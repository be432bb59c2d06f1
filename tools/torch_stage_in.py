"""How the size of a stage-in slot moves the staging of a 24 MP float
photograph and the photograph's turn through ``PopSift``, on one CUDA
card.

    python3 tools/torch_stage_in.py [--turns 2] [--photos 8] [--sizes 2,4,8]

A photograph is a 6000x4000 float32 window into a canvas of
``benchmark/inputs/photo_float.py``, with the row stride the benchmark's
photographs have.  For each slot size in MB, in turns (2, 4, 8, then 8,
4, 2, and so on), the ring is built at that size (the tool sets
``pipeline.SLOT_BYTES`` before it; the program never does) and gives:

- ``stage_ms``: the median of 10 stagings through ``pipeline.StageIn``,
  from the call to ``stage`` until its event has completed (the caller's
  copy and every DMA);
- ``images_per_s``: AliceVision's configuration
  (``benchmark/configs/alicevision-popsift-24mp.json``) through
  ``PopSift``, one photograph in flight, ``--photos`` photographs after
  two warm ones.

Once a turn, beside them, the copy and upload the ring replaced: a host
copy into a reused buffer, then ``pipeline.upload_image`` (a pageable
copy), as the median of 10.  The card's name and power limit head the
output; the last line is the JSON of every reading.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent
H, W = 4000, 6000


def smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip()


def median_ms(fn, reps: int = 10) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--photos", type=int, default=8)
    ap.add_argument("--sizes", default="2,4,8")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_stage_in: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    import popsift_torch as pt
    from popsift_torch import pipeline
    from benchmark.inputs.photo_float import make_canvas
    from benchmark.run import make_config

    print(smi(), flush=True)
    dev = torch.device("cuda")
    canvas = make_canvas([24, 0], H + 64, W + 64)
    photos = [canvas[o:o + H, 63 - o:63 - o + W] for o in range(0, 64, 9)]
    av = json.loads((HERE / "benchmark" / "configs"
                     / "alicevision-popsift-24mp.json").read_text())
    cfg = make_config(pt, av["popsift_config"])
    sizes = [int(s) for s in args.sizes.split(",")]
    rows = []
    buf = np.empty((H, W), np.float32)

    def pageable():
        np.copyto(buf, photos[0])
        pipeline.upload_image(buf, dev)
        torch.cuda.synchronize(dev)

    for turn in range(args.turns):
        order = sizes if turn % 2 == 0 else sizes[::-1]
        pageable()
        rows.append({"turn": turn, "variant": "copy+pageable",
                     "stage_ms": median_ms(pageable)})
        print(rows[-1], flush=True)
        for mb in order:
            pipeline.SLOT_BYTES = mb << 20
            ring = pipeline.StageIn(dev)

            def stage():
                _, ready, _ = ring.stage(photos[1], np.float32)
                ready.synchronize()
            stage()
            stage_ms = median_ms(stage)
            bands = ring.stage(photos[1], np.float32)[2]
            del ring
            with pt.PopSift(cfg, imode=pt.ImageMode.FLOAT,
                            device=dev) as ps:
                for i in range(2):
                    ps.enqueue(W, H, photos[i]).get()
                t0 = time.perf_counter()
                for i in range(args.photos):
                    ps.enqueue(W, H, photos[i % len(photos)]).get()
                rate = args.photos / (time.perf_counter() - t0)
            rows.append({"turn": turn, "variant": f"{mb} MB",
                         "bands": bands, "stage_ms": stage_ms,
                         "images_per_s": rate})
            print(rows[-1], flush=True)
    print(smi(), flush=True)
    print(json.dumps({"stage_in": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
