"""Where the matching-mode pair wall goes with one and with more workers,
on one CUDA card.

    python3 tools/torch_match_workers.py [--passes 9]

The pair is chip_smoke.py's: the seed-0 1080p scene and its np.rot90
view.  A pass is two ``enqueue``s, two ``get_dev()``s and
``FeaturesDev.match``, timed by the host clock, as chip_smoke.py phase 8
times it; each line gives the median pass and the range.  Cases:

- ``workers`` 1, 2 and 3 with the interpreter's switch interval as it is
  (5 ms by default) and at 0.1 ms (``sys.setswitchinterval``): the
  workers dispatch their PyTorch operations under one GIL, and a worker
  whose count readback returned waits for the GIL up to a switch
  interval while another worker holds it;
- the same two frames enqueued one at a time (each ``get_dev()`` before
  the next ``enqueue``) through two workers: no two extractions overlap;
- one extraction alone, and ``extract_features(..., want_dev=True)``
  called on this thread for both frames, without the pipeline.

The card's name and power limit head the output.
"""

from __future__ import annotations

import argparse
import importlib.util
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent


def median_range(times) -> str:
    return (f"{np.median(times):.3f} ms (range {min(times):.3f}-"
            f"{max(times):.3f})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--passes", type=int, default=9)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_match_workers: no CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("cs", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, str(HERE))
    import popsift_torch as pt
    from popsift_torch.extract import extract_features

    print(cs.smi_line(), flush=True)
    a = cs.make_scene(0, 1080, 1920)
    b = np.ascontiguousarray(np.rot90(a))
    matching = pt.ProcessingMode.MATCHING
    default_interval = sys.getswitchinterval()

    def pair(ps, serial: bool = False) -> float:
        t0 = time.perf_counter()
        if serial:
            left = ps.enqueue(a.shape[1], a.shape[0], a).get_dev()
            right = ps.enqueue(b.shape[1], b.shape[0], b).get_dev()
        else:
            jl = ps.enqueue(a.shape[1], a.shape[0], a)
            jr = ps.enqueue(b.shape[1], b.shape[0], b)
            left, right = jl.get_dev(), jr.get_dev()
        left.match(right)
        return (time.perf_counter() - t0) * 1e3

    def run(label: str, workers: int, serial: bool = False) -> None:
        with pt.PopSift(pt.Config(), mode=matching, workers=workers) as ps:
            pair(ps, serial)
            times = [pair(ps, serial) for _ in range(args.passes)]
        print(f"  {label}: {median_range(times)}", flush=True)

    for interval in (default_interval, 1e-4):
        sys.setswitchinterval(interval)
        print(f"switch interval {interval * 1e3:g} ms", flush=True)
        for workers in (1, 2, 3):
            run(f"pair wall, workers={workers}", workers)
        run("pair wall, workers=2, frames one at a time", 2, serial=True)
    sys.setswitchinterval(default_interval)

    with pt.PopSift(pt.Config(), mode=matching) as ps:
        ps.enqueue(a.shape[1], a.shape[0], a).get_dev()
        times = []
        for _ in range(args.passes):
            t0 = time.perf_counter()
            ps.enqueue(a.shape[1], a.shape[0], a).get_dev()
            times.append((time.perf_counter() - t0) * 1e3)
    print(f"one frame through the pipeline, workers=1: "
          f"{median_range(times)}", flush=True)
    times = []
    for _ in range(args.passes + 1):
        t0 = time.perf_counter()
        left = extract_features(a, pt.Config(), "cuda", want_dev=True)
        right = extract_features(b, pt.Config(), "cuda", want_dev=True)
        left.match(right)
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"pair on this thread, no pipeline: {median_range(times[1:])}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
