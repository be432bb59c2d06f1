"""One multi-device SfM front-end step on n ranks, the counterpart of
``__graft_entry__.dryrun_multichip``.

    python -m popsift_torch.parallel.dryrun --ranks N --device cpu|cuda

``device="cuda"`` runs one rank a card on NCCL; ``device="cpu"`` runs the
ranks on the CPU on gloo.  The mesh is (n/2, 2) for an even n of at least
4, else (n, 1); the batch of 48x64 images is deliberately uneven, padded
by :func:`~popsift_torch.parallel.batch.pad_batch`, and no pad frame may
keep a valid descriptor row.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..config import Config
from .batch import make_mesh, pad_batch, sfm_frontend_step
from .ranks import run_ranks


def _test_image(h: int, w: int) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w), np.float32)
    rng = np.random.default_rng(0)
    for _ in range(12):
        cx = rng.uniform(5, w - 5)
        cy = rng.uniform(5, h - 5)
        s = rng.uniform(1.5, 5.0)
        img += rng.uniform(0.3, 1.0) * np.exp(
            -(((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s * s)))
    return np.clip(img / max(img.max(), 1e-6), 0.0, 1.0)


def _step(rank: int, n: int, device: str) -> str:
    model = 2 if n % 2 == 0 and n >= 4 else 1
    data = n // model
    dev = (torch.device("cuda", rank % torch.cuda.device_count())
           if device == "cuda" else torch.device("cpu"))
    mesh = make_mesh(data=data, model=model, device=dev)
    h, w = 48, 64
    # data-1 keeps the padded batch at one image a data index while still
    # padding a frame
    batch = data - 1 if data >= 3 else data + 1
    step, _ = sfm_frontend_step(Config(), w, h, mesh, desc_cap=256)
    images = np.stack([_test_image(h, w) for _ in range(batch)])
    padded, img_valid = pad_batch(images, mesh)
    out = step(padded, img_valid)
    if bool(out["desc_valid"][batch:].any()):
        raise AssertionError("a pad frame kept a valid descriptor row")
    counts = out["match_counts"].cpu().tolist()
    return (f"dryrun_multichip: mesh=({data}x{model}) batch={batch}"
            f"+{padded.shape[0] - batch}pad desc_cap={out['desc'].shape[1]} "
            f"match_counts={counts}")


def dryrun_multichip(n: int, device: str = "cuda",
                     timeout: float = 300.0) -> str:
    """Run one step on ``n`` ranks, print its line and return it."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"dryrun_multichip: device {device!r}")
    if device == "cuda" and n > torch.cuda.device_count():
        raise ValueError(f"dryrun_multichip: {n} NCCL ranks need {n} cards; "
                         f"{torch.cuda.device_count()} found")
    lines = run_ranks(_step, n, "nccl" if device == "cuda" else "gloo",
                      args=(n, device), timeout=timeout)
    if len(set(lines)) != 1:
        raise RuntimeError(f"dryrun_multichip: the ranks disagree: {lines}")
    print(lines[0], flush=True)
    return lines[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=None,
                    help="number of ranks (default: the cards, or 4 on cpu)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    n = args.ranks or (torch.cuda.device_count() if args.device == "cuda"
                       else 4)
    dryrun_multichip(n, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
