"""The Oxford-shaped accuracy protocol through popsift_torch
(popsift_torch/eval/oxford.py): 8 scenes x 6 images of
tests/data/scenes/ under the Oxford transformation families, in each
SiftMode, with repeatability, matching score and descriptor L2 per pair.
The counterpart of tools/oxford_protocol.py, with its flags and exit
codes (0 when every mode meets the pass bar, else 1), plus --device.

Usage:
    python tools/torch_oxford_protocol.py [--modes popsift vlfeat opencv]
        [--scenes hopper china ...] [--out PARITY_torch.json]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from popsift_torch.eval import no_device_reason  # noqa: E402
from popsift_torch.eval import oxford  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--modes", nargs="+", default=list(oxford.MODES))
    ap.add_argument("--scenes", nargs="+", default=list(oxford.FAMILIES))
    ap.add_argument("--out", default="PARITY_torch.json")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), cuda:N or cpu")
    args = ap.parse_args(argv)
    why = no_device_reason(args.device)
    if why:
        ap.error(why)

    payload = oxford.run_protocol(args.modes, args.scenes, args.device,
                                  args.workers,
                                  log=lambda s: print(s, flush=True))
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=1)
    print(f"{'PASS' if payload['ok'] else 'FAIL'} -> {args.out}")
    return 0 if payload["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
