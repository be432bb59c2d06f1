#!/usr/bin/env python3
"""The control of a cell's comparison: the configuration's plain
reference one precision step below its float32, put in the program's
place.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 [--device cpu]

For each seed it makes the cell's inputs, draws the cell's sample size
of request numbers from the seed among the first ``--requests``, runs
the control on them (the scale space in bfloat16, matrix products in
TF32) and prints the numbers that the benchmark compares, judged against
the reference in float32 exactly as a run judges the program, beside the
cell's limits.  A sound limit lies below every control reading: the
control must come out not correct on every seed.  The benchmark's runs
do not run it.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_numbers(cell_name: str, seed: int, device: str,
                    requests: int = 64, overrides: dict | None = None):
    """(numbers, limits, correct) of the control on one seed."""
    import torch

    from benchmark.lib import check, judge, spec

    overrides = overrides or {}
    bench = spec.benchmark()
    cell = spec.cell(bench, cell_name)
    config = overrides.get("config") or spec.config(bench, cell["config"])
    traffic = overrides.get("traffic") or spec.traffic(cell["traffic"])
    limits = overrides.get("limits") or spec.limits(cell_name)
    ref = spec.reference_of(config)
    settings = ref.settings_of(config["popsift_config"])
    seed_bits = seed & (2 ** 64 - 1)
    gen = spec.named_module("inputs", config["input"]["kind"]).Generator(
        config["input"], seed_bits)
    kind = "pairs" if traffic["driver"] == "pairs" else "extract"
    picks = sorted(random.Random(seed_bits).sample(
        range(int(traffic["warmup"]), requests), int(traffic["sample"])))
    nums = check.numbers(kind, [(i, None) for i in picks], gen, settings,
                         torch.device(device),
                         ratio=float(traffic.get("ratio", 0.8)),
                         control=True, ref=ref)
    correct, checks = judge.verdict(nums, limits)
    return checks, correct


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--requests", type=int, default=64)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    for seed in (int(s) for s in args.seeds.split(",")):
        checks, correct = control_numbers(args.workload, seed, args.device,
                                          args.requests)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control_correct": correct, "checks": checks}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
