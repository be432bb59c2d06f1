#!/usr/bin/env python3
"""Run one cell of the benchmark of popsift_torch on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json``) names a
configuration (``benchmark/configs/<config>.json``: the Config settings,
the ProcessingMode, image mode and workers, the input source and the
plain reference that judges it) and a traffic mix
(``benchmark/traffic/<traffic>.json``: the driver that sends it and its
parameters).  Set-up imports the program, makes the inputs from the seed
and warms the cell's shapes; the window then sends the traffic for
``--seconds``.  Once it closes, a seeded sample of the window's outputs
is held to the configuration's plain reference
(``benchmark/reference/<reference>.py``, ``sift`` by default) under the
cell's limits (``benchmark/limits/<cell>.json``).  The last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones, each read by
``benchmark/metrics/<metric>.py``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number beside its
limit.  Without a CUDA card it exits 2 and prints no result.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import subprocess
import sys
import time
import types
from contextlib import nullcontext
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "popsift_tpu")
# switches of the program that the environment must not carry into a run
PROGRAM_SWITCHES = ("POPSIFT_TPU_STACK_KERNELS", "POPSIFT_TPU_TRACE",
                    "POPSIFT_TPU_PLATFORM", "POPSIFT_TPU_HOSTTRACE")


def process_age() -> float:
    """Seconds since this process started (/proc, 10 ms ticks)."""
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    return (time.clock_gettime(time.CLOCK_BOOTTIME)
            - start / os.sysconf("SC_CLK_TCK"))


def set_environment(config: dict, trace: bool) -> None:
    """Caches inside the checkout, the configuration's switches, and the
    program's host spans in a traced run; before torch is imported."""
    cache = ROOT / "build" / "bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    for k in PROGRAM_SWITCHES:
        os.environ.pop(k, None)
    os.environ.update({k: str(v) for k, v in config.get("env", {}).items()})
    os.environ["POPSIFT_TPU_HOSTTRACE"] = "1" if trace else "0"


def make_config(popsift_torch, settings: dict):
    """popsift_torch.Config from the configuration file's settings, each
    field converted to the type of its default (enums by value)."""
    cfg = popsift_torch.Config()
    for k, v in settings.items():
        if not hasattr(cfg, k):
            raise SystemExit(f"Config has no field {k!r}")
        setattr(cfg, k, type(getattr(cfg, k))(v))
    return cfg


def plan_info(ref, settings: dict, w: int, h: int) -> dict:
    """The input size, octave shapes, levels and blur spans, worked out
    by the configuration's reference ``ref`` (nothing of the program)."""
    plan = ref.make_plan(settings, w, h)
    inc, _ = ref.gauss_tables(settings)
    return dict(input_w=w, input_h=h, dims=plan.dims, levels=plan.levels,
                spans=[s for _, s in inc])


def smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi: unavailable"


def forbidden_loaded(modules) -> list:
    """The JAX-side packages among ``modules``, compared by whole
    top-level name (popsift_torch's name begins with popsift_tpu's
    first letters)."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def finite(v):
    if isinstance(v, float) and not math.isfinite(v):
        return None
    return v


def execute(cell_name: str, seed: int, seconds: float, trace: bool,
            device: str = "cuda:0", overrides: dict | None = None) -> dict:
    """One run of a cell; returns the result object.  ``overrides`` may
    replace the configuration, traffic or limits (tests run small cells
    on the CPU this way)."""
    import torch

    from benchmark.lib import check, judge, records, spec, trace as tr

    overrides = overrides or {}
    bench = spec.benchmark()
    cell = spec.cell(bench, cell_name)
    config = overrides.get("config") or spec.config(bench, cell["config"])
    traffic = overrides.get("traffic") or spec.traffic(cell["traffic"])
    limits = overrides.get("limits") or spec.limits(cell_name)
    ref = spec.reference_of(config)
    image_mode = spec.image_mode_of(config)
    settings = ref.settings_of(config["popsift_config"])
    seed_bits = seed & (2 ** 64 - 1)

    sys.path.insert(0, str(ROOT))
    import popsift_torch
    from popsift_torch import tracing
    from popsift_torch.kernels import _lib

    dev = torch.device(device)
    cfg = make_config(popsift_torch, config["popsift_config"])
    gen = spec.named_module("inputs", config["input"]["kind"]).Generator(
        config["input"], seed_bits)
    driver = spec.named_module("drivers", traffic["driver"])
    kind = "pairs" if traffic["driver"] == "pairs" else "extract"
    ps = popsift_torch.PopSift(
        cfg, mode=popsift_torch.ProcessingMode(config["mode"]),
        imode=popsift_torch.ImageMode(image_mode), device=device,
        workers=int(config.get("workers", 1)))
    counter = iter(range(1 << 62))
    ctx = types.SimpleNamespace(ps=ps, gen=gen, traffic=traffic,
                                next_index=lambda: next(counter),
                                scope=lambda name: nullcontext())

    warm = getattr(driver, "warmup", driver.run)(
        ctx, count=int(traffic["warmup"]))
    if not all(r.ok for r in warm.requests):
        raise RuntimeError("a warm-up request failed")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if trace:
        tracing.host_trace_snapshot(clear=True)

    run = types.SimpleNamespace(cell=cell_name, traffic=traffic,
                                plan=plan_info(ref, settings, gen.w,
                                               gen.h),
                                spans=None, trace=None, launches=None)
    run.setup_s = process_age()
    sample = records.Reservoir(int(traffic["sample"]), seed_bits)
    t_spans = records.clock()
    run.window = driver.run(ctx, seconds=seconds, sample=sample)
    if trace:
        run.spans = tracing.host_trace_snapshot(clear=True)
        run.span_s = records.clock() - t_spans
        run.span_requests = len(run.window.requests)
        _lib.reset_launches()
        ctx.scope = torch.profiler.record_function
        n_slice = int(traffic["slice"])
        run.trace = tr.profile(lambda: driver.run(ctx, count=n_slice))
        run.slice_requests = n_slice
        run.launches = _lib.launches()
    memory_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)

    samples = [(i, check.program_arrays(kind, out))
               for i, out in sample.items]
    ps.uninit()
    del ps, ctx, sample
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()

    t_check = records.clock()
    numbers = check.numbers(kind, sorted(samples, key=lambda s: s[0]), gen,
                            settings, dev,
                            ratio=float(traffic.get("ratio", 0.8)), ref=ref)
    check_s = records.clock() - t_check
    correct, checks = judge.verdict(numbers, limits)
    attempted = len(run.window.requests)
    failed = sum(not r.ok for r in run.window.requests)
    correct = correct and failed == 0 and attempted > 0 and bool(samples)

    metrics = {}
    for m in spec.metrics_of(bench, cell_name, trace):
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": device_info}
    if run.trace is not None:
        device_info["busy_s"] = run.trace["busy_s"]
        device_info["window_s"] = run.trace["window_s"]
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    result["checks"] = {k: {"value": finite(v["value"]),
                            "limit": v["limit"]} for k, v in checks.items()}
    result["_stderr"] = [
        f"samples {sorted(i for i, _ in samples)} of {attempted} requests, "
        f"checked in {check_s:.3f} s",
        *(f"check {k}: {finite(float(v['value']))!r} "
          f"(limit {v['limit']!r})" for k, v in checks.items())]
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from benchmark.lib import spec
    bench = spec.benchmark()
    cell = spec.cell(bench, args.workload)
    config = spec.config(bench, cell["config"])
    set_environment(config, bool(args.trace))
    spec.image_mode_of(config)
    spec.reference_of(config).settings_of(config["popsift_config"])

    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(cell["chips"]):
        print(f"benchmark: the cell needs {cell['chips']} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"benchmark: {smi()}", file=sys.stderr)
    result = execute(args.workload, args.seed, args.seconds,
                     bool(args.trace))
    loaded = forbidden_loaded(list(sys.modules))
    if loaded:
        print(f"benchmark: the process loaded {loaded}; the benchmark "
              f"measures popsift_torch alone", file=sys.stderr)
        return 3
    lines = result.pop("_stderr")
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
