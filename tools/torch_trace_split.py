#!/usr/bin/env python3
"""The host-span recorder of popsift_torch on the card: what a Chrome
trace with the host spans shows, and what the recorder costs.

    python tools/torch_trace_split.py trace [--frames 16] [--out DIR]
    python tools/torch_trace_split.py cost [--cells a,b] [--runs 3]

``trace`` runs the benchmark's ``popsift-1080p`` configuration (its
synthetic 1080p frames, 8 in flight through ``PopSift``) inside
``tracing.trace(DIR)`` and reads the file back: the readback spans and
the copies to the host per image, each copy by the host span that holds
its runtime call; the host spans per image (dispatch = ``extract`` less
its readbacks); each scope's host time less its readbacks; whether each
``stage1.o0`` span holds its octave's K7 launch (``octave_chain``); the
card's idle gaps by the innermost host span open on the worker at the
gap's middle, with one gap under a readback; and the gap between the
host spans' and the profiler's own ``pyramid`` ranges (the shared
clock).  The trace is kept gzipped in DIR.

``cost`` runs benchmark cells (``benchmark/run.py``'s ``execute``, one
process a run, ``--trace 0``) with the recorder off and on in turns, a
seed each pair, and prints each run's end-to-end metrics and the medians.

Both need a CUDA card.  The last line of output is one JSON object.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import gzip
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def smi() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi: unavailable"


def _pipeline(seed: int):
    """PopSift and the frame generator of the popsift-1080p configuration."""
    import popsift_torch
    from benchmark import run as bench
    from benchmark.lib import spec
    b = spec.benchmark()
    config = spec.config(b, "popsift-1080p")
    gen = spec.named_module("inputs", config["input"]["kind"]).Generator(
        config["input"], seed)
    ps = popsift_torch.PopSift(
        bench.make_config(popsift_torch, config["popsift_config"]),
        device="cuda")
    return ps, gen


def _closed_loop(ps, gen, frames: int, first: int, depth: int = 8) -> None:
    jobs = collections.deque()
    for i in range(first, first + frames):
        img = gen.request(i)
        jobs.append(ps.enqueue(img.shape[1], img.shape[0], img))
        if len(jobs) == depth:
            jobs.popleft().get()
    while jobs:
        jobs.popleft().get()


def _innermost(spans_by_tid: dict, tid, t: float):
    """The innermost host span open at ``t`` on ``tid`` (complete events,
    start-sorted), or None."""
    spans, starts = spans_by_tid.get(tid, ([], []))
    best = None
    for e in spans[:bisect.bisect_right(starts, t)]:
        if e["ts"] <= t <= e["ts"] + e["dur"]:
            if best is None or e["dur"] <= best["dur"]:
                best = e
    return best


def analyse(events: list, frames: int) -> dict:
    host = [e for e in events if e.get("cat") == "host_span"
            and e.get("ph") == "X"]
    by_id = {e["args"]["id"]: e for e in host}
    spans_by_tid = collections.defaultdict(list)
    for e in host:
        spans_by_tid[e["tid"]].append(e)
    spans_by_tid = {t: (sorted(v, key=lambda e: e["ts"]),
                        sorted(e["ts"] for e in v))
                    for t, v in spans_by_tid.items()}
    extracts = [e for e in host if e["name"] == "extract"]
    worker = collections.Counter(
        e["tid"] for e in extracts).most_common(1)[0][0]
    n = len(extracts)
    t0 = min(e["ts"] for e in extracts)
    t1 = max(e["ts"] + e["dur"] for e in extracts)

    def is_readback(e):
        return (e["name"].startswith("readback.")
                and e["name"] != "readback.match")

    readbacks = [e for e in host if is_readback(e)]
    rb_by_site = collections.Counter(e["name"] for e in readbacks)
    extract_ms = sum(e["dur"] for e in extracts) / 1e3
    readback_ms = sum(e["dur"] for e in readbacks) / 1e3

    # each scope's host time, and its readback children's
    scope_ms = collections.defaultdict(float)
    scope_rb_ms = collections.defaultdict(float)
    for e in host:
        scope_ms[e["name"]] += e["dur"] / 1e3
        if is_readback(e) and e["args"]["parent"] in by_id:
            scope_rb_ms[by_id[e["args"]["parent"]]["name"]] += e["dur"] / 1e3
    per_scope = {k: dict(host_ms=scope_ms[k] / n,
                         readback_ms=scope_rb_ms[k] / n,
                         dispatch_ms=(scope_ms[k] - scope_rb_ms[k]) / n)
                 for k in ("pyramid", "detect", "orientation", "descriptors",
                           "download", "filter", "assemble")}

    # copies to the host, each by the host span holding its runtime call
    launch = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and \
                "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = (e["tid"], float(e["ts"]))
    d2h = [e for e in events if e.get("cat") == "gpu_memcpy"
           and "DtoH" in e.get("name", "")
           and t0 <= float(e["ts"]) <= t1]
    d2h_by_site = collections.Counter()
    for e in d2h:
        at = launch.get(e.get("args", {}).get("correlation"))
        sp = _innermost(spans_by_tid, at[0], at[1]) if at else None
        d2h_by_site[sp["name"] if sp else "none"] += 1

    # K7 launches inside each stage1.o0 span of the worker
    k7_at = [launch.get(e.get("args", {}).get("correlation"))
             for e in events if e.get("cat") == "kernel"
             and "octave_chain" in e.get("name", "")]
    k7_at = [a for a in k7_at if a is not None]
    s10 = [e for e in host if e["name"] == "stage1.o0"]
    s10_with_k7 = sum(
        any(tid == s["tid"] and s["ts"] <= ts <= s["ts"] + s["dur"]
            for tid, ts in k7_at) for s in s10)

    # the card's idle gaps between the first extraction's start and the
    # last one's end, by the worker's innermost host span
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                 for e in events
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, gaps = [], []
    for s, e in dev:
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e])
    for (_, a), (b, _) in zip(busy, busy[1:]):
        if t0 <= a and b <= t1 and b > a:
            gaps.append((a, b))
    idle_by = collections.Counter()
    example = None
    for a, b in gaps:
        sp = _innermost(spans_by_tid, worker, (a + b) / 2)
        name = sp["name"] if sp else "none"
        idle_by[name] += (b - a) / 1e3
        if name.startswith("readback.") and (example is None
                                             or b - a > example["idle_us"]):
            chain, p = [], sp
            while p is not None:
                chain.append(p["name"])
                p = by_id.get(p["args"]["parent"])
            example = dict(idle_us=b - a, at_us=a, under=chain,
                           request=sp["args"]["request"])
    window_ms = (t1 - t0) / 1e3
    idle_ms = sum(b - a for a, b in gaps) / 1e3

    # the shared clock: host pyramid spans against the profiler's ranges
    def starts(cat):
        return sorted(float(e["ts"]) for e in events
                      if e.get("cat") == cat and e.get("name") == "pyramid"
                      and e.get("tid") == worker)
    prof, hs = starts("user_annotation"), starts("host_span")
    clock_gap = ([b - a for a, b in zip(prof, hs)]
                 if len(prof) == len(hs) else None)

    return dict(
        frames=frames, extract_spans=n,
        readback_spans_per_image=len(readbacks) / n,
        readback_spans_by_site={k: v / n
                                for k, v in sorted(rb_by_site.items())},
        d2h_copies_per_image=len(d2h) / n,
        d2h_copies_by_host_span={k: v / n
                                 for k, v in sorted(d2h_by_site.items())},
        extract_ms=extract_ms / n, readback_ms=readback_ms / n,
        dispatch_ms=(extract_ms - readback_ms) / n,
        upload_ms=scope_ms["upload"] / max(
            1, sum(e["name"] == "upload" for e in host)),
        per_scope=per_scope,
        stage1_o0_spans=len(s10), stage1_o0_with_k7_launch=s10_with_k7,
        window_ms=window_ms, idle_pct=100.0 * idle_ms / window_ms,
        idle_ms_by_host_span=dict(sorted(
            ((k, v / n) for k, v in idle_by.items()), key=lambda kv: -kv[1])),
        readback_gap_example=example,
        clock_gap_us=(dict(median=statistics.median(clock_gap),
                           least=min(clock_gap), most=max(clock_gap))
                      if clock_gap
                      else f"{len(prof)} ranges, {len(hs)} spans"),
        worker_tid_has_profiler_ranges=bool(prof))


def cmd_trace(args) -> dict:
    import torch
    from popsift_torch import tracing
    ps, gen = _pipeline(args.seed)
    _closed_loop(ps, gen, 4, 0)                     # warm-up
    torch.cuda.synchronize()
    out = Path(args.out)
    shutil.rmtree(out / "raw", ignore_errors=True)
    t = time.perf_counter()
    with tracing.trace(str(out / "raw")):
        _closed_loop(ps, gen, args.frames, 4)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t
    ps.uninit()
    (path,) = (out / "raw").iterdir()
    events = json.loads(path.read_text())["traceEvents"]
    with open(path, "rb") as f, gzip.open(out / "trace.json.gz", "wb") as g:
        shutil.copyfileobj(f, g)
    shutil.rmtree(out / "raw")
    result = analyse(events, args.frames)
    result["traced_wall_s"] = wall
    return result


def cmd_one(args) -> dict:
    """One benchmark run with the recorder as ``--on`` says."""
    from benchmark import run as bench
    from benchmark.lib import spec
    b = spec.benchmark()
    cell = spec.cell(b, args.cell)
    bench.set_environment(spec.config(b, cell["config"]), False)
    os.environ["POPSIFT_TPU_HOSTTRACE"] = "1" if args.on else "0"
    result = bench.execute(args.cell, args.seed, args.seconds, False)
    result.pop("_stderr")
    return result


def cmd_cost(args) -> dict:
    runs = []
    for k in range(args.runs):
        seed = args.seed + k
        for cell in args.cells.split(","):
            order = (False, True) if k % 2 == 0 else (True, False)
            for on in order:
                p = subprocess.run(
                    [sys.executable, __file__, "one", "--cell", cell,
                     "--seed", str(seed), "--seconds", str(args.seconds)]
                    + (["--on"] if on else []),
                    capture_output=True, text=True, cwd=ROOT, timeout=600)
                line = (p.stdout.strip().splitlines() or ["{}"])[-1]
                r = json.loads(line) if p.returncode == 0 else {}
                runs.append(dict(cell=cell, on=on, seed=seed,
                                 rc=p.returncode, correct=r.get("correct"),
                                 metrics={m: v["value"] for m, v in
                                          r.get("metrics", {}).items()}))
                if p.returncode:
                    print(p.stderr[-3000:], file=sys.stderr)
                print(json.dumps(runs[-1]), flush=True)
    medians = {}
    for cell in args.cells.split(","):
        for on in (False, True):
            vals = collections.defaultdict(list)
            for r in runs:
                if r["cell"] == cell and r["on"] == on:
                    for m, v in r["metrics"].items():
                        vals[m].append(v)
            medians[f"{cell} {'on' if on else 'off'}"] = {
                m: statistics.median(v) for m, v in vals.items()}
    return dict(runs=runs, medians=medians)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("trace")
    t.add_argument("--frames", type=int, default=16)
    t.add_argument("--seed", type=int, default=2147800011)
    t.add_argument("--out", default="build/bench_trace_split")
    c = sub.add_parser("cost")
    c.add_argument("--cells",
                   default="1080p-default.batch8,1080p-default.live")
    c.add_argument("--runs", type=int, default=3)
    c.add_argument("--seconds", type=float, default=20.0)
    c.add_argument("--seed", type=int, default=2147800021)
    o = sub.add_parser("one")
    o.add_argument("--cell", required=True)
    o.add_argument("--seed", type=int, required=True)
    o.add_argument("--seconds", type=float, required=True)
    o.add_argument("--on", action="store_true")
    args = p.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("torch_trace_split: needs a CUDA card", file=sys.stderr)
        return 2
    if args.cmd != "one":
        print(f"# {smi()}", flush=True)
    result = dict(trace=cmd_trace, cost=cmd_cost, one=cmd_one)[args.cmd](args)
    if args.cmd != "one":
        result["device"] = smi()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
