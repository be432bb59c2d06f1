"""The profiled slice of a traced run and its reduction.

``torch.profiler`` records the card's kernels, copies and sets, the CUDA
runtime calls that launched them and the ``record_function`` ranges of
every thread (the pipeline's worker thread included, hence
``profile_all_threads``).  The slice is one ``bench.slice`` range on the
harness's thread.  From the Chrome trace the reduction takes:

* ``window_s``: the slice's length; ``busy_s``: the union of the device's
  activity inside it;
* ``scope_device_s``: per range name, the device time of the work
  launched inside it (a kernel belongs to each range that holds its
  launching runtime call on that thread);
* ``device_ops``: the device operations by total time;
* ``idle_gaps``: the device's idle time inside the slice by what the
  host was doing then: the innermost range open at the gap's middle on
  the thread that launched most work (the pipeline's worker), then on
  each other thread with ranges (the harness's), joined by "/".
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def profile(fn) -> dict:
    """Run ``fn`` under the profiler and return the reduced trace."""
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with torch.profiler.profile(
            activities=acts,
            experimental_config=_ExperimentalConfig(
                profile_all_threads=True)) as prof:
        with torch.profiler.record_function("bench.slice"):
            fn()
            if cuda:
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return reduce(events)


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


class _Ranges:
    """The record_function ranges of one thread, for lookups by time.
    The program's scopes and the harness's ranges do not nest (the slice's
    own range is kept apart), so the ranges that hold a time are among the
    last few that start before it."""

    DEPTH = 4

    def __init__(self, ranges) -> None:
        self.ranges = sorted(ranges)          # (start, end, name)
        self.starts = [r[0] for r in self.ranges]

    def open_at(self, t: float) -> list:
        """The ranges that hold ``t``, outermost first."""
        k = bisect.bisect_right(self.starts, t)
        return [r for r in self.ranges[max(0, k - self.DEPTH):k]
                if r[1] >= t]


def reduce(events: list) -> dict:
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    slices = [e for e in xs if e.get("name") == "bench.slice"]
    if not slices:
        raise RuntimeError("the trace has no bench.slice range")
    t0 = float(slices[0]["ts"])
    t1 = t0 + float(slices[0]["dur"])
    ranges = collections.defaultdict(list)
    launch = {}
    launches_by_tid = collections.Counter()
    device = []
    for e in xs:
        cat = e.get("cat", "")
        ts, dur = float(e["ts"]), float(e["dur"])
        if cat == "user_annotation" and e["name"] != "bench.slice":
            ranges[e["tid"]].append((ts, ts + dur, e["name"]))
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch[corr] = (e["tid"], ts)
        elif cat in DEVICE_CATS:
            device.append(e)
    by_tid = {tid: _Ranges(r) for tid, r in ranges.items()}

    clipped = [(max(float(e["ts"]), t0),
                min(float(e["ts"]) + float(e["dur"]), t1)) for e in device]
    busy = _union([(s, e) for s, e in clipped if e > s])
    busy_us = sum(e - s for s, e in busy)

    ops = collections.Counter()
    scope_us = collections.Counter()
    for e in device:
        ops[e["name"][:160]] += float(e["dur"])
        src = launch.get(e.get("args", {}).get("correlation"))
        if src is None:
            continue
        launches_by_tid[src[0]] += 1
        tr = by_tid.get(src[0])
        if tr is not None:
            for name in {r[2] for r in tr.open_at(src[1])}:
                scope_us[name] += float(e["dur"])

    main = launches_by_tid.most_common(1)[0][0] if launches_by_tid else None
    gaps = collections.Counter()
    edges = [t0] + [x for s, e in busy for x in (s, e)] + [t1]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e <= s:
            continue
        mid = 0.5 * (s + e)
        parts = []
        for tid in [main] + sorted(t for t in by_tid if t != main):
            inner = by_tid[tid].open_at(mid) if tid in by_tid else []
            parts.append(inner[-1][2] if inner else "none")
        gaps["/".join(parts)] += e - s

    return dict(
        window_s=(t1 - t0) * 1e-6, busy_s=busy_us * 1e-6,
        scope_device_s={k: v * 1e-6 for k, v in scope_us.items()},
        device_ops=[[k, v * 1e-6] for k, v in ops.most_common(10)],
        idle_gaps=[[k, v * 1e-6] for k, v in gaps.most_common(10)])
