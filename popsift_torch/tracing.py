"""Tracing and profiling utilities (popsift_tpu/tracing.py).

The reference marks pipeline phases with NVTX ranges, compile-gated by
PopSift_USE_NVTX_PROFILING (popsift.h:26-31, nvtx calls in
popsift.cpp:441-452, sift_pyramid.cu:288-319).  Here:

* :func:`host_trace` - host timestamps of the pipeline's stages, summed
  per span at ``PopSift.uninit`` with ``POPSIFT_TPU_HOSTTRACE=1``,
* :func:`scope` - a ``torch.profiler.record_function`` range at the same
  cut points (pyramid, detection, grid filter, orientation, descriptors,
  download, assembly), which is also an NVTX range when the work runs on
  a CUDA device, so the ranges show in a profiler trace and in Nsight,
* :func:`trace` - a ``torch.profiler`` context that writes a Chrome trace
  into a directory; enable it ambiently with ``POPSIFT_TPU_TRACE=<dir>``,
* :class:`BriefDuration` - the event-pair wall-clock timer analog
  (debug_macros.h:84-117).
"""

from __future__ import annotations

import contextlib
import itertools
import os
import sys
import time

import torch

# POPSIFT_TPU_HOSTTRACE=1: record host-pipeline timestamps and print a
# stage summary at PopSift.uninit (the NVTX-range analog for the host
# threads).  Events are (time, tag, key, kwargs); "<name>.start"/".end"
# pairs become duration spans, events with kwargs become value series.
HOSTTRACE = os.environ.get("POPSIFT_TPU_HOSTTRACE", "") not in ("", "0")
_trace_events: list = []

# the scope names of an extraction, in the order they open
SCOPES = ("pyramid", "detect", "filter", "orientation", "descriptors",
          "download", "assemble")


def host_trace(tag: str, key, **kw) -> None:
    if HOSTTRACE:
        _trace_events.append((time.perf_counter(), tag, key, kw))


_span_keys = itertools.count()


def span_key() -> int:
    """A key no other span of the process has, for the ``.start``/``.end``
    pair of one call (the worker threads of a pipeline trace at once;
    ``next`` of an itertools.count is one call under the interpreter
    lock)."""
    return next(_span_keys)


def _collect_spans(events):
    """Fold raw (t, tag, key, kwargs) events into named series.

    ``<name>.start``/``.end`` pairs become duration spans (ms); kwarg
    values become ``#<tag>`` series.  Non-numeric kwarg values are
    counted, never aggregated: a string kwarg cast to float would raise
    inside PopSift.uninit.  Events are ordered by time alone, so events of
    one instant keep the order they were recorded in: a ``.start`` stays
    before its ``.end``, and keys of different types are never compared."""
    import collections

    spans = collections.defaultdict(list)
    open_at = {}
    for t, tag, key, kw in sorted(events, key=lambda e: e[0]):
        if tag.endswith(".start"):
            open_at[(tag[:-6], key)] = t
        elif tag.endswith(".end"):
            t0 = open_at.pop((tag[:-4], key), None)
            if t0 is not None:
                spans[tag[:-4]].append((t - t0) * 1e3)
        if kw:
            v = next(iter(kw.values()))
            try:
                v = float(v)
            except (TypeError, ValueError):
                v = 1.0  # count occurrences of non-numeric events
            spans[f"#{tag}"].append(v)
    return spans


def host_trace_snapshot(clear: bool = False) -> dict:
    """Per-pass attribution: return {name: (count, sum)} of all span /
    kwarg series recorded so far; optionally clear the buffer."""
    spans = _collect_spans(_trace_events)
    if clear:
        _trace_events.clear()
    return {name: (len(v), float(sum(v))) for name, v in spans.items()}


def host_trace_summary() -> None:
    if not HOSTTRACE or not _trace_events:
        return
    import numpy as np
    spans = _collect_spans(_trace_events)
    _trace_events.clear()
    print("# host trace:", file=sys.stderr)
    for name in sorted(spans):
        try:
            v = np.asarray(spans[name], dtype=np.float64)
            print(f"#   {name:22s} n={v.size:4d} mean={v.mean():8.2f} "
                  f"p50={np.percentile(v, 50):8.2f} "
                  f"p95={np.percentile(v, 95):8.2f} sum={v.sum():9.1f}",
                  file=sys.stderr)
        except Exception as e:  # diagnostics must never fail shutdown
            print(f"#   {name:22s} <unsummarizable: {e}>", file=sys.stderr)


@contextlib.contextmanager
def scope(name: str, device=None):
    """A named range of an extraction's phase: a ``record_function`` range
    that torch.profiler records, and with ``device`` a CUDA device also an
    NVTX range (a CPU-only build of PyTorch has no NVTX)."""
    nvtx = device is not None and torch.device(device).type == "cuda"
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profiler trace context: torch.profiler over the block (the CPU
    operations of the calling thread, and with a CUDA device every kernel
    and copy on it), exported as a Chrome trace into ``log_dir``.  If
    ``log_dir`` is None, uses the POPSIFT_TPU_TRACE env var; no-op when
    neither is set."""
    log_dir = log_dir or os.environ.get("POPSIFT_TPU_TRACE")
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"popsift_torch_{os.getpid()}_{time.time_ns()}.json"))


class BriefDuration:
    """Wall-clock phase timer (BriefDuration, debug_macros.h:84-117)."""

    def __init__(self, label: str, stream=None) -> None:
        self._label = label
        self._stream = stream or sys.stderr
        self._t0 = None
        self._elapsed = 0.0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self._t0 is not None:
            self._elapsed += time.perf_counter() - self._t0
            self._t0 = None

    def report(self) -> None:
        print(f"{self._label}: {self._elapsed * 1e3:.3f} ms",
              file=self._stream)

    def __enter__(self) -> "BriefDuration":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
        self.report()
