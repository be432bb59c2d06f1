"""Tracing and profiling utilities (popsift_tpu/tracing.py).

The reference marks pipeline phases with NVTX ranges, compile-gated by
PopSift_USE_NVTX_PROFILING (popsift.h:26-31, nvtx calls in
popsift.cpp:441-452, sift_pyramid.cu:288-319).  Here:

* the host-span recorder: :func:`begin` / :func:`end` around the
  pipeline's and the extraction's steps, kept in memory as
  :class:`Span` records and folded per name by
  :func:`host_trace_snapshot` and :func:`host_trace_summary` (printed at
  ``PopSift.uninit``); :func:`host_trace` adds value series (``#name``).
  The switch is :data:`HOSTTRACE`: ``POPSIFT_TPU_HOSTTRACE=1`` sets it at
  import, :func:`enable` at run time.  Off, a call site costs one test of
  it: no stamp, no generator, no profiler range,
* :func:`scope` - a ``torch.profiler.record_function`` range at the
  extraction's cut points (pyramid, detection, grid filter, orientation,
  descriptors, download, assembly), which is also an NVTX range when the
  work runs on a CUDA device, and with the recorder on a host span of the
  same name,
* :func:`trace` - a ``torch.profiler`` context that writes a Chrome trace
  into a directory, with the recorder on and its host spans appended;
  enable it ambiently with ``POPSIFT_TPU_TRACE=<dir>``,
* :class:`BriefDuration` - the event-pair wall-clock timer analog
  (debug_macros.h:84-117).

Spans.  ``PopSift.enqueue`` numbers each job from a process-wide counter
(:func:`new_request`); its root span ``job`` runs from the enqueue to the
job's end, and its ``queue`` span until a worker takes it.  The worker
makes the number its thread's request (:func:`set_request`), so every
span it opens carries it; a span's parent is the innermost span open on
its thread, else the job's root.  The nesting::

    job > queue, upload, extract
    extract > stage1.o<k> > pyramid, detect > readback.compact,
                                              readback.refine_status
            > filter > readback.recompact
            > stage2 > orientation > readback.rows
                     > descriptors
                     > download > readback.download
            > assemble

``stage2`` is one pass over every octave's extrema (one orientation
launch, one ``readback.rows``, one descriptor launch, two
``readback.download`` copies, one with MatchingMode's descriptors kept on
the card); the series ``#stage2.octaves`` counts the octaves that have
extrema in it.  Per image, ``#stage1.overflow`` counts the candidates and
extrema that the octaves' capacities dropped, ``#stage1.budget`` the
candidates that the compaction's per-block budget dropped, and with the
grid filter on ``#filter.total`` and ``#filter.kept`` the extrema before
and after it.
    match > readback.match              (FeaturesDev.match, no request)

A ``readback.<site>`` span is the host waiting for the card: each is one
synchronisation, and a scope's dispatch time is its span less its
readback children.  Stamps are ``time.time_ns()``, the clock of the
profiler's Chrome trace (its ``ts`` in us plus ``baseTimeNanoseconds``),
so a host span lies over the device activity of the same instant.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import sys
import threading
import time
from typing import NamedTuple

import torch

# The recorder's switch: POPSIFT_TPU_HOSTTRACE=1 at import, enable() at
# run time.  Call sites test it before anything else.
HOSTTRACE = os.environ.get("POPSIFT_TPU_HOSTTRACE", "") not in ("", "0")
# host_trace's events (time, tag, key, kwargs): "<name>.start"/".end"
# pairs become duration spans, events with kwargs become value series
_trace_events: list = []
_spans: list = []    # closed spans, Span's fields as tuples
_taps: list = []     # the lists of the trace() blocks open now

# the scope names of an extraction, in the order they open
SCOPES = ("pyramid", "detect", "filter", "orientation", "descriptors",
          "download", "assemble")

# the clock of the profiler's Chrome trace, in ns since the epoch
_clock = time.time_ns
# next() of an itertools.count is one call under the interpreter lock
_requests = itertools.count(1)
_span_ids = itertools.count(1)


class Span(NamedTuple):
    """One closed host span: ``start`` and ``end`` in ns on the
    profiler's clock; ``request`` the job's number (None outside a job);
    ``id`` unique in the process, ``parent`` the enclosing span's id;
    ``thread`` the native id of the thread that opened it; ``detached``
    when another thread may close it (``job``, ``queue``)."""

    name: str
    start: int
    end: int
    request: int | None
    id: int
    parent: int | None
    thread: int
    detached: bool


# An open span is the tuple (name, start, request, id, parent, thread,
# detached); closing it records Span's fields as a plain tuple, which
# host_spans() names: tuples are the cheapest records to build on the
# thread being measured.
_ID = 3


class _ThreadState(threading.local):
    def __init__(self) -> None:
        self.stack = []        # this thread's open spans, innermost last
        self.request = None
        self.root = None       # id of the running job's root span
        self.tid = threading.get_native_id()


_tls = _ThreadState()


def enable(on: bool = True) -> None:
    """Turn the host-span recorder on or off."""
    global HOSTTRACE
    HOSTTRACE = bool(on)


def new_request() -> int:
    """A request number no other job of the process has."""
    return next(_requests)


def set_request(request: int | None, root: tuple | None = None) -> None:
    """Make ``request`` this thread's current request and ``root`` (the
    job's open root span) the parent of its outermost spans; spans an
    earlier job left open on the thread (an extraction that raised) are
    dropped."""
    tls = _tls
    tls.request = request
    tls.root = root[_ID] if root is not None else None
    tls.stack.clear()


def begin(name: str) -> tuple:
    """Open a span on this thread, inside its innermost open span."""
    tls = _tls
    stack = tls.stack
    sp = (name, _clock(), tls.request, next(_span_ids),
          stack[-1][_ID] if stack else tls.root, tls.tid, False)
    stack.append(sp)
    return sp


def begin_detached(name: str, request: int | None,
                   parent: tuple | None = None) -> tuple:
    """Open a span that another thread may close, on no thread's stack."""
    return (name, _clock(), request, next(_span_ids),
            parent[_ID] if parent is not None else None, _tls.tid, True)


def end(sp: tuple) -> None:
    """Close ``sp`` and record it; on its thread it is popped with any
    span an exception left open inside it."""
    t = _clock()
    if not sp[6]:
        stack = _tls.stack
        if stack and stack[-1] is sp:
            stack.pop()
        else:
            for i in range(len(stack) - 1, -1, -1):
                if stack[i] is sp:
                    del stack[i:]
                    break
    rec = (sp[0], sp[1], t) + sp[2:]
    _spans.append(rec)
    if _taps:
        for tap in _taps:
            tap.append(rec)


def to_host(t: torch.Tensor, name: str):
    """``t.cpu().numpy()``; with the recorder on, a span ``name`` around
    the copy (one wait for the card, so none for an empty tensor)."""
    if not HOSTTRACE or t.numel() == 0:
        return t.cpu().numpy()
    sp = begin(name)
    a = t.cpu().numpy()
    end(sp)
    return a


def host_spans() -> list:
    """The closed spans recorded since the last clear, as :class:`Span`."""
    return [Span._make(r) for r in _spans]


def host_trace(tag: str, key, **kw) -> None:
    if HOSTTRACE:
        _trace_events.append((time.perf_counter(), tag, key, kw))


def _collect_spans(events):
    """Fold raw (t, tag, key, kwargs) events into named series.

    ``<name>.start``/``.end`` pairs become duration spans (ms); kwarg
    values become ``#<tag>`` series.  Non-numeric kwarg values are
    counted, never aggregated: a string kwarg cast to float would raise
    inside PopSift.uninit.  Events are ordered by time alone, so events of
    one instant keep the order they were recorded in: a ``.start`` stays
    before its ``.end``, and keys of different types are never compared."""
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


def _series(clear: bool) -> dict:
    """Every span's ms and every series' values by name, from both the
    recorder and host_trace's events."""
    series = _collect_spans(_trace_events)
    for name, start, end_, *_ in _spans:
        series[name].append((end_ - start) * 1e-6)
    if clear:
        _trace_events.clear()
        _spans.clear()
    return series


def host_trace_snapshot(clear: bool = False) -> dict:
    """Per-pass attribution: return {name: (count, sum)} of all span /
    kwarg series recorded so far; optionally clear the buffer."""
    return {name: (len(v), float(sum(v)))
            for name, v in _series(clear).items()}


def host_trace_summary() -> None:
    if not HOSTTRACE or not (_trace_events or _spans):
        return
    import numpy as np
    spans = _series(clear=True)
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
    that torch.profiler records, with ``device`` a CUDA device also an
    NVTX range (a CPU-only build of PyTorch has no NVTX), and with the
    recorder on a host span inside the range."""
    nvtx = device is not None and torch.device(device).type == "cuda"
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        sp = begin(name) if HOSTTRACE else None
        try:
            yield
        finally:
            if sp is not None:
                end(sp)
            if nvtx:
                torch.cuda.nvtx.range_pop()


def _trace_us(t_ns: int, base_ns: int) -> float:
    """A recorder stamp in the Chrome trace's time base (us after the
    trace's ``baseTimeNanoseconds``)."""
    return (t_ns - base_ns) / 1e3


def _append_spans(path: str, spans: list) -> None:
    """Add ``spans`` to the Chrome trace at ``path``: a complete event on
    its thread for a span that one thread opened and closed, an async
    pair for ``job`` and ``queue``; ``request``, ``id`` and ``parent`` in
    ``args``."""
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    events = doc.setdefault("traceEvents", [])
    for s in map(Span._make, spans):
        ev = dict(name=s.name, cat="host_span", pid=pid, tid=s.thread,
                  ts=_trace_us(s.start, base),
                  args=dict(request=s.request, id=s.id, parent=s.parent))
        if s.detached:
            events.append(dict(ev, ph="b", id=s.id))
            events.append(dict(ev, ph="e", id=s.id,
                               ts=_trace_us(s.end, base)))
        else:
            events.append(dict(ev, ph="X", dur=(s.end - s.start) / 1e3))
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profiler trace context: torch.profiler over the block (the CPU
    operations of every thread, the pipeline's workers included, and with
    a CUDA device every kernel and copy on it), exported as a Chrome trace
    into ``log_dir`` with the block's host spans appended (the recorder is
    on inside the block).  If ``log_dir`` is None, uses the
    POPSIFT_TPU_TRACE env var; no-op when neither is set."""
    log_dir = log_dir or os.environ.get("POPSIFT_TPU_TRACE")
    if not log_dir:
        yield
        return
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    was_on = HOSTTRACE
    tap: list = []
    _taps.append(tap)
    enable(True)
    try:
        with profile(activities=acts, experimental_config=_ExperimentalConfig(
                profile_all_threads=True)) as prof:
            yield
    finally:
        enable(was_on)
        _taps.remove(tap)
    path = os.path.join(
        log_dir, f"popsift_torch_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    _append_spans(path, tap)


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
