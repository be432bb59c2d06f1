"""The reduction of a profiler trace (benchmark/lib/trace.py) on a
hand-made Chrome trace."""

import pytest

from benchmark.lib import trace


def _x(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    _x("bench.slice", "user_annotation", 0, 1000, tid=1),
    _x("bench.get", "user_annotation", 10, 980, tid=1),
    _x("pyramid", "user_annotation", 0, 300, tid=2),
    _x("detect", "user_annotation", 300, 300, tid=2),
    _x("cudaLaunchKernel", "cuda_runtime", 50, 5, tid=2, corr=1),
    _x("cudaLaunchKernel", "cuda_runtime", 60, 5, tid=2, corr=2),
    _x("cudaLaunchKernel", "cuda_runtime", 350, 5, tid=2, corr=3),
    _x("octave_chain", "kernel", 100, 100, corr=1),
    _x("octave_chain", "kernel", 150, 100, corr=2),      # overlaps
    _x("detect", "kernel", 400, 50, corr=3),
    _x("Memcpy DtoH", "gpu_memcpy", 900, 200),            # past the end
]


def test_busy_scopes_and_ops():
    r = trace.reduce(EVENTS)
    assert r["window_s"] == pytest.approx(1000e-6)
    assert r["busy_s"] == pytest.approx((150 + 50 + 100) * 1e-6)
    assert r["scope_device_s"]["pyramid"] == pytest.approx(200e-6)
    assert r["scope_device_s"]["detect"] == pytest.approx(50e-6)
    assert r["device_ops"][0] == ["octave_chain", pytest.approx(200e-6)]


def test_idle_gaps_by_the_launching_thread_then_the_harness():
    r = trace.reduce(EVENTS)
    gaps = dict(r["idle_gaps"])
    # idle 0-100 (pyramid), 250-400 (mid 325: detect), 450-900 (mid 675:
    # no scope of the worker)
    assert gaps["pyramid/bench.get"] == pytest.approx(100e-6)
    assert gaps["detect/bench.get"] == pytest.approx(150e-6)
    assert gaps["none/bench.get"] == pytest.approx(450e-6)
    assert sum(gaps.values()) == pytest.approx(1000e-6 - r["busy_s"])


def test_a_trace_without_the_slice_is_refused():
    with pytest.raises(RuntimeError):
        trace.reduce(EVENTS[1:])
