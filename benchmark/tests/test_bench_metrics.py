"""The metric readers and the work counts."""

import types

import numpy as np
import pytest

from benchmark.lib import records, spec, work
from benchmark.reference import sift


def _window(latencies, t0=0.0, seconds=1.0, step=0.01):
    w = records.Window(t0, t0 + seconds)
    for k, lat in enumerate(latencies):
        sent = t0 + k * step
        w.requests.append(records.Request(k, sent, sent + lat, True))
    return w


def test_percentile_is_over_every_request_sent():
    lat = [0.010] * 95 + [0.050] * 5 + [0.500]   # the last ends after close
    run = types.SimpleNamespace(window=_window(lat))
    got = spec.reader("frame_ms_p95")(run)
    assert got == pytest.approx(np.percentile(np.array(lat) * 1e3, 95))
    assert got > 10.0


def test_rates_are_over_the_whole_window():
    w = _window([0.02] * 50, seconds=2.0, step=0.039)
    w.requests.append(records.Request(99, 1.99, 2.5, True))  # after close
    run = types.SimpleNamespace(window=w)
    assert spec.reader("images_per_s")(run) == pytest.approx(50 / 2.0)
    assert spec.reader("pairs_per_s")(run) == pytest.approx(50 / 2.0)


def test_span_readers():
    spans = {"extract": (10, 200.0), "stage1.o0": (10, 50.0),
             "stage1.o1": (10, 30.0), "stage2.o0": (10, 70.0),
             "stage2.o10": (10, 10.0), "#extrema": (10, 5.0)}
    run = types.SimpleNamespace(spans=spans, span_s=0.25)
    assert spec.reader("handoff_ms.batch")(run) == pytest.approx(5.0)
    assert spec.reader("stage1_host_ms.batch")(run) == pytest.approx(8.0)
    assert spec.reader("extract_host_ms.pairs")(run) == pytest.approx(20.0)
    none = types.SimpleNamespace(spans=None)
    assert spec.reader("handoff_ms.batch")(none) is None
    # a program that records no stage1.o<k> span: nothing, not 0
    no_stage1 = {k: v for k, v in spans.items()
                 if not k.startswith("stage1.")}
    assert spec.reader("stage1_host_ms.batch")(
        types.SimpleNamespace(spans=no_stage1, span_s=0.25)) is None


def test_trace_readers():
    run = types.SimpleNamespace(
        trace=dict(window_s=2.0, busy_s=0.5,
                   scope_device_s={"pyramid": 0.004}),
        launches={"detect": 18, "octave_chain": 8}, slice_requests=2,
        plan=dict(input_w=640, input_h=480, dims=((1280, 960),),
                  levels=3, spans=[1, 1, 1, 1, 1, 1]))
    for name in ("device_idle_pct.batch", "device_idle_pct.live",
                 "device_idle_pct.pairs"):
        assert spec.reader(name)(run) == pytest.approx(75.0)
    assert spec.reader("launches_per_image.batch")(run) == 13.0
    bound = (640 * 480 + 11 * 1280 * 960 * 4) / 3.35e12
    assert spec.reader("pyramid_roofline")(run) == pytest.approx(
        100 * bound * 2 / 0.004)
    run.trace["scope_device_s"] = {}
    assert spec.reader("pyramid_roofline")(run) is None


def test_match_reader():
    w = _window([0.02] * 3)
    for r, m in zip(w.requests, (0.001, None, 0.003)):
        r.match_s = m
    run = types.SimpleNamespace(window=w)
    assert spec.reader("match_ms.pairs")(run) == pytest.approx(2.0)


@pytest.mark.parametrize("w,h,octaves", [(1920, 1080, 9), (640, 480, 7)])
def test_pyramid_work_at_the_plan_shapes(w, h, octaves):
    s = sift.settings_of({})
    plan = sift.make_plan(s, w, h)
    assert len(plan.dims) == octaves and plan.dims[0] == (2 * w, 2 * h)
    by_hand = w * h + 11 * 4 * 4 * w * h
    for (ow, oh) in plan.dims[1:]:
        by_hand += 4 * ow * oh + 11 * 4 * ow * oh
    assert work.pyramid_bytes(w, h, plan.dims, plan.levels) == by_hand
    inc, _ = sift.gauss_tables(s)
    spans = [sp for _, sp in inc]
    assert spans == [6, 6, 8, 9, 11, 14]
    flops = work.pyramid_flops(plan.dims, spans)
    assert flops == sum(
        ow * oh * (sum(4 * (2 * sp - 1) for sp in spans[0 if o == 0 else 1:])
                   + 5) for o, (ow, oh) in enumerate(plan.dims))
    # the bytes bound the scale space at these shapes
    assert work.pyramid_seconds(w, h, plan.dims, plan.levels, spans) == \
        pytest.approx(by_hand / work.PEAK_BYTES_PER_S)
