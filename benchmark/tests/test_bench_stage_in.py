"""The reader of the program's ``stage_in`` spans: their mean on a
synthetic ``run.spans``, and None on a program that records no such span
(a program whose worker uploads the job's host copy)."""

import types

import pytest

from benchmark.lib import spec

NAME = "stage_in_ms.photo"


def test_the_mean_stage_in_span():
    # 10 photographs staged in 84 ms, 23 bands each
    spans = {"job": (10, 600.0), "stage_in": (10, 84.0),
             "#stage_in.bands": (10, 230.0), "upload": (10, 0.3),
             "extract": (10, 300.0)}
    run = types.SimpleNamespace(spans=spans, span_s=1.0)
    assert spec.reader(NAME)(run) == pytest.approx(8.4)


@pytest.mark.parametrize("spans", [
    None, {},
    {"job": (10, 600.0), "upload": (10, 150.0), "extract": (10, 300.0)}])
def test_none_without_the_span(spans):
    assert spec.reader(NAME)(types.SimpleNamespace(spans=spans)) is None


def test_declared_for_the_photograph_cell():
    (m,) = [m for m in spec.benchmark()["per_layer"] if m["name"] == NAME]
    assert m["workloads"] == ["av-photo-24mp.live"]
    assert (m["layer"], m["moves"], m["source"], m["unit"]) == (
        "pipeline", "images_per_s", "program_span", "ms")
