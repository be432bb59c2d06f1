"""The reader of the program's one stage-2 pass: the ``stage2`` span
summed per ``extract``, on synthetic ``run.spans``, and None on a program
that records no such span (the per-octave ``stage2.o<k>`` spans of
earlier programs do not count)."""

import types

import pytest

from benchmark.lib import spec

NAME = "stage2_pass_ms.batch"


def test_sums_the_pass_per_extraction():
    # 10 images, one pass each, 35 ms of passes in all
    spans = {"extract": (10, 200.0), "stage1.o0": (10, 80.0),
             "stage2": (10, 35.0), "#stage2.octaves": (10, 80.0),
             "readback.rows": (10, 3.0)}
    run = types.SimpleNamespace(spans=spans, span_s=1.0)
    assert spec.reader(NAME)(run) == pytest.approx(3.5)


@pytest.mark.parametrize("spans", [
    None, {},
    {"extract": (10, 200.0), "stage2.o0": (10, 70.0),
     "stage2.o1": (10, 10.0)},
    {"stage2": (10, 35.0)}])
def test_none_without_the_pass(spans):
    assert spec.reader(NAME)(types.SimpleNamespace(spans=spans)) is None


def test_declared_for_the_batch_cells():
    (m,) = [m for m in spec.benchmark()["per_layer"] if m["name"] == NAME]
    assert m["workloads"] == ["1080p-default.batch8", "1080p-notile.batch8"]
    assert (m["layer"], m["moves"], m["source"]) == (
        "extract stages", "images_per_s", "program_span")
