"""The readers of the program's request-scoped host spans: readback
waits and their count, dispatch, upload, queue and the matcher's span,
each on a synthetic ``run.spans`` and on one without its spans (a
program that records none of them)."""

import types

import pytest

from benchmark.lib import spec

# 10 images: extract 200 ms, of which readback 50 ms in 40 + 60 + 30
# syncs; the matcher's own readbacks lie outside the extraction
SPANS = {"extract": (10, 200.0), "stage1.o0": (10, 80.0),
         "readback.compact": (40, 20.0), "readback.rows": (60, 18.0),
         "readback.download": (30, 12.0), "readback.match": (25, 9.0),
         "upload": (10, 4.0), "queue": (10, 1.5), "match": (5, 30.0),
         "#descriptors": (10, 5.0)}

WANT = {"readback_ms.batch": 5.0, "readback_ms.live": 5.0,
        "readback_ms.pairs": 5.0, "readbacks_per_image.batch": 13.0,
        "dispatch_ms.batch": 15.0, "upload_ms.batch": 0.4,
        "queue_ms.live": 0.15, "match_host_ms.pairs": 6.0}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_on_synthetic_spans(name):
    run = types.SimpleNamespace(spans=dict(SPANS), span_s=1.0)
    assert spec.reader(name)(run) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_without_its_spans(name):
    read = spec.reader(name)
    assert read(types.SimpleNamespace(spans=None)) is None
    # the parent program's spans: extract and the stages, no new ones
    old = {"extract": (10, 200.0), "stage1.o0": (10, 80.0),
           "job": (10, 400.0), "#extrema": (10, 5.0)}
    assert read(types.SimpleNamespace(spans=old)) is None


def test_dispatch_and_readback_add_up_to_the_extract_span():
    run = types.SimpleNamespace(spans=dict(SPANS))
    total = (spec.reader("dispatch_ms.batch")(run)
             + spec.reader("readback_ms.batch")(run))
    assert total == pytest.approx(SPANS["extract"][1] / SPANS["extract"][0])


def test_every_new_reader_is_declared_where_its_spans_are():
    bench = spec.benchmark()
    declared = {m["name"]: m for m in bench["per_layer"]}
    for name in WANT:
        m = declared[name]
        cells = m["workloads"]
        suffix = name.rsplit(".", 1)[1]
        assert all(c.endswith(suffix if suffix != "batch" else "batch8")
                   for c in cells), (name, cells)
