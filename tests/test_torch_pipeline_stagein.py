"""The stage-in ring (``pipeline.StageIn``), through which ``PopSift.enqueue``
stages each image onto its device band by band.

Only the slots' pinning, the ring's stream and its events depend on the
device, so on the CPU the same banding runs with plain slots:

* the staged tensor is bit-equal to the input for contiguous float32, a
  canvas window with a row stride, float64 cast band by band (equal to
  ``astype(np.float32)``), uint8, one row, a height that is not a
  multiple of a band's rows, and a row of ``MAX_INPUT_DIM`` float32
  pixels; the caller may zero its array as soon as ``stage`` returns; the
  number of bands follows the shape, and one ring stages image after
  image, its slots taken in turn, keeping the slots' views for the last
  few shapes only;
* a ``PopSift`` on the CPU stages through a CPU ring of its own, whose
  tensor is the job's one copy of the image; with small slots its jobs
  give the features of ``extract_features`` of the caller's array, the
  ``stage_in`` span inside the job's span with the ``#stage_in.bands``
  series, a staging error reported through the job, and the ``--log``
  tree written from the staged image equal to ``dump_all`` of the
  array.

Marked ``card``, and skipped without one: an odd-shaped float photograph
and a byte frame through a real ``PopSift`` on the card, the device image
bit-equal to ``torch.from_numpy(img).cuda()`` and the features bit-equal
to an extraction of that upload.  The file imports no JAX:
``python -m pytest --noconftest -m card
tests/test_torch_pipeline_stagein.py`` runs the card's cases on a machine
without it.
"""

import collections
import filecmp
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import popsift_torch as pt  # noqa: E402
from popsift_torch import pipeline, tracing  # noqa: E402
from popsift_torch.debugdump import dump_all  # noqa: E402
from popsift_torch.device import MAX_INPUT_DIM  # noqa: E402
from popsift_torch.extract import extract_features  # noqa: E402

CPU = torch.device("cpu")
# slot bytes of the banding cases: a few hundred bytes a row, so that an
# image of a few dozen rows takes more bands than the ring has slots
SMALL_SLOT = 4096


def _canvas(h: int, w: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).random((h, w), dtype=np.float32)


def _float64(h, w):
    # float64 values that float32 rounds, ties of the last bit among them
    x = np.random.default_rng(1).random((h, w))
    x[0, :4] = [1 + 2.0 ** -24, 1 + 3 * 2.0 ** -24, 0.1, 1 / 3]
    return x


# name: (the caller's array, the staged dtype, the ring's slot bytes)
CASES = {
    "float32": (lambda: _canvas(150, 50), np.float32, SMALL_SLOT),
    "float32-window": (lambda: _canvas(160, 60, 2)[5:155, 3:53],
                       np.float32, SMALL_SLOT),
    "float64": (lambda: _float64(150, 50), np.float32, SMALL_SLOT),
    "uint8": (lambda: (_canvas(150, 70, 3) * 255).astype(np.uint8),
              np.uint8, SMALL_SLOT),
    "one-row": (lambda: _canvas(1, 50, 4), np.float32, SMALL_SLOT),
    "ragged": (lambda: _canvas(61, 50, 5), np.float32, SMALL_SLOT),
    "max-row": (lambda: _canvas(70, MAX_INPUT_DIM, 6), np.float32,
                pipeline.SLOT_BYTES),
}


def _ring(monkeypatch, slot_bytes: int) -> pipeline.StageIn:
    monkeypatch.setattr(pipeline, "SLOT_BYTES", slot_bytes)
    return pipeline.StageIn(CPU)


def _bands(shape, dtype, slot_bytes: int) -> int:
    h, w = shape
    return math.ceil(h / (slot_bytes // (w * np.dtype(dtype).itemsize)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_staged_tensor_is_bit_equal_to_the_input(case, monkeypatch):
    make, dtype, slot = CASES[case]
    image = make()
    dst, ready, bands = _ring(monkeypatch, slot).stage(image, dtype)
    want = image.astype(dtype)
    assert ready is None and dst.device == CPU
    assert dst.shape == image.shape and dst.is_contiguous()
    assert dst.dtype == {np.uint8: torch.uint8,
                         np.float32: torch.float32}[dtype]
    assert bands == _bands(image.shape, dtype, slot)
    np.testing.assert_array_equal(dst.numpy().view(np.uint8),
                                  want.view(np.uint8))


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_caller_may_zero_its_array_at_once(case, monkeypatch):
    make, dtype, slot = CASES[case]
    image = make()
    want = image.astype(dtype)
    ring = _ring(monkeypatch, slot)
    dst, _, _ = ring.stage(image, dtype)
    image[...] = 0
    # the next image through the ring overwrites every slot again
    ring.stage(np.ones_like(image), dtype)
    np.testing.assert_array_equal(dst.numpy(), want)


def test_one_ring_stages_image_after_image_in_turn(monkeypatch):
    ring = _ring(monkeypatch, SMALL_SLOT)
    images = [_canvas(h, 50, h) for h in (150, 7, 61, 1, 100)]
    turn = 0
    for image in images:
        dst, _, bands = ring.stage(image, np.float32)
        np.testing.assert_array_equal(dst.numpy(), image)
        turn = (turn + bands) % pipeline.SLOTS
        assert ring._next == turn


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_the_slot_views_are_kept_for_the_last_shapes(dtype, monkeypatch):
    ring = _ring(monkeypatch, SMALL_SLOT)
    for h, w in ((150, 50), (40, 70), (61, 33), (150, 50), (9, 1024)):
        image = (_canvas(h, w, w) * 200).astype(dtype)
        dst, _, _ = ring.stage(image, dtype)
        np.testing.assert_array_equal(dst.numpy(), image)
        assert len(ring._views) <= 4 * pipeline.SLOTS
    # once every slot has held the shape, staging it makes no new view
    for _ in range(pipeline.SLOTS):
        ring.stage(image, dtype)
    kept = dict(ring._views)
    dst, _, _ = ring.stage(image, dtype)
    np.testing.assert_array_equal(dst.numpy(), image)
    assert ring._views.keys() == kept.keys()
    assert all(ring._views[k] is v for k, v in kept.items())


@pytest.mark.parametrize("shape,dtype,bands", [
    ((1080, 1920), np.uint8, 1),            # a 1080p byte frame
    ((4000, 6000), np.float32, 23),         # a 24 MP float photograph
    ((3, MAX_INPUT_DIM), np.float32, 1),    # rows of the widest input
])
def test_the_bands_follow_the_shape(shape, dtype, bands):
    slot = pipeline.SLOT_BYTES
    assert slot >= MAX_INPUT_DIM * np.dtype(np.float32).itemsize
    assert _bands(shape, dtype, slot) == bands


def _image() -> np.ndarray:
    """A smooth random texture, 96 x 128, with keypoints in five
    octaves."""
    rng = np.random.default_rng(20)
    img = np.kron(rng.random((12, 16)), np.ones((8, 8)))
    for _ in range(2):
        img = (img + np.roll(img, 1, 0) + np.roll(img, -1, 0)
               + np.roll(img, 1, 1) + np.roll(img, -1, 1)) / 5.0
    img = (img - img.min()) / (img.max() - img.min())
    return (img * 255).astype(np.uint8)


def _inputs(kind: str):
    """(image mode, the caller's array) of a kind of input."""
    img = _image()
    if kind == "byte":
        return pt.ImageMode.BYTE, img
    canvas = np.zeros((110, 140))
    canvas[7:103, 5:133] = img / 255.0
    if kind == "float64":
        return pt.ImageMode.FLOAT, canvas[7:103, 5:133]
    return pt.ImageMode.FLOAT, canvas.astype(np.float32)[7:103, 5:133]


def _staging(ps: pt.PopSift, monkeypatch) -> pt.PopSift:
    """``ps`` on the CPU with a ring of small slots, so that its images
    take several bands."""
    ps._stage_in = _ring(monkeypatch, SMALL_SLOT)
    return ps


def _same_features(a, b) -> None:
    np.testing.assert_array_equal(a.get_descriptors(), b.get_descriptors())
    assert set(a._soa) == set(b._soa)
    for k in a._soa:
        np.testing.assert_array_equal(a._soa[k], b._soa[k])


def test_the_cpu_device_keeps_its_host_copy():
    """On the CPU the job's image is staged through the pipeline's own
    ring, with no stream and no events: the staged tensor is the job's
    one copy of the image."""
    img = _image()
    want = img.copy()
    with pt.PopSift(pt.Config(), device="cpu") as ps:
        ring = ps._stage_in
        assert isinstance(ring, pipeline.StageIn)
        assert ring._stream is None and ring._events is None
        job = ps.enqueue(img.shape[1], img.shape[0], img)
        img[...] = 0          # the caller reuses its buffer at once
        assert job.get().get_feature_count() > 0
    assert job._image_data is None
    got = job.get_img()
    assert got.device == CPU and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["byte", "float64", "float32-window"])
def test_a_staged_job_gives_the_host_copys_features(kind, monkeypatch):
    imode, image = _inputs(kind)
    h, w = image.shape
    want = extract_features(image, pt.Config(), "cpu")
    with _staging(pt.PopSift(pt.Config(), imode=imode, device="cpu"),
                  monkeypatch) as ps:
        job = ps.enqueue(w, h, image)
        staged = image.astype(np.uint8 if kind == "byte" else np.float32)
        image[...] = 0        # the caller reuses its buffer at once
        got = job.get()
    assert job._image_data is None
    np.testing.assert_array_equal(job.get_img().numpy(), staged)
    assert got.get_feature_count() > 0
    _same_features(got, want)


@pytest.fixture
def recorder():
    """The recorder on and empty; off and empty afterwards."""
    was = tracing.HOSTTRACE
    tracing.host_trace_snapshot(clear=True)
    tracing.enable(True)
    yield
    tracing.enable(was)
    tracing.host_trace_snapshot(clear=True)


def test_stage_in_span_and_bands_series(recorder, monkeypatch):
    img = _image()
    h, w = img.shape
    bands = _bands(img.shape, np.uint8, SMALL_SLOT)
    assert bands > 1
    with _staging(pt.PopSift(pt.Config(), device="cpu"), monkeypatch) as ps:
        jobs = [ps.enqueue(w, h, img) for _ in range(2)]
        for j in jobs:
            assert j.get().get_feature_count() > 0
        spans = tracing.host_spans()
        snap = tracing.host_trace_snapshot()
    assert snap["#stage_in.bands"] == (2, 2.0 * bands)
    by_id = {s.id: s for s in spans}
    for j in jobs:
        mine = [s for s in spans if s.request == j.request]
        names = collections.Counter(s.name for s in mine)
        assert names["stage_in"] == 1 and names["upload"] == 1
        (root,) = [s for s in mine if s.name == "job"]
        (sp,) = [s for s in mine if s.name == "stage_in"]
        (queued,) = [s for s in mine if s.name == "queue"]
        assert by_id[sp.parent] is root and sp.detached
        assert root.start <= sp.start <= sp.end <= queued.start
        # the caller's thread staged the image, as it opened the job
        assert sp.thread == root.thread


def test_a_staging_error_is_reported_through_the_job(monkeypatch):
    img = _image()
    h, w = img.shape

    def fail(*_):
        raise RuntimeError("CUDA error: staging failed")
    with _staging(pt.PopSift(pt.Config(), device="cpu"), monkeypatch) as ps:
        monkeypatch.setattr(ps._stage_in, "stage", fail)
        job = ps.enqueue(w, h, img)
        with pytest.raises(RuntimeError, match="staging failed"):
            job.get()
        assert job.get_img() is None and job.get_base() is None
        monkeypatch.undo()
        # the pipeline goes on with the next job
        assert ps.enqueue(w, h, img).get().get_feature_count() > 0


def test_log_mode_all_dumps_the_staged_image(tmp_path, monkeypatch):
    img = _image()
    h, w = img.shape
    cfg = pt.Config()
    cfg.set_log_mode(pt.LogMode.ALL)
    trees = {}
    for side in ("copy", "staged"):
        (tmp_path / side).mkdir()
        monkeypatch.chdir(tmp_path / side)
        if side == "copy":
            dump_all(cfg, img, "pyramid", device="cpu")
            feats = extract_features(img, cfg, "cpu")
        else:
            with _staging(pt.PopSift(cfg, device="cpu"), monkeypatch) as ps:
                feats = ps.enqueue(w, h, img).get()
        trees[side] = (sorted(p.relative_to(tmp_path / side)
                              for p in (tmp_path / side).rglob("*")
                              if p.is_file()), feats)
    names, want = trees["copy"]
    assert names and trees["staged"][0] == names
    _same_features(trees["staged"][1], want)
    match, mismatch, errors = filecmp.cmpfiles(
        tmp_path / "copy", tmp_path / "staged", [str(n) for n in names],
        shallow=False)
    assert not mismatch and not errors and len(match) == len(names)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("kind", ["float-photograph", "byte-frame"])
def test_the_card_stages_the_image_of_its_upload(kind, card):
    if kind == "byte-frame":
        imode, cfg = pt.ImageMode.BYTE, pt.Config()
        image = (_canvas(1080, 1920, 7) * 255).astype(np.uint8)
    else:
        imode, cfg = pt.ImageMode.FLOAT, pt.Config()
        cfg.set_downsampling(0)
        # odd sides, a row stride, and a dozen bands
        image = _canvas(3011, 4017, 8)[6:3005, 8:4009]
    h, w = image.shape
    plain = torch.from_numpy(np.ascontiguousarray(image)).to(card)
    want = extract_features(plain, cfg, card)
    with pt.PopSift(cfg, imode=imode, device=card) as ps:
        job = ps.enqueue(w, h, image)
        image[...] = 0        # the caller reuses its buffer at once
        got = job.get()
        img = job.get_img()
    assert img.device.type == "cuda" and img.dtype == plain.dtype
    assert torch.equal(img, plain)
    assert got.get_feature_count() > 0
    _same_features(got, want)
