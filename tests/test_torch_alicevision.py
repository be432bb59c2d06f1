"""AliceVision's popSIFT deployment (``benchmark/configs/
alicevision-popsift-24mp.json``) on the CPU.

* The port, through ``PopSift(..., FloatImages)``, against the plain
  reference ``benchmark/reference/sift_filtered.py`` on a 320x240 float32
  photograph at the configuration's settings, with ``filter_max_extrema``
  low enough that the grid filter engages: the benchmark cell's limits
  hold, and the filter keeps the same extrema on both sides, under
  LargestScaleFirst and SmallestScaleFirst.
* An octave keeps every refined extremum up to ``max_extrema``: on a
  field of dots whose octave 0 has more extrema than the JAX package's
  fixed buffer (16,384), nothing is dropped, and with a lower
  ``max_extrema`` the octave keeps exactly that many, the reference's
  first ones, and ``#stage1.overflow`` counts the rest;
  ``#stage1.budget`` counts the candidates that the compaction's
  per-block budget dropped, as many as the reference's budget drops.
* A job holds its own copy of the caller's image, one copy whatever the
  image's layout, so the caller may reuse its buffer at once (on a CUDA
  card ``enqueue`` stages the image instead:
  ``tests/test_torch_pipeline_stagein.py``).
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

from popsift_tpu import config as jcfg  # noqa: E402
from popsift_tpu import extract as jext  # noqa: E402

import popsift_torch as pt  # noqa: E402
from popsift_torch import extract as ex  # noqa: E402
from popsift_torch import tracing  # noqa: E402
from popsift_torch.gauss import build_gauss_info  # noqa: E402

from benchmark.inputs.photo_float import make_canvas  # noqa: E402
from benchmark.lib import judge  # noqa: E402
from benchmark.reference import sift, sift_filtered  # noqa: E402
from benchmark.run import make_config  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmark")


def _load(*path):
    with open(os.path.join(BENCH, *path)) as f:
        return json.load(f)


CONFIG = _load("configs", "alicevision-popsift-24mp.json")["popsift_config"]
LIMITS = _load("limits", "av-photo-24mp.live.json")


@pytest.fixture
def recorder():
    """The recorder on and empty; off and empty afterwards."""
    was = tracing.HOSTTRACE
    tracing.host_trace_snapshot(clear=True)
    tracing.enable(True)
    yield
    tracing.enable(was)
    tracing.host_trace_snapshot(clear=True)


def _keypoints(f: dict) -> np.ndarray:
    """The (x, y, sigma, octave) rows of a feature set, sorted."""
    rows = np.stack([f["xpos"], f["ypos"], f["sigma"],
                     f["octave"].astype(np.float64)], axis=1)
    return rows[np.lexsort(rows.T[::-1])]


@pytest.mark.parametrize("mode", ["down", "up"])
def test_port_matches_sift_filtered(recorder, mode):
    popsift_config = dict(CONFIG, filter_max_extrema=150,
                          grid_filter_mode=mode)
    image = np.ascontiguousarray(
        make_canvas([23, 1], 248, 328)[4:244, 4:324])
    assert image.dtype == np.float32
    with pt.PopSift(make_config(pt, popsift_config),
                    imode=pt.PopSift.FloatImages, device="cpu") as ps:
        feats = ps.enqueue(320, 240, image).get()
        snap = tracing.host_trace_snapshot()
    ref = sift_filtered.extract(image, sift_filtered.settings_of(
        popsift_config), "cpu")

    total, kept = snap["#filter.total"][1], snap["#filter.kept"][1]
    assert snap["#stage1.overflow"] == (1, 0.0)
    assert kept == feats.get_feature_count() < total / 1.1
    got, want = judge.host_features(feats), judge.reference_features(ref)
    correct, checks = judge.verdict(judge.compare_features(got, want),
                                    LIMITS)
    assert correct, checks
    np.testing.assert_array_equal(_keypoints(got), _keypoints(want))


def _dots(rows: int, cols: int, step: int = 9, seed: int = 0) -> np.ndarray:
    """A field of blurred dots (sigma 1.6), one at a jittered place in
    each step x step cell, float32 in [0, 1]: about one extremum every
    100 pixels of octave 0."""
    rng = np.random.default_rng(seed)
    img = np.zeros((rows * step, cols * step), np.float32)
    y = (np.arange(rows)[:, None] * step + step // 2
         + rng.integers(-3, 4, (rows, cols)))
    x = (np.arange(cols)[None, :] * step + step // 2
         + rng.integers(-3, 4, (rows, cols)))
    img[y, x] = rng.uniform(0.5, 1.0, (rows, cols))
    r = torch.arange(-5, 6, dtype=torch.float32)
    g = torch.exp(-r * r / (2 * 1.6 * 1.6))
    g /= g.sum()
    t = torch.from_numpy(img)[None, None]
    t = torch.nn.functional.conv2d(t, g.view(1, 1, 1, -1), padding=(0, 5))
    t = torch.nn.functional.conv2d(t, g.view(1, 1, -1, 1), padding=(5, 0))
    t = t[0, 0]
    return ((t - t.min()) / (t.max() - t.min())).numpy()


@pytest.fixture(scope="module")
def dense_octave():
    """A 1620x1260 float32 field of dots, its one octave's DoG and its
    candidates in the reference."""
    image = _dots(140, 180)
    settings = sift_filtered.settings_of(dict(CONFIG, octaves=1))
    plan = sift_filtered.make_plan(settings, 1620, 1260)
    img = torch.from_numpy(image)
    _, dog = sift.octave_stack(img, 0, plan, sift.gauss_tables(settings),
                               torch.float32)
    gate = float(np.float32(1.6)
                 * np.float32(sift.plan_peak_threshold(settings)))
    mask = sift.detect(dog, gate)
    zyx = sift.compact_mask(mask, plan.cand_caps[0])
    # the candidates the per-block budget drops, on both sides
    budget = int(mask.sum()) - int(zyx.shape[0])
    return image, settings, plan, dog, zyx, budget


@pytest.mark.parametrize("max_extrema", [100000, 5000])
def test_an_octave_keeps_up_to_max_extrema(recorder, dense_octave,
                                           max_extrema):
    image, settings, plan, dog, zyx, budget = dense_octave
    cfg = make_config(pt, dict(CONFIG, octaves=1, max_extrema=max_extrema))
    old = jext.make_plan(jcfg.Config(octaves=1, threshold=0.005,
                                     upscale_factor=0.0), 1620, 1260)
    tplan = ex.make_plan(cfg, 1620, 1260)
    (_, _, ext), = ex.octave_keypoints_all(
        tplan, build_gauss_info(cfg), ex.to_unit_image(image, "cpu"),
        full_stacks=False, need_field=True)
    x, y, _, sigma = sift.refine(dog, zyx, plan, 0, plan.cand_caps[0])
    survivors = int(x.shape[0])
    # more than the JAX package's fixed buffer holds
    assert survivors > old.ext_caps[0] == 16384
    assert ext.count == min(survivors, max_extrema)
    assert ext.overflow == survivors - ext.count
    snap = tracing.host_trace_snapshot()
    assert snap["#stage1.overflow"] == (1, float(ext.overflow))
    assert budget > 0 and snap["#stage1.budget"] == (1, float(budget))
    # the reference's first max_extrema, in candidate order
    np.testing.assert_array_equal(ext.xpos.numpy(),
                                  x[:ext.count].numpy())
    np.testing.assert_array_equal(ext.ypos.numpy(),
                                  y[:ext.count].numpy())
    np.testing.assert_array_equal(ext.sigma.numpy(),
                                  sigma[:ext.count].numpy())


@pytest.mark.parametrize("layout", ["float32", "float32-window", "float64",
                                    "uint8"])
def test_a_job_holds_its_own_copy_of_the_image(layout):
    canvas = make_canvas([23, 2], 40, 56)
    image = {"float32": np.ascontiguousarray(canvas[:32, :48]),
             "float32-window": canvas[4:36, 4:52],
             "float64": canvas[:32, :48].astype(np.float64),
             "uint8": (canvas[:32, :48] * 255).astype(np.uint8)}[layout]
    imode = (pt.PopSift.ByteImages if layout == "uint8"
             else pt.PopSift.FloatImages)
    with pt.PopSift(make_config(pt, CONFIG), imode=imode,
                    device="cpu") as ps:
        job = ps.enqueue(48, 32, image)
        want = image.astype(np.uint8 if layout == "uint8" else np.float32)
        image[...] = 0        # the caller reuses its buffer at once
        assert job.get() is not None
    held = job.get_img()
    assert tuple(held.shape) == (32, 48) and held.is_contiguous()
    assert held.dtype == (torch.uint8 if layout == "uint8"
                          else torch.float32)
    assert not np.shares_memory(held.numpy(), image)
    np.testing.assert_array_equal(held.numpy(), want)
