"""popsift_torch's repeatability evaluation on the CPU.

``eval/repeatability.py`` is a copy of the JAX package's: ``warp_affine``
gives the same image bit for bit and ``evaluate_pair`` the same result on
the same features.  The four cases of ``tests/test_repeatability.py``
(identity, translation, rotation by 12 degrees, scale 1.15) then run on
the port's CPU extraction with that test's scene and thresholds; no JAX
compile is needed, so they are not slow here.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

from popsift_tpu.eval import repeatability as jrep  # noqa: E402

import popsift_torch as pt  # noqa: E402
from popsift_torch.eval import repeatability as trep  # noqa: E402
from popsift_torch.extract import extract_features  # noqa: E402

from torch_parity import one_thread  # noqa: E402


@pytest.fixture(scope="module")
def scene():
    """tests/test_repeatability.py's scene."""
    rng = np.random.default_rng(3)
    h, w = 160, 200
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w), np.float32)
    for _ in range(25):
        cx = rng.uniform(20, w - 20)
        cy = rng.uniform(20, h - 20)
        s = rng.uniform(2.0, 6.0)
        img += rng.uniform(0.3, 1.0) * np.exp(
            -(((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s * s))) \
            * rng.choice([-1.0, 1.0])
    img = img - img.min()
    img = img / img.max()
    return (img * 255).astype(np.uint8)


def _rotation(deg, centre):
    th = np.deg2rad(deg)
    A = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    return A, centre - A @ centre


CASES = {
    "identity": (np.eye(2), np.zeros(2)),
    "translation": (np.eye(2), np.array([7.0, -4.0])),
    "rotation": _rotation(12, np.array([100.0, 80.0])),
    "scale": (np.eye(2) * 1.15, np.zeros(2)),
}


def _extract(img):
    with one_thread():
        return extract_features(img, pt.Config(), device="cpu")


@pytest.mark.parametrize("case", list(CASES))
def test_warp_affine_matches_jax(scene, case):
    A, t = CASES[case]
    for img in (scene, scene.astype(np.float32)):
        got = trep.warp_affine(img, A, t)
        want = jrep.warp_affine(img, A, t)
        assert got.dtype == want.dtype
        assert np.array_equal(got.view(np.uint8), want.view(np.uint8))
    got = trep.warp_affine(scene, A, t, out_shape=(120, 150))
    assert np.array_equal(got, jrep.warp_affine(scene, A, t,
                                                out_shape=(120, 150)))


@pytest.fixture(scope="module")
def results(scene):
    fa = _extract(scene)
    out = {}
    for case, (A, t) in CASES.items():
        warped = trep.warp_affine(scene, A, t)
        fb = _extract(warped)
        out[case] = (fa, fb, A, t, warped.shape)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_evaluate_pair_matches_jax(results, case):
    fa, fb, A, t, shape = results[case]
    got = trep.evaluate_pair(fa, fb, A, t, shape)
    want = jrep.evaluate_pair(fa, fb, A, t, shape)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def _run(results, case):
    fa, fb, A, t, shape = results[case]
    return trep.evaluate_pair(fa, fb, A, t, shape)


def test_identity_repeatability(results):
    res = _run(results, "identity")
    assert res.n_ref > 10
    assert res.repeatability > 0.99
    assert res.matching_score > 0.99


def test_translation_repeatability(results):
    res = _run(results, "translation")
    assert res.repeatability > 0.85
    assert res.matching_score > 0.85


def test_rotation_repeatability(results):
    res = _run(results, "rotation")
    assert res.repeatability > 0.75
    assert res.matching_score > 0.75


def test_scale_repeatability(results):
    res = _run(results, "scale")
    assert res.repeatability > 0.75
