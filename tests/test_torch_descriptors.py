"""popsift_torch loop-mode descriptors and their normalisation against
popsift_tpu's: both sides get the same JAX gradient field (as numpy) and
the same (keypoint, orientation) rows, so the stage is judged on its own.

Rows are the JAX package's refined extrema of a 240x320 texture with each
of their JAX orientations, plus random rows (positions up to 2 px outside
the image, every blur level, sigmas up to the configuration's largest,
angles anywhere in [-pi, pi)).  The field and extrema come from
test_torch_orientation's helpers.

Tolerances: unnormalised descriptors within rtol 1e-4 plus 1e-6 of the
row's largest entry (the same non-negative weights summed in another
order; trilinear binning is continuous, so a last-bit difference at a bin
edge moves no weight);
RootSift and L2-normalised descriptors within 1e-4 absolute.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

from popsift_tpu.ops import descriptors as jdesc  # noqa: E402
from popsift_tpu.ops import orientation as jori  # noqa: E402

from popsift_torch.ops import descriptors as tdesc  # noqa: E402

from test_torch_orientation import OCTAVES, _jax_octaves  # noqa: E402

N_RANDOM = 400


@functools.lru_cache(maxsize=None)
def _rows(o):
    """(field, x, y, lpos, sigma, angle) numpy rows of octave ``o``."""
    plan, octs = _jax_octaves()
    field, x, y, lp, sg = octs[OCTAVES.index(o)]
    L = field.shape[0] // 2
    h, w = field.shape[1:]
    num, ori = jax.jit(lambda f: jori.assign_orientations(
        f, 0, 0, x, y, lp, sg, np.ones(x.shape, bool), w, h,
        plan.ori_win))(field)
    num, ori = np.asarray(num), np.asarray(ori)
    feat = np.repeat(np.arange(len(x)), num)
    k = np.concatenate([np.arange(n) for n in num]) if len(num) else feat
    rng = np.random.default_rng(200 + o)
    smax = jori.max_sigma(plan.sigma0, plan.levels)
    rows = [
        np.concatenate([x[feat], rng.uniform(-2.0, w + 1.0, N_RANDOM)]),
        np.concatenate([y[feat], rng.uniform(-2.0, h + 1.0, N_RANDOM)]),
        np.concatenate([lp[feat], rng.integers(0, L, N_RANDOM)]),
        np.concatenate([sg[feat], rng.uniform(plan.sigma0, smax, N_RANDOM)]),
        np.concatenate([ori[feat, k], rng.uniform(-np.pi, np.pi, N_RANDOM)]),
    ]
    dts = (np.float32, np.float32, np.int32, np.float32, np.float32)
    return (field,) + tuple(r.astype(d) for r, d in zip(rows, dts)) \
        + (len(feat),)


@functools.lru_cache(maxsize=None)
def _jax_descriptors(o):
    plan, _ = _jax_octaves()
    field, x, y, lp, sg, ang, _ = _rows(o)
    h, w = field.shape[1:]
    valid = np.ones(x.shape, bool)

    def fn(f, x, y, lp, sg, ang, v):
        d = jdesc.loop_descriptors(f, 0, 0, x, y, lp, sg, ang, v, w, h,
                                   plan.desc_win)
        return (d, jdesc.normalize_rootsift(d, 0, v),
                jdesc.normalize_l2(d, 0, v))

    return tuple(np.array(a) for a in jax.jit(fn)(field, x, y, lp, sg, ang,
                                                  valid))


@functools.lru_cache(maxsize=None)
def _torch_descriptors(o):
    plan, _ = _jax_octaves()
    field, x, y, lp, sg, ang, _ = _rows(o)
    return tdesc.loop_descriptors(
        torch.as_tensor(field), *(torch.as_tensor(v)
                                  for v in (x, y, lp, sg, ang)),
        plan.desc_win)


@pytest.mark.parametrize("o", OCTAVES)
def test_loop_descriptors_match(o):
    jd, _, _ = _jax_descriptors(o)
    d = _torch_descriptors(o).numpy()
    assert _rows(o)[-1] > 0
    assert d.shape == jd.shape == (len(_rows(o)[1]), 128)
    scale = jd.max(axis=1, keepdims=True)
    assert (scale > 0).all()
    # near-empty bins (1e-6 of the row's largest) may differ more, relative
    # to their size, through exp() of the two maths libraries
    err = np.abs(d - jd)
    assert (err <= 1e-4 * np.abs(jd) + 1e-6 * scale).all(), \
        (err / (np.abs(jd) + 1e-6 * scale)).max()


@pytest.mark.parametrize("o", OCTAVES)
def test_normalised_descriptors_match(o):
    _, jrs, jl2 = _jax_descriptors(o)
    d = _torch_descriptors(o)
    rs = tdesc.normalize_rootsift(d, 0).numpy()
    l2 = tdesc.normalize_l2(d, 0).numpy()
    assert np.abs(rs - jrs).max() <= 1e-4
    assert np.abs(l2 - jl2).max() <= 1e-4


@pytest.mark.parametrize("norm_multi", [0, 2])
def test_normalisation_on_random_descriptors(norm_multi):
    rng = np.random.default_rng(norm_multi)
    d = (rng.random((300, 128)) ** 3).astype(np.float32)
    d[:3] = 0.0
    valid = np.ones(300, bool)
    jrs = np.asarray(jdesc.normalize_rootsift(d, norm_multi, valid))
    jl2 = np.asarray(jdesc.normalize_l2(d, norm_multi, valid))
    t = torch.as_tensor(d)
    np.testing.assert_allclose(tdesc.normalize_rootsift(t, norm_multi)
                               .numpy(), jrs, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tdesc.normalize_l2(t, norm_multi).numpy(),
                               jl2, rtol=1e-5, atol=1e-6)
    assert (tdesc.normalize_rootsift(t, norm_multi)[:3] == 0).all()


@pytest.mark.parametrize("levels", [2, 3, 4, 5])
@pytest.mark.parametrize("sigma", [1.2, 1.6, 2.0])
def test_window_size_matches(levels, sigma):
    assert tdesc.desc_window_size(sigma, levels) \
        == jdesc.desc_window_size(sigma, levels)
