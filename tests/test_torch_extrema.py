"""popsift_torch detection, compaction and refinement against
popsift_tpu's, stage by stage: both sides get the same JAX DoG (as numpy)
and, for refinement, the same JAX candidates, so each stage is judged on
its own.  All three SiftModes' gates and step rules are covered.

Tolerances: masks, candidate lists, ok/lpos/cell exactly equal; xn/yn
within 1e-4 px and sigma within rtol 1e-5 (XLA:CPU contracts some
multiply-adds of the 3x3 solve into FMAs, PyTorch does not).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from popsift_tpu import config as jcfg  # noqa: E402
from popsift_tpu import extract as jext  # noqa: E402
from popsift_tpu import gauss as jgauss  # noqa: E402
from popsift_tpu.ops import extrema as jex  # noqa: E402
from popsift_tpu.ops import pyramid as jpyr  # noqa: E402

from popsift_torch import config as tcfg  # noqa: E402
from popsift_torch import extract as text  # noqa: E402
from popsift_torch.kernels.detect import detect  # noqa: E402
from popsift_torch.kernels.refine import refine, refine_compact  # noqa: E402
from popsift_torch.ops import extrema as tex  # noqa: E402

MODES = ["popsift", "vlfeat", "opencv"]


def _texture(h, w, seed):
    rng = np.random.default_rng(seed)
    img = rng.random((h // 8, w // 8)).astype(np.float32)
    img = np.kron(img, np.ones((8, 8), np.float32))
    for _ in range(2):
        img = (img + np.roll(img, 1, 0) + np.roll(img, -1, 0)
               + np.roll(img, 1, 1) + np.roll(img, -1, 1)) / 5.0
    img = (img - img.min()) / (img.max() - img.min())
    return (img * 255).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def _jax_dogs(h, w):
    img = _texture(h, w, seed=7 * h + w)
    cfg = jcfg.Config()
    plan = jext.make_plan(cfg, w, h)
    gauss = jgauss.build_gauss_info(cfg)

    def fn(im):
        im = im.astype(jnp.float32) * (1.0 / 255.0)
        return jpyr.build_pyramid_and_dogs(
            im, gauss, plan.dims, plan.levels, plan.gauss_mode,
            plan.scaling_mode, plan.sift_mode, plan.upscale_factor)[1]

    return plan, [np.array(d) for d in jax.jit(fn)(img)]


def _plans(mode, w, h):
    j = jcfg.Config(sift_mode=jcfg.SiftMode(mode))
    t = tcfg.Config(sift_mode=tcfg.SiftMode(mode))
    return j, jext.make_plan(j, w, h), text.make_plan(t, w, h)


@functools.lru_cache(maxsize=None)
def _jax_detect(mode, o, h=120, w=160):
    _, dogs = _jax_dogs(h, w)
    jc, jplan, _ = _plans(mode, w, h)
    dog = dogs[o]

    def fn(d):
        mask = jex.detect_candidates(d, jplan.sift_mode, jplan.peak_threshold)
        return mask, jex.compact_mask(mask, jplan.cand_caps[o])

    mask, comp = jax.jit(fn)(dog)
    return np.array(mask), tuple(np.array(c) for c in comp)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("o", [0, 1, 2])
def test_candidate_mask_and_compaction_match(mode, o):
    plan, dogs = _jax_dogs(120, 160)
    _, jplan, tplan = _plans(mode, 160, 120)
    jmask, (jx, jy, jz, jvalid, jcount, joverflow) = _jax_detect(mode, o)
    dog = torch.as_tensor(dogs[o])
    mask = detect(dog, tplan.sift_mode, tplan.peak_threshold)
    assert mask.dtype == torch.uint8 and mask.shape == jmask.shape
    np.testing.assert_array_equal(mask.numpy().astype(bool), jmask)
    assert jmask.sum() > 0

    cap = tplan.cand_caps[o]
    cands = tex.compact_mask(mask, cap)
    assert (cands.count, cands.overflow) == (int(jcount), int(joverflow))
    # JAX layout: fixed capacity, invalid slots parked at x=1, y=1, z=0
    px = np.ones(cap, np.int32)
    py = np.ones(cap, np.int32)
    pz = np.zeros(cap, np.int32)
    px[:cands.count] = cands.x.numpy()
    py[:cands.count] = cands.y.numpy()
    pz[:cands.count] = cands.z.numpy()
    np.testing.assert_array_equal(px, jx)
    np.testing.assert_array_equal(py, jy)
    np.testing.assert_array_equal(pz, jz)
    np.testing.assert_array_equal(np.arange(cap) < cands.count, jvalid)


def test_compaction_clamps_at_capacity():
    mask = torch.zeros((2, 9, 11), dtype=torch.uint8)
    mask[0, 2, 3] = mask[0, 2, 7] = mask[1, 1, 1] = mask[1, 5, 2] = 1
    c = tex.compact_mask(mask, 3)
    jc = jax.jit(lambda m: jex.compact_mask(m, 3))(mask.numpy().astype(bool))
    assert (c.count, c.overflow) == (int(jc[4]), int(jc[5])) == (3, 1)
    np.testing.assert_array_equal(c.x.numpy(), np.asarray(jc[0]))
    np.testing.assert_array_equal(c.y.numpy(), np.asarray(jc[1]))
    np.testing.assert_array_equal(c.z.numpy(), np.asarray(jc[2]))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("o", [0, 1, 2])
def test_refinement_matches(mode, o):
    plan, dogs = _jax_dogs(120, 160)
    _, jplan, tplan = _plans(mode, 160, 120)
    _, (jx, jy, jz, jvalid, jcount, _) = _jax_detect(mode, o)
    n = int(jcount)
    w, h = jplan.dims[o]
    g = jplan.filter_grid_size
    dog = dogs[o]

    def fn(d, cx, cy, cz, cv):
        return jex.refine_extrema_multi(
            [d], [(cx, cy, cz + 1, cv)], jplan.sift_mode, jplan.sigma0,
            jplan.sigma_k, jplan.peak_threshold, jplan.edge_limit,
            [(w / g, h / g)], g, true_dims=[(w, h)])[0]

    ref = [np.array(v)[:n] for v in jax.jit(fn)(dog, jx, jy, jz, jvalid)]
    jxn, jyn, jlpos, jsigma, jcell, jok = ref

    p = text.refine_params_for(tplan, o, dog.shape[0])
    xn, yn, lpos, sigma, cell, ok = refine(
        torch.as_tensor(dog), torch.as_tensor(jx[:n]),
        torch.as_tensor(jy[:n]), torch.as_tensor(jz[:n] + 1), p)
    ok = ok.numpy()
    np.testing.assert_array_equal(ok, jok)
    assert jok.any()
    np.testing.assert_array_equal(lpos.numpy()[ok], jlpos[ok])
    np.testing.assert_array_equal(cell.numpy()[ok], jcell[ok])
    np.testing.assert_allclose(xn.numpy()[ok], jxn[ok], rtol=0, atol=1e-4)
    np.testing.assert_allclose(yn.numpy()[ok], jyn[ok], rtol=0, atol=1e-4)
    np.testing.assert_allclose(sigma.numpy()[ok], jsigma[ok], rtol=1e-5)

    # extremum compaction keeps the survivors in candidate order
    cap = max(1, int(jok.sum()) - 1)
    ext = tex.compact_extrema(xn, yn, lpos, sigma, cell,
                              torch.as_tensor(ok), cap)
    jext_ = jax.jit(lambda *a: jex.compact_extrema(*a, cap))(
        *(jnp.asarray(v) for v in (jxn, jyn, jlpos, jsigma, jcell, jok)))
    assert (ext.count, ext.overflow) == (int(jext_.count),
                                         int(jext_.overflow))
    np.testing.assert_array_equal(ext.lpos.numpy(),
                                  np.asarray(jext_.lpos)[:ext.count])
    np.testing.assert_allclose(ext.xpos.numpy(),
                               np.asarray(jext_.xpos)[:ext.count], atol=1e-4)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("o", [1, 2])
def test_compacted_refinement_matches(mode, o):
    """K4's compacting entry (refine_compact; its plain form on the CPU)
    against JAX refine_extrema_multi + compact_extrema on the JAX
    candidates' DoG, with a capacity that overflows: the same count and
    overflow, lpos and cell exactly, positions and sigma as in
    test_refinement_matches."""
    plan, dogs = _jax_dogs(120, 160)
    _, jplan, tplan = _plans(mode, 160, 120)
    _, (jx, jy, jz, jvalid, jcount, _) = _jax_detect(mode, o)
    w, h = jplan.dims[o]
    g = jplan.filter_grid_size
    dog = dogs[o]

    def fn(d, cx, cy, cz, cv):
        return jex.refine_extrema_multi(
            [d], [(cx, cy, cz + 1, cv)], jplan.sift_mode, jplan.sigma0,
            jplan.sigma_k, jplan.peak_threshold, jplan.edge_limit,
            [(w / g, h / g)], g, true_dims=[(w, h)])[0]

    ref = jax.jit(fn)(dog, jx, jy, jz, jvalid)
    kept = int(np.asarray(ref[5])[:int(jcount)].sum())
    assert kept > 2
    cap = kept - 2
    jext_ = jax.jit(lambda *a: jex.compact_extrema(*a, cap))(*ref)

    mask = detect(torch.as_tensor(dog), tplan.sift_mode, tplan.peak_threshold)
    cands = tex.compact_mask(mask, tplan.cand_caps[o])
    assert cands.count == int(jcount)
    p = text.refine_params_for(tplan, o, dog.shape[0])
    ext = refine_compact(torch.as_tensor(dog), cands, p, cap)
    assert (ext.count, ext.overflow) == (int(jext_.count),
                                         int(jext_.overflow)) == (cap, 2)
    for k in ("lpos", "cell"):
        np.testing.assert_array_equal(getattr(ext, k).numpy(),
                                      np.asarray(getattr(jext_, k))[:cap])
    for k in ("xpos", "ypos"):
        np.testing.assert_allclose(getattr(ext, k).numpy(),
                                   np.asarray(getattr(jext_, k))[:cap],
                                   rtol=0, atol=1e-4)
    np.testing.assert_allclose(ext.sigma.numpy(),
                               np.asarray(jext_.sigma)[:cap], rtol=1e-5)
