"""popsift_torch's fused octave chain (K7's plain version) and the pyramid
that uses it, against popsift_tpu.

* The plain chain against ``octave_chain_fused(..., interpret=True)``, the
  Pallas kernel run in interpret mode, in both emit modes, at the sizes
  and with the tolerances of tests/test_octave_kernel.py: levels rtol 2e-5
  / atol 2e-4, DoG rtol 1e-4 / atol 2e-4, mag rtol 2e-5 / atol 2e-3, and
  theta within 1e-3 rad where mag > 5e-2 (0.1 for the default spans, see
  PALLAS_THETA); everywhere, theta's error times mag stays within 2e-4.
  The Pallas kernel blurs vertically first and uses a polynomial atan2;
  the port follows the per-level order of K1 and atan2, so the values
  differ in the last bits.
* The same against the JAX per-level XLA chain, with theta within 1e-5
  rad where mag > 1e-3 (test_torch_pyramid.py's tolerance).
* The port's chain-aware pyramid against its per-level form: on the CPU
  both are the same plain PyTorch operations, so they are bit-equal (on
  one thread, see ``one_thread``).
* The port's pyramid, octave by octave, against the JAX package's
  build_pyramid_dogs_fields (its per-level XLA form on the CPU): levels
  and DoG within 1e-3 on the 0..255 scale, mag within 1e-3
  (test_torch_pyramid.py's tolerances).
* ``chain_halo`` and ``octave_chain_ok`` equal to the JAX package's over a
  grid of shapes and spans.
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from popsift_tpu import config as jcfg  # noqa: E402
from popsift_tpu import extract as jext  # noqa: E402
from popsift_tpu import gauss as jgauss  # noqa: E402
from popsift_tpu.kernels import octave as jocts  # noqa: E402
from popsift_tpu.ops import gradients as jgrad  # noqa: E402
from popsift_tpu.ops import pyramid as jpyr  # noqa: E402

from popsift_torch import config as tcfg  # noqa: E402
from popsift_torch import extract as text  # noqa: E402
from popsift_torch import gauss as tgauss  # noqa: E402
from popsift_torch.kernels import octave as tocts  # noqa: E402
from popsift_torch.kernels.grad import grad_field  # noqa: E402
from popsift_torch.ops import pyramid as tpyr  # noqa: E402

TEST_SPANS = (1, 4, 5, 6, 7, 9)


@contextlib.contextmanager
def one_thread():
    """PyTorch's CPU kernels evaluate atan2 (and sqrt) in vector or scalar
    form depending on how a call is split across threads, which can move
    the last bit; on one thread, repeated computations are bit-equal."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _mk_filters(spans):
    filters = []
    for s in spans:
        t = np.exp(-0.5 * (np.arange(s) / max(s / 2.5, 1.0)) ** 2)
        t = t / (t[0] + 2 * t[1:].sum())
        filters.append(t.astype(np.float32))
    return filters


def _default_chain():
    """Filters and spans of the default Config's incremental chain."""
    gauss = tgauss.build_gauss_info(tcfg.Config())
    return tpyr.chain_filters(gauss, tcfg.Config().levels)


def _xla_chain(lvl0, filters, spans):
    """The JAX package's per-level XLA chain (test_octave_kernel.py)."""
    lvls = [jnp.asarray(lvl0)]
    dogs = []
    for lvl in range(1, len(spans)):
        nxt = jpyr.sep_blur(lvls[-1], np.asarray(filters[lvl]),
                            int(spans[lvl]))
        dogs.append(nxt - lvls[-1])
        lvls.append(nxt)
    stack = jnp.stack(lvls)
    mag, theta = jgrad.gradient_fields(stack)
    return (np.asarray(stack), np.asarray(jnp.stack(dogs)),
            np.asarray(jgrad.interleave_field(mag, theta)))


def _check(stack, dogs, field, ref_stack, ref_dogs, ref_field, H, W,
           theta_mag_min, theta_tol):
    np.testing.assert_allclose(stack, ref_stack[:, :H, :W], rtol=2e-5,
                               atol=2e-4)
    np.testing.assert_allclose(dogs, ref_dogs[:, :H, :W], rtol=1e-4,
                               atol=2e-4)
    ref = ref_field[:, :H, :W]
    mag = ref[0::2]
    np.testing.assert_allclose(field[0::2], mag, rtol=2e-5, atol=2e-3)
    dth = np.abs(field[1::2] - ref[1::2])
    dth = np.minimum(dth, 2 * np.pi - dth)
    assert dth[mag > theta_mag_min].max(initial=0.0) <= theta_tol
    # everywhere: the angle error times the magnitude (the gradient's
    # error across its direction) stays within the levels' atol
    assert (dth * mag).max(initial=0.0) <= 2e-4
    assert np.isfinite(field).all()


# theta against the Pallas kernel (polynomial atan2, vertical pass first):
# test_octave_kernel.py compares where mag > 5e-2 within 1e-3 rad.  The
# default chain blurs more, so its gradients are weaker against the same
# rounding drift of the levels; there the rule holds where mag > 0.1.
PALLAS_THETA = {"test": (5e-2, 1e-3), "default": (1e-1, 1e-3)}
# against the XLA per-level chain (the same operation order, atan2):
# test_torch_pyramid.py's 1e-5 rad where mag > 1e-3
XLA_THETA = (1e-3, 1e-5)


def _chain_inputs(dims, which, seed):
    H, W = dims
    if which == "test":
        spans, filters = TEST_SPANS, _mk_filters(TEST_SPANS)
    else:
        filters, spans = _default_chain()
    rng = np.random.default_rng(seed)
    lvl0 = rng.random((H, W)).astype(np.float32) * 255.0
    return lvl0, filters, spans


@pytest.mark.parametrize("which", ["test", "default"])
@pytest.mark.parametrize("dims", [(70, 200), (96, 300)])
def test_chain_matches_pallas_interpret(dims, which):
    H, W = dims
    lvl0, filters, spans = _chain_inputs(dims, which, seed=H + W)
    L = len(spans)
    ref = [np.asarray(a) for a in jocts.octave_chain_fused(
        jnp.asarray(lvl0), filters, spans, emit_stack=True,
        emit_field=True, interpret=True)]
    out = [t.numpy() for t in tocts.octave_chain(
        torch.as_tensor(lvl0), filters, spans, emit_stack=True)]
    assert out[0].shape == (L, H, W) and out[1].shape == (L - 1, H, W)
    assert out[2].shape == (2 * L, H, W)
    _check(*out, *ref, H, W, *PALLAS_THETA[which])


@pytest.mark.parametrize("which", ["test", "default"])
def test_chain_one_level_matches_pallas_interpret(which):
    """emit_stack=False with one kept level: the default LOOP path's form,
    which writes only level L-3, the next octave's downscale source."""
    H, W = 64, 180
    lvl0, filters, spans = _chain_inputs((H, W), which, seed=13)
    keep = (len(spans) - 3,)
    ref = [np.asarray(a) for a in jocts.octave_chain_fused(
        jnp.asarray(lvl0), filters, spans, emit_stack=False,
        emit_field=True, stack_levels=keep, interpret=True)]
    out = [t.numpy() for t in tocts.octave_chain(
        torch.as_tensor(lvl0), filters, spans, emit_stack=False,
        stack_levels=keep)]
    assert out[0].shape == (1, H, W) and ref[0].shape[0] == 1
    _check(*out, *ref, H, W, *PALLAS_THETA[which])
    full = tocts.octave_chain(torch.as_tensor(lvl0), filters, spans,
                              emit_stack=True)
    assert torch.equal(torch.as_tensor(out[0][0]), full[0][keep[0]])


@pytest.mark.parametrize("which", ["test", "default"])
@pytest.mark.parametrize("dims", [(70, 200), (41, 140)])
def test_chain_matches_xla_per_level(dims, which):
    H, W = dims
    lvl0, filters, spans = _chain_inputs(dims, which, seed=3 * H + W)
    ref = _xla_chain(lvl0, filters, spans)
    out = [t.numpy() for t in tocts.octave_chain(
        torch.as_tensor(lvl0), filters, spans, emit_stack=True)]
    _check(*out, *ref, H, W, *XLA_THETA)


def test_chain_keeps_one_level_or_all():
    lvl0 = torch.zeros((40, 140))
    filters, spans = _default_chain()
    with pytest.raises(ValueError):
        tocts.octave_chain(lvl0, filters, spans, emit_stack=False)
    with pytest.raises(ValueError):
        tocts.octave_chain(lvl0, filters, spans, emit_stack=False,
                           stack_levels=(1, 3))
    with pytest.raises(ValueError):
        tocts.octave_chain(lvl0[None], filters, spans, emit_stack=True)


@pytest.mark.parametrize("emit_field", [False, True])
def test_halo_and_eligibility_match_jax(emit_field):
    span_sets = [TEST_SPANS, (1, 6, 6, 8, 9, 11), (1, 6, 8, 9, 11, 14),
                 (1, 30, 30, 30, 30, 30), (1, 25, 25, 25, 25, 25),
                 (1, 8, 11, 14, 20), (1, 3)]
    shapes = [(h, w) for h in (16, 31, 32, 33, 135, 270, 2160)
              for w in (64, 128, 129, 240, 480, 3840)]
    for spans in span_sets:
        assert tocts.chain_halo(spans, emit_field) \
            == jocts.chain_halo(spans, emit_field)
        for h, w in shapes:
            assert tocts.octave_chain_ok(h, w, spans, emit_field) \
                == jocts.octave_chain_ok(h, w, spans, emit_field), \
                (spans, h, w)


def test_chain_tile_fits_every_supported_config():
    """K7's tile holds the halo of every configuration with sigma <= 2
    and 2..8 levels, so those configurations take the chain on exactly
    the octaves octave_chain_ok admits."""
    for levels in range(2, 9):
        for sigma in (0.8, 1.0, 1.6, 2.0):
            cfg = tcfg.Config()
            cfg.levels, cfg.sigma = levels, sigma
            _, spans = tpyr.chain_filters(tgauss.build_gauss_info(cfg),
                                          levels)
            tile = tocts.chain_tile(tocts.chain_halo(spans, True))
            assert tile is not None and tile >= 8, (levels, sigma)
            assert tpyr.chain_eligible(2160, 3840, spans)
    assert tocts.chain_tile(44) == 64
    assert tocts.chain_tile(79) == 8
    assert tocts.chain_tile(80) is None


def _texture(h, w, seed):
    rng = np.random.default_rng(seed)
    img = rng.random((h // 8, w // 8)).astype(np.float32)
    img = np.kron(img, np.ones((8, 8), np.float32))
    for _ in range(2):
        img = (img + np.roll(img, 1, 0) + np.roll(img, -1, 0)
               + np.roll(img, 1, 1) + np.roll(img, -1, 1)) / 5.0
    img = (img - img.min()) / (img.max() - img.min())
    return (img * 255).astype(np.uint8)


def _port_pyramid(image, plan, gauss, full_stacks):
    """(stacks, dogs, fields) of every octave, as extract_features builds
    them one at a time: the JAX package's build_pyramid_dogs_fields."""
    stacks, dogs, fields = [], [], []
    src = image
    for o in range(plan.octaves):
        stack, src, dog, field = tpyr.octave_outputs(
            src, o, plan.dims, plan.levels, gauss, plan.sift_mode,
            plan.upscale_factor, full_stacks)
        stacks.append(stack)
        dogs.append(dog)
        fields.append(field)
    return stacks, dogs, fields


# 120x160 upscales to a 240x320 octave 0, which the chain takes
@pytest.mark.parametrize("full_stacks", [False, True])
def test_pyramid_chain_equals_per_level(full_stacks):
    img = _texture(120, 160, seed=5)
    cfg = tcfg.Config()
    plan = text.make_plan(cfg, 160, 120)
    gauss = tgauss.build_gauss_info(cfg)
    unit = text.to_unit_image(img, "cpu")
    with one_thread():
        stacks, dogs, fields = _port_pyramid(unit, plan, gauss, full_stacks)
    _, spans = tpyr.chain_filters(gauss, plan.levels)
    chain = [tpyr.chain_eligible(h, w, spans) for (w, h) in plan.dims]
    assert chain[0] and not chain[-1]
    src = unit
    for o in range(plan.octaves):
        stack, dog = tpyr.build_octave(src, o, plan.dims, plan.levels, gauss,
                                       plan.sift_mode, plan.upscale_factor)
        src = stack
        assert torch.equal(dogs[o], dog), o
        with one_thread():
            assert torch.equal(fields[o], grad_field(stack)), o
        if chain[o] and not full_stacks:
            assert stacks[o] is None
        else:
            assert torch.equal(stacks[o], stack), o


def test_pyramid_matches_jax_build_pyramid_dogs_fields():
    img = _texture(120, 160, seed=7)
    jc = jcfg.Config()
    jplan = jext.make_plan(jc, 160, 120)
    jg = jgauss.build_gauss_info(jc)
    im = jnp.asarray(img).astype(jnp.float32) * (1.0 / 255.0)
    pads = tuple((0, 0) for _ in jplan.dims)
    jstacks, jdogs, jfields = jpyr.build_pyramid_dogs_fields(
        im, jg, jplan.dims, jplan.levels, jplan.gauss_mode,
        jplan.scaling_mode, jplan.sift_mode, jplan.upscale_factor, pads,
        True)
    cfg = tcfg.Config()
    plan = text.make_plan(cfg, 160, 120)
    stacks, dogs, fields = _port_pyramid(
        text.to_unit_image(img, "cpu"), plan, tgauss.build_gauss_info(cfg),
        True)
    assert len(stacks) == len(jstacks) == plan.octaves
    for o in range(plan.octaves):
        np.testing.assert_allclose(stacks[o].numpy(), np.asarray(jstacks[o]),
                                   rtol=0, atol=1e-3, err_msg=f"octave {o}")
        np.testing.assert_allclose(dogs[o].numpy(), np.asarray(jdogs[o]),
                                   rtol=0, atol=1e-3, err_msg=f"octave {o}")
        jf = np.asarray(jfields[o])
        assert fields[o].shape == jf.shape
        np.testing.assert_allclose(fields[o].numpy()[0::2], jf[0::2],
                                   rtol=0, atol=1e-3, err_msg=f"octave {o}")
