"""popsift_torch scale space and gradient field against popsift_tpu's
(the XLA forms the JAX package runs on the CPU).

Tolerances: levels and DoG within 1e-3 on the 0..255 scale.  XLA:CPU
contracts the blur's multiply-adds into FMAs and PyTorch's CPU kernels
round each operation, so about a quarter of the blurred pixels differ in
the last bit (~6e-5 at 255).  The field is compared on the same (JAX)
stack: mag within 1e-3, theta within 1e-5 rad where mag > 1e-3.  The
levels are built both from the port's own Gauss tables and from the JAX
package's, carried across with ``tables.from_numpy``.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from popsift_tpu import config as jcfg  # noqa: E402
from popsift_tpu import constants as jconst  # noqa: E402
from popsift_tpu import extract as jext  # noqa: E402
from popsift_tpu import gauss as jgauss  # noqa: E402
from popsift_tpu.ops import gradients as jgrad  # noqa: E402
from popsift_tpu.ops import pyramid as jpyr  # noqa: E402

from popsift_torch import config as tcfg  # noqa: E402
from popsift_torch import extract as text  # noqa: E402
from popsift_torch import gauss as tgauss  # noqa: E402
from popsift_torch import tables  # noqa: E402
from popsift_torch.kernels import blur as tblur  # noqa: E402
from popsift_torch.kernels.grad import grad_field  # noqa: E402
from popsift_torch.ops import gradients as tgrad  # noqa: E402
from popsift_torch.ops import pyramid as tpyr  # noqa: E402

SIZES = [(96, 128), (120, 160)]


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
def _jax_pyramid(h, w):
    img = _texture(h, w, seed=h + w)
    cfg = jcfg.Config()
    plan = jext.make_plan(cfg, w, h)
    gauss = jgauss.build_gauss_info(cfg)

    def fn(im):
        im = im.astype(jnp.float32) * (1.0 / 255.0)
        stacks, dogs = jpyr.build_pyramid_and_dogs(
            im, gauss, plan.dims, plan.levels, plan.gauss_mode,
            plan.scaling_mode, plan.sift_mode, plan.upscale_factor)
        fields = [jgrad.padded_gradient_field(s, 0, 0) for s in stacks]
        return stacks, dogs, fields

    stacks, dogs, fields = jax.jit(fn)(img)
    return (img, plan, [np.array(s) for s in stacks],
            [np.array(d) for d in dogs], [np.array(f) for f in fields])


def _port_pyramid(image, gauss, plan):
    """All octaves of the port's incremental chain, as extract_features
    builds them one at a time."""
    stacks, dogs = [], []
    src = image
    for o in range(plan.octaves):
        stack, dog = tpyr.build_octave(src, o, plan.dims, plan.levels, gauss,
                                       tcfg.SiftMode.POPSIFT,
                                       plan.upscale_factor)
        stacks.append(stack)
        dogs.append(dog)
        src = stack
    return stacks, dogs


def _carried_gauss():
    """The JAX package's tables, carried across with tables.from_numpy."""
    j = jcfg.Config()
    info = jgauss.build_gauss_info(j)
    g = {fam: {k: np.asarray(getattr(getattr(info, fam), k))
               for k in ("sigma", "span", "filter")}
         for fam in ("inc", "abs_o0", "abs_oN", "dd")}
    g["required_filter_stages"] = info.required_filter_stages
    ci = jconst.build_const_info(j)
    c = {f.name: getattr(ci, f.name) for f in dataclasses.fields(ci)}
    return tables.from_numpy(g, c, device="cpu")[0]


@pytest.mark.parametrize("source", ["own", "carried"])
@pytest.mark.parametrize("h,w", SIZES)
def test_levels_and_dogs_match(h, w, source):
    img, plan, jstacks, jdogs, _ = _jax_pyramid(h, w)
    gauss = (tgauss.build_gauss_info(tcfg.Config()) if source == "own"
             else _carried_gauss())
    stacks, dogs = _port_pyramid(text.to_unit_image(img, "cpu"), gauss,
                                 plan)
    assert len(stacks) == len(jstacks) == plan.octaves
    for o in range(plan.octaves):
        assert stacks[o].shape == jstacks[o].shape
        assert dogs[o].shape == jdogs[o].shape
        np.testing.assert_allclose(stacks[o].numpy(), jstacks[o],
                                   rtol=0, atol=1e-3, err_msg=f"octave {o}")
        np.testing.assert_allclose(dogs[o].numpy(), jdogs[o], rtol=0,
                                   atol=1e-3, err_msg=f"dog octave {o}")


def _keep_field_failure(tmp_path, o, jstack, jfield, field):
    """Write a failing octave's arrays to ``tmp_path`` and print which side
    moved: the JAX field computed in the pyramid's program against one
    recomputed from the returned stack in a jit of its own (the JAX side
    moved if they differ), and the port's field against both."""
    again = np.array(jax.jit(lambda s: jgrad.padded_gradient_field(
        s, 0, 0))(jstack))
    path = tmp_path / f"field_octave{o}.npz"
    np.savez(path, jax_stack=jstack, jax_field=jfield, port_field=field,
             jax_field_recomputed=again)

    def diff(a, b):
        return (f"max |d| {float(np.abs(a - b).max()):.3g} at "
                f"{int((a != b).sum())} of {a.size}")

    print(f"octave {o}: arrays kept in {path}\n"
          f"  JAX in-program field vs JAX recomputed: {diff(jfield, again)}"
          f"\n  port field vs JAX in-program: {diff(field, jfield)}"
          f"\n  port field vs JAX recomputed: {diff(field, again)}\n  "
          + ("the JAX side moved" if not np.array_equal(jfield, again)
             else "the JAX side is stable; the port's field moved"))


@pytest.mark.parametrize("h,w", SIZES)
def test_field_matches_on_the_same_stack(h, w, tmp_path):
    """On failure the octave's arrays are written to ``tmp_path`` (the
    test failed now and then in whole runs, with no arrays to show which
    side moved)."""
    _, plan, jstacks, _, jfields = _jax_pyramid(h, w)
    for o in range(plan.octaves):
        field = grad_field(torch.as_tensor(jstacks[o])).numpy()
        jf = jfields[o]
        try:
            assert field.shape == jf.shape
            mag, jmag = field[0::2], jf[0::2]
            np.testing.assert_allclose(mag, jmag, rtol=0, atol=1e-3)
            strong = jmag > 1e-3
            dth = np.abs(field[1::2] - jf[1::2])[strong]
            dth = np.minimum(dth, 2 * np.pi - dth)
            assert dth.max() <= 1e-5, (o, dth.max())
            # two CPU computations of the port, bit for bit: on one
            # thread, as PyTorch's CPU atan2 may round the last bit by the
            # work's split
            n = torch.get_num_threads()
            torch.set_num_threads(1)
            try:
                one = grad_field(torch.as_tensor(jstacks[o])).numpy()
                mag_t, th_t = tgrad.gradient_fields(
                    torch.as_tensor(jstacks[o]))
            finally:
                torch.set_num_threads(n)
            np.testing.assert_array_equal(
                tgrad.interleave_field(mag_t, th_t).numpy(), one)
        except AssertionError:
            if field.shape == jf.shape:
                _keep_field_failure(tmp_path, o, jstacks[o], jf, field)
            raise


@pytest.mark.parametrize("src,dst,shift", [
    (60, 120, 1.0), (61, 122, 0.5), (60, 60, 0.5), (40, 60, 0.5),
    (64, 32, 0.5), (33, 17, 1.0)])
def test_resample_matches(src, dst, shift):
    rng = np.random.default_rng(src * dst)
    a = rng.random((src, src + 3)).astype(np.float32)
    jr = np.asarray(jax.jit(lambda x: jpyr._resample_1d(
        x, dst, src, shift, axis=0))(a))
    tr = tpyr._resample_1d(torch.as_tensor(a), dst, src, shift, dim=0)
    np.testing.assert_allclose(tr.numpy(), jr, rtol=0, atol=1e-6)
    img = rng.random((src, src + 7)).astype(np.float32)
    jr2 = np.asarray(jax.jit(lambda x: jpyr.resample_input(
        x, dst, dst + 14 if dst == 2 * src else dst + 7, shift))(img))
    tr2 = tpyr.resample_input(torch.as_tensor(img), dst,
                              dst + 14 if dst == 2 * src else dst + 7,
                              shift)
    np.testing.assert_allclose(tr2.numpy(), jr2, rtol=0, atol=1e-6)


@pytest.mark.parametrize("span_h,span_v,hscale", [(6, 6, 1.0),
                                                   (8, 6, 255.0),
                                                   (14, 14, 1.0),
                                                   (1, 3, 1.0)])
def test_sep_blur_matches_xla_blur(span_h, span_v, hscale):
    rng = np.random.default_rng(span_h * 31 + span_v)
    img = rng.random((37, 53)).astype(np.float32)
    th = rng.random(32).astype(np.float32)
    tv = rng.random(32).astype(np.float32)

    def fn(x):
        out = jpyr.blur_1d(x, th, span_h, axis=-1)
        if hscale != 1.0:
            out = out * hscale
        return jpyr.blur_1d(out, tv, span_v, axis=-2)

    ref = np.asarray(jax.jit(fn)(img))
    out, dog = tblur.sep_blur(torch.as_tensor(img), th, span_h, tv, span_v,
                              hscale=hscale, with_dog=True)
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-6,
                               atol=2e-6 * hscale)
    np.testing.assert_array_equal(dog.numpy(), out.numpy() - img)
    # preallocated outputs get the same values
    o2 = torch.empty(37, 53)
    d2 = torch.empty(37, 53)
    tblur.sep_blur(torch.as_tensor(img), th, span_h, tv, span_v,
                   hscale=hscale, with_dog=True, out=o2, dog_out=d2)
    assert torch.equal(o2, out) and torch.equal(d2, dog)


def test_downscale_and_input_shift():
    lvl = torch.arange(7 * 9, dtype=torch.float32).reshape(7, 9)
    ref = np.asarray(jpyr.downscale_by_2(jnp.asarray(lvl.numpy())))
    np.testing.assert_array_equal(tpyr.downscale_by_2(lvl).numpy(), ref)
    for mode in jcfg.SiftMode:
        for up in (-1.0, 0.0, 1.0):
            for o in (0, 1, 2):
                assert tpyr.input_shift(tcfg.SiftMode(mode.value), up, o) \
                    == jpyr.input_shift(mode, up, o)
