"""The port's pyramid strategies against popsift_tpu's on the CPU.

Fixed9, Fixed15, VLFeat-relative-all (``gauss_mode`` "vlfeat-direct"),
``scaling_mode=direct``, Fixed9 with direct scaling and the OpenCV
SiftMode (whose octave 0 reads the input at another shift): every octave's
levels and DoG, as ``extract_features`` builds them
(``ops/pyramid.py:octave_outputs`` with the whole stack kept), against
the JAX package's ``build_pyramid_and_dogs``, within 1e-3 on the 0..255
scale (``test_torch_pyramid.py``'s tolerance: XLA:CPU contracts the
blur's multiply-adds into FMAs, the port rounds each operation).

Also: the routing the JAX package keeps (no fixed octave takes the
chain, K7 or K1's chain entry; VLFeat-relative-all's octave 0 neither;
those octaves' DoG is the difference of adjacent levels, their field
K2's), and the fixed modes' refusal of ``levels + 3 != 6`` with the JAX
package's ValueError, raised before any device work.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_parity as tp  # noqa: E402

import popsift_tpu  # noqa: E402
from popsift_tpu import extract as jext  # noqa: E402
from popsift_tpu import gauss as jgauss  # noqa: E402
from popsift_tpu.ops import pyramid as jpyr  # noqa: E402

import popsift_torch  # noqa: E402
from popsift_torch import config as tcfg  # noqa: E402
from popsift_torch import extract as text  # noqa: E402
from popsift_torch.gauss import build_gauss_info  # noqa: E402
from popsift_torch.ops import pyramid as tpyr  # noqa: E402

CASES = {
    "fixed9": dict(gauss_mode=tcfg.GaussMode.FIXED9),
    "fixed15": dict(gauss_mode=tcfg.GaussMode.FIXED15),
    "vlfeat-direct": dict(gauss_mode=tcfg.GaussMode.VLFEAT_RELATIVE_ALL),
    "direct": dict(scaling_mode=tcfg.ScalingMode.SCALE_DIRECT),
    "fixed9-direct": dict(gauss_mode=tcfg.GaussMode.FIXED9,
                          scaling_mode=tcfg.ScalingMode.SCALE_DIRECT),
    "opencv-fixed15": dict(sift_mode=tcfg.SiftMode.OPENCV,
                           gauss_mode=tcfg.GaussMode.FIXED15),
}


def _jax_pyramid(img, cfg):
    j = tp.jax_config(cfg)
    h, w = img.shape
    plan = jext.make_plan(j, w, h)
    gauss = jgauss.build_gauss_info(j)

    def fn(im):
        im = im.astype(jnp.float32) * (1.0 / 255.0)
        return jpyr.build_pyramid_and_dogs(
            im, gauss, plan.dims, plan.levels, plan.gauss_mode,
            plan.scaling_mode, plan.sift_mode, plan.upscale_factor)

    stacks, dogs = jax.jit(fn)(img)
    return [np.array(s) for s in stacks], [np.array(d) for d in dogs]


def _port_pyramid(img, cfg, need_field=False):
    """(stacks, dogs, fields) of every octave through octave_outputs, as
    extract_features builds them, with every stack kept."""
    h, w = img.shape
    plan = text.make_plan(cfg, w, h)
    gauss = build_gauss_info(cfg)
    unit = text.to_unit_image(img, "cpu")
    stacks, dogs, fields = [], [], []
    src = unit
    with tp.one_thread():
        for o in range(plan.octaves):
            stack, src, dog, field = tpyr.octave_outputs(
                src, o, plan.dims, plan.levels, gauss, plan.sift_mode,
                plan.upscale_factor, True, need_field=need_field,
                gauss_mode=plan.gauss_mode, scaling_mode=plan.scaling_mode,
                image=unit)
            stacks.append(stack)
            dogs.append(dog)
            fields.append(field)
    return stacks, dogs, fields


@pytest.mark.parametrize("case", list(CASES))
def test_levels_and_dogs_match(case, textured_image):
    cfg = tcfg.Config(**CASES[case])
    jstacks, jdogs = _jax_pyramid(textured_image, cfg)
    stacks, dogs, _ = _port_pyramid(textured_image, cfg)
    assert len(stacks) == len(jstacks) > 1
    for o, (s, js, d, jd) in enumerate(zip(stacks, jstacks, dogs, jdogs)):
        assert s.shape == js.shape and d.shape == jd.shape, o
        np.testing.assert_allclose(s.numpy(), js, rtol=0, atol=1e-3,
                                   err_msg=f"levels, octave {o}")
        np.testing.assert_allclose(d.numpy(), jd, rtol=0, atol=1e-3,
                                   err_msg=f"DoG, octave {o}")


@pytest.mark.parametrize("case", ["fixed9", "fixed9-direct",
                                  "vlfeat-direct"])
def test_routing(case, textured_image, monkeypatch):
    """A fixed octave, and VLFeat-relative-all's octave 0, never reach the
    incremental chain: K1 once a level, the DoG by subtraction of adjacent
    levels, the field from K2.  VLFeat-relative-all's later octaves take
    the chain."""
    cfg = tcfg.Config(**CASES[case])
    chain_calls = []
    for name in ("octave_chain", "blur_chain"):
        real = getattr(tpyr, name)

        def spy(*args, _real=real, _name=name, **kw):
            chain_calls.append(_name)
            return _real(*args, **kw)
        monkeypatch.setattr(tpyr, name, spy)
    stacks, dogs, fields = _port_pyramid(textured_image, cfg,
                                         need_field=True)
    fixed = cfg.gauss_mode != tcfg.GaussMode.VLFEAT_RELATIVE_ALL
    apart = len(stacks) if fixed else 1
    assert (chain_calls == []) == fixed
    for o in range(apart):
        assert torch.equal(dogs[o], stacks[o][1:] - stacks[o][:-1]), o
        assert torch.equal(fields[o], tpyr.grad_field(stacks[o])), o


@pytest.mark.parametrize("levels", [2, 4])
@pytest.mark.parametrize("mode", ["fixed9", "fixed15"])
def test_fixed_levels_refused(mode, levels):
    """Both packages refuse a fixed Gauss mode unless levels + 3 == 6,
    with the same ValueError; the port before any device work."""
    cfg = tcfg.Config(levels=levels)
    cfg.set_gauss_mode(mode)
    img = np.zeros((48, 64), np.uint8)
    msg = "Unsupported number of levels for making all octaves at once"
    with pytest.raises(ValueError, match=msg):
        text.extract_features(img, cfg, device="cpu")
    with pytest.raises(ValueError, match=msg):
        # no CUDA device is needed to be refused
        text.extract_features(img, cfg, device="cuda")
    with popsift_torch.PopSift(cfg, device="cpu") as ps:
        with pytest.raises(ValueError, match=msg):
            ps.enqueue(64, 48, img).get()
    j = tp.jax_config(cfg)
    fn, _ = jext.get_extractor(j, 64, 48)
    with pytest.raises(ValueError, match=msg):
        fn(jext.normalize_input(img))
    with pytest.raises(ValueError, match=msg):
        with popsift_tpu.PopSift(j) as ps:
            ps.enqueue(64, 48, img).get()
