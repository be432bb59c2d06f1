"""popsift_torch's default pyramid against the executable reference
golden (tests/ref_golden.py:ref_pyramid_default, an independent numpy
port of the reference's CUDA build), on the CPU.

The scene and the tolerances are those at which tests/test_ref_parity.py:
test_pyramid_parity_default holds the JAX package to the same golden:
the interior (two pixels in from each edge) within 2e-3 on the 0..255
scale, the whole plane within 0.35.  The borders differ by design: the
port, like the JAX package, resamples the input to the octave grid and
clamps there, while the reference clamps in the source texture's
coordinates.  The levels come from the functions the extraction runs
(``ops/pyramid.py:octave_outputs`` with the whole stack kept, K7's plain
chain on the octaves that take it and K1's plain per-level chain on the
others), every level of every octave, and from the per-level form
(``build_octave``) of every octave as well.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

from popsift_torch import extract as text  # noqa: E402
from popsift_torch.config import Config  # noqa: E402
from popsift_torch.gauss import build_gauss_info  # noqa: E402
from popsift_torch.ops import pyramid as tpyr  # noqa: E402

import ref_golden as ref  # noqa: E402


def _scene():
    """test_ref_parity.py's scene: a 96x128 natural texture."""
    rng = np.random.default_rng(7)
    h, w = 96, 128
    img = rng.random((h // 8, w // 8)).astype(np.float32)
    img = np.kron(img, np.ones((8, 8), np.float32))
    for _ in range(2):
        img = (img + np.roll(img, 1, 0) + np.roll(img, -1, 0)
               + np.roll(img, 1, 1) + np.roll(img, -1, 1)) / 5.0
    img = (img - img.min()) / (img.max() - img.min())
    return (img * 255).astype(np.uint8)


def _port_stacks(image, plan, gauss, form):
    stacks, src = [], text.to_unit_image(image, "cpu")
    L = plan.levels + 3
    for o in range(plan.octaves):
        if form == "extraction":
            stack, down, _, _ = tpyr.octave_outputs(
                src, o, plan.dims, plan.levels, gauss, plan.sift_mode,
                plan.upscale_factor, full_stack=True)
            src = down
        else:
            stack, _ = tpyr.build_octave(src, o, plan.dims, plan.levels,
                                         gauss, plan.sift_mode,
                                         plan.upscale_factor)
            src = stack
        assert stack.shape[0] == L
        stacks.append(stack.numpy())
    return stacks


@pytest.fixture(scope="module")
def golden():
    image = _scene()
    h, w = image.shape
    cfg = Config()
    plan = text.make_plan(cfg, w, h)
    gauss = build_gauss_info(cfg)
    shift0 = tpyr.input_shift(plan.sift_mode, plan.upscale_factor, 0)
    want = ref.ref_pyramid_default(text.normalize_input(image), plan.dims,
                                   plan.levels, gauss, shift0)
    return image, plan, gauss, want


@pytest.mark.parametrize("form", ["extraction", "per_level"])
def test_pyramid_matches_golden(golden, form):
    image, plan, gauss, want = golden
    got = _port_stacks(image, plan, gauss, form)
    assert len(got) == len(want) == plan.octaves
    for o, (g, r) in enumerate(zip(got, want)):
        assert g.shape == r.shape, o
        assert np.isfinite(g).all(), o
        err = np.max(np.abs(g[:, 2:-2, 2:-2] - r[:, 2:-2, 2:-2]))
        assert err < 2e-3, f"octave {o}: interior max err {err}"
        full_err = np.max(np.abs(g - r))
        assert full_err < 0.35, f"octave {o}: border max err {full_err}"
