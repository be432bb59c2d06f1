"""popsift_torch's Grid (K12) and ILoop (K13) descriptor modes against
popsift_tpu, on the CPU.

The stage tests use the setup of tests/test_desc_modes.py's
test_grid_windowed_matches_plane: an L=4, 88x144 smoothed random stack and
96 slots, near-border ones included, 90% of them valid.

* The port's windowed forms (K8's window, then K12's or K13's plain
  version) against the JAX gather forms on the edge-padded stack, and the
  port's whole-plane forms against the JAX whole-plane forms: within 2e-5
  x the largest entry (XLA:CPU contracts multiply-adds into FMAs and sums
  in another order).  One exception is counted: Grid rounds each sample
  to a pixel, and where the FMA moves a position that is exactly k + 0.5
  in rounded float32 arithmetic, XLA's sample lands on the neighbouring
  pixel.  At most 2 of the 96 rows may differ for that reason, and they
  stay within 1e-3 x the largest entry, the tolerance at which
  test_desc_modes.py holds JAX's windowed forms to its whole-plane forms.
* The port's windowed and whole-plane forms agree with each other within
  the same 1e-3 (ILoop samples in window-local coordinates, which round
  differently from plane coordinates; Grid's integer taps are the same).
* Grid against tests/ref_golden.py:ref_desc_grid, at
  test_ref_parity.py:test_desc_grid_parity's tolerance (2e-3 x the
  largest entry).
* Each mode end to end on ``textured_image`` against the JAX extractor
  with the NoTile case's tolerances (test_torch_e2e.py), and with
  keypoints equal, bit for bit, to the port's loop mode.  Grid's rounding
  of samples to pixels is one exception, counted: the keypoints of the two
  packages differ by up to ~3e-4 px (the blur's FMA rounding, ROADMAP
  Queue 3), which moves the samples that lie that close to k + 0.5 onto
  the neighbouring pixel.  At most 2% of Grid's descriptors (4 of 307
  here) may then differ by more than 1e-3, and none by more than 4e-3.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

import popsift_tpu  # noqa: E402
from popsift_tpu import extract as jext  # noqa: E402
from popsift_tpu import features as jfeat  # noqa: E402
from popsift_tpu.config import Config as JConfig  # noqa: E402
from popsift_tpu.ops import descriptors as jdesc  # noqa: E402

import popsift_torch  # noqa: E402
from popsift_torch import extract as text  # noqa: E402
from popsift_torch.kernels import desc_grid as tkgrid  # noqa: E402
from popsift_torch.kernels.windows import gather_windows_exact  # noqa: E402
from popsift_torch.ops import descriptors as tdesc  # noqa: E402

import ref_golden as ref  # noqa: E402
from test_torch_e2e import _compare, _tied_features, one_thread  # noqa: E402

PAD_Y, PAD_X = 120, 256
TIGHT = 2e-5
LOOSE = 1e-3
MODES = ["grid", "iloop"]
# rows whose Grid samples may round to another pixel than XLA's
MAX_ROUNDING_ROWS = {"grid": 2, "iloop": 0}


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(9)
    L, h, w = 4, 88, 144
    stack = rng.random((L, h, w)).astype(np.float32)
    for _ in range(2):
        stack = (stack + np.roll(stack, 1, 1) + np.roll(stack, 1, 2)) / 3
    cap = 96
    x = rng.uniform(1, w - 2, cap).astype(np.float32)   # incl. near-border
    y = rng.uniform(1, h - 2, cap).astype(np.float32)
    lv = rng.integers(0, L, cap).astype(np.int32)
    sig = rng.uniform(1.6, 5.0, cap).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, cap).astype(np.float32)
    valid = rng.random(cap) < 0.9
    win = jdesc.desc_window_size(JConfig().sigma, JConfig().levels)
    args = (x, y, lv, sig, ang, valid)
    stackp = jnp.pad(jnp.asarray(stack),
                     ((0, 0), (PAD_Y, PAD_Y), (PAD_X, PAD_X)), mode="edge")
    jstack = jnp.asarray(stack)
    jax_out = {
        ("grid", "windowed"): jdesc.grid_rounded_descriptors_windowed(
            stackp, PAD_Y, PAD_X, *args, w, h, win),
        ("grid", "plane"): jdesc.grid_rounded_descriptors(jstack, *args),
        ("iloop", "windowed"): jdesc.iloop_descriptors_windowed(
            stackp, PAD_Y, PAD_X, *args, w, h, win),
        ("iloop", "plane"): jdesc.iloop_descriptors(jstack, *args),
    }
    return dict(stack=torch.as_tensor(stack), win=win, valid=valid,
                targs=[torch.as_tensor(a) for a in args],
                jax={k: np.asarray(v) for k, v in jax_out.items()})


def _port(s, mode, form):
    x, y, lv, sig, ang, valid = s["targs"]
    if form == "windowed":
        fn = {"grid": tdesc.grid_rounded_descriptors_windowed,
              "iloop": tdesc.iloop_descriptors_windowed}[mode]
        return fn(s["stack"], x, y, lv, sig, ang, s["win"],
                  valid=valid).numpy()
    fn = {"grid": tdesc.grid_rounded_descriptors,
          "iloop": tdesc.iloop_descriptors}[mode]
    return fn(s["stack"], x, y, lv, sig, ang, valid=valid).numpy()


def _close(got, want, rel):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("form", ["windowed", "plane"])
@pytest.mark.parametrize("mode", MODES)
def test_matches_jax(setup, mode, form):
    got = _port(setup, mode, form)
    want = setup["jax"][(mode, form)]
    assert got.shape == (96, 128)
    assert not got[~setup["valid"]].any()
    scale = max(1.0, float(np.abs(want).max()))
    off = np.abs(got - want).max(axis=1) > TIGHT * scale
    assert off.sum() <= MAX_ROUNDING_ROWS[mode], np.flatnonzero(off)
    _close(got[~off], want[~off], TIGHT)
    _close(got, want, LOOSE)


@pytest.mark.parametrize("mode", MODES)
def test_windowed_matches_whole_plane(setup, mode):
    _close(_port(setup, mode, "windowed"), _port(setup, mode, "plane"),
           LOOSE)


def _golden_fixture(seed=13, h=64, w=96, n=6):
    """test_ref_parity.py:_desc_fixture."""
    rng = np.random.default_rng(seed)
    layer = rng.random((h, w)).astype(np.float32)
    for _ in range(2):
        layer = (layer + np.roll(layer, 1, 0) + np.roll(layer, -1, 0)
                 + np.roll(layer, 1, 1) + np.roll(layer, -1, 1)) / 5.0
    x = rng.uniform(12, w - 13, n).astype(np.float32)
    y = rng.uniform(12, h - 13, n).astype(np.float32)
    sig = rng.uniform(1.0, 2.2, n).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    return layer, x, y, sig, ang


@pytest.mark.parametrize("form", ["windowed", "plane"])
def test_grid_matches_golden(form):
    layer, x, y, sig, ang = _golden_fixture()
    n = x.shape[0]
    stack = torch.as_tensor(layer[None])
    args = [torch.as_tensor(a) for a in (x, y, np.zeros(n, np.int32), sig,
                                         ang)]
    if form == "windowed":
        got = tdesc.grid_rounded_descriptors_windowed(stack, *args, 112)
    else:
        got = tdesc.grid_rounded_descriptors(stack, *args)
    for i in range(n):
        want = ref.ref_desc_grid(layer, float(x[i]), float(y[i]),
                                 float(sig[i]), float(ang[i]))
        _close(got[i].numpy(), want, 2e-3)


@pytest.mark.parametrize("mode", MODES)
def test_kernel_wrappers_take_windows(setup, mode):
    """K12's and K13's plain versions through their wrappers, which take
    the stack and read K8's exact-origin windows from it: the same numbers
    as K8's gather (gather_windows_exact at round(x) - win/2, round(y) -
    win/2) followed by the window forms; rows are independent, so a subset
    of rows gives the same rows (within 1e-6 x the largest entry: the
    maths library's vector and scalar forms, chosen by an element's place
    in the batch, may differ in the last bit); zero-scale rows give zeros;
    a stack that is not (L, H, W) float32, a window wider than K8's 120
    and a negative staging capacity are refused."""
    fn = {"grid": tkgrid.desc_grid_rounded_stack,
          "iloop": tkgrid.desc_iloop_stack}[mode]
    window_form = {"grid": tkgrid.desc_grid_rounded_plain,
                   "iloop": tkgrid.desc_iloop_plain}[mode]
    x, y, lv, sig, ang, _ = setup["targs"]
    stack, win = setup["stack"], setup["win"]
    _, h, w = stack.shape
    x0 = torch.round(x).to(torch.int32) - win // 2
    y0 = torch.round(y).to(torch.int32) - win // 2
    wins, ya = gather_windows_exact(stack, lv, y0, x0, win)
    rows = (x, y, lv, sig, ang)
    full = fn(stack, *rows, win)
    assert torch.equal(full, window_form(wins, x, y, x0.float(), ya.float(),
                                         sig, ang, w, h))
    part = fn(stack, *(r[5:9] for r in rows), win)
    _close(part.numpy(), full[5:9].numpy(), 1e-6)
    zero = [r[5:9] for r in rows]
    zero[3] = zero[3] * 0
    assert not fn(stack, *zero, win).any()
    with pytest.raises(ValueError):
        fn(stack[0], *rows, win)
    with pytest.raises(ValueError):
        fn(stack.double(), *rows, win)
    with pytest.raises(ValueError):
        fn(stack, *rows, 128)
    with pytest.raises(ValueError):
        fn(stack, *rows, win, stage=-1)


@pytest.fixture(scope="module")
def end_to_end(textured_image):
    img = textured_image
    h, w = img.shape
    out = {}
    with one_thread():
        loop = text.extract_features(img, popsift_torch.Config(),
                                     device="cpu")
        for mode in MODES:
            jcfg = popsift_tpu.Config()
            jcfg.set_desc_mode(popsift_tpu.DescMode(mode))
            fn, _ = jext.get_extractor(jcfg, w, h)
            ref_feats = jfeat.assemble_features(
                fn(jext.normalize_input(img)), jcfg.get_upscale_factor())
            tcfg = popsift_torch.Config()
            tcfg.set_desc_mode(popsift_torch.DescMode(mode))
            out[mode] = (ref_feats, text.extract_features(img, tcfg,
                                                          device="cpu"))
    return out, loop, _tied_features(img)


@pytest.mark.parametrize("mode", MODES)
def test_end_to_end_matches_jax(end_to_end, mode):
    out, _, tied = end_to_end
    ref_feats, port = out[mode]
    desc_tol = 1e-3
    if mode == "grid":
        d = np.abs(port.get_descriptors()
                   - ref_feats.get_descriptors()).max(axis=1)
        assert (d > desc_tol).sum() <= 0.02 * d.size, np.sort(d)[-10:]
        desc_tol = 4e-3
    _compare(ref_feats, port, tied, sigma_rtol=1e-4, ori_tol=2e-3,
             desc_tol=desc_tol)


@pytest.mark.parametrize("mode", MODES)
def test_keypoints_equal_loop_keypoints(end_to_end, mode):
    out, loop, _ = end_to_end
    got = out[mode][1].soa()
    want = loop.soa()
    for k in ("xpos", "ypos", "sigma", "num_ori", "orientation",
              "debug_octave"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
