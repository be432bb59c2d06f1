"""popsift_torch's NoTile/IGrid descriptors (K9's plain version: K8's
plain windows, then the window form) against popsift_tpu, on the setup of
tests/test_desc_modes.py's test_grid_windowed_matches_plane: an L=4,
88x144 smoothed random stack and 96 slots, near-border ones included, 90%
of them valid.

Tolerances:

* the port's windowed form against JAX's grid_descriptors_windowed on the
  edge-padded stack: the same arithmetic in the same window-local
  coordinates; XLA:CPU contracts multiply-adds into FMAs and sums the
  tile contractions in another order, so within 2e-5 x the largest entry;
* the port's windowed form, and its whole-plane form, against JAX's
  whole-plane grid_descriptors: atol 1e-3 x the largest entry, the
  tolerance test_desc_modes.py holds JAX's two forms to (window-local
  coordinates round differently from plane coordinates);
* the port's whole-plane form against JAX's: within 2e-5 x the largest
  entry, as the first.
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from popsift_tpu.config import Config as JConfig  # noqa: E402
from popsift_tpu.constants import build_const_info  # noqa: E402
from popsift_tpu.ops import descriptors as jdesc  # noqa: E402

import popsift_torch as pt  # noqa: E402
from popsift_torch import config as tcfg  # noqa: E402
from popsift_torch.constants import desc_tables_on  # noqa: E402
from popsift_torch.extract import extract_features  # noqa: E402
from popsift_torch.kernels import desc_grid as tkgrid  # noqa: E402
from popsift_torch.ops import descriptors as tdesc  # noqa: E402

PAD_Y, PAD_X = 120, 256
TIGHT = 2e-5
LOOSE = 1e-3


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
    consts = build_const_info(JConfig())
    win = jdesc.desc_window_size(JConfig().sigma, JConfig().levels)
    args = (x, y, lv, sig, ang, valid)
    stackp = jnp.pad(jnp.asarray(stack),
                     ((0, 0), (PAD_Y, PAD_Y), (PAD_X, PAD_X)), mode="edge")
    jwin = np.asarray(jdesc.grid_descriptors_windowed(
        stackp, PAD_Y, PAD_X, *args, h=h, w=w, win=win,
        desc_gauss=consts.desc_gauss, desc_tile=consts.desc_tile))
    jplane = np.asarray(jdesc.grid_descriptors(
        jnp.asarray(stack), *args, consts.desc_gauss, consts.desc_tile))
    targs = [torch.as_tensor(a) for a in args]
    return dict(stack=torch.as_tensor(stack), targs=targs, win=win,
                jwin=jwin, jplane=jplane, valid=valid)


def _close(got, ref, rel):
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * max(1.0, float(np.abs(ref).max())))


def _port_windowed(s):
    x, y, lv, sig, ang, valid = s["targs"]
    g, t = desc_tables_on("cpu")
    return tdesc.grid_descriptors_windowed(
        s["stack"], x, y, lv, sig, ang, s["win"], g, t, valid=valid).numpy()


def test_tables_match():
    from popsift_tpu.ops.descriptors import _grid_steps, _tile_weight_matrix
    np.testing.assert_array_equal(tdesc._grid_steps(), _grid_steps())
    _, tile = desc_tables_on("cpu")
    np.testing.assert_array_equal(
        tdesc._tile_weight_matrix(tile).numpy(),
        _tile_weight_matrix(build_const_info(JConfig()).desc_tile))


def test_windowed_matches_jax_windowed(setup):
    out = _port_windowed(setup)
    assert out.shape == (96, 128)
    _close(out, setup["jwin"], TIGHT)
    assert not out[~setup["valid"]].any()


def test_windowed_matches_jax_whole_plane(setup):
    _close(_port_windowed(setup), setup["jplane"], LOOSE)


def test_whole_plane_matches_jax_whole_plane(setup):
    x, y, lv, sig, ang, valid = setup["targs"]
    g, t = desc_tables_on("cpu")
    out = tdesc.grid_descriptors(setup["stack"], x, y, lv, sig, ang, g, t,
                                 valid=valid).numpy()
    _close(out, setup["jplane"], TIGHT)
    _close(out, _port_windowed(setup), LOOSE)


def test_desc_grid_takes_windows(setup):
    """K9's plain version through its wrapper, which takes the stack and
    places K8's windows itself: rows are independent, so a subset of slots
    gives the same rows (within 1e-6 x the largest entry: the maths
    library's vector and scalar forms, chosen by an element's place in the
    batch, may differ in the last bit); zero-scale slots give zeros; a
    stack that is not (L, H, W) float32 raises."""
    x, y, lv, sig, ang, _ = setup["targs"]
    stack, win = setup["stack"], setup["win"]
    g, t = desc_tables_on("cpu")
    full = tkgrid.desc_grid_stack(stack, x, y, lv, sig, ang, win, g, t)
    e = slice(5, 9)
    part = tkgrid.desc_grid_stack(stack, x[e], y[e], lv[e], sig[e] * 0,
                                  ang[e], win, g, t)
    assert not part.any()
    part = tkgrid.desc_grid_stack(stack, x[e], y[e], lv[e], sig[e], ang[e],
                                  win, g, t)
    _close(part.numpy(), full[e].numpy(), 1e-6)
    with pytest.raises(ValueError):
        tkgrid.desc_grid_stack(stack[0], x, y, lv, sig, ang, win, g, t)
    with pytest.raises(ValueError):
        tkgrid.desc_grid_stack(stack.double(), x, y, lv, sig, ang, win, g, t)


@pytest.mark.parametrize("mode", ["notile", "igrid", "grid", "iloop",
                                  "loop"])
def test_config_gate(mode):
    cfg = tcfg.Config()
    cfg.desc_mode = tcfg.DescMode(mode)
    # every mode runs end to end (a blank image has no features)
    img = np.zeros((64, 64), np.uint8)
    assert extract_features(img, cfg, device="cpu").get_feature_count() == 0


def test_igrid_equals_notile(textured_image):
    out = {}
    for mode in ("notile", "igrid"):
        cfg = pt.Config()
        cfg.desc_mode = pt.DescMode(mode)
        with one_thread():
            out[mode] = extract_features(textured_image, cfg, device="cpu")
    a, b = out["notile"], out["igrid"]
    assert a.get_feature_count() == b.get_feature_count() > 0
    np.testing.assert_array_equal(a.get_descriptors(), b.get_descriptors())
    for k, v in a.soa().items():
        np.testing.assert_array_equal(b.soa()[k], v, err_msg=k)
