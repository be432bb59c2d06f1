"""popsift_torch's window gather (K8's plain version) against popsift_tpu.

The JAX callers edge-pad the stack (pad 120 rows and 256 columns,
popsift_tpu/extract.py:201-204) and gather from the padded copy; the port
reads the unpadded plane with clamp addressing.  With the JAX origins
shifted by the pad, the windows must be bit-equal, for origins inside the
plane and for origins up to the pad outside it.  Both JAX functions run
their CPU forms (dynamic_slice); the aligned one is also held to its
Pallas kernel in interpret mode.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from popsift_tpu.kernels import windows as jwin  # noqa: E402
from popsift_tpu.kernels import windows2 as jwin2  # noqa: E402

from popsift_torch.kernels import windows as twin  # noqa: E402

PAD_Y, PAD_X = 120, 256


def _plane(L, H, W, seed):
    return np.random.default_rng(seed).random((L, H, W)).astype(np.float32)


def _origins(H, W, win, seed, outside):
    """Window origins as the descriptor stage makes them, round(x) - win/2,
    for keypoints inside the plane, or up to the pad outside it."""
    rng = np.random.default_rng(seed)
    n = 24
    if outside:
        y0 = rng.integers(-PAD_Y, H + PAD_Y - 2 * win, n)
        x0 = rng.integers(-PAD_X + 1, W + 2 * 128 - 256, n)
        y0[:4] = [-PAD_Y, -win, H - 1, H + PAD_Y - 2 * win]
        x0[:4] = [-PAD_X + 1, -win, W - 1, W]
    else:
        y0 = rng.integers(-win // 2, H - win // 2, n)
        x0 = rng.integers(-win // 2, W - win // 2, n)
    return y0.astype(np.int32), x0.astype(np.int32)


@pytest.mark.parametrize("win", [112, 48])
def test_window_dims_match(win):
    assert twin.rolled_window_dims(win) == jwin2.rolled_window_dims(win)
    assert twin.aligned_window_dims(win) == jwin.aligned_window_dims(win)
    with pytest.raises(ValueError):
        twin.rolled_window_dims(121)


@pytest.mark.parametrize("outside", [False, True])
@pytest.mark.parametrize("win", [112, 48])
def test_exact_windows_match_jax_on_the_padded_plane(win, outside):
    L, H, W = 4, 88, 144
    plane = _plane(L, H, W, seed=win)
    y0, x0 = _origins(H, W, win, seed=win + outside, outside=outside)
    lp = np.random.default_rng(3).integers(0, L, y0.shape[0]).astype(
        np.int32)
    padded = jnp.pad(jnp.asarray(plane),
                     ((0, 0), (PAD_Y, PAD_Y), (PAD_X, PAD_X)), mode="edge")
    jw, jya = jwin2.gather_windows_exact(
        padded, jnp.asarray(lp), jnp.asarray(y0 + PAD_Y),
        jnp.asarray(x0 + PAD_X), win)
    tw, tya = twin.gather_windows_exact(
        torch.as_tensor(plane), torch.as_tensor(lp), torch.as_tensor(y0),
        torch.as_tensor(x0), win)
    np.testing.assert_array_equal(tya.numpy(), np.asarray(jya) - PAD_Y)
    np.testing.assert_array_equal(tya.numpy(), (y0 // 8) * 8)
    assert tw.shape == (y0.shape[0], *twin.rolled_window_dims(win))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


@pytest.mark.parametrize("outside", [False, True])
@pytest.mark.parametrize("win", [112, 48])
def test_aligned_windows_match_jax_on_the_padded_plane(win, outside):
    L, H, W = 3, 96, 300
    plane = _plane(L, H, W, seed=2 * win)
    y0, x0 = _origins(H, W, win, seed=win + 7 * outside, outside=outside)
    lp = np.random.default_rng(5).integers(0, L, y0.shape[0]).astype(
        np.int32)
    padded = jnp.pad(jnp.asarray(plane),
                     ((0, 0), (PAD_Y, PAD_Y), (PAD_X, PAD_X)), mode="edge")
    jw, jya, jxa = jwin.gather_windows_aligned(
        padded, jnp.asarray(lp), jnp.asarray(y0 + PAD_Y),
        jnp.asarray(x0 + PAD_X), win)
    tw, tya, txa = twin.gather_windows_aligned(
        torch.as_tensor(plane), torch.as_tensor(lp), torch.as_tensor(y0),
        torch.as_tensor(x0), win)
    np.testing.assert_array_equal(tya.numpy(), np.asarray(jya) - PAD_Y)
    np.testing.assert_array_equal(txa.numpy(), np.asarray(jxa) - PAD_X)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    # the Pallas kernel itself, in interpret mode, on the same origins
    kw = jwin.gather_windows_aligned_pallas(padded, jnp.asarray(lp), jya,
                                            jxa, win, interpret=True)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(kw))


def test_plain_gather_is_clamp_addressing():
    L, H, W = 2, 20, 30
    plane = _plane(L, H, W, seed=1)
    lp = np.array([0, 1, 1], np.int32)
    ya = np.array([-5, 8, 16], np.int32)
    xa = np.array([-3, 25, 0], np.int32)
    out = twin.gather_windows(torch.as_tensor(plane), torch.as_tensor(lp),
                              torch.as_tensor(ya), torch.as_tensor(xa), 9, 7)
    for i in range(3):
        rows = np.clip(ya[i] + np.arange(9), 0, H - 1)
        cols = np.clip(xa[i] + np.arange(7), 0, W - 1)
        np.testing.assert_array_equal(
            out[i].numpy(), plane[lp[i]][np.ix_(rows, cols)])
    empty = twin.gather_windows(torch.as_tensor(plane),
                                torch.zeros(0, dtype=torch.int32),
                                torch.zeros(0, dtype=torch.int32),
                                torch.zeros(0, dtype=torch.int32), 9, 7)
    assert empty.shape == (0, 9, 7)
    with pytest.raises(ValueError):
        twin.gather_windows(torch.as_tensor(plane[0]), torch.as_tensor(lp),
                            torch.as_tensor(ya), torch.as_tensor(xa), 9, 7)
