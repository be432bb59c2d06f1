"""popsift_torch's brute-force matcher against popsift_tpu's, both on the
CPU (``popsift_tpu.ops.match.match_brute_force_jit``).

Descriptors are made from numpy seeds: RootSift-like rows (non-negative,
unit norm, rounded to u16 steps as ``desc_transfer="u16"`` delivers
them), exact copies, duplicated right rows (the first index wins a tie),
validity masks on either side, and the edge shapes M = 1, N = 0 and
M = 0.  Indices and ``accept`` must be equal; the distances agree within
rtol 1e-5 / atol 1e-6 (the two packages sum |l|^2, |r|^2 and l.r^T in
different orders).  The four scenarios of tests/test_match.py are run on
the port too.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from popsift_tpu.ops.match import match_brute_force_jit  # noqa: E402

from popsift_torch.ops.match import (ieee_float32_matmul,  # noqa: E402
                                     match_brute_force)

ROOT = Path(__file__).resolve().parent.parent


def rootsift_rows(rng, n):
    """Non-negative unit rows with a few dominant bins, in u16 steps."""
    d = rng.gamma(0.6, 1.0, (n, 128)).astype(np.float32)
    d = np.sqrt(d / d.sum(axis=1, keepdims=True))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (np.round(np.clip(d, 0, 1) * 65535.0).astype(np.uint16)
            .astype(np.float32) * np.float32(1.0 / 65535.0))


def both(l, r, l_valid=None, r_valid=None, ratio=0.8):
    """The JAX and the port's outputs as numpy tuples."""
    j = match_brute_force_jit(
        jnp.asarray(l), jnp.asarray(r),
        None if l_valid is None else jnp.asarray(l_valid),
        None if r_valid is None else jnp.asarray(r_valid), ratio=ratio)
    t = match_brute_force(
        torch.as_tensor(l), torch.as_tensor(r),
        None if l_valid is None else torch.as_tensor(l_valid),
        None if r_valid is None else torch.as_tensor(r_valid), ratio=ratio)
    return tuple(np.asarray(x) for x in j), tuple(x.numpy() for x in t)


def assert_same(j, t):
    names = ("best_idx", "second_idx", "accept", "best", "second")
    for name, a, b in zip(names, j, t):
        assert a.shape == b.shape, name
    assert t[0].dtype == np.int32 and t[1].dtype == np.int32
    assert t[2].dtype == np.bool_
    assert t[3].dtype == np.float32 and t[4].dtype == np.float32
    np.testing.assert_array_equal(t[0], j[0])
    np.testing.assert_array_equal(t[1], j[1])
    np.testing.assert_array_equal(t[2], j[2])
    np.testing.assert_allclose(t[3], j[3], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t[4], j[4], rtol=1e-5, atol=1e-6)


def noisy_copies(rng, n, m):
    """Left rows near right rows, each moved by noise of its own size (a
    real pair's mix of clear matches and ambiguous ones)."""
    r = rootsift_rows(rng, m)
    pick = rng.integers(0, m, n)
    noise = (rng.normal(0, 1, (n, 128)).astype(np.float32)
             * rng.uniform(0, 0.2, (n, 1)).astype(np.float32))
    return np.abs(r[pick] + noise).astype(np.float32), r


@pytest.mark.parametrize("n,m", [(64, 96), (300, 257)])
@pytest.mark.parametrize("kind", ["rootsift", "near"])
def test_matches_jax(n, m, kind):
    rng = np.random.default_rng(n * 1000 + m + (kind == "near"))
    if kind == "rootsift":
        l, r = rootsift_rows(rng, n), rootsift_rows(rng, m)
    else:
        l, r = noisy_copies(rng, n, m)
    j, t = both(l, r)
    assert_same(j, t)
    if kind == "near":
        assert 0 < t[2].sum() < n  # both verdicts occur


def test_exact_copies():
    rng = np.random.default_rng(5)
    r = rootsift_rows(rng, 50)
    l = r[[4, 0, 49, 17]]
    j, t = both(l, r)
    assert_same(j, t)
    np.testing.assert_array_equal(t[0], [4, 0, 49, 17])
    assert t[2].all()


def test_duplicated_right_rows_keep_the_first_index():
    rng = np.random.default_rng(6)
    r = rootsift_rows(rng, 40)
    r[[9, 30]] = r[3]          # three equal rows: 3, 9, 30
    r[25] = r[12]
    l = np.concatenate([r[[3, 12, 30]], rootsift_rows(rng, 20)])
    j, t = both(l, r)
    assert_same(j, t)
    np.testing.assert_array_equal(t[0][:3], [3, 12, 3])
    np.testing.assert_array_equal(t[1][:3], [9, 25, 9])
    assert not t[2][:3].any()    # 0 / 0 is NaN: rejected


def test_validity_masks():
    rng = np.random.default_rng(7)
    l, r = noisy_copies(rng, 80, 120)
    l_valid = rng.random(80) < 0.7
    r_valid = rng.random(120) < 0.6
    for lv, rv in ((l_valid, None), (None, r_valid), (l_valid, r_valid)):
        j, t = both(l, r, lv, rv)
        assert_same(j, t)
        if rv is not None:
            assert rv[t[0]].all() and rv[t[1]].all()
        if lv is not None:
            assert not t[2][~lv].any()


def test_ratio_argument():
    rng = np.random.default_rng(8)
    l, r = noisy_copies(rng, 100, 90)
    for ratio in (0.6, 0.8, 0.95):
        assert_same(*both(l, r, ratio=ratio))


def test_one_right_row():
    rng = np.random.default_rng(9)
    l, r = rootsift_rows(rng, 7), rootsift_rows(rng, 1)
    j, t = both(l, r)
    assert_same(j, t)
    assert np.isinf(t[4]).all() and t[2].all()
    np.testing.assert_array_equal(t[0], 0)


def test_every_right_row_invalid():
    rng = np.random.default_rng(10)
    l, r = rootsift_rows(rng, 5), rootsift_rows(rng, 6)
    j, t = both(l, r, r_valid=np.zeros(6, bool))
    assert_same(j, t)
    assert np.isinf(t[3]).all() and not t[2].any()


def test_no_left_row():
    rng = np.random.default_rng(11)
    j, t = both(np.zeros((0, 128), np.float32), rootsift_rows(rng, 9))
    assert_same(j, t)
    assert t[0].shape == (0,)


def test_no_right_row_raises_as_jax_does():
    rng = np.random.default_rng(12)
    l, r = rootsift_rows(rng, 4), np.zeros((0, 128), np.float32)
    with pytest.raises(ValueError):
        match_brute_force_jit(jnp.asarray(l), jnp.asarray(r))
    with pytest.raises(ValueError):
        match_brute_force(torch.as_tensor(l), torch.as_tensor(r))


def test_results_stay_on_the_inputs_device():
    rng = np.random.default_rng(13)
    out = match_brute_force(torch.as_tensor(rootsift_rows(rng, 3)),
                            torch.as_tensor(rootsift_rows(rng, 4)))
    assert all(x.device.type == "cpu" for x in out)


# tests/test_match.py's four scenarios, on the port

def _t(a):
    return torch.as_tensor(np.asarray(a))


def test_exact_match_accepted():
    rng = np.random.default_rng(0)
    r = rng.random((20, 128)).astype(np.float32)
    l = r[[3, 7, 11]] + 0.001  # near-exact copies
    best, second, accept, d1, d2 = match_brute_force(_t(l), _t(r))
    np.testing.assert_array_equal(best.numpy(), [3, 7, 11])
    assert bool(accept.all())


def test_ambiguous_match_rejected():
    rng = np.random.default_rng(1)
    base = rng.random(128).astype(np.float32)
    r = np.stack([base + 0.01, base + 0.011, rng.random(128)]).astype(
        np.float32)
    l = base[None]
    best, second, accept, d1, d2 = match_brute_force(_t(l), _t(r))
    # two near-identical right candidates: the ratio test fails
    assert not bool(accept[0])


def test_second_best_distinct():
    rng = np.random.default_rng(2)
    l = rng.random((5, 128)).astype(np.float32)
    r = rng.random((9, 128)).astype(np.float32)
    best, second, accept, d1, d2 = match_brute_force(_t(l), _t(r))
    assert bool((best != second).all())
    assert bool((d1 <= d2).all())


def test_invalid_right_columns_excluded():
    rng = np.random.default_rng(3)
    r = rng.random((6, 128)).astype(np.float32)
    l = r[[5]]
    r_valid = torch.as_tensor([True] * 5 + [False])
    best, second, accept, d1, d2 = match_brute_force(_t(l), _t(r), None,
                                                     r_valid)
    assert int(best[0]) != 5


def test_tf32_setting_is_held_off_and_restored():
    """The legacy flag, as a caller sets it: off inside, back after."""
    mm = torch.backends.cuda.matmul
    old = mm.allow_tf32
    try:
        mm.allow_tf32 = True
        with ieee_float32_matmul():
            assert mm.allow_tf32 is False
        assert mm.allow_tf32 is True
        rng = np.random.default_rng(14)
        match_brute_force(torch.as_tensor(rootsift_rows(rng, 3)),
                          torch.as_tensor(rootsift_rows(rng, 4)))
        assert mm.allow_tf32 is True
    finally:
        mm.allow_tf32 = old


def test_tf32_new_api_is_held_off_and_restored():
    """A process that set ``fp32_precision`` (PyTorch then refuses the
    legacy getter), in a subprocess: that state is process-wide."""
    if not hasattr(torch.backends.cuda.matmul, "fp32_precision"):
        pytest.skip("this PyTorch has no fp32_precision setting")
    code = (
        "import torch\n"
        "from popsift_torch.ops.match import ieee_float32_matmul\n"
        "mm = torch.backends.cuda.matmul\n"
        "mm.fp32_precision = 'tf32'\n"
        "with ieee_float32_matmul():\n"
        "    assert mm.fp32_precision == 'ieee', mm.fp32_precision\n"
        "assert mm.fp32_precision == 'tf32', mm.fp32_precision\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
