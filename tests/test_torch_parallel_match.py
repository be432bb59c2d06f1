"""popsift_torch.parallel.sharded_match on four gloo ranks, held to
popsift_tpu.parallel.batch.sharded_match and to the port's dense
ops/match.py:match_brute_force.

Inputs: the JAX test's random 32x128 left against 16x128 right
(tests/test_parallel.py), and the same descriptors under column masks
that reach the edge cases: a column block wholly invalid (its candidates
are (inf, the block's first index)), a block with one valid column (its
local second is inf), one valid column in all, and none (the ratio is
NaN and nothing is accepted).

Each port mesh is held exactly (indices, accept) to JAX's sharded_match
on a mesh of the same shape over the conftest's CPU devices, with the
distances within rtol 1e-5, both products being float32 sums in another
order.  Against JAX's (4, 2) mesh and the dense matcher, whose column
blocks differ, the best index, accept and best distance are held on
every row, and the second index wherever the second distance is finite:
where it is inf, it is the first candidate of the gather, which depends
on the blocks.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_parallel_ranks as tpr  # noqa: E402
from popsift_torch.ops.match import match_brute_force  # noqa: E402
from popsift_torch.parallel.ranks import run_ranks  # noqa: E402
from popsift_tpu.parallel import batch as jb  # noqa: E402

SHAPES = ((2, 2), (4, 1), (1, 4))


def _cases() -> dict:
    rng = np.random.default_rng(1)
    left = rng.random((32, 128)).astype(np.float32)
    right = rng.random((16, 128)).astype(np.float32)
    masks = {"random": np.ones(16, bool)}
    m = np.ones(16, bool)
    m[8:] = False
    masks["invalid_block"] = m
    m = np.ones(16, bool)
    m[8:] = False
    m[12] = True
    masks["one_valid_in_block"] = m
    m = np.zeros(16, bool)
    m[9] = True
    masks["one_valid"] = m
    masks["none_valid"] = np.zeros(16, bool)
    return {k: (left, right, v) for k, v in masks.items()}


CASES = _cases()


@pytest.fixture(scope="module")
def port():
    return run_ranks(tpr.match_rank, 4, "gloo", args=(SHAPES, CASES),
                     timeout=120.0)


def _jax(shape, name):
    data, model = shape
    if data * model == 8:
        devices = jax.devices()
    else:
        devices = jax.devices()[:data * model]
    mesh = jb.make_mesh(devices, data=data, model=model)
    l, r, rv = CASES[name]
    return tuple(np.asarray(x) for x in jb.sharded_match(mesh)(
        jnp.asarray(l), jnp.asarray(r), jnp.asarray(rv)))


def _check(got, want, second_where=None):
    g1i, g2i, acc, g1v, g2v = got
    w1i, w2i, wacc, w1v, w2v = want
    assert g1i.dtype == np.int32 and g2i.dtype == np.int32
    assert acc.dtype == bool and g1v.dtype == np.float32
    np.testing.assert_array_equal(g1i, w1i)
    np.testing.assert_array_equal(acc, wacc)
    np.testing.assert_allclose(g1v, w1v, rtol=1e-5)
    np.testing.assert_allclose(g2v, w2v, rtol=1e-5)
    sel = np.ones(len(g2i), bool) if second_where is None else second_where
    np.testing.assert_array_equal(g2i[sel], w2i[sel])


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_match_equals_jax_on_the_same_mesh(port, shape, name):
    want = _jax(shape, name)
    for out in port:
        _check(out[shape + (name,)], want)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_match_equals_jax_4x2_and_dense(port, shape, name):
    got = port[0][shape + (name,)]
    finite = np.isfinite(got[4])
    _check(got, _jax((4, 2), name), finite)
    l, r, rv = CASES[name]
    dense = tuple(t.numpy() for t in match_brute_force(
        torch.from_numpy(l), torch.from_numpy(r),
        r_valid=torch.from_numpy(rv)))
    _check(got, dense, finite)


def test_edge_cases_as_jax_has_them(port):
    for shape in SHAPES:
        g1i, g2i, acc, g1v, g2v = port[0][shape + ("none_valid",)]
        assert np.isinf(g1v).all() and np.isinf(g2v).all()
        assert not acc.any() and (g1i == 0).all()
        g1i, g2i, acc, g1v, g2v = port[0][shape + ("one_valid",)]
        assert (g1i == 9).all() and np.isfinite(g1v).all()
        assert np.isinf(g2v).all() and acc.all()


def test_ranks_agree_bit_for_bit(port):
    for key, want in port[0].items():
        for out in port[1:]:
            got = out[key]
            if want is None or isinstance(want, str):
                assert got == want
                continue
            for a, b in zip(got, want):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a.view(np.uint8),
                                              b.view(np.uint8))


@pytest.mark.parametrize("shape", SHAPES)
def test_indivisible_shapes_raise(port, shape):
    for out in port:
        assert "sharded_match" in out[shape + ("indivisible",)]
