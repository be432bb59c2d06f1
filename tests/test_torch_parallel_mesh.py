"""popsift_torch.parallel: the mesh, pad_batch, the bucket rule and the
default key, held to popsift_tpu.parallel.batch and popsift_tpu.staged.

The mesh is built by four gloo ranks on the CPU (one fresh process each,
started by ``popsift_torch.parallel.ranks.run_ranks``); the JAX meshes
are built over the conftest's virtual CPU devices.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import torch_parallel_ranks as tpr  # noqa: E402
from popsift_torch import config as tcfg  # noqa: E402
from popsift_torch import extract as text  # noqa: E402
from popsift_torch.parallel import batch as tb  # noqa: E402
from popsift_torch.parallel.ranks import run_ranks  # noqa: E402
from popsift_tpu import config as jcfg  # noqa: E402
from popsift_tpu import extract as jext  # noqa: E402
from popsift_tpu import staged as jstaged  # noqa: E402
from popsift_tpu.parallel import batch as jb  # noqa: E402

SHAPES = ((4, 1), (2, 2), (1, 4))
BATCHES = (1, 2, 3, 4, 5)


@pytest.fixture(scope="module")
def ranks():
    return run_ranks(tpr.mesh_rank, 4, "gloo", args=(SHAPES, BATCHES),
                     timeout=120.0)


@pytest.mark.parametrize("shape", SHAPES)
def test_mesh_coordinates_and_groups(ranks, shape):
    data, model = shape
    grid = np.arange(4).reshape(data, model)
    for rank, out in enumerate(ranks):
        got = out[shape]
        d, m = got["coords"]
        assert grid[d, m] == rank
        assert got["data_ranks"] == tuple(grid[:, m])
        assert got["model_ranks"] == tuple(grid[d, :])
        assert got["data_group"] == got["data_ranks"]
        assert got["model_group"] == got["model_ranks"]
        assert got["shape"] == {"data": data, "model": model}


@pytest.mark.parametrize("shape", SHAPES)
def test_pad_batch_matches_jax(ranks, shape):
    data, model = shape
    mesh = jb.make_mesh(jax.devices()[:4], data=data, model=model)
    for b in BATCHES:
        images = np.arange(b * 6, dtype=np.uint8).reshape(b, 2, 3)
        want_images, want_valid = jb.pad_batch(images, mesh)
        for out in ranks:
            got_images, got_valid = out[shape]["pads"][b]
            np.testing.assert_array_equal(got_images, want_images)
            assert got_images.dtype == want_images.dtype
            np.testing.assert_array_equal(got_valid, want_valid)


def test_make_mesh_needs_a_process_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        tb.make_mesh(device="cpu")


def test_bucket_matches_jax():
    got = [tb.bucket(n) for n in range(5001)]
    want = [jstaged.bucket(n) for n in range(5001)]
    assert got == want


@pytest.mark.parametrize("wh", [(64, 48), (160, 120), (1920, 1080)])
def test_default_key_matches_jax(wh):
    w, h = wh
    tplan = text.make_plan(tcfg.Config(), w, h)
    jplan = jext.make_plan(jcfg.Config(), w, h)
    assert tb._default_key(tplan) == jb._default_key(jplan)
    assert tb._default_key(tplan, 300) == jb._default_key(jplan, 300)


@pytest.mark.parametrize("x,m,want", [(0, 8, 0), (1, 8, 8), (8, 8, 8),
                                      (9, 8, 16), (256, 32, 256),
                                      (257, 32, 288)])
def test_round_to(x, m, want):
    assert tb._round_to(x, m) == want == jb._round_to(x, m)


def test_key_from_counts_holds_every_count():
    plan = text.make_plan(tcfg.Config(), 1920, 1080)
    rng = np.random.default_rng(0)
    counts = [int(rng.integers(0, c + 1)) for c in plan.ext_caps]
    oris = [int(c * 1.1) for c in counts]
    cks, ks, bs, ft, bt = tb.key_from_counts(plan, counts, oris)
    assert cks == plan.cand_caps
    for o in range(plan.octaves):
        assert counts[o] <= ks[o] <= plan.ext_caps[o]
        assert min(oris[o], plan.ori_caps[o]) <= bs[o] <= plan.ori_caps[o]
        assert ks[o] >= 128 and bs[o] >= 128
    assert sum(counts) <= ft <= sum(ks)
    assert sum(min(c, b) for c, b in zip(oris, bs)) <= bt <= sum(bs)
