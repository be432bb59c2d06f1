"""popsift_torch.parallel: sfm_frontend_step, the batched extractors and
dryrun_multichip on four gloo ranks, held to popsift_tpu.parallel.batch.

The port's step runs on a (2, 2) mesh of four gloo ranks on the CPU and
JAX's on a (2, 2) mesh of the conftest's CPU devices, at 48x64, in four
cases: on the images of tests/test_parallel.py an even batch of four, an
uneven one of three (padded by pad_batch), and a tiny key that clamps
extrema, (cks, ks, bs, ft, bt) = ((4,) * 4, (1,) * 4, (2,) * 4, 4, 8) with
desc_cap=8; and four overlapping crops of the conftest's textured image.
Extrema counts, overflow and every shape must be exact.  So must the
valid rows and the match counts of the tiny key and the crops, and their
valid descriptor rows agree within the end-to-end descriptor tolerance
of tests/test_torch_e2e.py (1e-3: XLA:CPU fuses the blur's multiply-adds,
the port rounds each).

The even and uneven batches' main features sit at the centres of round
blobs, whose nearly symmetric orientation histograms let last-bit
differences of the keypoint and the gradient field pick the peaks:
their orientations, and so their descriptors, number of rows and
matches, are decided there.  tests/test_torch_parallel_blobs.py shows
that the port's orientation code gives JAX's counts on JAX's inputs,
and that on its own inputs it differs at one feature of image 1 (3
orientations against 4).  So image 1's rows must be JAX's less one and
every other image's JAX's; at most one pair's matches may differ, by
one; the rows of the features off the centres are held to 1e-3.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_parallel_ranks as tpr  # noqa: E402
import torch_parity as tp  # noqa: E402
from popsift_torch import config as tcfg  # noqa: E402
from popsift_torch.parallel.dryrun import dryrun_multichip  # noqa: E402
from popsift_torch.parallel.dryrun import _test_image  # noqa: E402
from popsift_torch.parallel.ranks import run_ranks  # noqa: E402
from popsift_tpu import config as jcfg  # noqa: E402
from popsift_tpu.parallel import batch as jb  # noqa: E402

W, H = 64, 48
DESC_TOL = 1e-3
# the cases whose rows and matches must equal JAX's exactly
EXACT = ("tiny_key", "textured")
TINY_KEY = ((4,) * 4, (1,) * 4, (2,) * 4, 4, 8)


def _images(batch, h=H, w=W):
    """tests/test_parallel.py's images: two Gaussian blobs that move."""
    imgs = []
    for b in range(batch):
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        img = np.zeros((h, w), np.float32)
        for (cx, cy, s) in [(20 + b, 16, 2.5), (44 - b, 32, 3.5)]:
            img += np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2)
                            / (2 * s * s)))
        imgs.append(np.clip(img, 0, 1))
    return np.stack(imgs)


def _blob_centres(b: int):
    return ((20 + b, 16), (44 - b, 32))


def _textured_crops() -> np.ndarray:
    """Four overlapping 48x64 crops of the conftest's textured image."""
    rng = np.random.default_rng(42)
    img = rng.random((15, 20)).astype(np.float32)
    img = np.kron(img, np.ones((8, 8), np.float32))
    for _ in range(2):
        img = (img + np.roll(img, 1, 0) + np.roll(img, -1, 0)
               + np.roll(img, 1, 1) + np.roll(img, -1, 1)) / 5.0
    img = (img - img.min()) / (img.max() - img.min())
    img = (img * 255).astype(np.uint8)
    return np.stack([img[y:y + H, x:x + W]
                     for y, x in ((10, 20), (12, 23), (14, 26), (16, 29))])


def _cases() -> dict:
    even = _images(4)
    padded = np.concatenate([_images(3), np.zeros((1, H, W), np.float32)])
    valid = np.array([True, True, True, False])
    return {"even": (even, None, 256, None),
            "uneven": (padded, valid, 256, None),
            "tiny_key": (even, None, 8, TINY_KEY),
            "textured": (_textured_crops(), None, 256, None)}


CASES = _cases()


@pytest.fixture(scope="module", autouse=True)
def port_ranks():
    """The port's four ranks, started as the module starts so that they
    run while JAX compiles its steps."""
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(run_ranks, tpr.sfm_rank, 4, "gloo",
                          args=((2, 2), CASES, W, H), timeout=150.0)


@pytest.fixture(scope="module")
def port(port_ranks):
    return port_ranks.result()


@pytest.fixture(scope="module")
def single():
    """extract_features of each image of the even batch (the uneven
    batch's real frames are its first three)."""
    return [tp.port_features(img, tcfg.Config())
            for img in CASES["even"][0]]


@pytest.fixture(scope="module")
def jax_mesh():
    return jb.make_mesh(jax.devices()[:4], data=2, model=2)


@pytest.fixture(scope="module")
def jax_steps(jax_mesh):
    cfg = jcfg.Config()
    return {256: jb.sfm_frontend_step(cfg, W, H, jax_mesh, desc_cap=256)[0],
            8: jb.sfm_frontend_step(cfg, W, H, jax_mesh, desc_cap=8,
                                    key=TINY_KEY)[0]}


@pytest.fixture(scope="module")
def jax_out(jax_steps):
    out = {}
    for name, (images, valid, cap, _) in CASES.items():
        v = None if valid is None else jnp.asarray(valid)
        res = jax_steps[cap](jnp.asarray(images), v)
        out[name] = {k: np.asarray(x) for k, x in res.items()}
    return out


def test_textured_crops_are_the_conftest_image(textured_image):
    crops = CASES["textured"][0]
    np.testing.assert_array_equal(crops[0], textured_image[10:58, 20:84])
    np.testing.assert_array_equal(crops[3], textured_image[16:64, 29:93])


def test_uneven_case_is_pad_batch(jax_mesh):
    padded, valid = jb.pad_batch(_images(3), jax_mesh)
    np.testing.assert_array_equal(padded, CASES["uneven"][0])
    np.testing.assert_array_equal(valid, CASES["uneven"][1])


@pytest.mark.parametrize("name", sorted(CASES))
def test_sfm_step_counts_and_shapes_equal_jax(port, jax_out, name):
    want = jax_out[name]
    for out in port:
        got = out[name]
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].shape == want[k].shape, k
            assert got[k].dtype == want[k].dtype, k
        exact = ("ext_counts", "overflow") + (
            ("desc_valid", "match_counts") if name in EXACT else ())
        for k in exact:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("name", EXACT)
def test_sfm_step_descriptors_match_jax(port, jax_out, name):
    want = jax_out[name]
    got = port[0][name]
    rows = want["desc_valid"]
    assert rows.any()
    err = np.abs(got["desc"][rows] - want["desc"][rows]).max()
    assert err <= DESC_TOL, err
    # past the valid rows the port writes zeros (JAX leaves padding)
    assert not got["desc"][~rows].any()


@pytest.mark.parametrize("name", ["even", "uneven"])
def test_blob_centres_are_the_counted_divergence(port, jax_out, single,
                                                name):
    want, got = jax_out[name], port[0][name]
    rows_got = got["desc_valid"].sum(axis=1)
    rows_want = want["desc_valid"].sum(axis=1)
    moved = np.flatnonzero(rows_got != rows_want)
    assert moved.tolist() == [1]
    assert rows_got[1] == rows_want[1] - 1
    pairs = np.flatnonzero(got["match_counts"] != want["match_counts"])
    assert len(pairs) <= 1
    assert np.abs(got["match_counts"] - want["match_counts"]).max() <= 1
    images, valid = CASES[name][:2]
    off_centre = 0
    for i in range(len(images)):
        if (valid is not None and not valid[i]) or i in moved:
            continue
        feats = single[i]
        soa = feats.soa()
        centre = np.zeros(feats.get_feature_count(), bool)
        for cx, cy in _blob_centres(i):
            centre |= ((np.abs(soa["xpos"] - cx) < 1e-2)
                       & (np.abs(soa["ypos"] - cy) < 1e-2))
        idx = soa["desc_idx"][~centre]
        idx = idx[idx >= 0]
        off_centre += len(idx)
        err = np.abs(got["desc"][i][idx] - want["desc"][i][idx])
        assert err.max(initial=0.0) <= DESC_TOL, (i, err.max())
    assert off_centre > 0


def test_tiny_key_counts(port):
    """A key that clamps extrema: only refinement's buffer and the rows
    beyond bs count as overflow, so image 1 keeps 0 extrema (its first 4
    candidates do not survive) and overflow stays 0."""
    got = port[0]["tiny_key"]
    assert got["ext_counts"].tolist() == [[1, 0, 1, 0]]
    assert got["overflow"].tolist() == [0, 0, 0, 0]
    assert got["desc_valid"].sum(axis=1).tolist() == [1, 0, 1, 0]
    assert got["match_counts"].tolist() == [0, 0, 0]
    assert got["desc"].shape == (4, 32, 128)


def test_uneven_pad_frame_and_real_frames(port):
    got, even = port[0]["uneven"], port[0]["even"]
    assert not got["desc_valid"][3].any()
    assert got["match_counts"][2] == 0
    np.testing.assert_array_equal(got["desc_valid"][:3],
                                  even["desc_valid"][:3])
    np.testing.assert_array_equal(got["match_counts"][:2],
                                  even["match_counts"][:2])
    np.testing.assert_array_equal(got["desc"][:3], even["desc"][:3])


def test_ranks_agree_bit_for_bit(port):
    for name in CASES:
        for out in port[1:]:
            for k, v in port[0][name].items():
                np.testing.assert_array_equal(
                    out[name][k].view(np.uint8), v.view(np.uint8))


def test_ranks_import_no_jax(port):
    for out in port:
        assert out["jax_imported"] == []


def test_batched_rows_equal_extract_features(port, single):
    """Under the default key (which holds every row at 48x64) each image's
    rows are extract_features' descriptors bit for bit."""
    got = port[0]["staged"]
    assert port[0]["staged_key"] == ((128,) * 4, (128,) * 4, (128,) * 4,
                                     512, 512)
    for i, feats in enumerate(single):
        desc = feats.get_descriptors()
        n = desc.shape[0]
        assert got["ori_total"][i] == n
        assert got["ext_total"][i] == feats.get_feature_count()
        assert got["overflow"][i] == 0
        assert got["desc"][i][:n].tobytes() == desc.tobytes()
        assert not got["desc"][i][n:].any()


def test_batched_extractor_counts_equal_single(port, single):
    legacy = port[0]["legacy"]                  # (octaves, B)
    for i, feats in enumerate(single):
        per_octave = np.bincount(feats.soa()["debug_octave"],
                                 minlength=legacy.shape[0])
        np.testing.assert_array_equal(legacy[:, i], per_octave)
    assert (legacy.sum(axis=0) >= 1).all()


def test_indivisible_batch_raises(port):
    for out in port:
        assert "does not split over the data axis" in out["indivisible"]


def test_dryrun_multichip_on_cpu(capsys, jax_steps, jax_mesh):
    line = dryrun_multichip(4, device="cpu")
    assert capsys.readouterr().out.strip() == line
    assert line.startswith("dryrun_multichip: mesh=(2x2) batch=3+1pad "
                           "desc_cap=256 match_counts=")
    # JAX's step on the dryrun's padded batch gives the same counts
    images = np.stack([_test_image(H, W) for _ in range(3)])
    padded, valid = jb.pad_batch(images, jax_mesh)
    want = jax_steps[256](jnp.asarray(padded), jnp.asarray(valid))
    assert line.endswith(
        f"match_counts={np.asarray(want['match_counts']).tolist()}")
