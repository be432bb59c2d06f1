"""popsift_torch's ``--log`` dump tree against popsift_tpu's, on the CPU.

* ``format_desc_row`` is byte for byte the JAX package's on
  ``test_parity_format.py``'s values (which a g++-compiled golden holds
  to the reference's ostream output), in both row formats.
* ``dump_all`` of the port and of the JAX package on one small image: the
  same relative file names; raw float dumps of the levels and DoGs within
  ``test_torch_pyramid.py``'s atol 1e-3; their 8-bit PGMs off by at most 1
  on at most 1% of the pixels (a level a last bit apart can truncate to
  the next integer); desc/fpt row counts exact and their values within
  the end-to-end tolerances of ``test_torch_e2e.py`` (scaled by the
  reference's second 2^(octave-up) and plus half a printed digit), the
  angles and descriptors of tied features left out as there.
* ``PopSift(Config with log_mode=ALL, device="cpu")`` writes the tree into
  the working directory and gives the features of ``extract_features``;
  in MatchingMode it writes nothing.
* ``extract_features(..., return_pyramid=True)`` gives the default
  route's features bit for bit, with every octave's whole stack and DoG.
"""

import math
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

from popsift_tpu import debugdump as jdump  # noqa: E402
from popsift_tpu.io import pgm as jpgm  # noqa: E402

import popsift_torch as pt  # noqa: E402
from popsift_torch import debugdump as tdump  # noqa: E402
from popsift_torch.extract import extract_features, make_plan  # noqa: E402

from test_parity_format import _values  # noqa: E402
from torch_parity import (DESC_TOL, ORI_TOL, SIGMA_RTOL,  # noqa: E402
                          XY_ATOL, jax_config, one_thread, tied_features)

PYRAMID_ATOL = 1e-3     # test_torch_pyramid.py


@pytest.mark.parametrize("with_orientation", [True, False])
def test_format_desc_row_matches_jax(with_orientation):
    vals = _values()
    rng = np.random.default_rng(3)
    for i in range(0, len(vals) - 4, 3):
        x, y, sigma, ori = vals[i:i + 4]
        sigma = abs(sigma) + 0.5
        desc = rng.choice(vals, 128)
        got = tdump.format_desc_row(x, y, sigma, ori, desc,
                                    with_orientation)
        want = jdump.format_desc_row(x, y, sigma, ori, desc,
                                     with_orientation)
        assert got == want
        assert got.endswith(" \n") and len(got.split()) == (
            132 if with_orientation else 133)


def _tree(root: Path) -> dict:
    return {str(p.relative_to(root)): p for p in sorted(root.rglob("*"))
            if p.is_file()}


def _rows(path: Path) -> np.ndarray:
    return np.array([ln.split() for ln in path.read_text().splitlines()],
                    dtype=np.float64).reshape(-1, 132 if "dir-desc" in
                                              str(path) else 133)


@pytest.fixture(scope="module")
def dumps(textured_image, tmp_path_factory):
    img = textured_image
    h, w = img.shape
    cfg = pt.Config()
    cfg.set_log_mode(pt.LogMode.ALL)
    job = types.SimpleNamespace(_w=w, _h=h, _image_data=img)
    jdir = tmp_path_factory.mktemp("jax")
    tdir = tmp_path_factory.mktemp("torch")
    jdump.dump_all(jax_config(cfg), job, "pyramid", base_dir=str(jdir))
    with one_thread():
        tdump.dump_all(cfg, img, "pyramid", base_dir=str(tdir),
                       device="cpu")
    return img, cfg, _tree(jdir), _tree(tdir)


def test_dump_tree_names(dumps):
    img, cfg, jt, tt = dumps
    assert set(tt) == set(jt)
    plan = make_plan(cfg, img.shape[1], img.shape[0])
    L = plan.levels + 3
    dirs = {name.split("/")[0] for name in tt}
    assert dirs == set(tdump.DIRS)
    for d, n in (("dir-octave", L), ("dir-octave-dump", L), ("dir-dog", L - 1),
                 ("dir-dog-txt", L - 1), ("dir-dog-dump", L - 1)):
        assert sum(name.startswith(d + "/") for name in tt) == \
            plan.octaves * n, d


def test_dump_raw_floats_match_jax(dumps):
    _, _, jt, tt = dumps
    names = [n for n in tt if n.endswith(".dump")]
    assert names
    worst = 0.0
    for n in names:
        a = np.fromfile(tt[n], np.float32)
        b = np.fromfile(jt[n], np.float32)
        assert a.shape == b.shape and a.size > 0, n
        worst = max(worst, float(np.abs(a - b).max()))
    assert worst <= PYRAMID_ATOL, worst


def test_dump_pgms_match_jax(dumps):
    _, _, jt, tt = dumps
    names = [n for n in tt if n.endswith(".pgm")]
    assert names
    for n in names:
        a = jpgm._read_pgm_py(str(tt[n])).astype(np.int32)
        b = jpgm._read_pgm_py(str(jt[n])).astype(np.int32)
        assert a.shape == b.shape, n
        off = np.abs(a - b)
        assert off.max() <= 1, n
        assert (off > 0).mean() <= 0.01, n


@pytest.mark.parametrize("kind", ["dir-desc", "dir-fpt"])
def test_dump_descriptor_rows_match_jax(dumps, kind):
    img, cfg, jt, tt = dumps
    name = f"{kind}/desc-pyramid.txt"
    got, want = _rows(tt[name]), _rows(jt[name])
    assert got.shape == want.shape and got.shape[0] > 0
    # per row: its feature's octave (the second 2^(octave-up) scaling)
    # and whether its orientation peaks tie
    with one_thread():
        feats = extract_features(img, cfg, device="cpu")
    s = feats.soa()
    assert got.shape[0] == feats.get_descriptor_count()
    feat = np.repeat(np.arange(feats.get_feature_count()), s["num_ori"])
    scale = 2.0 ** (s["debug_octave"][feat] - cfg.get_upscale_factor())
    tied = tied_features(img, cfg)[feat]

    def close(col, atol, rtol=0.0):
        # 5 significant digits printed: half a digit of the value
        ref = want[:, col]
        err = np.abs(got[:, col] - ref)
        return err <= atol + (rtol + 5e-5) * np.abs(ref)

    assert close(0, XY_ATOL * scale).all()
    assert close(1, XY_ATOL * scale).all()
    if kind == "dir-desc":
        assert close(2, 0.0, SIGMA_RTOL).all()
        d = np.abs(got[:, 3] - want[:, 3]) % 360.0
        d = np.minimum(d, 360.0 - d)
        assert (d[~tied] <= math.degrees(ORI_TOL) + 5e-5 * 360).all()
        first = 4
    else:
        assert close(2, 0.0, 2 * SIGMA_RTOL).all()
        assert (got[:, 3] == 0).all() and close(4, 0.0, 2 * SIGMA_RTOL).all()
        first = 5
    err = np.abs(got[~tied, first:] - want[~tied, first:])
    assert (err <= DESC_TOL + 5e-5 * np.abs(want[~tied, first:])).all()


def test_pipeline_log_mode_writes_tree(textured_image, tmp_path,
                                       monkeypatch):
    monkeypatch.chdir(tmp_path)
    img = textured_image
    cfg = pt.Config()
    cfg.set_log_mode(pt.LogMode.ALL)
    with one_thread():
        want = extract_features(img, cfg, device="cpu")
        assert not any(tmp_path.iterdir())
        with pt.PopSift(cfg, device="cpu") as ps:
            got = ps.enqueue(img.shape[1], img.shape[0], img).get()
    assert set(p.name for p in tmp_path.iterdir()) == set(tdump.DIRS)
    sw, sg = want.soa(), got.soa()
    assert all(np.array_equal(sw[k], sg[k]) for k in sw)
    assert np.array_equal(want.get_descriptors(), got.get_descriptors())
    rows = (tmp_path / "dir-desc" / "desc-pyramid.txt").read_text()
    assert len(rows.splitlines()) == got.get_descriptor_count()


def test_matching_mode_does_not_dump(textured_image, tmp_path,
                                     monkeypatch):
    """MatchingMode writes no tree (popsift_tpu/pipeline.py:559-573)."""
    monkeypatch.chdir(tmp_path)
    img = textured_image
    cfg = pt.Config()
    cfg.set_log_mode(pt.LogMode.ALL)
    with pt.PopSift(cfg, mode=pt.ProcessingMode.MATCHING,
                    device="cpu") as ps:
        dev = ps.enqueue(img.shape[1], img.shape[0], img).get_dev()
    assert dev.get_feature_count() > 0
    assert not any(tmp_path.iterdir())


def test_pyramid_route_features_bit_equal(textured_image):
    img = textured_image
    cfg = pt.Config()
    with one_thread():
        want = extract_features(img, cfg, device="cpu")
        got, stacks, dogs = extract_features(img, cfg, device="cpu",
                                             return_pyramid=True)
    sw, sg = want.soa(), got.soa()
    for k in sw:
        assert np.array_equal(sw[k].view(np.uint8), sg[k].view(np.uint8)), k
    assert np.array_equal(want.get_descriptors().view(np.uint32),
                          got.get_descriptors().view(np.uint32))
    plan = make_plan(cfg, img.shape[1], img.shape[0])
    assert len(stacks) == len(dogs) == plan.octaves
    for (w, h), st, dg in zip(plan.dims, stacks, dogs):
        assert tuple(st.shape) == (plan.levels + 3, h, w)
        assert tuple(dg.shape) == (plan.levels + 2, h, w)
        torch.testing.assert_close(dg, st[1:] - st[:-1], rtol=0, atol=0)
