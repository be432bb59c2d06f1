"""popsift_torch's reference-layout tree and parity pack
(popsift_torch/eval/parity.py) against tools/oxford_parity.py and
tools/parity_pack.py, on the CPU.

* The port's ``produce_output_tree`` of a 240x320 crop of
  tests/data/scenes/street.pgm passes the JAX tool's own comparators at
  their default tolerances against the JAX tool's tree of the same crop
  (one JAX compile): every pyramid and DoG level, and features.txt and
  keypoints.txt.
* The port's comparators return the JAX comparators' verdicts and
  messages on those two trees, both ways, and on a copy of the port's
  tree with one level and the keypoints corrupted.
* ``build_pack`` on one synthetic scene gives the layout that
  tests/test_parity_format.py::test_parity_pack_builds checks, and the
  synthetic scene is the JAX tool's.
"""

import json
import os
import shutil
import sys
import tarfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

from popsift_torch.eval import parity as tpar  # noqa: E402
from popsift_torch.eval import oxford as tox  # noqa: E402
from popsift_torch.io.pgm import read_pgm, write_pgm  # noqa: E402

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))

import oxford_parity as jpar  # noqa: E402
import parity_pack as jpack  # noqa: E402

# the JAX tool's default tolerances (tools/oxford_parity.py's flags)
TOL_MEAN, TOL_FRAC, KP_EPS, MIN_REP, TOL_L2 = 1.0, 0.02, 1.5, 0.99, 0.05
LEAVES = ("features.txt", "keypoints.txt", "descriptors.txt")


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """(port tree, JAX tree) of a 240x320 crop of street.pgm."""
    img = np.ascontiguousarray(tox.load_scene("street")[120:360, 160:480])
    root = tmp_path_factory.mktemp("trees")
    port, jax = str(root / "port"), str(root / "jax")
    tpar.produce_output_tree(img, port, device="cpu")
    jpar.produce_output_tree(img, jax)
    return port, jax


def test_same_layout(trees):
    port, jax = trees
    for sub in ("dir-octave", "dir-dog"):
        assert sorted(os.listdir(os.path.join(port, sub))) == sorted(
            os.listdir(os.path.join(jax, sub)))
    assert sorted(os.listdir(port)) == sorted(os.listdir(jax)) == sorted(
        ("dir-octave", "dir-dog") + LEAVES)
    for leaf in LEAVES:
        with open(os.path.join(port, leaf)) as a, \
                open(os.path.join(jax, leaf)) as b:
            n = len(a.readlines())
            assert n == len(b.readlines()) and n > 20


@pytest.mark.parametrize("sub", ["dir-octave", "dir-dog"])
def test_port_levels_pass_the_jax_comparator(trees, sub):
    port, jax = trees
    ok, msg = jpar.compare_pgm_dir(os.path.join(port, sub),
                                   os.path.join(jax, sub), TOL_MEAN,
                                   TOL_FRAC)
    print(msg)
    assert ok, msg
    assert tpar.compare_pgm_dir(os.path.join(port, sub),
                                os.path.join(jax, sub), TOL_MEAN,
                                TOL_FRAC) == (ok, msg)


@pytest.mark.parametrize("leaf", ["features.txt", "keypoints.txt"])
def test_port_features_pass_the_jax_comparator(trees, leaf):
    port, jax = trees
    ok, msg = jpar.compare_features(os.path.join(port, leaf),
                                    os.path.join(jax, leaf), KP_EPS,
                                    MIN_REP, TOL_L2)
    print(msg)
    assert ok, msg
    assert tpar.compare_features(os.path.join(port, leaf),
                                 os.path.join(jax, leaf), KP_EPS, MIN_REP,
                                 TOL_L2) == (ok, msg)


@pytest.mark.parametrize("swap", [False, True])
def test_comparators_give_the_jax_numbers(trees, swap):
    """Both comparators of the port on the two trees, either way round,
    return the JAX tool's (verdict, message); compare_tree is its per-image
    rule (pyramid, DoG and features.txt all pass)."""
    a, b = trees[::-1] if swap else trees
    want = []
    for sub in ("dir-octave", "dir-dog"):
        want.append(jpar.compare_pgm_dir(os.path.join(a, sub),
                                         os.path.join(b, sub), TOL_MEAN,
                                         TOL_FRAC))
    want.append(jpar.compare_features(os.path.join(a, "features.txt"),
                                      os.path.join(b, "features.txt"),
                                      KP_EPS, MIN_REP, TOL_L2))
    ok, msgs = tpar.compare_tree(a, b)
    assert msgs == [m for _, m in want]
    assert ok == all(o for o, _ in want)
    np.testing.assert_array_equal(
        tpar.load_rows(os.path.join(a, "features.txt"))[0],
        jpar._load_rows(os.path.join(a, "features.txt"))[0])


def test_corruption_fails_both_comparators(trees, tmp_path):
    port, _ = trees
    bad = str(tmp_path / "bad")
    shutil.copytree(port, bad)
    d = os.path.join(bad, "dir-octave")
    name = sorted(os.listdir(d))[0]
    img = read_pgm(os.path.join(d, name))
    write_pgm(os.path.join(d, name),
              np.clip(img.astype(np.int16) + 8, 0, 255).astype(np.uint8))
    feats = os.path.join(bad, "features.txt")
    with open(feats) as f:
        lines = f.readlines()
    with open(feats, "w") as f:
        for ln in lines:
            t = ln.split()
            t[0] = str(float(t[0]) + 5.0)
            f.write(" ".join(t) + "\n")
    args = (os.path.join(port, "dir-octave"), d, TOL_MEAN, TOL_FRAC)
    got = tpar.compare_pgm_dir(*args)
    assert got == jpar.compare_pgm_dir(*args) and not got[0]
    args = (os.path.join(port, "features.txt"), feats, KP_EPS, MIN_REP,
            TOL_L2)
    got = tpar.compare_features(*args)
    assert got == jpar.compare_features(*args) and not got[0]
    assert not tpar.compare_tree(port, bad)[0]


def test_reference_protocol_config_is_the_tools():
    c, j = tpar.reference_protocol_config(), jpar.reference_protocol_config()
    for f in ("gauss_mode", "sift_mode", "desc_mode", "norm_mode",
              "log_mode"):
        assert getattr(c, f).value == getattr(j, f).value, f
    assert c.desc_transfer == j.desc_transfer == "f32"
    assert c.upscale_factor == j.upscale_factor


def test_build_pack_layout(tmp_path):
    """tests/test_parity_format.py::test_parity_pack_builds's checks."""
    img = tpar.synthetic_scene(1, 96, 128)
    np.testing.assert_array_equal(img, jpack._synthetic_scene(1, 96, 128))
    out = str(tmp_path / "pack.tgz")
    tpar.build_pack([("tiny", img)], out, device="cpu")
    with tarfile.open(out) as tf:
        names = tf.getnames()
        manifest = json.load(tf.extractfile("parity-pack/MANIFEST.json"))
    base = "parity-pack/tiny/output-tiny"
    for leaf in LEAVES:
        assert f"{base}/{leaf}" in names
    assert any(n.startswith(f"{base}/dir-octave/pyramid-o-0-l-")
               for n in names)
    assert any(n.startswith(f"{base}/dir-dog/d-pyramid-o-0-l-")
               for n in names)
    assert manifest["protocol"] == tpar.PACK_PROTOCOL
    assert manifest["images"] == {"tiny": {"h": 96, "w": 128}}
