"""popsift_torch's Oxford-shaped protocol (popsift_torch/eval/oxford.py)
against tools/oxford_protocol.py, on the CPU.

* ``make_sequence`` gives the JAX tool's images bit for bit and its
  affines exactly, for every family: on tests/test_oxford_protocol.py's
  small synthetic scene, on the hopper scene for zoomrot, and on the
  average scene for jpeg, whose five images the port reads from
  tests/data/scenes/jpeg/ (no imaging library in the port) and which
  equal the JAX tool's PIL round trip byte for byte.
* ``desc_l2_stats`` of the port and of the JAX tool agree on the same
  features.
* Hopper's pair 1-2 in PopSift mode through ``PopSift(device="cpu")``
  reproduces PARITY_r05.json's row (the JAX tool's record): keypoint
  counts within ROW_KEYPOINTS, rates within ROW_RATE.
* A 120x160 hopper crop and its zoom+rotation images give the same rows
  through the port and through the JAX package's ``get_extractor`` (one
  JAX compile).
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

from popsift_tpu.eval import repeatability as jrep  # noqa: E402

import popsift_torch as pt  # noqa: E402
from popsift_torch.eval import oxford as tox  # noqa: E402
from popsift_torch.eval import repeatability as trep  # noqa: E402

from torch_parity import (hopper_crop, jax_features,  # noqa: E402
                          port_features)

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))

import oxford_protocol as jox  # noqa: E402

RECORD = Path(__file__).resolve().parent.parent / "PARITY_r05.json"
# a row of the port against the JAX tool's: keypoints, and both rates
ROW_KEYPOINTS = 2
ROW_RATE = 0.002


def _scene():
    """tests/test_oxford_protocol.py's scene."""
    rng = np.random.default_rng(3)
    img = rng.random((60, 80)).astype(np.float32)
    img = np.kron(img, np.ones((2, 2), np.float32))[:96, :128]
    for _ in range(2):
        img = (img + np.roll(img, 1, 0) + np.roll(img, 1, 1)) / 3
    return (img / img.max() * 255).astype(np.uint8)


def _assert_same_sequence(got, want):
    assert len(got) == len(want) == 5
    for (im, A, t), (jim, jA, jt) in zip(got, want):
        assert im.dtype == jim.dtype == np.uint8
        np.testing.assert_array_equal(im, jim)
        np.testing.assert_array_equal(A, jA)
        np.testing.assert_array_equal(t, jt)


@pytest.mark.parametrize("family", ["blur", "light", "zoomrot",
                                    "viewpoint"])
def test_make_sequence_matches_jax(family):
    img = _scene()
    _assert_same_sequence(tox.make_sequence(img, family),
                          jox.make_sequence(img, family))


def test_make_sequence_matches_jax_on_hopper():
    img = tox.load_scene("hopper")
    assert img.shape == (480, 640)
    _assert_same_sequence(tox.make_sequence(img, "zoomrot"),
                          jox.make_sequence(img, "zoomrot"))


def test_jpeg_sequence_matches_jax_on_average():
    pytest.importorskip("PIL")
    img = tox.load_scene(tox.JPEG_SCENE)
    _assert_same_sequence(tox.make_sequence(img, "jpeg"),
                          jox.make_sequence(img, "jpeg"))


@pytest.mark.parametrize("quality", tox.JPEG_QUALITIES)
def test_checked_in_jpeg_images_equal_the_pil_round_trip(quality):
    pytest.importorskip("PIL")
    img = tox.load_scene(tox.JPEG_SCENE)
    path = tox.JPEG_DIR / f"{tox.JPEG_SCENE}-q{quality}.pgm"
    h, w = img.shape
    data = path.read_bytes()
    header = f"P5\n{w} {h}\n255\n".encode()
    assert data[:len(header)] == header
    assert data[len(header):] == jox.jpeg_roundtrip(img, quality).tobytes()


def test_jpeg_family_has_images_only_for_its_scene():
    with pytest.raises(ValueError, match="average"):
        tox.make_sequence(_scene(), "jpeg")


def test_scenes_and_families_are_the_tools():
    assert tox.FAMILIES == jox.FAMILIES
    for name in tox.FAMILIES:
        np.testing.assert_array_equal(tox.load_scene(name),
                                      jox.load_scene(name))
    for mode in tox.MODES:
        assert (tox.protocol_config(mode).sift_mode.value
                == jox.protocol_config(mode).sift_mode.value)
    np.testing.assert_array_equal(tox.gaussian_blur(_scene(), 1.3),
                                  jox.gaussian_blur(_scene(), 1.3))


@pytest.fixture(scope="module")
def hopper_pair():
    """Hopper's images 1 and 2 (zoom+rotation), PopSift mode, through the
    port's pipeline on the CPU."""
    img1 = tox.load_scene("hopper")
    img2, A, t = tox.make_sequence(img1, "zoomrot")[0]
    h, w = img1.shape
    with pt.PopSift(tox.protocol_config("popsift"), device="cpu") as ps:
        jobs = [ps.enqueue(w, h, im) for im in (img1, img2)]
        feats = [j.get() for j in jobs]
    return feats, A, t, img2.shape


def test_hopper_pair_reproduces_the_record(hopper_pair):
    (fa, fb), A, t, shape = hopper_pair
    r = trep.evaluate_pair(fa, fb, A, t, shape)
    l2 = tox.desc_l2_stats(fa, fb, A, t)
    rec = next(row for row in json.loads(RECORD.read_text())
               ["results"]["popsift"]["rows"]
               if row["scene"] == "hopper" and row["pair"] == "1-2")
    print(f"port: rep {r.repeatability:.4f} match {r.matching_score:.4f} "
          f"L2 {l2:.4f} {r.n_ref}/{r.n_warped}; record: {rec}")
    assert abs(r.n_ref - rec["n_ref"]) <= ROW_KEYPOINTS
    assert abs(r.n_warped - rec["n_warped"]) <= ROW_KEYPOINTS
    assert abs(r.repeatability - rec["repeatability"]) <= ROW_RATE
    assert abs(r.matching_score - rec["matching_score"]) <= ROW_RATE
    assert abs(l2 - rec["desc_l2"]) <= ROW_RATE


def test_desc_l2_stats_matches_jax(hopper_pair):
    (fa, fb), A, t, _ = hopper_pair
    got = tox.desc_l2_stats(fa, fb, A, t)
    want = jox.desc_l2_stats(fa, fb, A, t)
    assert got == pytest.approx(want, abs=1e-6)
    assert 0.0 < got < 0.5
    # a pair without a common keypoint has no statistic, on both sides
    far = np.array([1e4, 1e4])
    assert np.isnan(tox.desc_l2_stats(fa, fb, A, t + far))
    assert np.isnan(jox.desc_l2_stats(fa, fb, A, t + far))


def test_crop_rows_match_jax():
    """The crop's pairs 1-2 and 1-3 under zoom+rotation: each row through
    the port (extract_features on the CPU, the port's evaluate_pair) and
    through the JAX package (get_extractor, its evaluate_pair) within
    ROW_KEYPOINTS and ROW_RATE."""
    img1 = hopper_crop()
    seq = tox.make_sequence(img1, "zoomrot")[:2]
    cfg = tox.protocol_config("popsift")
    port = [port_features(im, cfg) for im in [img1] + [s[0] for s in seq]]
    jax = [jax_features(im, cfg) for im in [img1] + [s[0] for s in seq]]
    for k, (im, A, t) in enumerate(seq, start=1):
        r = trep.evaluate_pair(port[0], port[k], A, t, im.shape)
        j = jrep.evaluate_pair(jax[0], jax[k], A, t, im.shape)
        print(f"1-{k + 1}: port {r}; jax {j}")
        assert r.n_ref > 20 and r.n_matches > 10
        assert abs(r.n_ref - j.n_ref) <= ROW_KEYPOINTS
        assert abs(r.n_warped - j.n_warped) <= ROW_KEYPOINTS
        assert abs(r.repeatability - j.repeatability) <= ROW_RATE
        assert abs(r.matching_score - j.matching_score) <= ROW_RATE
        l2 = tox.desc_l2_stats(port[0], port[k], A, t)
        jl2 = jox.desc_l2_stats(jax[0], jax[k], A, t)
        assert abs(l2 - jl2) <= ROW_RATE
