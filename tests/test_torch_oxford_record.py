"""Where PARITY_r05.json is not what the JAX package computes on the CPU.

PARITY_r05.json, tools/oxford_protocol.py's record, was taken on a TPU.
Its rows agree with the port on the CPU within a few keypoints except for
one scene: china_l, whose first image has 74 keypoints fewer inside the
image in the record's PopSift pairs than the port finds (68 in OpenCV
mode, 74 in VLFeat mode).  This test is the witness that the record, not
the port, is the outlier there: on the CPU the JAX package's
``get_extractor`` gives china_l's pair 1-2 the port's row, keypoint for
keypoint, and both are 74 keypoints off the record's ``n_ref``.
chip_smoke.py therefore holds the card's china_l rows to the port's rows
on the CPU (OXFORD_RECORD_DIVERGES) and every other row to the record.
"""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

from popsift_tpu.eval import repeatability as jrep  # noqa: E402

from popsift_torch.eval import oxford as tox  # noqa: E402
from popsift_torch.eval import repeatability as trep  # noqa: E402

from torch_parity import jax_features, port_features  # noqa: E402

RECORD = Path(__file__).resolve().parent.parent / "PARITY_r05.json"
# keypoints inside china_l's first image that the record lacks
RECORD_SHORT = 74


def test_china_l_pair_is_the_jax_packages_not_the_records():
    img1 = tox.load_scene("china_l")
    img2, A, t = tox.make_sequence(img1, "zoomrot")[0]
    cfg = tox.protocol_config("popsift")
    port = [port_features(np.array(im), cfg) for im in (img1, img2)]
    jax = [jax_features(np.array(im), cfg) for im in (img1, img2)]
    assert port[0].get_feature_count() == jax[0].get_feature_count()
    np.testing.assert_array_equal(
        np.bincount(port[0].soa()["debug_octave"]),
        np.bincount(np.asarray(jax[0]._soa["debug_octave"])))
    r = trep.evaluate_pair(port[0], port[1], A, t, img2.shape)
    j = jrep.evaluate_pair(jax[0], jax[1], A, t, img2.shape)
    rec = next(row for row in json.loads(RECORD.read_text())
               ["results"]["popsift"]["rows"]
               if row["scene"] == "china_l" and row["pair"] == "1-2")
    print(f"port {r}; jax {j}; record {rec}")
    assert r.n_ref == j.n_ref == rec["n_ref"] + RECORD_SHORT
    assert abs(r.n_warped - j.n_warped) <= 2
    assert abs(r.repeatability - j.repeatability) <= 0.002
    assert abs(r.matching_score - j.matching_score) <= 0.002
