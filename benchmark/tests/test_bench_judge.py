"""The comparison that decides ``correct`` (benchmark/lib/judge.py)."""

import math

import numpy as np
import pytest

from benchmark.lib import judge


def _features(n=6, seed=0, dup=False):
    rng = np.random.default_rng(seed)
    num = np.array([1, 2, 1, 1, 3, 1][:n])
    rows = int(num.sum())
    start = np.cumsum(num) - num
    kk = np.arange(4)[None, :]
    f = dict(xpos=rng.random(n) * 100, ypos=rng.random(n) * 100,
             sigma=1 + rng.random(n), num_ori=num,
             orientation=np.where(kk < num[:, None], rng.random((n, 4)), 0),
             octave=np.zeros(n, np.int64),
             desc_idx=np.where(kk < num[:, None], start[:, None] + kk, -1),
             descriptors=rng.random((rows, 128)).astype(np.float32))
    if dup:                      # two features on one spot
        for k in ("xpos", "ypos", "sigma"):
            f[k][1] = f[k][0]
    return f


def _copy(f):
    return {k: np.array(v, copy=True) for k, v in f.items()}


@pytest.mark.parametrize("dup", [False, True])
def test_equal_sets_read_zero(dup):
    f = _features(dup=dup)
    assert judge.compare_features(_copy(f), f) == dict(
        miss_share=0, pos_gap=0, angle_gap=0, desc_gap=0)


def test_faults_read_over_zero():
    f = _features()
    g = _copy(f)
    g["xpos"][2] += 0.05 * g["sigma"][2]
    assert judge.compare_features(g, f)["pos_gap"] == pytest.approx(0.05)
    g = _copy(f)
    g["descriptors"][3, 7] += 0.01
    assert judge.compare_features(g, f)["desc_gap"] == pytest.approx(
        0.01, rel=1e-5)
    g = _copy(f)
    g["orientation"][4, 1] += 0.2
    assert judge.compare_features(g, f)["angle_gap"] == pytest.approx(0.2)
    g = _copy(f)
    g["xpos"][0] += 5.0
    assert judge.compare_features(g, f)["miss_share"] == pytest.approx(2 / 12)
    g = _copy(f)
    g["num_ori"][1] = 1
    assert judge.compare_features(g, f)["miss_share"] == pytest.approx(2 / 12)


def test_orientation_order_does_not_matter():
    f = _features()
    g = _copy(f)
    r0, r1 = g["desc_idx"][1, :2]
    g["descriptors"][[r0, r1]] = g["descriptors"][[r1, r0]]
    g["orientation"][1, [0, 1]] = g["orientation"][1, [1, 0]]
    assert judge.compare_features(g, f)["desc_gap"] == 0
    assert judge.compare_features(g, f)["angle_gap"] == 0


def _match(left, right, dtype=np.float64):
    l, r = left.astype(dtype), right.astype(dtype)
    d = (l * l).sum(1)[:, None] + (r * r).sum(1)[None, :] - 2 * l @ r.T
    d = np.maximum(d, 0)
    best = d.argmin(1)
    m = d.copy()
    m[np.arange(len(d)), best] = np.inf
    second = m.argmin(1)
    d1, d2 = d[np.arange(len(d)), best], m[np.arange(len(d)), second]
    return (best.astype(np.int32), second.astype(np.int32), d1 / d2 < 0.8,
            d1.astype(np.float32), d2.astype(np.float32)), d


def test_matches():
    rng = np.random.default_rng(1)
    left = rng.random((40, 128)).astype(np.float32)
    right = np.concatenate([left[:20] + 0.01, rng.random((30, 128))]) \
        .astype(np.float32)
    prog, d64 = _match(left, right, np.float32)
    _, d64 = _match(left, right)
    ok = judge.compare_matches(left, right, prog, d64, 0.8)
    assert ok["accept_miss"] == 0 and ok["dist_gap"] < 1e-4
    best, second, accept, d1, d2 = (np.array(a, copy=True) for a in prog)
    best[3] = (best[3] + 1) % 50
    assert judge.compare_matches(left, right, (best, second, accept, d1,
                                               d2), d64, 0.8)[
        "dist_gap"] > 1e-2
    accept = ~prog[2]
    assert judge.compare_matches(left, right, (prog[0], prog[1], accept,
                                               prog[3], prog[4]), d64, 0.8)[
        "accept_miss"] > 0


def test_verdict():
    ok, checks = judge.verdict({"a": 0.1, "b": 2}, {"a": 0.2, "b": 1,
                                                    "c": 0})
    assert not ok and checks["c"]["value"] == math.inf
    assert judge.verdict({"a": 0.1}, {"a": 0.1})[0]
