"""The comparison that decides ``correct``.

Features are compared as a user would compare two feature sets of one
image.  A program feature and a reference feature may pair when their
positions and sigmas lie within PAIR_TOL of each other in units of the
reference feature's sigma, in the same octave where both sides report
one; pairs are taken one to one, the closest first.  The numbers, per image:

* ``miss_share``: the share of both sides' features that find no pair,
  a pair whose orientation count differs counting twice;
* ``pos_gap``: the widest gap in x, y or sigma between paired features,
  in units of the reference feature's sigma;
* ``angle_gap``: the widest gap in radians between the orientations of
  paired features (each paired by its descriptor row);
* ``desc_gap``: the widest gap of one descriptor element between paired
  descriptor rows (each row of a feature paired with the nearest row of
  its partner).

Matches (MatchingMode's ``FeaturesDev.match``) are judged on the
program's own descriptors against float64 distances:

* ``dist_gap``: the widest gap between the distance the program reports
  for a row's best or second match and the float64 distance of that
  pair, and between the float64 distance of the pair it chose and the
  float64 best (second best);
* ``accept_miss``: rows whose ratio-test verdict differs from the
  float64 verdict, leaving out rows whose float64 ratio lies within
  RATIO_TIE of the threshold.

Each run's number is the largest over its sampled requests.
"""

from __future__ import annotations

import math

import numpy as np

PAIR_TOL = 0.1
RATIO_TIE = 1e-4


def host_features(feats) -> dict:
    """The arrays of a FeaturesHost."""
    soa = feats.soa()
    return dict(xpos=np.asarray(soa["xpos"], np.float64),
                ypos=np.asarray(soa["ypos"], np.float64),
                sigma=np.asarray(soa["sigma"], np.float64),
                num_ori=np.asarray(soa["num_ori"], np.int64),
                orientation=np.asarray(soa["orientation"], np.float64),
                octave=np.asarray(soa["debug_octave"], np.int64),
                desc_idx=np.asarray(soa["desc_idx"], np.int64),
                descriptors=np.asarray(feats.get_descriptors(), np.float32))


def device_features(feats) -> dict:
    """The arrays of a FeaturesDev, its descriptors copied to the host;
    its descriptor rows are in feature order, ``num_ori`` rows each."""
    f = feats.get_features()
    num = np.asarray(f["num_ori"], np.int64)
    start = np.cumsum(num) - num
    kk = np.arange(4)[None, :]
    return dict(xpos=np.asarray(f["xpos"], np.float64),
                ypos=np.asarray(f["ypos"], np.float64),
                sigma=np.asarray(f["sigma"], np.float64), num_ori=num,
                desc_idx=np.where(kk < num[:, None], start[:, None] + kk,
                                  -1),
                descriptors=feats.get_descriptors().float().cpu().numpy())


def reference_features(ref: dict) -> dict:
    """The reference's arrays (benchmark/reference/sift.py:extract)."""
    out = {k: np.asarray(ref[k], np.float64)
           for k in ("xpos", "ypos", "sigma", "orientation")}
    out.update(num_ori=np.asarray(ref["num_ori"], np.int64),
               octave=np.asarray(ref["debug_octave"], np.int64),
               desc_idx=np.asarray(ref["desc_idx"], np.int64),
               descriptors=np.asarray(ref["descriptors"], np.float32))
    return out


def _candidates(a: dict, b: dict):
    """(i, j, d) for every feature i of ``a`` and j of ``b`` within
    PAIR_TOL of each other: the largest gap in x, y or sigma in units of
    b's sigma, same octave where both sides report one."""
    out = []
    if a["xpos"].shape[0] == 0 or b["xpos"].shape[0] == 0:
        return out
    for s in range(0, a["xpos"].shape[0], 512):
        e = slice(s, s + 512)
        d = np.maximum(np.abs(a["xpos"][e, None] - b["xpos"][None, :]),
                       np.abs(a["ypos"][e, None] - b["ypos"][None, :]))
        d = np.maximum(d, np.abs(a["sigma"][e, None] - b["sigma"][None, :]))
        d = d / b["sigma"][None, :]
        if "octave" in a and "octave" in b:
            d = np.where(a["octave"][e, None] == b["octave"][None, :], d,
                         np.inf)
        ii, jj = np.nonzero(d <= PAIR_TOL)
        out.extend(zip((ii + s).tolist(), jj.tolist(), d[ii, jj].tolist()))
    return out


def _pairs(a: dict, b: dict) -> list:
    """One-to-one pairs (i, j, d), the closest first: features that the
    refinement put on one spot on both sides pair one by one."""
    used_a, used_b, pairs = set(), set(), []
    for i, j, d in sorted(_candidates(a, b), key=lambda c: c[2]):
        if i not in used_a and j not in used_b:
            used_a.add(i)
            used_b.add(j)
            pairs.append((i, j, d))
    return pairs


def _rows(f: dict, i: int) -> np.ndarray:
    return f["desc_idx"][i, :f["num_ori"][i]]


def compare_features(prog: dict, ref: dict) -> dict:
    """The numbers of one image (module docstring)."""
    n_p, n_r = prog["xpos"].shape[0], ref["xpos"].shape[0]
    if n_p + n_r == 0:
        return dict(miss_share=0.0, pos_gap=0.0, angle_gap=0.0,
                    desc_gap=0.0)
    paired = _pairs(prog, ref)
    misses = n_p + n_r - 2 * len(paired)
    pos_gap = angle_gap = desc_gap = 0.0
    both_ori = "orientation" in prog and "orientation" in ref
    for i, j, d in paired:
        pos_gap = max(pos_gap, d)
        if prog["num_ori"][i] != ref["num_ori"][j]:
            misses += 2
            continue
        rp, rr = _rows(prog, i), _rows(ref, j)
        if (rp >= prog["descriptors"].shape[0]).any() or (rp < 0).any():
            return dict(miss_share=1.0, pos_gap=math.inf,
                        angle_gap=math.inf, desc_gap=math.inf)
        dp = prog["descriptors"][rp].astype(np.float64)
        dr = ref["descriptors"][rr].astype(np.float64)
        gaps = np.abs(dp[:, None, :] - dr[None, :, :]).max(axis=2)
        for k in range(len(rp)):
            m = int(np.argmin(gaps[k]))
            desc_gap = max(desc_gap, float(gaps[k, m]))
            if both_ori:
                da = abs(prog["orientation"][i, k] - ref["orientation"][j, m])
                angle_gap = max(angle_gap, min(da, 2 * math.pi - da))
    return dict(miss_share=misses / (n_p + n_r), pos_gap=pos_gap,
                angle_gap=angle_gap, desc_gap=desc_gap)


def compare_matches(left: np.ndarray, right: np.ndarray, prog, d64,
                    ratio: float) -> dict:
    """The match numbers of one pair: ``prog`` is the program's (best,
    second, accept, best_dist, second_dist), ``d64`` the (N, M) float64
    distances of the program's descriptors ``left`` and ``right``."""
    best, second, accept, d1, d2 = (np.asarray(a) for a in prog)
    n = left.shape[0]
    if best.shape[0] != n or n == 0:
        return dict(dist_gap=0.0 if best.shape[0] == n else math.inf,
                    accept_miss=0 if best.shape[0] == n else n)
    rows = np.arange(n)
    best = best.astype(np.int64)
    second = second.astype(np.int64)
    m = right.shape[0]
    if ((best < 0) | (best >= m) | (second < 0) | (second >= m)).any() \
            or (m > 1 and (best == second).any()):
        return dict(dist_gap=math.inf, accept_miss=n)
    srt = np.sort(d64, axis=1)
    ref1 = srt[:, 0]
    ref2 = srt[:, 1] if m > 1 else np.full(n, np.inf)
    db = d64[rows, best]
    ds = d64[rows, second] if m > 1 else np.full(n, np.inf)
    fin = np.isfinite(ref2)
    gap = np.concatenate([
        np.abs(d1.astype(np.float64) - db), db - ref1,
        np.abs(d2.astype(np.float64)[fin] - ds[fin]), ds[fin] - ref2[fin]])
    with np.errstate(divide="ignore", invalid="ignore"):
        r = ref1 / ref2
    verdict = r < ratio
    tie = np.abs(r - ratio) < RATIO_TIE
    return dict(dist_gap=float(np.max(np.abs(gap))) if gap.size else 0.0,
                accept_miss=int(((accept != verdict) & ~tie).sum()))


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the cell's numbers; a
    number the run could not read counts as over its limit."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        v = numbers.get(name, math.inf)
        checks[name] = {"value": v, "limit": limit}
        ok = ok and v <= limit
    return ok, checks
