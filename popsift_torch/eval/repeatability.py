"""Keypoint repeatability / matching evaluation, a copy of
popsift_tpu/eval/repeatability.py that takes this package's FeaturesHost.

The reference's accuracy protocol compares pyramid/keypoint/descriptor
dumps byte-for-byte against stored goldens on the Oxford affine dataset
(testScripts/testOxfordDataset.sh.in).  Without network access to the
dataset, this module provides the same *methodology* on synthetic
homography pairs: warp an image with a known transform, extract from both,
and measure

* repeatability: fraction of keypoints (in the common region) whose
  projection has a counterpart within ``eps`` pixels and compatible scale,
* matching score: fraction of descriptor matches (Lowe ratio) that are
  geometrically correct under the known transform.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def warp_affine(img: np.ndarray, A: np.ndarray, t: np.ndarray,
                out_shape=None) -> np.ndarray:
    """Inverse-warp an image: out(p) = img(A_inv (p - t)) with bilinear
    sampling and edge clamping."""
    h, w = out_shape or img.shape
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    A_inv = np.linalg.inv(A)
    sx = A_inv[0, 0] * (xs - t[0]) + A_inv[0, 1] * (ys - t[1])
    sy = A_inv[1, 0] * (xs - t[0]) + A_inv[1, 1] * (ys - t[1])
    x0 = np.clip(np.floor(sx).astype(int), 0, img.shape[1] - 1)
    y0 = np.clip(np.floor(sy).astype(int), 0, img.shape[0] - 1)
    x1 = np.clip(x0 + 1, 0, img.shape[1] - 1)
    y1 = np.clip(y0 + 1, 0, img.shape[0] - 1)
    fx = np.clip(sx - np.floor(sx), 0, 1)
    fy = np.clip(sy - np.floor(sy), 0, 1)
    v = (img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x1] * fx * (1 - fy)
         + img[y1, x0] * (1 - fx) * fy + img[y1, x1] * fx * fy)
    return v.astype(img.dtype)


@dataclasses.dataclass
class RepeatabilityResult:
    repeatability: float
    n_ref: int
    n_warped: int
    n_repeated: int
    matching_score: float
    n_matches: int
    n_correct: int


def _project(pts: np.ndarray, A: np.ndarray, t: np.ndarray) -> np.ndarray:
    return pts @ A.T + t


def evaluate_pair(feats_a, feats_b, A: np.ndarray, t: np.ndarray,
                  shape_b: tuple[int, int], eps: float = 3.0,
                  scale_tol: float = 1.6) -> RepeatabilityResult:
    """Repeatability + matching score for an image pair related by
    p_b = A p_a + t.  ``feats_*`` are FeaturesHost objects."""
    pa = np.array([[f.xpos, f.ypos] for f in feats_a], np.float64) \
        .reshape(-1, 2)
    sa = np.array([f.sigma for f in feats_a], np.float64)
    pb = np.array([[f.xpos, f.ypos] for f in feats_b], np.float64) \
        .reshape(-1, 2)
    sb = np.array([f.sigma for f in feats_b], np.float64)

    h_b, w_b = shape_b
    proj = _project(pa, A, t)
    det_scale = np.sqrt(abs(np.linalg.det(A)))
    inside = ((proj[:, 0] >= 0) & (proj[:, 0] < w_b)
              & (proj[:, 1] >= 0) & (proj[:, 1] < h_b))

    n_rep = 0
    for i in np.nonzero(inside)[0]:
        if len(pb) == 0:
            break
        d = np.hypot(pb[:, 0] - proj[i, 0], pb[:, 1] - proj[i, 1])
        srel = sb / max(sa[i] * det_scale, 1e-9)
        cand = (d < eps) & (srel < scale_tol) & (srel > 1.0 / scale_tol)
        if cand.any():
            n_rep += 1
    n_inside = int(inside.sum())
    repeatability = n_rep / max(n_inside, 1)

    # descriptor matching score
    da = feats_a.get_descriptors()
    db = feats_b.get_descriptors()
    n_matches = n_correct = 0
    if len(da) and len(db):
        # map descriptors back to their keypoints
        ka = []
        for fi, f in enumerate(feats_a):
            for o in range(f.num_ori):
                ka.append(fi)
        kb = []
        for fi, f in enumerate(feats_b):
            for o in range(f.num_ori):
                kb.append(fi)
        ka = np.asarray(ka)
        kb = np.asarray(kb)

        d2 = (np.sum(da * da, 1)[:, None] + np.sum(db * db, 1)[None, :]
              - 2.0 * da @ db.T)
        best = np.argmin(d2, 1)
        part = np.partition(d2, 1, axis=1)
        accept = part[:, 0] < 0.64 * part[:, 1]  # ratio^2 = 0.8^2
        for i in np.nonzero(accept)[0]:
            ai = ka[i]
            bi = kb[best[i]]
            if not inside[ai]:
                continue
            n_matches += 1
            d = np.hypot(pb[bi, 0] - proj[ai, 0], pb[bi, 1] - proj[ai, 1])
            if d < eps:
                n_correct += 1
    matching_score = n_correct / max(n_matches, 1)

    return RepeatabilityResult(
        repeatability=repeatability, n_ref=n_inside, n_warped=len(pb),
        n_repeated=n_rep, matching_score=matching_score,
        n_matches=n_matches, n_correct=n_correct)
