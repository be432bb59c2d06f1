"""The Oxford-shaped accuracy protocol on the repository's photographs, a
port of tools/oxford_protocol.py that runs popsift_torch.

The reference's accuracy harness runs 8 scenes x 6 images of the Oxford
affine dataset (testScripts/testOxfordDataset.sh.in).  This protocol has
the same shape on the checked-in photographs (tests/data/scenes/*.pgm,
640x480): each scene's img2..img6 apply one Oxford transformation family
at rising magnitude with a known affine (A, t) --

  zoom+rotation (bark/boat), gaussian blur (bikes/trees), viewpoint
  affine (graf/wall), decreasing light (leuven), jpeg compression (ubc)

-- and per SiftMode it measures what the Oxford evaluation measures:
keypoint repeatability, the matching score (Lowe-ratio matches that are
geometrically correct) and the median descriptor L2 between geometrically
matched keypoints.  The pass bar is the JAX tool's: mean img1-2
repeatability >= 0.60 and mean matching score >= 0.45.

The JPEG family needs an encoder, and this package imports no imaging
library: its five images exist only for the ``average`` scene, checked in
under tests/data/scenes/jpeg/ (made once by tools/oxford_protocol.py's
``jpeg_roundtrip`` at qualities 75/50/30/18/10).
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from ..config import Config, SiftMode
from ..io.pgm import read_pgm
from ..pipeline import PopSift
from .repeatability import evaluate_pair, warp_affine

SCENE_DIR = Path(__file__).resolve().parents[2] / "tests" / "data" / "scenes"
JPEG_DIR = SCENE_DIR / "jpeg"
JPEG_SCENE = "average"
JPEG_QUALITIES = (75, 50, 30, 18, 10)

# scene -> Oxford transformation family (8 scenes, one per Oxford scene
# slot; the family decides how img2..img6 are derived from img1)
FAMILIES = {
    "hopper": "zoomrot",      # ~bark
    "china": "blur",          # ~bikes
    "china_l": "zoomrot",     # ~boat
    "flower": "viewpoint",    # ~graf
    "flower_r": "light",      # ~leuven
    "camera": "blur",         # ~trees
    "average": "jpeg",        # ~ubc
    "street": "viewpoint",    # ~wall
}
MODES = ("popsift", "vlfeat", "opencv")
PROTOCOL = ("8 scenes x 6 images, Oxford transformation families on real "
            "photographs")
# the pass bar on the img1-2 pairs' means
PASS_REPEATABILITY_12 = 0.60
PASS_MATCHING_SCORE_12 = 0.45


def load_scene(name: str) -> np.ndarray:
    return np.asarray(read_pgm(str(SCENE_DIR / f"{name}.pgm")), np.uint8)


def gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    span = max(int(math.ceil(3 * sigma)), 1)
    xs = np.arange(-span, span + 1, dtype=np.float64)
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    k /= k.sum()
    f = img.astype(np.float64)
    f = np.apply_along_axis(
        lambda r: np.convolve(np.pad(r, span, mode="edge"), k,
                              mode="valid"), 1, f)
    f = np.apply_along_axis(
        lambda c: np.convolve(np.pad(c, span, mode="edge"), k,
                              mode="valid"), 0, f)
    return np.clip(np.round(f), 0, 255).astype(np.uint8)


def jpeg_images(img: np.ndarray) -> list[np.ndarray]:
    """The JPEG round trips of ``img`` at JPEG_QUALITIES, read from the
    checked-in PGMs; ``img`` must be the JPEG_SCENE they were made from."""
    if not np.array_equal(img, load_scene(JPEG_SCENE)):
        raise ValueError(f"the jpeg family has images only for the "
                         f"{JPEG_SCENE!r} scene ({JPEG_DIR})")
    return [read_pgm(str(JPEG_DIR / f"{JPEG_SCENE}-q{q}.pgm"))
            for q in JPEG_QUALITIES]


def make_sequence(img: np.ndarray, family: str):
    """img2..img6 of a scene + their ground-truth affine (A, t) mapping
    img1 coordinates -> imgN coordinates (identity for the photometric
    families, as the Oxford H matrices are for blur/jpeg/light scenes)."""
    h, w = img.shape
    eye = np.eye(2)
    z2 = np.zeros(2)
    jpegs = jpeg_images(img) if family == "jpeg" else None
    out = []
    for k in range(1, 6):
        if family == "blur":
            out.append((gaussian_blur(img, 0.8 * k), eye, z2))
        elif family == "jpeg":
            out.append((jpegs[k - 1], eye, z2))
        elif family == "light":
            f = 1.0 - 0.15 * k
            out.append((np.clip(np.round(img * f), 0, 255)
                        .astype(np.uint8), eye, z2))
        elif family == "zoomrot":
            ang = math.radians(6.0 * k)
            s = 1.0 / (1.0 + 0.08 * k)
            A = s * np.array([[math.cos(ang), -math.sin(ang)],
                              [math.sin(ang), math.cos(ang)]])
            c = np.array([w / 2.0, h / 2.0])
            t = c - A @ c
            out.append((warp_affine(img, A, t), A, t))
        elif family == "viewpoint":
            # increasing horizontal shear + mild anisotropic scale: the
            # affine core of a viewpoint change
            sh = 0.08 * k
            sx = 1.0 - 0.05 * k
            A = np.array([[sx, sh], [0.0, 1.0]])
            c = np.array([w / 2.0, h / 2.0])
            t = c - A @ c
            out.append((warp_affine(img, A, t), A, t))
        else:
            raise ValueError(family)
    return out


def protocol_config(mode: str) -> Config:
    c = Config()
    c.set_mode({"popsift": SiftMode.POPSIFT, "vlfeat": SiftMode.VLFEAT,
                "opencv": SiftMode.OPENCV}[mode])
    return c


def desc_l2_stats(feats_a, feats_b, A, t, eps=3.0):
    """Median L2 between descriptors of geometrically matched keypoint
    pairs (one descriptor per keypoint: its first orientation)."""
    sa, sb = feats_a._soa, feats_b._soa
    na_, nb_ = feats_a.get_feature_count(), feats_b.get_feature_count()
    pa = np.stack([np.asarray(sa["xpos"][:na_]),
                   np.asarray(sa["ypos"][:na_])], 1) @ A.T + t
    pb = np.stack([np.asarray(sb["xpos"][:nb_]),
                   np.asarray(sb["ypos"][:nb_])], 1)
    if len(pa) == 0 or len(pb) == 0:
        return float("nan")
    da_all = np.asarray(feats_a.get_descriptors())
    db_all = np.asarray(feats_b.get_descriptors())
    ia_num = np.asarray(sa["num_ori"][:na_])
    ib_num = np.asarray(sb["num_ori"][:nb_])
    ia_idx = np.asarray(sa["desc_idx"][:na_])
    ib_idx = np.asarray(sb["desc_idx"][:nb_])
    d2 = ((pa[:, None, :] - pb[None, :, :]) ** 2).sum(-1)
    j = np.argmin(d2, 1)
    okm = d2[np.arange(len(pa)), j] <= eps * eps
    l2s = []
    for i in np.where(okm & (ia_num > 0))[0]:
        jb = j[i]
        if ib_num[jb] <= 0:
            continue
        da = da_all[ia_idx[i][0]]
        db = db_all[ib_idx[jb][0]]
        n_a = np.linalg.norm(da)
        n_b = np.linalg.norm(db)
        if n_a > 0 and n_b > 0:
            l2s.append(float(np.linalg.norm(da / n_a - db / n_b)))
    return float(np.median(l2s)) if l2s else float("nan")


def scene_rows(ps, scene: str, log=print) -> list[dict]:
    """The five pairs 1-2 .. 1-6 of one scene through the PopSift ``ps``."""
    img1 = load_scene(scene)
    fam = FAMILIES[scene]
    seq = make_sequence(img1, fam)
    h, w = img1.shape
    jobs = [ps.enqueue(w, h, img1)]
    jobs += [ps.enqueue(w, h, im) for im, _, _ in seq]
    feats = [j.get() for j in jobs]
    rows = []
    for k, (imN, A, t) in enumerate(seq, start=2):
        r = evaluate_pair(feats[0], feats[k - 1], A, t, imN.shape)
        l2 = desc_l2_stats(feats[0], feats[k - 1], A, t)
        rows.append(dict(
            scene=scene, family=fam, pair=f"1-{k}",
            repeatability=round(r.repeatability, 4),
            matching_score=round(r.matching_score, 4),
            desc_l2=round(l2, 4) if l2 == l2 else None,
            n_ref=r.n_ref, n_warped=r.n_warped))
        if log is not None:
            log(f"{scene:9s} {fam:9s} 1-{k}: rep={r.repeatability:.3f} "
                f"match={r.matching_score:.3f} descL2={l2:.3f} "
                f"({r.n_ref}/{r.n_warped} kp)")
    return rows


def summarize(rows: list[dict]) -> dict:
    easy = [r for r in rows if r["pair"] == "1-2"]
    return dict(
        mean_repeatability_12=round(float(np.mean(
            [r["repeatability"] for r in easy])), 4),
        mean_matching_score_12=round(float(np.mean(
            [r["matching_score"] for r in easy])), 4),
        mean_repeatability_all=round(float(np.mean(
            [r["repeatability"] for r in rows])), 4),
        median_desc_l2=round(float(np.median(
            [r["desc_l2"] for r in rows if r["desc_l2"] is not None])), 4))


def passes(summary: dict) -> bool:
    return (summary["mean_repeatability_12"] >= PASS_REPEATABILITY_12
            and summary["mean_matching_score_12"] >= PASS_MATCHING_SCORE_12)


def run_protocol(modes=MODES, scenes=tuple(FAMILIES), device="cuda",
                 workers: int = 2, log=print) -> dict:
    """The protocol in each SiftMode of ``modes`` on ``scenes``, extracted
    by ``PopSift(protocol_config(mode), device=device, workers=workers)``.
    Returns tools/oxford_protocol.py's payload (ok, protocol, scenes,
    results[mode] = {summary, rows}) and the device's name.  ``log`` takes
    each row's and each summary's line (None: quiet)."""
    results = {}
    name = None
    for mode in modes:
        rows = []
        with PopSift(protocol_config(mode), device=device,
                     workers=workers) as ps:
            if name is None:
                dev = ps._device
                name = (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu")
            for scene in scenes:
                rows += scene_rows(
                    ps, scene, None if log is None
                    else (lambda s, m=mode: log(f"[{m}] {s}")))
        summary = summarize(rows)
        results[mode] = dict(summary=summary, rows=rows)
        if log is not None:
            log(f"[{mode}] summary: {summary}")
    return dict(ok=all(passes(r["summary"]) for r in results.values()),
                protocol=PROTOCOL, scenes={s: FAMILIES[s] for s in scenes},
                results=results, device=name)
