"""The reference script's output tree, its tolerance comparison and the
parity pack, a port of tools/oxford_parity.py and tools/parity_pack.py
that runs popsift_torch.

testOxfordDataset.sh.in runs ``popsift-demo --log --gauss-mode vlfeat
--desc-mode loop --popsift-mode --root-sift --downsampling -1`` on every
image of the Oxford affine dataset and arranges its output as

    output-<img>/dir-octave/pyramid-o-O-l-L.pgm
    output-<img>/dir-dog/d-pyramid-o-O-l-L.pgm
    output-<img>/features.txt     (sort -n, LC_ALL=C)
    output-<img>/keypoints.txt    (sort -n of dir-fpt/desc-pyramid.txt)
    output-<img>/descriptors.txt  (sort -n of dir-desc/desc-pyramid.txt)

:func:`produce_output_tree` makes that tree; :func:`compare_tree` holds one
tree to another with float tolerances instead of the script's byte-exact
``cmp``:

* pyramid / DoG PGMs: worst mean |diff| <= ``tol_img_mean`` grey levels
  and <= ``tol_img_frac`` of the pixels off by more than 2 levels;
* keypoints: >= ``min_rep`` of the reference keypoints have a counterpart
  within ``kp_eps`` px and 20% relative sigma;
* descriptors: median L2 between matched unit-norm descriptors <=
  ``tol_l2``.

:func:`build_pack` bundles such trees, with a manifest, for a diff against
a run of the reference binary.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tarfile
import tempfile

import numpy as np

from ..config import (Config, DescMode, GaussMode, LogMode, NormMode,
                      SiftMode)
from ..debugdump import dump_all
from ..extract import extract_features
from ..io.pgm import read_pgm

SCENES = ["boat", "bikes", "trees", "graf", "wall", "bark", "leuven", "ubc"]
IMAGES = ["img1", "img2", "img3", "img4", "img5", "img6"]
# the comparison's default tolerances (tools/oxford_parity.py's flags)
TOL_IMG_MEAN = 1.0
TOL_IMG_FRAC = 0.02
KP_EPS = 1.5
MIN_REPEATABILITY = 0.99
TOL_DESC_L2 = 0.05
PACK_PROTOCOL = ("--log --gauss-mode vlfeat --desc-mode loop "
                 "--popsift-mode --root-sift --downsampling -1")


def reference_protocol_config() -> Config:
    """The exact flag set of testOxfordDataset.sh.in's popsift-demo call."""
    c = Config()
    c.set_gauss_mode(GaussMode.VLFEAT_COMPUTE)     # --gauss-mode vlfeat
    c.set_mode(SiftMode.POPSIFT)                   # --popsift-mode
    c.set_desc_mode(DescMode.LOOP)                 # --desc-mode loop
    c.set_norm_mode(NormMode.ROOT_SIFT)            # --root-sift
    c.set_downsampling(-1.0)                       # --downsampling -1
    c.set_log_mode(LogMode.ALL)                    # --log
    # reference parity: exact f32 descriptor download
    c.set_desc_transfer("f32")
    return c


def sort_into(src: str, dst: str) -> None:
    """``sort -n`` as the script runs it (testOxfordDataset.sh.in:67-71):
    GNU sort's numeric-prefix order with the byte-wise last-resort tie
    break, under LC_ALL=C; without coreutils, an approximation in
    Python."""
    env = dict(os.environ, LC_ALL="C")
    try:
        with open(dst, "w") as f:
            subprocess.run(["sort", "-n", src], stdout=f, env=env,
                           check=True)
        return
    except (OSError, subprocess.CalledProcessError):
        pass
    with open(src) as f:
        lines = f.readlines()
    lines.sort(key=lambda ln: (float(ln.split()[0] or 0), ln))
    with open(dst, "w") as f:
        f.writelines(lines)


def produce_output_tree(image: np.ndarray, out_dir: str,
                        device="cuda") -> None:
    """Extract ``image`` on ``device`` with the dump and arrange the
    reference script's layout (the mv/sort block of
    testOxfordDataset.sh.in) in ``out_dir``."""
    if os.path.isdir(out_dir):
        shutil.rmtree(out_dir)
    os.makedirs(out_dir)
    config = reference_protocol_config()
    dump_all(config, image, "pyramid", base_dir=out_dir, device=device)

    sort_into(os.path.join(out_dir, "dir-fpt", "desc-pyramid.txt"),
              os.path.join(out_dir, "keypoints.txt"))
    sort_into(os.path.join(out_dir, "dir-desc", "desc-pyramid.txt"),
              os.path.join(out_dir, "descriptors.txt"))
    # features.txt in the script is the sorted output-features.txt, whose
    # rows have keypoints.txt's "x y 1/s^2 0 1/s^2 d0..d127" format in the
    # final image coordinates (features.print()); the dir-fpt file carries
    # the --log path's second scaling, so the rows are printed again here
    feats = extract_features(image, config, device)
    raw = os.path.join(out_dir, "output-features.txt")
    with open(raw, "w") as f:
        feats.print(f, write_as_uchar=False)
    sort_into(raw, os.path.join(out_dir, "features.txt"))
    os.remove(raw)

    # trim to the compared layout
    for d in ("dir-octave-dump", "dir-dog-txt", "dir-dog-dump",
              "dir-desc", "dir-fpt"):
        shutil.rmtree(os.path.join(out_dir, d), ignore_errors=True)


def compare_pgm_dir(ours: str, refs: str, tol_mean: float,
                    tol_frac: float) -> tuple[bool, str]:
    names = sorted(os.listdir(refs)) if os.path.isdir(refs) else []
    if not names:
        return True, "no reference images"
    worst_mean = worst_frac = 0.0
    n = 0
    for name in names:
        mine = os.path.join(ours, name)
        if not os.path.exists(mine):
            return False, f"missing {name}"
        a = read_pgm(mine).astype(np.int16)
        b = read_pgm(os.path.join(refs, name)).astype(np.int16)
        if a.shape != b.shape:
            return False, f"shape mismatch {name}: {a.shape} vs {b.shape}"
        d = np.abs(a - b)
        worst_mean = max(worst_mean, float(d.mean()))
        worst_frac = max(worst_frac, float((d > 2).mean()))
        n += 1
    ok = worst_mean <= tol_mean and worst_frac <= tol_frac
    return ok, (f"{n} levels, worst mean |d|={worst_mean:.3f}, "
                f"worst frac(|d|>2)={worst_frac:.4f}")


def load_rows(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Parse 'x y a b c d0..d127' rows -> (keypoints Nx3 [x,y,sigma],
    descriptors Nx128).  sigma is recovered from the 1/sigma^2 column."""
    kps, descs = [], []
    with open(path) as f:
        for ln in f:
            t = ln.split()
            if len(t) < 5:
                continue
            x, y = float(t[0]), float(t[1])
            inv_s2 = float(t[2])
            sig = 1.0 / math.sqrt(inv_s2) if inv_s2 > 0 else 0.0
            kps.append((x, y, sig))
            if len(t) >= 133:
                descs.append([float(v) for v in t[5:133]])
    return (np.asarray(kps, np.float64).reshape(-1, 3),
            np.asarray(descs, np.float64).reshape(-1, 128))


def compare_features(ours: str, refs: str, kp_eps: float,
                     min_rep: float, tol_l2: float) -> tuple[bool, str]:
    if not os.path.exists(refs):
        return True, "no reference features"
    ka, da = load_rows(ours)
    kb, db = load_rows(refs)
    if len(kb) == 0:
        return len(ka) == 0, f"ref empty, ours {len(ka)}"
    # nearest-neighbour by position + relative sigma
    matched = 0
    l2s = []
    for i in range(len(kb)):
        d = np.hypot(ka[:, 0] - kb[i, 0], ka[:, 1] - kb[i, 1]) \
            if len(ka) else np.array([np.inf])
        j = int(np.argmin(d))
        if d[j] < kp_eps and (kb[i, 2] <= 0 or ka[j, 2] <= 0
                              or 0.8 < ka[j, 2] / kb[i, 2] < 1.25):
            matched += 1
            if len(da) and len(db):
                na = da[j] / max(np.linalg.norm(da[j]), 1e-12)
                nb = db[i] / max(np.linalg.norm(db[i]), 1e-12)
                l2s.append(float(np.linalg.norm(na - nb)))
    rep = matched / len(kb)
    med_l2 = float(np.median(l2s)) if l2s else 0.0
    ok = rep >= min_rep and med_l2 <= tol_l2
    return ok, (f"repeatability {rep * 100:.2f}% ({matched}/{len(kb)}), "
                f"median desc L2 {med_l2:.4f}")


def compare_tree(ours: str, refs: str, tol_img_mean: float = TOL_IMG_MEAN,
                 tol_img_frac: float = TOL_IMG_FRAC, kp_eps: float = KP_EPS,
                 min_rep: float = MIN_REPEATABILITY,
                 tol_l2: float = TOL_DESC_L2) -> tuple[bool, list[str]]:
    """One image's pass rule: its pyramid, its DoG and its features.txt
    each pass.  Returns (ok, [pyramid, dog, features messages])."""
    ok1, m1 = compare_pgm_dir(os.path.join(ours, "dir-octave"),
                              os.path.join(refs, "dir-octave"),
                              tol_img_mean, tol_img_frac)
    ok2, m2 = compare_pgm_dir(os.path.join(ours, "dir-dog"),
                              os.path.join(refs, "dir-dog"),
                              tol_img_mean, tol_img_frac)
    ok3, m3 = compare_features(os.path.join(ours, "features.txt"),
                               os.path.join(refs, "features.txt"),
                               kp_eps, min_rep, tol_l2)
    return ok1 and ok2 and ok3, [m1, m2, m3]


def synthetic_scene(seed: int, h: int = 480, w: int = 640) -> np.ndarray:
    """A textured 8-bit scene for a pack without data (parity_pack.py's
    ``_synthetic_scene``)."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), np.float32)
    for cell, amp in ((64, 1.0), (32, 0.5), (16, 0.25), (8, 0.12)):
        base = rng.random((h // cell + 2, w // cell + 2)).astype(np.float32)
        up = np.kron(base, np.ones((cell, cell), np.float32))[:h, :w]
        img += amp * up
    for _ in range(2):
        img = (img + np.roll(img, 1, 0) + np.roll(img, -1, 0)
               + np.roll(img, 1, 1) + np.roll(img, -1, 1)) / 5.0
    img = (img - img.min()) / (img.max() - img.min())
    return (img * 255).astype(np.uint8)


def collect_images(paths: list[str]) -> list[tuple[str, np.ndarray]]:
    """(name, image) of each PGM/PPM file, or of each in a directory."""
    out = []
    for p in paths:
        if os.path.isdir(p):
            for name in sorted(os.listdir(p)):
                if name.lower().endswith((".pgm", ".ppm")):
                    out.append((os.path.splitext(name)[0],
                                read_pgm(os.path.join(p, name))))
        else:
            out.append((os.path.splitext(os.path.basename(p))[0],
                        read_pgm(p)))
    return out


def build_pack(images: list[tuple[str, np.ndarray]], out_path: str,
               device="cuda") -> None:
    """Each image's output tree at ``<name>/output-<name>/`` and a
    MANIFEST.json, as ``parity-pack/`` in the gzipped tar ``out_path``."""
    with tempfile.TemporaryDirectory() as tmp:
        manifest = {
            "protocol": PACK_PROTOCOL,
            "reference_script": "testScripts/testOxfordDataset.sh.in",
            "compare_with": ("tools/torch_oxford_parity.py --reference "
                             "<this-pack>"),
            "images": {},
        }
        for name, img in images:
            tree = os.path.join(tmp, name, f"output-{name}")
            produce_output_tree(img, tree, device)
            manifest["images"][name] = {
                "h": int(img.shape[0]), "w": int(img.shape[1]),
            }
            print(f"# packed {name} ({img.shape[1]}x{img.shape[0]})",
                  file=sys.stderr)
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f, indent=2)
        with tarfile.open(out_path, "w:gz") as tf:
            tf.add(tmp, arcname="parity-pack")
    print(f"# wrote {out_path} "
          f"({os.path.getsize(out_path) / 1e6:.1f} MB)", file=sys.stderr)
