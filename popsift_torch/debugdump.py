"""The ``--log`` debug dump tree (popsift_tpu/debugdump.py).

Reproduces the reference's golden-state dump layout
(Octave::download_and_save_array, sift_octave.cu:111-188, and
Pyramid::save_descriptors, sift_pyramid.cu:88-106): every pyramid level and
DoG level as PGM + raw float dumps under dir-octave/* and descriptors under
dir-desc/ + dir-fpt/, the fidelity harness of testOxfordDataset.sh.in.
"""

from __future__ import annotations

import math
import os

import numpy as np

from .config import Config
from .extract import extract_features
from .io.pgm import write_pgm

# the seven directories of the tree
DIRS = ("dir-octave", "dir-octave-dump", "dir-dog", "dir-dog-txt",
        "dir-dog-dump", "dir-desc", "dir-fpt")


def format_desc_row(x: float, y: float, sigma: float, ori_rad: float,
                    desc, with_orientation: bool) -> str:
    """One text row of Pyramid::writeDescriptor (sift_pyramid.cu:401-444),
    byte-compatible with the C++ ostream output: setprecision(5) default
    float format (= %.5g) throughout, trailing space before the newline.

    with_orientation=True is the dir-desc format (x y sigma dom_ori);
    False is the dir-fpt format (x y 1/s^2 0 1/s^2)."""
    if with_orientation:
        dom = ori_rad / (2.0 * math.pi) * 360.0
        if dom < 0:
            dom += 360.0
        head = f"{x:.5g} {y:.5g} {sigma:.5g} {dom:.5g} "
    else:
        sv = 1.0 / (sigma * sigma)
        head = f"{x:.5g} {y:.5g} {sv:.5g} 0 {sv:.5g} "
    return head + " ".join(f"{float(v):.5g}" for v in desc) + " \n"


def dump_all(config: Config, image, basename: str, base_dir: str = ".",
             device="cuda") -> None:
    """Dump pyramid/DoG images and descriptor text files for one image,
    an (H, W) array or tensor (a pipeline job's ``get_img()``), extracting
    it again on ``device`` with every octave's whole stack and DoG."""
    feats, stacks, dogs = extract_features(image, config, device,
                                           return_pyramid=True)
    oct_dir, octd_dir, dog_dir, dogt_dir, dogd_dir, desc_dir, fpt_dir = (
        os.path.join(base_dir, d) for d in DIRS)
    for d in (oct_dir, octd_dir, dog_dir, dogt_dir, dogd_dir):
        os.makedirs(d, exist_ok=True)

    # directory layout mirrors Octave::download_and_save_array
    # (sift_octave.cu:119-137): dir-octave (unscaled pgm),
    # dir-octave-dump (raw float), dir-dog (scaled pgm),
    # dir-dog-txt (offset-by-127 pgm-style), dir-dog-dump (raw float)
    for o, stack in enumerate(stacks):
        arr = stack.cpu().numpy()
        for lvl in range(arr.shape[0]):
            name = f"{basename}-o-{o}-l-{lvl}"
            write_pgm(os.path.join(oct_dir, name + ".pgm"),
                      np.clip(arr[lvl], 0, 255).astype(np.uint8))
            arr[lvl].astype(np.float32).tofile(
                os.path.join(octd_dir, name + ".dump"))
    for o, dog in enumerate(dogs):
        arr = dog.cpu().numpy()
        for lvl in range(arr.shape[0]):
            name = f"d-{basename}-o-{o}-l-{lvl}"
            lo, hi = float(arr[lvl].min()), float(arr[lvl].max())
            scale = 255.0 / (hi - lo) if hi > lo else 1.0
            write_pgm(os.path.join(dog_dir, name + ".pgm"),
                      ((arr[lvl] - lo) * scale).astype(np.uint8))
            write_pgm(os.path.join(dogt_dir, name + ".txt.pgm"),
                      np.clip(arr[lvl] + 127.0, 0, 255).astype(np.uint8))
            arr[lvl].astype(np.float32).tofile(
                os.path.join(dogd_dir, name + ".dump"))

    # descriptor text dumps (save_descriptors writes both orientations-
    # and shape-matrix-style headers, sift_pyramid.cu:401-444)
    up = config.get_upscale_factor()
    os.makedirs(desc_dir, exist_ok=True)
    os.makedirs(fpt_dir, exist_ok=True)

    def write(path: str, with_orientation: bool) -> None:
        with open(path, "w") as of:
            for f in feats:
                # writeDescriptor scales the (already prep_features-scaled)
                # coordinates again by 2^(octave-up), reproduced faithfully
                # (sift_pyramid.cu:407-412)
                s = 2.0 ** (f.debug_octave - up)
                for k in range(f.num_ori):
                    d = f._descriptors[int(f.desc_idx[k])]
                    of.write(format_desc_row(
                        f.xpos * s, f.ypos * s, f.sigma * s,
                        float(f.orientation[k]), d, with_orientation))

    write(os.path.join(desc_dir, f"desc-{basename}.txt"), True)
    write(os.path.join(fpt_dir, f"desc-{basename}.txt"), False)
