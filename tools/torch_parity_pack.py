"""Build a parity pack through popsift_torch: the reference script's
output tree of each image (popsift_torch/eval/parity.py), bundled with a
manifest for an offline diff against a run of the reference binary
(`popsift-demo --log --gauss-mode vlfeat --desc-mode loop --popsift-mode
--root-sift --downsampling -1` on the same images, then
tools/torch_oxford_parity.py).  The counterpart of tools/parity_pack.py,
with its flags, plus --device.

    <pack>/<name>/output-<name>/
        dir-octave/pyramid-o-O-l-L.pgm
        dir-dog/d-pyramid-o-O-l-L.pgm
        features.txt     (sort -n, LC_ALL=C)
        keypoints.txt    (sort -n of dir-fpt/desc-pyramid.txt)
        descriptors.txt  (sort -n of dir-desc/desc-pyramid.txt)

Usage:
    python tools/torch_parity_pack.py --images <dir-or-pgm...> --out pack.tgz
    python tools/torch_parity_pack.py --synthetic 2 --out pack.tgz
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from popsift_torch.eval import no_device_reason  # noqa: E402
from popsift_torch.eval import parity  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--images", nargs="*", default=[],
                    help="PGM files or directories of PGMs")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="pack N synthetic scenes instead (no dataset)")
    ap.add_argument("--out", default="parity-pack.tgz")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), cuda:N or cpu")
    args = ap.parse_args(argv)
    why = no_device_reason(args.device)
    if why:
        ap.error(why)

    images = parity.collect_images(args.images)
    for i in range(args.synthetic):
        images.append((f"synthetic{i}", parity.synthetic_scene(100 + i)))
    if not images:
        ap.error("no images: pass --images or --synthetic N")
    parity.build_pack(images, args.out, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
