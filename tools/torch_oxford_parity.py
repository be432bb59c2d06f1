"""Oxford-dataset parity through popsift_torch against reference-produced
dumps (popsift_torch/eval/parity.py), the counterpart of
tools/oxford_parity.py with its flags and exit codes, plus --device.

For every scene/image of the dataset that has a reference output, it
extracts the image with the reference script's flags (--log --gauss-mode
vlfeat --desc-mode loop --popsift-mode --root-sift --downsampling -1),
writes the script's output tree under --out and compares it with the
reference tree at the tolerances below.  Exit status 0 iff every compared
image passes, 1 if one fails, 2 if nothing was compared.

Usage:
    python tools/torch_oxford_parity.py --dataset /path/to/oxford \
        --reference /path/to/reference-tree [--out DIR] \
        [--scenes boat bikes ...] [--images img1 img2 ...] \
        [--device cuda|cpu]

Both trees as the reference script lays them out:
    <reference>/<scene>/output-<img>/{dir-octave,dir-dog}/*.pgm
    <reference>/<scene>/output-<img>/{features,keypoints,descriptors}.txt
The dataset tree holds <scene>/imgN.pgm or imgN.ppm.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from popsift_torch.eval import no_device_reason  # noqa: E402
from popsift_torch.eval import parity  # noqa: E402
from popsift_torch.io.pgm import read_pgm  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", required=True,
                    help="Oxford dataset dir (scene/imgN.pgm|ppm)")
    ap.add_argument("--reference", required=True,
                    help="reference output tree (scene/output-imgN/...)")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "oxford-parity"))
    ap.add_argument("--scenes", nargs="*", default=parity.SCENES)
    ap.add_argument("--images", nargs="*", default=parity.IMAGES)
    ap.add_argument("--tol-img-mean", type=float, default=parity.TOL_IMG_MEAN)
    ap.add_argument("--tol-img-frac", type=float, default=parity.TOL_IMG_FRAC)
    ap.add_argument("--kp-eps", type=float, default=parity.KP_EPS)
    ap.add_argument("--min-repeatability", type=float,
                    default=parity.MIN_REPEATABILITY)
    ap.add_argument("--tol-desc-l2", type=float, default=parity.TOL_DESC_L2)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), cuda:N or cpu")
    args = ap.parse_args(argv)
    why = no_device_reason(args.device)
    if why:
        ap.error(why)

    rows = []
    for scene in args.scenes:
        for img in args.images:
            src = None
            for ext in (".pgm", ".ppm"):
                p = os.path.join(args.dataset, scene, img + ext)
                if os.path.exists(p):
                    src = p
                    break
            ref_dir = os.path.join(args.reference, scene, f"output-{img}")
            if src is None or not os.path.isdir(ref_dir):
                continue
            out_dir = os.path.join(args.out, scene, f"output-{img}")
            parity.produce_output_tree(read_pgm(src), out_dir, args.device)
            ok, (m1, m2, m3) = parity.compare_tree(
                out_dir, ref_dir, args.tol_img_mean, args.tol_img_frac,
                args.kp_eps, args.min_repeatability, args.tol_desc_l2)
            rows.append(ok)
            print(f"{scene}/{img}: {'OK ' if ok else 'BAD'} | "
                  f"pyramid: {m1} | dog: {m2} | features: {m3}")

    if not rows:
        print("No (dataset image, reference output) pairs found — "
              "nothing compared.", file=sys.stderr)
        return 2
    print(f"\n{sum(rows)}/{len(rows)} images pass parity.")
    return 0 if all(rows) else 1


if __name__ == "__main__":
    sys.exit(main())
