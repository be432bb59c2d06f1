"""popsift-match: extract from two images and brute-force match
(popsift_tpu/cli/match.py).

    python -m popsift_torch.cli.match -l <left> -r <right> [options]

Port of application/match.cpp: the same flags, extraction in
MatchingMode (descriptors left on the device), the match report in
show_distance format (features.cu:230-265)."""

from __future__ import annotations

import argparse
import os
import sys

from ..config import ProcessingMode
from ..io.pgm import read_pgm
from ..pipeline import PopSift
from ..tracing import trace
from .common import (add_common_options, config_from_args,
                     maybe_print_gauss_tables, platform_device,
                     print_device_info)


def main(argv: list[str] | None = None) -> int:
    device = platform_device()
    parser = argparse.ArgumentParser(prog="popsift-match")
    parser.add_argument("-l", "--left", required=True,
                        help='"Left"  input file')
    parser.add_argument("-r", "--right", required=True,
                        help='"Right" input file')
    add_common_options(parser, log_short=False)
    args = parser.parse_args(argv)

    for f in (args.left, args.right):
        if not os.path.isfile(f):
            print(f"Input file {f} is not a regular file, nothing to do")
            return 1

    config = config_from_args(args)
    maybe_print_gauss_tables(config)
    if args.print_dev_info:
        print_device_info(device)

    with trace(), PopSift(config, mode=ProcessingMode.MATCHING,
                          device=device) as popsift:
        jobs = []
        for f in (args.left, args.right):
            img = read_pgm(f)
            h, w = img.shape
            jobs.append(popsift.enqueue(w, h, img))

        l_features = jobs[0].get_dev()
        print(f"Number of features:    {l_features.get_feature_count()}")
        print(f"Number of descriptors: {l_features.get_descriptor_count()}")
        r_features = jobs[1].get_dev()
        print(f"Number of features:    {r_features.get_feature_count()}")
        print(f"Number of descriptors: {r_features.get_descriptor_count()}")

        l_features.match_and_print(r_features, sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
