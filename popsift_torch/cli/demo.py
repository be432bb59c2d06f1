"""popsift-demo: extract SIFT features from images (popsift_tpu/cli/demo.py).

    python -m popsift_torch.cli.demo -i <file-or-directory> [options]

Port of application/main.cpp: the same flags, the same output files
(output-features.txt; the --log dump tree), the same counts-to-stderr
reporting (main.cpp:246-264)."""

from __future__ import annotations

import argparse
import os
import sys
import time

from ..io.pgm import read_pgm
from ..pipeline import PopSift
from ..tracing import BriefDuration, trace
from .common import (add_common_options, collect_filenames,
                     config_from_args, maybe_print_gauss_tables,
                     platform_device, print_device_info)


def process_image(input_file: str, popsift: PopSift, float_mode: bool,
                  print_time: bool):
    """Load + enqueue one image (main.cpp:172-244)."""
    t0 = time.time()
    image_data = read_pgm(input_file)
    h, w = image_data.shape
    if print_time:
        print(f"Loading {w} x {h} image {input_file} took "
              f"{time.time() - t0:.3f}s", file=sys.stderr)
    if float_mode:
        # float path divides by 256 like main.cpp:234
        return popsift.enqueue(w, h, image_data.astype("float32") / 256.0)
    return popsift.enqueue(w, h, image_data)


def read_job(job, really_write: bool, write_as_uchar: bool) -> None:
    """main.cpp:246-264."""
    feature_list = job.get()
    print(f"Number of feature points: "
          f"{feature_list.get_feature_count()} number of feature "
          f"descriptors: {feature_list.get_descriptor_count()}",
          file=sys.stderr)
    if really_write:
        with open("output-features.txt", "w") as of:
            feature_list.print(of, write_as_uchar)


def main(argv: list[str] | None = None) -> int:
    device = platform_device()
    parser = argparse.ArgumentParser(prog="popsift-demo")
    # the reference takes one -i (a file or a directory, recursed,
    # main.cpp:59,153-170); accepting repeats is a harmless superset —
    # silently dropping all but the last input would lose data
    parser.add_argument("-i", "--input-file", required=True,
                        action="append", help="Input file or directory")
    add_common_options(parser)
    args = parser.parse_args(argv)

    config = config_from_args(args)
    maybe_print_gauss_tables(config)
    if args.print_dev_info:
        print_device_info(device)

    input_files = []
    for item in args.input_file:
        if os.path.isdir(item):
            input_files.extend(collect_filenames(item))
        else:
            input_files.append(item)
    if not input_files:
        print(f"No files in {args.input_file}", file=sys.stderr)
        return 1

    from ..config import ImageMode
    imode = ImageMode.FLOAT if args.float_mode else ImageMode.BYTE
    with trace(), PopSift(config, imode=imode, device=device) as popsift:
        # phase timers like the reference's nvtx/BriefDuration pairs
        # around enqueue and drain (main.cpp:118, popsift.cpp:441-452);
        # reported only under --print-time-info
        t_enqueue = BriefDuration("Enqueue (load + upload dispatch)")
        t_drain = BriefDuration("Extraction (drain)")
        t_enqueue.start()
        jobs = []
        for f in input_files:
            job = process_image(f, popsift, args.float_mode,
                                args.print_time_info)
            if job is not None:
                jobs.append(job)
        t_enqueue.stop()
        t_drain.start()
        for job in jobs:
            read_job(job, not args.dont_write, args.write_as_uchar)
        t_drain.stop()
        if args.print_time_info:
            t_enqueue.report()
            t_drain.report()
    return 0


if __name__ == "__main__":
    sys.exit(main())
