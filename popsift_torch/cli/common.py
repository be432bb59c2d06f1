"""Shared CLI argument surface for popsift-demo / popsift-match
(popsift_tpu/cli/common.py).

Flag names and semantics mirror the boost::program_options definitions of
the reference applications (application/main.cpp:49-150,
match.cpp:48-146).  The tools run on the current CUDA device, or on the
CPU's plain PyTorch versions with ``POPSIFT_TPU_PLATFORM=cpu``."""

from __future__ import annotations

import argparse
import os

from ..config import Config, LogMode, NormMode, ScalingMode, SiftMode


GAUSS_MODE_USAGE = (
    "Choice of Gauss filter method. Options are: vlfeat (default), "
    "vlfeat-hw-interpolated, vlfeat-direct, opencv, fixed9, fixed15, "
    "relative (synonym for vlfeat-hw-interpolated)")

NORM_MODE_USAGE = ("Choice of descriptor normalization modes. Options are: "
                   "RootSift (L1-like, default), classic (L2-like)")


def platform_device() -> str:
    """The device the tools run on, from POPSIFT_TPU_PLATFORM: unset,
    "gpu" or "cuda" is the CUDA device (a pipeline on it raises where there
    is none), "cpu" the CPU; anything else raises."""
    platform = os.environ.get("POPSIFT_TPU_PLATFORM", "").strip().lower()
    if platform in ("", "gpu", "cuda"):
        return "cuda"
    if platform == "cpu":
        return "cpu"
    raise ValueError(f"POPSIFT_TPU_PLATFORM={platform!r}: gpu, cuda or cpu")


def add_common_options(parser: argparse.ArgumentParser,
                       log_short: bool = True) -> None:
    opt = parser.add_argument_group("Options")
    opt.add_argument("-v", "--verbose", action="store_true", help="")
    log_flags = ["-l", "--log"] if log_short else ["--log"]
    opt.add_argument(*log_flags, action="store_true",
                     help="Write debugging files")

    par = parser.add_argument_group("Parameters")
    par.add_argument("--octaves", type=int, help="Number of octaves")
    par.add_argument("--levels", type=int, help="Number of levels per octave")
    par.add_argument("--sigma", type=float, help="Initial sigma value")
    par.add_argument("--threshold", type=float, help="Contrast threshold")
    par.add_argument("--edge-threshold", type=float, help="On-edge threshold")
    par.add_argument("--edge-limit", type=float, help="On-edge threshold")
    par.add_argument("--downsampling", type=float,
                     help="Downscale width and height of input by 2^N")
    par.add_argument("--initial-blur", type=float,
                     help="Assume initial blur, subtract when blurring "
                          "first time")

    modes = parser.add_argument_group("Modes")
    modes.add_argument("--gauss-mode", type=str, help=GAUSS_MODE_USAGE)
    modes.add_argument("--desc-mode", type=str,
                       help="Choice of descriptor extraction modes: loop, "
                            "iloop, grid, igrid, notile. Default is loop")
    modes.add_argument("--popsift-mode", action="store_true",
                       help="During the initial upscale, shift pixels by 1. "
                            "In extrema refinement, steps up to 0.6, do not "
                            "reject points when reaching max iterations, "
                            "first contrast threshold is .8 * peak thresh. "
                            "Shift feature coords octave 0 back to original "
                            "pos.")
    modes.add_argument("--vlfeat-mode", action="store_true",
                       help="During the initial upscale, shift pixels by 1. "
                            "In extrema refinement, steps up to 0.6, levels "
                            "remain unchanged, do not reject points when "
                            "reaching max iterations, first contrast "
                            "threshold is .8 * peak thresh.")
    modes.add_argument("--opencv-mode", action="store_true",
                       help="During the initial upscale, shift pixels by "
                            "0.5. In extrema refinement, steps up to 0.5, "
                            "reject points when reaching max iterations, "
                            "first contrast threshold is floor(.5 * peak "
                            "thresh).")
    modes.add_argument("--direct-scaling", action="store_true",
                       help="Direct each octave from upscaled orig instead "
                            "of blurred level.")
    modes.add_argument("--norm-multi", type=int,
                       help="Multiply the descriptor by pow(2,<int>).")
    modes.add_argument("--norm-mode", type=str, help=NORM_MODE_USAGE)
    modes.add_argument("--root-sift", action="store_true",
                       help=NORM_MODE_USAGE)
    modes.add_argument("--filter-max-extrema", type=int,
                       help="Approximate max number of extrema.")
    modes.add_argument("--filter-grid", type=int,
                       help="Grid edge length for extrema filtering (ie. "
                            "value 4 leads to a 4x4 grid)")
    modes.add_argument("--filter-sort", type=str,
                       help="Sort extrema in each cell by scale, either "
                            "random (default), up or down")

    info = parser.add_argument_group("Informational")
    info.add_argument("--print-gauss-tables", action="store_true",
                      help="A debug output printing Gauss filter size and "
                           "tables")
    info.add_argument("--print-dev-info", action="store_true",
                      help="A debug output printing device information")
    info.add_argument("--print-time-info", action="store_true",
                      help="A debug output printing image processing time "
                           "after load()")
    info.add_argument("--write-as-uchar", action="store_true",
                      help="Output descriptors rounded to int. Scaling to "
                           "sensible ranges is not automatic, should be "
                           "combined with --norm-multi=9 or similar")
    info.add_argument("--dont-write", action="store_true",
                      help="Suppress descriptor output")
    info.add_argument("--pgmread-loading", action="store_true",
                      help="Use the PGM image loader (always used here; "
                           "kept for flag parity)")
    info.add_argument("--float-mode", action="store_true",
                      help="Upload image as float instead of byte")


def config_from_args(args: argparse.Namespace) -> Config:
    config = Config()
    if args.verbose:
        config.set_verbose()
    if args.log:
        config.set_log_mode(LogMode.ALL)
    if args.octaves is not None:
        config.set_octaves(args.octaves)
    if args.levels is not None:
        config.set_levels(args.levels)
    if args.sigma is not None:
        config.set_sigma(args.sigma)
    if args.threshold is not None:
        config.set_threshold(args.threshold)
    if args.edge_threshold is not None:
        config.set_edge_limit(args.edge_threshold)
    if args.edge_limit is not None:
        config.set_edge_limit(args.edge_limit)
    if args.downsampling is not None:
        config.set_downsampling(args.downsampling)
    if args.initial_blur is not None:
        config.set_initial_blur(args.initial_blur)
    if args.gauss_mode is not None:
        config.set_gauss_mode(args.gauss_mode)
    if args.desc_mode is not None:
        config.set_desc_mode(args.desc_mode)
    if args.popsift_mode:
        config.set_mode(SiftMode.POPSIFT)
    if args.vlfeat_mode:
        config.set_mode(SiftMode.VLFEAT)
    if args.opencv_mode:
        config.set_mode(SiftMode.OPENCV)
    if args.direct_scaling:
        config.set_scaling_mode(ScalingMode.SCALE_DIRECT)
    if args.norm_multi is not None:
        config.set_normalization_multiplier(args.norm_multi)
    if args.norm_mode is not None:
        config.set_norm_mode(args.norm_mode)
    if args.root_sift:
        config.set_norm_mode(NormMode.ROOT_SIFT)
    if args.filter_max_extrema is not None:
        config.set_filter_max_extrema(args.filter_max_extrema)
    if args.filter_grid is not None:
        config.set_filter_grid_size(args.filter_grid)
    if args.filter_sort is not None:
        config.set_filter_sorting(args.filter_sort)
    if args.print_gauss_tables:
        config.set_print_gauss_tables()
    return config


def collect_filenames(path: str) -> list[str]:
    """Directory recursion (main.cpp:153-170)."""
    out: list[str] = []
    for entry in sorted(os.listdir(path)):
        p = os.path.join(path, entry)
        if os.path.isfile(p):
            out.append(p)
        elif os.path.isdir(p):
            out.extend(collect_filenames(p))
    return out


def print_device_info(device: str) -> None:
    if device == "cpu":
        print("device cpu: the plain PyTorch versions of the kernels")
        return
    from ..device import DeviceProperties
    DeviceProperties().print()


def maybe_print_gauss_tables(config: Config) -> None:
    if config.print_gauss_tables:
        from ..gauss import build_gauss_info, format_gauss_tables
        print(format_gauss_tables(build_gauss_info(config)))
