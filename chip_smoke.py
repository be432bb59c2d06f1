"""Start-up proof of popsift_torch on one NVIDIA Hopper GPU (H100).

    python3 chip_smoke.py

Run from the repository root.  It needs one CUDA device of compute
capability 9.0, the CUDA toolkit (nvcc) and PyTorch; it imports neither
JAX nor popsift_tpu.  In order it:

1. prints the card's name and power limit, the torch and CUDA versions, and
   builds the kernel library from popsift_torch/csrc (printing the build
   time, and what ptxas reports for K7 and K6/K11);
2. checks every kernel against its plain PyTorch version on the card, on
   the inputs the main paths give it for a 1080p scene: the octave-0
   levels, DoG and stack for the blur, the blur's chain entry at every
   octave that takes it (its field bit for bit against K2 on its own
   stack, with equal digests, on all four scenes), the octave chain (both
   emit modes, and bit for bit against the per-level kernels, at every
   octave that takes it), the gradient kernel (though no 1080p path
   launches it: K7 and K1's chain entry write the field), detection at
   every octave and on a DoG full of exact
   ties (bit for bit), the octave-2 masks whose candidates the compaction
   budget trims (against the ones the CPU tests hold to the JAX package),
   and the real candidates and
   keypoint rows of the scene's busiest octave for refinement (per
   candidate, and with its compaction bit for bit against
   compact_extrema of both, at the octave's capacity and at one that
   overflows), orientation (the histograms within rtol 1e-5 of the plain
   ones, num_ori and the angles bit for bit against the plain peaks of
   the kernel's own histograms, and the epilogue alone on tie-rich
   histograms), loop descriptors (from the field and from the stack; the
   stack kernels also bit for bit against the field kernels on K2's field,
   at octave 0, at the busiest octave and at the octave of the largest
   sigma), the window gather (both call shapes, though no path launches
   it: K9, K12 and K13 read its windows from the stack; at the busiest
   octave and with the same rows on octave 0's stack, which does not fit
   in L2, each shape's share of its bound printed; and bit for bit on
   origins that reach every branch of its kernel: inside the plane at
   each 16-byte shift, across each edge and corner, wholly outside, at
   the last level, for 0, 1, 37 and 2311 rows), and the NoTile,
   Grid and ILoop descriptors read from the stack (against K8's plain
   windows and the window forms; bit-identical run to run and with every
   row's taps read through L2 instead of the staged footprint, also timed
   that way; the share of rows whose footprint exceeds the staging
   capacity; a digest of K9's output, which equals that of K8 and the
   window form's kernel before K9 read the stack, as
   tools/torch_time_kernels.py --kernels K9 shows on both trees),
   K5/K10, K6/K11 and K9/K12/K13 as the main path launches them, once
   over a table of every octave that holds extrema (bit for bit against
   their one-entry launches octave by octave and run to run, the stack
   kernels against the field kernels, and within the single-octave
   tolerances of the plain versions of each octave; these table launches
   are the kernel table's rows of these kernels, the single-octave
   launches kept inside them as ``one_octave``), K1 at the halo classes only the non-default pyramids reach (4:
   Fixed9's span 5; 32: VLFeat-relative-all's span 21), the same taps on
   both axes x255 at octave 0, bit for bit, with cuDNN's time beside
   them, and K3 and K4 in the OpenCV and VLFeat SiftModes on each mode's
   own DoG (K3 bit for bit at every octave, K4 at the busiest);
   it times both between CUDA events (the median of repeated calls), the
   kernel also by its device time (torch.profiler, the mean), beside the
   kernel's bound;
3. drives the default path, PopSift(Config()).enqueue(...).get(), on four
   distinct 1080p scenes with the launch counts reset just before, fails
   if a kernel of that path was not launched, if gather_windows or
   grad_field was (counted or in the profile), or if the features per image
   moved from their recorded counts (and prints how the descriptor rows
   compare with those of the plain peaks), and checks that a repeated
   frame gives bit-identical features; it times five such passes (median and
   range) and profiles one more for the device's busy and idle share, and
   counts the PyTorch operations per image (none may be torch.roll: the
   orientation peaks are K5's);
   per scene it requires the recorded count of candidates the compaction
   budget dropped and at most MAX_K1_CALLS calls of K1 (the same on every
   path);
4. drives the NoTile path, PopSift(Config(desc_mode=notile)), the same
   way, and checks that its keypoints are the default path's, that no
   gather_windows or grad_field ran (counted or in the profile), and per
   scene the
   descriptor rows whose footprint exceeds the staging capacity;
5. drives the stack-kernel path (POPSIFT_TPU_STACK_KERNELS=1 on the
   default Config) the same way: no gradient-field, field-histogram,
   field-descriptor or gather_windows launch (gather_windows and
   grad_field neither in the profile), and features equal to the default
   path's bit
   for bit; the switch is restored afterwards;
6. drives the Grid and ILoop paths for one pass each (launches, keypoints
   equal to the default path's, bit-identical repeat, one profiled pass;
   no gather_windows or grad_field launch, counted or in the profile; per
   scene the
   descriptor rows whose footprint exceeds the staging capacity);
7. holds the card's features of a small scene against the plain PyTorch
   versions run on the CPU, for all five paths;
8. drives matching mode, PopSift(Config(), mode=MATCHING, workers=2)
   .enqueue(...).get_dev() and FeaturesDev.match, on the four scenes,
   their 90-degree rotations and the repository's two real 640x480 pairs
   (china, flower) with the launch counts reset just before (the default
   path's kernels launched, gather_windows and grad_field not): each
   frame's FeaturesDev equals its ExtractingMode features (phase 3's for
   the scenes), its descriptors a CUDA tensor bit for bit; each scene
   matched with itself gives every row itself; each pair's matches equal
   a float64 matcher's on the CPU except at near ties (at most 0.1% of
   the rows), with distances within rtol 1e-4 (and float32's rounding
   bound near 0); workers=1 and workers=2
   give bit-identical FeaturesDevs; the matcher gives the same results
   bit for bit with TF32 turned on by the caller (it holds TF32 off for
   its product).  It prints the accepted matches per pair, the share of
   a rotated pair's matches within 2 px of the rotation, the matcher's
   time on a 1080p pair, and the wall of a pair (two enqueues, two
   get_devs and the match) for one and two workers;
9. drives the non-default modes (MODES): the OpenCV and VLFeat
   SiftModes, the Fixed9, Fixed15 and VLFeat-relative-all Gauss modes,
   direct scaling, Fixed9 with direct scaling, and the grid filter
   (filter_max_extrema=1000) in its three sortings, each through
   PopSift(Config(...)) on the four scenes, one timed and one profiled
   pass: the kernels of its route launched and the others not (no K7 and
   no K1 chain entry on the fixed route, K2 on the fixed and relative
   routes, K8 on none), features on every scene as recorded in
   MODE_FEATURES, a bit-identical repeat, and the card against the CPU on
   a 640x480 photograph (tests/data/scenes/street.pgm) as in phase 7; the
   grid filter also triggers on every
   scene, keeps what ops/filtergrid.py keeps on the CPU from the card's
   own unfiltered extrema, and its features are a subset of phase 3's;
10. drives the command-line tools and diagnostics: (a) writes the four
   scenes as P5 PGMs into a temporary directory and scene 0 also as P2
   and P6, each read back equal; (b) runs popsift_torch.cli.demo's main
   in this process on that directory with the launch counts reset (the
   default path's kernels launched, gather_windows and grad_field not;
   the stderr counts DEFAULT_FEATURES; output-features.txt byte-equal to
   FeaturesHost.print of phase 3's scene 3); (c) runs the demo as a child
   process on its default device with --print-dev-info, --print-time-info
   and --print-gauss-tables (rc 0, the same counts, the card's name, the
   Gauss tables of format_gauss_tables, no JAX or popsift_tpu module
   imported in the child; prints the enqueue and drain times); (d) runs
   popsift_torch.cli.match on scene 0 and its rotation (its lines equal
   match_and_print in this process, its accepted count phase 8's); (e)
   runs --log on tests/data/scenes/street.pgm (the seven directories, a
   file per level and DoG of each kind, every raw dump bit-equal to the
   pyramid-returning route on the card, dir-desc's rows the job's
   descriptors, the features bit-equal to a run without --log, the raw
   dumps within LOG_CPU_ATOL of the same dump made on the CPU); (f) with
   the host trace on, prints each host span's ms per image and share of
   the wall over three passes of the scenes (features DEFAULT_FEATURES),
   the wall with the trace on and off, and per scope its host ms and the
   device ms of what it launched, from a profile of extract_features in
   which every scope must appear; (g) holds the repeatability of
   tests/test_repeatability.py's scene, extracted on the card, to that
   test's thresholds, and prints the same numbers for scene 0 at 1080p;
11. drives the multi-device SfM front end (popsift_torch.parallel): (a)
   sfm_frontend_step on one NCCL rank initialised in this process through
   a FileStore, mesh (1, 1), the four scenes as one batch of a tensor
   already on the card under key_from_counts of phase 3's features, with
   the launch counts reset
   just before (the default path's kernels launched, gather_windows and
   grad_field not): each image's valid rows bit-equal to phase 3's
   descriptors, ext_counts DEFAULT_FEATURES, overflow 0, the match counts
   those of ops/match.py:match_brute_force on the same blocks (rows that
   differ only at near ties, at most 0.1%); it prints the extrema and
   overflow under the default key; (b) four gloo ranks sharing the card
   (parallel/ranks.py:run_ranks), mesh (2, 2), scenes 0-2 padded to four:
   the ranks bit-equal to each other over two steps, the real frames'
   rows bit-equal to (a)'s, the match indices equal to (a)'s except at
   near ties, no valid row in the pad frame and no match to it; (c)
   dryrun_multichip on NCCL, one rank a card; (d) the wall of one step of
   (a) and (b), median of three, beside the card's name and power limit;
12. drives the lossless wire codec (popsift_torch.wirecodec): (a)
   encodes the four scenes and three synthetic frames of their size on
   the host (each scheme reached: the bitmap scheme on the scenes, 2-bit
   codes and nibbles on the synthetic frames, and no buffer for a noise
   frame, which upload_image_u8 then uploads raw); (b) decodes each
   buffer on the card, bit-equal to the frame and to the CPU decode of
   the same buffer; (c) passes upload_image_u8(scene, cuda) into
   extract_features with the launch counts reset just before (the default
   path's kernels launched, gather_windows and grad_field not; phase 3's
   features bit for bit, with equal descriptor digests); (d) prints per
   frame the bytes on the wire, the host encode time, the H2D copy of the
   buffer against the raw frame's, and the decode's time between CUDA
   events and on the device (for scene 0 also by kernel), beside the
   card's name and power limit; (e)
   checks that no JAX module was imported;
13. drives the accuracy harness (popsift_torch.eval): (a) the
   Oxford-shaped protocol, 8 photographs of tests/data/scenes x 6 images
   under known transformations, through
   PopSift(protocol_config(mode), device="cuda") in the PopSift, VLFeat and
   OpenCV SiftModes with the launch counts reset just before (the default
   path's kernels launched, gather_windows and grad_field not): each mode
   meets the pass bar (img1-2 repeatability >= 0.60, matching score >=
   0.45), its summary lies within OXFORD_SUMMARY_ATOL of PARITY_r05.json's
   and at most OXFORD_MOST_ROWS_OFF of its 40 rows lie off the record's
   (keypoints by more than max(3, 1%), rates by more than 0.01), each
   printed, where the rows of OXFORD_RECORD_DIVERGES are held instead to
   the port's rows on the CPU made in the same run; it prints per mode the summary, the largest row deviation and
   the wall beside the card's name and power limit; (b) the card against
   the CPU, as in phase 7, on hopper's first image and flower_r's second
   (light family), and the same feature count (none) on average's JPEG
   image at quality 75; (c) the reference script's output tree of
   street.pgm on the card against the CPU's at the parity tool's default
   tolerances, and a parity pack of one synthetic scene in the reference
   layout;
14. stages through ``PopSift.enqueue`` a 6000x4000 float32 window
   (AliceVision's configuration) and a 1080p byte frame, the caller
   zeroing its array at once: the job's device image and features bit
   for bit those of the upload the ring replaced, the photograph in more
   than one band of the page-locked ring and the frame in one; prints
   ``#stage_in.bands``, the ``stage_in`` and ``upload`` spans, and the
   staging's time against the replaced host copy and pageable upload;
15. prints the kernel table as one JSON line (each row's launches are
   those of its home path, the first that launches it; K8's, on no path,
   are its counts summed, each required to be 0; each row also holds its
   launches on every path, matching mode, the CLI, the multi-device step,
   the codec upload and the accuracy harness included) and, last, the
   device line, after
   checking that no JAX module was imported and that no process the
   script started is left (every child has exited and been waited for).

Any failed check raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import re
import subprocess
import sys
import tarfile
import tempfile
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and non-tensor-core
# float32 operations/s.  The bound of a kernel is the larger of its
# compulsory bytes over the first and its operations over the second.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# Operations per unit of work, counted from the kernels' sources (a
# transcendental or a divide counts as one operation).
OPS_BLUR_PER_TAP = 3          # (l + r) * t, then + acc
OPS_GRAD = 7                  # 2 sub, 2 mul, add, sqrt, atan2
OPS_DETECT = 56               # 26 max, 26 min, 2 compares, abs, gate
OPS_REFINE_ITER = 110         # derivatives, 3x3 solve, step rule
OPS_ORI_PIXEL = 16            # distance, exp weight, bin
OPS_ORI_PEAKS = 36 * 30       # per extremum: 6 smoothing passes, the peak
#                               test and refinement, 4 argmax rounds
OPS_DESC_PIXEL = 100          # rotation, exp weight, angle, 16 tiles x 2 bins
OPS_GRID_SAMPLE = 70          # rotation, 4 bilinear taps, hypot, atan2, bins
OPS_GRID_TILES = 2 * 16 * (40 * 32 + 128)   # the two tile contractions
OPS_ROUNDED_SAMPLE = 60       # position, 2 roundings, recomputed weights,
#                               4 taps, hypot, atan2, exp, 8 bin adds
OPS_ILOOP_SAMPLE = 90         # 4 bilinear samples (12 each), hypot, atan2,
#                               exp, weights, 8 bin adds

# Features per image of the default path on the four 1080p scenes (seeds
# 0-3), as the per-level pyramid gave them; the fused chain is bit-equal
# to it, so they must not move.  The compaction budget (16 candidates per
# 1024-voxel run, as the JAX package keeps) drops BUDGET_DROPPED of each
# scene's candidates, all at octave 2; tests/test_torch_detect.py holds the
# port's candidates on those masks to the JAX package's compact_mask.
DEFAULT_FEATURES = (2299, 2469, 2420, 2499)
# Descriptor rows per image of the default path (one per accepted
# orientation) when the peaks were plain PyTorch ops after a kernel that
# wrote only the histograms.  K5 sums each histogram in another order, so
# a peak that the last bit decides (at the 0.8 acceptance line, or tied
# with another) may go the other way: a change is printed, not refused.
PLAIN_PEAKS_DESCRIPTORS = (2490, 2656, 2606, 2682)
BUDGET_DROPPED = (2, 6, 3, 0)
BUDGET_MASKS = HERE / "tests" / "data" / "budget_masks_1080p.npz"
# K1's calls per image on every path: octave 0's level 0, and one chain
# call for each octave that K7 does not take
MAX_K1_CALLS = 6
# The kernels each path launches (the others are not on it).
LOOP_PATH = ("sep_blur", "blur_chain", "octave_chain", "detect", "refine",
             "ori_hist", "desc_loop")
NOTILE_PATH = ("sep_blur", "blur_chain", "octave_chain", "detect", "refine",
               "ori_hist", "desc_grid_stack")
STACK_PATH = ("sep_blur", "blur_chain", "octave_chain", "detect", "refine",
              "ori_hist_stack", "desc_loop_stack")
GRID_PATH = ("sep_blur", "blur_chain", "octave_chain", "detect", "refine",
             "ori_hist", "desc_grid_rounded_stack")
ILOOP_PATH = ("sep_blur", "blur_chain", "octave_chain", "detect", "refine",
              "ori_hist", "desc_iloop_stack")
# K9, K12 and K13 read the stack, and the default and stack paths take no
# windows: no path launches K8.  K7 writes the field of octaves 0-3 and
# K1's chain entry that of octaves 4-8: no path of phases 3-8 launches K2
# (its home paths are phase 9's fixed and relative routes).
NOT_ON_ANY_PATH = ("gather_windows", "grad_field")
# the kernels the stack path must not launch: it reads no gradient field
NOT_ON_STACK_PATH = ("ori_hist", "desc_loop") + NOT_ON_ANY_PATH
STACK_SWITCH = "POPSIFT_TPU_STACK_KERNELS"

# Phase 9, the non-default modes: each a Config (its setters and their
# arguments) and its route.  A "chain" route launches the default path's
# kernels and no K2 or K8; on the "fixed" route every octave's levels come
# from K1 once a level (no K7 and no K1 chain entry) with the field from
# K2; on the "relative" route octave 0 does so and the later octaves take
# the chain.
MODES = (
    ("opencv", (("set_mode", "opencv"),), "chain"),
    ("vlfeat", (("set_mode", "vlfeat"),), "chain"),
    ("fixed9", (("set_gauss_mode", "fixed9"),), "fixed"),
    ("fixed15", (("set_gauss_mode", "fixed15"),), "fixed"),
    ("vlfeat-direct", (("set_gauss_mode", "vlfeat-direct"),), "relative"),
    ("direct", (("set_scaling_mode", "direct"),), "chain"),
    ("fixed9-direct", (("set_gauss_mode", "fixed9"),
                       ("set_scaling_mode", "direct")), "fixed"),
    ("filter-random", (("set_filter_max_extrema", 1000),
                       ("set_filter_sorting", "random")), "chain"),
    ("filter-down", (("set_filter_max_extrema", 1000),
                     ("set_filter_sorting", "down")), "chain"),
    ("filter-up", (("set_filter_max_extrema", 1000),
                   ("set_filter_sorting", "up")), "chain"),
)
FIXED_PATH = ("sep_blur", "grad_field", "detect", "refine", "ori_hist",
              "desc_loop")
RELATIVE_PATH = LOOP_PATH + ("grad_field",)
ROUTES = {"chain": (LOOP_PATH, NOT_ON_ANY_PATH),
          "fixed": (FIXED_PATH, ("octave_chain", "blur_chain",
                                 "gather_windows")),
          "relative": (RELATIVE_PATH, ("gather_windows",))}
# the scene of phase 9's card-against-CPU check (Fixed9: 183 features)
CPU_CHECK_SCENE = "street.pgm"
# Features per image of each non-default mode on the four scenes, as the
# first run of each gave them (NVIDIA H100 80GB HBM3, 700 W); they must
# not move.  Fixed9's and Fixed9+direct's on the CPU are the same.
MODE_FEATURES = {
    "opencv": (1927, 2046, 2077, 2114),
    "vlfeat": (2306, 2466, 2426, 2502),
    "fixed9": (1, 1, 2, 2),
    "fixed15": (4421, 4698, 4642, 4825),
    "vlfeat-direct": (2305, 2462, 2426, 2500),
    "direct": (2545, 2727, 2716, 2830),
    "fixed9-direct": (27, 34, 34, 42),
    "filter-random": (1004, 1004, 1000, 1004),
    "filter-down": (1004, 1004, 1000, 1004),
    "filter-up": (1004, 1004, 1000, 1004),
}


def make_scene(seed: int, h: int, w: int) -> np.ndarray:
    """Band-limited random texture (1/f-like spectrum) with a keypoint
    density like real footage; the benchmark scenes of the repository."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), np.float32)
    for cell, amp in ((128, 1.0), (64, 0.6), (32, 0.35), (16, 0.2),
                      (8, 0.1)):
        base = rng.random((h // cell + 2, w // cell + 2)).astype(np.float32)
        up = np.kron(base, np.ones((cell, cell), np.float32))[:h, :w]
        img += amp * up
    for _ in range(3):
        img = (img + np.roll(img, 1, 0) + np.roll(img, -1, 0)
               + np.roll(img, 1, 1) + np.roll(img, -1, 1)) / 5.0
    img = (img - img.min()) / (img.max() - img.min())
    return (img * 255).astype(np.uint8)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def child_pids() -> list:
    """The processes whose parent is this one, in any state (a child that
    has exited but was not waited for included)."""
    me = str(os.getpid())
    kids = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        if stat.rsplit(")", 1)[1].split()[1] == me:
            kids.append(int(d))
    return kids


def cuda_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Median time of one call of ``fn`` on the current stream, between two
    CUDA events: the wrapper's host time before its launch included, as a
    caller meets it."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def library_records(fn, reps: int) -> list:
    """(name, us) of each record of the library's kernels in
    torch.profiler's CUDA activity over ``reps`` calls of ``fn``: the
    records named in an anonymous namespace at the top level.  The profile
    holds 50 ms of idle host time before the first call and after the
    last kernel ends, because the profiler drops the records that its
    clock places outside its window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(0.05)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.05)
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == DeviceType.CUDA
            and e.name.removeprefix("void ").startswith(
                "(anonymous namespace)::")]


def device_ms(fn, reps: int = 20, warmup: int = 2,
              per_launch: int = 1) -> float | None:
    """Mean device time of the library kernels one call of ``fn``
    launches, from :func:`library_records`, without the host time that
    CUDA events around a call count.  Each call must give ``per_launch``
    records for each launch the wrappers count (one for every entry but
    K4's refinement with its compaction, which launches two kernels).  A
    profile with fewer records is taken again.  After three such profiles
    the time is estimated from the fullest one, each kernel name's mean
    record times the records a call gives over the names seen, and a note
    says so; with no record at all it is None (not measured).  The
    wrappers' launch counts, not the profiler, show that a kernel ran."""
    import torch
    from popsift_torch.kernels import _lib
    before = _lib.launches()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    after = _lib.launches()
    launched = sum(after[k] - before[k] for k in after)
    require(launched > 0 and launched % warmup == 0,
            f"device_ms: {launched} launches in {warmup} calls")
    per_call = launched * per_launch // warmup
    want = reps * per_call
    best = []
    for _ in range(3):
        recs = library_records(fn, reps)
        require(len(recs) <= want, f"device_ms: {len(recs)} records of "
                f"the library's kernels for {want} launches")
        if len(recs) == want:
            return sum(us for _, us in recs) / reps / 1e3
        print(f"  (device_ms: the profiler recorded {len(recs)} of {want} "
              f"launches; profiled again)", flush=True)
        best = max(best, recs, key=len)
    if not best:
        print("  (device_ms: no record in three profiles; device time not "
              "measured)", flush=True)
        return None
    by_name = {}
    for name, us in best:
        by_name.setdefault(name, []).append(us)
    est = sum(sum(v) / len(v) for v in by_name.values()) \
        * per_call / len(by_name) / 1e3
    print(f"  (device_ms: {len(best)} of {want} records at best; estimated "
          f"from the mean record of each of {len(by_name)} kernels)",
          flush=True)
    return est


def fmt_ms(t: float | None) -> str:
    return "not measured" if t is None else f"{t:.6f}"


def kernel_ms(fn, reps: int = 20, per_launch: int = 1) -> tuple[float, float]:
    """A kernel's two times: between CUDA events (the median) and on the
    device (the mean)."""
    return cuda_ms(fn, reps), device_ms(fn, reps, per_launch=per_launch)


def ulps(a, b) -> int:
    """Largest distance in units in the last place between two float32
    tensors of the same shape."""
    import torch

    def ordered(t):
        i = t.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    if a.numel() == 0:
        return 0
    return int((ordered(a) - ordered(b)).abs().max())


def ptxas_report(log: str, names) -> None:
    """What ptxas says (registers, shared memory, spills) of the kernels
    named, and every error line of the build."""
    kernel = None
    for line in log.splitlines():
        if "error" in line.lower():
            print("  ptxas: " + line.strip(), flush=True)
        m = re.search(r"(?:entry function|properties for) '?(_Z\w+)", line)
        if m:
            # a mangled name holds <length><name>, then I<arguments>E for
            # a template, each constant argument L<type><value>E (Lb1 for
            # true, Li16 for 16)
            kernel = None
            for name in names:
                at = m.group(1).find(f"{len(name)}{name}")
                if at >= 0:
                    rest = m.group(1)[at + len(str(len(name))) + len(name):]
                    args = re.match(r"I((?:L[a-z]\d+E)+)E", rest)
                    kernel = name
                    if args:
                        vals = [{"b1": "true", "b0": "false"}.get(a, a[1:])
                                for a in re.findall(r"L([a-z]\d+)E",
                                                    args.group(1))]
                        kernel += "<" + ", ".join(vals) + ">"
            continue
        if kernel and ("registers" in line or "spill" in line):
            print(f"  ptxas {kernel}: {line.split(':', 1)[-1].strip()}",
                  flush=True)


def max_abs(a, b) -> float:
    if a.numel() == 0:
        return 0.0
    return float((a.double() - b.double()).abs().max())


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def box_union_pixels(lp, x0, x1, y0, y1, L, H, W) -> int:
    """Number of distinct (level, y, x) pixels covered by the inclusive
    boxes [x0, x1] x [y0, y1] at level lp (2-D difference array)."""
    import torch
    keep = (x1 >= x0) & (y1 >= y0)
    lp, x0, x1, y0, y1 = (t[keep].long() for t in (lp, x0, x1, y0, y1))
    d = torch.zeros((L, H + 1, W + 1), dtype=torch.int32, device=lp.device)
    one = torch.ones_like(lp, dtype=torch.int32)
    for yy, xx, s in ((y0, x0, 1), (y0, x1 + 1, -1), (y1 + 1, x0, -1),
                      (y1 + 1, x1 + 1, 1)):
        d.index_put_((lp, yy, xx), one * s, accumulate=True)
    cover = d.cumsum(1).cumsum(2)[:, :H, :W]
    return int((cover > 0).sum())


class Table:
    """The per-kernel rows of the final JSON line."""

    SOURCES = {
        "sep_blur": ("popsift_torch/csrc/blur.cu",
                     "popsift_tpu/kernels/blur.py:94"),
        "blur_chain": ("popsift_torch/csrc/blur.cu",
                       "popsift_tpu/kernels/blur.py:94"),
        "grad_field": ("popsift_torch/csrc/grad.cu",
                       "popsift_tpu/kernels/grad.py:97"),
        "detect": ("popsift_torch/csrc/detect.cu",
                   "popsift_tpu/kernels/detect.py:154"),
        "refine": ("popsift_torch/csrc/refine.cu",
                   "popsift_tpu/kernels/refine.py:122"),
        "ori_hist": ("popsift_torch/csrc/binwin.cu",
                     "popsift_tpu/kernels/binwin.py:180"),
        "desc_loop": ("popsift_torch/csrc/binwin.cu",
                      "popsift_tpu/kernels/binwin.py:334"),
        "octave_chain": ("popsift_torch/csrc/octave.cu",
                         "popsift_tpu/kernels/octave.py:282"),
        "gather_windows": ("popsift_torch/csrc/windows.cu",
                           "popsift_tpu/kernels/windows2.py:76"),
        "desc_grid_stack": ("popsift_torch/csrc/desc_grid.cu",
                            "popsift_tpu/ops/descriptors.py:529"),
        "ori_hist_stack": ("popsift_torch/csrc/binwin.cu",
                           "popsift_tpu/kernels/binwin.py:656"),
        "desc_loop_stack": ("popsift_torch/csrc/binwin.cu",
                            "popsift_tpu/kernels/binwin.py:703"),
        "desc_grid_rounded_stack": ("popsift_torch/csrc/desc_grid.cu",
                                    "popsift_tpu/ops/descriptors.py:657"),
        "desc_iloop_stack": ("popsift_torch/csrc/desc_grid.cu",
                             "popsift_tpu/ops/descriptors.py:1091"),
    }

    def __init__(self):
        self.rows = {}
        self.subs = {}

    def add(self, name, label, err, times, plain_ms, nbytes, nops,
            library_ms=None, sub=None):
        """One kernel's row; ``times`` is :func:`kernel_ms`'s pair: ``ms``
        between CUDA events and ``device_ms``.  ``sub`` names a second call
        shape, kept inside the row of ``name`` under that key."""
        ms, dms = times
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / F32_OPS_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        by = "bytes" if t_bytes >= t_ops else "operations"
        lib = "null" if library_ms is None else f"{library_ms:.6f}"
        print(f"  {label}: max_abs_err={err:.6g} kernel_ms={ms:.6f} "
              f"device_ms={fmt_ms(dms)} plain_ms={plain_ms:.6f} "
              f"bound_ms={bound:.6f} ({by}: {nbytes:.0f} B, {nops:.0f} ops) "
              f"library_ms={lib}", flush=True)
        if sub is not None:
            row = dict(max_abs_err=err, ms=ms, device_ms=dms,
                       plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                       library_ms=library_ms)
            if name in self.rows:
                self.rows[name][sub] = row
            else:
                self.subs.setdefault(name, {})[sub] = row
            return
        src, rep = self.SOURCES[name]
        self.rows[name] = dict(
            name=name, route="cuda", source=src, replaces=rep,
            launches=0, max_abs_err=err, ms=ms, device_ms=dms,
            plain_ms=plain_ms, bound_ms=bound, bound_by=by,
            library_ms=library_ms, **self.subs.get(name, {}))


def check_kernels(torch, pt, scene: np.ndarray, table: Table,
                  dev) -> None:
    """Phase 2: each kernel against its plain version, at octave 0 (K1-K3,
    K7) or at the scene's busiest octave (K4-K6, K8, K9)."""
    from popsift_torch import extract as ext
    from popsift_torch.gauss import build_gauss_info
    from popsift_torch.kernels import binwin, blur, detect, grad, refine
    from popsift_torch.ops import extrema as ops_ext
    from popsift_torch.ops import orientation as ops_ori
    from popsift_torch.ops import pyramid as ops_pyr

    cfg = pt.Config()
    h_in, w_in = scene.shape
    plan = ext.make_plan(cfg, w_in, h_in)
    gauss = build_gauss_info(cfg)
    w, h = plan.dims[0]
    img = ext.to_unit_image(scene, dev)
    base = ops_pyr.resample_input(
        img, h, w, ops_pyr.input_shift(plan.sift_mode,
                                       plan.upscale_factor, 0)).contiguous()
    px = h * w
    print(f"phase 2: kernels against their plain versions at octave 0 "
          f"({h}x{w}, {plan.octaves} octaves)", flush=True)

    # K1, level 0: dd[0] horizontally, x255, inc[0] vertically
    sh, sv = int(gauss.dd.span[0]), int(gauss.inc.span[0])
    args0 = (gauss.dd.filter[0], sh, gauss.inc.filter[0], sv)
    k = blur.sep_blur(base, *args0, hscale=255.0)
    p = blur.sep_blur_plain(base, *args0, hscale=255.0)
    require(torch.equal(k, p), "K1 level 0: kernel != plain")
    ms = kernel_ms(lambda: blur.sep_blur(base, *args0, hscale=255.0))
    pms = cuda_ms(lambda: blur.sep_blur_plain(base, *args0, hscale=255.0),
                  reps=10)
    table.add("sep_blur", f"K1 sep_blur level 0, spans {sh}/{sv}, x255",
              max_abs(k, p), ms, pms, 8 * px,
              OPS_BLUR_PER_TAP * (sh + sv) * px, sub="level0")

    stack, dog = ops_pyr.build_octave(img, 0, plan.dims, plan.levels, gauss,
                                      plan.sift_mode, plan.upscale_factor)
    L = stack.shape[0]
    span = int(gauss.inc.span[L - 1])
    taps = gauss.inc.filter[L - 1]
    src = stack[L - 2]
    k, kd = blur.sep_blur(src, taps, span, with_dog=True)
    p, pd = blur.sep_blur_plain(src, taps, span, taps, span, with_dog=True)
    require(torch.equal(k, p) and torch.equal(kd, pd),
            f"K1 span {span} + DoG: kernel != plain")
    ms = kernel_ms(lambda: blur.sep_blur(src, taps, span, with_dog=True))
    pms = cuda_ms(lambda: blur.sep_blur_plain(src, taps, span, taps, span,
                                              with_dog=True), reps=10)
    # the same blur as one cuDNN convolution over the edge-padded plane
    # (float32, TF32 off), the library yardstick
    t2 = torch.as_tensor(np.outer(taps[:span][::-1].tolist()
                                  + taps[1:span].tolist(),
                                  taps[:span][::-1].tolist()
                                  + taps[1:span].tolist()),
                         dtype=torch.float32, device=dev)[None, None]
    padded = torch.nn.functional.pad(src[None, None], (span - 1,) * 4,
                                     mode="replicate")
    lib_ms = cuda_ms(lambda: torch.nn.functional.conv2d(padded, t2))
    lib_err = max_abs(torch.nn.functional.conv2d(padded, t2)[0, 0], k)
    print(f"  (cuDNN conv2d of the padded plane differs by {lib_err:.6g})")
    table.add("sep_blur", f"K1 sep_blur span {span} + DoG",
              max(max_abs(k, p), max_abs(kd, pd)), ms, pms, 12 * px,
              (OPS_BLUR_PER_TAP * 2 * span + 1) * px, library_ms=lib_ms)

    check_chain(torch, plan, gauss, 0, stack, dog, table)

    # K2
    f = grad.grad_field(stack)
    fp = grad.grad_field_plain(stack)
    require(torch.equal(f[0::2], fp[0::2]), "K2 mag: kernel != plain")
    th_ulps = ulps(f[1::2], fp[1::2])
    print(f"  K2 theta: {th_ulps} ulp", flush=True)
    require(th_ulps <= 2, f"K2 theta differs by {th_ulps} ulp")
    ms = kernel_ms(lambda: grad.grad_field(stack))
    pms = cuda_ms(lambda: grad.grad_field_plain(stack), reps=10)
    table.add("grad_field", f"K2 grad_field ({L},{h},{w})",
              max_abs(f, fp), ms, pms, 12 * L * px, OPS_GRAD * L * px)

    # K3, at octave 0 (timed), at every other octave below, and on a DoG
    # full of exact ties
    m = detect.detect(dog, plan.sift_mode, plan.peak_threshold)
    gate, border = detect.gate_for(plan.sift_mode, plan.peak_threshold)
    mp = detect.detect_plain(dog, gate, border)
    require(torch.equal(m, mp), "K3 mask: kernel != plain")
    check_detect_ties(torch, plan, dev)
    cands = ops_ext.compact_mask(m, plan.cand_caps[0])
    octave0 = (stack, dog)
    cands_p = ops_ext.compact_mask(mp, plan.cand_caps[0])
    require(cands.count == cands_p.count and torch.equal(cands.x, cands_p.x)
            and torch.equal(cands.y, cands_p.y)
            and torch.equal(cands.z, cands_p.z), "K3 candidate lists differ")
    ms = kernel_ms(lambda: detect.detect(dog, plan.sift_mode,
                                         plan.peak_threshold))
    pms = cuda_ms(lambda: detect.detect_plain(dog, gate, border), reps=10)
    nl = dog.shape[0] - 2
    table.add("detect", f"K3 detect ({dog.shape[0]},{h},{w}) -> "
              f"{cands.count} candidates", max_abs(m.float(), mp.float()),
              ms, pms,
              (4 * dog.shape[0] + nl) * px, OPS_DETECT * nl * px)

    # K4-K6 work on keypoints, and octave 0 of a smooth scene holds few:
    # they are checked on the octave of this scene with the most candidates
    # K7 also on every other octave that takes the chain
    best = (cands.count, 0, stack, dog, cands)
    octaves = [(0, stack, dog)]
    prev = stack
    _, spans = ops_pyr.chain_filters(gauss, plan.levels)
    filters = ops_pyr.chain_filters(gauss, plan.levels)[0]
    for o in range(1, plan.octaves):
        st, dg = ops_pyr.build_octave(prev, o, plan.dims, plan.levels, gauss,
                                      plan.sift_mode, plan.upscale_factor)
        if ops_pyr.chain_eligible(st.shape[1], st.shape[2], spans):
            check_chain(torch, plan, gauss, o, st, dg, table)
        else:
            check_blur_chain(torch, o, st, dg, filters, spans, table)
        mo = detect.detect(dg, plan.sift_mode, plan.peak_threshold)
        require(torch.equal(mo, detect.detect_plain(dg, gate, border)),
                f"K3 mask at octave {o}: kernel != plain")
        c = ops_ext.compact_mask(mo, plan.cand_caps[o])
        if c.count > best[0]:
            best = (c.count, o, st, dg, c)
        octaves.append((o, st, dg))
        prev = st
    _, ob, stack, dog, cands = best
    w, h = plan.dims[ob]
    L = stack.shape[0]
    require(cands.count > 0, "no candidates in any octave")
    print(f"  K4-K6 at octave {ob} ({h}x{w}), {cands.count} candidates",
          flush=True)

    # K4, per candidate: the kernel against its plain version
    rp = ext.refine_params_for(plan, ob, dog.shape[0])
    cz = cands.z + 1
    kr = refine.refine(dog, cands.x, cands.y, cz, rp)
    pr = refine.refine_plain(dog, cands.x, cands.y, cz, rp,
                             return_iters=True)
    iters = int(pr[-1].sum())
    xn, yn, lpos, sig, cell, ok = kr
    pxn, pyn, plpos, psig, pcell, pok = pr[:-1]
    require(torch.equal(ok, pok), "K4 ok differs")
    require(torch.equal(lpos, plpos) and torch.equal(cell, pcell),
            "K4 lpos/cell differ")
    require(torch.equal(xn, pxn) and torch.equal(yn, pyn),
            "K4 xn/yn not bit-equal")
    s_ulps = ulps(sig, psig)
    print(f"  K4 sigma: {s_ulps} ulp; {int(ok.sum())} of {cands.count} "
          f"kept after {iters} slot-iterations", flush=True)
    require(s_ulps <= 2, f"K4 sigma differs by {s_ulps} ulp")
    cx, cy = cands.x, cands.y
    ms = kernel_ms(lambda: refine.refine(dog, cx, cy, cz, rp))
    pms = cuda_ms(lambda: refine.refine_plain(dog, cx, cy, cz, rp), reps=10)
    n = cands.count
    table.add("refine", f"K4 refine {n} candidates, per candidate",
              max(max_abs(xn, pxn), max_abs(yn, pyn), max_abs(sig, psig)),
              ms, pms, n * 12 + iters * 27 * 4 + n * 24,
              OPS_REFINE_ITER * iters, sub="per_candidate")
    cap = plan.ext_caps[ob]
    ex = check_refine_compact(torch, dog, cands, rp, cap, iters, table)

    # K5 on the octave's extrema: the histogram and the peaks
    field = grad.grad_field(stack)
    args5 = (field, ex.xpos, ex.ypos, ex.lpos, ex.sigma)
    ne = ex.count
    hk = torch.empty((ne, 36), dtype=torch.float32, device=dev)
    hk2 = torch.empty_like(hk)
    num, ang = binwin.ori_peaks(*args5, hist=hk)
    num2, ang2 = binwin.ori_peaks(*args5, hist=hk2)
    require(torch.equal(hk, hk2) and torch.equal(num, num2)
            and torch.equal(ang, ang2), "K5 is not deterministic")
    require(torch.equal(hk, binwin.ori_hist(*args5)),
            "K5: ori_hist differs from ori_peaks' histograms")
    pn, pa = binwin.peaks_from_hist(hk)
    require(torch.equal(num, pn) and torch.equal(ang, pa),
            "K5: num_ori or angles differ from peaks_from_hist of the "
            "kernel's own histograms")
    hp = binwin.ori_hist_plain(*args5)
    require(torch.allclose(hk, hp, rtol=1e-5, atol=1e-6),
            f"K5 histograms differ by {max_abs(hk, hp):.3g}")
    qn, qa = binwin.ori_peaks_plain(*args5)
    same = num == qn
    off = int((~same).sum())
    err = max(max_abs(hk, hp), max_abs(ang[same], qa[same]))
    print(f"  K5: num_ori and angles bit-equal to peaks_from_hist of its "
          f"own histograms and run to run; histograms within "
          f"{max_abs(hk, hp):.3g} of the plain version, whose peaks give "
          f"another num_ori on {off} of {ne} extrema (angles of the others "
          f"within {max_abs(ang[same], qa[same]):.3g})", flush=True)
    # the plain histograms sum in another order; a last-bit difference
    # decides a tie now and then
    require(off <= ne // 100 and max_abs(ang[same], qa[same]) <= 1e-4,
            "K5 orientations differ from the plain version's")
    check_peak_ties(torch, dev)
    ms = kernel_ms(lambda: binwin.ori_peaks(*args5))
    pms = cuda_ms(lambda: binwin.ori_peaks_plain(*args5), reps=10)
    work, union, _ = support_pixels(ex.xpos, ex.ypos, ex.lpos, ex.sigma, L,
                                    h, w)
    table.add("ori_hist", f"K5 ori_peaks {ne} extrema of octave {ob}", err,
              ms, pms, 8 * union + 16 * ne + 20 * ne,
              OPS_ORI_PIXEL * work + OPS_ORI_PEAKS * ne, sub="one_octave")
    a_ms = cuda_ms(lambda: ops_ori.assign_orientations(*args5))
    h_ms = cuda_ms(lambda: binwin.peaks_from_hist(binwin.ori_hist(*args5)))
    print(f"  assign_orientations at octave {ob}: {a_ms:.6f} ms (events); "
          f"K5's histograms and the plain peaks after them: {h_ms:.6f} ms",
          flush=True)

    # K6 on the octave's (extremum, orientation) rows
    num_ori, oris = ops_ori.assign_orientations(field, ex.xpos, ex.ypos,
                                                ex.lpos, ex.sigma)
    feat, ang, *_ = ext.descriptor_rows(plan, [ob], [ex.count], num_ori,
                                       oris)
    half = plan.desc_win // 2
    args6 = (field, ex.xpos[feat].contiguous(), ex.ypos[feat].contiguous(),
             ex.lpos[feat].contiguous(), ex.sigma[feat].contiguous(),
             ang.contiguous(), half)
    dk = binwin.desc_loop(*args6)
    dk2 = binwin.desc_loop(*args6)
    dp = binwin.desc_loop_plain(*args6)
    require(torch.equal(dk, dk2), "K6 is not deterministic")
    require(torch.allclose(dk, dp, rtol=1e-5, atol=1e-6),
            f"K6 descriptors differ by {max_abs(dk, dp):.3g}")
    ms = kernel_ms(lambda: binwin.desc_loop(*args6))
    pms = cuda_ms(lambda: binwin.desc_loop_plain(*args6), reps=10)
    nd = int(feat.shape[0])
    work, union, _ = support_pixels(*args6[1:5], L, h, w, ang=args6[5],
                                    half=half)
    table.add("desc_loop", f"K6 desc_loop {nd} rows of octave {ob}",
              max_abs(dk, dp), ms, pms, 8 * union + 20 * nd + 512 * nd,
              OPS_DESC_PIXEL * work, sub="one_octave")

    # K6 against K11 at octave 0, at this octave (timed here) and at the
    # octave whose keypoints have the largest sigma, where the descriptor's
    # support comes nearest the window's half and the image edge
    stack0, dog0 = octave0
    _, ex0 = ext.octave_keypoints(plan, 0, dog0)
    check_stack_kernels(torch, plan, 0, stack0, ex0, table, timed=False)
    check_stack_kernels(torch, plan, ob, stack, ex, table, timed=True)
    widest = None
    for o, st, dg in octaves:
        _, e = ext.octave_keypoints(plan, o, dg)
        if e.count and (widest is None
                        or float(e.sigma.max()) >= widest[0]):
            widest = (float(e.sigma.max()), o, st, e)
    sig, ow, st, e = widest
    R = int(binwin.desc_support(e.sigma, half).max())
    print(f"  largest sigma {sig:.4g} at octave {ow} ({st.shape[1]}x"
          f"{st.shape[2]}): support half-width up to {R} of the window's "
          f"{half}", flush=True)
    check_stack_kernels(torch, plan, ow, st, e, table, timed=False)

    check_windows_and_grid(torch, plan, stack, stack0, ob, args6[1:6],
                           table)
    check_table_launches(torch, pt, plan, img, table)
    check_blur_classes(torch, pt, scene, table, dev)
    for mode in ("opencv", "vlfeat"):
        check_mode_keypoints(torch, pt, scene, mode, table, dev)
    torch.cuda.synchronize()


def check_blur_classes(torch, pt, scene: np.ndarray, table: Table,
                       dev) -> None:
    """K1 at the halo classes no default path reaches, on octave 0 of the
    non-default pyramids (the same taps on both axes, x255, from the
    resampled input): class 4, Fixed9's abs_o0 level 1 (span 5), and class
    32, VLFeat-relative-all's abs_o0 level 5 (span 21, a 160 KB tile, one
    block per SM).  Bit for bit against the plain version, timed beside
    its bound and one cuDNN convolution of the edge-padded plane by the
    blur's 2-D kernel x255 (float32, TF32 off)."""
    from popsift_torch import extract as ext
    from popsift_torch.gauss import build_gauss_info
    from popsift_torch.kernels import blur
    from popsift_torch.ops import pyramid as ops_pyr

    h_in, w_in = scene.shape
    img = ext.to_unit_image(scene, dev)
    for gmode, lvl in (("fixed9", 1), ("vlfeat-direct", 5)):
        cfg = pt.Config()
        cfg.set_gauss_mode(gmode)
        plan = ext.make_plan(cfg, w_in, h_in)
        gauss = build_gauss_info(cfg)
        w, h = plan.dims[0]
        base = ops_pyr.resample_input(img, h, w, ops_pyr.apart_shift(
            plan.gauss_mode, plan.sift_mode,
            plan.upscale_factor)).contiguous()
        taps, span = gauss.abs_o0.filter[lvl], int(gauss.abs_o0.span[lvl])
        p_class = blur.halo_class(span)
        args = (taps, span, taps, span)
        k = blur.sep_blur(base, *args, hscale=255.0)
        p = blur.sep_blur_plain(base, *args, hscale=255.0)
        require(torch.equal(k, p), f"K1 class {p_class} (span {span}): "
                f"kernel != plain")
        ms = kernel_ms(lambda: blur.sep_blur(base, *args, hscale=255.0))
        pms = cuda_ms(lambda: blur.sep_blur_plain(base, *args, hscale=255.0),
                      reps=10)
        full = taps[:span][::-1].tolist() + taps[1:span].tolist()
        t2 = torch.as_tensor(np.outer(full, full) * 255.0,
                             dtype=torch.float32, device=dev)[None, None]
        padded = torch.nn.functional.pad(base[None, None], (span - 1,) * 4,
                                         mode="replicate")
        lib_ms = cuda_ms(lambda: torch.nn.functional.conv2d(padded, t2),
                         reps=5, warmup=1)
        lib_err = max_abs(torch.nn.functional.conv2d(padded, t2)[0, 0], k)
        print(f"  (cuDNN conv2d of the padded plane differs by "
              f"{lib_err:.6g})", flush=True)
        px = h * w
        table.add("sep_blur", f"K1 sep_blur halo class {p_class}: {gmode} "
                  f"abs_o0 level {lvl}, span {span} both axes, x255 "
                  f"({h}x{w})", max_abs(k, p), ms, pms, 8 * px,
                  OPS_BLUR_PER_TAP * 2 * span * px, library_ms=lib_ms,
                  sub=f"class{p_class}")


def check_mode_keypoints(torch, pt, scene: np.ndarray, mode: str,
                         table: Table, dev) -> None:
    """K3 and K4 (refine_compact) in the OpenCV or VLFeat SiftMode, on that
    mode's own DoG of its busiest octave: K3 bit for bit against its plain
    version; K4 bit for bit against compact_extrema of the per-candidate
    kernel, and against its plain version as phase 2's default check holds
    it (sigma within 2 ulp).  Timed as sub-rows of the two kernels."""
    from popsift_torch import extract as ext
    from popsift_torch.gauss import build_gauss_info
    from popsift_torch.kernels import detect, refine
    from popsift_torch.ops import extrema as ops_ext
    from popsift_torch.ops import pyramid as ops_pyr

    cfg = pt.Config(sift_mode=pt.SiftMode(mode))
    h_in, w_in = scene.shape
    plan = ext.make_plan(cfg, w_in, h_in)
    gauss = build_gauss_info(cfg)
    gate, border = detect.gate_for(plan.sift_mode, plan.peak_threshold)
    img = ext.to_unit_image(scene, dev)
    src, best = img, None
    for o in range(plan.octaves):
        _, src, dog, _ = ops_pyr.octave_outputs(
            src, o, plan.dims, plan.levels, gauss, plan.sift_mode,
            plan.upscale_factor, False, need_field=False, image=img)
        m = detect.detect(dog, plan.sift_mode, plan.peak_threshold)
        require(torch.equal(m, detect.detect_plain(dog, gate, border)),
                f"K3 ({mode}) at octave {o}: kernel != plain")
        c = ops_ext.compact_mask(m, plan.cand_caps[o])
        if best is None or c.count > best[0]:
            best = (c.count, o, dog, c)
    n, o, dog, cands = best
    w, h = plan.dims[o]
    px = h * w
    nl = dog.shape[0] - 2
    ms = kernel_ms(lambda: detect.detect(dog, plan.sift_mode,
                                         plan.peak_threshold))
    pms = cuda_ms(lambda: detect.detect_plain(dog, gate, border), reps=10)
    table.add("detect", f"K3 detect, {mode} mode, octave {o} "
              f"({dog.shape[0]},{h},{w}) -> {n} candidates; bit-equal at "
              f"every octave", 0.0, ms, pms, (4 * dog.shape[0] + nl) * px,
              OPS_DETECT * nl * px, sub=mode)

    rp = ext.refine_params_for(plan, o, dog.shape[0])
    cx, cy, cz = cands.x, cands.y, cands.z + 1
    kr = refine.refine(dog, cx, cy, cz, rp)
    iters = int(refine.refine_plain(dog, cx, cy, cz, rp,
                                    return_iters=True)[-1].sum())
    cap = plan.ext_caps[o]
    e = refine.refine_compact(dog, cands, rp, cap)
    q = ops_ext.compact_extrema(*kr, cap)
    p = refine.refine_compact_plain(dog, cands, rp, cap)
    for other, sig, what in ((q, 0, "compact_extrema of the per-candidate "
                              "kernel"), (p, 2, "its plain version")):
        require(e.count == other.count and e.overflow == other.overflow
                and all(torch.equal(getattr(e, k), getattr(other, k))
                        for k in ("xpos", "ypos", "lpos", "cell"))
                and ulps(e.sigma, other.sigma) <= sig,
                f"K4 ({mode}) compacted differs from {what}")
    require(e.count > 0, f"K4 ({mode}): no extrema at octave {o}")
    print(f"  K4 {mode} mode, octave {o}: {e.count} of {n} candidates kept "
          f"after {iters} slot-iterations; bit-equal to compact_extrema of "
          f"the per-candidate kernel, to the plain version but sigma "
          f"({ulps(e.sigma, p.sigma)} ulp)", flush=True)
    ms = kernel_ms(lambda: refine.refine_compact(dog, cands, rp, cap),
                   per_launch=2)
    pms = cuda_ms(lambda: refine.refine_compact_plain(dog, cands, rp, cap),
                  reps=10)
    table.add("refine", f"K4 refine_compact, {mode} mode, {n} candidates "
              f"-> {e.count} extrema (2 kernels)",
              max(max_abs(e.xpos, p.xpos), max_abs(e.ypos, p.ypos),
                  max_abs(e.sigma, p.sigma)), ms, pms,
              n * 12 + iters * 27 * 4 + 20 * e.count + 8,
              OPS_REFINE_ITER * iters, sub=mode)


def check_refine_compact(torch, dog, cands, rp, cap: int, iters: int,
                         table: Table):
    """K4 as the path calls it, refinement and compaction in one entry (two
    kernels): bit for bit against ops/extrema.py:compact_extrema of the
    per-candidate kernel's outputs and of the plain version's (sigma within
    the per-candidate check's 2 ulp), at the octave's capacity and at one
    small enough to overflow, and run to run; timed beside the parent's
    calls, refine then compact_extrema.  Returns the octave's extrema."""
    from popsift_torch.kernels import refine
    from popsift_torch.ops import extrema as ops_ext

    def equal(a, b, sigma_ulps=0):
        return (a.count == b.count and a.overflow == b.overflow
                and all(torch.equal(getattr(a, k), getattr(b, k))
                        for k in ("xpos", "ypos", "lpos", "cell"))
                and ulps(a.sigma, b.sigma) <= sigma_ulps)

    n = cands.count
    cx, cy, cz = cands.x, cands.y, cands.z + 1
    kr = refine.refine(dog, cx, cy, cz, rp)
    ex = refine.refine_compact(dog, cands, rp, cap)
    small = max(1, ex.count // 3)
    for c in (small, cap):
        e = refine.refine_compact(dog, cands, rp, c)
        require(equal(e, ops_ext.compact_extrema(*kr, c)),
                f"K4 compacted (cap {c}) differs from compact_extrema of "
                f"the per-candidate kernel")
        require(equal(e, refine.refine_compact(dog, cands, rp, c)),
                "K4 compacted is not deterministic")
        p = refine.refine_compact_plain(dog, cands, rp, c)
        require(equal(e, p, sigma_ulps=2),
                f"K4 compacted (cap {c}) differs from its plain version")
        print(f"  K4 compacted, cap {c}: {e.count} extrema, overflow "
              f"{e.overflow}; bit-equal to compact_extrema of the kernel's "
              f"and of the plain version's per-candidate outputs (sigma "
              f"{ulps(e.sigma, p.sigma)} ulp)", flush=True)
    require(small < ex.count, "K4: the small cap did not overflow")
    ms = kernel_ms(lambda: refine.refine_compact(dog, cands, rp, cap),
                   per_launch=2)
    pms = cuda_ms(lambda: refine.refine_compact_plain(dog, cands, rp, cap),
                  reps=10)
    parent = cuda_ms(lambda: ops_ext.compact_extrema(
        *refine.refine(dog, cx, cy, cz, rp), cap))
    print(f"  K4 refinement + compaction: {ms[0]:.6f} ms (events), device "
          f"{fmt_ms(ms[1])} ms in two kernels; refine then compact_extrema, "
          f"the parent's calls: {parent:.6f} ms (events)", flush=True)
    table.add("refine", f"K4 refine_compact {n} candidates -> {ex.count} "
              f"extrema (2 kernels)",
              max(max_abs(ex.xpos, p.xpos), max_abs(ex.ypos, p.ypos),
                  max_abs(ex.sigma, p.sigma)), ms, pms,
              n * 12 + iters * 27 * 4 + 20 * ex.count + 8,
              OPS_REFINE_ITER * iters)
    return ex


def tie_rich_histograms(torch) -> np.ndarray:
    """(n, 36) float32 orientation histograms whose peaks tie exactly:
    flat ones (no peak); two to five equal spikes, whose smoothed peaks are
    equal to the bit because each bin's arithmetic depends only on its
    neighbours' values (the lower bin wins); adjacent equal bins; a second
    peak exactly at 0.8 of the highest, and one float step below it (found
    with the plain version, whose arithmetic the card's repeats); and
    random histograms of four levels.  The plain version is
    popsift_torch.kernels.binwin.peak_candidates."""
    from popsift_torch.kernels.binwin import peak_candidates

    def spikes(pos, height, base=0.0):
        h = np.full(36, base, np.float32)
        h[list(pos)] = height
        return h

    rows = [np.full(36, c, np.float32) for c in (0.0, 1.0, 3.5, 1e-30)]
    for pos in ((3, 21), (0, 18), (35, 17), (5, 14, 23, 32),
                (1, 8, 15, 22, 29), (10, 11), (10, 11, 12), (0, 35)):
        rows += [spikes(pos, 2.0), spikes(pos, 0.7, base=0.1)]
    a = np.float32(2.0)
    steps = np.arange(-4096, 4097)
    b = (np.float32(0.8) * a).view(np.int32) + steps
    hist = np.zeros((steps.size, 36), np.float32)
    hist[:, 4] = a
    hist[:, 22] = b.astype(np.int32).view(np.float32)
    _, yval = peak_candidates(torch.as_tensor(hist))
    line = yval[:, 4] * 0.8
    below = torch.nextafter(line, torch.full_like(line, -np.inf))
    for hit in (yval[:, 22] == line, yval[:, 22] == below):
        idx = torch.nonzero(hit).reshape(-1)
        require(idx.numel() > 0, "no histogram with a peak at (or just "
                "below) 0.8 of the highest")
        rows.append(hist[int(idx[0])])
    rng = np.random.default_rng(17)
    rows += list((rng.integers(0, 4, (64, 36)) * 0.5).astype(np.float32))
    return np.stack(rows)


def check_peak_ties(torch, dev) -> None:
    """K5's epilogue on the tie-rich histograms, bit for bit against the
    plain version on the card and on the CPU."""
    from popsift_torch.kernels import binwin

    h = tie_rich_histograms(torch)
    num, ang = binwin.peaks_of_hist(torch.as_tensor(h, device=dev))
    pn, pa = binwin.peaks_from_hist(torch.as_tensor(h, device=dev))
    cn, ca = binwin.peaks_from_hist(torch.as_tensor(h))
    require(torch.equal(num, pn) and torch.equal(ang, pa)
            and torch.equal(num.cpu(), cn) and torch.equal(ang.cpu(), ca),
            "K5's epilogue differs from the plain version on tie-rich "
            "histograms")
    print(f"  K5's epilogue on {h.shape[0]} tie-rich histograms: bit-equal "
          f"to the plain version on the card and on the CPU (num_ori "
          f"{np.bincount(num.cpu().numpy(), minlength=5).tolist()} for "
          f"0-4)", flush=True)


def digest(t) -> str:
    """The first 16 hex digits of the sha256 of a tensor's bytes."""
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def check_blur_chain(torch, o, stack, dog, filters, spans, table: Table,
                     timed: bool = True) -> str:
    """K1's chain entry on octave ``o`` (``stack`` and ``dog`` are what the
    path's per-level form computed from the same level 0): bit for bit
    against its plain version, K1's plain version per level, with and
    without the field; the field bit for bit against K2 on the entry's
    own stack (equal digests), its mag equal to the plain field and its
    theta within 2 ulp (K2's own check), and the entry bit-identical run
    to run.  With ``timed``, the entry is timed with the field, without it
    and without it followed by K2 (the form it replaces); the first such
    octave gives the table's row.  Returns the field's digest."""
    from popsift_torch.kernels import blur, grad

    L, h, w = stack.shape
    lvl0 = stack[0].contiguous()
    ps, pd = blur.blur_chain_plain(lvl0, filters, spans)
    ks, kd = blur.blur_chain(lvl0, filters, spans)
    require(torch.equal(ks, ps) and torch.equal(kd, pd)
            and torch.equal(stack, ps) and torch.equal(dog, pd),
            f"K1 chain entry at octave {o}: kernel != plain")
    fs, fd, ff = blur.blur_chain(lvl0, filters, spans, emit_field=True)
    require(torch.equal(fs, ks) and torch.equal(fd, kd),
            f"K1 chain entry at octave {o}: the stack or DoG differ with "
            f"the field")
    k2 = grad.grad_field(fs)
    d_field, d_k2 = digest(ff), digest(k2)
    require(torch.equal(ff, k2) and d_field == d_k2,
            f"K1 chain entry's field at octave {o} differs from K2 on its "
            f"stack (sha256 {d_field} against {d_k2})")
    pf = grad.grad_field_plain(ps)
    require(torch.equal(ff[0::2], pf[0::2]),
            f"K1 chain entry's mag at octave {o}: kernel != plain")
    th_ulps = ulps(ff[1::2], pf[1::2])
    require(th_ulps <= 2, f"K1 chain entry's theta at octave {o} differs "
            f"from the plain field by {th_ulps} ulp")
    again = blur.blur_chain(lvl0, filters, spans, emit_field=True)
    require(all(torch.equal(a, b) for a, b in zip(again, (fs, fd, ff))),
            f"K1 chain entry at octave {o}: not bit-identical run to run")
    if not timed:
        return d_field
    err = max(max_abs(ks, ps), max_abs(kd, pd), max_abs(ff, pf))
    blocks, rows = blur.chain_bands(h)
    print(f"  K1 chain entry at octave {o} ({h}x{w}, {blocks} blocks of "
          f"{rows} rows): stack and DoG bit-equal to K1's plain version per "
          f"level, with and without the field; field bit-equal to K2 on "
          f"its stack (sha256 {d_field}), theta {th_ulps} ulp from the plain "
          f"field; bit-identical run to run", flush=True)
    ms = kernel_ms(lambda: blur.blur_chain(lvl0, filters, spans,
                                           emit_field=True))
    alone = kernel_ms(lambda: blur.blur_chain(lvl0, filters, spans))
    then_k2 = kernel_ms(lambda: grad.grad_field(
        blur.blur_chain(lvl0, filters, spans)[0]))
    print(f"    with the field {ms[0]:.6f} ms, device {fmt_ms(ms[1])}; "
          f"without {alone[0]:.6f}, device {fmt_ms(alone[1])}; without, "
          f"then K2 {then_k2[0]:.6f}, device {fmt_ms(then_k2[1])}",
          flush=True)
    if "blur_chain" in table.rows:
        return d_field
    px = h * w
    pms = cuda_ms(lambda: blur.blur_chain_plain(lvl0, filters, spans,
                                                emit_field=True), reps=10)
    table.add("blur_chain", f"K1 blur_chain octave {o} ({L},{h},{w}) with "
              f"the field, spans {spans[1:]}", err, ms, pms,
              4 * px * (1 + 2 * (L - 1)) + 8 * px * L,
              sum(OPS_BLUR_PER_TAP * 2 * s + 1 for s in spans[1:]) * px
              + OPS_GRAD * L * px)
    return d_field


def check_chain_fields(torch, pt, scenes, dev) -> None:
    """K1's chain entry, with the field, on the octaves it takes of every
    scene but the first, which check_kernels checked (check_blur_chain
    untimed)."""
    from popsift_torch import extract as ext
    from popsift_torch.gauss import build_gauss_info
    from popsift_torch.ops import pyramid as ops_pyr

    cfg = pt.Config()
    gauss = build_gauss_info(cfg)
    for seed in range(1, len(scenes)):
        scene = scenes[seed]
        h_in, w_in = scene.shape
        plan = ext.make_plan(cfg, w_in, h_in)
        filters, spans = ops_pyr.chain_filters(gauss, plan.levels)
        src = ext.to_unit_image(scene, dev)
        digests = {}
        for o in range(plan.octaves):
            st, dg = ops_pyr.build_octave(src, o, plan.dims, plan.levels,
                                          gauss, plan.sift_mode,
                                          plan.upscale_factor)
            if not ops_pyr.chain_eligible(st.shape[1], st.shape[2], spans):
                digests[o] = check_blur_chain(torch, o, st, dg, filters,
                                              spans, None, timed=False)
            src = st
        require(bool(digests), f"scene {seed}: no octave took K1's chain")
        print(f"  scene {seed}: K1's chain entry at octaves "
              f"{min(digests)}-{max(digests)}: stack and DoG bit-equal to "
              f"the plain chain, field bit-equal to K2 on its stack and run "
              f"to run; sha256 "
              + ", ".join(digests.values()), flush=True)


def tie_rich_dog(torch, shape, seed, dev):
    """A DoG of values quantised to nine levels, with plateaus and signed
    zeros: every comparison of the extremum test meets exact ties."""
    rng = np.random.default_rng(seed)
    d = (rng.integers(-4, 5, shape) * 1.0).astype(np.float32)
    for _ in range(shape[1] * shape[2] // 40):
        p, y, x = (int(rng.integers(0, n)) for n in shape)
        d[p, y:y + 3, x:x + 4] = rng.integers(-4, 5)
    zeros = rng.random(shape) < 0.1
    d[zeros] = np.where(rng.random(int(zeros.sum())) < 0.5, -0.0, 0.0)
    return torch.as_tensor(d, device=dev)


def check_detect_ties(torch, plan, dev) -> None:
    """K3 bit for bit against its plain version on tie-rich DoGs, one with
    aligned rows and one without."""
    from popsift_torch.kernels import detect

    gate, border = detect.gate_for(plan.sift_mode, plan.peak_threshold)
    for shape in ((5, 540, 960), (5, 517, 1001)):
        d = tie_rich_dog(torch, shape, 5, dev)
        m = detect.detect(d, plan.sift_mode, plan.peak_threshold)
        mp = detect.detect_plain(d, gate, border)
        require(torch.equal(m, mp), f"K3 on a tie-rich DoG {shape}: kernel "
                f"!= plain")
        print(f"  K3 on a tie-rich DoG {shape}: bit-equal to its plain "
              f"version ({int(mp.sum())} extrema)", flush=True)


def check_budget_masks(torch, pt, scenes, dev) -> None:
    """The octave-2 masks of scenes 0-2, whose candidates the compaction
    budget trims, are the ones tests/test_torch_detect.py holds the
    port's compaction to the JAX package's on."""
    from popsift_torch import extract as ext
    from popsift_torch.gauss import build_gauss_info
    from popsift_torch.kernels import detect
    from popsift_torch.ops import pyramid as ops_pyr

    stored = np.load(BUDGET_MASKS)
    cfg = pt.Config()
    h, w = scenes[0].shape
    plan = ext.make_plan(cfg, w, h)
    gauss = build_gauss_info(cfg)
    for seed in range(3):
        src = ext.to_unit_image(scenes[seed], dev)
        for o in range(3):
            _, src, dog, _ = ops_pyr.octave_outputs(
                src, o, plan.dims, plan.levels, gauss, plan.sift_mode,
                plan.upscale_factor, full_stack=False)
        m = detect.detect(dog, plan.sift_mode, plan.peak_threshold)
        flat = torch.nonzero(m.reshape(-1)).reshape(-1).cpu().numpy()
        require(np.array_equal(flat, stored[f"s{seed}_o2"]),
                f"scene {seed}'s octave-2 mask differs from {BUDGET_MASKS}")
    print(f"  octave-2 masks of scenes 0-2 as in {BUDGET_MASKS.name}",
          flush=True)


def support_pixels(xs, ys, lpos, sigma, L, h, w, ang=None, half=0):
    """The pixels that K5/K10 (``ang`` None: the orientation disc
    int(dx^2 + dy^2) <= round(4.5 sigma)^2, s_orientation.cu:142) or
    K6/K11 (the rotated square |u|_inf < 2.5 in SBP units, outside which
    every tile weight is zero, s_desc_loop.cu:87-139) need, in the 1-pixel
    interior of each slot's level.  The kernels walk the bounding box and
    skip the rest; a bound counts only these.  Returns (pixels summed over
    the slots: the binning work; distinct pixels: the field pixels K5/K6
    read; distinct horizontal or vertical neighbours of those pixels: the
    stack pixels whose central differences K10/K11 take)."""
    import torch
    from popsift_torch.kernels import binwin
    dev = xs.device
    if ang is None:
        R = torch.round(3.0 * (1.5 * sigma)).long()
    else:
        R = binwin.desc_support(sigma, half)
    rx, ry = torch.round(xs).long(), torch.round(ys).long()
    lp = lpos.long().clamp(0, L - 1)
    need = torch.zeros((L, h, w), dtype=torch.bool, device=dev)
    nbr = torch.zeros_like(need)
    work = 0
    order = torch.argsort(R)
    for start in range(0, order.numel(), 256):
        e = order[start:start + 256]
        offs = torch.arange(-int(R[e].max()), int(R[e].max()) + 1,
                            device=dev)
        jj, ii = rx[e, None] + offs, ry[e, None] + offs
        inbox = offs.abs()[None, :] <= R[e, None]
        ok = ((inbox & (jj >= 1) & (jj <= w - 2))[:, None, :]
              & (inbox & (ii >= 1) & (ii <= h - 2))[:, :, None])
        dxf = (jj.float() - xs[e, None])[:, None, :]
        dyf = (ii.float() - ys[e, None])[:, :, None]
        if ang is None:
            r2 = (R[e] * R[e])[:, None, None]
            ok &= (dxf * dxf + dyf * dyf).int() <= r2
        else:
            sbp = (3.0 * sigma[e]).abs()[:, None, None]
            cos_t = torch.cos(ang[e])[:, None, None]
            sin_t = torch.sin(ang[e])[:, None, None]
            ux = (cos_t * dxf + sin_t * dyf) / sbp
            uy = (cos_t * dyf - sin_t * dxf) / sbp
            ok &= (sbp > 0) & (ux.abs() < 2.5) & (uy.abs() < 2.5)
        work += int(ok.sum())
        k, a, b = ok.nonzero(as_tuple=True)
        lv, y, x = lp[e][k], ii[k, a], jj[k, b]
        need[lv, y, x] = True
        for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
            nbr[lv, y + dy, x + dx] = True
    return work, int(need.sum()), int(nbr.sum())


def check_stack_kernels(torch, plan, o, stack, ex, table: Table,
                        timed: bool) -> None:
    """K10 and K11 on octave ``o``'s extrema and descriptor rows: bit for
    bit against K5 and K6 on K2's field of the same stack, run to run,
    and against their plain versions (K5's and K6's tolerances)."""
    from popsift_torch import extract as ext
    from popsift_torch.kernels import binwin, grad

    L, h, w = stack.shape
    field = grad.grad_field(stack)
    a10 = (stack, ex.xpos, ex.ypos, ex.lpos, ex.sigma)
    hk, h5, hk2 = (torch.empty((ex.count, 36), dtype=torch.float32,
                               device=stack.device) for _ in range(3))
    num_ori, oris = binwin.ori_peaks_stack(*a10, hist=hk)
    n5, o5 = binwin.ori_peaks(field, *a10[1:], hist=h5)
    require(torch.equal(hk, h5) and torch.equal(num_ori, n5)
            and torch.equal(oris, o5),
            f"K10 differs from K5 on K2's field at octave {o}")
    n2, o2 = binwin.ori_peaks_stack(*a10, hist=hk2)
    require(torch.equal(hk, hk2) and torch.equal(num_ori, n2)
            and torch.equal(oris, o2), "K10 is not deterministic")
    pn, po = binwin.peaks_from_hist(hk)
    require(torch.equal(num_ori, pn) and torch.equal(oris, po),
            f"K10: num_ori or angles differ from peaks_from_hist of its own "
            f"histograms at octave {o}")
    hp = binwin.ori_hist_stack_plain(*a10)
    require(torch.allclose(hk, hp, rtol=1e-5, atol=1e-6),
            f"K10 histograms differ by {max_abs(hk, hp):.3g}")
    feat, ang, *_ = ext.descriptor_rows(plan, [o], [ex.count], num_ori, oris)
    half = plan.desc_win // 2
    rows = tuple(v[feat].contiguous() for v in a10[1:]) + (ang.contiguous(),)
    dk = binwin.desc_loop_stack(stack, *rows, half)
    d6 = binwin.desc_loop(field, *rows, half)
    require(torch.equal(dk, d6),
            f"K11 differs from K6 on K2's field at octave {o}")
    require(torch.equal(d6, binwin.desc_loop(field, *rows, half)),
            f"K6 is not deterministic at octave {o}")
    require(torch.equal(dk, binwin.desc_loop_stack(stack, *rows, half)),
            "K11 is not deterministic")
    dp = binwin.desc_loop_stack_plain(stack, *rows, half)
    require(torch.allclose(dk, dp, rtol=1e-5, atol=1e-6),
            f"K11 descriptors differ by {max_abs(dk, dp):.3g}")
    d6p = binwin.desc_loop_plain(field, *rows, half)
    require(torch.allclose(d6, d6p, rtol=1e-5, atol=1e-6),
            f"K6 descriptors differ by {max_abs(d6, d6p):.3g} at octave {o}")
    ne, nd = ex.count, int(feat.shape[0])
    print(f"  K10/K11 at octave {o} ({h}x{w}): {ne} extrema, {nd} rows; "
          f"bit-equal to K5/K6 on K2's field and run to run; within "
          f"{max_abs(hk, hp):.3g} / {max_abs(dk, dp):.3g} of their plain "
          f"versions", flush=True)
    if not timed:
        return
    work, _, nbr = support_pixels(*a10[1:], L, h, w)
    ms = kernel_ms(lambda: binwin.ori_peaks_stack(*a10))
    pms = cuda_ms(lambda: binwin.ori_peaks_stack_plain(*a10), reps=10)
    table.add("ori_hist_stack", f"K10 ori_peaks_stack {ne} extrema of "
              f"octave {o}", max_abs(hk, hp), ms, pms,
              4 * nbr + 16 * ne + 20 * ne,
              (OPS_ORI_PIXEL + OPS_GRAD) * work + OPS_ORI_PEAKS * ne,
              sub="one_octave")
    work, _, nbr = support_pixels(*rows[:4], L, h, w, ang=rows[4],
                                  half=half)
    ms = kernel_ms(lambda: binwin.desc_loop_stack(stack, *rows, half))
    pms = cuda_ms(lambda: binwin.desc_loop_stack_plain(stack, *rows, half),
                  reps=10)
    table.add("desc_loop_stack", f"K11 desc_loop_stack {nd} rows of "
              f"octave {o}", max_abs(dk, dp), ms, pms,
              4 * nbr + 20 * nd + 512 * nd,
              (OPS_DESC_PIXEL + OPS_GRAD) * work, sub="one_octave")

    def field_path():
        f = grad.grad_field(stack)
        binwin.ori_peaks(f, *a10[1:])
        binwin.desc_loop(f, *rows, half)

    def stack_path():
        binwin.ori_peaks_stack(*a10)
        binwin.desc_loop_stack(stack, *rows, half)
    print(f"  K2 + K5 + K6 on this octave: {cuda_ms(field_path):.6f} ms; "
          f"K10 + K11: {cuda_ms(stack_path):.6f} ms", flush=True)


def check_chain(torch, plan, gauss, o, stack, dog, table: Table) -> None:
    """K7 on octave ``o`` in both emit modes, bit for bit against K1 per
    level plus K2 (``stack`` and ``dog`` were built by K1 from the same
    level 0) and against its plain version, and timed (the table's row at
    octave 0)."""
    from popsift_torch.kernels import grad, octave
    from popsift_torch.ops import pyramid as ops_pyr

    L, h, w = stack.shape
    px = h * w
    lvl0 = stack[0]
    filters, spans = ops_pyr.chain_filters(gauss, plan.levels)
    keep = (L - ops_pyr.PREV_LEVEL,)
    field = grad.grad_field(stack)
    chosen = octave.chain_plan(h, w, spans)
    print(f"  K7 at octave {o} ({h}x{w}): strip {chosen.strip}, segment "
          f"{chosen.seg} rows, {chosen.smem} B of shared memory, "
          f"{-(-w // chosen.strip) * -(-h // chosen.seg)} blocks",
          flush=True)
    blur_ops = sum(OPS_BLUR_PER_TAP * 2 * s + 1 for s in spans[1:]) * px
    for emit_stack in (True, False):
        out = octave.octave_chain(lvl0, filters, spans, emit_stack, keep)
        ks, kd, kf = out
        ref_stack = stack if emit_stack else stack[list(keep)]
        form = "full stack" if emit_stack else f"level {keep[0]} only"
        require(torch.equal(ks, ref_stack) and torch.equal(kd, dog),
                f"K7 ({form}, octave {o}): levels or DoG differ from K1 per "
                f"level")
        require(torch.equal(kf[0::2], field[0::2]),
                f"K7 ({form}, octave {o}): mag differs from K2")
        th_ulps = ulps(kf[1::2], field[1::2])
        print(f"  K7 ({form}): levels, DoG and mag bit-equal to K1 per level "
              f"plus K2; theta {th_ulps} ulp", flush=True)
        require(th_ulps == 0, f"K7 theta differs from K2 by {th_ulps} ulp "
                f"at octave {o}")
        ps, pd, pf = octave.octave_chain_plain(lvl0, filters, spans,
                                               emit_stack, keep)
        err = max(max_abs(ks, ps), max_abs(kd, pd), max_abs(kf, pf))
        p_ulps = ulps(kf[1::2], pf[1::2])
        require(torch.equal(ks, ps) and torch.equal(kd, pd)
                and torch.equal(kf[0::2], pf[0::2]) and p_ulps <= 2,
                f"K7 ({form}, octave {o}) differs from its plain version")
        if o:
            continue
        ms = kernel_ms(lambda: octave.octave_chain(lvl0, filters, spans,
                                                   emit_stack, keep))
        pms = cuda_ms(lambda: octave.octave_chain_plain(
            lvl0, filters, spans, emit_stack, keep), reps=10)
        n_out = ks.shape[0] + (L - 1) + 2 * L
        table.add("octave_chain", f"K7 octave_chain ({form}, {h}x{w}, spans "
                  f"{spans[1:]}), plain theta {p_ulps} ulp", err, ms, pms,
                  4 * px * (1 + n_out), blur_ops + OPS_GRAD * L * px,
                  sub="full_stack" if emit_stack else None)
    if o:
        # the other chain octaves: the planner's blocks timed, level kept
        t, dt = kernel_ms(lambda: octave.octave_chain(lvl0, filters, spans,
                                                      False, keep))
        print(f"  K7 (level {keep[0]} only) at octave {o}: {t:.6f} ms, "
              f"device {fmt_ms(dt)} ms", flush=True)
        return

    def per_level():
        st, _ = ops_pyr.per_level_chain(lvl0, plan.levels, gauss)
        grad.grad_field(st)
    print(f"  (K1 per level plus K2 on the same level 0: "
          f"{cuda_ms(per_level, reps=10):.6f} ms)", flush=True)


def window_index(torch, plane, lps, oy, ox, wy: int, wx: int):
    """The index tensors of one advanced-indexing call, ``plane[li, yi,
    xi]``, that gathers K8's windows with clamped addressing."""
    _, h, w = plane.shape
    dev = plane.device
    li = lps.long()[:, None, None]
    yi = (oy.long()[:, None] + torch.arange(wy, device=dev)
          ).clamp(0, h - 1)[:, :, None]
    xi = (ox.long()[:, None] + torch.arange(wx, device=dev)
          ).clamp(0, w - 1)[:, None, :]
    return li, yi, xi


def gather_bytes(plane, lps, oy, ox, wy: int, wx: int) -> int:
    """K8's compulsory bytes: each distinct plane pixel that its clamped
    windows read, once, each window pixel written once, the three
    origins."""
    L, h, w = plane.shape
    n = int(lps.shape[0])
    union = box_union_pixels(
        lps, ox.clamp(0, w - 1), (ox + wx - 1).clamp(0, w - 1),
        oy.clamp(0, h - 1), (oy + wy - 1).clamp(0, h - 1), L, h, w)
    return 4 * union + 4 * n * wy * wx + 12 * n


def window_branches(torch, plane, lps, oy, ox, wy: int, wx: int) -> dict:
    """How the items of csrc/windows.cu (bands of ITEM_ROWS rows by chunks
    of ITEM_COLS columns of a window) split over its branches for these
    origins: rows of items inside the plane by the 16-byte shift of their
    first column (0-3), items on the clamped path across an edge or wholly
    outside, inside items narrower than a warp's chunk, and items of rows
    whose width is not a multiple of 4 (clamped path, 4-byte stores)."""
    from popsift_torch.kernels import windows
    R, C = windows.ITEM_ROWS, windows.ITEM_COLS
    L, H, W = plane.shape
    dev = plane.device
    b = torch.arange(-(-wy // R), device=dev)
    c = torch.arange(-(-wx // C), device=dev)
    y0 = oy.long()[:, None, None] + R * b[None, :, None]
    x0 = ox.long()[:, None, None] + C * c[None, None, :]
    nr = (wy - R * b).clamp(max=R)[None, :, None]
    nc = (wx - C * c).clamp(max=C)[None, None, :]
    vec = wx % 4 == 0
    inside = (y0 >= 0) & (y0 + nr <= H) & (x0 >= 0) & (x0 + nc <= W) & vec
    outside = (y0 + nr <= 0) | (y0 >= H) | (x0 + nc <= 0) | (x0 >= W)
    items = torch.ones_like(inside)
    k = torch.arange(R, device=dev)
    first = (plane.data_ptr() // 4 + lps.long()[:, None, None, None] * H * W
             + (y0[..., None] + k) * W + x0[..., None])
    row = (inside[..., None] & (k < nr[..., None])).expand(first.shape)
    out = {f"inside rows, shift {s}": int((row & (first % 4 == s)).sum())
           for s in range(4)}
    out["clamped items across an edge"] = int((~inside & ~outside & vec)
                                              .sum())
    out["clamped items wholly outside"] = int((outside & vec).sum())
    out["inside items narrower than a chunk"] = int(
        (inside & (nc < C)).expand(items.shape).sum())
    out["items of 4-byte stores"] = 0 if vec else int(items.sum())
    return out


def branch_origins(torch, L: int, H: int, W: int, wy: int, wx: int, n: int,
                   seed: int, dev):
    """``n`` window origins (level, y, x) for K8: every pairing of rows
    and columns inside the plane, across each edge and corner, and wholly
    outside it, shuffled, then random origins inside; every fifth at the
    last level."""
    rng = np.random.default_rng(seed)
    ys = [-1000, -wy - 5, -(wy // 2), -1, 0, 1, 2, 3, H - wy, H - wy // 2,
          H - 1, H + 3]
    xs = [-1000, -wx - 9, -(wx // 2), -1, 0, 1, 2, 3, W - wx, W - wx + 1,
          W - wx // 2, W - 1, W + 1]
    pairs = np.array([(y, x) for y in ys for x in xs])[
        rng.permutation(len(ys) * len(xs))]
    y = rng.integers(0, max(H - wy, 0) + 1, n)
    x = rng.integers(0, max(W - wx, 0) + 1, n)
    m = min(n, len(pairs))
    y[:m], x[:m] = pairs[:m, 0], pairs[:m, 1]
    lp = rng.integers(0, L, n)
    lp[::5] = L - 1
    return tuple(torch.as_tensor(v.astype(np.int32), device=dev)
                 for v in (lp, y, x))


def check_window_branches(torch, planes, win: int) -> None:
    """K8 bit for bit against its plain version and against one
    advanced-indexing call on origins that reach every branch of its
    kernel (:func:`window_branches`), on each of ``planes`` and on a
    3x67x301 plane whose base lies 4 bytes past a 16-byte boundary (rows
    of every shift): the two call shapes through their wrappers, and
    gather_windows at other widths (win 120's rows, a 384-column aligned
    window, a partial second chunk, 7 columns), for 0, 1, 37 and 2311
    (prime) rows."""
    from popsift_torch.kernels import windows
    dev = planes[0].device
    gen = torch.Generator(device=dev).manual_seed(0)
    odd = torch.rand(1 + 3 * 67 * 301, generator=gen, device=dev)[1:] \
        .view(3, 67, 301)
    shapes = (windows.rolled_window_dims(win), windows.aligned_window_dims(win),
              windows.rolled_window_dims(120), (120, 384), (56, 200), (9, 7))
    total: dict = {}
    for pi, plane in enumerate((*planes, odd)):
        L, H, W = plane.shape
        for si, (wy, wx) in enumerate(shapes):
            for n in (0, 1, 37, 2311):
                lp, oy, ox = branch_origins(torch, L, H, W, wy, wx, n,
                                            100 * pi + 10 * si + n, dev)
                k = windows.gather_windows(plane, lp, oy, ox, wy, wx)
                p = windows.gather_windows_plain(plane, lp, oy, ox, wy, wx)
                require(k.shape == (n, wy, wx) and torch.equal(k, p),
                        f"K8 ({wy}x{wx}, {n} rows, plane {H}x{W}): kernel "
                        f"!= plain on the branch origins")
                if n:
                    require(torch.equal(k, plane[window_index(
                        torch, plane, lp, oy, ox, wy, wx)]),
                        f"K8 ({wy}x{wx}, {n} rows, plane {H}x{W}): "
                        f"advanced indexing differs")
                for key, v in window_branches(torch, plane, lp, oy, ox, wy,
                                              wx).items():
                    total[key] = total.get(key, 0) + v
        lp, oy, ox = branch_origins(torch, L, H, W, 120, 128, 2311, pi, dev)
        for form, call in (("exact", windows.gather_windows_exact),
                           ("aligned", windows.gather_windows_aligned)):
            k, *org = call(plane, lp, oy, ox, win)
            ya, xa = (org[0], ox) if form == "exact" else org
            wy, wx = k.shape[1:]
            require(torch.equal(k, windows.gather_windows_plain(
                plane, lp, ya, xa, wy, wx)) and torch.equal(
                k, plane[window_index(torch, plane, lp, ya, xa, wy, wx)]),
                f"K8 ({form}, plane {H}x{W}): kernel != plain on the "
                f"branch origins")
    try:
        windows.gather_windows(planes[0], lp[:2], lp, lp, 8, 8)
    except ValueError:
        pass
    else:
        raise AssertionError("K8 took origin vectors of unequal lengths")
    print("  K8 on the branch origins, bit-equal to its plain version and "
          "to advanced indexing: " + ", ".join(f"{k} {v}" for k, v in
                                               total.items()), flush=True)
    require(all(total.values()), "K8: the branch origins missed a branch")


def check_windows_and_grid(torch, plan, stack, stack0, ob: int, rows,
                           table: Table) -> None:
    """K8, which no path launches since K9, K12 and K13 read its windows
    from the stack, on origins that reach every branch of its kernel, and
    in both call shapes on the descriptor rows of the busiest octave
    ``ob`` (``stack``) and on the same rows at octave 0's scale
    (``stack0``, which does not fit in L2); then K9, K12 and K13 on those
    rows, as the NoTile path gives them."""
    from popsift_torch.kernels import windows

    xs, ys, lps, sg, an = rows
    win = plan.desc_win
    n = int(xs.shape[0])
    check_window_branches(torch, (stack, stack0), win)
    for st, scale, tag, subs in (
            (stack0, 2 ** ob, "octave 0", ("exact_octave0", "aligned_octave0")),
            (stack, 1, f"octave {ob}", (None, "aligned"))):
        L, h, w = st.shape
        lp = lps.clamp(0, L - 1).to(torch.int32)
        x0 = torch.round(xs * scale).to(torch.int32) - win // 2
        y0 = torch.round(ys * scale).to(torch.int32) - win // 2
        wk, ya = windows.gather_windows_exact(st, lp, y0, x0, win)
        aw, aya, axa = windows.gather_windows_aligned(st, lp, y0, x0, win)
        for sub, oy, ox, k in ((subs[1], aya, axa, aw),
                               (subs[0], ya, x0, wk)):
            wy, wx = k.shape[1:]
            form = "aligned" if k is aw else "exact"
            p = windows.gather_windows_plain(st, lp, oy, ox, wy, wx)
            require(torch.equal(k, p), f"K8 ({form}, {tag}): kernel != "
                    f"plain")
            ms = kernel_ms(lambda: windows.gather_windows(st, lp, oy, ox, wy,
                                                          wx))
            pms = cuda_ms(lambda: windows.gather_windows_plain(
                st, lp, oy, ox, wy, wx), reps=10)
            # the library yardstick: one advanced-indexing call, its index
            # tensors built outside the timed region
            idx = window_index(torch, st, lp, oy, ox, wy, wx)
            require(torch.equal(st[idx], k),
                    f"K8 ({form}, {tag}): advanced indexing differs")
            lib_ms = cuda_ms(lambda: st[idx])
            nbytes = gather_bytes(st, lp, oy, ox, wy, wx)
            table.add("gather_windows", f"K8 gather_windows ({form}, {tag} "
                      f"{h}x{w}) {n} x ({wy},{wx})", max_abs(k, p), ms, pms,
                      nbytes, 0, library_ms=lib_ms, sub=sub)
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            share = ("not measured" if ms[1] is None
                     else f"{100.0 * bound / ms[1]:.1f}%")
            print(f"  K8 ({form}, {tag}): {share} of its bound on the device "
                  f"({100.0 * bound / ms[0]:.1f}% by events)", flush=True)

    nbytes = footprint_bytes(stack, rows, win)
    check_stack_descriptors(torch, plan, stack, rows, nbytes, table)


def staged_boxes(xs, ys, sg, an, win: int):
    """Each row's footprint as K9/K12/K13 stage it (footprint_box one pixel
    wider on each side) and its pixels."""
    from popsift_torch.kernels import desc_grid
    half = desc_grid.footprint_half(sg, an) + 1
    box = desc_grid.footprint_box(xs, ys, sg, an, win, half=half)
    return box, (box[1] - box[0] + 1) * (box[3] - box[2] + 1)


def footprint_bytes(stack, rows, win: int, say: bool = True) -> int:
    """The compulsory bytes of a descriptor kernel that reads the stack
    (K9, K12, K13) on ``rows``: the distinct stack pixels that the rows'
    footprint boxes (without the kernels' one-pixel slack) cover, the five
    inputs and the outputs.  With ``say`` it prints the staged footprints'
    sizes and the rows whose footprint exceeds the staging capacity."""
    from popsift_torch.kernels import desc_grid, windows

    xs, ys, lps, sg, an = rows
    L, h, w = stack.shape
    n = int(xs.shape[0])
    if say:
        _, pix = staged_boxes(xs, ys, sg, an, win)
        over = int((pix > desc_grid.STAGE_FLOATS).sum())
        print(f"  K9/K12/K13 footprints of {n} rows: {int(pix.min())}-"
              f"{int(pix.max())} px staged (median {int(pix.median())}); "
              f"{over} rows ({100.0 * over / max(n, 1):.2f}%) exceed the "
              f"staging capacity of {desc_grid.STAGE_FLOATS} px",
              flush=True)
    x0, ya = windows.window_origins(xs, ys, win)
    tb = desc_grid.footprint_box(xs, ys, sg, an, win)
    union = box_union_pixels(
        lps.clamp(0, L - 1), (x0 + tb[0]).clamp(0, w - 1),
        (x0 + tb[1]).clamp(0, w - 1), (ya + tb[2]).clamp(0, h - 1),
        (ya + tb[3]).clamp(0, h - 1), L, h, w)
    return 4 * union + 4 * 5 * n + 512 * n


def check_stack_descriptors(torch, plan, stack, rows, nbytes: int,
                            table: Table) -> None:
    """K9, K12 and K13 on the descriptor rows of one octave, read from the
    stack: against K8's plain windows and the window forms, run to run,
    and with every row read through L2 (``stage=0``, which is also the
    design without staging, timed beside the staged one); K9's sha256.
    ``nbytes``: their compulsory bytes (:func:`footprint_bytes`)."""
    from popsift_torch.constants import desc_tables_on
    from popsift_torch.kernels import desc_grid

    xs, ys, lps, sg, an = rows
    win = plan.desc_win
    n = int(xs.shape[0])
    # the samples this run's rows need: NoTile's whole 40x40 grid, Grid's
    # rounded points with a non-negative triangle weight, ILoop's list, in
    # each of 16 tiles
    good = int(desc_grid.grid_rounded_points(xs, ys, sg, an)[4].sum())
    listed = 16 * int(desc_grid.iloop_sample_list(sg, an)[1].sum())
    print(f"  samples that carry weight: Grid {good} of {n * 16 * 256}, "
          f"ILoop {listed} of {n * 16 * 1024}", flush=True)
    gauss_t, tile_t = desc_tables_on(stack.device)
    # (entry, label, its tables, operations, table bytes, rows allowed
    # beyond 1e-5 of the largest entry): K9's plain tile contractions are
    # cuBLAS products, summed in another order than the kernel's fixed
    # loops, none of its rows further off; a Grid sample whose position
    # lies within a last-bit difference of k + 0.5 (cosf / sinf of the
    # kernel against torch's) may round to the other pixel, which moves
    # its row further, and K13 sums its list in another order: at most 1%
    # of their rows, none beyond 1e-3
    for name, label, tables, nops, tbytes, allowed in (
            ("desc_grid_stack", "K9", (gauss_t, tile_t),
             n * (1600 * OPS_GRID_SAMPLE + OPS_GRID_TILES),
             4 * (1600 + 16), 0),
            ("desc_grid_rounded_stack", "K12", (), good * OPS_ROUNDED_SAMPLE,
             0, n // 100),
            ("desc_iloop_stack", "K13", (), listed * OPS_ILOOP_SAMPLE, 0,
             n // 100)):
        kern = getattr(desc_grid, name)
        plain = getattr(desc_grid, name + "_plain")
        args = (stack, xs, ys, lps, sg, an, win) + tables
        k = kern(*args)
        require(torch.equal(k, kern(*args)), f"{label} is not deterministic")
        require(torch.equal(k, kern(*args, stage=0)),
                f"{label}: the rows read through L2 differ from the staged")
        p = plain(*args)
        scale = float(p.abs().max())
        row_err = (k - p).abs().amax(dim=1)
        off = int((row_err > 1e-5 * scale).sum())
        print(f"  {label}: bit-identical run to run and through L2; within "
              f"{max_abs(k, p):.3g} of its plain version (largest entry "
              f"{scale:.3g}); {off} of {n} rows beyond 1e-5 of it; sha256 "
              f"{digest(k)}", flush=True)
        require(off <= allowed and float(row_err.max()) <= 1e-3 * scale,
                f"{label} descriptors differ from the plain version")
        pms = cuda_ms(lambda: plain(*args), reps=10)
        table.add(name, f"{label} {name} {n} rows of one octave, no "
                  f"staging (stage=0)", max_abs(k, p),
                  kernel_ms(lambda: kern(*args, stage=0)), pms,
                  nbytes + tbytes, nops, sub="one_octave_no_staging")
        table.add(name, f"{label} {name} {n} rows of one octave",
                  max_abs(k, p), kernel_ms(lambda: kern(*args)), pms,
                  nbytes + tbytes, nops, sub="one_octave")


def check_table_launches(torch, pt, plan, img, table: Table) -> None:
    """K5/K10, K6/K11 and K9/K12/K13 as the main path launches them: once
    an image, with a table of every octave that holds extrema, on stage
    1's grid-filtered extrema of ``img`` (the [0, 1] input on the card),
    laid end to end in ascending octave order, and the rows that
    descriptor_rows makes of them.  Each table launch equals, bit for bit,
    its one-entry launches octave by octave and itself run to run; the
    stack kernels equal the field kernels; each is held to the plain
    versions of its octaves (binwin.per_octave) at the tolerances of the
    single-octave checks, timed, and its bound summed over the octaves.
    These are the kernel table's rows of these kernels."""
    from popsift_torch import extract as ext
    from popsift_torch.constants import desc_tables_on
    from popsift_torch.gauss import build_gauss_info
    from popsift_torch.kernels import binwin, desc_grid, grad

    stage1, _ = ext.image_keypoints(plan, build_gauss_info(pt.Config()), img,
                                    stack_kernels=False, return_pyramid=True)
    live = [(o, st, grad.grad_field(st) if f is None else f, e)
            for o, (st, f, e) in enumerate(stage1) if e.count]
    require(len(live) >= 2, f"extrema in {len(live)} octaves: no table")
    octs = [o for o, _, _, _ in live]
    counts = [e.count for _, _, _, e in live]
    stacks = [st for _, st, _, _ in live]
    fields = [f for _, _, f, _ in live]
    kp = tuple(torch.cat([getattr(e, k) for _, _, _, e in live])
               for k in ("xpos", "ypos", "lpos", "sigma"))
    ne, k = sum(counts), len(live)
    print(f"  table launches: octaves {octs}, extrema {counts}", flush=True)

    def sliced(vecs, cnts):
        s = 0
        for c in cnts:
            yield tuple(v[s:s + c] for v in vecs)
            s += c

    # K5 and K10: the table launch, its one-entry launches, the plain
    # histograms and peaks of each octave
    def ori_table(stack, srcs, hist=None):
        fn = binwin.ori_peaks_stack_octaves if stack \
            else binwin.ori_peaks_octaves
        return fn(srcs, counts, *kp, hist=hist)

    def ori_one(stack, srcs):
        fn = binwin.ori_peaks_stack if stack else binwin.ori_peaks

        def one(src, *v):
            h = torch.empty((v[0].shape[0], 36), dtype=torch.float32,
                            device=src.device)
            n, a = fn(src, *v, hist=h)
            return torch.cat((h, n[:, None].float(), a), 1)
        return torch.cat(binwin.per_octave(one, srcs, counts, *kp))

    ori = {}
    for stack, name, label, srcs in ((False, "ori_hist", "K5", fields),
                                     (True, "ori_hist_stack", "K10",
                                      stacks)):
        hk, hk2 = (torch.empty((ne, 36), dtype=torch.float32,
                               device=img.device) for _ in range(2))
        num, ang = ori_table(stack, srcs, hk)
        got = torch.cat((hk, num[:, None].float(), ang), 1)
        num2, ang2 = ori_table(stack, srcs, hk2)
        require(torch.equal(got, torch.cat((hk2, num2[:, None].float(),
                                            ang2), 1)),
                f"{label}'s table launch is not deterministic")
        require(torch.equal(got, ori_one(stack, srcs)),
                f"{label}'s table launch differs from its one-entry "
                f"launches")
        plain_h = binwin.ori_hist_stack_plain if stack \
            else binwin.ori_hist_plain
        plain_p = binwin.ori_peaks_stack_plain if stack \
            else binwin.ori_peaks_plain
        hp = torch.cat(binwin.per_octave(plain_h, srcs, counts, *kp))
        qs = binwin.per_octave(plain_p, srcs, counts, *kp)
        qn = torch.cat([q[0] for q in qs])
        qa = torch.cat([q[1] for q in qs])
        same = num == qn
        off = int((~same).sum())
        a_err = max_abs(ang[same], qa[same])
        print(f"  {label} table of {k} octaves, {ne} extrema: bit-equal to "
              f"its one-entry launches and run to run; histograms within "
              f"{max_abs(hk, hp):.3g} of the plain versions, whose peaks "
              f"give another num_ori on {off} extrema (angles of the "
              f"others within {a_err:.3g})", flush=True)
        require(torch.allclose(hk, hp, rtol=1e-5, atol=1e-6),
                f"{label} table histograms differ by {max_abs(hk, hp):.3g}")
        require(off <= ne // 100 and a_err <= 1e-4,
                f"{label} table orientations differ from the plain "
                f"versions'")
        ori[label] = got
        work = union = nbr = 0
        for (o, st, _, _), v in zip(live, sliced(kp, counts)):
            w_, u_, n_ = support_pixels(*v, st.shape[0], st.shape[1],
                                        st.shape[2])
            work, union, nbr = work + w_, union + u_, nbr + n_
        ms = kernel_ms(lambda: ori_table(stack, srcs))
        pms = cuda_ms(lambda: binwin.per_octave(plain_p, srcs, counts, *kp),
                      reps=10)
        nbytes = (4 * nbr if stack else 8 * union) + 36 * ne
        nops = (OPS_ORI_PIXEL + (OPS_GRAD if stack else 0)) * work \
            + OPS_ORI_PEAKS * ne
        table.add(name, f"{label} {name} table of {k} octaves, {ne} extrema",
                  max_abs(hk, hp), ms, pms, nbytes, nops)
    require(torch.equal(ori["K5"], ori["K10"]),
            "K10's table launch differs from K5's on the main path's fields")

    # the rows of every octave, as stage 2 makes them
    num_ori, oris = binwin.ori_peaks_octaves(fields, counts, *kp)
    feat, ang, _, _, rows = ext.descriptor_rows(plan, octs, counts, num_ori,
                                                oris)
    rv = tuple(v[feat].contiguous() for v in kp) + (ang.contiguous(),)
    nd, half, win = int(feat.shape[0]), plan.desc_win // 2, plan.desc_win
    print(f"  descriptor rows {rows} ({nd})", flush=True)

    # K6 and K11
    loop = {}
    for stack, name, label, srcs in ((False, "desc_loop", "K6", fields),
                                     (True, "desc_loop_stack", "K11",
                                      stacks)):
        fn = binwin.desc_loop_stack_octaves if stack \
            else binwin.desc_loop_octaves
        one = binwin.desc_loop_stack if stack else binwin.desc_loop
        plain = binwin.desc_loop_stack_plain if stack \
            else binwin.desc_loop_plain
        d = fn(srcs, rows, *rv, half)
        require(torch.equal(d, fn(srcs, rows, *rv, half)),
                f"{label}'s table launch is not deterministic")
        require(torch.equal(d, torch.cat(binwin.per_octave(
            lambda src, *v: one(src, *v, half), srcs, rows, *rv))),
            f"{label}'s table launch differs from its one-entry launches")

        def plain_all():
            return torch.cat(binwin.per_octave(
                lambda src, *v: plain(src, *v, half), srcs, rows, *rv))
        dp = plain_all()
        print(f"  {label} table of {k} octaves, {nd} rows: bit-equal to its "
              f"one-entry launches and run to run; within "
              f"{max_abs(d, dp):.3g} of the plain versions", flush=True)
        require(torch.allclose(d, dp, rtol=1e-5, atol=1e-6),
                f"{label} table descriptors differ by {max_abs(d, dp):.3g}")
        loop[label] = d
        work = union = nbr = 0
        for (o, st, _, _), v in zip(live, sliced(rv, rows)):
            w_, u_, n_ = support_pixels(*v[:4], st.shape[0], st.shape[1],
                                        st.shape[2], ang=v[4], half=half)
            work, union, nbr = work + w_, union + u_, nbr + n_
        ms = kernel_ms(lambda: fn(srcs, rows, *rv, half))
        pms = cuda_ms(plain_all, reps=10)
        table.add(name, f"{label} {name} table of {k} octaves, {nd} rows",
                  max_abs(d, dp), ms, pms,
                  (4 * nbr if stack else 8 * union) + 532 * nd,
                  (OPS_DESC_PIXEL + (OPS_GRAD if stack else 0)) * work)
    require(torch.equal(loop["K6"], loop["K11"]),
            "K11's table launch differs from K6's on the main path's fields")

    # K9, K12 and K13 on the stacks, with the allowances of
    # check_stack_descriptors
    gauss_t, tile_t = desc_tables_on(img.device)
    nbytes = sum(footprint_bytes(st, v, win, say=False)
                 for st, v in zip(stacks, sliced(rv, rows)))
    good = int(desc_grid.grid_rounded_points(rv[0], rv[1], rv[3],
                                             rv[4])[4].sum())
    listed = 16 * int(desc_grid.iloop_sample_list(rv[3], rv[4])[1].sum())
    for name, label, tables, nops, tbytes, allowed in (
            ("desc_grid_stack", "K9", (gauss_t, tile_t),
             nd * (1600 * OPS_GRID_SAMPLE + OPS_GRID_TILES),
             4 * (1600 + 16), 0),
            ("desc_grid_rounded_stack", "K12", (), good * OPS_ROUNDED_SAMPLE,
             0, nd // 100),
            ("desc_iloop_stack", "K13", (), listed * OPS_ILOOP_SAMPLE, 0,
             nd // 100)):
        fn = getattr(desc_grid, name + "_octaves")
        one = getattr(desc_grid, name)
        plain = getattr(desc_grid, name + "_plain")
        args = (stacks, rows) + rv + (win,) + tables
        d = fn(*args)
        require(torch.equal(d, fn(*args)),
                f"{label}'s table launch is not deterministic")
        require(torch.equal(d, fn(*args, stage=0)),
                f"{label}'s table launch: the rows read through L2 differ "
                f"from the staged")
        require(torch.equal(d, torch.cat(binwin.per_octave(
            lambda st, *v: one(st, *v, win, *tables), stacks, rows, *rv))),
            f"{label}'s table launch differs from its one-entry launches")

        def plain_all():
            return torch.cat(binwin.per_octave(
                lambda st, *v: plain(st, *v, win, *tables), stacks, rows,
                *rv))
        dp = plain_all()
        scale = float(dp.abs().max())
        row_err = (d - dp).abs().amax(dim=1)
        off = int((row_err > 1e-5 * scale).sum())
        print(f"  {label} table of {k} octaves, {nd} rows: bit-equal to its "
              f"one-entry launches, run to run and through L2; within "
              f"{max_abs(d, dp):.3g} of the plain versions (largest entry "
              f"{scale:.3g}); {off} rows beyond 1e-5 of it", flush=True)
        require(off <= allowed and float(row_err.max()) <= 1e-3 * scale,
                f"{label} table descriptors differ from the plain versions")
        pms = cuda_ms(plain_all, reps=10)
        table.add(name, f"{label} {name} table of {k} octaves, {nd} rows, no "
                  f"staging (stage=0)", max_abs(d, dp),
                  kernel_ms(lambda: fn(*args, stage=0)), pms,
                  nbytes + tbytes, nops, sub="no_staging")
        table.add(name, f"{label} {name} table of {k} octaves, {nd} rows",
                  max_abs(d, dp), kernel_ms(lambda: fn(*args)), pms,
                  nbytes + tbytes, nops)


@contextlib.contextmanager
def footprint_tally(tally: list):
    """While active, each NoTile, Grid or ILoop descriptor call of the
    extraction appends (rows, rows whose staged footprint exceeds the staging
    capacity, largest footprint in px) to ``tally``."""
    from popsift_torch import extract as ext_mod
    from popsift_torch.kernels import desc_grid

    def tallied(fn):
        def call(stacks, counts, xs, ys, lpos, sigma, ang, win, *a, **k):
            _, pix = staged_boxes(xs, ys, sigma, ang, win)
            tally.append((int(pix.numel()),
                          int((pix > desc_grid.STAGE_FLOATS).sum()),
                          int(pix.max()) if pix.numel() else 0))
            return fn(stacks, counts, xs, ys, lpos, sigma, ang, win, *a,
                      **k)
        return call

    # the one descriptor launch of each extraction's stage-2 pass
    names = ("desc_grid_stack_octaves", "desc_grid_rounded_stack_octaves",
             "desc_iloop_stack_octaves")
    saved = {name: getattr(ext_mod, name) for name in names}
    for name, fn in saved.items():
        setattr(ext_mod, name, tallied(fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ext_mod, name, fn)


def features_equal(a, b) -> bool:
    sa, sb = a.soa(), b.soa()
    return (all(np.array_equal(sa[k], sb[k]) for k in sa)
            and np.array_equal(a.get_descriptors(), b.get_descriptors()))


def check_output(feats, w: int, h: int) -> None:
    s = feats.soa()
    n, nd = feats.get_feature_count(), feats.get_descriptor_count()
    require(n > 0 and nd >= n, f"too few features ({n}, {nd})")
    for k in ("xpos", "ypos", "sigma", "orientation"):
        require(bool(np.isfinite(s[k]).all()), f"non-finite {k}")
    require(bool(((s["xpos"] >= 0) & (s["xpos"] < w)).all()
                 and ((s["ypos"] >= 0) & (s["ypos"] < h)).all()),
            "feature outside the image")
    d = feats.get_descriptors()
    require(d.shape == (nd, 128) and bool(np.isfinite(d).all()),
            "bad descriptor matrix")
    require(int(s["num_ori"].sum()) == nd, "num_ori does not add up")


MAIN_PATH_PASSES = 5


def run_path(torch, pt, scenes, cfg, label: str, path_kernels,
             device="cuda", passes: int = MAIN_PATH_PASSES,
             not_launched=(), not_profiled=(),
             tally_boxes: bool = False, budget_dropped=BUDGET_DROPPED,
             max_k1: int | None = MAX_K1_CALLS) -> tuple[dict, list]:
    """Phases 3-6 and 9: the user-facing entry point on the card with
    ``cfg``.  The scenes go through ``passes`` times; the launch counts
    are those of the first pass, and ms per image is the median pass, with
    the range.  Every kernel of ``path_kernels`` must have been launched,
    and none of ``not_launched``; no kernel of the profiled pass may be
    named after one of ``not_profiled``.  Per scene the candidates the
    compaction budget dropped must be ``budget_dropped`` and K1's calls at
    most ``max_k1`` (each printed only where None).  With
    ``tally_boxes``, prints per scene the descriptor rows whose footprint
    exceeds K9/K12/K13's staging capacity.  Returns the path's numbers and
    the first pass's features."""
    from popsift_torch import kernels
    from popsift_torch.ops import extrema as ops_ext

    h, w = scenes[0].shape
    print(f"{label} on {len(scenes)} distinct {w}x{h} scenes, "
          f"{passes} pass{'es' if passes > 1 else ''}", flush=True)

    def one_pass(ps):
        t0 = time.perf_counter()
        jobs = [ps.enqueue(w, h, s) for s in scenes]
        out = [j.get() for j in jobs]
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) / len(scenes) * 1e3

    torch.cuda.reset_peak_memory_stats()
    with pt.PopSift(cfg, device=device) as ps:
        ps.enqueue(w, h, scenes[-1]).get()        # first-use set-up
        torch.cuda.synchronize()
        kernels.reset_launches()
        feats, ms_first = one_pass(ps)
        counts = kernels.launches()
        pass_ms = [ms_first] + [one_pass(ps)[1] for _ in range(passes - 1)]
        again = ps.enqueue(w, h, scenes[0]).get()
        # per scene: candidates the compaction budget dropped, K1 calls
        dropped, k1_calls, boxes = [], [], []
        for scene in scenes:
            kernels.reset_launches()
            ops_ext.reset_budget_dropped()
            tally = []
            with (footprint_tally(tally) if tally_boxes
                  else contextlib.nullcontext()):
                ps.enqueue(w, h, scene).get()
            boxes.append((sum(t[0] for t in tally), sum(t[1] for t in tally),
                          max(t[2] for t in tally)) if tally else None)
            dropped.append(ops_ext.budget_dropped())
            n = kernels.launches()
            k1_calls.append(n["sep_blur"] + n["blur_chain"])
    ms_img = float(np.median(pass_ms))
    print("  features per image: "
          + ", ".join(f"{f.get_feature_count()}/{f.get_descriptor_count()}"
                      for f in feats), flush=True)
    print(f"  {ms_img:.3f} ms per image (median pass; passes "
          + ", ".join(f"{t:.3f}" for t in pass_ms)
          + f"), {1e3 / ms_img:.3f} images/s (host clock, {len(scenes)} "
          f"images per pass)", flush=True)
    print(f"  launches: {json.dumps(counts)}", flush=True)
    print(f"  per scene: candidates the compaction budget dropped "
          f"{dropped}, K1 calls {k1_calls}", flush=True)
    if tally_boxes:
        from popsift_torch.kernels.desc_grid import STAGE_FLOATS
        print(f"  per scene: descriptor rows whose footprint exceeds the "
              f"staging capacity of {STAGE_FLOATS} px (share; largest "
              f"footprint): "
              + ", ".join(f"{b[1]}/{b[0]} ({100.0 * b[1] / max(b[0], 1):.2f}"
                          f"%; {b[2]} px)" for b in boxes), flush=True)
    require(budget_dropped is None or tuple(dropped) == budget_dropped,
            f"the budget dropped {dropped} candidates, recorded "
            f"{budget_dropped}")
    require(max_k1 is None or max(k1_calls) <= max_k1,
            f"K1 called {k1_calls} times per image (at most {max_k1})")
    for name in path_kernels:
        require(counts[name] > 0,
                f"kernel {name} was not launched on the {label} path")
    for name in not_launched:
        require(counts[name] == 0,
                f"kernel {name} was launched on the {label} path")
    for f in feats:
        check_output(f, w, h)
    require(features_equal(feats[0], again),
            "the same frame gave different features")
    print("  repeated frame: bit-identical features", flush=True)
    prof = profile_path(torch, pt, scenes, cfg, device, not_profiled)
    if prof["device_busy_ms"] is not None:
        # busy time is the same with the profiler off; the unprofiled
        # wall is the median pass above
        prof["device_idle_share"] = 1.0 - prof["device_busy_ms"] / ms_img
        print(f"  device idle {100 * prof['device_idle_share']:.1f}% of the "
              f"unprofiled wall ({100 * prof['device_idle_share_profiled']:.1f}"
              f"% under the profiler)", flush=True)
    return dict(ms_per_image=ms_img, pass_ms_per_image=pass_ms,
                counts=counts, budget_dropped=dropped, k1_calls=k1_calls,
                footprints_over_capacity=[b and b[1] for b in boxes],
                features=[f.get_feature_count() for f in feats],
                descriptors=[f.get_descriptor_count() for f in feats],
                peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                **prof), feats


def count_ops(torch, scenes, cfg, device) -> dict:
    """PyTorch operations the host dispatches per image on a path, nested
    ones (an aten::to calling aten::copy_) included: the CPU activity of
    torch.profiler over extract_features of the scenes, the function the
    pipeline's worker runs, called on this thread (the profiler records
    the operations of the thread that started it)."""
    from torch.profiler import ProfilerActivity, profile
    from popsift_torch.extract import extract_features

    extract_features(scenes[-1], cfg, device=device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for scene in scenes:
            extract_features(scene, cfg, device=device)
    ops = {}
    for e in prof.key_averages():
        if e.key.startswith("aten::"):
            ops[e.key] = ops.get(e.key, 0) + e.count
    n = len(scenes)
    return dict(aten_ops_per_image=sum(ops.values()) / n,
                roll_per_image=ops.get("aten::roll", 0) / n,
                nonzero_per_image=ops.get("aten::nonzero", 0) / n)


def profile_path(torch, pt, scenes, cfg, device, absent=()) -> dict:
    """Where a path's time goes: torch.profiler over the same scenes,
    device time summed by kernel name, and the device's busy share of the
    wall time (kernels and copies; one stream, so they do not overlap).
    No kernel's name may hold one of ``absent``."""
    from torch.profiler import ProfilerActivity, profile

    h, w = scenes[0].shape
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with pt.PopSift(cfg, device=device) as ps:
        ps.enqueue(w, h, scenes[-1]).get()
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for j in [ps.enqueue(w, h, s) for s in scenes]:
                j.get()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0)) / 1e3
        if t > 0:
            by_name[e.key] = (by_name.get(e.key, (0.0, 0))[0] + t, e.count)
    busy = sum(t for t, _ in by_name.values())
    n = len(scenes)
    op_counts = count_ops(torch, scenes, cfg, device)
    print(f"  profile: wall {wall_ms / n:.3f} ms/image (profiler on), "
          f"device busy {busy / n:.3f} ms/image; PyTorch ops per image: "
          f"{op_counts['aten_ops_per_image']:.2f} (aten::roll "
          f"{op_counts['roll_per_image']:.2f}, aten::nonzero "
          f"{op_counts['nonzero_per_image']:.2f})", flush=True)
    require(op_counts["roll_per_image"] == 0,
            "torch.roll ran on the path: orientation peaks left K5/K10")
    if busy == 0.0:
        print("  profile: the profiler recorded no device time; device "
              "share not measured"
              + (f", kernel names not checked for {absent} (the launch "
                 f"counts are)" if absent else ""), flush=True)
        return dict(profile_wall_ms=wall_ms / n, device_busy_ms=None,
                    **op_counts)
    for name in absent:
        hits = [k for k in by_name if name in k]
        require(not hits, f"the profile holds {hits}")
        print(f"  profile: no {name} kernel among the {len(by_name)} "
              f"names with device time", flush=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    for name, (t, c) in top:
        print(f"    {t / n:9.4f} ms/image {c / n:8.1f} calls/image  "
              f"{name[:90]}", flush=True)
    return dict(profile_wall_ms=wall_ms / n, device_busy_ms=busy / n,
                device_idle_share_profiled=1.0 - busy / wall_ms, **op_counts)


def same_keypoints(a, b) -> bool:
    sa, sb = a.soa(), b.soa()
    return all(np.array_equal(sa[k], sb[k])
               for k in ("xpos", "ypos", "sigma", "num_ori", "orientation",
                         "debug_octave"))


def check_against_cpu(torch, pt, cfg, label: str, scene=None) -> None:
    """Phase 7: the card's features of a small scene (by default a 320x240
    synthetic one) against the plain versions on the CPU.  Both sides
    round each operation the same way, but exp/sin/cos/atan2/pow come from
    different maths libraries, so a feature may move by a few ulp; 99% of
    the CPU features must be found on the card at the same octave within
    1e-3 px and sigma rtol 1e-4, and 99% of those found must have their
    first descriptor within 1e-3."""
    from popsift_torch.extract import extract_features

    if scene is None:
        scene = make_scene(11, 240, 320)
    h, w = scene.shape
    cpu = extract_features(scene, cfg, device="cpu")
    gpu = extract_features(scene, cfg, device="cuda")
    check_output(gpu, w, h)
    sc, sg = cpu.soa(), gpu.soa()
    nc, ng = cpu.get_feature_count(), gpu.get_feature_count()
    d = np.hypot(sc["xpos"][:, None] - sg["xpos"][None, :],
                 sc["ypos"][:, None] - sg["ypos"][None, :])
    d = np.where(sc["debug_octave"][:, None] == sg["debug_octave"][None, :],
                 d, np.inf)
    j = d.argmin(axis=1)
    hit = (d[np.arange(nc), j] <= 1e-3) & (
        np.abs(sg["sigma"][j] - sc["sigma"]) <= 1e-4 * sc["sigma"])
    ic, ig = sc["desc_idx"][hit, 0], sg["desc_idx"][j[hit], 0]
    both = (ic >= 0) & (ig >= 0)
    ddiff = np.abs(cpu.get_descriptors()[ic[both]]
                   - gpu.get_descriptors()[ig[both]]).max(axis=1)
    require(ddiff.size > 0, f"no matched descriptors ({label})")
    print(f"  {label}: {w}x{h} scene, {nc} CPU / {ng} GPU features, "
          f"{int(hit.sum())} matched; first descriptors of matched features "
          f"within {float(np.median(ddiff)):.3g} (median), "
          f"{float(ddiff.max()):.3g} (largest)", flush=True)
    require(abs(nc - ng) <= max(1, nc // 100) and hit.mean() >= 0.99,
            f"card and CPU features disagree ({label})")
    require(float((ddiff <= 1e-3).mean()) >= 0.99,
            f"card and CPU descriptors disagree ({label})")


def mode_config(pt, mode: str):
    cfg = pt.Config()
    cfg.set_desc_mode(pt.DescMode(mode))
    return cfg


def require_same_keypoints(ref_feats, feats, label: str) -> None:
    require(all(same_keypoints(a, b) for a, b in zip(ref_feats, feats)),
            f"the {label} path's keypoints differ from the default path's")
    print("  keypoints (x, y, sigma, num_ori, orientations) identical to "
          "the default path's on every scene", flush=True)


@contextlib.contextmanager
def stack_kernels_on():
    """The stack-kernel switch on for the block, and as it was after."""
    old = os.environ.get(STACK_SWITCH)
    os.environ[STACK_SWITCH] = "1"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(STACK_SWITCH, None)
        else:
            os.environ[STACK_SWITCH] = old

MATCH_PAIRS_REAL = (("china.pgm", "china_l.pgm"),
                    ("flower.pgm", "flower_r.pgm"))
NEAR_TIE = 1e-5
MOST_NEAR_TIE_MISMATCHES = 0.001


def read_pgm(path: Path) -> np.ndarray:
    """An 8-bit binary PGM (P5) as an (H, W) uint8 array."""
    data = path.read_bytes()
    fields, pos = [], 0
    while len(fields) < 4:
        while data[pos:pos + 1].isspace():
            pos += 1
        end = pos
        while not data[end:end + 1].isspace():
            end += 1
        fields.append(data[pos:end])
        pos = end
    require(fields[0] == b"P5" and int(fields[3]) == 255,
            f"{path} is not an 8-bit P5 PGM")
    w, h = int(fields[1]), int(fields[2])
    return np.frombuffer(data, np.uint8, w * h, pos + 1).reshape(h, w)


def bits_equal(a: np.ndarray, b: np.ndarray) -> bool:
    return (a.shape == b.shape and a.dtype == b.dtype
            and np.array_equal(a.view(np.uint8), b.view(np.uint8)))


def dev_equal(a, b) -> bool:
    """Two FeaturesDev, bit for bit."""
    fa, fb = a.get_features(), b.get_features()
    return (all(bits_equal(fa[k], fb[k]) for k in fa)
            and bits_equal(a.get_reverse_map(), b.get_reverse_map())
            and bits_equal(a.get_descriptors().cpu().numpy(),
                           b.get_descriptors().cpu().numpy()))


def require_dev_equals_host(dev, host, label: str) -> None:
    """Matching mode's features of a frame against ExtractingMode's."""
    s, f = host.soa(), dev.get_features()
    for k in ("xpos", "ypos", "sigma", "num_ori"):
        require(bits_equal(f[k], s[k]),
                f"{label}: FeaturesDev {k} differs from FeaturesHost's")
    desc = dev.get_descriptors()
    require(desc.device.type == "cuda" and desc.dtype.is_floating_point,
            f"{label}: descriptors on {desc.device}, {desc.dtype}")
    require(bits_equal(desc.cpu().numpy(), host.get_descriptors()),
            f"{label}: device descriptors differ from the host's")
    num = s["num_ori"]
    require(bits_equal(dev.get_reverse_map(),
                       np.repeat(np.arange(num.shape[0], dtype=np.int64),
                                 num)[:desc.shape[0]]),
            f"{label}: reverse map")


def self_match_copies(dev, label: str) -> int:
    """A frame matched with itself gives every row itself, accepted, but
    rows whose descriptor has an exact copy in the frame (two extrema
    refined to one point): those match the first copy and are rejected.
    Returns the number of such rows."""
    best, _, accept, d1, d2 = dev.match(dev)
    desc = dev.get_descriptors().cpu().numpy()
    m = desc.shape[0]
    _, first, inverse = np.unique(desc, axis=0, return_index=True,
                                  return_inverse=True)
    first = first[inverse.reshape(-1)]
    copied = np.bincount(first, minlength=m)[first] > 1
    require(np.array_equal(best[~copied], np.arange(m)[~copied])
            and bool(accept[~copied].all()),
            f"{label}: a self-match row did not match itself")
    require(np.array_equal(best[copied], first[copied])
            and not accept[copied].any()
            and np.array_equal(d1[copied], d2[copied]),
            f"{label}: rows with a copy")
    return int(copied.sum())


def plain_match64(l: np.ndarray, r: np.ndarray, ratio: float = 0.8):
    """The plain matcher on the CPU in float64: best, second and third
    nearest distances and indices, and the ratio test."""
    l, r = l.astype(np.float64), r.astype(np.float64)
    d = np.maximum((l * l).sum(1)[:, None] + (r * r).sum(1)[None, :]
                   - 2.0 * (l @ r.T), 0.0)
    rows = np.arange(d.shape[0])
    order = []
    for _ in range(min(3, d.shape[1])):
        i = d.argmin(axis=1)
        order.append((i, d[rows, i].copy()))
        d[rows, i] = np.inf
    (b, db), (s2, ds) = order[0], order[1]
    dt = order[2][1] if len(order) > 2 else np.full_like(db, np.inf)
    return b, s2, db / ds < ratio, db, ds, dt


def compare_with_plain(card, l, r, label: str, ratio: float = 0.8) -> dict:
    """The card's match of descriptors ``l`` against ``r`` (numpy) with
    the float64 matcher's.  A row may differ only at a near tie: its two
    nearest, or second and third nearest, distances within NEAR_TIE of
    each other, or its distance ratio within NEAR_TIE of ``ratio``; at
    most MOST_NEAR_TIE_MISMATCHES of the rows may.  The best and second
    distances agree within rtol 1e-4 and, for distances near 0, within
    the rounding bound of float32's |l|^2 + |r|^2 - 2 l.r: D u (|l|^2 +
    |r|^2) with D = 128 terms and u = 2^-24, about 1.5e-5 for unit rows."""
    best, second, accept, d1, d2 = card
    pb, ps, pa, pd1, pd2, pd3 = plain_match64(l, r, ratio)
    differ = (best != pb) | (second != ps) | (accept != pa)
    near = ((pd2 - pd1 <= NEAR_TIE) | (pd3 - pd2 <= NEAR_TIE)
            | (np.abs(pd1 / np.maximum(pd2, 1e-300) - ratio) <= NEAR_TIE))
    n = len(best)
    norms = float((l.astype(np.float64) ** 2).sum(1).max()
                  + (r.astype(np.float64) ** 2).sum(1).max())
    atol = l.shape[1] * 2.0 ** -24 * norms
    err = max(float(np.abs(d1 - pd1).max()), float(np.abs(d2 - pd2).max()))
    over = max(float((np.abs(d1 - pd1) - 1e-4 * pd1).max()),
               float((np.abs(d2 - pd2) - 1e-4 * pd2).max()))
    print(f"  {label}: {n} rows, {int(accept.sum())} accepted; rows "
          f"differing from the float64 matcher {int(differ.sum())}, all at "
          f"near ties: {bool(near[differ].all())} (near-tie rows "
          f"{int(near.sum())}); distances within {err:.3g} (beyond rtol "
          f"1e-4 by at most {max(over, 0.0):.3g}, bound {atol:.3g})",
          flush=True)
    require(bool(near[differ].all()),
            f"{label}: the card's matches differ from the float64 "
            f"matcher's away from a near tie at rows "
            f"{np.flatnonzero(differ & ~near)[:10].tolist()}")
    require(int(differ.sum()) <= MOST_NEAR_TIE_MISMATCHES * n,
            f"{label}: {int(differ.sum())} rows differ at near ties")
    require(np.allclose(d1, pd1, rtol=1e-4, atol=atol)
            and np.allclose(d2, pd2, rtol=1e-4, atol=atol),
            f"{label}: distances differ from the float64 matcher's")
    return dict(rows=n, accepted=int(accept.sum()),
                differing_at_near_ties=int(differ.sum()),
                near_tie_rows=int(near.sum()), max_distance_error=err)


def rotation_share(left, right, best, accept, width: int) -> float:
    """Share of the accepted matches of a frame (width ``width``) with its
    np.rot90 view that land within 2 px of the rotated position: (x, y)
    goes to (y, width - 1 - x)."""
    fl, fr = left.get_features(), right.get_features()
    lrev, rrev = left.get_reverse_map(), right.get_reverse_map()
    i = np.flatnonzero(accept)
    if i.size == 0:
        return 0.0
    lx, ly = fl["xpos"][lrev[i]], fl["ypos"][lrev[i]]
    rx, ry = fr["xpos"][rrev[best[i]]], fr["ypos"][rrev[best[i]]]
    return float((np.hypot(rx - ly, ry - (width - 1 - lx)) <= 2.0).mean())


def all_device_ms(torch, fn, reps: int = 20) -> float | None:
    """Mean device time of one call of ``fn``, every CUDA kernel and copy
    it runs (torch.profiler, 50 ms idle on each side); None if the
    profiler recorded none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(0.05)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.05)
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    return us / reps / 1e3 if us > 0 else None


def check_tf32(torch, l, r) -> dict:
    """The matcher with TF32 turned on by the caller, both ways PyTorch
    offers, against the matcher with it off: bit for bit, and the caller's
    setting still on after the call.  A plain torch.mm with TF32 on shows
    that TF32 would have changed the product."""
    from popsift_torch.ops.match import match_brute_force
    mm = torch.backends.cuda.matmul
    ieee = [t.cpu().numpy() for t in match_brute_force(l, r)]
    exact = torch.mm(l, r.t())
    out = {}
    for how in ("allow_tf32", "float32_matmul_precision"):
        if how == "allow_tf32":
            mm.allow_tf32 = True
        else:
            torch.set_float32_matmul_precision("high")
        try:
            moved = float((torch.mm(l, r.t()) - exact).abs().max())
            got = [t.cpu().numpy() for t in match_brute_force(l, r)]
            still_on = mm.allow_tf32
        finally:
            mm.allow_tf32 = False
        same = all(bits_equal(a, b) for a, b in zip(got, ieee))
        print(f"  TF32 on by {how}: a plain torch.mm moves by up to "
              f"{moved:.3g}; the matcher's results bit-identical to TF32 "
              f"off: {same}; the caller's TF32 still on after: {still_on}",
              flush=True)
        require(moved > 0, f"TF32 by {how} did not change torch.mm")
        require(same, f"the matcher's results moved with TF32 by {how}")
        require(still_on, f"the matcher left TF32 by {how} off")
        out[how] = dict(mm_moved=moved, identical=same)
    return out


def matching_frames(scenes) -> list:
    """(label, frame, right-hand partner or None) of phase 8."""
    frames = [(f"scene {i}", s) for i, s in enumerate(scenes)]
    frames += [(f"scene {i} rot90", np.ascontiguousarray(np.rot90(s)))
               for i, s in enumerate(scenes)]
    data = HERE / "tests" / "data" / "scenes"
    for a, b in MATCH_PAIRS_REAL:
        frames += [(a, read_pgm(data / a)), (b, read_pgm(data / b))]
    return frames


def run_matching(torch, pt, scenes, loop_feats, smi: str) -> dict:
    """Phase 8: matching mode on the card."""
    from popsift_torch import kernels
    from popsift_torch.ops.match import match_brute_force

    frames = matching_frames(scenes)
    labels = [lab for lab, _ in frames]
    by_label = dict(frames)
    pairs = [(f"scene {i}", f"scene {i} rot90") for i in range(len(scenes))]
    pairs += list(MATCH_PAIRS_REAL)
    print(f"phase 8: matching mode, PopSift(Config(), mode=MATCHING, "
          f"workers=2) on {len(frames)} frames: the four scenes, their "
          f"90-degree rotations and the real pairs "
          f"{', '.join('/'.join(p) for p in MATCH_PAIRS_REAL)} ({smi})",
          flush=True)

    # ExtractingMode features of the frames phase 3 did not extract
    host = dict(zip(labels[:len(scenes)], loop_feats))
    with pt.PopSift(pt.Config()) as ps:
        jobs = [(lab, ps.enqueue(f.shape[1], f.shape[0], f))
                for lab, f in frames[len(scenes):]]
        host.update((lab, j.get()) for lab, j in jobs)

    def drive(workers: int) -> dict:
        with pt.PopSift(pt.Config(), mode=pt.ProcessingMode.MATCHING,
                        workers=workers) as ps:
            jobs = [(lab, ps.enqueue(f.shape[1], f.shape[0], f))
                    for lab, f in frames]
            return {lab: j.get_dev() for lab, j in jobs}

    torch.cuda.synchronize()
    kernels.reset_launches()
    dev = drive(2)
    torch.cuda.synchronize()
    counts = kernels.launches()
    print(f"  launches: {json.dumps(counts)}", flush=True)
    for name in LOOP_PATH:
        require(counts[name] > 0,
                f"kernel {name} was not launched in matching mode")
    for name in NOT_ON_ANY_PATH:
        require(counts[name] == 0,
                f"kernel {name} was launched in matching mode")

    # (a) each frame's FeaturesDev against its FeaturesHost
    for lab in labels:
        require(dev[lab] is not None, f"{lab}: get_dev() gave None")
        require_dev_equals_host(dev[lab], host[lab], lab)
    print("  (a) every frame's FeaturesDev equals its ExtractingMode "
          "features (xpos, ypos, sigma, num_ori bit for bit; descriptors "
          "a CUDA tensor bit-identical to the host array; reverse map "
          "repeat(arange(n), num_ori)): "
          + ", ".join(f"{lab} {dev[lab].get_feature_count()}/"
                      f"{dev[lab].get_descriptor_count()}"
                      for lab in labels), flush=True)

    # (b) self-matches
    copies = [self_match_copies(dev[f"scene {i}"], f"scene {i}")
              for i in range(len(scenes))]
    print(f"  (b) each scene matched with itself: every row itself and "
          f"accepted, but rows with an exact copy in the frame (rejected, "
          f"matched to the first copy): {copies}", flush=True)

    # (c) each pair against the float64 matcher on the CPU
    pair_stats = {}
    for a, b in pairs:
        l, r = dev[a], dev[b]
        card = l.match(r)
        st = compare_with_plain(card, l.get_descriptors().cpu().numpy(),
                                r.get_descriptors().cpu().numpy(),
                                f"(c) {a} -> {b}")
        if b.endswith("rot90"):
            st["within_2px_of_the_rotation"] = rotation_share(
                l, r, card[0], card[2], by_label[a].shape[1])
            print(f"      {100 * st['within_2px_of_the_rotation']:.2f}% of "
                  f"the accepted matches within 2 px of the rotation",
                  flush=True)
        pair_stats[f"{a}->{b}"] = st
    print(f"  accepted matches per pair ({smi}): "
          + ", ".join(f"{k} {v['accepted']}" for k, v in pair_stats.items()),
          flush=True)

    # (d) one worker against two
    one = drive(1)
    require(all(dev_equal(one[lab], dev[lab]) for lab in labels),
            "workers=1 and workers=2 gave different FeaturesDevs")
    print("  (d) workers=1 and workers=2, all frames enqueued at once: "
          "bit-identical FeaturesDevs on every frame", flush=True)

    # (e) TF32 turned on by the caller
    l = dev["scene 0"].get_descriptors()
    r = dev["scene 0 rot90"].get_descriptors()
    tf32 = check_tf32(torch, l, r)
    print("  (e) the matcher holds TF32 off for its product: results "
          "bit-identical with TF32 on", flush=True)

    # the matcher's time, and the pair wall
    match_ms = cuda_ms(lambda: match_brute_force(l, r))
    match_dev = all_device_ms(torch, lambda: match_brute_force(l, r))
    print(f"  matcher on scene 0 -> scene 0 rot90 ({l.shape[0]} x "
          f"{r.shape[0]} rows): {match_ms:.6f} ms by events, "
          f"{fmt_ms(match_dev)} ms on the device (torch.mm and the "
          f"selection; {smi})", flush=True)
    a, b = scenes[0], np.ascontiguousarray(np.rot90(scenes[0]))
    walls = {}
    for workers in (1, 2):
        with pt.PopSift(pt.Config(), mode=pt.ProcessingMode.MATCHING,
                        workers=workers) as ps:
            ps.enqueue(a.shape[1], a.shape[0], a).get_dev()
            times = []
            for _ in range(MAIN_PATH_PASSES):
                t0 = time.perf_counter()
                jl = ps.enqueue(a.shape[1], a.shape[0], a)
                jr = ps.enqueue(b.shape[1], b.shape[0], b)
                jl.get_dev().match(jr.get_dev())
                times.append((time.perf_counter() - t0) * 1e3)
        walls[workers] = dict(median_ms=float(np.median(times)),
                              passes_ms=times)
        print(f"  pair wall, workers={workers} (two enqueues, two get_devs "
              f"and the match, 1080p): {np.median(times):.3f} ms (median of "
              f"{len(times)}; range {min(times):.3f}-{max(times):.3f}; "
              f"{smi})", flush=True)
    return dict(counts=counts, frames={lab: [dev[lab].get_feature_count(),
                                             dev[lab].get_descriptor_count()]
                                       for lab in labels},
                self_match_copies=copies, pairs=pair_stats, tf32=tf32,
                matcher_ms=match_ms, matcher_device_ms=match_dev,
                pair_wall=walls)


def mode_label(settings) -> str:
    return "Config(" + ", ".join(f"{k.removeprefix('set_')}={v}"
                                 for k, v in settings) + ")"


def subset_of(part, whole) -> bool:
    """Whether every feature of ``part`` is one of ``whole``'s, with the
    same octave, position, sigma and orientations, to the bit."""
    def rows(f):
        s = f.soa()
        return [(int(o), float(x), float(y), float(sg), int(n), a.tobytes())
                for o, x, y, sg, n, a in zip(
                    s["debug_octave"], s["xpos"], s["ypos"], s["sigma"],
                    s["num_ori"], s["orientation"])]
    return set(rows(part)) <= set(rows(whole))


def check_grid_filter(torch, pt, scenes, cfg, feats, loop_feats) -> list:
    """The grid filter on the card: on each scene it triggers (its own
    unfiltered extrema exceed the budget x 1.1), its keep masks equal
    those of ops/filtergrid.py run on the CPU on the card's own unfiltered
    extrema, the path's features are as many as the masks keep, and they
    are a subset of the unfiltered path's (phase 3's default features,
    the same Config without the filter).  Returns (kept, total) per
    scene."""
    from popsift_torch import extract as ext
    from popsift_torch.gauss import build_gauss_info
    from popsift_torch.ops import filtergrid as ops_fg

    h, w = scenes[0].shape
    plan = ext.make_plan(cfg, w, h)
    gauss = build_gauss_info(cfg)
    budget = plan.filter_max_extrema
    out = []
    for i, scene in enumerate(scenes):
        img = ext.to_unit_image(scene, "cuda")
        exts = [e for _, _, e in ext.octave_keypoints_all(
            plan, gauss, img, False, True)]
        total = sum(e.count for e in exts)
        require(ops_fg.triggers(budget, total),
                f"scene {i}: {total} extrema do not trigger the filter "
                f"(budget {budget})")
        keeps = ops_fg.grid_filter_keep_masks(
            exts, budget, plan.filter_grid_size, plan.grid_filter_mode)
        host = [e._replace(**{k: getattr(e, k).cpu() for k in
                              ("xpos", "ypos", "lpos", "sigma", "cell")})
                for e in exts]
        plain = ops_fg.grid_filter_keep_masks(
            host, budget, plan.filter_grid_size, plan.grid_filter_mode)
        require(all(torch.equal(k.cpu(), p) for k, p in zip(keeps, plain)),
                f"scene {i}: the card's keep masks differ from the plain "
                f"filter's on the CPU")
        kept = sum(int(k.sum()) for k in keeps)
        require(feats[i].get_feature_count() == kept,
                f"scene {i}: {feats[i].get_feature_count()} features, the "
                f"masks keep {kept}")
        require(subset_of(feats[i], loop_feats[i]),
                f"scene {i}: filtered features not among the unfiltered")
        out.append((kept, total))
    print(f"  grid filter (budget {budget}): kept/extrema per scene "
          f"{out}; triggered on every scene; keep masks equal the plain "
          f"filter's on the CPU; features a subset of the unfiltered "
          f"path's", flush=True)
    return out


def run_modes(torch, pt, scenes, loop_feats) -> tuple[dict, list]:
    """Phase 9: each non-default mode of MODES through PopSift on the four
    scenes (one timed pass, one profiled), with its route's kernels
    launched and the others not, a bit-identical repeat, the recorded
    features per image, and the card against the CPU on a small scene; the
    grid filter also by :func:`check_grid_filter`.  Returns the stats per
    mode and the modes whose features are not recorded."""
    # Fixed9 finds no feature on the small synthetic scene: the card is
    # held to the CPU on a real 640x480 photograph instead
    small = read_pgm(HERE / "tests" / "data" / "scenes" / CPU_CHECK_SCENE)
    stats, unrecorded = {}, []
    for name, settings, route in MODES:
        cfg = pt.Config()
        for setter, arg in settings:
            getattr(cfg, setter)(arg)
        launched, absent = ROUTES[route]
        label = mode_label(settings)
        print(f"phase 9: {name}, ", end="")
        st, feats = run_path(torch, pt, scenes, cfg, f"PopSift({label})",
                             launched, passes=1, not_launched=absent,
                             not_profiled=absent, budget_dropped=None,
                             max_k1=None)
        got = tuple(st["features"])
        want = MODE_FEATURES.get(name)
        if want is None:
            unrecorded.append(name)
            print(f"  features per image {got}: none recorded", flush=True)
        else:
            require(got == want, f"{name}: features per image {got}, "
                    f"recorded {want}")
            print(f"  features per image as recorded: {got}", flush=True)
        if cfg.filter_max_extrema > 0:
            st["filter_kept_total"] = check_grid_filter(
                torch, pt, scenes, cfg, feats, loop_feats)
        check_against_cpu(torch, pt, cfg, name, scene=small)
        busy = st.get("device_busy_ms")
        print(f"  {name}: {st['ms_per_image']:.3f} ms/image, device busy "
              f"{fmt_ms(busy)} ms/image, peak {st['peak_mem_gib']:.3f} GiB",
              flush=True)
        stats[name] = st
    return stats, unrecorded


# Phase 10, the command-line tools and diagnostics.  The --log tree of a
# 1080p frame would be about 0.6 GB, so it is written for a 640x480 photo.
LOG_SCENE = "street.pgm"
# the card's raw dumps against the same dump made on the CPU (0..255)
LOG_CPU_ATOL = 1e-3
PLATFORM_SWITCH = "POPSIFT_TPU_PLATFORM"
HOST_SPLIT_PASSES = 3
# tests/test_repeatability.py's thresholds: (repeatability, matching
# score) above which each warp of its 160x200 scene must stay
REPEAT_THRESHOLDS = {"identity": (0.99, 0.99), "translation": (0.85, 0.85),
                     "rotation": (0.75, 0.75), "scale": (0.75, None)}
# the child's wrapper around the demo's main: it also reports the modules
# of JAX and popsift_tpu that were imported, and fails if there are any
CHILD_DEMO = """import sys
from popsift_torch.cli import demo
rc = demo.main(sys.argv[1:])
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "popsift_tpu")))
print("imported:", bad)
sys.exit(rc or (3 if bad else 0))
"""


def repeat_scene() -> np.ndarray:
    """tests/test_repeatability.py's 160x200 scene of 25 Gaussian blobs."""
    rng = np.random.default_rng(3)
    h, w = 160, 200
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w), np.float32)
    for _ in range(25):
        cx = rng.uniform(20, w - 20)
        cy = rng.uniform(20, h - 20)
        s = rng.uniform(2.0, 6.0)
        img += rng.uniform(0.3, 1.0) * np.exp(
            -(((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s * s))) \
            * rng.choice([-1.0, 1.0])
    img = img - img.min()
    img = img / img.max()
    return (img * 255).astype(np.uint8)


def affine_cases(w: int, h: int) -> dict:
    """tests/test_repeatability.py's four warps, the rotation about the
    image's centre."""
    th = np.deg2rad(12)
    rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    c = np.array([w / 2.0, h / 2.0])
    return {"identity": (np.eye(2), np.zeros(2)),
            "translation": (np.eye(2), np.array([7.0, -4.0])),
            "rotation": (rot, c - rot @ c),
            "scale": (np.eye(2) * 1.15, np.zeros(2))}


def repeatability(pt, img: np.ndarray) -> dict:
    """evaluate_pair of ``img`` and each of its warps, extracted through
    PopSift on the card."""
    from popsift_torch.eval.repeatability import evaluate_pair, warp_affine
    h, w = img.shape
    out = {}
    with pt.PopSift(pt.Config()) as ps:
        fa = ps.enqueue(w, h, img).get()
        for name, (A, t) in affine_cases(w, h).items():
            warped = warp_affine(img, A, t)
            fb = ps.enqueue(w, h, warped).get()
            out[name] = evaluate_pair(fa, fb, A, t, warped.shape)
    return out


def printed(feats) -> str:
    buf = io.StringIO()
    feats.print(buf)
    return buf.getvalue()


def demo_counts(err: str) -> list:
    """(features, descriptors) of each job from the demo's stderr."""
    return [(int(m.group(1)), int(m.group(2))) for m in re.finditer(
        r"Number of feature points: (\d+) number of feature descriptors: "
        r"(\d+)", err)]


def write_cli_inputs(tmp: Path, scenes) -> tuple[Path, Path]:
    """(a) The four scenes as P5 PGMs in one directory (scene 3 sorts
    last), scene 0 as P2 (with a comment) and as P6 (equal channels, so
    its grey value is exact) in another, each read back."""
    from popsift_torch.io.pgm import read_pgm as port_read_pgm
    from popsift_torch.io.pgm import write_pgm
    scene_dir, fmt_dir = tmp / "scenes", tmp / "formats"
    scene_dir.mkdir()
    fmt_dir.mkdir()
    files = []
    for i, s in enumerate(scenes):
        p = scene_dir / f"scene-{i}.pgm"
        write_pgm(str(p), s)
        files.append((p, s))
    s0 = scenes[0]
    h, w = s0.shape
    p2 = fmt_dir / "scene-0-p2.pgm"
    p2.write_bytes(f"P2\n# scene 0\n{w} {h}\n255\n".encode()
                   + "\n".join(" ".join(map(str, r))
                               for r in s0.tolist()).encode() + b"\n")
    p6 = fmt_dir / "scene-0-p6.ppm"
    p6.write_bytes(f"P6\n{w} {h}\n255\n".encode()
                   + np.repeat(s0[..., None], 3, axis=2).tobytes())
    files += [(p2, s0), (p6, s0)]
    t0 = time.perf_counter()
    for p, s in files:
        require(np.array_equal(port_read_pgm(str(p)), s),
                f"{p.name} does not read back as written")
    print(f"  (a) {len(scenes)} scenes written as P5 and scene 0 as P2 and "
          f"P6; each read back equal ({time.perf_counter() - t0:.3f} s for "
          f"the {len(files)} reads)", flush=True)
    return scene_dir, fmt_dir


def run_demo(argv, cwd: Path) -> tuple[int, str]:
    """The demo's main in this process, in ``cwd``; (rc, stderr)."""
    from popsift_torch.cli import demo
    err = io.StringIO()
    with contextlib.chdir(cwd), contextlib.redirect_stderr(err):
        rc = demo.main(argv)
    return rc, err.getvalue()


def check_demo_child(torch, scene_dir: Path, tmp: Path) -> dict:
    """(c) The demo as a child process on its default device."""
    from popsift_torch.gauss import build_gauss_info, format_gauss_tables
    import popsift_torch as pt
    env = dict(os.environ)
    env.pop(PLATFORM_SWITCH, None)
    env["PYTHONPATH"] = str(HERE) + os.pathsep + env.get("PYTHONPATH", "")
    cwd = tmp / "child"
    cwd.mkdir()
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-c", CHILD_DEMO, "-i", str(scene_dir),
         "--print-dev-info", "--print-time-info", "--print-gauss-tables"],
        capture_output=True, text=True, cwd=cwd, env=env, timeout=600)
    wall = time.perf_counter() - t0
    require(r.returncode == 0, f"the demo's child exited {r.returncode}:\n"
            f"{r.stderr[-3000:]}")
    got = tuple(n for n, _ in demo_counts(r.stderr))
    require(got == DEFAULT_FEATURES, f"the child demo's features {got}")
    name = torch.cuda.get_device_name(0)
    require(name in r.stdout, f"the card's name {name!r} not printed")
    tables = format_gauss_tables(build_gauss_info(pt.Config()))
    require(tables in r.stdout, "the child's Gauss tables differ")
    require("imported: []" in r.stdout, "the child imported JAX: "
            + r.stdout.splitlines()[-1])
    times = {ln.split(":")[0]: float(ln.split(":")[1].split()[0])
             for ln in r.stderr.splitlines()
             if ln.startswith(("Enqueue", "Extraction"))}
    require(len(times) == 2, "no enqueue/drain times printed")
    dev_line = next(ln for ln in r.stdout.splitlines() if name in ln)
    print(f"  (c) python -m popsift_torch.cli.demo (through a -c wrapper) on "
          f"its default device: rc 0, features {got}, {dev_line.strip()!r}, "
          f"the Gauss tables equal format_gauss_tables, no JAX or "
          f"popsift_tpu module imported; " + ", ".join(
              f"{k} {v:.3f} ms" for k, v in times.items())
          + f" for {len(got)} images; child wall {wall:.3f} s",
          flush=True)
    return dict(features=list(got), child_wall_s=wall,
                enqueue_ms=times["Enqueue (load + upload dispatch)"],
                drain_ms=times["Extraction (drain)"])


def check_match_cli(pt, scenes, match_stats, tmp: Path) -> dict:
    """(d) popsift_torch.cli.match on scene 0 and its 90-degree rotation
    (phase 8's pair) against match_and_print in this process."""
    from popsift_torch.cli import match
    from popsift_torch.io.pgm import write_pgm
    a = scenes[0]
    b = np.ascontiguousarray(np.rot90(a))
    pa, pb = tmp / "match-left.pgm", tmp / "match-right.pgm"
    write_pgm(str(pa), a)
    write_pgm(str(pb), b)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = match.main(["-l", str(pa), "-r", str(pb)])
    require(rc == 0, f"popsift-match exited {rc}")
    lines = out.getvalue().splitlines()
    with pt.PopSift(pt.Config(), mode=pt.ProcessingMode.MATCHING) as ps:
        left = ps.enqueue(a.shape[1], a.shape[0], a).get_dev()
        right = ps.enqueue(b.shape[1], b.shape[0], b).get_dev()
    ref = io.StringIO()
    left.match_and_print(right, ref)
    require(lines[4:] == ref.getvalue().splitlines(),
            "popsift-match's lines differ from match_and_print's")
    require(lines[:2] == [
        f"Number of features:    {left.get_feature_count()}",
        f"Number of descriptors: {left.get_descriptor_count()}"],
        "popsift-match's counts differ")
    accepted = sum(ln.startswith("accept") for ln in lines[4:])
    want = match_stats["pairs"]["scene 0->scene 0 rot90"]["accepted"]
    require(accepted == want, f"popsift-match accepted {accepted}, phase 8 "
            f"{want}")
    print(f"  (d) popsift-match scene 0 -> its rotation: rc 0, "
          f"{len(lines) - 4} accept/reject lines equal to match_and_print "
          f"in this process, {accepted} accepted as in phase 8", flush=True)
    return dict(lines=len(lines) - 4, accepted=accepted)


def check_log_tree(pt, tmp: Path) -> dict:
    """(e) --log on a 640x480 photograph: the tree, its raw dumps against
    the pyramid route on the card bit for bit and against the CPU's dump,
    and the job's features unchanged by --log."""
    from popsift_torch.debugdump import DIRS, dump_all
    from popsift_torch.extract import extract_features, make_plan

    path = HERE / "tests" / "data" / "scenes" / LOG_SCENE
    img = read_pgm(path).copy()
    h, w = img.shape
    cwd = tmp / "log"
    cwd.mkdir()
    rc, err = run_demo(["-i", str(path), "--log"], cwd)
    require(rc == 0, f"the demo with --log exited {rc}")
    tree = {p.relative_to(cwd).as_posix(): p for p in cwd.rglob("*")
            if p.is_file()}
    require({n.split("/")[0] for n in tree if "/" in n} == set(DIRS),
            f"the --log tree's directories {sorted(tree)[:8]}")
    cfg = pt.Config()
    plan = make_plan(cfg, w, h)
    L = plan.levels + 3
    for d, per_octave in (("dir-octave", L), ("dir-octave-dump", L),
                          ("dir-dog", L - 1), ("dir-dog-txt", L - 1),
                          ("dir-dog-dump", L - 1)):
        n = sum(name.startswith(d + "/") for name in tree)
        require(n == plan.octaves * per_octave, f"{d} holds {n} files")
    with pt.PopSift(cfg) as ps:
        feats = ps.enqueue(w, h, img).get()
    route, stacks, dogs = extract_features(img, cfg, "cuda",
                                           return_pyramid=True)
    require(features_equal(route, feats), "the pyramid route's features "
            "differ from the default path's")
    n_dumps = 0
    for prefix, sub, arrays in (("", "dir-octave-dump", stacks),
                                ("d-", "dir-dog-dump", dogs)):
        for o, t in enumerate(arrays):
            arr = t.cpu().numpy()
            for lvl in range(arr.shape[0]):
                raw = tree[f"{sub}/{prefix}pyramid-o-{o}-l-{lvl}.dump"]
                require(raw.read_bytes() == arr[lvl].tobytes(),
                        f"{raw.name} differs from the pyramid route's")
                n_dumps += 1
    counts = demo_counts(err)
    rows = len(tree["dir-desc/desc-pyramid.txt"].read_text().splitlines())
    require(len(counts) == 1 and rows == counts[0][1]
            == feats.get_descriptor_count(),
            f"dir-desc holds {rows} rows, the job {counts}")
    require(tree["output-features.txt"].read_text() == printed(feats),
            "the --log run's output-features.txt differs from the run "
            "without --log")
    logged = pt.Config()
    logged.set_log_mode(pt.LogMode.ALL)
    (tmp / "log2").mkdir()
    with contextlib.chdir(tmp / "log2"), pt.PopSift(logged) as ps:
        got = ps.enqueue(w, h, img).get()
    require(features_equal(got, feats), "log_mode=ALL moved the features")
    cpu_dir = tmp / "log-cpu"
    dump_all(logged, img, "pyramid", base_dir=str(cpu_dir), device="cpu")
    worst = 0.0
    for name, p in tree.items():
        if name.endswith(".dump"):
            a = np.fromfile(p, np.float32)
            b = np.fromfile(cpu_dir / name, np.float32)
            require(a.shape == b.shape, f"{name}: CPU dump of another size")
            worst = max(worst, float(np.abs(a - b).max()))
    require(worst <= LOG_CPU_ATOL, f"the card's dumps differ from the CPU's "
            f"by {worst}")
    size = sum(p.stat().st_size for p in tree.values())
    print(f"  (e) --log on {LOG_SCENE} ({w}x{h}): {len(tree)} files "
          f"({size / 2 ** 20:.1f} MiB) in the seven directories, "
          f"{plan.octaves} octaves x {L} levels and {L - 1} DoGs; {n_dumps} "
          f"raw dumps bit-equal to the pyramid route on the card; dir-desc "
          f"{rows} rows = the job's descriptors; features bit-equal to the "
          f"run without --log; card against CPU dumps: largest difference "
          f"{worst:.6g} (within {LOG_CPU_ATOL})", flush=True)
    return dict(files=len(tree), mib=size / 2 ** 20, raw_dumps=n_dumps,
                desc_rows=rows, cpu_max_abs=worst)


def traced_passes(torch, pt, scenes, on: bool) -> tuple[float, dict]:
    """HOST_SPLIT_PASSES passes of the scenes through PopSift(Config())
    with the host trace ``on`` or off: ms per image and the snapshot."""
    from popsift_torch import tracing
    h, w = scenes[0].shape
    tracing.HOSTTRACE = on
    try:
        with pt.PopSift(pt.Config()) as ps:
            ps.enqueue(w, h, scenes[-1]).get()
            torch.cuda.synchronize()
            tracing._trace_events.clear()
            t0 = time.perf_counter()
            for _ in range(HOST_SPLIT_PASSES):
                jobs = [ps.enqueue(w, h, s) for s in scenes]
                got = tuple(j.get().get_feature_count() for j in jobs)
                require(got == DEFAULT_FEATURES, f"features {got} with the "
                        f"host trace {'on' if on else 'off'}")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            snap = tracing.host_trace_snapshot(clear=True)
    finally:
        tracing.HOSTTRACE = False
        tracing._trace_events.clear()
    return wall * 1e3 / (HOST_SPLIT_PASSES * len(scenes)), snap


def scope_split(torch, pt, scenes, tmp: Path) -> dict:
    """Per scope: its host ms and the device ms of the kernels and copies
    launched inside it, per image, from a Chrome trace of
    extract_features over the scenes on this thread (only this thread
    extracts while it runs, so a launch belongs to the scope whose range
    holds its runtime call)."""
    from torch.profiler import ProfilerActivity, profile
    from popsift_torch.extract import extract_features
    from popsift_torch.tracing import SCOPES
    extract_features(scenes[-1], pt.Config(), "cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        for s in scenes:
            extract_features(s, pt.Config(), "cuda")
        torch.cuda.synchronize()
        time.sleep(0.05)
    path = tmp / "scopes.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
              if e.get("cat") == "user_annotation" and e.get("name") in SCOPES]
    launch_at = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    n = len(scenes)
    host = {s: 0.0 for s in SCOPES}
    device = {s: 0.0 for s in SCOPES + ("outside",)}
    for t0, t1, name in ranges:
        host[name] += (t1 - t0) / 1e3 / n
    starts = np.array([r[0] for r in ranges])
    order = np.argsort(starts)
    starts = starts[order]
    ranges = [ranges[i] for i in order]
    n_dev = 0
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        n_dev += 1
        at = launch_at.get(e.get("args", {}).get("correlation"))
        where = "outside"
        if at is not None:
            i = int(np.searchsorted(starts, at, side="right")) - 1
            if i >= 0 and ranges[i][0] <= at <= ranges[i][1]:
                where = ranges[i][2]
        device[where] += e["dur"] / 1e3 / n
    missing = [s for s in SCOPES if not any(r[2] == s for r in ranges)]
    require(not missing, f"scopes missing from the profile: {missing}")
    return dict(host_ms=host, device_ms=device if n_dev else None,
                device_records=n_dev)


def host_split(torch, pt, scenes, tmp: Path, smi: str) -> dict:
    """(f) The host's time of the default path by span and by scope."""
    walls = {False: [], True: []}
    snap = wall_on = None
    for on in (False, True, False, True):
        ms, s = traced_passes(torch, pt, scenes, on)
        walls[on].append(ms)
        if on:       # the spans of the last traced run, and its wall
            snap, wall_on = s, ms
    n = HOST_SPLIT_PASSES * len(scenes)
    print(f"  (f) host spans, PopSift(Config()), {HOST_SPLIT_PASSES} passes "
          f"of the 4 scenes with POPSIFT_TPU_HOSTTRACE on ({smi}); features "
          f"{DEFAULT_FEATURES} on every pass:", flush=True)
    spans = {}
    for name in sorted(snap):
        count, total = snap[name]
        if name.startswith("#"):
            spans[name] = total / n
            print(f"      {name:14s} {total / n:10.1f} per image", flush=True)
            continue
        spans[name] = total / n
        print(f"      {name:14s} {total / n:8.3f} ms/image ({count} spans), "
              f"{100 * total / n / wall_on:5.1f}% of the wall", flush=True)
    # stage 1 per octave (stage1.o<k>), stage 2 one pass (stage2)
    groups = {g: sum(v for k, v in spans.items()
                     if k == g or k.startswith(g + ".o"))
              for g in ("stage1", "stage2")}
    covered = spans.get("extract", 0.0)
    print(f"      stage 1 {groups['stage1']:.3f} ms, stage 2 "
          f"{groups['stage2']:.3f} ms per image; the extract spans cover "
          f"{100 * covered / wall_on:.1f}% of the wall "
          f"({wall_on:.3f} ms/image with tracing on; a job span runs from "
          f"enqueue, so the jobs queued behind one overlap)", flush=True)
    print(f"      wall with the host trace off {walls[False]} ms/image, on "
          f"{walls[True]} ms/image (runs off, on, off, on)", flush=True)
    scopes = scope_split(torch, pt, scenes, tmp)
    dev = scopes["device_ms"]
    print(f"      per scope, extract_features profiled on 4 scenes ({smi}): "
          f"host ms / device ms per image", flush=True)
    for name in scopes["host_ms"]:
        print(f"      {name:12s} host {scopes['host_ms'][name]:8.3f}  device "
              f"{fmt_ms(dev and dev[name])}", flush=True)
    if dev:
        print(f"      outside the scopes: device {dev['outside']:.3f} ms "
              f"per image ({scopes['device_records']} device records)",
              flush=True)
    return dict(spans_ms_per_image=spans, extract_share=covered / wall_on,
                traced_wall_ms=wall_on, wall_off_ms=walls[False],
                wall_on_ms=walls[True], **scopes)


def check_repeatability(pt, scenes, smi: str) -> dict:
    """(g) Repeatability on the card: the CPU test's scene held to its
    thresholds, and scene 0 at 1080p printed."""
    small = repeatability(pt, repeat_scene())
    for name, (rep, score) in REPEAT_THRESHOLDS.items():
        res = small[name]
        require(res.repeatability > rep and (score is None
                                             or res.matching_score > score),
                f"repeatability {name}: {res}")
    require(small["identity"].n_ref > 10, "too few identity keypoints")
    big = repeatability(pt, scenes[0])

    def fmt(res):
        return ", ".join(f"{k} {v.repeatability:.4f}/{v.matching_score:.4f}"
                         for k, v in res.items())
    print(f"  (g) repeatability/matching score on the card ({smi}): the "
          f"test's 200x160 scene {fmt(small)} (thresholds "
          f"{REPEAT_THRESHOLDS}); scene 0 at 1080p {fmt(big)}", flush=True)
    import dataclasses
    return {k: {n: dataclasses.asdict(v) for n, v in r.items()}
            for k, r in (("test_scene", small), ("scene0_1080p", big))}


def run_cli(torch, pt, scenes, loop_feats, match_stats, smi: str) -> dict:
    """Phase 10: the command-line tools and diagnostics on the card."""
    import tempfile
    from popsift_torch import kernels
    print(f"phase 10: the CLI, I/O and diagnostics ({smi})", flush=True)
    with tempfile.TemporaryDirectory(prefix="popsift_cli_") as name:
        tmp = Path(name)
        scene_dir, _ = write_cli_inputs(tmp, scenes)

        # (b) the demo in this process
        out = tmp / "demo"
        out.mkdir()
        torch.cuda.synchronize()
        kernels.reset_launches()
        rc, err = run_demo(["-i", str(scene_dir)], out)
        torch.cuda.synchronize()
        counts = kernels.launches()
        require(rc == 0, f"the demo exited {rc}")
        for k in LOOP_PATH:
            require(counts[k] > 0, f"kernel {k} was not launched by the demo")
        for k in NOT_ON_ANY_PATH:
            require(counts[k] == 0, f"kernel {k} was launched by the demo")
        got = tuple(n for n, _ in demo_counts(err))
        require(got == DEFAULT_FEATURES, f"the demo's features {got}")
        require((out / "output-features.txt").read_text()
                == printed(loop_feats[-1]),
                "output-features.txt differs from phase 3's scene 3")
        print(f"  (b) popsift_torch.cli.demo main() on the directory: "
              f"launches {json.dumps(counts)}; features {got}; "
              f"output-features.txt byte-equal to FeaturesHost.print of "
              f"phase 3's scene 3", flush=True)
        stats = dict(counts=counts, features=list(got))
        stats["child"] = check_demo_child(torch, scene_dir, tmp)
        stats["match"] = check_match_cli(pt, scenes, match_stats, tmp)
        stats["log"] = check_log_tree(pt, tmp)
        stats["host"] = host_split(torch, pt, scenes, tmp, smi)
    stats["repeatability"] = check_repeatability(pt, scenes, smi)
    return stats


# Phase 11, the multi-device SfM front end (popsift_torch.parallel): (a)
# one NCCL rank in this process, (b) four gloo ranks sharing the card, (c)
# dryrun_multichip on NCCL, one rank a card.
PARALLEL_TIMEOUT_S = 600.0
STEP_REPEATS = 3


def frames_key(pt, feats, w: int, h: int) -> tuple:
    """key_from_counts of the largest per-octave extrema and descriptor
    rows of ``feats``: a key that holds every row of each frame."""
    from popsift_torch.parallel.batch import key_from_counts
    plan = pt.extract.make_plan(pt.Config(), w, h)
    counts = np.zeros(plan.octaves, np.int64)
    rows = np.zeros(plan.octaves, np.int64)
    for f in feats:
        s = f.soa()
        counts = np.maximum(counts, np.bincount(
            s["debug_octave"], minlength=plan.octaves))
        rows = np.maximum(rows, np.bincount(
            s["debug_octave"], weights=s["num_ori"],
            minlength=plan.octaves).astype(np.int64))
    return key_from_counts(plan, counts.tolist(), rows.tolist())


def timed_steps(torch, run, args, reps: int, barrier=None) -> list:
    walls = []
    for _ in range(reps):
        if barrier is not None:
            barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(*args)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return walls


def step_pairs(match, out) -> list:
    """The sharded matcher's per-row results of each pair i -> i+1 of a
    step's blocks, as the step matches them."""
    d, v = out["desc"], out["desc_valid"]
    return [tuple(t.cpu().numpy() for t in match(d[i], d[i + 1], v[i + 1]))
            for i in range(d.shape[0] - 1)]


def to_host(out: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in out.items()}


def parallel_rank(rank: int, scenes: np.ndarray, key: tuple,
                  reps: int) -> dict:
    """(b)'s rank: the step on scenes padded over a (2, 2) mesh whose
    four gloo ranks share cuda:0."""
    import torch
    import torch.distributed as dist
    from popsift_torch import Config
    from popsift_torch.parallel import batch as pb
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = pb.make_mesh(2, 2, device="cuda:0")
    h, w = scenes.shape[1:]
    run, _ = pb.sfm_frontend_step(Config(), w, h, mesh, desc_cap=key[4],
                                  key=key)
    padded, valid = pb.pad_batch(scenes, mesh)
    out = run(padded, valid)
    walls = timed_steps(torch, run, (padded, valid), reps, dist.barrier)
    again = run(padded, valid)
    return dict(to_host(out), pairs=step_pairs(pb.sharded_match(mesh), out),
                walls=walls, again=to_host(again),
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)


def require_pairs_equal(got: list, want: list, blocks, label: str) -> int:
    """Per pair, the rows (of valid left descriptors) whose best, second
    or accept differ between two matchers: each must be a near tie of the
    float64 matcher on the pair's valid blocks, and at most
    MOST_NEAR_TIE_MISMATCHES of the rows.  Returns how many differ."""
    n_differ = 0
    for i, (g, w) in enumerate(zip(got, want)):
        l, r = blocks[i], blocks[i + 1]
        n = l.shape[0]
        differ = ((g[0][:n] != w[0][:n]) | (g[1][:n] != w[1][:n])
                  | (g[2][:n] != w[2][:n]))
        if differ.any():
            _, _, _, pd1, pd2, pd3 = plain_match64(l, r)
            near = ((pd2 - pd1 <= NEAR_TIE) | (pd3 - pd2 <= NEAR_TIE)
                    | (np.abs(pd1 / np.maximum(pd2, 1e-300) - 0.8)
                       <= NEAR_TIE))
            require(bool(near[differ].all()),
                    f"{label}: pair {i}->{i + 1} differs away from a near "
                    f"tie at rows {np.flatnonzero(differ & ~near)[:10]}")
            require(int(differ.sum()) <= MOST_NEAR_TIE_MISMATCHES * n,
                    f"{label}: pair {i}->{i + 1}: {int(differ.sum())} of "
                    f"{n} rows differ")
        n_differ += int(differ.sum())
    return n_differ


def run_parallel(torch, pt, scenes, loop_feats, smi: str) -> dict:
    """Phase 11: the multi-device SfM front end on the card."""
    import shutil
    import tempfile
    from datetime import timedelta

    import torch.distributed as dist
    from popsift_torch import kernels
    from popsift_torch.ops.match import match_brute_force
    from popsift_torch.parallel import batch as pb
    from popsift_torch.parallel.dryrun import dryrun_multichip
    from popsift_torch.parallel.ranks import run_ranks

    print(f"phase 11: the multi-device SfM front end ({smi})", flush=True)
    t_phase = time.perf_counter()
    h, w = scenes[0].shape
    images = np.stack(scenes)
    key = frames_key(pt, loop_feats, w, h)
    host = [f.get_descriptors() for f in loop_feats]
    stats = dict(key=key)

    # (a) one NCCL rank, initialised here through a FileStore
    tmp = tempfile.mkdtemp(prefix="popsift_store_")
    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
        rank=0, world_size=1, timeout=timedelta(seconds=120))
    try:
        mesh = pb.make_mesh(1, 1, device="cuda:0")
        run, _ = pb.sfm_frontend_step(pt.Config(), w, h, mesh,
                                      desc_cap=key[4], key=key)
        # the frames already on the card, as a caller that decodes there
        frames = torch.as_tensor(images, device="cuda:0")
        run(frames)                                   # first use
        torch.cuda.synchronize()
        kernels.reset_launches()
        out = run(frames)
        torch.cuda.synchronize()
        counts = kernels.launches()
        walls_a = timed_steps(torch, run, (frames,), STEP_REPEATS)
        match = pb.sharded_match(mesh)
        pairs_a = step_pairs(match, out)
        dense = [tuple(t.cpu().numpy() for t in match_brute_force(
            out["desc"][i], out["desc"][i + 1], l_valid=out["desc_valid"][i],
            r_valid=out["desc_valid"][i + 1])) for i in range(3)]
        default_run, _ = pb.sfm_frontend_step(pt.Config(), w, h, mesh)
        out_default = default_run(images)
        over_default = out_default["overflow"].cpu().tolist()
        ext_default = out_default["ext_counts"][0].cpu().tolist()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    a = to_host(out)
    rows = a["desc_valid"].sum(axis=1)
    for i, f in enumerate(loop_feats):
        require(rows[i] == f.get_descriptor_count()
                and bits_equal(a["desc"][i][:rows[i]], host[i]),
                f"(a) image {i}: rows differ from phase 3's descriptors")
    require(tuple(a["ext_counts"][0]) == DEFAULT_FEATURES,
            f"(a) ext_counts {a['ext_counts'].tolist()}")
    require(not a["overflow"].any(), f"(a) overflow {a['overflow']}")
    for k in LOOP_PATH:
        require(counts[k] > 0, f"(a) kernel {k} was not launched")
    for k in NOT_ON_ANY_PATH:
        require(counts[k] == 0, f"(a) kernel {k} was launched")
    blocks = [a["desc"][i][:rows[i]] for i in range(4)]
    mc = a["match_counts"].tolist()
    require(mc == [int((p[2] & a["desc_valid"][i]).sum())
                   for i, p in enumerate(pairs_a)],
            "(a) match_counts differ from the sharded matcher's rows")
    accepted = [int(p[2].sum()) for p in dense]
    differ_a = require_pairs_equal(pairs_a, dense, blocks,
                                   "(a) against match_brute_force")
    require(all(abs(m - d) <= differ_a for m, d in zip(mc, accepted)),
            f"(a) match_counts {mc}, match_brute_force {accepted}")
    print(f"  (a) 1 NCCL rank, mesh (1, 1), 4 scenes on the card, key {key}: "
          f"launches {json.dumps(counts)}; rows {rows.tolist()} bit-equal "
          f"to phase 3's descriptors; ext_counts "
          f"{a['ext_counts'][0].tolist()}; overflow "
          f"{a['overflow'].tolist()}; match_counts {mc} "
          f"(match_brute_force {accepted}, rows differing {differ_a}); "
          f"under the default key extrema {ext_default}, overflow "
          f"{over_default}", flush=True)
    stats.update(counts=counts, match_counts=mc, dense_accepted=accepted,
                 overflow_default_key=over_default,
                 ext_counts_default_key=ext_default,
                 step_ms_one_rank=walls_a)

    # (b) four gloo ranks sharing the card, scenes 0-2 padded to four
    t0 = time.perf_counter()
    outs = run_ranks(parallel_rank, 4, "gloo",
                     args=(images[:3], key, STEP_REPEATS),
                     timeout=PARALLEL_TIMEOUT_S)
    wall_b = time.perf_counter() - t0
    b = outs[0]
    fields = ("ext_counts", "overflow", "desc", "desc_valid", "match_counts")
    for r, o in enumerate(outs):
        for k in fields:
            require(bits_equal(o[k], b[k]) and bits_equal(o["again"][k],
                                                          b[k]),
                    f"(b) rank {r}'s {k} differs from rank 0's")
        for p, q in zip(o["pairs"], b["pairs"]):
            require(all(bits_equal(x, y) for x, y in zip(p, q)),
                    f"(b) rank {r}'s matches differ from rank 0's")
    rows_b = b["desc_valid"].sum(axis=1)
    for i in range(3):
        require(rows_b[i] == rows[i] and bits_equal(
            b["desc"][i][:rows[i]], a["desc"][i][:rows[i]]),
            f"(b) image {i}: rows differ from (a)'s")
    require(rows_b[3] == 0, "(b) the pad frame has valid rows")
    require(b["match_counts"][2] == 0, "(b) the pad pair has matches")
    require(tuple(b["ext_counts"][0][:3]) == DEFAULT_FEATURES[:3],
            f"(b) ext_counts {b['ext_counts'].tolist()}")
    differ_b = require_pairs_equal(b["pairs"][:2], pairs_a[:2], blocks,
                                   "(b) against (a)")
    print(f"  (b) 4 gloo ranks sharing cuda:0, mesh (2, 2), scenes 0-2 + 1 "
          f"pad: the ranks bit-equal (two steps each); rows "
          f"{rows_b.tolist()}, real frames bit-equal to (a); match_counts "
          f"{b['match_counts'].tolist()} (rows differing from (a) at near "
          f"ties {differ_b}); "
          f"peak {max(o['peak_gib'] for o in outs):.3f} GiB a rank; "
          f"{wall_b:.1f} s with start-up ({smi})", flush=True)
    stats.update(match_counts_4=b["match_counts"].tolist(),
                 rows_differing_4=differ_b,
                 step_ms_four_ranks=[max(o["walls"][j] for o in outs)
                                     for j in range(STEP_REPEATS)],
                 ranks_wall_s=wall_b)

    # (c) dryrun_multichip on NCCL, one rank a card
    stats["dryrun"] = dryrun_multichip(torch.cuda.device_count(), "cuda")
    print(f"  (c) {stats['dryrun']}", flush=True)

    # (d) the wall of one step, median of three (no claim)
    for label, k in (("(a) 1 rank, 4 scenes", "step_ms_one_rank"),
                     ("(b) 4 ranks, 3 scenes + pad", "step_ms_four_ranks")):
        print(f"  (d) {label}: step {float(np.median(stats[k])):.3f} ms "
              f"(median of {', '.join(f'{t:.3f}' for t in stats[k])}; "
              f"{smi})", flush=True)
    stats["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 11 took {stats['phase_s']:.1f} s ({smi})", flush=True)
    return stats


# Phase 12, the lossless wire codec (popsift_torch.wirecodec): numpy encode
# on the host, decode on the card, and the codec upload into the
# extraction.  Synthetic frames at the scenes' size reach the schemes the
# scenes do not (all four take the bitmap scheme, bits=1).
CODEC_REPEATS = 5


def integrate_d2(d2: np.ndarray) -> np.ndarray:
    """The u8 image whose mod-256 second difference is ``d2``."""
    dy = np.cumsum(d2 % 256, axis=1) % 256
    return (np.cumsum(dy, axis=0) % 256).astype(np.uint8)


def codec_frames(h: int, w: int) -> dict:
    """(name: (frame, scheme)) of the synthetic frames: residuals +-1 with
    0.5% escapes (2-bit codes), residuals in [-5, 5] with 1% escapes
    (nibbles), and uniform noise (no buffer: raw upload)."""
    rng = np.random.default_rng(14)
    two = rng.choice(np.array([-1, 1], np.int16), (h, w))
    two[rng.random((h, w)) > 0.995] = 77
    four = rng.integers(-5, 6, (h, w)).astype(np.int16)
    four[rng.random((h, w)) > 0.99] = -90
    return {"two-bit": (integrate_d2(two), 2),
            "four-bit": (integrate_d2(four), 4),
            "noise": (rng.integers(0, 256, (h, w), dtype=np.uint8), None)}


def kernel_breakdown(torch, fn, reps: int = 10, top: int = 8) -> list:
    """(kernel name, device ms a call, launches a call) of the ``top``
    kernels by device time over ``reps`` calls of ``fn`` (torch.profiler,
    50 ms idle on each side)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(0.05)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.05)
    rows = []
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
        if t > 0:
            rows.append((e.key, t / reps / 1e3, e.count / reps))
    return sorted(rows, key=lambda r: -r[1])[:top]


def run_codec(torch, pt, scenes, loop_feats, smi: str) -> dict:
    """Phase 12: the lossless wire codec on the card."""
    from popsift_torch import kernels
    from popsift_torch import wirecodec as wc
    from popsift_torch.extract import extract_features

    print(f"phase 12: the lossless wire codec ({smi})", flush=True)
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    h, w = scenes[0].shape
    frames = {f"scene {i}": (s, 1) for i, s in enumerate(scenes)}
    frames.update(codec_frames(h, w))
    stats = dict(frames={})

    # (a) encode on the host, (b) decode on the card against the frame and
    # the CPU decode of the same buffer, (d) times
    for name, (img, want) in frames.items():
        enc = []
        for _ in range(CODEC_REPEATS):
            t0 = time.perf_counter()
            buf = wc.encode_u8(img)
            enc.append((time.perf_counter() - t0) * 1e3)
        bits = None if buf is None else int(buf[:16].view(np.uint32)[2])
        require(bits == want, f"(a) {name}: scheme {bits}, expected {want}")
        row = dict(bits=bits, raw_bytes=img.size,
                   encode_ms=float(np.median(enc)),
                   h2d_raw_ms=cuda_ms(
                       lambda: torch.from_numpy(img).to(dev)))
        if buf is None:
            decodes = []
            real = wc.decode_u8
            wc.decode_u8 = lambda *a: decodes.append(a) or real(*a)
            try:
                up = wc.upload_image_u8(img, dev)
            finally:
                wc.decode_u8 = real
            require(not decodes, f"(b) {name}: decoded, not uploaded raw")
            require(up.device.type == dev.type and up.dtype == torch.uint8
                    and bits_equal(up.cpu().numpy(), img),
                    f"(b) {name}: the raw upload differs from the frame")
            print(f"  {name}: no buffer (raw {img.size} B), encode "
                  f"{row['encode_ms']:.3f} ms; upload_image_u8 uploaded it "
                  f"raw, equal; H2D raw {row['h2d_raw_ms']:.4f} ms",
                  flush=True)
            stats["frames"][name] = row
            continue
        host = torch.from_numpy(buf)
        dbuf = host.to(dev)
        got = wc.decode_u8(dbuf, h, w, bits)
        torch.cuda.synchronize()
        require(got.device.type == dev.type and got.dtype == torch.uint8,
                f"(b) {name}: decoded to {got.dtype} on {got.device}")
        require(bits_equal(got.cpu().numpy(), img),
                f"(b) {name}: the card's decode differs from the frame")
        require(bits_equal(got.cpu().numpy(),
                           wc.decode_u8(host, h, w, bits).numpy()),
                f"(b) {name}: the card's decode differs from the CPU's")
        row.update(wire_bytes=buf.size,
                   h2d_buffer_ms=cuda_ms(lambda: host.to(dev)),
                   decode_ms=cuda_ms(lambda: wc.decode_u8(dbuf, h, w, bits)),
                   decode_device_ms=all_device_ms(
                       torch, lambda: wc.decode_u8(dbuf, h, w, bits)))
        stats["frames"][name] = row
        print(f"  {name}: bits={bits}, {buf.size} B of {img.size} raw "
              f"({img.size / buf.size:.2f}x); decode on the card = frame = "
              f"CPU decode, bit for bit; encode {row['encode_ms']:.3f} ms "
              f"(host, median of {CODEC_REPEATS}); H2D buffer "
              f"{row['h2d_buffer_ms']:.4f} ms, raw {row['h2d_raw_ms']:.4f} "
              f"ms; decode {row['decode_ms']:.4f} ms (events), "
              f"{fmt_ms(row['decode_device_ms'])} ms (device)", flush=True)

    # (c) the codec upload into the extraction, launch counts reset just
    # before: phase 3's features bit for bit
    uploads = [wc.upload_image_u8(s, dev) for s in scenes]
    extract_features(uploads[-1], pt.Config(), dev)            # first use
    torch.cuda.synchronize()
    kernels.reset_launches()
    feats = [extract_features(u, pt.Config(), dev) for u in uploads]
    torch.cuda.synchronize()
    counts = kernels.launches()
    for k in LOOP_PATH:
        require(counts[k] > 0, f"(c) kernel {k} was not launched")
    for k in NOT_ON_ANY_PATH:
        require(counts[k] == 0, f"(c) kernel {k} was launched")
    got = tuple(f.get_feature_count() for f in feats)
    require(got == DEFAULT_FEATURES, f"(c) features per image {got}")
    for i, (a, b) in enumerate(zip(feats, loop_feats)):
        require(features_equal(a, b),
                f"(c) scene {i}: features differ from phase 3's")
    digests = [hashlib.sha256(f.get_descriptors().tobytes()).hexdigest()[:16]
               for f in feats]
    require(digests == [hashlib.sha256(f.get_descriptors().tobytes())
                        .hexdigest()[:16] for f in loop_feats],
            "(c) descriptor digests differ from phase 3's")
    print(f"  (c) extract_features(upload_image_u8(scene, cuda)): features "
          f"{got}, bit-equal to phase 3's (descriptor sha256 "
          f"{', '.join(digests)}); launches {json.dumps(counts)}", flush=True)
    stats.update(counts=counts, features=list(got), desc_sha256=digests)

    # where the decode's device time goes (scene 0's buffer)
    dbuf = torch.from_numpy(wc.encode_u8(scenes[0])).to(dev)
    stats["decode_kernels"] = kernel_breakdown(
        torch, lambda: wc.decode_u8(dbuf, h, w, 1))
    print("  (d) scene 0's decode by kernel, device ms a call (launches): "
          + "; ".join(f"{t:.4f} ({c:g}) {k[:60]}"
                      for k, t, c in stats["decode_kernels"]), flush=True)

    # (e) no JAX module and no popsift_tpu module
    require(not any(m == "jax" or m.startswith(("jax.", "popsift_tpu"))
                    for m in sys.modules), "JAX was imported")
    print("  (e) no JAX module and no popsift_tpu module was imported",
          flush=True)
    stats["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 12 took {stats['phase_s']:.1f} s ({smi})", flush=True)
    return stats


# Phase 13, the accuracy harness (popsift_torch.eval): the Oxford-shaped
# protocol in the three SiftModes, the card against the CPU on three of
# its images, and the reference script's output tree and pack.
OXFORD_RECORD = HERE / "PARITY_r05.json"
# the protocol's summary numbers against the record's
OXFORD_SUMMARY_ATOL = 0.005
# a row's keypoint counts within max(OXFORD_ROW_KEYPOINTS, 1%) of the
# record's and its rates within OXFORD_ROW_RATE; at most
# OXFORD_MOST_ROWS_OFF of a mode's rows may lie outside that
OXFORD_ROW_KEYPOINTS = 3
OXFORD_ROW_RATE = 0.01
OXFORD_MOST_ROWS_OFF = 2
OXFORD_KEYS = ("n_ref", "n_warped", "repeatability", "matching_score",
               "desc_l2")
# Scenes whose record rows are not what the JAX package computes on the
# CPU: PARITY_r05.json was taken on a TPU, and there china_l's first image
# gave 74 (PopSift, VLFeat) and 68 (OpenCV) keypoints fewer inside the
# image than the JAX package's get_extractor, its staged extractor and its
# batch program under the tool's frozen key give on the CPU, each 2966
# features in PopSift mode, the port's count (tests/
# test_torch_oxford_record.py).  Their rows are held to the port's rows on
# the CPU, made in the same run, at the same bounds.
OXFORD_RECORD_DIVERGES = ("china_l",)


def row_deviation(got: dict, want: dict) -> tuple[dict, bool]:
    """A protocol row's deviation from a reference row, key by key, and
    whether it lies within the bounds."""
    dev = {k: (None if got[k] is None or want[k] is None
               else got[k] - want[k]) for k in OXFORD_KEYS}
    within = all(abs(dev[k]) <= max(OXFORD_ROW_KEYPOINTS, 0.01 * want[k])
                 for k in ("n_ref", "n_warped")) and all(
        abs(dev[k]) <= OXFORD_ROW_RATE
        for k in ("repeatability", "matching_score"))
    return dev, within


def check_protocol_mode(oxford, mode: str, record: dict, smi: str) -> dict:
    """(a) one SiftMode's protocol on the card against the record, and the
    rows of OXFORD_RECORD_DIVERGES against the port on the CPU."""
    t0 = time.perf_counter()
    payload = oxford.run_protocol([mode], device="cuda", workers=1,
                                  log=None)
    wall = time.perf_counter() - t0
    res, rec = payload["results"][mode], record[mode]
    summary = res["summary"]
    require(oxford.passes(summary), f"(a) {mode}: below the pass bar "
            f"(img1-2 repeatability >= {oxford.PASS_REPEATABILITY_12}, "
            f"matching score >= {oxford.PASS_MATCHING_SCORE_12}): {summary}")
    summary_dev = {k: summary[k] - rec["summary"][k] for k in summary}
    require(len(res["rows"]) == len(rec["rows"]) == 40,
            f"(a) {mode}: {len(res['rows'])} rows")
    t0 = time.perf_counter()
    cpu = oxford.run_protocol([mode], OXFORD_RECORD_DIVERGES, device="cpu",
                              workers=1, log=None)["results"][mode]["rows"]
    cpu_s = time.perf_counter() - t0
    cpu_rows = {(r["scene"], r["pair"]): r for r in cpu}
    off, largest = [], {k: 0.0 for k in OXFORD_KEYS}
    largest_cpu = dict(largest)
    for got, want in zip(res["rows"], rec["rows"]):
        where = (got["scene"], got["pair"])
        require(where == (want["scene"], want["pair"]),
                f"(a) {mode}: row {where} against {want['scene']} "
                f"{want['pair']}")
        held, within = row_deviation(got, cpu_rows.get(where, want))
        into = largest
        if where in cpu_rows:
            into = largest_cpu
            print(f"  (a) {mode} {where[0]} {where[1]}: off the record by "
                  f"{json.dumps(row_deviation(got, want)[0])}, off the CPU "
                  f"by {json.dumps(held)}", flush=True)
        for k, v in held.items():
            if v is not None and abs(v) > abs(into[k]):
                into[k] = v
        if not within:
            off.append(dict(scene=where[0], pair=where[1], **held))
            print(f"  (a) {mode} {where[0]} {where[1]}: off by "
                  f"{json.dumps(held)} (card {json.dumps(got)})",
                  flush=True)
    print(f"  (a) {mode}: {json.dumps(summary)}; record "
          f"{json.dumps(rec['summary'])}; summary deviation "
          f"{json.dumps({k: round(v, 6) for k, v in summary_dev.items()})}; "
          f"largest row deviation from the record {json.dumps(largest)}, "
          f"of {', '.join(OXFORD_RECORD_DIVERGES)} from the CPU "
          f"{json.dumps(largest_cpu)}; {len(off)} of 40 rows off; "
          f"{wall:.1f} s for 48 images on the card, {cpu_s:.1f} s for "
          f"{len(cpu_rows) + len(OXFORD_RECORD_DIVERGES)} on the CPU "
          f"({smi})", flush=True)
    require(all(abs(v) <= OXFORD_SUMMARY_ATOL for v in summary_dev.values()),
            f"(a) {mode}: summary off the record by more than "
            f"{OXFORD_SUMMARY_ATOL}: {summary_dev}")
    require(len(off) <= OXFORD_MOST_ROWS_OFF,
            f"(a) {mode}: {len(off)} rows off the record")
    return dict(summary=summary, record_summary=rec["summary"],
                summary_deviation=summary_dev, largest_row_deviation=largest,
                largest_cpu_row_deviation=largest_cpu, rows_off=off,
                wall_s=wall, cpu_s=cpu_s, device=payload["device"])


def check_parity_tree(torch, parity, tmp: Path) -> dict:
    """(c) the reference-layout tree of street.pgm on the card against the
    CPU's, and a pack of one synthetic scene."""
    img = np.array(read_pgm(HERE / "tests" / "data" / "scenes" / LOG_SCENE))
    card, cpu = tmp / "card" / "output-street", tmp / "cpu" / "output-street"
    parity.produce_output_tree(img, str(card), device="cuda")
    parity.produce_output_tree(img, str(cpu), device="cpu")
    ok, msgs = parity.compare_tree(str(card), str(cpu))
    kp_ok, kp_msg = parity.compare_features(
        str(card / "keypoints.txt"), str(cpu / "keypoints.txt"),
        parity.KP_EPS, parity.MIN_REPEATABILITY, parity.TOL_DESC_L2)
    print(f"  (c) {LOG_SCENE}'s reference-layout tree, card against CPU: "
          f"pyramid {msgs[0]}; dog {msgs[1]}; features.txt {msgs[2]}; "
          f"keypoints.txt {kp_msg}", flush=True)
    require(ok and kp_ok, "(c) the card's tree fails against the CPU's")
    for leaf in ("features.txt", "keypoints.txt", "descriptors.txt"):
        n = len((card / leaf).read_text().splitlines())
        require(n > 0 and n == len((cpu / leaf).read_text().splitlines()),
                f"(c) {leaf}: {n} rows on the card")
    pack = tmp / "pack.tgz"
    parity.build_pack([("synthetic0", parity.synthetic_scene(100))],
                      str(pack), device="cuda")
    with tarfile.open(pack) as tf:
        names = tf.getnames()
        manifest = json.load(tf.extractfile("parity-pack/MANIFEST.json"))
    base = "parity-pack/synthetic0/output-synthetic0"
    for leaf in ("features.txt", "keypoints.txt", "descriptors.txt"):
        require(f"{base}/{leaf}" in names, f"(c) the pack has no {leaf}")
    for sub, stem in (("dir-octave", "pyramid"), ("dir-dog", "d-pyramid")):
        require(any(n.startswith(f"{base}/{sub}/{stem}-o-0-l-")
                    for n in names), f"(c) the pack has no {sub}")
    require(manifest["images"] == {"synthetic0": {"h": 480, "w": 640}},
            f"(c) the pack's manifest: {manifest['images']}")
    print(f"  (c) build_pack of one synthetic 640x480 scene on the card: "
          f"{len(names)} entries in the reference layout, "
          f"{pack.stat().st_size} B", flush=True)
    return dict(tree=msgs + [kp_msg], pack_entries=len(names))


def run_oxford(torch, pt, smi: str) -> dict:
    """Phase 13: the accuracy harness on the card."""
    from popsift_torch import kernels
    from popsift_torch.extract import extract_features
    from popsift_torch.eval import oxford, parity

    print(f"phase 13: the accuracy harness ({smi})", flush=True)
    t_phase = time.perf_counter()
    record = json.loads(OXFORD_RECORD.read_text())["results"]
    stats = dict(modes={})

    # (a) the protocol in each SiftMode, launch counts reset just before
    torch.cuda.synchronize()
    kernels.reset_launches()
    for mode in oxford.MODES:
        stats["modes"][mode] = check_protocol_mode(oxford, mode, record, smi)
    torch.cuda.synchronize()
    counts = kernels.launches()
    for k in LOOP_PATH:
        require(counts[k] > 0, f"(a) kernel {k} was not launched")
    for k in NOT_ON_ANY_PATH:
        require(counts[k] == 0, f"(a) kernel {k} was launched")
    print(f"  (a) launches {json.dumps(counts)}", flush=True)
    stats["counts"] = counts

    # (b) the card against the CPU on the protocol's images: hopper's
    # first, flower_r's second (the light family) and average's at JPEG
    # quality 75, a low-contrast photograph (grey levels 21-70) in which
    # neither finds a feature, as the record's 0/0 rows of that scene say
    cfg = oxford.protocol_config("popsift")
    check_against_cpu(torch, pt, cfg, "(b) hopper img1",
                      scene=oxford.load_scene("hopper"))
    check_against_cpu(torch, pt, cfg, "(b) flower_r img2",
                      scene=oxford.make_sequence(
                          oxford.load_scene("flower_r"), "light")[0][0])
    q75 = oxford.make_sequence(oxford.load_scene(oxford.JPEG_SCENE),
                               "jpeg")[0][0]
    n_q75 = [extract_features(q75, cfg, device).get_feature_count()
             for device in ("cpu", "cuda")]
    print(f"  (b) average q75: {n_q75[0]} CPU / {n_q75[1]} GPU features",
          flush=True)
    require(n_q75[0] == n_q75[1], "(b) average q75: the card and the CPU "
            "find different numbers of features")
    stats["average_q75_features"] = n_q75

    with tempfile.TemporaryDirectory() as tmp:
        stats["parity"] = check_parity_tree(torch, parity, Path(tmp))

    require(not any(m == "jax" or m.startswith(("jax.", "popsift_tpu", "PIL"))
                    for m in sys.modules), "JAX or PIL was imported")
    stats["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 13 took {stats['phase_s']:.1f} s ({smi})", flush=True)
    return stats


def run_stage_in(torch, pt, scenes, smi: str) -> dict:
    """Phase 14: ``PopSift.enqueue`` stages each image onto the card band
    by band through its page-locked ring.  A 6000x4000 float32 window (a
    row stride, AliceVision's configuration) and a 1080p byte frame go
    through ``enqueue`` with the recorder on, the caller zeroing its
    array at once: the job's device image bit-equal to the upload it
    replaced (the array's pageable upload, floats normalised on the host
    first), its features
    bit-equal to ``extract_features`` of that upload, the photograph in
    more than one band and the frame in one.  Prints the bands, the
    ``stage_in`` and ``upload`` spans, and the staging's time against the
    replaced host copy and pageable upload (medians of 5, printed only)."""
    from benchmark.inputs.photo_float import make_canvas
    from benchmark.run import make_config
    from popsift_torch import tracing
    from popsift_torch.extract import extract_features, normalize_input
    print("phase 14: the stage-in ring", flush=True)
    dev = torch.device("cuda")

    def upload(image):
        if image.dtype != np.uint8:
            image = normalize_input(image)
        return torch.from_numpy(np.ascontiguousarray(image)).to(dev)
    av = json.loads((HERE / "benchmark" / "configs"
                     / "alicevision-popsift-24mp.json").read_text())
    canvas = make_canvas([24, 1], 4000 + 40, 6000 + 40)
    cases = (("6000x4000 float32 window", make_config(pt, av["popsift_config"]),
              pt.ImageMode.FLOAT, canvas[17:4017, 23:6023]),
             ("1080p byte frame", pt.Config(), pt.ImageMode.BYTE,
              scenes[1].copy()))
    stats = {}
    was = tracing.HOSTTRACE
    for label, cfg, imode, image in cases:
        h, w = image.shape
        plain = upload(image)
        want = extract_features(plain, cfg, dev)
        tracing.host_trace_snapshot(clear=True)
        tracing.enable(True)
        try:
            with pt.PopSift(cfg, imode=imode, device=dev) as ps:
                job = ps.enqueue(w, h, image)
                image[...] = 0            # the caller reuses its array
                got = job.get()
                img = job.get_img()
                snap = tracing.host_trace_snapshot(clear=True)
                require(torch.equal(img, plain),
                        f"{label}: the staged image differs from the "
                        f"upload")
                require(features_equal(got, want),
                        f"{label}: features differ from those of the "
                        f"upload")
                image[...] = plain.cpu().numpy()
                buf = np.empty_like(image)

                def replaced():
                    np.copyto(buf, image)
                    upload(buf)
                    torch.cuda.synchronize(dev)

                def staged():
                    _, ready, _ = ps._stage_in.stage(image, image.dtype)
                    ready.synchronize()
                times = {}
                for name, fn in (("replaced", replaced),
                                 ("staged", staged)) * 2:
                    fn()
                    t = []
                    for _ in range(5):
                        t0 = time.perf_counter()
                        fn()
                        t.append((time.perf_counter() - t0) * 1e3)
                    times.setdefault(name, []).append(float(np.median(t)))
        finally:
            tracing.enable(was)
        bands = snap["#stage_in.bands"][1]
        require(bands > 1 if imode == pt.ImageMode.FLOAT else bands == 1,
                f"{label}: {bands} bands")
        stats[label] = dict(bands=bands, features=got.get_feature_count(),
                            stage_in_ms=snap["stage_in"][1],
                            upload_ms=snap["upload"][1],
                            replaced_ms=times["replaced"],
                            staged_ms=times["staged"])
        print(f"  {label}: device image and {got.get_feature_count()} "
              f"features bit-equal to the upload's; {bands:.0f} band(s), "
              f"stage_in {snap['stage_in'][1]:.3f} ms, upload span "
              f"{snap['upload'][1]:.3f} ms; staging "
              f"{', '.join(f'{t:.3f}' for t in times['staged'])} ms against "
              f"host copy + pageable upload "
              f"{', '.join(f'{t:.3f}' for t in times['replaced'])} ms "
              f"(medians of 5, in turns; {smi})", flush=True)
    return stats


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    import popsift_torch as pt
    if HERE not in Path(pt.__file__).resolve().parents:
        raise RuntimeError(f"popsift_torch imported from {pt.__file__}, "
                           f"not from {HERE}")
    require(not any(m == "jax" or m.startswith(("jax.", "popsift_tpu"))
                    for m in sys.modules), "JAX was imported")
    from popsift_torch.kernels import _lib

    # phases 2-4 run with the stack kernels off, and the CLI on the card,
    # whatever the caller set
    os.environ.pop(STACK_SWITCH, None)
    os.environ.pop(PLATFORM_SWITCH, None)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = smi_line()
    print(smi, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s)", flush=True)
    t0 = time.perf_counter()
    _lib.library(torch.device("cuda"))
    print(f"phase 1: kernel library built in "
          f"{_lib.build_info.get('build_seconds', 0.0):.1f} s "
          f"(ready after {time.perf_counter() - t0:.1f} s): "
          f"{_lib.build_info['path']}", flush=True)
    log = Path(_lib.build_info["log_path"])
    ptxas_report(log.read_text() if log.exists() else "",
                 ("octave_chain", "desc_loop", "sep_blur", "blur_chain",
                  "detect", "ori_peaks", "refine", "compact",
                  "desc_grid_stack", "desc_grid_rounded_stack",
                  "desc_iloop_stack", "gather_windows"))

    t_scene = time.perf_counter()
    scenes = [make_scene(seed, 1080, 1920) for seed in range(4)]
    print(f"  4 scenes made in {time.perf_counter() - t_scene:.1f} s",
          flush=True)
    table = Table()
    check_kernels(torch, pt, scenes[0], table, torch.device("cuda"))
    check_chain_fields(torch, pt, scenes, torch.device("cuda"))
    check_budget_masks(torch, pt, scenes, torch.device("cuda"))

    print("phase 3: the default path, ", end="")
    loop_stats, loop_feats = run_path(torch, pt, scenes, pt.Config(),
                                      "PopSift(Config())", LOOP_PATH,
                                      not_launched=NOT_ON_ANY_PATH,
                                      not_profiled=NOT_ON_ANY_PATH)
    got = tuple(loop_stats["features"])
    require(got == DEFAULT_FEATURES, f"features per image {got}, recorded "
            f"{DEFAULT_FEATURES}")
    print(f"  features per image as recorded: {got}", flush=True)
    rows = tuple(loop_stats["descriptors"])
    moved = [a - b for a, b in zip(rows, PLAIN_PEAKS_DESCRIPTORS)]
    print(f"  descriptor rows per image {rows}; with the plain peaks after "
          f"a histogram-only kernel {PLAIN_PEAKS_DESCRIPTORS}: "
          + ("unchanged" if not any(moved) else
             f"moved by {moved}, orientations that K5's summation order "
             f"decided at a last-bit tie"), flush=True)

    notile = mode_config(pt, "notile")
    print("phase 4: the NoTile path, ", end="")
    notile_stats, notile_feats = run_path(
        torch, pt, scenes, notile, "PopSift(Config(desc_mode=notile))",
        NOTILE_PATH, not_launched=NOT_ON_ANY_PATH,
        not_profiled=NOT_ON_ANY_PATH, tally_boxes=True)
    require_same_keypoints(loop_feats, notile_feats, "NoTile")

    print("phase 5: the stack-kernel path, ", end="")
    with stack_kernels_on():
        stack_stats, stack_feats = run_path(
            torch, pt, scenes, pt.Config(),
            f"PopSift(Config()) with {STACK_SWITCH}=1", STACK_PATH,
            not_launched=NOT_ON_STACK_PATH, not_profiled=NOT_ON_ANY_PATH)
    require(all(features_equal(a, b) for a, b in zip(loop_feats,
                                                     stack_feats)),
            "the stack path's features differ from the default path's")
    print(f"  features per image {tuple(stack_stats['features'])}, "
          f"bit-identical to the default path's on every scene; no "
          f"{', '.join(NOT_ON_STACK_PATH)} launch", flush=True)

    stats = {"default": loop_stats, "notile": notile_stats,
             "stack": stack_stats}
    for mode, kernels in (("grid", GRID_PATH), ("iloop", ILOOP_PATH)):
        print(f"phase 6: the {mode} path, ", end="")
        stats[mode], feats = run_path(
            torch, pt, scenes, mode_config(pt, mode),
            f"PopSift(Config(desc_mode={mode}))", kernels, passes=1,
            not_launched=NOT_ON_ANY_PATH,
            not_profiled=NOT_ON_ANY_PATH, tally_boxes=True)
        require_same_keypoints(loop_feats, feats, mode)

    homes = {"default": LOOP_PATH, "notile": NOTILE_PATH,
             "stack": STACK_PATH, "grid": GRID_PATH, "iloop": ILOOP_PATH}
    for name in table.rows:
        table.rows[name]["launches_by_path"] = {
            p: st["counts"][name] for p, st in stats.items()}

    print("phase 7: the card against the CPU", flush=True)
    check_against_cpu(torch, pt, pt.Config(), "default")
    check_against_cpu(torch, pt, notile, "notile")
    with stack_kernels_on():
        check_against_cpu(torch, pt, pt.Config(), "stack kernels")
    for mode in ("grid", "iloop"):
        check_against_cpu(torch, pt, mode_config(pt, mode), mode)

    match_stats = run_matching(torch, pt, scenes, loop_feats, smi)
    for name in table.rows:
        table.rows[name]["launches_by_path"]["matching"] = \
            match_stats["counts"][name]

    require(not any(m == "jax" or m.startswith(("jax.", "popsift_tpu"))
                    for m in sys.modules), "JAX was imported")
    print("  (f) no JAX module and no popsift_tpu module was imported",
          flush=True)

    mode_stats, unrecorded = run_modes(torch, pt, scenes, loop_feats)
    for name, _, route in MODES:
        homes[name] = ROUTES[route][0]
    for name in table.rows:
        by_path = table.rows[name]["launches_by_path"]
        for mode, st in mode_stats.items():
            by_path[mode] = st["counts"][name]
        # K8 is on no path (its count, required 0 on each, is its sum);
        # K2's home paths are the fixed and relative routes
        home = next((p for p, kern in homes.items() if name in kern), None)
        table.rows[name]["launches"] = (
            by_path[home] if home
            else sum(v for p, v in by_path.items() if p != "matching"))

    cli_stats = run_cli(torch, pt, scenes, loop_feats, match_stats, smi)
    for name in table.rows:
        table.rows[name]["launches_by_path"]["cli"] = \
            cli_stats["counts"][name]

    parallel_stats = run_parallel(torch, pt, scenes, loop_feats, smi)
    for name in table.rows:
        table.rows[name]["launches_by_path"]["parallel"] = \
            parallel_stats["counts"][name]

    codec_stats = run_codec(torch, pt, scenes, loop_feats, smi)
    for name in table.rows:
        table.rows[name]["launches_by_path"]["codec"] = \
            codec_stats["counts"][name]

    oxford_stats = run_oxford(torch, pt, smi)
    for name in table.rows:
        table.rows[name]["launches_by_path"]["oxford"] = \
            oxford_stats["counts"][name]

    stage_in_stats = run_stage_in(torch, pt, scenes, smi)

    require(not any(m == "jax" or m.startswith(("jax.", "popsift_tpu"))
                    for m in sys.modules), "JAX was imported")
    left = child_pids()
    require(not left, f"processes started by this script are still "
            f"running: {left}")
    print("phase 15: the kernel table (no child process left)", flush=True)
    print(json.dumps({f"{p}_path": st for p, st in stats.items()}),
          flush=True)
    print(json.dumps({"matching": match_stats}), flush=True)
    print(json.dumps({"modes": mode_stats}), flush=True)
    print(json.dumps({"cli": cli_stats}), flush=True)
    print(json.dumps({"parallel": parallel_stats}), flush=True)
    print(json.dumps({"codec": codec_stats}), flush=True)
    print(json.dumps({"oxford": oxford_stats}), flush=True)
    print(json.dumps({"stage_in": stage_in_stats}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"kernels": [table.rows[k] for k in _lib.KERNELS]}),
          flush=True)
    require(not unrecorded, f"no recorded features per image for "
            f"{unrecorded}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
