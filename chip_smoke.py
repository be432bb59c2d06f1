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
   octave that takes it, the octave chain (both emit modes, and bit for
   bit against the per-level kernels, at every octave that takes it), the
   gradient kernel, detection at every octave and on a DoG full of exact
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
   it: K9, K12 and K13 read its windows from the stack), and the NoTile,
   Grid and ILoop descriptors read from the stack (against K8's plain
   windows and the window forms; bit-identical run to run and with every
   row's taps read through L2 instead of the staged footprint, also timed
   that way; the share of rows whose footprint exceeds the staging
   capacity; a digest of K9's output, which equals that of K8 and the
   window form's kernel before K9 read the stack, as
   tools/torch_time_kernels.py --kernels K9 shows on both trees);
   it times both between CUDA events (the median of repeated calls), the
   kernel also by its device time (torch.profiler, the mean), beside the
   kernel's bound;
3. drives the default path, PopSift(Config()).enqueue(...).get(), on four
   distinct 1080p scenes with the launch counts reset just before, fails
   if a kernel of that path was not launched, if gather_windows was
   (counted or in the profile), or if the features per image
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
   gather_windows ran (counted or in the profile), and per scene the
   descriptor rows whose footprint exceeds the staging capacity;
5. drives the stack-kernel path (POPSIFT_TPU_STACK_KERNELS=1 on the
   default Config) the same way: no gradient-field, field-histogram,
   field-descriptor or gather_windows launch (gather_windows neither in
   the profile), and features equal to the default path's bit
   for bit; the switch is restored afterwards;
6. drives the Grid and ILoop paths for one pass each (launches, keypoints
   equal to the default path's, bit-identical repeat, one profiled pass;
   no gather_windows launch, counted or in the profile; per scene the
   descriptor rows whose footprint exceeds the staging capacity);
7. holds the card's features of a small scene against the plain PyTorch
   versions run on the CPU, for all five paths;
8. prints the kernel table as one JSON line (gather_windows's launches are
   its counts summed over the five paths, each required to be 0) and,
   last, the device line.

Any failed check raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import re
import subprocess
import sys
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
LOOP_PATH = ("sep_blur", "blur_chain", "octave_chain", "grad_field",
             "detect", "refine", "ori_hist", "desc_loop")
NOTILE_PATH = ("sep_blur", "blur_chain", "octave_chain", "grad_field",
               "detect", "refine", "ori_hist", "desc_grid_stack")
STACK_PATH = ("sep_blur", "blur_chain", "octave_chain", "detect", "refine",
              "ori_hist_stack", "desc_loop_stack")
GRID_PATH = ("sep_blur", "blur_chain", "octave_chain", "grad_field",
             "detect", "refine", "ori_hist", "desc_grid_rounded_stack")
ILOOP_PATH = ("sep_blur", "blur_chain", "octave_chain", "grad_field",
              "detect", "refine", "ori_hist", "desc_iloop_stack")
# K9, K12 and K13 read the stack, and the default and stack paths take no
# windows: no path launches K8
NOT_ON_ANY_PATH = ("gather_windows",)
# the kernels the stack path must not launch: it reads no gradient field
NOT_ON_STACK_PATH = ("grad_field", "ori_hist", "desc_loop") + NOT_ON_ANY_PATH
STACK_SWITCH = "POPSIFT_TPU_STACK_KERNELS"


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
        shape, kept inside the row of ``name`` (added before it) under that
        key."""
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
            self.subs.setdefault(name, {})[sub] = dict(
                max_abs_err=err, ms=ms, device_ms=dms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=library_ms)
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
    table.add("ori_hist", f"K5 ori_peaks {ne} extrema", err, ms, pms,
              8 * union + 16 * ne + 20 * ne,
              OPS_ORI_PIXEL * work + OPS_ORI_PEAKS * ne)
    a_ms = cuda_ms(lambda: ops_ori.assign_orientations(*args5))
    h_ms = cuda_ms(lambda: binwin.peaks_from_hist(binwin.ori_hist(*args5)))
    print(f"  assign_orientations at octave {ob}: {a_ms:.6f} ms (events); "
          f"K5's histograms and the plain peaks after them: {h_ms:.6f} ms",
          flush=True)

    # K6 on the octave's (extremum, orientation) rows
    num_ori, oris = ops_ori.assign_orientations(field, ex.xpos, ex.ypos,
                                                ex.lpos, ex.sigma)
    feat, ang, _ = ext.descriptor_rows(plan, ob, num_ori, oris)
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
    table.add("desc_loop", f"K6 desc_loop {nd} rows", max_abs(dk, dp), ms,
              pms, 8 * union + 20 * nd + 512 * nd, OPS_DESC_PIXEL * work)

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

    check_windows_and_grid(torch, plan, stack, args6[1:6], table)
    torch.cuda.synchronize()


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


def check_blur_chain(torch, o, stack, dog, filters, spans,
                     table: Table) -> None:
    """K1's chain entry on octave ``o`` (``stack`` and ``dog`` are what the
    path's per-level form computed from the same level 0): bit for bit
    against its plain version, K1's plain version per level; timed at the
    first such octave, the table's row."""
    from popsift_torch.kernels import blur

    L, h, w = stack.shape
    lvl0 = stack[0].contiguous()
    ps, pd = blur.blur_chain_plain(lvl0, filters, spans)
    ks, kd = blur.blur_chain(lvl0, filters, spans)
    require(torch.equal(ks, ps) and torch.equal(kd, pd)
            and torch.equal(stack, ps) and torch.equal(dog, pd),
            f"K1 chain entry at octave {o}: kernel != plain")
    err = max(max_abs(ks, ps), max_abs(kd, pd))
    blocks, rows = blur.chain_bands(h)
    ms = kernel_ms(lambda: blur.blur_chain(lvl0, filters, spans))
    print(f"  K1 chain entry at octave {o} ({h}x{w}, {blocks} blocks of "
          f"{rows} rows): bit-equal to K1's plain version per level; "
          f"{ms[0]:.6f} ms, device {fmt_ms(ms[1])} ms", flush=True)
    if "blur_chain" in table.rows:
        return
    px = h * w
    pms = cuda_ms(lambda: blur.blur_chain_plain(lvl0, filters, spans),
                  reps=10)
    table.add("blur_chain", f"K1 blur_chain octave {o} ({L},{h},{w}), spans "
              f"{spans[1:]}", err, ms, pms, 4 * px * (1 + 2 * (L - 1)),
              sum(OPS_BLUR_PER_TAP * 2 * s + 1 for s in spans[1:]) * px)


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
    feat, ang, _ = ext.descriptor_rows(plan, o, num_ori, oris)
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
    table.add("ori_hist_stack", f"K10 ori_peaks_stack {ne} extrema",
              max_abs(hk, hp), ms, pms, 4 * nbr + 16 * ne + 20 * ne,
              (OPS_ORI_PIXEL + OPS_GRAD) * work + OPS_ORI_PEAKS * ne)
    work, _, nbr = support_pixels(*rows[:4], L, h, w, ang=rows[4],
                                  half=half)
    ms = kernel_ms(lambda: binwin.desc_loop_stack(stack, *rows, half))
    pms = cuda_ms(lambda: binwin.desc_loop_stack_plain(stack, *rows, half),
                  reps=10)
    table.add("desc_loop_stack", f"K11 desc_loop_stack {nd} rows",
              max_abs(dk, dp), ms, pms, 4 * nbr + 20 * nd + 512 * nd,
              (OPS_DESC_PIXEL + OPS_GRAD) * work)

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


def check_windows_and_grid(torch, plan, stack, rows, table: Table) -> None:
    """K8 in both call shapes, which no path launches since K9, K12 and K13
    read its windows from the stack, then K9, K12 and K13 on the
    descriptor rows of one octave, as the NoTile path gives them."""
    from popsift_torch.kernels import windows

    xs, ys, lps, sg, an = rows
    L, h, w = stack.shape
    win = plan.desc_win
    n = int(xs.shape[0])
    lps = lps.clamp(0, L - 1)
    x0 = torch.round(xs).to(torch.int32) - win // 2
    y0 = torch.round(ys).to(torch.int32) - win // 2

    def union(ya, xa, wy, wx):
        return box_union_pixels(
            lps, xa.clamp(0, w - 1), (xa + wx - 1).clamp(0, w - 1),
            ya.clamp(0, h - 1), (ya + wy - 1).clamp(0, h - 1), L, h, w)

    wk, ya = windows.gather_windows_exact(stack, lps, y0, x0, win)
    aw, aya, axa = windows.gather_windows_aligned(stack, lps, y0, x0, win)
    shapes = (("aligned", aya, axa, windows.aligned_window_dims(win), aw),
              (None, ya, x0, windows.rolled_window_dims(win), wk))
    for sub, oy, ox, (wy, wx), k in shapes:
        p = windows.gather_windows_plain(stack, lps, oy, ox, wy, wx)
        form = sub or "exact"
        require(torch.equal(k, p), f"K8 ({form}): kernel != plain")
        ms = kernel_ms(lambda: windows.gather_windows(stack, lps, oy, ox, wy,
                                                      wx))
        pms = cuda_ms(lambda: windows.gather_windows_plain(
            stack, lps, oy, ox, wy, wx), reps=10)
        # the library yardstick: one advanced-indexing call, its index
        # tensors built outside the timed region
        li = lps.long()[:, None, None]
        yi = (oy.long()[:, None] + torch.arange(wy, device=stack.device)
              ).clamp(0, h - 1)[:, :, None]
        xi = (ox.long()[:, None] + torch.arange(wx, device=stack.device)
              ).clamp(0, w - 1)[:, None, :]
        require(torch.equal(stack[li, yi, xi], k),
                f"K8 ({form}): advanced indexing differs")
        lib_ms = cuda_ms(lambda: stack[li, yi, xi])
        table.add("gather_windows", f"K8 gather_windows ({form}) {n} x "
                  f"({wy},{wx})", max_abs(k, p), ms, pms,
                  4 * union(oy, ox, wy, wx) + 4 * n * wy * wx + 12 * n, 0,
                  library_ms=lib_ms, sub=sub)

    nbytes = footprint_bytes(stack, rows, win)
    check_stack_descriptors(torch, plan, stack, rows, nbytes, table)


def staged_boxes(xs, ys, sg, an, win: int):
    """Each row's footprint as K9/K12/K13 stage it (footprint_box one pixel
    wider on each side) and its pixels."""
    from popsift_torch.kernels import desc_grid
    half = desc_grid.footprint_half(sg, an) + 1
    box = desc_grid.footprint_box(xs, ys, sg, an, win, half=half)
    return box, (box[1] - box[0] + 1) * (box[3] - box[2] + 1)


def footprint_bytes(stack, rows, win: int) -> int:
    """The compulsory bytes of a descriptor kernel that reads the stack
    (K9, K12, K13) on ``rows``: the distinct stack pixels that the rows'
    footprint boxes (without the kernels' one-pixel slack) cover, the five
    inputs and the outputs.  Prints the staged footprints' sizes and the
    rows whose footprint exceeds the staging capacity."""
    from popsift_torch.kernels import desc_grid, windows

    xs, ys, lps, sg, an = rows
    L, h, w = stack.shape
    n = int(xs.shape[0])
    _, pix = staged_boxes(xs, ys, sg, an, win)
    over = int((pix > desc_grid.STAGE_FLOATS).sum())
    print(f"  K9/K12/K13 footprints of {n} rows: {int(pix.min())}-"
          f"{int(pix.max())} px staged (median {int(pix.median())}); "
          f"{over} rows ({100.0 * over / max(n, 1):.2f}%) exceed the "
          f"staging capacity of {desc_grid.STAGE_FLOATS} px", flush=True)
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
        digest = hashlib.sha256(k.cpu().numpy().tobytes()).hexdigest()[:16]
        print(f"  {label}: bit-identical run to run and through L2; within "
              f"{max_abs(k, p):.3g} of its plain version (largest entry "
              f"{scale:.3g}); {off} of {n} rows beyond 1e-5 of it; sha256 "
              f"{digest}", flush=True)
        require(off <= allowed and float(row_err.max()) <= 1e-3 * scale,
                f"{label} descriptors differ from the plain version")
        pms = cuda_ms(lambda: plain(*args), reps=10)
        table.add(name, f"{label} {name} {n} rows, no staging (stage=0)",
                  max_abs(k, p), kernel_ms(lambda: kern(*args, stage=0)),
                  pms, nbytes + tbytes, nops, sub="no_staging")
        table.add(name, f"{label} {name} {n} rows", max_abs(k, p),
                  kernel_ms(lambda: kern(*args)), pms, nbytes + tbytes, nops)


@contextlib.contextmanager
def footprint_tally(tally: list):
    """While active, each NoTile, Grid or ILoop descriptor call of the
    extraction appends (rows, rows whose staged footprint exceeds the staging
    capacity, largest footprint in px) to ``tally``."""
    from popsift_torch.kernels import desc_grid
    from popsift_torch.ops import descriptors as ops_desc

    def tallied(fn):
        def call(stack, xs, ys, lpos, sigma, ang, win, *a, **k):
            _, pix = staged_boxes(xs, ys, sigma, ang, win)
            tally.append((int(pix.numel()),
                          int((pix > desc_grid.STAGE_FLOATS).sum()),
                          int(pix.max()) if pix.numel() else 0))
            return fn(stack, xs, ys, lpos, sigma, ang, win, *a, **k)
        return call

    names = ("desc_grid_stack", "desc_grid_rounded_stack",
             "desc_iloop_stack")
    saved = {name: getattr(ops_desc, name) for name in names}
    for name, fn in saved.items():
        setattr(ops_desc, name, tallied(fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops_desc, name, fn)


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
             tally_boxes: bool = False) -> tuple[dict, list]:
    """Phases 3-6: the user-facing entry point on the card with ``cfg``.
    The scenes go through ``passes`` times; the launch counts are those of
    the first pass, and ms per image is the median pass, with the range.
    Every kernel of ``path_kernels`` must have been launched, and none of
    ``not_launched``; no kernel of the profiled pass may be named after
    one of ``not_profiled``.  With ``tally_boxes``, prints per scene the
    descriptor rows whose footprint exceeds K9/K12/K13's staging capacity.
    Returns the path's numbers and the first pass's features."""
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
    require(tuple(dropped) == BUDGET_DROPPED,
            f"the budget dropped {dropped} candidates, recorded "
            f"{BUDGET_DROPPED}")
    require(max(k1_calls) <= MAX_K1_CALLS,
            f"K1 called {k1_calls} times per image (at most {MAX_K1_CALLS})")
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


def check_against_cpu(torch, pt, cfg, label: str) -> None:
    """Phase 7: the card's features of a small scene against the plain
    versions on the CPU.  Both sides round each operation the same way,
    but exp/sin/cos/atan2/pow come from different maths libraries, so a
    feature may move by a few ulp; 99% of the CPU features must be found
    on the card at the same octave within 1e-3 px and sigma rtol 1e-4, and
    99% of those found must have their first descriptor within 1e-3."""
    from popsift_torch.extract import extract_features

    scene = make_scene(11, 240, 320)
    cpu = extract_features(scene, cfg, device="cpu")
    gpu = extract_features(scene, cfg, device="cuda")
    check_output(gpu, 320, 240)
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
    print(f"  {label}: 320x240 scene, {nc} CPU / {ng} GPU features, "
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

    # phases 2-4 run with the stack kernels off, whatever the caller set
    os.environ.pop(STACK_SWITCH, None)
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
                  "desc_iloop_stack"))

    t_scene = time.perf_counter()
    scenes = [make_scene(seed, 1080, 1920) for seed in range(4)]
    print(f"  4 scenes made in {time.perf_counter() - t_scene:.1f} s",
          flush=True)
    table = Table()
    check_kernels(torch, pt, scenes[0], table, torch.device("cuda"))
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
        by_path = {p: st["counts"][name] for p, st in stats.items()}
        # K8 is on no path (its count, required 0 on each, is their sum)
        home = next((p for p, kern in homes.items() if name in kern), None)
        table.rows[name]["launches"] = (by_path[home] if home
                                        else sum(by_path.values()))
        table.rows[name]["launches_by_path"] = by_path

    print("phase 7: the card against the CPU", flush=True)
    check_against_cpu(torch, pt, pt.Config(), "default")
    check_against_cpu(torch, pt, notile, "notile")
    with stack_kernels_on():
        check_against_cpu(torch, pt, pt.Config(), "stack kernels")
    for mode in ("grid", "iloop"):
        check_against_cpu(torch, pt, mode_config(pt, mode), mode)

    print(json.dumps({f"{p}_path": st for p, st in stats.items()}),
          flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"kernels": [table.rows[k] for k in _lib.KERNELS]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
