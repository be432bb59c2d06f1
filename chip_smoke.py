"""Start-up proof of popsift_torch on one NVIDIA Hopper GPU (H100).

    python3 chip_smoke.py

Run from the repository root.  It needs one CUDA device of compute
capability 9.0, the CUDA toolkit (nvcc) and PyTorch; it imports neither
JAX nor popsift_tpu.  In order it:

1. prints the card's name and power limit, the torch and CUDA versions, and
   builds the kernel library from popsift_torch/csrc (printing the build
   time and what ptxas reports per kernel);
2. checks every kernel against its plain PyTorch version on the card, on
   the inputs the main path gives it for a 1080p scene: the octave-0
   levels, DoG and stack for the blur, gradient and detection kernels, and
   the real candidates and keypoint slots of the scene's busiest octave for
   refinement, orientation and descriptors; it times both with CUDA events
   (median of repeated calls) beside the kernel's bound;
3. drives the main path, PopSift(Config()).enqueue(...).get(), on four
   distinct 1080p scenes with the launch counts reset just before, fails
   if any kernel was not launched, and checks that a repeated frame gives
   bit-identical features; it times five such passes (median and range)
   and profiles one more for the device's busy and idle share;
4. holds the card's features of a small scene against the plain PyTorch
   versions run on the CPU;
5. prints the kernel table as one JSON line and, last, the device line.

Any failed check raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
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
OPS_DESC_PIXEL = 100          # rotation, exp weight, angle, 16 tiles x 2 bins


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
    """Median time of one call of ``fn`` on the current stream."""
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
    }

    def __init__(self):
        self.rows = {}

    def add(self, name, label, err, ms, plain_ms, nbytes, nops,
            library_ms=None):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / F32_OPS_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        by = "bytes" if t_bytes >= t_ops else "operations"
        lib = "null" if library_ms is None else f"{library_ms:.6f}"
        print(f"  {label}: max_abs_err={err:.6g} kernel_ms={ms:.6f} "
              f"plain_ms={plain_ms:.6f} bound_ms={bound:.6f} ({by}: "
              f"{nbytes:.0f} B, {nops:.0f} ops) library_ms={lib}",
              flush=True)
        src, rep = self.SOURCES[name]
        self.rows[name] = dict(
            name=name, route="cuda", source=src, replaces=rep,
            launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by=by, library_ms=library_ms)


def check_kernels(torch, pt, scene: np.ndarray, table: Table) -> None:
    """Phase 2: each kernel against its plain version at octave 0."""
    from popsift_torch import extract as ext
    from popsift_torch.gauss import build_gauss_info
    from popsift_torch.kernels import binwin, blur, detect, grad, refine
    from popsift_torch.ops import extrema as ops_ext
    from popsift_torch.ops import orientation as ops_ori
    from popsift_torch.ops import pyramid as ops_pyr

    dev = torch.device("cuda")
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
    ms = cuda_ms(lambda: blur.sep_blur(base, *args0, hscale=255.0))
    pms = cuda_ms(lambda: blur.sep_blur_plain(base, *args0, hscale=255.0),
                  reps=10)
    table.add("sep_blur", f"K1 sep_blur level 0, spans {sh}/{sv}, x255",
              max_abs(k, p), ms, pms, 8 * px,
              OPS_BLUR_PER_TAP * (sh + sv) * px)
    blur_level0 = table.rows.pop("sep_blur")

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
    ms = cuda_ms(lambda: blur.sep_blur(src, taps, span, with_dog=True))
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
    table.rows["sep_blur"]["level0"] = {
        key: blur_level0[key] for key in ("max_abs_err", "ms", "plain_ms",
                                          "bound_ms")}

    # K2
    f = grad.grad_field(stack)
    fp = grad.grad_field_plain(stack)
    require(torch.equal(f[0::2], fp[0::2]), "K2 mag: kernel != plain")
    th_ulps = ulps(f[1::2], fp[1::2])
    print(f"  K2 theta: {th_ulps} ulp", flush=True)
    require(th_ulps <= 2, f"K2 theta differs by {th_ulps} ulp")
    ms = cuda_ms(lambda: grad.grad_field(stack))
    pms = cuda_ms(lambda: grad.grad_field_plain(stack), reps=10)
    table.add("grad_field", f"K2 grad_field ({L},{h},{w})",
              max_abs(f, fp), ms, pms, 12 * L * px, OPS_GRAD * L * px)

    # K3
    m = detect.detect(dog, plan.sift_mode, plan.peak_threshold)
    gate, border = detect.gate_for(plan.sift_mode, plan.peak_threshold)
    mp = detect.detect_plain(dog, gate, border)
    require(torch.equal(m, mp), "K3 mask: kernel != plain")
    cands = ops_ext.compact_mask(m, plan.cand_caps[0])
    cands_p = ops_ext.compact_mask(mp, plan.cand_caps[0])
    require(cands.count == cands_p.count and torch.equal(cands.x, cands_p.x)
            and torch.equal(cands.y, cands_p.y)
            and torch.equal(cands.z, cands_p.z), "K3 candidate lists differ")
    ms = cuda_ms(lambda: detect.detect(dog, plan.sift_mode,
                                       plan.peak_threshold))
    pms = cuda_ms(lambda: detect.detect_plain(dog, gate, border), reps=10)
    nl = dog.shape[0] - 2
    table.add("detect", f"K3 detect ({dog.shape[0]},{h},{w}) -> "
              f"{cands.count} candidates", max_abs(m.float(), mp.float()),
              ms, pms,
              (4 * dog.shape[0] + nl) * px, OPS_DETECT * nl * px)

    # K4-K6 work on keypoints, and octave 0 of a smooth scene holds few:
    # they are checked on the octave of this scene with the most candidates
    best = (cands.count, 0, stack, dog, cands)
    prev = stack
    for o in range(1, plan.octaves):
        st, dg = ops_pyr.build_octave(prev, o, plan.dims, plan.levels, gauss,
                                      plan.sift_mode, plan.upscale_factor)
        c = ops_ext.compact_mask(
            detect.detect(dg, plan.sift_mode, plan.peak_threshold),
            plan.cand_caps[o])
        if c.count > best[0]:
            best = (c.count, o, st, dg, c)
        prev = st
    _, ob, stack, dog, cands = best
    w, h = plan.dims[ob]
    L = stack.shape[0]
    require(cands.count > 0, "no candidates in any octave")
    print(f"  K4-K6 at octave {ob} ({h}x{w}), {cands.count} candidates",
          flush=True)

    # K4
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
    ms = cuda_ms(lambda: refine.refine(dog, cx, cy, cz, rp))
    pms = cuda_ms(lambda: refine.refine_plain(dog, cx, cy, cz, rp), reps=10)
    n = cands.count
    table.add("refine", f"K4 refine {n} candidates",
              max(max_abs(xn, pxn), max_abs(yn, pyn), max_abs(sig, psig)),
              ms, pms, n * 12 + iters * 27 * 4 + n * 21,
              OPS_REFINE_ITER * iters)

    # K5 on the octave's extrema
    ex = ops_ext.compact_extrema(*kr, plan.ext_caps[ob])
    field = grad.grad_field(stack)
    args5 = (field, ex.xpos, ex.ypos, ex.lpos, ex.sigma)
    hk = binwin.ori_hist(*args5)
    hk2 = binwin.ori_hist(*args5)
    hp = binwin.ori_hist_plain(*args5)
    require(torch.equal(hk, hk2), "K5 is not deterministic")
    require(torch.allclose(hk, hp, rtol=1e-5, atol=1e-6),
            f"K5 histograms differ by {max_abs(hk, hp):.3g}")
    ms = cuda_ms(lambda: binwin.ori_hist(*args5))
    pms = cuda_ms(lambda: binwin.ori_hist_plain(*args5), reps=10)
    ne = ex.count
    rx = torch.round(ex.xpos).int()
    ry = torch.round(ex.ypos).int()
    rad = torch.round(3.0 * (1.5 * ex.sigma)).int()
    lp = ex.lpos.clamp(0, L - 1)
    x0, x1 = (rx - rad).clamp(min=1), (rx + rad).clamp(max=w - 2)
    y0, y1 = (ry - rad).clamp(min=1), (ry + rad).clamp(max=h - 2)
    box = int(((x1 - x0 + 1).clamp(min=0) * (y1 - y0 + 1).clamp(min=0))
              .sum())
    union = box_union_pixels(lp, x0, x1, y0, y1, L, h, w)
    table.add("ori_hist", f"K5 ori_hist {ne} extrema", max_abs(hk, hp), ms,
              pms, 8 * union + 16 * ne + 144 * ne, OPS_ORI_PIXEL * box)

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
    ms = cuda_ms(lambda: binwin.desc_loop(*args6))
    pms = cuda_ms(lambda: binwin.desc_loop_plain(*args6), reps=10)
    nd = int(feat.shape[0])
    R = binwin.desc_support(args6[4], half).int()
    drx = torch.round(args6[1]).int()
    dry = torch.round(args6[2]).int()
    x0, x1 = (drx - R).clamp(min=1), (drx + R).clamp(max=w - 2)
    y0, y1 = (dry - R).clamp(min=1), (dry + R).clamp(max=h - 2)
    box = int(((x1 - x0 + 1).clamp(min=0) * (y1 - y0 + 1).clamp(min=0))
              .sum())
    union = box_union_pixels(args6[3].clamp(0, L - 1), x0, x1, y0, y1, L,
                             h, w)
    table.add("desc_loop", f"K6 desc_loop {nd} rows", max_abs(dk, dp), ms,
              pms, 8 * union + 20 * nd + 512 * nd, OPS_DESC_PIXEL * box)
    torch.cuda.synchronize()


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


def run_main_path(torch, pt, scenes, table: Table) -> dict:
    """Phase 3: the user-facing entry point on the card.  The scenes go
    through MAIN_PATH_PASSES times; the launch counts are those of the
    first pass, and ms per image is the median pass, with the range."""
    from popsift_torch import kernels

    h, w = scenes[0].shape
    print(f"phase 3: PopSift(Config()) on {len(scenes)} distinct "
          f"{w}x{h} scenes, {MAIN_PATH_PASSES} passes", flush=True)

    def one_pass(ps):
        t0 = time.perf_counter()
        jobs = [ps.enqueue(w, h, s) for s in scenes]
        out = [j.get() for j in jobs]
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) / len(scenes) * 1e3

    with pt.PopSift(pt.Config()) as ps:
        ps.enqueue(w, h, scenes[-1]).get()        # first-use set-up
        torch.cuda.synchronize()
        kernels.reset_launches()
        feats, ms_first = one_pass(ps)
        counts = kernels.launches()
        pass_ms = [ms_first] + [one_pass(ps)[1]
                                for _ in range(MAIN_PATH_PASSES - 1)]
        again = ps.enqueue(w, h, scenes[0]).get()
    ms_img = float(np.median(pass_ms))
    print("  features per image: "
          + ", ".join(f"{f.get_feature_count()}/{f.get_descriptor_count()}"
                      for f in feats), flush=True)
    print(f"  {ms_img:.3f} ms per image (median pass; passes "
          + ", ".join(f"{t:.3f}" for t in pass_ms)
          + f"), {1e3 / ms_img:.3f} images/s (host clock, {len(scenes)} "
          f"images per pass)", flush=True)
    print(f"  launches: {json.dumps(counts)}", flush=True)
    for name, c in counts.items():
        require(c > 0, f"kernel {name} was not launched on the main path")
        table.rows[name]["launches"] = c
    for f in feats:
        check_output(f, w, h)
    require(features_equal(feats[0], again),
            "the same frame gave different features")
    print("  repeated frame: bit-identical features", flush=True)
    prof = profile_main_path(torch, pt, scenes)
    if prof["device_busy_ms"] is not None:
        # busy time is the same with the profiler off; the unprofiled
        # wall is the median pass above
        prof["device_idle_share"] = 1.0 - prof["device_busy_ms"] / ms_img
        print(f"  device idle {100 * prof['device_idle_share']:.1f}% of the "
              f"unprofiled wall ({100 * prof['device_idle_share_profiled']:.1f}"
              f"% under the profiler)", flush=True)
    return dict(ms_per_image=ms_img, pass_ms_per_image=pass_ms,
                counts=counts,
                peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                **prof)


def profile_main_path(torch, pt, scenes) -> dict:
    """Where the main path's time goes: torch.profiler over the same
    scenes, device time summed by kernel name, and the device's busy
    share of the wall time (kernels and copies; one stream, so they do
    not overlap)."""
    from torch.profiler import ProfilerActivity, profile

    h, w = scenes[0].shape
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with pt.PopSift(pt.Config()) as ps:
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
    print(f"  profile: wall {wall_ms / n:.3f} ms/image (profiler on), "
          f"device busy {busy / n:.3f} ms/image", flush=True)
    if busy == 0.0:
        print("  profile: the profiler recorded no device time; device "
              "share not measured", flush=True)
        return dict(profile_wall_ms=wall_ms / n, device_busy_ms=None)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    for name, (t, c) in top:
        print(f"    {t / n:9.4f} ms/image {c / n:8.1f} calls/image  "
              f"{name[:90]}", flush=True)
    return dict(profile_wall_ms=wall_ms / n, device_busy_ms=busy / n,
                device_idle_share_profiled=1.0 - busy / wall_ms)


def check_against_cpu(torch, pt) -> None:
    """Phase 4: the card's features of a small scene against the plain
    versions on the CPU.  Both sides round each operation the same way,
    but exp/sin/cos/atan2/pow come from different maths libraries, so a
    feature may move by a few ulp; 99% of the CPU features must be found
    on the card at the same octave within 1e-3 px and sigma rtol 1e-4."""
    from popsift_torch.extract import extract_features

    scene = make_scene(11, 240, 320)
    cpu = extract_features(scene, pt.Config(), device="cpu")
    gpu = extract_features(scene, pt.Config(), device="cuda")
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
    print(f"phase 4: 320x240 scene, {nc} CPU / {ng} GPU features, "
          f"{int(hit.sum())} matched", flush=True)
    require(abs(nc - ng) <= max(1, nc // 100) and hit.mean() >= 0.99,
            "card and CPU features disagree")


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
    for line in _lib.build_info.get("log", "").splitlines():
        if "registers" in line or "error" in line.lower():
            print("  ptxas:" + line.split("ptxas info    :")[-1], flush=True)

    t_scene = time.perf_counter()
    scenes = [make_scene(seed, 1080, 1920) for seed in range(4)]
    print(f"  4 scenes made in {time.perf_counter() - t_scene:.1f} s",
          flush=True)
    table = Table()
    check_kernels(torch, pt, scenes[0], table)
    main_stats = run_main_path(torch, pt, scenes, table)
    check_against_cpu(torch, pt)

    print(json.dumps({"main_path": main_stats}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"kernels": [table.rows[k] for k in _lib.KERNELS]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
