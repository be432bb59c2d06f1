"""Time kernels of a checkout of popsift_torch on one CUDA card, to compare
two trees on the same card.

    python3 tools/torch_time_kernels.py [--root DIR] [--kernels K1,K3,...]

``--root`` is the checkout whose popsift_torch is timed (this repository
by default); run the tool in turns for two checkouts (A, B, B, A) in one
run on the card, the parent unpacked with ``git archive`` into
``build/popsift_torch/``.  ``--kernels`` picks from K1, K2, K1K2, K3, K4,
K5, K10, K7, K6, K11, K9, K12, K13 and ops (all by default).  It uses only
functions that every version of the port since K1's chain entry
(``blur_chain``) has, on chip_smoke.py's seed-0 1080p scene:

- K1: octave 0's level 0 (x255), the span-14 level with its DoG at
  octave 0, and levels 1..L-1 of each octave that K7 does not take
  (``ops/pyramid.py:per_level_chain``, the form the path runs there: K1
  per level, or its chain entry);
- K2: the gradient field of each octave that K7 does not take (4-8 at
  1080p);
- K1K2: on those octaves, levels, DoG and field as the default path
  computes them: K1's chain entry with ``emit_field=True`` where the tree
  has it, else the chain entry followed by K2; per octave and summed,
  with a digest of the three outputs (equal digests: bit-identical), by
  events (the median and the least of 100 calls), device time and host
  time (``k1k2_times``);
- K3: every octave;
- K4: refinement and compaction at the busiest octave, as
  ``extract.octave_keypoints`` less detection and the candidates'
  compaction (``compact_mask(detect(...))``), both timed;
- K5 and K10: ``ops/orientation.assign_orientations`` at the busiest
  octave, from the field and from the stack (the histograms and the
  peaks, whatever runs them);
- K7: octave 0, both emit forms;
- K6 and K11: the descriptor rows of the busiest octave;
- K9, K12 and K13: the NoTile, Grid and ILoop descriptor steps on the
  same rows, through ``ops/descriptors.py:grid_descriptors_windowed``,
  ``grid_rounded_descriptors_windowed`` and ``iloop_descriptors_windowed``
  (K8 and the window kernel, or the kernel that reads the stack,
  whichever the tree runs), with a digest of each tree's descriptors
  (equal digests: bit-identical output);
- ops: the PyTorch operations per image of the default path
  (``chip_smoke.count_ops`` over the four 1080p scenes), and per scene
  the features, descriptor rows and a digest of them (equal digests:
  bit-identical features).

Each gets two times of one call: between CUDA events (chip_smoke.cuda_ms,
the median of 20 calls, 50 for K6/K11 and the descriptor steps), and on
the device: the library
kernels' records in torch.profiler over the same number of calls,
divided by the calls (every record a call makes counts, however many
kernels the tree launches for it; a profile whose record count is not a
whole multiple of the count of one call is taken again, three times at
most).  The card's name and power limit are printed first.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import inspect
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]
KERNELS = ("K1", "K2", "K1K2", "K3", "K4", "K5", "K10", "K7", "K6", "K11",
           "K9", "K12", "K13", "ops")


def library_spans(torch, fn, calls: int) -> list[float]:
    """Device durations (us) of the library's kernel records over
    ``calls`` calls of ``fn``.  The profile holds 50 ms of idle host time
    before the first call and after the last kernel ends, because the
    profiler drops the records that its clock places outside its window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(0.05)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.05)
    return [e.time_range.elapsed_us() for e in prof.events()
            if e.device_type == DeviceType.CUDA
            and e.name.removeprefix("void ").startswith(
                "(anonymous namespace)::")]


def device_ms(torch, fn, reps: int) -> tuple[float, int]:
    """(mean device ms of one call, library kernel records per call)."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        per_call = len(library_spans(torch, fn, 1))
        spans = library_spans(torch, fn, reps)
        if per_call and len(spans) == per_call * reps:
            return sum(spans) / reps / 1e3, per_call
    raise AssertionError(f"the profiler recorded {len(spans)} records for "
                         f"{reps} calls of {per_call}, three times")


def k1k2_times(torch, fn, reps: int = 100, bursts: int = 5):
    """(events median, events least, device, host) ms of one call: the
    median and the least of ``reps`` calls between CUDA events, the mean
    device time, and the least over ``bursts`` bursts of ``reps`` calls
    enqueued back to back (one synchronisation a burst) of the wall time
    a call, which is the wrappers' host time where the card keeps up."""
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    dms, _ = device_ms(torch, fn, reps)
    host = []
    for _ in range(bursts):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) / reps * 1e3)
    return np.array([np.median(times), min(times), dms, min(host)])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--kernels", default=",".join(KERNELS))
    args = ap.parse_args()
    root = Path(args.root).resolve()
    want = [k.strip() for k in args.kernels.split(",") if k.strip()]
    unknown = sorted(set(want) - set(KERNELS))
    if unknown:
        ap.error(f"unknown kernels {unknown}; pick from {KERNELS}")
    import torch
    if not torch.cuda.is_available():
        print("torch_time_kernels: no CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("cs", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, str(root))
    import popsift_torch as pt
    from popsift_torch import extract as ext
    from popsift_torch.constants import desc_tables_on
    from popsift_torch.gauss import build_gauss_info
    from popsift_torch.kernels import _lib, binwin, blur, detect, grad, octave
    from popsift_torch.ops import descriptors as ops_desc
    from popsift_torch.ops import extrema as ops_ext
    from popsift_torch.ops import orientation as ops_ori
    from popsift_torch.ops import pyramid as ops_pyr
    assert Path(pt.__file__).resolve().is_relative_to(root)

    dev = torch.device("cuda")
    print(f"{cs.smi_line()}; popsift_torch from {root}", flush=True)
    _lib.library(dev)
    scene = cs.make_scene(0, 1080, 1920)
    cfg = pt.Config()
    plan = ext.make_plan(cfg, 1920, 1080)
    gauss = build_gauss_info(cfg)
    img = ext.to_unit_image(scene, dev)
    filters, spans = ops_pyr.chain_filters(gauss, plan.levels)
    octaves, best, src = [], None, img
    for o in range(plan.octaves):
        st, dg = ops_pyr.build_octave(src, o, plan.dims, plan.levels, gauss,
                                      plan.sift_mode, plan.upscale_factor)
        octaves.append((st, dg))
        _, ex = ext.octave_keypoints(plan, o, dg)
        if best is None or ex.count > best[0]:
            best = (ex.count, o, st, ex)
        src = st
    keep = (len(spans) - ops_pyr.PREV_LEVEL,)

    def report(label, fn, reps=20):
        ms = cs.cuda_ms(fn, reps)
        dms, per_call = device_ms(torch, fn, reps)
        print(f"{label}: {ms:.6f} ms, device {dms:.6f} ms ({per_call} "
              f"kernel{'s' if per_call > 1 else ''} a call)", flush=True)

    if "K1" in want:
        w, h = plan.dims[0]
        base = ops_pyr.resample_input(img, h, w, ops_pyr.input_shift(
            plan.sift_mode, plan.upscale_factor, 0)).contiguous()
        a0 = (gauss.dd.filter[0], int(gauss.dd.span[0]),
              gauss.inc.filter[0], int(gauss.inc.span[0]))
        report(f"K1 level 0 {h}x{w}, x255",
               lambda: blur.sep_blur(base, *a0, hscale=255.0))
        st0 = octaves[0][0]
        L = st0.shape[0]
        s14 = st0[L - 2]
        report(f"K1 span {spans[L - 1]} + DoG {h}x{w}",
               lambda: blur.sep_blur(s14, filters[L - 1], spans[L - 1],
                                     with_dog=True))
        for o, (st, _) in enumerate(octaves):
            if ops_pyr.chain_eligible(st.shape[1], st.shape[2], spans):
                continue
            lvl = st[0].contiguous()
            report(f"K1 octave {o} {tuple(lvl.shape)}, levels 1-{L - 1}",
                   lambda: ops_pyr.per_level_chain(lvl, plan.levels, gauss))
    if "K2" in want:
        for o, (st, _) in enumerate(octaves):
            if ops_pyr.chain_eligible(st.shape[1], st.shape[2], spans):
                continue
            bound = 12 * st.numel() / cs.HBM_BYTES_PER_S * 1e3
            report(f"K2 octave {o} {tuple(st.shape)} (bound {bound:.7f} ms, "
                   f"bytes)", lambda: grad.grad_field(st))
    if "K1K2" in want:
        folded = "emit_field" in inspect.signature(blur.blur_chain).parameters
        form = ("blur_chain(emit_field=True)" if folded
                else "blur_chain, then grad_field")

        def with_field(lvl):
            if folded:
                return blur.blur_chain(lvl, filters, spans, emit_field=True)
            stack, dog = blur.blur_chain(lvl, filters, spans)
            return stack, dog, grad.grad_field(stack)
        total = np.zeros(4)
        for o, (st, _) in enumerate(octaves):
            if ops_pyr.chain_eligible(st.shape[1], st.shape[2], spans):
                continue
            lvl = st[0].contiguous()
            h = hashlib.sha256()
            for t in with_field(lvl):
                h.update(t.cpu().numpy().tobytes())
            times = k1k2_times(torch, lambda: with_field(lvl))
            print(f"K1K2 octave {o} {tuple(st.shape)}, {form}, sha256 "
                  f"{h.hexdigest()[:16]}: events median {times[0]:.6f} ms, "
                  f"least {times[1]:.6f}; device {times[2]:.6f} ms; host "
                  f"{times[3]:.6f} ms a call", flush=True)
            total += times
        print(f"K1K2 summed over those octaves: events median "
              f"{total[0]:.6f} ms, least {total[1]:.6f}; device "
              f"{total[2]:.6f} ms; host {total[3]:.6f} ms", flush=True)
    if "K3" in want:
        for o, (_, dg) in enumerate(octaves):
            report(f"K3 octave {o} {tuple(dg.shape)}",
                   lambda: detect.detect(dg, plan.sift_mode,
                                         plan.peak_threshold))
    if "K7" in want:
        lvl0 = octaves[0][0][0].contiguous()
        for emit_stack in (False, True):
            form = "whole stack" if emit_stack else f"level {keep[0]} kept"
            report(f"K7 octave 0 {tuple(lvl0.shape)}, {form}",
                   lambda: octave.octave_chain(lvl0, filters, spans,
                                               emit_stack, keep))
    if "K4" in want:
        _, o, _, _ = best
        dg = octaves[o][1]
        report(f"K3 + compact_mask octave {o}",
               lambda: ops_ext.compact_mask(
                   detect.detect(dg, plan.sift_mode, plan.peak_threshold),
                   plan.cand_caps[o]))
        report(f"octave_keypoints octave {o} (K3, compact_mask, K4 and its "
               f"compaction)", lambda: ext.octave_keypoints(plan, o, dg))
    if "K5" in want or "K10" in want:
        _, o, stack, ex = best
        field = grad.grad_field(stack)
        kp = (ex.xpos, ex.ypos, ex.lpos, ex.sigma)
        if "K5" in want:
            report(f"assign_orientations octave {o}, {ex.count} extrema",
                   lambda: ops_ori.assign_orientations(field, *kp))
        if "K10" in want:
            report(f"assign_orientations octave {o}, {ex.count} extrema, "
                   f"from the stack",
                   lambda: ops_ori.assign_orientations(None, *kp,
                                                       stack=stack))
    if {"K6", "K11", "K9", "K12", "K13"} & set(want):
        _, o, stack, ex = best
        field = grad.grad_field(stack)
        num_ori, oris = ops_ori.assign_orientations(field, ex.xpos, ex.ypos,
                                                    ex.lpos, ex.sigma)
        feat, ang, _, _ = ext.descriptor_rows(plan, o, num_ori, oris)
        rows = tuple(v[feat].contiguous() for v in (ex.xpos, ex.ypos,
                                                    ex.lpos, ex.sigma)) \
            + (ang.contiguous(),)
        half = plan.desc_win // 2
        n = int(feat.shape[0])
        if "K6" in want:
            report(f"K6 octave {o}, {n} rows",
                   lambda: binwin.desc_loop(field, *rows, half), 50)
        if "K11" in want:
            report(f"K11 octave {o}, {n} rows",
                   lambda: binwin.desc_loop_stack(stack, *rows, half), 50)
        tables = desc_tables_on(dev)
        for key, mode, fn, extra in (
                ("K9", "NoTile", ops_desc.grid_descriptors_windowed, tables),
                ("K12", "Grid", ops_desc.grid_rounded_descriptors_windowed,
                 ()),
                ("K13", "ILoop", ops_desc.iloop_descriptors_windowed, ())):
            if key not in want:
                continue
            out = fn(stack, *rows, plan.desc_win, *extra).cpu().numpy()
            digest = hashlib.sha256(out.tobytes()).hexdigest()[:16]
            report(f"{mode} descriptors ({key}) octave {o}, {n} rows, "
                   f"sha256 {digest}",
                   lambda: fn(stack, *rows, plan.desc_win, *extra), 50)
    if "ops" in want:
        scenes = [cs.make_scene(seed, 1080, 1920) for seed in range(4)]
        print(f"default path ops per image: "
              f"{cs.count_ops(torch, scenes, cfg, dev)}", flush=True)
        for seed, scene in enumerate(scenes):
            f = ext.extract_features(scene, cfg, device=dev)
            h = hashlib.sha256()
            for k, v in sorted(f.soa().items()):
                h.update(k.encode())
                h.update(np.ascontiguousarray(v).tobytes())
            h.update(np.ascontiguousarray(f.get_descriptors()).tobytes())
            print(f"scene {seed}: {f.get_feature_count()} features, "
                  f"{f.get_descriptor_count()} descriptor rows, sha256 "
                  f"{h.hexdigest()[:16]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
