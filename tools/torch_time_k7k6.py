"""Time K7 (octave chain), K6 and K11 (loop descriptors) of a checkout of
popsift_torch on one CUDA card, to compare two trees on the same card.

    python3 tools/torch_time_k7k6.py [--root DIR]

``--root`` is the checkout whose popsift_torch is timed (this repository
by default); run the tool in turns for two checkouts (A, B, B, A) in one
run on the card.  It uses only functions that every version of the
port has: level 0 of octave 0 of chip_smoke.py's seed-0 1080p scene for
K7 (both emit forms), the descriptor rows of the busiest octave for K6
and K11.  Each kernel gets chip_smoke.py's two times of one call: between
CUDA events (chip_smoke.cuda_ms, the median of 20 calls for K7 and 50 for
K6/K11) and on the device (chip_smoke.device_ms, the mean), printed beside
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    root = Path(ap.parse_args().root).resolve()
    import torch
    if not torch.cuda.is_available():
        print("torch_time_k7k6: no CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("cs", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, str(root))
    import popsift_torch as pt
    from popsift_torch import extract as ext
    from popsift_torch.gauss import build_gauss_info
    from popsift_torch.kernels import _lib, binwin, grad, octave
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
    best, src = None, img
    for o in range(plan.octaves):
        st, dg = ops_pyr.build_octave(src, o, plan.dims, plan.levels, gauss,
                                      plan.sift_mode, plan.upscale_factor)
        if o == 0:
            lvl0 = st[0].contiguous()
        _, ex = ext.octave_keypoints(plan, o, dg)
        if best is None or ex.count > best[0]:
            best = (ex.count, o, st, ex)
        src = st
    keep = (len(spans) - ops_pyr.PREV_LEVEL,)

    def report(label, fn, reps):
        ms, dms = cs.kernel_ms(fn, reps)
        print(f"{label}: {ms:.6f} ms, device {dms:.6f} ms", flush=True)

    for emit_stack in (False, True):
        form = "whole stack" if emit_stack else f"level {keep[0]} kept"
        report(f"K7 octave 0 {tuple(lvl0.shape)}, {form}",
               lambda: octave.octave_chain(lvl0, filters, spans, emit_stack,
                                           keep), 20)
    _, o, stack, ex = best
    field = grad.grad_field(stack)
    num_ori, oris = ops_ori.assign_orientations(field, ex.xpos, ex.ypos,
                                                ex.lpos, ex.sigma)
    feat, ang, _ = ext.descriptor_rows(plan, o, num_ori, oris)
    rows = tuple(v[feat].contiguous() for v in (ex.xpos, ex.ypos, ex.lpos,
                                                ex.sigma)) \
        + (ang.contiguous(),)
    half = plan.desc_win // 2
    n = int(feat.shape[0])
    report(f"K6 octave {o}, {n} rows",
           lambda: binwin.desc_loop(field, *rows, half), 50)
    report(f"K11 octave {o}, {n} rows",
           lambda: binwin.desc_loop_stack(stack, *rows, half), 50)
    return 0


if __name__ == "__main__":
    sys.exit(main())
