"""The plain reference of AliceVision's popSIFT describer: ``sift`` plus
float images, the reference's per-octave capacities and the grid filter.

AliceVision's ``ImageDescriber_SIFT_popSIFT`` hands PopSift float images
and turns on the grid filter at ``filter_max_extrema``.  This module
reuses ``benchmark.reference.sift`` for the scale space, detection,
refinement, orientation, descriptors and assembly, and adds:

* the image as given: a float32 image is taken as it is, a uint8 one is
  scaled by 1/255 as ``sift`` scales it;
* the capacities PopSift has: an octave keeps up to ``max_extrema``
  refined extrema in candidate order (s_extrema.cu:549-557), and
  ``1.25 * max_extrema`` descriptor rows (sift_constants.cu:31);
* the grid filter over every octave's extrema before orientation
  (s_filtergrid.cu:225-263, s_orientation.cu:378-383): it acts when
  ``filter_max_extrema * 1.1 < total``, compared in float32; the cells'
  populations sorted ascending give ``sumup_i = count_i * (cells - 1 -
  i) + (count_0 + ... + count_i)``, ``ct`` the cells whose ``sumup``
  exceeds the budget, ``tailaverage`` the mean of the ``ct`` largest
  populations in float32 and ``newlimit = ceil(tailaverage - (total -
  budget) / ct)`` with the C++ integer division; each cell keeps its
  first ``newlimit`` extrema, ordered by ``sigma * 2**octave``, largest
  first (LargestScaleFirst) or smallest first (SmallestScaleFirst).

Departures from the published description, each shared with the
program: the candidates pass ``sift``'s per-block budget (16 of each
1,024 voxels of an octave's mask), which PopSift does not have; within
a cell, extrema of equal scale keep their order, octave by octave and
in raster order within an octave, where PopSift's sort need not be
stable; RandomScale, which PopSift shuffles, is refused.  A
cell is ``floor(y / (h / g)) * g + floor(x / (w / g))`` in octave
coordinates, each quotient a float32 division, clipped to the last cell.

It imports nothing of the program.  The check runs it in float32 with
TF32 off; ``pyramid_dtype=torch.bfloat16`` is the control, as in
``sift``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import sift

GRID_MODES = ("down", "up")
DEFAULTS = dict(sift.DEFAULTS, grid_filter_mode="random")


def settings_of(popsift_config: dict) -> dict:
    """The configuration's settings with the defaults filled in; raises
    on a setting this reference does not implement."""
    s = dict(DEFAULTS)
    for k, v in popsift_config.items():
        if k in ("verbose", "log_mode", "print_gauss_tables"):
            continue
        if k not in DEFAULTS:
            raise ValueError(f"reference: unknown setting {k!r}")
        s[k] = v
    for k, allowed in sift.SUPPORTED.items():
        if s[k] not in allowed:
            raise ValueError(f"reference: {k}={s[k]!r} is not implemented")
    if s["ext_capacity"] > 0 or s["ori_capacity"] > 0:
        raise ValueError("reference: ext_capacity and ori_capacity are "
                         "not implemented")
    if s["filter_max_extrema"] > 0:
        if s["grid_filter_mode"] not in GRID_MODES:
            raise ValueError(f"reference: grid_filter_mode="
                             f"{s['grid_filter_mode']!r} is not implemented")
        if int(s["filter_grid_size"]) < 1:
            raise ValueError("reference: filter_grid_size must be >= 1")
    s["levels"] = max(2, int(s["levels"]))
    return s


def make_plan(settings: dict, width: int, height: int) -> sift.Plan:
    """``sift``'s plan with PopSift's capacities: up to ``max_extrema``
    extrema an octave, 1.25 times that in rows, and candidates bounded
    only by the per-block budget."""
    plan = sift.make_plan(settings, width, height)
    ext = int(settings["max_extrema"])
    ori = -(-(ext + ext // 4) // 128) * 128
    cand = tuple(-(-(w * h * plan.levels) // sift.BLOCK) * sift.PER_BLOCK
                 for w, h in plan.dims)
    return dataclasses.replace(plan, cand_caps=cand,
                               ext_caps=(ext,) * plan.octaves,
                               ori_caps=(ori,) * plan.octaves)


def gauss_tables(settings: dict):
    return sift.gauss_tables(settings)


def _cells(x, y, dims, grid: int, device):
    """The grid cell of each extremum (octave coordinates), clipped to
    the last cell."""
    w, h = dims
    gw = torch.tensor(np.float32(w / grid), device=device)
    gh = torch.tensor(np.float32(h / grid), device=device)
    cell = (torch.floor(y / gh).to(torch.int64) * grid
            + torch.floor(x / gw).to(torch.int64))
    return cell.clamp(0, grid * grid - 1)


def grid_filter(cells: np.ndarray, scales: np.ndarray, budget: int,
                grid: int, largest_first: bool) -> np.ndarray:
    """The bool mask of the extrema the filter keeps, over the extrema of
    every octave end to end; ``cells`` their grid cells, ``scales``
    their float32 ``sigma * 2**octave``."""
    total = cells.shape[0]
    if not np.float32(budget * 1.1) < np.float32(total):
        return np.ones(total, bool)
    n_cells = grid * grid
    counts = np.bincount(cells, minlength=n_cells).astype(np.int64)
    srt = np.sort(counts)
    sumup = srt * (n_cells - 1 - np.arange(n_cells)) + np.cumsum(srt)
    ct = int((sumup > budget).sum())
    tailaverage = np.float32(srt[n_cells - ct:].sum()) / np.float32(ct)
    newlimit = int(np.ceil(tailaverage - np.float32((total - budget) // ct)))
    key = -scales if largest_first else scales
    order = np.lexsort((np.arange(total), key, cells))
    first = np.cumsum(counts) - counts
    rank = np.empty(total, np.int64)
    rank[order] = np.arange(total) - first[cells[order]]
    return rank < newlimit


def extract(image: np.ndarray, settings: dict, device="cuda",
            pyramid_dtype=torch.float32) -> dict:
    """Features of one (H, W) image, float32 as it is or uint8 scaled by
    1/255, in the layout of ``sift.extract``."""
    h, w = image.shape
    plan = make_plan(settings, w, h)
    tables = sift.gauss_tables(settings)
    if image.dtype == np.uint8:
        img = torch.as_tensor(np.array(image), device=device) \
            .to(torch.float32) * (1.0 / 255.0)
    else:
        img = torch.as_tensor(np.array(image, np.float32), device=device)
    gate = float(np.float32(1.6)
                 * np.float32(sift.plan_peak_threshold(settings)))
    grid = int(settings["filter_grid_size"])

    # stage 1, every octave: scale space, detection, refinement
    stacks, found = [], []
    src = img
    for o in range(plan.octaves):
        stack, dog = sift.octave_stack(src, o, plan, tables, pyramid_dtype)
        src = stack[plan.levels + 3 - sift.PREV_LEVEL]
        zyx = sift.compact_mask(sift.detect(dog, gate), plan.cand_caps[o])
        found.append(sift.refine(dog, zyx, plan, o, plan.ext_caps[o]))
        del dog
        stacks.append(stack)

    # the grid filter over all of them
    if settings["filter_max_extrema"] > 0:
        cells = torch.cat([_cells(x, y, plan.dims[o], grid, device)
                           for o, (x, y, _, _) in enumerate(found)])
        scales = torch.cat([s * (2.0 ** o)
                            for o, (_, _, _, s) in enumerate(found)])
        keep = torch.as_tensor(grid_filter(
            cells.cpu().numpy(), scales.cpu().numpy(),
            int(settings["filter_max_extrema"]), grid,
            settings["grid_filter_mode"] == "down"), device=device)
        sizes = [int(f[0].shape[0]) for f in found]
        found = [tuple(a[k] for a in f)
                 for f, k in zip(found, torch.split(keep, sizes))]

    # stage 2, octave by octave
    parts = []
    for o, (x, y, lpos, sigma) in enumerate(found):
        field = sift.gradient_field(stacks[o])
        if x.shape[0]:
            num_ori, oris = sift.peaks_from_hist(
                sift.ori_hist(field, x, y, lpos, sigma))
        else:
            num_ori = torch.zeros(0, dtype=torch.int32, device=device)
            oris = torch.zeros((0, 4), dtype=torch.float32, device=device)
        n = num_ori.shape[0]
        num64 = num_ori.to(torch.int64)
        incl = torch.cumsum(num64, 0)
        rows = min(int(incl[-1]) if n else 0, plan.ori_caps[o])
        feat = torch.repeat_interleave(torch.arange(n, device=device),
                                       num64)[:rows]
        first = incl - num64
        ang = oris[feat, torch.arange(rows, device=device) - first[feat]]
        num_eff = torch.clamp(torch.minimum(num64, rows - first), min=0)
        if settings["desc_mode"] == "notile":
            desc = sift.desc_notile(stacks[o], x[feat], y[feat], lpos[feat],
                                    sigma[feat], ang, plan.desc_win,
                                    *sift.desc_tables(device))
        else:
            desc = sift.desc_loop(field, x[feat], y[feat], lpos[feat],
                                  sigma[feat], ang, plan.desc_win // 2)
        parts.append(dict(
            x=x.cpu().numpy(), y=y.cpu().numpy(), sigma=sigma.cpu().numpy(),
            num_ori=num_eff.to(torch.int32).cpu().numpy(),
            orientations=oris.cpu().numpy(),
            desc=sift.quantize(sift.normalize(desc, settings), settings)))
        del field
        stacks[o] = None
    return sift.assemble(parts, settings["upscale_factor"])
