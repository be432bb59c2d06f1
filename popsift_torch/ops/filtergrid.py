"""Grid filtering: cap the total number of extrema with per-cell budgets
(popsift_tpu/ops/filtergrid.py).

The JAX package computes the filter with jnp sorts and sums over
fixed-capacity buffers; here the same decisions run on the port's compact
per-octave :class:`~popsift_torch.ops.extrema.Extrema`, whose entries are
all valid and in the order the JAX buffers hold their valid slots:

* every extremum carries a grid-cell id (clipped to the last cell) and a
  cross-octave scale ``sigma * 2**octave``;
* extrema are sorted stably, cell-major, and within a cell by scale as
  the GridFilterMode says (RandomScale keeps raster order);
* the cell budget ``newlimit`` comes from the cells' populations sorted
  ascending, with the C++ integer division and float32 arithmetic of the
  JAX package (s_filtergrid.cu:225-263);
* the filter acts only when ``budget * 1.1 < total``, compared in float32
  as the JAX package compares it (s_orientation.cu:378-383).

Plain PyTorch on the extrema's device; the JAX package has no Pallas
kernel here.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import tracing
from ..config import GridFilterMode
from .extrema import Extrema


def triggers(budget: int, total: int) -> bool:
    """Whether the filter acts on ``total`` extrema: the JAX package's
    ``budget * 1.1 < total.astype(float32)``, whose Python float is taken
    to float32 (weak typing) before the comparison."""
    return bool(np.float32(budget * 1.1) < np.float32(total))


def grid_filter_keep_masks(exts: list[Extrema], budget: int, grid_size: int,
                           mode: GridFilterMode) -> list[torch.Tensor]:
    """Per-octave bool masks (one entry per extremum) of the extrema the
    filter keeps: all of them unless :func:`triggers`."""
    sizes = [int(e.xpos.shape[0]) for e in exts]
    total = sum(sizes)
    dev = exts[0].xpos.device
    if not triggers(budget, total):
        return [torch.ones(n, dtype=torch.bool, device=dev) for n in sizes]
    n_cells = grid_size * grid_size
    cell = torch.cat([e.cell.to(torch.int64) for e in exts]).clamp(
        0, n_cells - 1)
    scale = torch.cat([e.sigma * (2.0 ** o) for o, e in enumerate(exts)])

    # stable sort, cell-major, then by the mode's scale order
    if mode == GridFilterMode.LARGEST_SCALE_FIRST:
        order = torch.argsort(-scale, stable=True)
    elif mode == GridFilterMode.SMALLEST_SCALE_FIRST:
        order = torch.argsort(scale, stable=True)
    else:
        order = torch.arange(total, device=dev)
    order = order[torch.argsort(cell[order], stable=True)]

    cells = torch.arange(n_cells, device=dev)
    counts = (cell[:, None] == cells[None, :]).sum(0)        # (n_cells,)

    # s_filtergrid.cu:225-257: cells by population ascending, sumup_i =
    # count_i * (n - 1 - i) + prefix sum_i, ct = cells with sumup > budget
    cnt_sorted = torch.sort(counts).values
    sumup = cnt_sorted * (n_cells - 1 - cells) + torch.cumsum(cnt_sorted, 0)
    ct = torch.clamp((sumup > budget).sum(), min=1)
    # the mean population of the ct most populated cells, in float32
    tail = torch.where(cells >= n_cells - ct, cnt_sorted, 0).sum()
    tailaverage = tail.to(torch.float32) / ct.to(torch.float32)
    # the C++ integer division (s_filtergrid.cu:257); total > budget here
    int_div = (total - budget) // ct
    newlimit = torch.ceil(tailaverage - int_div.to(torch.float32)).to(
        torch.int64)
    limits = torch.minimum(counts, newlimit)

    # rank of each extremum within its cell in the sorted order
    cell_sorted = cell[order]
    offsets = torch.cumsum(counts, 0) - counts
    rank = torch.arange(total, device=dev) - offsets[cell_sorted]
    keep = torch.empty(total, dtype=torch.bool, device=dev)
    keep[order] = rank < limits[cell_sorted]
    return list(torch.split(keep, sizes))


def recompact(e: Extrema, keep: torch.Tensor) -> Extrema:
    """The extrema that ``keep`` names, in their order (the copy_if
    writeback, s_filtergrid.cu:290-318); the overflow stays the
    extraction's.  The count is read back (``readback.recompact``)."""
    sp = tracing.begin("readback.recompact") if tracing.HOSTTRACE else None
    idx = torch.nonzero(keep).reshape(-1)
    if sp is not None:
        tracing.end(sp)
    return Extrema(xpos=e.xpos[idx], ypos=e.ypos[idx], lpos=e.lpos[idx],
                   sigma=e.sigma[idx], cell=e.cell[idx],
                   count=int(idx.shape[0]), overflow=e.overflow)
