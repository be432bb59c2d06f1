"""Compaction of DoG extrema (popsift_tpu/ops/extrema.py).

Detection and the Newton refinement are K3 and K4
(:mod:`popsift_torch.kernels.detect`, :mod:`popsift_torch.kernels.refine`);
this module turns K3's per-voxel mask into a list, and holds the plain
version of K4's compaction (:func:`compact_extrema`).
Shapes are dynamic here: candidate and extremum lists hold exactly the
kept entries, in raster (z, y, x) order, clamped at the plan's capacities
with the number dropped reported as ``overflow`` (the reference clamps
to max_extrema the same way, s_extrema.cu:549-557).  Candidates also
pass the JAX package's per-block survivor budget first.  The counts are
read back to the host, each a ``readback.compact`` or (the plain K4
compaction) ``readback.refine_status`` host span when the recorder is on.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import torch

from .. import tracing

# popsift_tpu/ops/extrema.py: compact_mask keeps at most PER_BLOCK set
# positions of each BLOCK-voxel run of the flattened (z, y, x) mask
BLOCK = 1024
PER_BLOCK = 16

# Candidates the budget dropped since the last reset_budget_dropped(), a
# tally like the kernels' launch counts that a run reads per image
_tally_lock = threading.Lock()
_budget_dropped = 0


def budget_dropped() -> int:
    with _tally_lock:
        return _budget_dropped


def reset_budget_dropped() -> None:
    global _budget_dropped
    with _tally_lock:
        _budget_dropped = 0


def _tally(n: int) -> None:
    global _budget_dropped
    with _tally_lock:
        _budget_dropped += n


class Candidates(NamedTuple):
    zyx: torch.Tensor    # (count, 3) i32 rows (mask layer, y, x); the
    #                      mask layer is the DoG layer - 1
    count: int
    overflow: int

    @property
    def x(self) -> torch.Tensor:
        return self.zyx[:, 2]

    @property
    def y(self) -> torch.Tensor:
        return self.zyx[:, 1]

    @property
    def z(self) -> torch.Tensor:
        return self.zyx[:, 0]


class Extrema(NamedTuple):
    xpos: torch.Tensor   # (count,) f32, octave coordinates
    ypos: torch.Tensor
    lpos: torch.Tensor   # (count,) i32
    sigma: torch.Tensor  # (count,) f32
    cell: torch.Tensor   # (count,) i32 grid-filter cell id
    count: int
    overflow: int


def compact_mask(mask: torch.Tensor, cap: int) -> Candidates:
    """Set positions of the mask in raster (z, y, x) order: the first
    PER_BLOCK of each BLOCK-voxel run of the flattened mask, then clamped
    at ``cap`` (compact_mask of the JAX package).  ``overflow`` counts
    every set position not returned, the budget's and the cap's."""
    sp = tracing.begin("readback.compact") if tracing.HOSTTRACE else None
    nz = torch.nonzero(mask)                 # (total, 3), raster order
    if sp is not None:
        tracing.end(sp)
    total = int(nz.shape[0])
    if total > PER_BLOCK:
        _, h, w = mask.shape
        block = ((nz[:, 0] * h + nz[:, 1]) * w + nz[:, 2]) // BLOCK
        # in raster order a position is its block's PER_BLOCK-th or later
        # exactly when the position PER_BLOCK before it is in the same block
        over = block[PER_BLOCK:] == block[:-PER_BLOCK]
        sp = tracing.begin("readback.compact") if tracing.HOSTTRACE else None
        any_over = bool(over.any())
        if sp is not None:
            tracing.end(sp)
        if any_over:
            keep = torch.ones(total, dtype=torch.bool, device=nz.device)
            keep[PER_BLOCK:] = ~over
            sp = (tracing.begin("readback.compact") if tracing.HOSTTRACE
                  else None)
            nz = nz[keep]              # boolean indexing reads a count
            if sp is not None:
                tracing.end(sp)
    kept = int(nz.shape[0])
    _tally(total - kept)
    count = min(kept, cap)
    return Candidates(zyx=nz[:count].to(torch.int32).contiguous(),
                      count=count, overflow=total - count)


def compact_extrema(xn, yn, lpos, sigma, cell, ok, cap: int) -> Extrema:
    """Keep the refined survivors in candidate order, clamped at ``cap``."""
    sp = (tracing.begin("readback.refine_status") if tracing.HOSTTRACE
          else None)
    idx = torch.nonzero(ok).reshape(-1)
    if sp is not None:
        tracing.end(sp)
    total = int(idx.shape[0])
    count = min(total, cap)
    idx = idx[:count]
    return Extrema(xpos=xn[idx], ypos=yn[idx], lpos=lpos[idx],
                   sigma=sigma[idx], cell=cell[idx], count=count,
                   overflow=total - count)
