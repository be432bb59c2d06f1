"""Compaction of DoG extrema (popsift_tpu/ops/extrema.py).

Detection and the Newton refinement are K3 and K4
(:mod:`popsift_torch.kernels.detect`, :mod:`popsift_torch.kernels.refine`);
this module turns their per-voxel and per-candidate outputs into lists.
Shapes are dynamic here: candidate and extremum lists hold exactly the
kept entries, in raster (z, y, x) order, clamped at the plan's capacities
with the number dropped reported as ``overflow`` (the reference clamps
to max_extrema the same way, s_extrema.cu:549-557).
"""

from __future__ import annotations

from typing import NamedTuple

import torch



class Candidates(NamedTuple):
    x: torch.Tensor      # (count,) i32
    y: torch.Tensor      # (count,) i32
    z: torch.Tensor      # (count,) i32 mask layer (DoG layer - 1)
    count: int
    overflow: int


class Extrema(NamedTuple):
    xpos: torch.Tensor   # (count,) f32, octave coordinates
    ypos: torch.Tensor
    lpos: torch.Tensor   # (count,) i32
    sigma: torch.Tensor  # (count,) f32
    cell: torch.Tensor   # (count,) i32 grid-filter cell id
    count: int
    overflow: int


def compact_mask(mask: torch.Tensor, cap: int) -> Candidates:
    """Set positions of the mask in raster (z, y, x) order, clamped at
    ``cap`` (compact_mask of the JAX package without its per-block
    survivor budget, see ROADMAP Queue 3)."""
    nz = torch.nonzero(mask)
    total = int(nz.shape[0])
    count = min(total, cap)
    nz = nz[:count].to(torch.int32)
    return Candidates(x=nz[:, 2], y=nz[:, 1], z=nz[:, 0], count=count,
                      overflow=total - count)


def compact_extrema(xn, yn, lpos, sigma, cell, ok, cap: int) -> Extrema:
    """Keep the refined survivors in candidate order, clamped at ``cap``."""
    idx = torch.nonzero(ok).reshape(-1)
    total = int(idx.shape[0])
    count = min(total, cap)
    idx = idx[:count]
    return Extrema(xpos=xn[idx], ypos=yn[idx], lpos=lpos[idx],
                   sigma=sigma[idx], cell=cell[idx], count=count,
                   overflow=total - count)
