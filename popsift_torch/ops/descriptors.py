"""Loop-mode descriptors and their normalisation
(popsift_tpu/ops/descriptors.py)."""

from __future__ import annotations

import math

import torch

from ..constants import DESC_MAGNIFY
from ..kernels.binwin import desc_loop
from .orientation import max_sigma


def desc_window_size(sigma0: float, levels: int) -> int:
    """Static loop-family window: covers |d|_inf < 2.5*sqrt(2)*SBP_max."""
    sbp_max = DESC_MAGNIFY * max_sigma(sigma0, levels)
    win = int(math.ceil(2.0 * 2.5 * math.sqrt(2.0) * sbp_max)) + 4
    return (win + 7) // 8 * 8


def loop_descriptors(field: torch.Tensor, xpos, ypos, lpos, sigma, ang,
                     win: int) -> torch.Tensor:
    """(n, 128) unnormalised descriptors in [ty][tx][bin] order (K6)."""
    return desc_loop(field, xpos, ypos, lpos, sigma, ang, win // 2)


def normalize_rootsift(desc: torch.Tensor, norm_multi: int) -> torch.Tensor:
    """L1-normalise then sqrt, scaled by 2^norm_multi
    (s_desc_norm_rs.h:42-77)."""
    s = desc.sum(dim=-1, keepdim=True)
    safe = torch.where(s > 0.0, s, 1.0)
    out = torch.sqrt(desc / safe) * (2.0 ** norm_multi)
    return torch.where(s > 0.0, out, 0.0)


def normalize_l2(desc: torch.Tensor, norm_multi: int) -> torch.Tensor:
    """Classic L2: norm, clamp at 0.2*norm, renormalise with rsqrt
    (s_desc_norm_l2.h:86-129)."""
    n1 = torch.sqrt((desc * desc).sum(dim=-1, keepdim=True))
    clamped = torch.minimum(desc, 0.2 * n1)
    n2sq = (clamped * clamped).sum(dim=-1, keepdim=True)
    inv = torch.rsqrt(torch.where(n2sq > 0.0, n2sq, 1.0)) \
        * (2.0 ** norm_multi)
    return torch.where(n2sq > 0.0, clamped * inv, 0.0)
