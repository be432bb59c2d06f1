"""Descriptors of the loop and grid families and their normalisation
(popsift_tpu/ops/descriptors.py).

Loop descriptors read the gradient field (K6).  The grid family (NoTile
and IGrid, which compute the same numbers) samples the blurred stack on a
rotated 40x40 grid: :func:`grid_descriptors_windowed` gathers one window
per row (K8) and computes the descriptor from it (K9);
:func:`grid_descriptors` samples the whole plane and is kept for the tests
that hold the windowed form to it.  The JAX package's matmul form
(grid_descriptors_windowed_mm) recast the sampling for the TPU's matrix
unit; K9 computes the same function directly and it is not ported.
"""

from __future__ import annotations

import math

import torch

from ..constants import DESC_MAGNIFY
from ..kernels.binwin import desc_loop
from ..kernels.desc_grid import (_grid_steps,  # noqa: F401
                                 _tile_weight_matrix, desc_grid,
                                 grid_histograms, grid_points)
from ..kernels.windows import gather_windows_exact
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


def _bilinear(stack: torch.Tensor, lp, px, py):
    """Bilinear samples of plane ``lp`` (n,) of the (L, H, W) stack at
    (px, py) (n, ...), the coordinate clamped to the image as the CUDA
    texture does (ops/descriptors.py:_bilinear of the JAX package)."""
    _, h, w = stack.shape
    px = torch.clamp(px, 0.0, w - 1.0)
    py = torch.clamp(py, 0.0, h - 1.0)
    x0f = torch.floor(px)
    y0f = torch.floor(py)
    fx = px - x0f
    fy = py - y0f
    x0 = x0f.to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y0 = y0f.to(torch.int64)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    base = lp.reshape((-1,) + (1,) * (px.dim() - 1)) * h
    flat = stack.reshape(-1)
    v00 = flat[(base + y0) * w + x0]
    v01 = flat[(base + y0) * w + x1]
    v10 = flat[(base + y1) * w + x0]
    v11 = flat[(base + y1) * w + x1]
    return ((v00 * (1 - fx) + v01 * fx) * (1 - fy)
            + (v10 * (1 - fx) + v11 * fx) * fy)


def grid_descriptors(stack: torch.Tensor, xpos, ypos, lpos, sigma, ang,
                     desc_gauss, desc_tile, valid=None) -> torch.Tensor:
    """(n, 128) NoTile/IGrid descriptors sampled from the whole octave
    plane (s_desc_notile.cu:31-129).  ``valid`` (n,) bool zeroes rows."""
    L = stack.shape[0]
    lp = lpos.to(torch.int64).clamp(0, L - 1)
    px, py, cos_t, sin_t, ok = grid_points(xpos, ypos, sigma, ang)
    if valid is not None:
        ok = ok & valid[:, None, None]

    def bl(ppx, ppy):
        return _bilinear(stack, lp, ppx, ppy)

    dx = bl(px + cos_t, py + sin_t) - bl(px - cos_t, py - sin_t)
    dy = bl(px - sin_t, py + cos_t) - bl(px + sin_t, py - cos_t)
    return grid_histograms(dx, dy, ok, desc_gauss, desc_tile)


def grid_descriptors_windowed(stack: torch.Tensor, xpos, ypos, lpos, sigma,
                              ang, win: int, desc_gauss, desc_tile,
                              valid=None) -> torch.Tensor:
    """(n, 128) NoTile/IGrid descriptors through per-row windows: K8
    gathers a (win_y, 128) window of the unpadded (L, H, W) stack at
    column round(x) - win/2 and row 8 floor((round(y) - win/2) / 8), with
    clamp addressing; K9 samples it in window-local coordinates.
    ``valid`` (n,) bool zeroes rows."""
    L, h, w = stack.shape
    x0 = torch.round(xpos).to(torch.int32) - win // 2
    y0 = torch.round(ypos).to(torch.int32) - win // 2
    lp = lpos.to(torch.int32).clamp(0, L - 1)
    wins, ya = gather_windows_exact(stack, lp, y0, x0, win)
    desc = desc_grid(wins, xpos, ypos, x0.to(torch.float32),
                     ya.to(torch.float32), sigma, ang, w, h, desc_gauss,
                     desc_tile)
    if valid is not None:
        desc = torch.where(valid[:, None], desc, 0.0)
    return desc


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
