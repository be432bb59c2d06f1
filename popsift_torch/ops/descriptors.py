"""Descriptors of the loop and grid families and their normalisation
(popsift_tpu/ops/descriptors.py).

Loop descriptors read the gradient field (K6), or the blurred stack (K11)
on the stack-kernel path.  The sampling modes read the blurred stack
through one window per row (K8's exact-origin window) and compute each
descriptor from it: NoTile and IGrid, which compute the same numbers, on a
rotated 40x40 grid (:func:`grid_descriptors_windowed`, K9); Grid on
rotated 16x16 grids per tile rounded to pixels
(:func:`grid_rounded_descriptors_windowed`, K12); ILoop on axis-aligned
32x32 grids per tile (:func:`iloop_descriptors_windowed`, K13).  All three
kernels read the window's pixels straight from the stack.  The
whole-plane forms (:func:`grid_descriptors`,
:func:`grid_rounded_descriptors`, :func:`iloop_descriptors`) sample the
octave's plane instead and are kept for the tests that hold the windowed
forms to them.  The JAX package's matmul forms (``..._mm``) recast the
sampling for the TPU's matrix unit; K9, K12 and K13 compute the same
functions directly and the matmul forms are not ported.
"""

from __future__ import annotations

import math

import torch

from ..constants import DESC_MAGNIFY
from ..kernels.binwin import desc_loop, desc_loop_stack
from ..kernels.desc_grid import (CHUNK_GRID, CHUNK_ILOOP,  # noqa: F401
                                 _grid_steps, _tile_weight_matrix,
                                 desc_grid_rounded_stack, desc_grid_stack,
                                 desc_iloop_stack, grid_histograms,
                                 grid_points, grid_rounded_body, iloop_body)
from .orientation import max_sigma


def desc_window_size(sigma0: float, levels: int) -> int:
    """Static loop-family window: covers |d|_inf < 2.5*sqrt(2)*SBP_max."""
    sbp_max = DESC_MAGNIFY * max_sigma(sigma0, levels)
    win = int(math.ceil(2.0 * 2.5 * math.sqrt(2.0) * sbp_max)) + 4
    return (win + 7) // 8 * 8


def loop_descriptors(field, xpos, ypos, lpos, sigma, ang, win: int,
                     stack=None) -> torch.Tensor:
    """(n, 128) unnormalised descriptors in [ty][tx][bin] order from the
    (2L, H, W) ``field`` (K6), or from the (L, H, W) ``stack`` (K11) when
    one is given (popsift_tpu ops/descriptors.py:89-94); ``field`` may
    then be None.  The caller passes a stack only on the stack-kernel
    path."""
    if stack is not None:
        return desc_loop_stack(stack, xpos, ypos, lpos, sigma, ang, win // 2)
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


def _zero_invalid(desc: torch.Tensor, valid) -> torch.Tensor:
    if valid is None:
        return desc
    return torch.where(valid[:, None], desc, 0.0)


def grid_descriptors_windowed(stack: torch.Tensor, xpos, ypos, lpos, sigma,
                              ang, win: int, desc_gauss, desc_tile,
                              valid=None) -> torch.Tensor:
    """(n, 128) NoTile/IGrid descriptors through K8's windows, which K9
    reads straight from the stack and samples in window-local coordinates.
    ``valid`` (n,) bool zeroes rows."""
    return _zero_invalid(desc_grid_stack(stack, xpos, ypos, lpos, sigma, ang,
                                         win, desc_gauss, desc_tile), valid)


def grid_rounded_descriptors_windowed(stack: torch.Tensor, xpos, ypos, lpos,
                                      sigma, ang, win: int,
                                      valid=None) -> torch.Tensor:
    """(n, 128) Grid descriptors through K8's windows, which K12 reads
    straight from the stack.  Integer taps are clipped to the image first
    and then to the window (popsift_tpu ops/descriptors.py:908-958); a
    clipped tap always lands inside the window, since clipping only moves
    a sample toward the keypoint."""
    return _zero_invalid(desc_grid_rounded_stack(stack, xpos, ypos, lpos,
                                                 sigma, ang, win), valid)


def iloop_descriptors_windowed(stack: torch.Tensor, xpos, ypos, lpos, sigma,
                               ang, win: int, valid=None) -> torch.Tensor:
    """(n, 128) ILoop descriptors through K8's windows, which K13 reads
    straight from the stack, with the image bounds in window coordinates
    as for NoTile (popsift_tpu ops/descriptors.py:1039-1088)."""
    return _zero_invalid(desc_iloop_stack(stack, xpos, ypos, lpos, sigma,
                                          ang, win), valid)


def _chunked(body, n: int, chunk: int, device) -> torch.Tensor:
    out = torch.empty((n, 128), dtype=torch.float32, device=device)
    for s in range(0, n, chunk):
        out[s:s + chunk] = body(slice(s, s + chunk))
    return out


def grid_rounded_descriptors(stack: torch.Tensor, xpos, ypos, lpos, sigma,
                             ang, valid=None) -> torch.Tensor:
    """(n, 128) Grid descriptors over whole-plane integer taps."""
    L, h, w = stack.shape
    lp = lpos.to(torch.int64).clamp(0, L - 1)
    flat = stack.reshape(-1)

    def body(e):
        row = (lp[e] * h)[:, None, None]

        def tapi(yy, xx):
            return flat[(row + yy) * w + xx]
        return grid_rounded_body(tapi, xpos[e], ypos[e], sigma[e], ang[e],
                                 w, h)
    return _zero_invalid(_chunked(body, xpos.shape[0], CHUNK_GRID,
                                  stack.device), valid)


def iloop_descriptors(stack: torch.Tensor, xpos, ypos, lpos, sigma, ang,
                      valid=None) -> torch.Tensor:
    """(n, 128) ILoop descriptors over whole-plane bilinear samples."""
    L = stack.shape[0]
    lp = lpos.to(torch.int64).clamp(0, L - 1)

    def body(e):
        def bil(px, py):
            return _bilinear(stack, lp[e], px, py)
        return iloop_body(bil, xpos[e], ypos[e], sigma[e], ang[e])
    return _zero_invalid(_chunked(body, xpos.shape[0], CHUNK_ILOOP,
                                  stack.device), valid)


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
