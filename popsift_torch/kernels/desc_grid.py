"""K9: NoTile/IGrid descriptors from per-slot windows (csrc/desc_grid.cu).

The JAX package computes this step as XLA (ops/descriptors.py:
grid_descriptors_windowed and its matmul form ..._mm); the reference runs
it as a CUDA kernel (s_desc_notile.cu:31-129).  The plain version here is
the arithmetic of grid_descriptors_windowed, batched over the slots:
the rotated 40x40 sample grid, bilinear samples inside each slot's
(win_y, 128) window in window-local coordinates, the rotated gradient,
the Gaussian weight, two orientation bins and the two tile contractions.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import DESC_MAGNIFY, M_4RPI, M_PI2
from . import _lib

_CHUNK = 256


def _grid_steps() -> np.ndarray:
    """40 sample offsets: stepbase + k/8, stepbase = -2.5 + 1/16
    (s_desc_notile.cu:29,57-58)."""
    return (-2.5 + 1.0 / 16.0
            + np.arange(40, dtype=np.float32) / 8.0)


def _tile_weight_matrix(desc_tile: torch.Tensor) -> torch.Tensor:
    """(40, 4) matrix: TX[k, t] = desc_tile[k - 8t] when 0 <= k - 8t < 16
    (s_desc_notile.cu:55)."""
    TX = torch.zeros((40, 4), dtype=torch.float32, device=desc_tile.device)
    for t in range(4):
        TX[8 * t:8 * t + 16, t] = desc_tile
    return TX


def grid_points(x, y, sigma, ang):
    """The rotated 40x40 sample grid of each slot: (px, py) (n, 40, 40)
    in the octave's coordinates, cos and sin of the angle (n, 1, 1) and
    ``ok`` (n, 1, 1), the scale gate."""
    steps = torch.as_tensor(_grid_steps(), device=x.device)
    sbp = torch.abs(DESC_MAGNIFY * sigma)[:, None, None]
    cos_t = torch.cos(ang)[:, None, None]
    sin_t = torch.sin(ang)[:, None, None]
    sx = steps[None, None, :]
    sy = steps[None, :, None]
    ptx = cos_t * sx - sin_t * sy
    pty = cos_t * sy + sin_t * sx
    px = x[:, None, None] + ptx * sbp
    py = y[:, None, None] + pty * sbp
    return px, py, cos_t, sin_t, sbp > 0.0


def grid_histograms(dx, dy, ok, desc_gauss, desc_tile) -> torch.Tensor:
    """(n, 128) descriptors in [ty][tx][bin] order from the rotated
    gradient (dx, dy) of every sample (n, 40, 40)."""
    mod = torch.hypot(dx, dy)
    th = torch.atan2(dy, dx)
    th = torch.where(th < 0.0, th + M_PI2, th)
    tth = th * M_4RPI
    fo = torch.floor(tth).to(torch.int32)
    do0 = tth - fo.to(torch.float32)
    fo0 = fo & 7
    fo1 = (fo0 + 1) & 7
    ww = torch.where(ok, desc_gauss * mod, 0.0)
    bins = torch.arange(8, dtype=torch.int32, device=dx.device)
    A = ((fo0[..., None] == bins) * ((1.0 - do0) * ww)[..., None]
         + (fo1[..., None] == bins) * (do0 * ww)[..., None])
    TX = _tile_weight_matrix(desc_tile)
    B = torch.einsum("nyxb,xt->nytb", A, TX)
    D = torch.einsum("nytb,ys->nstb", B, TX)
    return D.reshape(-1, 128)


def _bilinear_win(wflat, px, py, win_y: int, xlo, xhi, ylo, yhi):
    """Bilinear samples inside each slot's flattened (win_y, 128) window
    (ops/descriptors.py:_bilinear_win of the JAX package): the coordinate
    is clamped to the image bounds in window-local terms, the tap indices
    to the window."""
    n = px.shape[0]
    px = torch.minimum(torch.maximum(px, xlo), xhi)
    py = torch.minimum(torch.maximum(py, ylo), yhi)
    x0f = torch.floor(px)
    y0f = torch.floor(py)
    fx = px - x0f
    fy = py - y0f
    x0 = x0f.to(torch.int64).clamp_(0, 126)
    y0 = y0f.to(torch.int64).clamp_(0, win_y - 2)
    base = (y0 * 128 + x0).reshape(n, -1)

    def tap(off):
        return torch.gather(wflat, 1, base + off).reshape(px.shape)

    v00, v01, v10, v11 = tap(0), tap(1), tap(128), tap(129)
    return ((v00 * (1 - fx) + v01 * fx) * (1 - fy)
            + (v10 * (1 - fx) + v11 * fx) * fy)


def desc_grid_plain(wins, x, y, x0f, y0f, sigma, ang, w: int, h: int,
                    desc_gauss, desc_tile) -> torch.Tensor:
    n, win_y, _ = wins.shape
    out = torch.empty((n, 128), dtype=torch.float32, device=wins.device)
    for s in range(0, n, _CHUNK):
        e = slice(s, s + _CHUNK)
        px, py, cos_t, sin_t, ok = grid_points(x[e], y[e], sigma[e], ang[e])
        ox = x0f[e][:, None, None]
        oy = y0f[e][:, None, None]
        pxr = px - ox
        pyr = py - oy
        lims = (0.0 - ox, (w - 1.0) - ox, 0.0 - oy, (h - 1.0) - oy)
        wflat = wins[e].reshape(px.shape[0], -1)

        def bw(ppx, ppy):
            return _bilinear_win(wflat, ppx, ppy, win_y, *lims)

        dx = bw(pxr + cos_t, pyr + sin_t) - bw(pxr - cos_t, pyr - sin_t)
        dy = bw(pxr - sin_t, pyr + cos_t) - bw(pxr + sin_t, pyr - cos_t)
        out[e] = grid_histograms(dx, dy, ok, desc_gauss, desc_tile)
    return out


def desc_grid(wins: torch.Tensor, x, y, x0f, y0f, sigma, ang, w: int,
              h: int, desc_gauss: torch.Tensor,
              desc_tile: torch.Tensor) -> torch.Tensor:
    """(n, 128) unnormalised NoTile/IGrid descriptors of keypoints (x, y)
    at scale ``sigma`` and angle ``ang`` from their (n, win_y, 128)
    windows, whose origins in the (h, w) octave are (x0f, y0f)."""
    if wins.dim() != 3 or wins.shape[2] != 128 or wins.shape[1] % 4 \
            or wins.dtype != torch.float32:
        raise ValueError("desc_grid takes (n, win_y, 128) float32 windows "
                         "with win_y a multiple of 4")
    if wins.device.type == "cpu":
        return desc_grid_plain(wins, x, y, x0f, y0f, sigma, ang, w, h,
                               desc_gauss, desc_tile)
    dev = _lib.check_cuda("desc_grid", wins)
    x, y, x0f, y0f, sigma, ang, desc_gauss, desc_tile = (
        v.to(device=dev, dtype=torch.float32).contiguous()
        for v in (x, y, x0f, y0f, sigma, ang, desc_gauss, desc_tile))
    n, win_y, _ = wins.shape
    out = torch.empty((n, 128), dtype=torch.float32, device=dev)
    if n:
        _lib.call("desc_grid", dev, wins.data_ptr(), win_y, x.data_ptr(),
                  y.data_ptr(), x0f.data_ptr(), y0f.data_ptr(),
                  sigma.data_ptr(), ang.data_ptr(), n, w, h,
                  desc_gauss.data_ptr(), desc_tile.data_ptr(),
                  out.data_ptr())
    return out
