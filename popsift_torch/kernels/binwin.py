"""K5 and K6: orientation histograms and loop-mode descriptors read from
the interleaved gradient field (csrc/binwin.cu).

Replace popsift_tpu/kernels/binwin.py:ori_hist_fused and desc_loop_fused.
The plain versions gather one square window per slot and bin it with
masked sums, the formulation of the JAX package's
ops/orientation.py:_histograms and ops/descriptors.py:loop_descriptors;
pixels outside a slot's support add exactly zero there as in the kernels.
Slots go through in chunks of similar radius, so that each chunk's window
is cut to its own largest radius.
"""

from __future__ import annotations

import math

import torch

from ..constants import DESC_MAGNIFY, M_4RPI, M_PI2, ORI_NBINS, \
    ORI_WINFACTOR
from . import _lib

_CHUNK = 256


def _chunks(radius: torch.Tensor) -> list[torch.Tensor]:
    """Slot indices in chunks of _CHUNK, in order of window radius."""
    order = torch.argsort(radius, stable=True)
    return [order[s:s + _CHUNK] for s in range(0, order.numel(), _CHUNK)]


def _windows(field, lp, rx, ry, R):
    """(n, S, S) mag and theta windows centred at (rx, ry), S = 2R+1,
    read with clamped coordinates, plus the unclamped coordinates."""
    L2, H, W = field.shape
    offs = torch.arange(-R, R + 1, device=field.device)
    jj = rx[:, None] + offs
    ii = ry[:, None] + offs
    base = (2 * lp)[:, None, None] * H + ii.clamp(0, H - 1)[:, :, None]
    idx = base * W + jj.clamp(0, W - 1)[:, None, :]
    flat = field.reshape(-1)
    return flat[idx], flat[idx + H * W], jj, ii


def ori_hist_plain(field, x, y, lpos, sigma) -> torch.Tensor:
    L2, H, W = field.shape
    n = x.shape[0]
    out = torch.zeros((n, ORI_NBINS), dtype=torch.float32,
                      device=field.device)
    pi2 = torch.tensor(M_PI2, dtype=torch.float32, device=field.device)
    radius = torch.round(3.0 * (ORI_WINFACTOR * sigma)).to(torch.int64)
    for e in _chunks(radius):
        xs, ys, sg, rad = x[e], y[e], sigma[e], radius[e]
        lp = lpos[e].to(torch.int64).clamp(0, L2 // 2 - 1)
        rx = torch.round(xs).to(torch.int64)
        ry = torch.round(ys).to(torch.int64)
        R = max(int(rad.max()), 0)
        mw, tw, jj, ii = _windows(field, lp, rx, ry, R)
        # xmin/xmax gates (s_orientation.cu:114-117)
        xmin = torch.clamp(rx - rad, min=1)
        xmax = torch.clamp(rx + rad, max=W - 2)
        ymin = torch.clamp(ry - rad, min=1)
        ymax = torch.clamp(ry + rad, max=H - 2)
        in_x = (jj >= xmin[:, None]) & (jj <= xmax[:, None])
        in_y = (ii >= ymin[:, None]) & (ii <= ymax[:, None])
        dxf = jj.to(torch.float32) - xs[:, None]
        dyf = ii.to(torch.float32) - ys[:, None]
        # int truncation of the squared distance (s_orientation.cu:142)
        sq = (dxf[:, None, :] * dxf[:, None, :]
              + dyf[:, :, None] * dyf[:, :, None]).to(torch.int32)
        sigw = ORI_WINFACTOR * sg
        factor = -0.5 / (sigw * sigw)
        inside = (sq <= (rad * rad)[:, None, None]) \
            & in_x[:, None, :] & in_y[:, :, None]
        weight = torch.where(
            inside, mw * torch.exp(sq.to(torch.float32)
                                   * factor[:, None, None]), 0.0)
        # a device-tensor divisor keeps the true division on CUDA too
        bidx = torch.round(ORI_NBINS * (tw + math.pi) / pi2).to(torch.int32)
        bidx = torch.where(bidx == ORI_NBINS, 0, bidx)
        out[e] = torch.stack([torch.where(bidx == b, weight, 0.0)
                              .sum(dim=(1, 2)) for b in range(ORI_NBINS)],
                             dim=1)
    return out


def desc_support(sigma: torch.Tensor, half: int) -> torch.Tensor:
    """Per-slot half-width R of the box that covers the descriptor's
    support |u|_inf < 2.5 (SBP units), at most the static window's half."""
    sbp = torch.abs(DESC_MAGNIFY * sigma)
    return ((3.5355339 * sbp).to(torch.int64) + 2).clamp(max=half)


def desc_loop_plain(field, x, y, lpos, sigma, ang, half: int):
    L2, H, W = field.shape
    n = x.shape[0]
    out = torch.zeros((n, 4, 4, 8), dtype=torch.float32, device=field.device)
    support = desc_support(sigma, half)
    for e in _chunks(support):
        xs, ys, sg, a = x[e], y[e], sigma[e], ang[e]
        lp = lpos[e].to(torch.int64).clamp(0, L2 // 2 - 1)
        rx = torch.round(xs).to(torch.int64)
        ry = torch.round(ys).to(torch.int64)
        R = int(support[e].max())
        mw, tw, jj, ii = _windows(field, lp, rx, ry, R)
        sbp = torch.abs(DESC_MAGNIFY * sg)
        ok = sbp > 0.0
        safe = torch.where(ok, sbp, 1.0)[:, None, None]
        cos_t = torch.cos(a)[:, None, None]
        sin_t = torch.sin(a)[:, None, None]
        dxf = (jj.to(torch.float32) - xs[:, None])[:, None, :]
        dyf = (ii.to(torch.float32) - ys[:, None])[:, :, None]
        # rotated coordinates in SBP units (s_desc_loop.cu:87-90)
        ux = (cos_t * dxf + sin_t * dyf) / safe
        uy = (cos_t * dyf - sin_t * dxf) / safe
        ww = torch.exp(-(ux * ux + uy * uy) / 8.0)
        in_img = ((jj >= 1) & (jj <= W - 2))[:, None, :] \
            & ((ii >= 1) & (ii <= H - 2))[:, :, None]
        wgt = torch.where(in_img & ok[:, None, None], mw * ww, 0.0)
        th = tw - a[:, None, None]
        th = torch.where(th < 0.0, th + M_PI2, th)
        th = torch.where(th >= M_PI2, th - M_PI2, th)
        tth = th * M_4RPI
        fo0 = torch.floor(tth).to(torch.int32)
        do0 = tth - fo0.to(torch.float32)
        fo0 = fo0.clamp(0, 7)
        fo1 = torch.where(fo0 + 1 == 8, 0, fo0 + 1)
        lo = wgt * (1.0 - do0)
        hi = wgt * do0
        wxs = [torch.clamp(1.0 - torch.abs(ux - (t - 1.5)), min=0.0)
               for t in range(4)]
        wys = [torch.clamp(1.0 - torch.abs(uy - (t - 1.5)), min=0.0)
               for t in range(4)]
        hist = torch.empty((len(e), 4, 4, 8), dtype=torch.float32,
                           device=field.device)
        for b in range(8):
            a_b = torch.where(fo0 == b, lo, 0.0) + torch.where(fo1 == b, hi,
                                                               0.0)
            for tx in range(4):
                e_b = wxs[tx] * a_b
                for ty in range(4):
                    hist[:, ty, tx, b] = (wys[ty] * e_b).sum(dim=(1, 2))
        out[e] = hist
    return out.reshape(n, 128)


def _slot_inputs(name, field, *vecs):
    dev = _lib.check_cuda(name, field)
    conv = []
    for v, dt in vecs:
        conv.append(v.to(device=dev, dtype=dt).contiguous())
    return dev, conv


def ori_hist(field: torch.Tensor, x, y, lpos, sigma) -> torch.Tensor:
    """(n, 36) gradient-magnitude histograms of keypoints (x, y) at blur
    level lpos (s_orientation.cu:104-162)."""
    if field.dim() != 3 or field.shape[0] % 2 or field.dtype != torch.float32:
        raise ValueError("ori_hist takes a (2L, H, W) float32 field")
    if field.device.type == "cpu":
        return ori_hist_plain(field, x, y, lpos, sigma)
    dev, (x, y, lpos, sigma) = _slot_inputs(
        "ori_hist", field, (x, torch.float32), (y, torch.float32),
        (lpos, torch.int32), (sigma, torch.float32))
    n = int(x.shape[0])
    out = torch.empty((n, ORI_NBINS), dtype=torch.float32, device=dev)
    if n:
        L2, H, W = field.shape
        _lib.call("ori_hist", dev, field.data_ptr(), L2 // 2, H, W,
                  x.data_ptr(), y.data_ptr(), lpos.data_ptr(),
                  sigma.data_ptr(), n, out.data_ptr())
    return out


def desc_loop(field: torch.Tensor, x, y, lpos, sigma, ang,
              half: int) -> torch.Tensor:
    """(n, 128) unnormalised loop-mode descriptors in [ty][tx][bin] order
    (s_desc_loop.cu:18-139); ``half`` is half the static window."""
    if field.dim() != 3 or field.shape[0] % 2 or field.dtype != torch.float32:
        raise ValueError("desc_loop takes a (2L, H, W) float32 field")
    if field.device.type == "cpu":
        return desc_loop_plain(field, x, y, lpos, sigma, ang, half)
    dev, (x, y, lpos, sigma, ang) = _slot_inputs(
        "desc_loop", field, (x, torch.float32), (y, torch.float32),
        (lpos, torch.int32), (sigma, torch.float32), (ang, torch.float32))
    n = int(x.shape[0])
    out = torch.empty((n, 128), dtype=torch.float32, device=dev)
    if n:
        L2, H, W = field.shape
        _lib.call("desc_loop", dev, field.data_ptr(), L2 // 2, H, W,
                  x.data_ptr(), y.data_ptr(), lpos.data_ptr(),
                  sigma.data_ptr(), ang.data_ptr(), n, int(half),
                  out.data_ptr())
    return out
