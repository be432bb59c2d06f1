"""K5 / K10: orientation histograms, and K6 / K11: loop-mode descriptors
(csrc/binwin.cu).  K5 and K6 read the interleaved gradient field; K10 and
K11 compute each pixel's gradient from the blurred stack inside the
kernel, as the reference does (s_gradiant.h:55-69).

Replace popsift_tpu/kernels/binwin.py:ori_hist_fused, desc_loop_fused,
ori_hist_stack_pallas and desc_loop_stack_pallas.  The plain versions
gather one square window per slot and bin it with masked sums, the
formulation of the JAX package's ops/orientation.py:_histograms and
ops/descriptors.py:loop_descriptors; pixels outside a slot's support add
exactly zero there as in the kernels.  The stack variants' plain versions
take the window's gradient from the stack with K2's expressions, so on the
same stack they give the field variants' numbers.  Slots go through in
chunks of similar radius, so that each chunk's window is cut to its own
largest radius.
"""

from __future__ import annotations

import math
import os

import torch

from ..constants import DESC_MAGNIFY, M_4RPI, M_PI2, ORI_NBINS, \
    ORI_WINFACTOR
from . import _lib

_CHUNK = 256


def _chunks(radius: torch.Tensor) -> list[torch.Tensor]:
    """Slot indices in chunks of _CHUNK, in order of window radius."""
    order = torch.argsort(radius, stable=True)
    return [order[s:s + _CHUNK] for s in range(0, order.numel(), _CHUNK)]


def stack_kernels_enabled() -> bool:
    """Whether orientation and loop descriptors take K10 and K11 from the
    blurred stack.  ``POPSIFT_TPU_STACK_KERNELS``, read at each call, with
    the JAX package's rule (popsift_tpu/kernels/binwin.py:632): unset,
    "" and "0" mean off, so one setting picks the same path in both
    packages.  The switch is the whole gate: the JAX gate's shape limits
    (W >= 384, H >= win rows + 16, win <= 112) come from its 384-lane slab
    DMA, while K10 and K11 read their support directly and take every
    octave."""
    return os.environ.get("POPSIFT_TPU_STACK_KERNELS", "") not in ("", "0")


def _offsets(rx, ry, R, device):
    offs = torch.arange(-R, R + 1, device=device)
    return rx[:, None] + offs, ry[:, None] + offs


def _field_windows(field, lp, rx, ry, R):
    """(n, S, S) mag and theta windows of the (2L, H, W) field centred at
    (rx, ry), S = 2R+1, read with clamped coordinates, plus the unclamped
    coordinates."""
    _, H, W = field.shape
    jj, ii = _offsets(rx, ry, R, field.device)
    base = (2 * lp)[:, None, None] * H + ii.clamp(0, H - 1)[:, :, None]
    idx = base * W + jj.clamp(0, W - 1)[:, None, :]
    flat = field.reshape(-1)
    return flat[idx], flat[idx + H * W], jj, ii


def _stack_windows(stack, lp, rx, ry, R):
    """The same windows with the gradient taken from the (L, H, W) stack:
    K2's central differences, sqrt and atan2 (ops/gradients.py) at the
    clamped coordinates; outside the 1-pixel interior the values differ
    from the field's, and every caller masks them out."""
    _, H, W = stack.shape
    jj, ii = _offsets(rx, ry, R, stack.device)
    x = jj.clamp(0, W - 1)[:, None, :]
    y = ii.clamp(0, H - 1)[:, :, None]
    row = lp[:, None, None] * H
    flat = stack.reshape(-1)

    def at(yy, xx):
        return flat[(row + yy) * W + xx]

    dx = at(y, (x + 1).clamp(max=W - 1)) - at(y, (x - 1).clamp(min=0))
    dy = at((y + 1).clamp(max=H - 1), x) - at((y - 1).clamp(min=0), x)
    return torch.sqrt(dx * dx + dy * dy), torch.atan2(dy, dx), jj, ii


def _ori_hist(windows, levels, H, W, x, y, lpos, sigma) -> torch.Tensor:
    """(n, 36) histograms; ``windows(lp, rx, ry, R)`` gives each slot's
    (mag, theta) window and its coordinates (:func:`_field_windows`)."""
    n = x.shape[0]
    out = torch.zeros((n, ORI_NBINS), dtype=torch.float32, device=x.device)
    pi2 = torch.tensor(M_PI2, dtype=torch.float32, device=x.device)
    radius = torch.round(3.0 * (ORI_WINFACTOR * sigma)).to(torch.int64)
    for e in _chunks(radius):
        xs, ys, sg, rad = x[e], y[e], sigma[e], radius[e]
        lp = lpos[e].to(torch.int64).clamp(0, levels - 1)
        rx = torch.round(xs).to(torch.int64)
        ry = torch.round(ys).to(torch.int64)
        R = max(int(rad.max()), 0)
        mw, tw, jj, ii = windows(lp, rx, ry, R)
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


def ori_hist_plain(field, x, y, lpos, sigma) -> torch.Tensor:
    L2, H, W = field.shape
    return _ori_hist(lambda *a: _field_windows(field, *a), L2 // 2, H, W, x,
                     y, lpos, sigma)


def ori_hist_stack_plain(stack, x, y, lpos, sigma) -> torch.Tensor:
    L, H, W = stack.shape
    return _ori_hist(lambda *a: _stack_windows(stack, *a), L, H, W, x, y,
                     lpos, sigma)


def desc_support(sigma: torch.Tensor, half: int) -> torch.Tensor:
    """Per-slot half-width R of the box that covers the descriptor's
    support |u|_inf < 2.5 (SBP units), at most the static window's half."""
    sbp = torch.abs(DESC_MAGNIFY * sigma)
    return ((3.5355339 * sbp).to(torch.int64) + 2).clamp(max=half)


def _desc_loop(windows, levels, H, W, x, y, lpos, sigma, ang, half: int):
    """(n, 128) descriptors from the windows of :func:`_ori_hist`."""
    n = x.shape[0]
    out = torch.zeros((n, 4, 4, 8), dtype=torch.float32, device=x.device)
    support = desc_support(sigma, half)
    for e in _chunks(support):
        xs, ys, sg, a = x[e], y[e], sigma[e], ang[e]
        lp = lpos[e].to(torch.int64).clamp(0, levels - 1)
        rx = torch.round(xs).to(torch.int64)
        ry = torch.round(ys).to(torch.int64)
        R = int(support[e].max())
        mw, tw, jj, ii = windows(lp, rx, ry, R)
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
                           device=x.device)
        for b in range(8):
            a_b = torch.where(fo0 == b, lo, 0.0) + torch.where(fo1 == b, hi,
                                                               0.0)
            for tx in range(4):
                e_b = wxs[tx] * a_b
                for ty in range(4):
                    hist[:, ty, tx, b] = (wys[ty] * e_b).sum(dim=(1, 2))
        out[e] = hist
    return out.reshape(n, 128)


def desc_loop_plain(field, x, y, lpos, sigma, ang, half: int):
    L2, H, W = field.shape
    return _desc_loop(lambda *a: _field_windows(field, *a), L2 // 2, H, W,
                      x, y, lpos, sigma, ang, half)


def desc_loop_stack_plain(stack, x, y, lpos, sigma, ang, half: int):
    L, H, W = stack.shape
    return _desc_loop(lambda *a: _stack_windows(stack, *a), L, H, W, x, y,
                      lpos, sigma, ang, half)


def _slot_inputs(name, field, *vecs):
    dev = _lib.check_cuda(name, field)
    conv = []
    for v, dt in vecs:
        conv.append(v.to(device=dev, dtype=dt).contiguous())
    return dev, conv


def _check_source(name: str, src: torch.Tensor, stack: bool) -> None:
    if src.dim() != 3 or src.dtype != torch.float32 \
            or (not stack and src.shape[0] % 2):
        raise ValueError(f"{name} takes a "
                         f"{'(L, H, W)' if stack else '(2L, H, W)'} float32 "
                         f"{'stack' if stack else 'field'}")


def _ori_hist_call(name, src, levels, x, y, lpos, sigma) -> torch.Tensor:
    dev, (x, y, lpos, sigma) = _slot_inputs(
        name, src, (x, torch.float32), (y, torch.float32),
        (lpos, torch.int32), (sigma, torch.float32))
    n = int(x.shape[0])
    out = torch.empty((n, ORI_NBINS), dtype=torch.float32, device=dev)
    if n:
        _, H, W = src.shape
        _lib.call(name, dev, src.data_ptr(), levels, H, W, x.data_ptr(),
                  y.data_ptr(), lpos.data_ptr(), sigma.data_ptr(), n,
                  out.data_ptr())
    return out


def _desc_loop_call(name, src, levels, x, y, lpos, sigma, ang,
                    half) -> torch.Tensor:
    dev, (x, y, lpos, sigma, ang) = _slot_inputs(
        name, src, (x, torch.float32), (y, torch.float32),
        (lpos, torch.int32), (sigma, torch.float32), (ang, torch.float32))
    n = int(x.shape[0])
    out = torch.empty((n, 128), dtype=torch.float32, device=dev)
    if n:
        _, H, W = src.shape
        _lib.call(name, dev, src.data_ptr(), levels, H, W, x.data_ptr(),
                  y.data_ptr(), lpos.data_ptr(), sigma.data_ptr(),
                  ang.data_ptr(), n, int(half), out.data_ptr())
    return out


def ori_hist(field: torch.Tensor, x, y, lpos, sigma) -> torch.Tensor:
    """(n, 36) gradient-magnitude histograms of keypoints (x, y) at blur
    level lpos (s_orientation.cu:104-162), from the (2L, H, W) field."""
    _check_source("ori_hist", field, stack=False)
    if field.device.type == "cpu":
        return ori_hist_plain(field, x, y, lpos, sigma)
    return _ori_hist_call("ori_hist", field, field.shape[0] // 2, x, y, lpos,
                          sigma)


def ori_hist_stack(stack: torch.Tensor, x, y, lpos, sigma) -> torch.Tensor:
    """:func:`ori_hist` from the (L, H, W) blurred stack (K10)."""
    _check_source("ori_hist_stack", stack, stack=True)
    if stack.device.type == "cpu":
        return ori_hist_stack_plain(stack, x, y, lpos, sigma)
    return _ori_hist_call("ori_hist_stack", stack, stack.shape[0], x, y,
                          lpos, sigma)


def desc_loop(field: torch.Tensor, x, y, lpos, sigma, ang,
              half: int) -> torch.Tensor:
    """(n, 128) unnormalised loop-mode descriptors in [ty][tx][bin] order
    (s_desc_loop.cu:18-139) from the (2L, H, W) field; ``half`` is half
    the static window."""
    _check_source("desc_loop", field, stack=False)
    if field.device.type == "cpu":
        return desc_loop_plain(field, x, y, lpos, sigma, ang, half)
    return _desc_loop_call("desc_loop", field, field.shape[0] // 2, x, y,
                           lpos, sigma, ang, half)


def desc_loop_stack(stack: torch.Tensor, x, y, lpos, sigma, ang,
                    half: int) -> torch.Tensor:
    """:func:`desc_loop` from the (L, H, W) blurred stack (K11)."""
    _check_source("desc_loop_stack", stack, stack=True)
    if stack.device.type == "cpu":
        return desc_loop_stack_plain(stack, x, y, lpos, sigma, ang, half)
    return _desc_loop_call("desc_loop_stack", stack, stack.shape[0], x, y,
                           lpos, sigma, ang, half)
