"""K1: separable Gaussian blur (csrc/blur.cu).

Replaces popsift_tpu/kernels/blur.py:sep_blur_fused and
sep_blur_fused_with_dog.  ``out = blur_v(hscale * blur_h(img))`` with
clamp addressing, optionally with the DoG layer ``out - img``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _lib


def _clamped_index(n: int, pad: int, device) -> torch.Tensor:
    return torch.arange(-pad, n + pad, device=device).clamp_(0, n - 1)


def blur_1d(img: torch.Tensor, half_taps, span: int,
            dim: int) -> torch.Tensor:
    """Shift-and-add blur along ``dim`` (-1 horizontal, -2 vertical) with
    edge ("clamp") padding: centre tap first, then ``(l + r) * t[off]``
    for rising ``off`` (ops/pyramid.py:blur_1d of the JAX package)."""
    span = int(span)
    taps = [float(t) for t in np.asarray(half_taps, np.float32)[:max(span, 1)]]
    if span <= 1:
        return img * taps[0]
    pad = span - 1
    size = img.shape[dim]
    padded = img.index_select(dim, _clamped_index(size, pad, img.device))

    def sl(off: int) -> torch.Tensor:
        return padded.narrow(dim, pad + off, size)

    out = sl(0) * taps[0]
    for off in range(1, span):
        out = out + (sl(-off) + sl(off)) * taps[off]
    return out


def sep_blur_plain(img, taps_h, span_h, taps_v, span_v, hscale=1.0,
                   with_dog=False):
    out = blur_1d(img, taps_h, span_h, -1)
    if hscale != 1.0:
        out = out * float(hscale)
    out = blur_1d(out, taps_v, span_v, -2)
    return (out, out - img) if with_dog else out


def sep_blur(img: torch.Tensor, taps_h, span_h: int, taps_v=None,
             span_v: int | None = None, hscale: float = 1.0,
             with_dog: bool = False, out: torch.Tensor | None = None,
             dog_out: torch.Tensor | None = None):
    """Blur an (H, W) f32 image; returns ``out`` or ``(out, dog)``.

    ``out`` / ``dog_out`` may name preallocated (H, W) tensors (views of
    an octave stack) to write into."""
    if taps_v is None:
        taps_v, span_v = taps_h, span_h
    span_h, span_v = int(span_h), int(span_v)
    if img.dim() != 2 or img.dtype != torch.float32:
        raise ValueError("sep_blur takes an (H, W) float32 tensor")
    if img.device.type == "cpu":
        res = sep_blur_plain(img, taps_h, span_h, taps_v, span_v, hscale,
                             with_dog)
        o, d = res if with_dog else (res, None)
        if out is not None:
            o = out.copy_(o)
        if d is not None and dog_out is not None:
            d = dog_out.copy_(d)
        return (o, d) if with_dog else o

    if not 1 <= span_h <= 32 or not 1 <= span_v <= 32:
        raise ValueError(f"sep_blur spans must be 1..32 ({span_h}, {span_v})")
    H, W = img.shape
    o = torch.empty_like(img) if out is None else out
    d = None
    if with_dog:
        d = torch.empty_like(img) if dog_out is None else dog_out
    dev = _lib.check_cuda("sep_blur", img, o, *([d] if with_dog else []))
    tmp = torch.empty_like(img)
    th = np.ascontiguousarray(np.asarray(taps_h, np.float32)[:span_h])
    tv = np.ascontiguousarray(np.asarray(taps_v, np.float32)[:span_v])
    _lib.call("sep_blur", dev, img.data_ptr(), tmp.data_ptr(),
              o.data_ptr(), d.data_ptr() if with_dog else None, H, W,
              th.ctypes.data, span_h, tv.ctypes.data, span_v, float(hscale))
    return (o, d) if with_dog else o
