"""Gaussian scale space + DoG (popsift_tpu/ops/pyramid.py).

Per octave a (levels+3, H, W) stack of blurred levels, scaled to 0..255,
and the (levels+2, H, W) DoG.  Level 0 of octave 0 is the resampled input
blurred with ``dd[0]`` horizontally, x255, and ``inc[0]`` vertically; the
level 0 of a later octave picks every second pixel of level ``levels`` of
the octave before; every further level blurs the previous one with
``inc[l]``, and the same kernel launch writes its DoG layer.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SiftMode
from ..gauss import GaussInfo
from ..kernels.blur import sep_blur

PREV_LEVEL = 3  # s_pyramid_build.cu:22


def _shifted(arr: torch.Tensor, delta: int, dim: int) -> torch.Tensor:
    """``arr`` shifted by +-1 along ``dim`` with clamp addressing."""
    n = arr.shape[dim]
    if delta > 0:
        return torch.cat([arr.narrow(dim, 1, n - 1),
                          arr.narrow(dim, n - 1, 1)], dim=dim)
    return torch.cat([arr.narrow(dim, 0, 1), arr.narrow(dim, 0, n - 1)],
                     dim=dim)


def _upsample2_1d(arr: torch.Tensor, shift: float, dim: int) -> torch.Tensor:
    """2x bilinear upscale: destination x samples the source at
    (x + shift) / 2 - 0.5, i.e. even outputs at k + (shift-1)/2 and odd
    outputs at k + shift/2, each a blend with the clamped neighbour."""
    dim = dim % arr.dim()

    def blend(frac: float) -> torch.Tensor:
        if frac >= 0.0:
            return arr * (1.0 - frac) + _shifted(arr, +1, dim) * frac
        return arr * (1.0 + frac) + _shifted(arr, -1, dim) * (-frac)

    even = blend((shift - 1.0) / 2.0)
    odd = blend(shift / 2.0)
    out = torch.stack([even, odd], dim=dim + 1)
    shape = list(arr.shape)
    shape[dim] *= 2
    return out.reshape(shape)


def _resample_1d(arr: torch.Tensor, dst_size: int, src_size: int,
                 shift: float, dim: int) -> torch.Tensor:
    """Bilinear resample along one axis: destination x samples the source
    at (x + shift) * src/dst - 0.5 with clamp addressing
    (s_pyramid_build_ra.cu:37-38)."""
    if dst_size == 2 * src_size:
        return _upsample2_1d(arr, shift, dim)
    pos = (np.arange(dst_size, dtype=np.float64) + shift) \
        * (src_size / dst_size) - 0.5
    i0 = np.clip(np.floor(pos).astype(np.int64), 0, src_size - 1)
    i1 = np.clip(i0 + 1, 0, src_size - 1)
    w = np.clip(pos - np.floor(pos), 0.0, 1.0).astype(np.float32)
    dev = arr.device
    a = arr.index_select(dim, torch.as_tensor(i0, device=dev))
    b = arr.index_select(dim, torch.as_tensor(i1, device=dev))
    shape = [1] * arr.dim()
    shape[dim] = dst_size
    wt = torch.as_tensor(w, device=dev).reshape(shape)
    return a * (1.0 - wt) + b * wt


def resample_input(image: torch.Tensor, dst_h: int, dst_w: int,
                   shift: float) -> torch.Tensor:
    src_h, src_w = image.shape
    out = _resample_1d(image, dst_h, src_h, shift, dim=0)
    return _resample_1d(out, dst_w, src_w, shift, dim=1)


def downscale_by_2(level: torch.Tensor) -> torch.Tensor:
    """get_by_2_pick_every_second (s_pyramid_build.cu:50-71)."""
    return level[..., ::2, ::2]


def input_shift(sift_mode: SiftMode, upscale_factor: float,
                octave: int) -> float:
    """Sub-pixel shift when reading the input (s_pyramid_build.cu:110-114)."""
    if octave == 0 and sift_mode in (SiftMode.POPSIFT, SiftMode.VLFEAT):
        return 0.5 * (2.0 ** (upscale_factor - octave))
    return 0.5


def build_octave(src: torch.Tensor, octave: int, dims, levels: int,
                 gauss: GaussInfo, sift_mode: SiftMode,
                 upscale_factor: float):
    """One octave of the incremental chain.  ``src`` is the [0, 1] input
    image for octave 0 and the previous octave's stack otherwise.
    Returns (stack (L, H, W), dog (L-1, H, W))."""
    w, h = dims[octave]
    L = levels + 3
    stack = torch.empty((L, h, w), dtype=torch.float32, device=src.device)
    dog = torch.empty((L - 1, h, w), dtype=torch.float32, device=src.device)
    if octave == 0:
        base = resample_input(src, h, w,
                              input_shift(sift_mode, upscale_factor, 0))
        sep_blur(base.contiguous(), gauss.dd.filter[0], gauss.dd.span[0],
                 gauss.inc.filter[0], gauss.inc.span[0], hscale=255.0,
                 out=stack[0])
    else:
        stack[0].copy_(downscale_by_2(src[L - PREV_LEVEL])[:h, :w])
    for lvl in range(1, L):
        sep_blur(stack[lvl - 1], gauss.inc.filter[lvl],
                 int(gauss.inc.span[lvl]), with_dog=True, out=stack[lvl],
                 dog_out=dog[lvl - 1])
    return stack, dog

