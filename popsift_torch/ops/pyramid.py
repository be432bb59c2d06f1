"""Gaussian scale space + DoG + gradient field (popsift_tpu/ops/pyramid.py).

Per octave a (levels+3, H, W) stack of blurred levels, scaled to 0..255,
the (levels+2, H, W) DoG and the (2 (levels+3), H, W) gradient field.
Level 0 of octave 0 is the resampled input blurred with ``dd[0]``
horizontally, x255, and ``inc[0]`` vertically (K1); the level 0 of a later
octave picks every second pixel of level ``levels`` of the octave before.
Every further level blurs the previous one with ``inc[l]``: on octaves that
``octave_chain_ok`` admits, K7 computes all of them with the DoG and the
field in one launch; smaller octaves run K1 per level (each launch also
writes its DoG layer) and then K2.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SiftMode
from ..gauss import GaussInfo
from ..kernels.blur import sep_blur
from ..kernels.grad import grad_field
from ..kernels.octave import (chain_halo, chain_tile, octave_chain,
                              octave_chain_ok)

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


def octave_level0(src: torch.Tensor, octave: int, dims, gauss: GaussInfo,
                  sift_mode: SiftMode,
                  upscale_factor: float) -> torch.Tensor:
    """Level 0 of ``octave``: from the [0, 1] input image for octave 0,
    else from ``src``, level L-3 of the octave before (an (h, w) plane)."""
    w, h = dims[octave]
    if octave == 0:
        base = resample_input(src, h, w,
                              input_shift(sift_mode, upscale_factor, 0))
        return sep_blur(base.contiguous(), gauss.dd.filter[0],
                        gauss.dd.span[0], gauss.inc.filter[0],
                        gauss.inc.span[0], hscale=255.0)
    return downscale_by_2(src)[:h, :w].contiguous()


def chain_filters(gauss: GaussInfo, levels: int):
    """Per-level (filters, spans) of the incremental chain, index 0
    unused (popsift_tpu ops/pyramid.py:348-350)."""
    L = levels + 3
    spans = (1,) + tuple(int(gauss.inc.span[lvl]) for lvl in range(1, L))
    filters = ([np.ones(1, np.float32)]
               + [np.asarray(gauss.inc.filter[lvl]) for lvl in range(1, L)])
    return filters, spans


def chain_eligible(h: int, w: int, spans) -> bool:
    """Octaves that take K7: the JAX package's ``octave_chain_ok``, and a
    halo that K7's shared-memory tile holds (every configuration with
    sigma <= 2 and up to 8 levels does)."""
    return (octave_chain_ok(h, w, spans, emit_field=True)
            and chain_tile(chain_halo(spans, True)) is not None)


def per_level_chain(lvl0: torch.Tensor, levels: int, gauss: GaussInfo):
    """Levels 1..L-1 from level 0 with K1 per level.  Returns
    (stack (L, H, W), dog (L-1, H, W))."""
    h, w = lvl0.shape
    L = levels + 3
    stack = torch.empty((L, h, w), dtype=torch.float32, device=lvl0.device)
    dog = torch.empty((L - 1, h, w), dtype=torch.float32, device=lvl0.device)
    stack[0].copy_(lvl0)
    for lvl in range(1, L):
        sep_blur(stack[lvl - 1], gauss.inc.filter[lvl],
                 int(gauss.inc.span[lvl]), with_dog=True, out=stack[lvl],
                 dog_out=dog[lvl - 1])
    return stack, dog


def build_octave(src: torch.Tensor, octave: int, dims, levels: int,
                 gauss: GaussInfo, sift_mode: SiftMode,
                 upscale_factor: float):
    """One octave of the incremental chain in its per-level form.  ``src``
    is the [0, 1] input image for octave 0 and the previous octave's stack
    otherwise.  Returns (stack (L, H, W), dog (L-1, H, W))."""
    L = levels + 3
    prev = src if octave == 0 else src[L - PREV_LEVEL]
    lvl0 = octave_level0(prev, octave, dims, gauss, sift_mode,
                         upscale_factor)
    return per_level_chain(lvl0, levels, gauss)


def octave_outputs(src: torch.Tensor, octave: int, dims, levels: int,
                   gauss: GaussInfo, sift_mode: SiftMode,
                   upscale_factor: float, full_stack: bool,
                   need_field: bool = True):
    """Scale space, DoG and gradient field of one octave, the counterpart
    of one octave of popsift_tpu's ``build_pyramid_dogs_fields``.  ``src``
    is the [0, 1] input image for octave 0 and level L-3 of the octave
    before otherwise.  Returns (stack, down, dog, field): ``stack`` is
    None on a chain octave when ``full_stack`` is False (the loop
    descriptors never read it), and ``down`` is level L-3, the next
    octave's source.  A chain octave always has K7's field; a per-level
    octave has K2's only with ``need_field`` (nothing reads it on the
    stack-kernel path), and None otherwise."""
    w, h = dims[octave]
    L = levels + 3
    lvl0 = octave_level0(src, octave, dims, gauss, sift_mode,
                         upscale_factor)
    filters, spans = chain_filters(gauss, levels)
    if chain_eligible(h, w, spans):
        stack, dog, field = octave_chain(lvl0, filters, spans,
                                         emit_stack=full_stack,
                                         stack_levels=(L - PREV_LEVEL,))
        if full_stack:
            return stack, stack[L - PREV_LEVEL], dog, field
        return None, stack[0], dog, field
    stack, dog = per_level_chain(lvl0, levels, gauss)
    field = grad_field(stack) if need_field else None
    return stack, stack[L - PREV_LEVEL], dog, field
