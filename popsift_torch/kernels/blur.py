"""K1: separable Gaussian blur (csrc/blur.cu).

Replaces popsift_tpu/kernels/blur.py:sep_blur_fused and
sep_blur_fused_with_dog.  ``out = blur_v(hscale * blur_h(img))`` with
clamp addressing, optionally with the DoG layer ``out - img``.

:func:`sep_blur` blurs one plane (a block per tile of :data:`TILE`), and
:func:`blur_chain` computes every level of a small octave from its level
0 in one launch: one cluster of blocks, each keeping a band of rows of the
level and of its horizontal pass in its shared memory (:func:`chain_bands`)
and copying its halo rows of that pass from its neighbours.  With
``emit_field`` the same launch then writes the octave's gradient field
from the stack it wrote, bit-equal to K2's
(:mod:`popsift_torch.kernels.grad`) on the same stack.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _lib
from .grad import grad_field_plain

MAX_SPAN = 32
MAX_LEVELS = 16          # csrc/blur.cu kMaxLevels
# sep_blur: output rows of a vertical item, and the output rows and
# columns of a block's tile (csrc/blur.cu kVRows, kTileRows, kTileCols)
VROWS, TILE = 8, (64, 128)
# blur_chain: output rows of a vertical item, and the rows of a block's
# band it aims at (kChainVRows, kChainBand); the shared memory a chain
# block may use (kChainSmem)
CHAIN_VROWS, CHAIN_BAND = 2, 4
CHAIN_SMEM = 232448 - 1024
MAX_CLUSTER = 16         # blocks of the chain entry's cluster
# blur_chain takes octaves of at most this many pixels (the size below
# which the JAX package's octave_chain_ok refuses the fused chain) whose
# bands fit a block's shared memory (chain_fits)
CHAIN_MAX_PIXELS = 1 << 16


def halo_class(span: int) -> int:
    """The halo class P of csrc/blur.cu: the smallest of 4, 8, 16, 32 that
    holds span - 1 (the columns each side a tile reads, and the unrolled
    length of the tap loops)."""
    need = int(span) - 1
    return next(p for p in (4, 8, 16, 32) if need <= p)


def chain_bands(h: int) -> tuple[int, int]:
    """(blocks, rows) of the chain entry (csrc/blur.cu chain_bands): the
    least power of two up to MAX_CLUSTER blocks that gives each at most
    CHAIN_BAND rows, and the rows of each block's band (the last band may
    hold fewer)."""
    want = -(-h // CHAIN_BAND)
    blocks = 1
    while blocks < want and blocks < MAX_CLUSTER:
        blocks *= 2
    return blocks, -(-h // blocks)


def chain_smem(h: int, w: int, spans) -> int:
    """Bytes of a chain block's shared memory (csrc/blur.cu
    chain_smem_floats): its band of the current and the next level, and
    two buffers of the horizontal pass of its band with P rows above and
    P + CHAIN_VROWS below."""
    rows = chain_bands(h)[1]
    p = halo_class(max(int(s) for s in spans[1:]))
    return 4 * (2 * rows * w + 2 * (rows + 2 * p + CHAIN_VROWS) * w)


def chain_fits(h: int, w: int, spans) -> bool:
    return (h * w <= CHAIN_MAX_PIXELS
            and chain_smem(h, w, spans) <= CHAIN_SMEM)


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


@functools.lru_cache(maxsize=256)
def _host_taps(raw: bytes):
    """A ctypes float array of the taps, kept for the process."""
    return (ctypes.c_float * (len(raw) // 4)).from_buffer_copy(raw)


def _taps(taps, span: int):
    return _host_taps(np.asarray(taps, np.float32)[:span].tobytes())


@functools.lru_cache(maxsize=64)
def _host_chain(raw: bytes, spans: tuple):
    """The chain entry's (levels x 32) taps (``raw``: each level's
    ``spans[l]`` taps end to end from level 1) and per-level spans as
    ctypes arrays, kept for the process."""
    table = np.zeros((len(spans), MAX_SPAN), np.float32)
    flat = np.frombuffer(raw, np.float32)
    at = 0
    for lvl in range(1, len(spans)):
        table[lvl, :spans[lvl]] = flat[at:at + spans[lvl]]
        at += spans[lvl]
    taps = (ctypes.c_float * table.size).from_buffer_copy(table.tobytes())
    return taps, (ctypes.c_int * len(spans))(*spans)


def _check_spans(name: str, *spans: int) -> None:
    if not all(1 <= s <= MAX_SPAN for s in spans):
        raise ValueError(f"{name} spans must be 1..{MAX_SPAN} ({spans})")


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

    _check_spans("sep_blur", span_h, span_v)
    H, W = img.shape
    o = torch.empty_like(img) if out is None else out
    d = None
    if with_dog:
        d = torch.empty_like(img) if dog_out is None else dog_out
    dev = _lib.check_cuda("sep_blur", img, o, *([d] if with_dog else []))
    _lib.call("sep_blur", dev, img.data_ptr(), o.data_ptr(),
              d.data_ptr() if with_dog else None, H, W,
              _taps(taps_h, span_h), span_h, _taps(taps_v, span_v), span_v,
              float(hscale))
    return (o, d) if with_dog else o


def _chain_outputs(lvl0: torch.Tensor, levels: int):
    h, w = lvl0.shape
    stack = torch.empty((levels, h, w), dtype=torch.float32,
                        device=lvl0.device)
    dog = torch.empty((levels - 1, h, w), dtype=torch.float32,
                      device=lvl0.device)
    stack[0].copy_(lvl0)
    return stack, dog


def blur_chain_plain(lvl0: torch.Tensor, filters, spans,
                     emit_field: bool = False):
    """Levels 1..L-1 from level 0, each the separable blur of the level
    before by ``filters[l]`` (``spans[l]`` taps, both directions), with
    the L-1 DoG layers: K1's plain version per level.  Index 0 of
    ``filters`` and ``spans`` is unused.  Returns (stack (L, H, W),
    dog (L-1, H, W)), and with ``emit_field`` K2's plain field of the
    stack (2L, H, W) as well."""
    stack, dog = _chain_outputs(lvl0, len(spans))
    for lvl in range(1, len(spans)):
        s = int(spans[lvl])
        stack[lvl], dog[lvl - 1] = sep_blur_plain(
            stack[lvl - 1], filters[lvl], s, filters[lvl], s, with_dog=True)
    if emit_field:
        return stack, dog, grad_field_plain(stack)
    return stack, dog


def blur_chain(lvl0: torch.Tensor, filters, spans,
               emit_field: bool = False):
    """:func:`blur_chain_plain` in one launch of K1's chain entry, for an
    octave that :func:`chain_fits`."""
    if lvl0.dim() != 2 or lvl0.dtype != torch.float32:
        raise ValueError("blur_chain takes an (H, W) float32 level 0")
    L = len(spans)
    if not 2 <= L <= MAX_LEVELS:
        raise ValueError(f"blur_chain takes 2..{MAX_LEVELS} levels ({L})")
    if lvl0.device.type == "cpu":
        return blur_chain_plain(lvl0, filters, spans, emit_field)
    spans = tuple(int(s) for s in spans)
    _check_spans("blur_chain", *spans[1:])
    h, w = lvl0.shape
    if not chain_fits(h, w, spans):
        raise ValueError(f"blur_chain takes at most {CHAIN_MAX_PIXELS} "
                         f"pixels whose bands fit {CHAIN_SMEM} bytes "
                         f"({h}x{w}, spans {spans})")
    stack, dog = _chain_outputs(lvl0, L)
    field = (torch.empty((2 * L, h, w), dtype=torch.float32,
                         device=lvl0.device) if emit_field else None)
    dev = _lib.check_cuda("blur_chain", stack, dog,
                          *([field] if emit_field else []))
    raw = b"".join(np.asarray(filters[lvl], np.float32)[:spans[lvl]]
                   .tobytes() for lvl in range(1, L))
    taps, host_spans = _host_chain(raw, (1,) + spans[1:])
    _lib.call("blur_chain", dev, stack.data_ptr(), dog.data_ptr(),
              field.data_ptr() if emit_field else None, L, h, w, taps,
              host_spans)
    return (stack, dog, field) if emit_field else (stack, dog)
