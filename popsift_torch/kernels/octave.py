"""K7: the fused octave chain (csrc/octave.cu).

Replaces popsift_tpu/kernels/octave.py:octave_chain_fused.  From level 0
of an octave one launch writes every level of the incremental chain
(level l = the separable blur of level l-1 by ``filters[l]``, re-clamped
at the image edge), the L-1 DoG layers and the interleaved
``[mag; theta]`` field of K2's layout.  The plain version is the
per-level composition: K1's plain version per level, then K2's.

Outputs are exactly (., H, W); the JAX kernel's block-alignment surplus
is a TPU artefact and is not carried over.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _lib
from .blur import sep_blur_plain
from .grad import grad_field_plain

MAX_LEVELS = 16     # csrc/octave.cu kMaxLevels
MAX_SPAN = 32
# dynamic shared memory for the tile's two f32 buffers: the 232,448 bytes
# a block may use on the H100, less 4 KB for the kernel's static tables
SMEM_BYTES = 232448 - 4096
TILES = (64, 32, 16, 8)


def chain_halo(spans, emit_field: bool) -> int:
    """Rows/columns of level-0 context one output point needs: the sum of
    all incremental spans (each level consumes span-1 each side) plus one
    for the central-difference gradient (popsift_tpu octave.py:59-63)."""
    return sum(int(s) - 1 for s in spans) + (1 if emit_field else 0)


def octave_chain_ok(h: int, w: int, spans, emit_field: bool) -> bool:
    """The JAX package's eligibility rule (popsift_tpu octave.py:79-86),
    kept as it is so that the same octaves take the chain."""
    halo = chain_halo(spans, emit_field)
    return (halo <= 120 and h >= 32 and w >= 129
            and h * w >= (1 << 16))


def chain_tile(halo: int) -> int | None:
    """K7's output tile edge for a chain halo: the largest of TILES whose
    two f32 buffers of (P + 4) x P, P = tile + 2 halo, fit a block's
    shared memory, or None beyond a halo of 79 (no configuration with
    sigma <= 2 and up to 8 levels per octave needs more than 62)."""
    for t in TILES:
        p = t + 2 * halo
        if 2 * (p + 4) * p * 4 <= SMEM_BYTES:
            return t
    return None


def octave_chain_plain(lvl0: torch.Tensor, filters, spans,
                       emit_stack: bool, stack_levels=()):
    lvls = [lvl0]
    dogs = []
    for lvl in range(1, len(spans)):
        nxt, dog = sep_blur_plain(lvls[-1], filters[lvl], int(spans[lvl]),
                                  filters[lvl], int(spans[lvl]),
                                  with_dog=True)
        lvls.append(nxt)
        dogs.append(dog)
    stack = torch.stack(lvls)
    field = grad_field_plain(stack)
    if not emit_stack:
        stack = stack[list(stack_levels)]
    return stack, torch.stack(dogs), field


def octave_chain(lvl0: torch.Tensor, filters, spans, emit_stack: bool,
                 stack_levels=()):
    """Fused incremental octave chain from the (H, W) f32 level 0.

    filters / spans: per-level half-filters and spans (index 0 unused).
    emit_stack: write all L levels; otherwise only the one level in
    ``stack_levels`` (the next octave's downscale source).
    Returns (stack (L or 1, H, W), dogs (L-1, H, W), field (2L, H, W))."""
    spans = tuple(int(s) for s in spans)
    L = len(spans)
    if lvl0.dim() != 2 or lvl0.dtype != torch.float32:
        raise ValueError("octave_chain takes an (H, W) float32 level 0")
    if not emit_stack and len(stack_levels) != 1:
        raise ValueError("octave_chain keeps all levels or exactly one")
    if lvl0.device.type == "cpu":
        return octave_chain_plain(lvl0, filters, spans, emit_stack,
                                  stack_levels)

    if not 2 <= L <= MAX_LEVELS or not all(1 <= s <= MAX_SPAN
                                           for s in spans[1:]):
        raise ValueError(f"octave_chain takes 2..{MAX_LEVELS} levels with "
                         f"spans 1..{MAX_SPAN} ({spans})")
    tile = chain_tile(chain_halo(spans, True))
    if tile is None:
        raise ValueError(f"octave_chain: halo {chain_halo(spans, True)} "
                         f"does not fit shared memory")
    dev = _lib.check_cuda("octave_chain", lvl0)
    H, W = lvl0.shape
    keep = -1 if emit_stack else int(stack_levels[0])
    stack = torch.empty((L if emit_stack else 1, H, W), dtype=torch.float32,
                        device=dev)
    dogs = torch.empty((L - 1, H, W), dtype=torch.float32, device=dev)
    field = torch.empty((2 * L, H, W), dtype=torch.float32, device=dev)
    taps = np.zeros((L, MAX_SPAN), np.float32)
    for lvl in range(1, L):
        taps[lvl, :spans[lvl]] = np.asarray(filters[lvl],
                                            np.float32)[:spans[lvl]]
    spans_arr = np.asarray(spans, np.int32)
    _lib.call("octave_chain", dev, lvl0.data_ptr(), stack.data_ptr(),
              dogs.data_ptr(), field.data_ptr(), L, H, W, taps.ctypes.data,
              spans_arr.ctypes.data, tile, keep)
    return stack, dogs, field
