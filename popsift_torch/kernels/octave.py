"""K7: the fused octave chain (csrc/octave.cu).

Replaces popsift_tpu/kernels/octave.py:octave_chain_fused.  From level 0
of an octave one launch writes every level of the incremental chain
(level l = the separable blur of level l-1 by ``filters[l]``, re-clamped
at the image edge), the L-1 DoG layers and the interleaved
``[mag; theta]`` field of K2's layout.  The plain version is the
per-level composition: K1's plain version per level, then K2's.

Outputs are exactly (., H, W); the JAX kernel's block-alignment surplus
is a TPU artefact and is not carried over.  The kernel's blocks are
strips of output columns cut into segments of rows, each sliding down its
segment with a ring of rows per level in shared memory; :func:`chain_plan`
sizes them and :func:`chain_layout` gives the rings.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from . import _lib
from .blur import sep_blur_plain
from .grad import grad_field_plain

MAX_LEVELS = 16     # csrc/octave.cu kMaxLevels
MAX_SPAN = 32
ROWS = 8            # csrc/octave.cu kRows: rows a block advances per step
COLS = 8            # kCols: outputs of a horizontal-pass item
STRIPS = tuple(range(128, 31, -8))   # the strips the planner weighs
# shared memory: what a block may use on the H100, less 4 KB for the
# kernel's static shared memory (its ring slots)
SMEM_BYTES = 232448 - 4096
SMS = 132           # the H100's SMs; one K7 block of 512 threads fits each
MIN_SEGMENT = 64    # fewer rows per segment pay too much vertical halo
FILL = 0.95         # the share of the SMs a plan's one wave should fill


class ChainPlan(NamedTuple):
    strip: int      # output columns per block
    seg: int        # output rows per block
    smem: int       # dynamic shared memory per block, bytes


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


def chain_halos(spans) -> list[int]:
    """Per level, the rows/columns beyond a block's outputs that the later
    levels and the gradient consume: 1 for the last level, and level l-1
    needs span_l - 1 more than level l."""
    halos = [1] * len(spans)
    for lvl in range(len(spans) - 1, 0, -1):
        halos[lvl - 1] = halos[lvl] + int(spans[lvl]) - 1
    return halos


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def chain_leads(spans) -> list[int]:
    """Rows level l runs ahead of a K7 block's base row: its halo, plus
    ROWS for each level after it (each level takes the rows the level
    before produced one step earlier)."""
    L = len(spans)
    return [h + ROWS * (L - 1 - lvl)
            for lvl, h in enumerate(chain_halos(spans))]


def chain_layout(spans, strip: int) -> list[dict]:
    """K7's shared-memory rings for a strip width, level by level, as
    csrc/octave.cu:layout lays them out: ``ring`` (pitch, depth) holds the
    level's own rows, ``hring`` (levels >= 1) the horizontal blur of the
    level before, the vertical pass's window, which also has a table of
    ``hring[1]`` row offsets after the rings.  Pitches are in floats."""
    spans = [int(s) for s in spans]
    halos = chain_halos(spans)
    L = len(spans)
    out = []
    for lvl in range(L):
        w = strip + 2 * halos[lvl]
        entry = {"width": w}
        if lvl > 0:
            entry["hring"] = (COLS * -(-w // COLS),
                              2 * spans[lvl] - 2 + ROWS)
        pitch, depth = _round4(w), 2 * ROWS + 2
        if lvl + 1 < L:
            s = spans[lvl + 1]
            wn = w - 2 * (s - 1)
            pitch = max(pitch, COLS * (-(-wn // COLS) - 1)
                        + _round4(COLS + 2 * s - 2))
            depth = 2 * ROWS + max(2, s - 1)
        entry["ring"] = (pitch, depth)
        out.append(entry)
    return out


def chain_smem(spans, strip: int) -> int:
    """Dynamic shared memory of one K7 block, bytes: the rings, then the
    window tables (an int per row of each horizontal ring)."""
    lay = chain_layout(spans, strip)
    return 4 * (sum(p * d for e in lay for p, d in
                    [e["ring"]] + ([e["hring"]] if "hring" in e else []))
                + sum(e["hring"][1] for e in lay[1:]))


def chain_plan(h: int, w: int, spans) -> ChainPlan | None:
    """K7's blocks for an (h, w) octave.  Each strip's rows are cut into
    as many segments of at least MIN_SEGMENT rows as the SMs left over by
    the strips hold.  The plan is the widest strip of STRIPS whose rings
    fit shared memory and whose one wave of blocks fills FILL of the SMs,
    else the one with the most blocks (on the H100 a narrower strip's extra
    halo columns cost less than idle SMs, and a wider strip's fewer halo
    columns more than the last twentieth of the SMs).  None when the spans
    exceed the kernel's limits, octave_chain_ok's halo limit, or shared
    memory."""
    return _chain_plan(int(h), int(w), tuple(int(s) for s in spans))


@functools.lru_cache(maxsize=256)
def _chain_plan(h: int, w: int, spans: tuple):
    """:func:`chain_plan`, cached per shape and spans (a plan is made for
    every launch)."""
    if (not 2 <= len(spans) <= MAX_LEVELS
            or not all(1 <= s <= MAX_SPAN for s in spans[1:])
            or chain_halo(spans, True) > 120):
        return None
    best = None
    for cand in STRIPS:
        smem = chain_smem(spans, cand)
        if smem > SMEM_BYTES:
            continue
        strips = -(-w // cand)
        nseg = max(1, min(SMS // strips, h // MIN_SEGMENT))
        seg = ROWS * -(-(-(-h // nseg)) // ROWS)
        blocks = strips * -(-h // seg)
        plan = ChainPlan(cand, seg, smem)
        if blocks >= FILL * SMS:
            return plan
        if best is None or blocks > best[0]:
            best = (blocks, plan)
    return None if best is None else best[1]


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
    H, W = lvl0.shape
    plan = chain_plan(H, W, spans)
    if plan is None:
        raise ValueError(f"octave_chain: halo {chain_halo(spans, True)} "
                         f"does not fit shared memory")
    dev = _lib.check_cuda("octave_chain", lvl0)
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
              spans_arr.ctypes.data, plan.strip, plan.seg, plan.smem, keep)
    return stack, dogs, field
