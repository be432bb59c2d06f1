"""K8: batched window gather with clamp addressing (csrc/windows.cu).

Replaces popsift_tpu/kernels/windows2.py:gather_windows_exact and
popsift_tpu/kernels/windows.py:gather_windows_aligned.  Both read
per-slot windows of an (L, H, W) plane; the JAX callers edge-pad the plane
first, and here every read clamps its coordinates to the plane instead,
which gives the same values without a padded copy.  The window shapes and
origins stay the JAX ones (rows from an 8-aligned origin, 128 columns),
because the descriptor arithmetic downstream works in window-local
coordinates and its rounding depends on them.
"""

from __future__ import annotations

import torch

from . import _lib

# A work item of the kernel: a band of ITEM_ROWS rows by a chunk of
# ITEM_COLS columns of one window (csrc/windows.cu: kRows, kChunk).
ITEM_ROWS, ITEM_COLS = 8, 128


def rolled_window_dims(win: int) -> tuple[int, int]:
    """(rows, cols) of an exact-origin window (windows2.py:27-29)."""
    if win > 120:
        raise ValueError("exact-origin windows require win <= 120")
    return -(-(win + 7) // 8) * 8, 128


def aligned_window_dims(win: int) -> tuple[int, int]:
    """(rows, cols) of an (8, 128)-aligned window (windows.py:31-39)."""
    return -(-(win + 7) // 8) * 8, -(-(win + 127) // 128) * 128


def gather_windows_plain(plane: torch.Tensor, lpos, ya, xa, wy: int,
                         wx: int) -> torch.Tensor:
    _, H, W = plane.shape
    dev = plane.device
    rows = (ya.to(torch.int64)[:, None]
            + torch.arange(wy, device=dev)).clamp_(0, H - 1)
    cols = (xa.to(torch.int64)[:, None]
            + torch.arange(wx, device=dev)).clamp_(0, W - 1)
    return plane[lpos.to(torch.int64)[:, None, None], rows[:, :, None],
                 cols[:, None, :]]


def gather_windows(plane: torch.Tensor, lpos, ya, xa, wy: int,
                   wx: int) -> torch.Tensor:
    """(n, wy, wx) windows of ``plane[lpos[i]]`` with top-left corners
    (ya[i], xa[i]); ``lpos`` must lie in 0..L-1."""
    if plane.dim() != 3 or plane.dtype != torch.float32:
        raise ValueError("gather_windows takes an (L, H, W) float32 plane")
    if plane.device.type == "cpu":
        return gather_windows_plain(plane, lpos, ya, xa, wy, wx)
    dev = _lib.check_cuda("gather_windows", plane)
    # no copy of origins that are contiguous int32 on the card already
    lpos, ya, xa = (v.to(device=dev, dtype=torch.int32).contiguous()
                    for v in (lpos, ya, xa))
    if lpos.dim() != 1 or ya.shape != lpos.shape or xa.shape != lpos.shape:
        raise ValueError("gather_windows takes three (n,) origin vectors")
    n = int(lpos.shape[0])
    out = torch.empty((n, wy, wx), dtype=torch.float32, device=dev)
    if n:
        _, H, W = plane.shape
        _lib.call("gather_windows", dev, plane.data_ptr(), H, W,
                  lpos.data_ptr(), ya.data_ptr(), xa.data_ptr(), n, wy, wx,
                  out.data_ptr())
    return out


def _floor_to(v: torch.Tensor, m: int) -> torch.Tensor:
    return torch.div(v, m, rounding_mode="floor") * m


def gather_windows_exact(plane: torch.Tensor, lpos, y0, x0, win: int):
    """(win_y, 128) windows whose column 0 is exactly x0 and whose rows
    start at the 8-aligned ya = 8 floor(y0 / 8).  Returns (windows, ya)."""
    wy, wx = rolled_window_dims(win)
    ya = _floor_to(y0.to(torch.int32), 8)
    return gather_windows(plane, lpos, ya, x0, wy, wx), ya


def window_origins(x, y, win: int):
    """The exact-origin window of a descriptor row at (x, y): column
    x0 = round(x) - win/2 and first row ya = 8 floor((round(y) - win/2) /
    8), both int32, as :func:`gather_windows_exact` places it for y0 =
    round(y) - win/2."""
    x0 = torch.round(x).to(torch.int32) - win // 2
    y0 = torch.round(y).to(torch.int32) - win // 2
    return x0, _floor_to(y0, 8)


def gather_windows_aligned(plane: torch.Tensor, lpos, y0, x0, win: int):
    """(win_y, 128 k) windows at (8, 128)-aligned origins.  Returns
    (windows, ya, xa)."""
    wy, wx = aligned_window_dims(win)
    ya = _floor_to(y0.to(torch.int32), 8)
    xa = _floor_to(x0.to(torch.int32), 128)
    return gather_windows(plane, lpos, ya, xa, wy, wx), ya, xa
