"""K3: dense DoG extremum mask (csrc/detect.cu).

Replaces popsift_tpu/kernels/detect.py:detect_pallas and
detect_packed_pallas.  From the (levels+2, H, W) DoG it writes a
(levels, H, W) uint8 mask whose layer z is DoG layer z+1: a value strictly
greater (or strictly smaller) than its 26 neighbours, passing the SiftMode
contrast gate, outside the border (s_extrema.cu:56-120, 506-517).

The kernel's warps each own a strip of :data:`STRIP` output columns (2 a
lane in lanes 1-30; lanes 0 and 31 load the halo columns) over a segment
of rows and a group of up to :data:`GROUP` mask layers
(:func:`detect_plan`), and slide down the segment, reading every DoG
plane of the group once.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SiftMode
from . import _lib

COLS = 2             # columns of a lane (csrc/detect.cu kCols)
STRIP = 30 * COLS    # output columns of a warp (kStrip)
GROUP = 3            # the most mask layers of a warp (kGroup)
SEG_ROWS = (2, 16)   # the least and most rows of a larger plane's segment
SMALL_PLANE = 1 << 15
WARPS_WANTED = 132 * 32   # twice the warps that fit the H100's SMs at once


def detect_plan(levels: int, H: int, W: int) -> tuple[int, int]:
    """(rows of a warp's segment, mask layers of a warp).  A plane of at
    most SMALL_PLANE pixels cannot fill the card: one row and one layer a
    warp keep each warp's serial work shortest.  A larger one takes GROUP
    layers a warp, each DoG plane then read once, in segments short
    enough that the launch has WARPS_WANTED warps and long enough that the
    two rows each reads above its first output row stay cheap."""
    if H * W <= SMALL_PLANE:
        return 1, 1
    warps = -(-W // STRIP) * -(-levels // GROUP)
    seg = -(-H * warps // WARPS_WANTED)
    return max(SEG_ROWS[0], min(SEG_ROWS[1], seg)), GROUP


def gate_for(sift_mode: SiftMode, peak_threshold: float):
    """(gate, border) of first_contrast_ok (s_extrema.cu:150-153,
    200-204, 252-256), the gate rounded to float32 as the JAX package
    computes it."""
    t = np.float32(peak_threshold)
    if sift_mode == SiftMode.OPENCV:
        return float(np.floor(t)), 5
    if sift_mode == SiftMode.VLFEAT:
        return float(np.float32(0.8 * 2.0) * t), 1
    return float(np.float32(1.6) * t), 1


def detect_plain(dog: torch.Tensor, gate: float, border: int) -> torch.Tensor:
    L, h, w = dog.shape
    levels = L - 2
    mask = torch.zeros((levels, h, w), dtype=torch.uint8, device=dog.device)
    if h < 3 or w < 3:
        return mask
    hi, wi = h - 2, w - 2
    center = dog[1:levels + 1, 1:1 + hi, 1:1 + wi]
    nb_max = nb_min = None
    for dz in (-1, 0, 1):
        for dy in (0, 1, 2):
            for dx in (0, 1, 2):
                if dz == 0 and dy == 1 and dx == 1:
                    continue
                nb = dog[1 + dz:levels + 1 + dz, dy:dy + hi, dx:dx + wi]
                nb_max = nb if nb_max is None else torch.maximum(nb_max, nb)
                nb_min = nb if nb_min is None else torch.minimum(nb_min, nb)
    inner = ((center > nb_max) | (center < nb_min)) \
        & (center.abs() >= gate)
    mask[:, 1:1 + hi, 1:1 + wi] = inner.to(torch.uint8)
    if border > 1:
        b = border
        mask[:, :b] = 0
        mask[:, h - b:] = 0
        mask[:, :, :b] = 0
        mask[:, :, w - b:] = 0
    return mask


def detect(dog: torch.Tensor, sift_mode: SiftMode,
           peak_threshold: float) -> torch.Tensor:
    if dog.dim() != 3 or dog.dtype != torch.float32 or dog.shape[0] < 3:
        raise ValueError("detect takes a (levels+2, H, W) float32 DoG")
    gate, border = gate_for(sift_mode, peak_threshold)
    if dog.device.type == "cpu":
        return detect_plain(dog, gate, border)
    dev = _lib.check_cuda("detect", dog)
    L, H, W = dog.shape
    mask = torch.empty((L - 2, H, W), dtype=torch.uint8, device=dev)
    seg, group = detect_plan(L - 2, H, W)
    _lib.call("detect", dev, dog.data_ptr(), mask.data_ptr(), L - 2, H, W,
              gate, border, seg, group)
    return mask
