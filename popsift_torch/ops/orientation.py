"""Orientation assignment (popsift_tpu/ops/orientation.py).

36-bin gradient histograms per extremum (K5 from the gradient field, or
K10 from the blurred stack on the stack-kernel path), VLFeat smoothing,
quadratic peak refinement and the acceptance of up to 4 peaks of at least
0.8 of the highest (s_orientation.cu:75-259), all in one launch of K5 or
K10.  Their plain versions, the CPU path and the reference, live beside
the kernels (:mod:`popsift_torch.kernels.binwin`).
"""

from __future__ import annotations

import torch

from ..constants import ORI_WINFACTOR, ORIENTATION_MAX_COUNT
from ..kernels.binwin import ori_peaks, ori_peaks_stack


def max_sigma(sigma0: float, levels: int) -> float:
    """Worst-case extremum sigma: sn <= levels + 2 (s_extrema.cu:243)."""
    return sigma0 * 2.0 ** ((levels + 2) / levels)


def ori_window_size(sigma0: float, levels: int) -> int:
    """Static window covering radius round(4.5 * sigma_max), padded to a
    multiple of 8."""
    rad = int(round(3.0 * ORI_WINFACTOR * max_sigma(sigma0, levels)))
    return (2 * rad + 1 + 7) // 8 * 8


def assign_orientations(field, xpos, ypos, lpos, sigma, stack=None):
    """Up to 4 orientations per extremum: (num_ori (n,), angles (n, 4))
    in descending peak order.  The histograms come from the (2L, H, W)
    ``field`` (K5), or from the (L, H, W) ``stack`` (K10) when one is
    given (popsift_tpu ops/orientation.py:151-157); ``field`` may then be
    None.  The caller passes a stack only on the stack-kernel path."""
    use_stack = stack is not None
    src = stack if use_stack else field
    if xpos.shape[0] == 0:
        return (torch.zeros(0, dtype=torch.int32, device=src.device),
                torch.zeros((0, ORIENTATION_MAX_COUNT), dtype=torch.float32,
                            device=src.device))
    return (ori_peaks_stack if use_stack else ori_peaks)(src, xpos, ypos,
                                                         lpos, sigma)
