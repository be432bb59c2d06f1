"""Orientation assignment (popsift_tpu/ops/orientation.py).

36-bin gradient histograms per extremum (K5 from the gradient field, or
K10 from the blurred stack on the stack-kernel path), VLFeat smoothing,
quadratic peak refinement and the acceptance of up to 4 peaks of at least
0.8 of the highest (s_orientation.cu:75-259).
"""

from __future__ import annotations

import math

import torch

from ..constants import M_PI2, ORI_NBINS, ORI_WINFACTOR, \
    ORIENTATION_MAX_COUNT
from ..kernels.binwin import ori_hist, ori_hist_stack


def max_sigma(sigma0: float, levels: int) -> float:
    """Worst-case extremum sigma: sn <= levels + 2 (s_extrema.cu:243)."""
    return sigma0 * 2.0 ** ((levels + 2) / levels)


def ori_window_size(sigma0: float, levels: int) -> int:
    """Static window covering radius round(4.5 * sigma_max), padded to a
    multiple of 8."""
    rad = int(round(3.0 * ORI_WINFACTOR * max_sigma(sigma0, levels)))
    return (2 * rad + 1 + 7) // 8 * 8


def smooth_histogram_vlfeat(hist: torch.Tensor) -> torch.Tensor:
    """Six circular 3-bin box averages (s_orientation.cu:165-178)."""
    for _ in range(6):
        hist = (torch.roll(hist, 1, dims=-1) + hist
                + torch.roll(hist, -1, dims=-1)) / 3.0
    return hist


def peak_candidates(hist: torch.Tensor):
    """Smoothing + quadratic peak refinement (s_orientation.cu:165-221):
    per bin the refined peak position (-1 where there is no peak) and the
    interpolated peak height (-inf there)."""
    sm = smooth_histogram_vlfeat(hist)
    prev = torch.roll(sm, 1, dims=-1)
    nxt = torch.roll(sm, -1, dims=-1)
    is_peak = sm > torch.maximum(prev, nxt)
    num = torch.where(is_peak, 3.0 * prev - 4.0 * sm + 1.0 * nxt, 0.0)
    den = torch.where(is_peak, 2.0 * (prev - 2.0 * sm + nxt), 1.0)
    newbin = num / den
    pred = is_peak & (newbin >= 0.0) & (newbin <= 2.0)
    bins = torch.arange(ORI_NBINS, dtype=torch.float32, device=hist.device)
    prev_idx = torch.where(bins == 0, ORI_NBINS - 1.0, bins - 1.0)
    refined = torch.where(pred, prev_idx + newbin, -1.0)
    yval = torch.where(pred, -(num * num) / (4.0 * den) + prev,
                       -math.inf)
    return refined, yval


def peaks_from_hist(hist: torch.Tensor,
                    max_count: int = ORIENTATION_MAX_COUNT):
    """Top-k acceptance of the refined peaks (s_orientation.cu:222-258):
    up to ``max_count`` peaks of at least 0.8 of the highest.  Peaks are
    ranked by a stable descending sort, so equal heights keep the lower
    bin first as lax.top_k does."""
    refined, yval = peak_candidates(hist)
    top_val, top_idx = torch.sort(yval, dim=-1, descending=True,
                                  stable=True)
    top_val = top_val[:, :max_count]
    top_idx = top_idx[:, :max_count]
    best = top_val[:, :1]
    accept = (top_val >= 0.8 * best) & torch.isfinite(top_val)
    chosen = torch.gather(refined, 1, top_idx)
    chosen = torch.where(chosen >= ORI_NBINS, chosen - ORI_NBINS, chosen)
    th = M_PI2 * chosen / ORI_NBINS - math.pi
    num_ori = accept.sum(dim=-1).to(torch.int32)
    return num_ori, torch.where(accept, th, 0.0)


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
    hist = (ori_hist_stack if use_stack else ori_hist)(src, xpos, ypos, lpos,
                                                       sigma)
    return peaks_from_hist(hist)
