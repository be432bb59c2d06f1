"""The plain reference of the brute-force matcher (popsift_torch's
``FeaturesDev.match``, features.cu:165-304): for every left descriptor
the nearest and second nearest right descriptor by squared L2 distance,
first index on ties, and Lowe's ratio test best / second < ratio."""

from __future__ import annotations

import numpy as np
import torch


def distances(left: np.ndarray, right: np.ndarray, device="cuda",
              dtype=torch.float64, tf32: bool = False) -> torch.Tensor:
    """(N, M) squared distances |l|^2 + |r|^2 - 2 l.r^T, clamped at 0."""
    l_t = torch.as_tensor(left, device=device).to(dtype)
    r_t = torch.as_tensor(right, device=device).to(dtype)
    mm = torch.backends.cuda.matmul
    old = mm.allow_tf32
    mm.allow_tf32 = tf32
    try:
        cross = torch.mm(l_t, r_t.t())
    finally:
        mm.allow_tf32 = old
    ln = (l_t * l_t).sum(dim=-1, keepdim=True)
    rn = (r_t * r_t).sum(dim=-1)[None, :]
    return torch.clamp_min(ln + rn - 2.0 * cross, 0.0)


def match(left: np.ndarray, right: np.ndarray, ratio: float = 0.8,
          device="cuda", dtype=torch.float64, tf32: bool = False):
    """(best, second, accept, best_dist, second_dist) as numpy arrays."""
    d2 = distances(left, right, device, dtype, tf32)
    n = d2.shape[0]
    best_idx = torch.argmin(d2, dim=-1)
    best = d2[torch.arange(n, device=d2.device), best_idx]
    masked = d2.clone()
    masked[torch.arange(n, device=d2.device), best_idx] = float("inf")
    second_idx = torch.argmin(masked, dim=-1)
    second = masked[torch.arange(n, device=d2.device), second_idx]
    accept = best / second < ratio
    return tuple(t.cpu().numpy() for t in (best_idx.to(torch.int32),
                                           second_idx.to(torch.int32),
                                           accept, best, second))
