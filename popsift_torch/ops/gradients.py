"""Dense gradient fields in plain PyTorch (popsift_tpu/ops/gradients.py).

Layout: interleaved along the leading axis, ``field[2l] = mag_l`` and
``field[2l+1] = theta_l``, unpadded (2L, H, W).  K2
(:mod:`popsift_torch.kernels.grad`) writes that field in one launch; these
functions are its plain version.
"""

from __future__ import annotations

import torch


def gradient_fields(stack: torch.Tensor):
    """Per-level (mag, theta), each (L, H, W): central differences with
    clamp borders (s_gradiant.h:55-69), ``mag = sqrt(dx*dx + dy*dy)``,
    ``theta = atan2(dy, dx)``."""
    _, H, W = stack.shape
    dev = stack.device
    xi = torch.arange(W, device=dev)
    yi = torch.arange(H, device=dev)
    xp, xm = xi.add(1).clamp_(max=W - 1), xi.sub(1).clamp_(min=0)
    yp, ym = yi.add(1).clamp_(max=H - 1), yi.sub(1).clamp_(min=0)
    dx = stack[:, :, xp] - stack[:, :, xm]
    dy = stack[:, yp, :] - stack[:, ym, :]
    return torch.sqrt(dx * dx + dy * dy), torch.atan2(dy, dx)


def interleave_field(mag: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """(L, H, W) x2 -> (2L, H, W) with mag_l at 2l, theta_l at 2l+1."""
    L, H, W = mag.shape
    return torch.stack([mag, theta], dim=1).reshape(2 * L, H, W)
