"""K2: interleaved gradient field (csrc/grad.cu).

Replaces popsift_tpu/kernels/grad.py:gradient_field_fused.  From an
(L, H, W) blurred stack it writes (2L, H, W) with ``field[2l] = mag_l``
and ``field[2l+1] = theta_l``: central differences with clamp borders,
``mag = sqrt(dx*dx + dy*dy)``, ``theta = atan2(dy, dx)``.
"""

from __future__ import annotations

import torch

from ..ops.gradients import gradient_fields, interleave_field
from . import _lib


def grad_field_plain(stack: torch.Tensor) -> torch.Tensor:
    return interleave_field(*gradient_fields(stack))


def grad_field(stack: torch.Tensor) -> torch.Tensor:
    if stack.dim() != 3 or stack.dtype != torch.float32:
        raise ValueError("grad_field takes an (L, H, W) float32 tensor")
    if stack.device.type == "cpu":
        return grad_field_plain(stack)
    dev = _lib.check_cuda("grad_field", stack)
    L, H, W = stack.shape
    field = torch.empty((2 * L, H, W), dtype=torch.float32, device=dev)
    _lib.call("grad_field", dev, stack.data_ptr(), field.data_ptr(), L, H, W)
    return field
