"""Brute-force descriptor matching (popsift_tpu/ops/match.py).

The reference scans every right descriptor per left descriptor and keeps
the running best pair (features.cu:165-304); the JAX package, and this
module, compute the squared L2 distance matrix as |l|^2 + |r|^2 - 2 l.r^T
with one matrix product and pick the best and second best per row, with
Lowe's ratio test at 0.8 (features.cu:225).

The product is ``torch.mm``: the JAX package computes it as a plain
``jnp.dot`` outside any Pallas kernel.  It must be IEEE float32.  With
TF32 enabled for cuBLAS (``torch.backends.cuda.matmul.allow_tf32``,
``torch.set_float32_matmul_precision("high")`` or
``torch.backends.cuda.matmul.fp32_precision = "tf32"``) the card would
round the inputs to a 10-bit mantissa, which moves distance ratios near
0.8 and so the ratio test.  :func:`match_brute_force` therefore turns TF32
off for the dispatch of its product and puts the caller's setting back
after it (:func:`ieee_float32_matmul`).  The setting is process-wide and
read when a product is dispatched, so the change is made under a module
lock: concurrent matches (the pipeline's workers) serialise only that
dispatch, and none restores the setting in the middle of another's.  A
product that another thread dispatches in that window runs in IEEE
float32 too.  CPU products are left as the caller set them.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_precision_lock = threading.Lock()


@contextlib.contextmanager
def ieee_float32_matmul():
    """cuBLAS float32 products in IEEE float32 (TF32 off) for the block,
    and the process's setting as it was after it.  The flag is set through
    the API the process uses: PyTorch raises when the legacy getter
    (``allow_tf32``) is read after ``fp32_precision`` was set."""
    mm = torch.backends.cuda.matmul
    with _precision_lock:
        try:
            old, off = mm.allow_tf32, False
            attr = "allow_tf32"
        except RuntimeError:
            old, off = mm.fp32_precision, "ieee"
            attr = "fp32_precision"
        if old == off:
            yield
            return
        setattr(mm, attr, off)
        try:
            yield
        finally:
            setattr(mm, attr, old)


def match_brute_force(l_desc: torch.Tensor, r_desc: torch.Tensor,
                      l_valid: torch.Tensor | None = None,
                      r_valid: torch.Tensor | None = None,
                      ratio: float = 0.8):
    """Match every left descriptor (N, D) against all right descriptors
    (M, D), both float32 on one device.

    Returns (best_idx, second_idx, accept, best_dist, second_dist) on that
    device: int32, int32, bool and two float32 (N,) tensors of squared
    distances.  ``accept`` is the ratio test best / second < ``ratio``,
    and False where ``l_valid`` is.  Right columns with ``r_valid`` False
    are at infinite distance.  With M = 1 the second distance is inf and
    a row is accepted; with every right column invalid the ratio is NaN
    and no row is.  M = 0 raises, as the JAX function does."""
    if l_desc.ndim != 2 or r_desc.ndim != 2 \
            or l_desc.shape[1] != r_desc.shape[1]:
        raise ValueError(f"match_brute_force: descriptors of shapes "
                         f"{tuple(l_desc.shape)} and {tuple(r_desc.shape)}")
    if l_desc.device != r_desc.device:
        raise ValueError("match_brute_force: both descriptor sets must be "
                         "on one device")
    n, m = l_desc.shape[0], r_desc.shape[0]
    if m == 0:
        raise ValueError("match_brute_force: no right descriptor (argmin "
                         "of an empty sequence)")
    l_desc = l_desc.to(torch.float32)
    r_desc = r_desc.to(torch.float32)
    ln = torch.sum(l_desc * l_desc, dim=-1, keepdim=True)      # (N, 1)
    rn = torch.sum(r_desc * r_desc, dim=-1)[None, :]           # (1, M)
    with ieee_float32_matmul():
        cross = torch.mm(l_desc, r_desc.t())                   # (N, M)
    d2 = torch.clamp_min(ln + rn - 2.0 * cross, 0.0)
    inf = float("inf")
    if r_valid is not None:
        d2 = torch.where(r_valid.to(torch.bool)[None, :], d2, inf)

    # best and second best (the reference's running pair,
    # features.cu:199-221); argmin keeps the first index on ties, on the
    # card too, as the sequential scan does
    best_idx = torch.argmin(d2, dim=-1)
    best = torch.take_along_dim(d2, best_idx[:, None], dim=-1)[:, 0]
    masked = d2.clone()
    masked[torch.arange(n, device=d2.device), best_idx] = inf
    second_idx = torch.argmin(masked, dim=-1)
    second = torch.take_along_dim(masked, second_idx[:, None], dim=-1)[:, 0]

    accept = best / second < ratio
    if l_valid is not None:
        accept = accept & l_valid.to(torch.bool)
    return (best_idx.to(torch.int32), second_idx.to(torch.int32), accept,
            best, second)
