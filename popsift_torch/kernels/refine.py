"""K4: Newton refinement of extremum candidates (csrc/refine.cu).

Replaces popsift_tpu/kernels/refine.py:gather27 and
kernels/refine_batch.py:gather27_batch_pallas together with the loop of
ops/extrema.py:refine_extrema_multi that drives them: up to 5 iterations
of the closed-form 3x3 solve (s_solve.h:25-86) with the per-SiftMode step
rule (s_extrema.cu:145-298), then the move, verify, contrast and edge
tests.  :func:`refine_compact`, the extraction's entry, also compacts the
survivors in candidate order (ops/extrema.py:compact_extrema) and returns
an :class:`~popsift_torch.ops.extrema.Extrema`; :func:`refine` returns
the per-candidate ``(xn, yn, lpos, sigma, cell, ok)``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading

import numpy as np
import torch

from .. import tracing
from ..config import SiftMode
from ..ops.extrema import Candidates, Extrema, compact_extrema
from . import _lib

MAX_ITERATIONS = 5  # s_extrema.cu:362

_MODE_CODE = {SiftMode.POPSIFT: 0, SiftMode.OPENCV: 1, SiftMode.VLFEAT: 2}


@dataclasses.dataclass(frozen=True)
class RefineParams:
    """Scalars of one octave's refinement, rounded to float32 where the
    JAX package compares in float32."""

    sift_mode: SiftMode
    width: int
    height: int
    n_layers: int          # DoG layers (maxlevel)
    sigma0: float          # f32
    sigma_k: float         # f32
    contr_thr: float       # f32(2 * peak_threshold)
    edge_thr: float        # f32((r + 1)^2 / r)
    gwd: float             # f32 grid cell width
    ghd: float             # f32 grid cell height
    grid_width: int

    @property
    def hp(self) -> int:   # rows of the volume gather27 clamps into
        return max(-(-self.height // 8) * 8, 16)

    @property
    def wp(self) -> int:
        return max(-(-self.width // 128) * 128, 256)


@functools.lru_cache(maxsize=64)
def refine_params(sift_mode, width, height, n_layers, sigma0, sigma_k,
                  peak_threshold, edge_limit, grid_w_div, grid_h_div,
                  grid_width) -> RefineParams:
    f = lambda v: float(np.float32(v))  # noqa: E731
    r = edge_limit
    return RefineParams(
        sift_mode=sift_mode, width=int(width), height=int(height),
        n_layers=int(n_layers), sigma0=f(sigma0), sigma_k=f(sigma_k),
        contr_thr=f(2.0 * peak_threshold),
        edge_thr=f((r + 1.0) * (r + 1.0) / r),
        gwd=f(grid_w_div), ghd=f(grid_h_div), grid_width=int(grid_width))


def _solve3(A00, A01, A02, A11, A12, A22, bx, by, bz):
    """Closed-form symmetric 3x3 solve (s_solve.h:25-86); ok == det != 0."""
    det0 = A11 * A22 - A12 * A12
    det1 = A12 * A02 - A01 * A22
    det2 = A01 * A12 - A11 * A02
    det3 = A00 * A22 - A02 * A02
    det4 = A01 * A02 - A00 * A12
    det5 = A00 * A11 - A01 * A01
    det = A00 * det0 + A01 * det1 + A02 * det2
    ok = det != 0.0
    rsd = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    i00, i01, i02 = det0 * rsd, det1 * rsd, det2 * rsd
    i11, i12, i22 = det3 * rsd, det4 * rsd, det5 * rsd
    dx = i00 * bx + i01 * by + i02 * bz
    dy = i01 * bx + i11 * by + i12 * bz
    dz = i02 * bx + i12 * by + i22 * bz
    return ok, dx, dy, dz


def refine_plain(dog: torch.Tensor, cx, cy, cz, p: RefineParams,
                 return_iters: bool = False):
    """Vectorised over candidates; each slot stops changing once done or
    failed, exactly like the per-thread loop of the kernel."""
    L, H, W = dog.shape
    dev = dog.device
    n = cx.shape[0]
    flat = dog.reshape(-1)
    nx, ny, nz = cx.to(torch.int64), cy.to(torch.int64), cz.to(torch.int64)
    zero = torch.zeros(n, dtype=torch.float32, device=dev)
    st = {k: zero for k in ("v", "dx", "dy", "dz", "Dx", "Dy", "Dz", "DDx",
                            "DDy", "DDz", "DXx", "DXy", "DXz")}
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    failed = torch.zeros(n, dtype=torch.bool, device=dev)
    done_iter = torch.full((n,), MAX_ITERATIONS + 1, dtype=torch.int64,
                           device=dev)
    iters = torch.zeros(n, dtype=torch.int64, device=dev)
    r3 = torch.arange(-1, 2, device=dev)
    oz = r3.repeat_interleave(9)
    oy = r3.repeat_interleave(3).repeat(3)
    ox = r3.repeat(9)
    is_opencv = p.sift_mode == SiftMode.OPENCV
    is_vlfeat = p.sift_mode == SiftMode.VLFEAT
    width, height, maxlevel = p.width, p.height, p.n_layers

    for it in range(1, MAX_ITERATIONS + 1):
        active = ~done & ~failed
        if not bool(active.any()):
            break
        iters = iters + active.to(torch.int64)
        z = nz.clamp(1, L - 2)
        y = ny.clamp(1, p.hp - 2)
        x = nx.clamp(1, p.wp - 2)
        idx = ((z[:, None] + oz) * H
               + (y[:, None] + oy).clamp(max=H - 1)) * W \
            + (x[:, None] + ox).clamp(max=W - 1)
        win = flat[idx].reshape(n, 3, 3, 3)

        def P(a, b, c):
            return win[:, 1 + a, 1 + b, 1 + c]

        v = torch.where((it == 1) & active, P(0, 0, 0), st["v"])
        Dx = 0.5 * (P(0, 0, 1) - P(0, 0, -1))
        Dy = 0.5 * (P(0, 1, 0) - P(0, -1, 0))
        Dz = 0.5 * (P(1, 0, 0) - P(-1, 0, 0))
        c = P(0, 0, 0)
        DDx = P(0, 0, 1) + P(0, 0, -1) - 2.0 * c
        DDy = P(0, 1, 0) + P(0, -1, 0) - 2.0 * c
        DDz = P(1, 0, 0) + P(-1, 0, 0) - 2.0 * c
        DXx = 0.25 * (P(0, 1, 1) + P(0, -1, -1) - P(0, 1, -1) - P(0, -1, 1))
        DXy = 0.25 * (P(1, 0, 1) + P(-1, 0, -1) - P(1, 0, -1) - P(-1, 0, 1))
        DXz = 0.25 * (P(1, 1, 0) + P(-1, -1, 0) - P(1, -1, 0) - P(-1, 1, 0))

        ok, sx, sy, sz = _solve3(DDx, DXx, DXy, DDy, DXz, DDz, -Dx, -Dy, -Dz)
        dx = torch.where(ok, sx, 0.0)
        dy = torch.where(ok, sy, 0.0)
        dz = torch.where(ok, sz, 0.0)
        solve_break = ~ok
        last_it = it == MAX_ITERATIONS

        if is_opencv:
            conv = (dx.abs() < 0.5) & (dy.abs() < 0.5) & (dz.abs() < 0.5)
            mx = nx + torch.round(dx).to(torch.int64)
            my = ny + torch.round(dy).to(torch.int64)
            mz = nz + torch.round(dz).to(torch.int64)
            oob = (mx < 5) | (mx >= width - 5) | (my < 5) \
                | (my >= height - 5) | (mz < 1) | (mz > maxlevel - 2)
            new_done = conv | solve_break
            new_fail = ~solve_break & ~conv & oob
            move = ~conv & ~solve_break
            nx_n = torch.where(move, mx, nx)
            ny_n = torch.where(move, my, ny)
            nz_n = torch.where(move, mz, nz)
        else:
            one = torch.ones_like(nx)
            nil = torch.zeros_like(nx)
            tx = torch.where((dx >= 0.6) & (nx < width - 2), one, nil) \
                + torch.where((dx <= -0.6) & (nx > 1), -one, nil)
            ty = torch.where((dy >= 0.6) & (ny < height - 2), one, nil) \
                + torch.where((dy <= -0.6) & (ny > 1), -one, nil)
            if is_vlfeat:
                tz = nil
            else:
                tz = torch.where((dz >= 0.6) & (nz < maxlevel - 1), one, nil) \
                    + torch.where((dz <= -0.6) & (nz > 1), -one, nil)
            no_move = (tx == 0) & (ty == 0) & (tz == 0)
            new_done = solve_break | (no_move & (not last_it))
            new_fail = torch.zeros_like(no_move)
            move = ~solve_break & ~no_move & (not last_it)
            nx_n = torch.where(move, nx + tx, nx)
            ny_n = torch.where(move, ny + ty, ny)
            nz_n = torch.where(move, nz + tz, nz)

        def upd(old, new):
            return torch.where(active, new, old)

        nx, ny, nz = upd(nx, nx_n), upd(ny, ny_n), upd(nz, nz_n)
        new = dict(v=v, dx=dx, dy=dy, dz=dz, Dx=Dx, Dy=Dy, Dz=Dz, DDx=DDx,
                   DDy=DDy, DDz=DDz, DXx=DXx, DXy=DXy, DXz=DXz)
        st = {k: (new[k] if k == "v" else upd(st[k], new[k])) for k in st}
        done_iter = torch.where(active & new_done,
                                torch.full_like(done_iter, it), done_iter)
        done = done | (active & new_done)
        failed = failed | (active & new_fail)

    ok = ~failed
    if is_opencv:
        ok &= done_iter < MAX_ITERATIONS
    else:
        ok &= ~((st["dx"] >= 1.5) | (st["dy"] >= 1.5) | (st["dz"] >= 1.5))
    xn = nx.to(torch.float32) + st["dx"]
    yn = ny.to(torch.float32) + st["dy"]
    sn = nz.to(torch.float32) + st["dz"]
    if not is_opencv:
        ok &= ~((xn < 0.0) | (xn > float(width) - 1.0) | (yn < 0.0)
                | (yn > float(height) - 1.0) | (sn < 0.0)
                | (sn > float(maxlevel)))
    contr = st["v"] + 0.5 * (st["Dx"] * st["dx"] + st["Dy"] * st["dy"]
                             + st["Dz"] * st["dz"])
    tr = st["DDx"] + st["DDy"]
    det = st["DDx"] * st["DDy"] - st["DXx"] * st["DXx"]
    edgeval = tr * tr / torch.where(det == 0, 1.0, det)
    ok &= det > 0.0
    ok &= contr.abs() >= p.contr_thr
    ok &= edgeval < p.edge_thr

    lpos = torch.round(sn).to(torch.int32)
    sigk = torch.tensor(p.sigma_k, dtype=torch.float32, device=dev)
    sigma = p.sigma0 * torch.pow(sigk, sn)
    # divide by device tensors: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, the kernel divides
    gh = torch.tensor(p.ghd, dtype=torch.float32, device=dev)
    gw = torch.tensor(p.gwd, dtype=torch.float32, device=dev)
    cell = (torch.floor(yn / gh).to(torch.int32) * p.grid_width
            + torch.floor(xn / gw).to(torch.int32))
    out = (xn, yn, lpos, sigma, cell, ok)
    return out + (iters,) if return_iters else out


class _ParamsC(ctypes.Structure):
    """RefineParams as csrc/refine.cu's struct RefineParams lays it out."""

    _fields_ = [(k, ctypes.c_int) for k in ("H", "W", "Hp", "Wp",
                                            "n_layers", "mode")] \
        + [(k, ctypes.c_float) for k in ("sigma0", "sigma_k", "contr_thr",
                                         "edge_thr", "gwd", "ghd")] \
        + [("grid_width", ctypes.c_int)]


@functools.lru_cache(maxsize=64)
def _params_c(p: RefineParams) -> _ParamsC:
    return _ParamsC(p.height, p.width, p.hp, p.wp, p.n_layers,
                    _MODE_CODE[p.sift_mode], p.sigma0, p.sigma_k,
                    p.contr_thr, p.edge_thr, p.gwd, p.ghd, p.grid_width)


def _check_dog(name: str, dog: torch.Tensor, p: RefineParams) -> None:
    if dog.dim() != 3 or dog.dtype != torch.float32:
        raise ValueError(f"{name} takes an (L, H, W) float32 DoG")
    if tuple(dog.shape[1:]) != (p.height, p.width):
        raise ValueError(f"{name}: DoG dims differ from the parameters")


def refine(dog: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor,
           cz: torch.Tensor, p: RefineParams):
    """Refine candidates at integer (cx, cy, cz); cz is the DoG layer.
    Per candidate ``(xn, yn, lpos, sigma, cell, ok)``."""
    _check_dog("refine", dog, p)
    if dog.device.type == "cpu":
        return refine_plain(dog, cx, cy, cz, p)
    n = int(cx.shape[0])
    # the kernel takes compact_mask's (mask layer, y, x) rows
    zyx = torch.stack((cz - 1, cy, cx), dim=1).to(torch.int32).contiguous()
    dev = _lib.check_cuda("refine", dog, zyx)
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    xn, yn, sigma = (torch.empty(n, **f32) for _ in range(3))
    lpos, cell, ok = (torch.empty(n, **i32) for _ in range(3))
    if n:
        _lib.call("refine", dev, dog.data_ptr(), zyx.data_ptr(), n,
                  ctypes.addressof(_params_c(p)), xn.data_ptr(),
                  yn.data_ptr(), lpos.data_ptr(), sigma.data_ptr(),
                  cell.data_ptr(), ok.data_ptr())
    return xn, yn, lpos, sigma, cell, ok.to(torch.bool)


_status = threading.local()


def _status_buffer():
    """This thread's pinned int32 pair, to which refine_compact's kernel
    writes (count, overflow) through unified addressing, and a ctypes view
    of it."""
    buf = getattr(_status, "buf", None)
    if buf is None:
        t = torch.zeros(2, dtype=torch.int32, pin_memory=True)
        buf = _status.buf = (t, (ctypes.c_int * 2).from_address(t.data_ptr()))
    return buf


def refine_compact_plain(dog: torch.Tensor, cands: Candidates,
                         p: RefineParams, cap: int) -> Extrema:
    return compact_extrema(*refine_plain(dog, cands.x, cands.y,
                                         cands.z + 1, p), cap)


def refine_compact(dog: torch.Tensor, cands: Candidates, p: RefineParams,
                   cap: int) -> Extrema:
    """Refine ``cands`` (compact_mask's rows) and keep the survivors in
    candidate order, clamped at ``cap``: :func:`refine` and
    ops/extrema.py:compact_extrema in one call of two kernels, which
    returns when the count and overflow are on the host (the one
    synchronisation: the call, its two launches included, is a
    ``readback.refine_status`` host span when the recorder is on)."""
    _check_dog("refine", dog, p)
    if cap < 1:
        raise ValueError("refine_compact: cap must be at least 1")
    if dog.device.type == "cpu":
        return refine_compact_plain(dog, cands, p, cap)
    n = cands.count
    if n == 0:
        e = torch.empty(0, dtype=torch.float32, device=dog.device)
        i = torch.empty(0, dtype=torch.int32, device=dog.device)
        return Extrema(xpos=e, ypos=e, lpos=i, sigma=e, cell=i, count=0,
                       overflow=0)
    zyx = cands.zyx
    if zyx.dtype != torch.int32 or zyx.shape != (n, 3):
        raise ValueError("refine_compact takes (count, 3) int32 candidates")
    dev = _lib.check_cuda("refine", dog, zyx)
    _lib.library(dev)  # the card's checks come before the pinned buffer's
    m = min(n, cap)
    # outputs (5, m), then the kernels' scratch
    buf = torch.empty(5 * m + 6 * n + -(-n // 32), dtype=torch.int32,
                      device=dev)
    status, words = _status_buffer()
    sp = (tracing.begin("readback.refine_status") if tracing.HOSTTRACE
          else None)
    _lib.call("refine_compact", dev, dog.data_ptr(), zyx.data_ptr(), n,
              ctypes.addressof(_params_c(p)), cap, buf.data_ptr(),
              status.data_ptr(), count_as="refine")
    if sp is not None:
        tracing.end(sp)
    count, overflow = words
    ints = buf.as_strided((5, count), (m, 1))
    xpos, ypos, _, sigma, _ = ints.view(torch.float32).unbind(0)
    _, _, lpos, _, cell = ints.unbind(0)
    return Extrema(xpos=xpos, ypos=ypos, lpos=lpos, sigma=sigma, cell=cell,
                   count=count, overflow=overflow)
