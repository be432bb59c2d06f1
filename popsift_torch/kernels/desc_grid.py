"""K9: NoTile/IGrid, K12: Grid and K13: ILoop descriptors, each read from
the blurred stack through K8's window of the row (csrc/desc_grid.cu).

The JAX package computes these steps as XLA (ops/descriptors.py:
grid_descriptors_windowed, grid_rounded_descriptors_windowed and
iloop_descriptors_windowed, and their matmul forms ``..._mm``); the
reference runs them as CUDA kernels (s_desc_notile.cu:31-129,
s_desc_grid.cu:18-121, s_desc_iloop.cu:18-130).  The plain versions here
are the arithmetic of the JAX gather forms, batched over the slots.

* NoTile/IGrid: the rotated 40x40 sample grid, bilinear samples inside
  each slot's (win_y, 128) window in window-local coordinates, the rotated
  gradient, the Gaussian weight, two orientation bins and the two tile
  contractions.
* Grid (:func:`grid_rounded_body`): per tile a rotated 16x16 grid rounded
  to pixels, weights recomputed there, integer central differences.
* ILoop (:func:`iloop_body`): per tile an axis-aligned 32x32 grid over the
  rotated tile's bounding box, bilinear rotated-derivative gradients.

The two bodies take a sampler, so the whole-plane forms in
ops/descriptors.py run the same arithmetic on the octave's plane.  K9, K12
and K13 (:func:`desc_grid_stack`, :func:`desc_grid_rounded_stack`,
:func:`desc_iloop_stack`) read K8's window of each row straight from the
(L, H, W) stack, only over the row's footprint (:func:`footprint_box`);
their plain versions are K8's plain gather followed by the window forms
(:func:`desc_grid_plain`, :func:`desc_grid_rounded_plain`,
:func:`desc_iloop_plain`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import DESC_MAGNIFY, M_4RPI, M_PI2
from . import _lib
from .windows import gather_windows_plain, rolled_window_dims, window_origins

_CHUNK = 256
# rows per plain-version chunk of the Grid (4096 samples a row) and ILoop
# (16384 samples a row) forms
CHUNK_GRID = 64
CHUNK_ILOOP = 16
# floats of shared memory a K9/K12/K13 block stages a row's footprint in
# (32 KB: boxes up to 90 x 90, sbp ~ 11 at 45 degrees); a row whose box
# holds more reads its taps from the stack through L2
STAGE_FLOATS = 8192


def _grid_steps() -> np.ndarray:
    """40 sample offsets: stepbase + k/8, stepbase = -2.5 + 1/16
    (s_desc_notile.cu:29,57-58)."""
    return (-2.5 + 1.0 / 16.0
            + np.arange(40, dtype=np.float32) / 8.0)


def _tile_weight_matrix(desc_tile: torch.Tensor) -> torch.Tensor:
    """(40, 4) matrix: TX[k, t] = desc_tile[k - 8t] when 0 <= k - 8t < 16
    (s_desc_notile.cu:55)."""
    TX = torch.zeros((40, 4), dtype=torch.float32, device=desc_tile.device)
    for t in range(4):
        TX[8 * t:8 * t + 16, t] = desc_tile
    return TX


def grid_points(x, y, sigma, ang):
    """The rotated 40x40 sample grid of each slot: (px, py) (n, 40, 40)
    in the octave's coordinates, cos and sin of the angle (n, 1, 1) and
    ``ok`` (n, 1, 1), the scale gate."""
    steps = torch.as_tensor(_grid_steps(), device=x.device)
    sbp = torch.abs(DESC_MAGNIFY * sigma)[:, None, None]
    cos_t = torch.cos(ang)[:, None, None]
    sin_t = torch.sin(ang)[:, None, None]
    sx = steps[None, None, :]
    sy = steps[None, :, None]
    ptx = cos_t * sx - sin_t * sy
    pty = cos_t * sy + sin_t * sx
    px = x[:, None, None] + ptx * sbp
    py = y[:, None, None] + pty * sbp
    return px, py, cos_t, sin_t, sbp > 0.0


def grid_histograms(dx, dy, ok, desc_gauss, desc_tile) -> torch.Tensor:
    """(n, 128) descriptors in [ty][tx][bin] order from the rotated
    gradient (dx, dy) of every sample (n, 40, 40)."""
    mod = torch.hypot(dx, dy)
    th = torch.atan2(dy, dx)
    th = torch.where(th < 0.0, th + M_PI2, th)
    tth = th * M_4RPI
    fo = torch.floor(tth).to(torch.int32)
    do0 = tth - fo.to(torch.float32)
    fo0 = fo & 7
    fo1 = (fo0 + 1) & 7
    ww = torch.where(ok, desc_gauss * mod, 0.0)
    bins = torch.arange(8, dtype=torch.int32, device=dx.device)
    A = ((fo0[..., None] == bins) * ((1.0 - do0) * ww)[..., None]
         + (fo1[..., None] == bins) * (do0 * ww)[..., None])
    TX = _tile_weight_matrix(desc_tile)
    B = torch.einsum("nyxb,xt->nytb", A, TX)
    D = torch.einsum("nytb,ys->nstb", B, TX)
    return D.reshape(-1, 128)


def _bilinear_win(wflat, px, py, win_y: int, xlo, xhi, ylo, yhi):
    """Bilinear samples inside each slot's flattened (win_y, 128) window
    (ops/descriptors.py:_bilinear_win of the JAX package): the coordinate
    is clamped to the image bounds in window-local terms, the tap indices
    to the window."""
    n = px.shape[0]
    px = torch.minimum(torch.maximum(px, xlo), xhi)
    py = torch.minimum(torch.maximum(py, ylo), yhi)
    x0f = torch.floor(px)
    y0f = torch.floor(py)
    fx = px - x0f
    fy = py - y0f
    x0 = x0f.to(torch.int64).clamp_(0, 126)
    y0 = y0f.to(torch.int64).clamp_(0, win_y - 2)
    base = (y0 * 128 + x0).reshape(n, -1)

    def tap(off):
        return torch.gather(wflat, 1, base + off).reshape(px.shape)

    v00, v01, v10, v11 = tap(0), tap(1), tap(128), tap(129)
    return ((v00 * (1 - fx) + v01 * fx) * (1 - fy)
            + (v10 * (1 - fx) + v11 * fx) * fy)


def desc_grid_plain(wins, x, y, x0f, y0f, sigma, ang, w: int, h: int,
                    desc_gauss, desc_tile) -> torch.Tensor:
    n, win_y, _ = wins.shape
    out = torch.empty((n, 128), dtype=torch.float32, device=wins.device)
    for s in range(0, n, _CHUNK):
        e = slice(s, s + _CHUNK)
        px, py, cos_t, sin_t, ok = grid_points(x[e], y[e], sigma[e], ang[e])
        ox = x0f[e][:, None, None]
        oy = y0f[e][:, None, None]
        pxr = px - ox
        pyr = py - oy
        lims = (0.0 - ox, (w - 1.0) - ox, 0.0 - oy, (h - 1.0) - oy)
        wflat = wins[e].reshape(px.shape[0], -1)

        def bw(ppx, ppy):
            return _bilinear_win(wflat, ppx, ppy, win_y, *lims)

        dx = bw(pxr + cos_t, pyr + sin_t) - bw(pxr - cos_t, pyr - sin_t)
        dy = bw(pxr - sin_t, pyr + cos_t) - bw(pxr + sin_t, pyr - cos_t)
        out[e] = grid_histograms(dx, dy, ok, desc_gauss, desc_tile)
    return out


def _tile_centres(n_like: torch.Tensor):
    """(1, 16, 1) tile-centre offsets ix - 1.5, iy - 1.5 of tile
    t = 4 iy + ix (s_desc_loop.cu:57-58), the [ty][tx] output order."""
    offs = torch.arange(4, dtype=torch.float32, device=n_like.device) - 1.5
    return offs.repeat(4)[None, :, None], offs.repeat_interleave(4)[None, :,
                                                                    None]


def _wrap_2pi(th: torch.Tensor) -> torch.Tensor:
    th = torch.where(th < 0.0, th + M_PI2, th)
    return torch.where(th >= M_PI2, th - M_PI2, th)


def tile_bins(th: torch.Tensor, wgt: torch.Tensor) -> torch.Tensor:
    """(n, 128) per-tile sums of every sample's two orientation bins from
    th in [0, 2 pi) and the sample weight, both (n, 16, samples)."""
    tth = th * M_4RPI
    fo = torch.floor(tth)
    do0 = tth - fo
    fo0 = fo.to(torch.int32).clamp(0, 7)
    fo1 = (fo0 + 1) & 7
    lo = (1.0 - do0) * wgt
    hi = do0 * wgt
    D = torch.stack([(torch.where(fo0 == b, lo, 0.0)
                      + torch.where(fo1 == b, hi, 0.0)).sum(dim=-1)
                     for b in range(8)], dim=-1)
    return D.reshape(th.shape[0], 128)


def grid_rounded_points(x, y, sigma, ang):
    """The Grid samples of each row (s_desc_grid.cu:62-86): per tile a
    rotated 16x16 grid, each sample rounded to the nearest pixel (half to
    even, as jnp.round), and the rotated-local coordinates recomputed
    there.  Returns (px, py, nx, ny, good), each (n, 16, 256) with sample
    j = 16 yd + xd of tile t = 4 iy + ix; ``good``: the triangle weights
    1 - |nx| and 1 - |ny| are not negative and the scale is positive."""
    sbp = torch.abs(DESC_MAGNIFY * sigma)
    ok = (sbp > 0.0)[:, None, None]
    safe = torch.where(sbp > 0.0, sbp, 1.0)[:, None, None]
    c = torch.cos(ang)[:, None, None]
    s = torch.sin(ang)[:, None, None]
    sb = sbp[:, None, None]
    # local 16x16 grid in tile units, (k + 0.5) / 8 - 1 (s_desc_grid.cu:69)
    k = (torch.arange(16, dtype=torch.float32, device=x.device) + 0.5) \
        / 8.0 - 1.0
    u = k.repeat(16)
    v = k.repeat_interleave(16)
    pixox = c * u - s * v
    pixoy = c * v + s * u
    ox, oy = _tile_centres(x)
    ptx = (c * sb) * ox - (s * sb) * oy + x[:, None, None]
    pty = (c * sb) * oy + (s * sb) * ox + y[:, None, None]
    px = torch.round(ptx + pixox * sb)
    py = torch.round(pty + pixoy * sb)
    rx = (px - ptx) / safe
    ry = (py - pty) / safe
    nx = c * rx + s * ry
    ny = c * ry - s * rx
    good = (1.0 - torch.abs(nx) >= 0.0) & (1.0 - torch.abs(ny) >= 0.0) & ok
    return px, py, nx, ny, good


def grid_rounded_body(tapi, x, y, sigma, ang, w: int, h: int):
    """(n, 128) Grid descriptors (popsift_tpu ops/descriptors.py:
    _grid_rounded_body; s_desc_grid.cu:18-121) given ``tapi(yy, xx)``, the
    values at integer coordinates already clipped to the (h, w) image.
    Each tile samples its own rotated 16x16 grid, every sample rounded to
    the nearest pixel (:func:`grid_rounded_points`), the tile and Gaussian
    weights recomputed at the rounded pixel and the sample skipped where
    the triangle weight goes negative (:86); the gradient is the
    axis-aligned central difference there, de-rotated by the angle."""
    px, py, nx, ny, good = grid_rounded_points(x, y, sigma, ang)
    ox, oy = _tile_centres(x)
    ix0 = px.to(torch.int64).clamp(0, w - 1)
    iy0 = py.to(torch.int64).clamp(0, h - 1)
    gdx = tapi(iy0, (ix0 + 1).clamp(max=w - 1)) \
        - tapi(iy0, (ix0 - 1).clamp(min=0))
    gdy = tapi((iy0 + 1).clamp(max=h - 1), ix0) \
        - tapi((iy0 - 1).clamp(min=0), ix0)
    mod = torch.hypot(gdx, gdy)
    th = _wrap_2pi(torch.atan2(gdy, gdx) - ang[:, None, None])
    dnx = nx + ox
    dny = ny + oy
    ww = torch.exp(-(dnx * dnx + dny * dny) / 8.0)
    wx = 1.0 - torch.abs(nx)
    wy = 1.0 - torch.abs(ny)
    return tile_bins(th, torch.where(good, ww * wx * wy * mod, 0.0))


def _iloop_grid(ang):
    """The fixed 32x32 ILoop grid of each row (s_desc_iloop.cu:60-75):
    offsets (dxg, dyg) in SBP units, -bsz + k bsz / 16, and their rotated
    coordinates (nx, ny), each (n, 1, 1024) with sample j = 32 row +
    column, and cos / sin of the angle (n, 1, 1)."""
    cos_t = torch.cos(ang)
    sin_t = torch.sin(ang)
    bsz = (torch.abs(cos_t) + torch.abs(sin_t))[:, None]
    kk = torch.arange(32, dtype=torch.float32, device=ang.device)
    d = -bsz + kk * bsz / 16.0
    dxg = d.repeat(1, 32)[:, None, :]
    dyg = d.repeat_interleave(32, dim=1)[:, None, :]
    c = cos_t[:, None, None]
    s = sin_t[:, None, None]
    nx = c * dxg + s * dyg
    ny = c * dyg - s * dxg
    return dxg, dyg, nx, ny, c, s


def iloop_sample_list(sigma, ang):
    """K13's list of each row's samples that carry weight, built as the
    kernel builds it: one ballot per 32 samples (grid row q holds samples
    32 q .. 32 q + 31), an exclusive prefix of the 32 counts, and each
    sample's place = its ballot's prefix + the set bits below its lane
    (the kernel keeps the sample's offsets and rotated coordinates there).
    The samples that carry weight are those with |nx| < 1 and |ny| < 1 at
    a positive scale (the ``nn_ok & ok`` of :func:`iloop_body`).  Returns
    (list (n, 1024) int32, -1 past the count; count (n,))."""
    _, _, nx, ny, _, _ = _iloop_grid(ang)
    ok = (torch.abs(DESC_MAGNIFY * sigma) > 0.0)[:, None]
    inside = ((torch.abs(nx) < 1.0) & (torch.abs(ny) < 1.0))[:, 0] & ok
    inside = inside.reshape(-1, 32, 32).to(torch.int32)
    per_ballot = inside.sum(dim=2)
    base = torch.cumsum(per_ballot, dim=1) - per_ballot
    below = torch.cumsum(inside, dim=2) - inside
    place = torch.where(inside > 0, base[:, :, None] + below, 1024)
    n = inside.shape[0]
    out = torch.full((n, 1025), -1, dtype=torch.int32, device=sigma.device)
    k = torch.arange(1024, dtype=torch.int32, device=sigma.device)
    out.scatter_(1, place.reshape(n, 1024).to(torch.int64),
                 k.expand(n, 1024).contiguous())
    return out[:, :1024], per_ballot.sum(dim=1)


def iloop_body(bil, x, y, sigma, ang):
    """(n, 128) ILoop descriptors (popsift_tpu ops/descriptors.py:
    _iloop_body; s_desc_iloop.cu:18-130) given the bilinear sampler
    ``bil(px, py)``: per tile a fixed 32x32 axis-aligned grid spanning the
    rotated tile's bounding box (offsets -bsz + k bsz / 16 in SBP units),
    rotated-derivative gradients, no angle subtraction."""
    sbp = torch.abs(DESC_MAGNIFY * sigma)
    ok = (sbp > 0.0)[:, None, None]
    dxg, dyg, nx, ny, c, s = _iloop_grid(ang)
    sb = sbp[:, None, None]
    nn_ok = (torch.abs(nx) < 1.0) & (torch.abs(ny) < 1.0)
    ox, oy = _tile_centres(x)
    ptx = (c * sb) * ox - (s * sb) * oy
    pty = (c * sb) * oy + (s * sb) * ox
    jj = (x[:, None, None] + ptx) + dxg * sb
    ii = (y[:, None, None] + pty) + dyg * sb
    gdx = bil(jj + c, ii + s) - bil(jj - c, ii - s)
    gdy = bil(jj - s, ii + c) - bil(jj + s, ii - c)
    mod = torch.hypot(gdx, gdy)
    th = _wrap_2pi(torch.atan2(gdy, gdx))
    dnx = nx + ox
    dny = ny + oy
    ww = torch.exp(-(dnx * dnx + dny * dny) / 8.0)
    wgt = torch.where(nn_ok & ok, ww * (1.0 - torch.abs(nx))
                      * (1.0 - torch.abs(ny)) * mod, 0.0)
    return tile_bins(th, wgt)


def _window_taps(wflat, x0i, y0i, win_y: int):
    """Integer taps of the flattened (n, win_y * 128) windows at image
    coordinates, clipped to the window (grid_rounded_descriptors_windowed
    of the JAX package)."""
    def tapi(yy, xx):
        xr = (xx - x0i).clamp(0, 127)
        yr = (yy - y0i).clamp(0, win_y - 1)
        idx = (yr * 128 + xr).reshape(wflat.shape[0], -1)
        return torch.gather(wflat, 1, idx).reshape(xx.shape)
    return tapi


def desc_grid_rounded_plain(wins, x, y, x0f, y0f, sigma, ang, w: int,
                            h: int) -> torch.Tensor:
    n, win_y, _ = wins.shape
    out = torch.empty((n, 128), dtype=torch.float32, device=wins.device)
    for s0 in range(0, n, CHUNK_GRID):
        e = slice(s0, s0 + CHUNK_GRID)
        tapi = _window_taps(wins[e].reshape(len(x[e]), -1),
                            x0f[e].to(torch.int64)[:, None, None],
                            y0f[e].to(torch.int64)[:, None, None], win_y)
        out[e] = grid_rounded_body(tapi, x[e], y[e], sigma[e], ang[e], w, h)
    return out


def desc_iloop_plain(wins, x, y, x0f, y0f, sigma, ang, w: int,
                     h: int) -> torch.Tensor:
    n, win_y, _ = wins.shape
    out = torch.empty((n, 128), dtype=torch.float32, device=wins.device)
    for s0 in range(0, n, CHUNK_ILOOP):
        e = slice(s0, s0 + CHUNK_ILOOP)
        ox = x0f[e][:, None, None]
        oy = y0f[e][:, None, None]
        lims = (0.0 - ox, (w - 1.0) - ox, 0.0 - oy, (h - 1.0) - oy)
        wflat = wins[e].reshape(len(x[e]), -1)

        def bil(px, py):
            return _bilinear_win(wflat, px - ox, py - oy, win_y, *lims)
        out[e] = iloop_body(bil, x[e], y[e], sigma[e], ang[e])
    return out


def footprint_half(sigma, ang) -> torch.Tensor:
    """(n,) int64 half side of each row's footprint box, ceil(2.5 bsz sbp
    + 2) with bsz = |cos| + |sin| and sbp = 3 sigma (at most 256).  The
    Grid samples lie within 2.4375 bsz sbp of the keypoint, rounded to a
    pixel, with taps one pixel further; the NoTile samples within 2.4375
    bsz sbp and the ILoop samples within 2.5 bsz sbp, each with
    rotated-derivative taps one pixel further and the bilinear corner's
    second pixel."""
    sbp = torch.abs(DESC_MAGNIFY * sigma)
    bsz = torch.abs(torch.cos(ang)) + torch.abs(torch.sin(ang))
    return torch.ceil(2.5 * bsz * sbp + 2.0).clamp(max=256.0) \
        .to(torch.int64)


def footprint_box(x, y, sigma, ang, win: int, half=None):
    """Each row's footprint in window-local pixels of K8's exact-origin
    window (:func:`window_origins`): the inclusive box (bx0, bx1, by0,
    by1), (n,) int64 each, of +-``half`` (:func:`footprint_half` by
    default) around (floor(x - x0), floor(y - ya)), clamped to the
    (win_y, 128) window.  Every tap of the NoTile, Grid and ILoop forms
    lies inside; K9, K12 and K13 stage this box widened by one pixel on
    each side."""
    win_y, win_x = rolled_window_dims(win)
    x0, ya = window_origins(x, y, win)
    if half is None:
        half = footprint_half(sigma, ang)
    fx = torch.floor(x - x0.to(torch.float32)).to(torch.int64)
    fy = torch.floor(y - ya.to(torch.float32)).to(torch.int64)
    return ((fx - half).clamp(min=0), (fx + half).clamp(max=win_x - 1),
            (fy - half).clamp(min=0), (fy + half).clamp(max=win_y - 1))


def stack_windows_plain(stack: torch.Tensor, x, y, lpos, win: int):
    """K8's (win_y, 128) window of each row (the plain gather), with its
    origins (x0, ya) as float32."""
    L = stack.shape[0]
    x0, ya = window_origins(x, y, win)
    wy, wx = rolled_window_dims(win)
    lp = lpos.to(torch.int64).clamp(0, L - 1)
    wins = gather_windows_plain(stack, lp, ya, x0, wy, wx)
    return wins, x0.to(torch.float32), ya.to(torch.float32)


def desc_grid_stack_plain(stack, x, y, lpos, sigma, ang, win: int,
                          desc_gauss, desc_tile) -> torch.Tensor:
    _, h, w = stack.shape
    wins, x0f, yaf = stack_windows_plain(stack, x, y, lpos, win)
    return desc_grid_plain(wins, x, y, x0f, yaf, sigma, ang, w, h,
                           desc_gauss, desc_tile)


def desc_grid_rounded_stack_plain(stack, x, y, lpos, sigma, ang,
                                  win: int) -> torch.Tensor:
    _, h, w = stack.shape
    wins, x0f, yaf = stack_windows_plain(stack, x, y, lpos, win)
    return desc_grid_rounded_plain(wins, x, y, x0f, yaf, sigma, ang, w, h)


def desc_iloop_stack_plain(stack, x, y, lpos, sigma, ang,
                           win: int) -> torch.Tensor:
    _, h, w = stack.shape
    wins, x0f, yaf = stack_windows_plain(stack, x, y, lpos, win)
    return desc_iloop_plain(wins, x, y, x0f, yaf, sigma, ang, w, h)


def _check_stack(name: str, stack: torch.Tensor, win: int,
                 stage: int) -> None:
    if stack.dim() != 3 or stack.dtype != torch.float32:
        raise ValueError(f"{name} takes an (L, H, W) float32 stack")
    rolled_window_dims(win)
    if stage < 0:
        raise ValueError(f"{name}: stage must be >= 0 floats")


def _on(dev, v, dtype):
    if v.device != dev or v.dtype != dtype or not v.is_contiguous():
        v = v.to(device=dev, dtype=dtype).contiguous()
    return v


def _stack_rows_call(name: str, stack, x, y, lpos, sigma, ang, win: int,
                     stage: int, tables=()) -> torch.Tensor:
    """Launch ``name`` on the rows of the (L, H, W) stack, with optional
    float32 device tables after the staging capacity."""
    dev = _lib.check_cuda(name, stack)
    lpos = _on(dev, lpos, torch.int32)
    x, y, sigma, ang, *tables = (_on(dev, v, torch.float32)
                                 for v in (x, y, sigma, ang, *tables))
    L, H, W = stack.shape
    n = int(x.shape[0])
    out = torch.empty((n, 128), dtype=torch.float32, device=dev)
    if n:
        _lib.call(name, dev, stack.data_ptr(), L, H, W, lpos.data_ptr(),
                  x.data_ptr(), y.data_ptr(), sigma.data_ptr(),
                  ang.data_ptr(), n, win, rolled_window_dims(win)[0], stage,
                  *(t.data_ptr() for t in tables), out.data_ptr())
    return out


def desc_grid_stack(stack: torch.Tensor, x, y, lpos, sigma, ang, win: int,
                    desc_gauss: torch.Tensor, desc_tile: torch.Tensor,
                    stage: int = STAGE_FLOATS) -> torch.Tensor:
    """(n, 128) unnormalised NoTile/IGrid descriptors (K9) of keypoints
    (x, y) at level ``lpos`` of the (L, H, W) ``stack``, scale ``sigma``
    and angle ``ang``: the numbers of K8's exact-origin windows (descriptor
    window ``win``) through :func:`desc_grid_plain` with the (40, 40)
    ``desc_gauss`` and (16,) ``desc_tile`` tables.  ``stage``: floats of
    shared memory for a row's footprint on the card (0: every row reads
    the stack through L2)."""
    _check_stack("desc_grid_stack", stack, win, stage)
    if stack.device.type == "cpu":
        return desc_grid_stack_plain(stack, x, y, lpos, sigma, ang, win,
                                     desc_gauss, desc_tile)
    return _stack_rows_call("desc_grid_stack", stack, x, y, lpos, sigma,
                            ang, win, stage, (desc_gauss, desc_tile))


def desc_grid_rounded_stack(stack: torch.Tensor, x, y, lpos, sigma, ang,
                            win: int, stage: int = STAGE_FLOATS
                            ) -> torch.Tensor:
    """(n, 128) unnormalised Grid descriptors (K12) of keypoints (x, y) at
    level ``lpos`` of the (L, H, W) ``stack``, scale ``sigma`` and angle
    ``ang``: the numbers of K8's exact-origin windows (descriptor window
    ``win``) through :func:`desc_grid_rounded_plain`.  ``stage``: floats
    of shared memory for a row's footprint on the card (0: every row reads
    the stack through L2)."""
    _check_stack("desc_grid_rounded_stack", stack, win, stage)
    if stack.device.type == "cpu":
        return desc_grid_rounded_stack_plain(stack, x, y, lpos, sigma, ang,
                                             win)
    return _stack_rows_call("desc_grid_rounded_stack", stack, x, y, lpos,
                            sigma, ang, win, stage)


def desc_iloop_stack(stack: torch.Tensor, x, y, lpos, sigma, ang, win: int,
                     stage: int = STAGE_FLOATS) -> torch.Tensor:
    """(n, 128) unnormalised ILoop descriptors (K13); arguments as
    :func:`desc_grid_rounded_stack`."""
    _check_stack("desc_iloop_stack", stack, win, stage)
    if stack.device.type == "cpu":
        return desc_iloop_stack_plain(stack, x, y, lpos, sigma, ang, win)
    return _stack_rows_call("desc_iloop_stack", stack, x, y, lpos, sigma,
                            ang, win, stage)
