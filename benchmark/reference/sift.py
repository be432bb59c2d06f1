"""The plain reference of the benchmark's extraction configurations.

A frozen copy of popsift_torch's plain PyTorch path (each kernel's
``*_plain`` version and the ops around them, as ``device="cpu"`` runs
them), cut to the settings the benchmark's configurations use: PopSift
SiftMode, VLFeat_Compute Gauss tables, the incremental pyramid with the
default scaling, no grid filter, ``loop`` or ``notile`` descriptors,
RootSift or L2 normalisation, and any ``desc_transfer``.  It raises on
any other setting.  It imports nothing of the program and runs on any
torch device; the benchmark runs it on the card, in float32 with TF32
off.

``pyramid_dtype=torch.bfloat16`` computes the scale space (input
resample, blurs and DoG) in bfloat16 and the rest in float32: the
benchmark's control, the step below the configuration's float32 that a
faster pyramid would tempt.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

# sift_constants.h:33-54
ORI_NBINS = 36
ORI_WINFACTOR = 1.5
DESC_MAGNIFY = 3.0
ORIENTATION_MAX_COUNT = 4
M_PI2 = 2.0 * math.pi
M_4RPI = 4.0 / math.pi
MAX_OCTAVES = 20
GAUSS_ALIGN = 32
PREV_LEVEL = 3
MAX_ITERATIONS = 5
BLOCK, PER_BLOCK = 1024, 16      # the candidates' per-block budget
CHUNK = 256

DEFAULTS = dict(
    octaves=-1, levels=3, sigma=1.6, edge_limit=10.0, threshold=0.04,
    upscale_factor=1.0, gauss_mode="vlfeat", sift_mode="popsift",
    scaling_mode="indirect", desc_mode="loop", max_extrema=100000,
    filter_max_extrema=-1, filter_grid_size=2, assume_initial_blur=True,
    initial_blur=0.5, norm_mode="RootSift", norm_multiplier=0,
    ext_capacity=-1, ori_capacity=-1, desc_transfer="u16")
SUPPORTED = dict(gauss_mode=("vlfeat",), sift_mode=("popsift",),
                 scaling_mode=("indirect",), desc_mode=("loop", "notile"),
                 norm_mode=("RootSift", "classic"),
                 desc_transfer=("f32", "u16", "u8", "u8p"))


@dataclasses.dataclass(frozen=True)
class Plan:
    """Per-octave shapes and capacities of one input size
    (popsift_torch/extract.py:make_plan)."""

    settings: dict
    input_w: int
    input_h: int
    dims: tuple
    levels: int
    cand_caps: tuple
    ext_caps: tuple
    ori_caps: tuple
    desc_win: int

    @property
    def octaves(self) -> int:
        return len(self.dims)


def settings_of(popsift_config: dict) -> dict:
    """The configuration's settings with the defaults filled in; raises
    on a setting this reference does not implement."""
    s = dict(DEFAULTS)
    for k, v in popsift_config.items():
        if k in ("verbose", "log_mode", "print_gauss_tables",
                 "grid_filter_mode"):
            continue
        if k not in DEFAULTS:
            raise ValueError(f"reference: unknown setting {k!r}")
        s[k] = v
    for k, allowed in SUPPORTED.items():
        if s[k] not in allowed:
            raise ValueError(f"reference: {k}={s[k]!r} is not implemented")
    if s["filter_max_extrema"] > 0:
        raise ValueError("reference: the grid filter is not implemented")
    s["levels"] = max(2, int(s["levels"]))
    return s


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def make_plan(settings: dict, width: int, height: int) -> Plan:
    up = float(settings["upscale_factor"])
    levels = settings["levels"]
    w = int(math.ceil(width * 2.0 ** up))
    h = int(math.ceil(height * 2.0 ** up))
    if settings["octaves"] >= 0:
        octaves = min(max(settings["octaves"], 1), MAX_OCTAVES)
    else:
        octaves = min(max(int(math.floor(
            math.log(min(width, height)) / math.log(2.0) - 3.0
            + 2.0 ** up)), 1), MAX_OCTAVES)
    dims, cand, ext, ori = [], [], [], []
    for _ in range(octaves):
        dims.append((w, h))
        voxels = w * h * levels
        if settings["ext_capacity"] > 0:
            ext_cap = settings["ext_capacity"]
        else:
            ext_cap = min(settings["max_extrema"],
                          max(512, _round_up(voxels // 256, 128)), 16384)
        cand.append(min(max(settings["max_extrema"], 2 * ext_cap),
                        max(1024, _round_up(voxels // 64, 128)), 65536))
        ext.append(ext_cap)
        ori.append(settings["ori_capacity"] if settings["ori_capacity"] > 0
                   else _round_up(ext_cap + ext_cap // 4, 128))
        w, h = -(-w // 2), -(-h // 2)
    sbp_max = DESC_MAGNIFY * settings["sigma"] * 2.0 ** ((levels + 2)
                                                         / levels)
    win = int(math.ceil(2.0 * 2.5 * math.sqrt(2.0) * sbp_max)) + 4
    return Plan(settings, width, height, tuple(dims), levels, tuple(cand),
                tuple(ext), tuple(ori), (win + 7) // 8 * 8)


# --- Gauss tables (gauss_filter.cu:127-371), VLFeat_Compute only --------

def _gauss_filter(sigma: float):
    if sigma <= 0.0:
        f = np.zeros(GAUSS_ALIGN, np.float32)
        f[0] = 1.0
        return f, 1
    span = min(int(math.ceil(4.0 * sigma)) + 1, GAUSS_ALIGN - 1)
    taps = np.zeros(GAUSS_ALIGN, np.float64)
    taps[0] = 1.0
    acc = 1.0
    for x in range(1, span):
        val = math.exp(-0.5 * (float(x) / sigma) ** 2)
        taps[x] = val
        acc += np.float32(2.0 * val)
    taps[:span] /= acc
    return taps.astype(np.float32), span


def gauss_tables(settings: dict):
    """(inc, dd): per level and per octave a (taps, span) pair."""
    sigma0 = float(settings["sigma"])
    levels = settings["levels"]
    blur0 = (settings["initial_blur"] * 2.0 ** settings["upscale_factor"]
             if settings["assume_initial_blur"] else 0.0)
    inc = [math.sqrt(abs(sigma0 * sigma0 - blur0 * blur0))
           if settings["assume_initial_blur"] else sigma0]
    for lvl in range(1, levels + 3):
        sp = sigma0 * 2.0 ** ((lvl - 1) / levels)
        ss = sigma0 * 2.0 ** (lvl / levels)
        inc.append(math.sqrt(ss * ss - sp * sp))
    dd = []
    for octv in range(MAX_OCTAVES):
        s = math.ldexp(sigma0, octv)
        dd.append(math.ldexp(math.sqrt(abs(s * s - blur0 * blur0)), -octv))
    return [_gauss_filter(s) for s in inc], [_gauss_filter(s) for s in dd]


# --- the scale space (ops/pyramid.py, kernels/blur.py, kernels/grad.py) --

def _clamped_index(n: int, pad: int, device) -> torch.Tensor:
    return torch.arange(-pad, n + pad, device=device).clamp_(0, n - 1)


def blur_1d(img, half_taps, span: int, dim: int):
    taps = [float(t) for t in np.asarray(half_taps, np.float32)[:max(span,
                                                                     1)]]
    if span <= 1:
        return img * taps[0]
    pad = span - 1
    size = img.shape[dim]
    padded = img.index_select(dim, _clamped_index(size, pad, img.device))
    out = padded.narrow(dim, pad, size) * taps[0]
    for off in range(1, span):
        out = out + (padded.narrow(dim, pad - off, size)
                     + padded.narrow(dim, pad + off, size)) * taps[off]
    return out


def sep_blur(img, taps_h, span_h, taps_v, span_v, hscale=1.0):
    out = blur_1d(img, taps_h, span_h, -1)
    if hscale != 1.0:
        out = out * float(hscale)
    return blur_1d(out, taps_v, span_v, -2)


def _shifted(arr, delta: int, dim: int):
    n = arr.shape[dim]
    if delta > 0:
        return torch.cat([arr.narrow(dim, 1, n - 1),
                          arr.narrow(dim, n - 1, 1)], dim=dim)
    return torch.cat([arr.narrow(dim, 0, 1), arr.narrow(dim, 0, n - 1)],
                     dim=dim)


def _upsample2_1d(arr, shift: float, dim: int):
    def blend(frac: float):
        if frac >= 0.0:
            return arr * (1.0 - frac) + _shifted(arr, +1, dim) * frac
        return arr * (1.0 + frac) + _shifted(arr, -1, dim) * (-frac)

    out = torch.stack([blend((shift - 1.0) / 2.0), blend(shift / 2.0)],
                      dim=dim + 1)
    shape = list(arr.shape)
    shape[dim] *= 2
    return out.reshape(shape)


def _resample_1d(arr, dst: int, src: int, shift: float, dim: int):
    if dst == 2 * src:
        return _upsample2_1d(arr, shift, dim)
    pos = (np.arange(dst, dtype=np.float64) + shift) * (src / dst) - 0.5
    i0 = np.clip(np.floor(pos).astype(np.int64), 0, src - 1)
    i1 = np.clip(i0 + 1, 0, src - 1)
    w = np.clip(pos - np.floor(pos), 0.0, 1.0).astype(np.float32)
    dev = arr.device
    a = arr.index_select(dim, torch.as_tensor(i0, device=dev))
    b = arr.index_select(dim, torch.as_tensor(i1, device=dev))
    shape = [1] * arr.dim()
    shape[dim] = dst
    wt = torch.as_tensor(w, device=dev).reshape(shape).to(arr.dtype)
    return a * (1.0 - wt) + b * wt


def gradient_field(stack):
    """(2L, H, W): mag_l at 2l, theta_l at 2l+1 (ops/gradients.py)."""
    L, H, W = stack.shape
    dev = stack.device
    xi = torch.arange(W, device=dev)
    yi = torch.arange(H, device=dev)
    dx = stack[:, :, xi.add(1).clamp_(max=W - 1)] \
        - stack[:, :, xi.sub(1).clamp_(min=0)]
    dy = stack[:, yi.add(1).clamp_(max=H - 1), :] \
        - stack[:, yi.sub(1).clamp_(min=0), :]
    mag, theta = torch.sqrt(dx * dx + dy * dy), torch.atan2(dy, dx)
    return torch.stack([mag, theta], dim=1).reshape(2 * L, H, W)


def octave_stack(src, o: int, plan: Plan, tables, dtype):
    """Octave ``o``'s (L+3, H, W) stack and (L+2, H, W) DoG, both
    float32 (computed in ``dtype``).  ``src`` is the [0, 1] input for
    octave 0 and level L of the octave before otherwise."""
    inc, dd = tables
    w, h = plan.dims[o]
    if o == 0:
        shift = 0.5 * 2.0 ** plan.settings["upscale_factor"]
        base = _resample_1d(src.to(dtype), h, src.shape[0], shift, 0)
        base = _resample_1d(base, w, src.shape[1], shift, 1)
        lvl0 = sep_blur(base, dd[0][0], dd[0][1], inc[0][0], inc[0][1],
                        hscale=255.0)
    else:
        lvl0 = src.to(dtype)[::2, ::2][:h, :w]
    lvls, dogs = [lvl0], []
    for lvl in range(1, plan.levels + 3):
        nxt = sep_blur(lvls[-1], inc[lvl][0], inc[lvl][1], inc[lvl][0],
                       inc[lvl][1])
        dogs.append(nxt - lvls[-1])
        lvls.append(nxt)
    return (torch.stack(lvls).to(torch.float32),
            torch.stack(dogs).to(torch.float32))


# --- detection, compaction and refinement (kernels/detect.py,
# ops/extrema.py, kernels/refine.py), PopSift SiftMode -------------------

def detect(dog, gate: float):
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
    inner = ((center > nb_max) | (center < nb_min)) & (center.abs() >= gate)
    mask[:, 1:1 + hi, 1:1 + wi] = inner.to(torch.uint8)
    return mask


def compact_mask(mask, cap: int):
    """(z, y, x) rows of the set voxels in raster order: the first
    PER_BLOCK of each BLOCK-voxel run, then the first ``cap``."""
    nz = torch.nonzero(mask)
    total = int(nz.shape[0])
    if total > PER_BLOCK:
        _, h, w = mask.shape
        block = ((nz[:, 0] * h + nz[:, 1]) * w + nz[:, 2]) // BLOCK
        over = block[PER_BLOCK:] == block[:-PER_BLOCK]
        if bool(over.any()):
            keep = torch.ones(total, dtype=torch.bool, device=nz.device)
            keep[PER_BLOCK:] = ~over
            nz = nz[keep]
    return nz[:min(int(nz.shape[0]), cap)]


def _solve3(A00, A01, A02, A11, A12, A22, bx, by, bz):
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
    return (ok, i00 * bx + i01 * by + i02 * bz,
            i01 * bx + i11 * by + i12 * bz, i02 * bx + i12 * by + i22 * bz)


def refine(dog, zyx, plan: Plan, o: int, cap: int):
    """Newton refinement of the candidates (PopSift rules) and the
    survivors in candidate order, at most ``cap``: (x, y, lpos, sigma)."""
    s = plan.settings
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    L, H, W = dog.shape
    width, height = plan.dims[o]
    maxlevel = L
    hp = max(-(-height // 8) * 8, 16)
    wp = max(-(-width // 128) * 128, 256)
    dev = dog.device
    n = zyx.shape[0]
    flat = dog.reshape(-1)
    nx, ny = zyx[:, 2].to(torch.int64), zyx[:, 1].to(torch.int64)
    nz = zyx[:, 0].to(torch.int64) + 1
    zero = torch.zeros(n, dtype=torch.float32, device=dev)
    st = {k: zero for k in ("v", "dx", "dy", "dz", "Dx", "Dy", "Dz", "DDx",
                            "DDy", "DDz", "DXx", "DXy", "DXz")}
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    r3 = torch.arange(-1, 2, device=dev)
    oz, oy, ox = (r3.repeat_interleave(9), r3.repeat_interleave(3).repeat(3),
                  r3.repeat(9))
    for it in range(1, MAX_ITERATIONS + 1):
        active = ~done
        if not bool(active.any()):
            break
        z = nz.clamp(1, L - 2)
        y = ny.clamp(1, hp - 2)
        x = nx.clamp(1, wp - 2)
        idx = ((z[:, None] + oz) * H
               + (y[:, None] + oy).clamp(max=H - 1)) * W \
            + (x[:, None] + ox).clamp(max=W - 1)
        win = flat[idx].reshape(n, 3, 3, 3)

        def P(a, b, c):
            return win[:, 1 + a, 1 + b, 1 + c]

        v = torch.where((it == 1) & active, P(0, 0, 0), st["v"])
        c = P(0, 0, 0)
        new = dict(
            v=v, Dx=0.5 * (P(0, 0, 1) - P(0, 0, -1)),
            Dy=0.5 * (P(0, 1, 0) - P(0, -1, 0)),
            Dz=0.5 * (P(1, 0, 0) - P(-1, 0, 0)),
            DDx=P(0, 0, 1) + P(0, 0, -1) - 2.0 * c,
            DDy=P(0, 1, 0) + P(0, -1, 0) - 2.0 * c,
            DDz=P(1, 0, 0) + P(-1, 0, 0) - 2.0 * c,
            DXx=0.25 * (P(0, 1, 1) + P(0, -1, -1) - P(0, 1, -1)
                        - P(0, -1, 1)),
            DXy=0.25 * (P(1, 0, 1) + P(-1, 0, -1) - P(1, 0, -1)
                        - P(-1, 0, 1)),
            DXz=0.25 * (P(1, 1, 0) + P(-1, -1, 0) - P(1, -1, 0)
                        - P(-1, 1, 0)))
        ok, sx, sy, sz = _solve3(new["DDx"], new["DXx"], new["DXy"],
                                 new["DDy"], new["DXz"], new["DDz"],
                                 -new["Dx"], -new["Dy"], -new["Dz"])
        new["dx"] = dx = torch.where(ok, sx, 0.0)
        new["dy"] = dy = torch.where(ok, sy, 0.0)
        new["dz"] = dz = torch.where(ok, sz, 0.0)
        last_it = it == MAX_ITERATIONS
        one, nil = torch.ones_like(nx), torch.zeros_like(nx)
        tx = torch.where((dx >= 0.6) & (nx < width - 2), one, nil) \
            + torch.where((dx <= -0.6) & (nx > 1), -one, nil)
        ty = torch.where((dy >= 0.6) & (ny < height - 2), one, nil) \
            + torch.where((dy <= -0.6) & (ny > 1), -one, nil)
        tz = torch.where((dz >= 0.6) & (nz < maxlevel - 1), one, nil) \
            + torch.where((dz <= -0.6) & (nz > 1), -one, nil)
        no_move = (tx == 0) & (ty == 0) & (tz == 0)
        new_done = ~ok | (no_move & (not last_it))
        move = active & ok & ~no_move & (not last_it)
        nx = torch.where(move, nx + tx, nx)
        ny = torch.where(move, ny + ty, ny)
        nz = torch.where(move, nz + tz, nz)
        st = {k: (new[k] if k == "v" else torch.where(active, new[k], st[k]))
              for k in st}
        done = done | (active & new_done)

    ok = ~((st["dx"] >= 1.5) | (st["dy"] >= 1.5) | (st["dz"] >= 1.5))
    xn = nx.to(torch.float32) + st["dx"]
    yn = ny.to(torch.float32) + st["dy"]
    sn = nz.to(torch.float32) + st["dz"]
    ok &= ~((xn < 0.0) | (xn > float(width) - 1.0) | (yn < 0.0)
            | (yn > float(height) - 1.0) | (sn < 0.0) | (sn > float(maxlevel)))
    contr = st["v"] + 0.5 * (st["Dx"] * st["dx"] + st["Dy"] * st["dy"]
                             + st["Dz"] * st["dz"])
    tr = st["DDx"] + st["DDy"]
    det = st["DDx"] * st["DDy"] - st["DXx"] * st["DXx"]
    edgeval = tr * tr / torch.where(det == 0, 1.0, det)
    r = s["edge_limit"]
    ok &= det > 0.0
    ok &= contr.abs() >= f32(2.0 * plan_peak_threshold(s))
    ok &= edgeval < f32((r + 1.0) * (r + 1.0) / r)
    sigk = torch.tensor(f32(2.0 ** (1.0 / plan.levels)), dtype=torch.float32,
                        device=dev)
    sigma = f32(s["sigma"]) * torch.pow(sigk, sn)
    keep = torch.nonzero(ok).reshape(-1)[:cap]
    return (xn[keep], yn[keep], torch.round(sn).to(torch.int32)[keep],
            sigma[keep])


def plan_peak_threshold(settings: dict) -> float:
    """sift_conf.cu:276-279."""
    return settings["threshold"] * 0.5 * 255.0 / settings["levels"]


# --- orientation (kernels/binwin.py) ------------------------------------

def _chunks(radius):
    order = torch.argsort(radius, stable=True)
    return [order[s:s + CHUNK] for s in range(0, order.numel(), CHUNK)]


def _field_windows(field, lp, rx, ry, R):
    _, H, W = field.shape
    offs = torch.arange(-R, R + 1, device=field.device)
    jj, ii = rx[:, None] + offs, ry[:, None] + offs
    base = (2 * lp)[:, None, None] * H + ii.clamp(0, H - 1)[:, :, None]
    idx = base * W + jj.clamp(0, W - 1)[:, None, :]
    flat = field.reshape(-1)
    return flat[idx], flat[idx + H * W], jj, ii


def ori_hist(field, x, y, lpos, sigma):
    L2, H, W = field.shape
    levels = L2 // 2
    n = x.shape[0]
    out = torch.zeros((n, ORI_NBINS), dtype=torch.float32, device=x.device)
    pi2 = torch.tensor(M_PI2, dtype=torch.float32, device=x.device)
    radius = torch.round(3.0 * (ORI_WINFACTOR * sigma)).to(torch.int64)
    for e in _chunks(radius):
        xs, ys, sg, rad = x[e], y[e], sigma[e], radius[e]
        lp = lpos[e].to(torch.int64).clamp(0, levels - 1)
        rx = torch.round(xs).to(torch.int64)
        ry = torch.round(ys).to(torch.int64)
        R = max(int(rad.max()), 0)
        mw, tw, jj, ii = _field_windows(field, lp, rx, ry, R)
        xmin = torch.clamp(rx - rad, min=1)
        xmax = torch.clamp(rx + rad, max=W - 2)
        ymin = torch.clamp(ry - rad, min=1)
        ymax = torch.clamp(ry + rad, max=H - 2)
        in_x = (jj >= xmin[:, None]) & (jj <= xmax[:, None])
        in_y = (ii >= ymin[:, None]) & (ii <= ymax[:, None])
        dxf = jj.to(torch.float32) - xs[:, None]
        dyf = ii.to(torch.float32) - ys[:, None]
        sq = (dxf[:, None, :] * dxf[:, None, :]
              + dyf[:, :, None] * dyf[:, :, None]).to(torch.int32)
        sigw = ORI_WINFACTOR * sg
        factor = -0.5 / (sigw * sigw)
        inside = (sq <= (rad * rad)[:, None, None]) \
            & in_x[:, None, :] & in_y[:, :, None]
        weight = torch.where(
            inside, mw * torch.exp(sq.to(torch.float32)
                                   * factor[:, None, None]), 0.0)
        bidx = torch.round(ORI_NBINS * (tw + math.pi) / pi2).to(torch.int32)
        bidx = torch.where(bidx == ORI_NBINS, 0, bidx)
        out[e] = torch.stack([torch.where(bidx == b, weight, 0.0)
                              .sum(dim=(1, 2)) for b in range(ORI_NBINS)],
                             dim=1)
    return out


def peaks_from_hist(hist):
    for _ in range(6):
        hist = (torch.roll(hist, 1, dims=-1) + hist
                + torch.roll(hist, -1, dims=-1)) * (1.0 / 3.0)
    prev = torch.roll(hist, 1, dims=-1)
    nxt = torch.roll(hist, -1, dims=-1)
    is_peak = hist > torch.maximum(prev, nxt)
    num = torch.where(is_peak, 3.0 * prev - 4.0 * hist + 1.0 * nxt, 0.0)
    den = torch.where(is_peak, 2.0 * (prev - 2.0 * hist + nxt), 1.0)
    newbin = num / den
    pred = is_peak & (newbin >= 0.0) & (newbin <= 2.0)
    bins = torch.arange(ORI_NBINS, dtype=torch.float32, device=hist.device)
    prev_idx = torch.where(bins == 0, ORI_NBINS - 1.0, bins - 1.0)
    refined = torch.where(pred, prev_idx + newbin, -1.0)
    yval = torch.where(pred, -(num * num) / (4.0 * den) + prev, -math.inf)
    top_val, top_idx = torch.sort(yval, dim=-1, descending=True, stable=True)
    top_val = top_val[:, :ORIENTATION_MAX_COUNT]
    top_idx = top_idx[:, :ORIENTATION_MAX_COUNT]
    accept = (top_val >= 0.8 * top_val[:, :1]) & torch.isfinite(top_val)
    chosen = torch.gather(refined, 1, top_idx)
    chosen = torch.where(chosen >= ORI_NBINS, chosen - ORI_NBINS, chosen)
    th = M_PI2 * chosen * (1.0 / ORI_NBINS) - math.pi
    return accept.sum(dim=-1).to(torch.int32), torch.where(accept, th, 0.0)


# --- descriptors (kernels/binwin.py, kernels/desc_grid.py,
# kernels/windows.py, ops/descriptors.py) --------------------------------

def desc_loop(field, x, y, lpos, sigma, ang, half: int):
    L2, H, W = field.shape
    levels = L2 // 2
    n = x.shape[0]
    out = torch.zeros((n, 4, 4, 8), dtype=torch.float32, device=x.device)
    sbp_all = torch.abs(DESC_MAGNIFY * sigma)
    support = ((3.5355339 * sbp_all).to(torch.int64) + 2).clamp(max=half)
    for e in _chunks(support):
        xs, ys, sg, a = x[e], y[e], sigma[e], ang[e]
        lp = lpos[e].to(torch.int64).clamp(0, levels - 1)
        rx = torch.round(xs).to(torch.int64)
        ry = torch.round(ys).to(torch.int64)
        mw, tw, jj, ii = _field_windows(field, lp, rx, ry,
                                        int(support[e].max()))
        sbp = torch.abs(DESC_MAGNIFY * sg)
        ok = sbp > 0.0
        safe = torch.where(ok, sbp, 1.0)[:, None, None]
        cos_t = torch.cos(a)[:, None, None]
        sin_t = torch.sin(a)[:, None, None]
        dxf = (jj.to(torch.float32) - xs[:, None])[:, None, :]
        dyf = (ii.to(torch.float32) - ys[:, None])[:, :, None]
        ux = (cos_t * dxf + sin_t * dyf) / safe
        uy = (cos_t * dyf - sin_t * dxf) / safe
        ww = torch.exp(-(ux * ux + uy * uy) / 8.0)
        in_img = ((jj >= 1) & (jj <= W - 2))[:, None, :] \
            & ((ii >= 1) & (ii <= H - 2))[:, :, None]
        wgt = torch.where(in_img & ok[:, None, None], mw * ww, 0.0)
        th = tw - a[:, None, None]
        th = torch.where(th < 0.0, th + M_PI2, th)
        th = torch.where(th >= M_PI2, th - M_PI2, th)
        tth = th * M_4RPI
        fo0 = torch.floor(tth).to(torch.int32)
        do0 = tth - fo0.to(torch.float32)
        fo0 = fo0.clamp(0, 7)
        fo1 = torch.where(fo0 + 1 == 8, 0, fo0 + 1)
        lo = wgt * (1.0 - do0)
        hi = wgt * do0
        wxs = [torch.clamp(1.0 - torch.abs(ux - (t - 1.5)), min=0.0)
               for t in range(4)]
        wys = [torch.clamp(1.0 - torch.abs(uy - (t - 1.5)), min=0.0)
               for t in range(4)]
        hist = torch.empty((len(e), 4, 4, 8), dtype=torch.float32,
                           device=x.device)
        for b in range(8):
            a_b = torch.where(fo0 == b, lo, 0.0) + torch.where(fo1 == b, hi,
                                                               0.0)
            for tx in range(4):
                e_b = wxs[tx] * a_b
                for ty in range(4):
                    hist[:, ty, tx, b] = (wys[ty] * e_b).sum(dim=(1, 2))
        out[e] = hist
    return out.reshape(n, 128)


def desc_tables(device):
    """The 40x40 descriptor Gaussian and the 16 tile weights
    (sift_constants.cu:34-47)."""
    step = 1.0 / 8.0
    base = 0.5 * step - 20.0 * step
    idx = np.arange(40, dtype=np.float32)
    dnx = (base + idx * step)[None, :]
    dny = (base + idx * step)[:, None]
    g = np.exp(-((dnx * dnx + dny * dny) / 8.0)).astype(np.float32)
    i = np.arange(16, dtype=np.float32)
    tile = (1.0 - np.abs(-1.0 + 1.0 / 16.0 + i * (1.0 / 8.0))) \
        .astype(np.float32)
    return torch.as_tensor(g, device=device), torch.as_tensor(tile,
                                                              device=device)


def _bilinear_win(wflat, px, py, win_y: int, xlo, xhi, ylo, yhi):
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


def desc_notile(stack, x, y, lpos, sigma, ang, win: int, desc_gauss,
                desc_tile):
    """NoTile descriptors: each row's (win_y, 128) window of its level at
    the exact origin, then the rotated 40x40 sample grid inside it."""
    L, h, w = stack.shape
    dev = stack.device
    if win > 120:
        raise ValueError("exact-origin windows require win <= 120")
    win_y = -(-(win + 7) // 8) * 8
    x0 = torch.round(x).to(torch.int32) - win // 2
    y0 = torch.round(y).to(torch.int32) - win // 2
    ya = torch.div(y0, 8, rounding_mode="floor") * 8
    lp = lpos.to(torch.int64).clamp(0, L - 1)
    rows = (ya.to(torch.int64)[:, None]
            + torch.arange(win_y, device=dev)).clamp_(0, h - 1)
    cols = (x0.to(torch.int64)[:, None]
            + torch.arange(128, device=dev)).clamp_(0, w - 1)
    wins = stack[lp[:, None, None], rows[:, :, None], cols[:, None, :]]
    x0f, y0f = x0.to(torch.float32), ya.to(torch.float32)
    steps = torch.as_tensor(-2.5 + 1.0 / 16.0
                            + np.arange(40, dtype=np.float32) / 8.0,
                            device=dev)
    TX = torch.zeros((40, 4), dtype=torch.float32, device=dev)
    for t in range(4):
        TX[8 * t:8 * t + 16, t] = desc_tile
    n = x.shape[0]
    out = torch.empty((n, 128), dtype=torch.float32, device=dev)
    for s in range(0, n, CHUNK):
        e = slice(s, s + CHUNK)
        sbp = torch.abs(DESC_MAGNIFY * sigma[e])[:, None, None]
        cos_t = torch.cos(ang[e])[:, None, None]
        sin_t = torch.sin(ang[e])[:, None, None]
        sx, sy = steps[None, None, :], steps[None, :, None]
        px = x[e][:, None, None] + (cos_t * sx - sin_t * sy) * sbp
        py = y[e][:, None, None] + (cos_t * sy + sin_t * sx) * sbp
        ok = sbp > 0.0
        ox = x0f[e][:, None, None]
        oy = y0f[e][:, None, None]
        pxr, pyr = px - ox, py - oy
        lims = (0.0 - ox, (w - 1.0) - ox, 0.0 - oy, (h - 1.0) - oy)
        wflat = wins[e].reshape(px.shape[0], -1)

        def bw(ppx, ppy):
            return _bilinear_win(wflat, ppx, ppy, win_y, *lims)

        dx = bw(pxr + cos_t, pyr + sin_t) - bw(pxr - cos_t, pyr - sin_t)
        dy = bw(pxr - sin_t, pyr + cos_t) - bw(pxr + sin_t, pyr - cos_t)
        mod = torch.hypot(dx, dy)
        th = torch.atan2(dy, dx)
        th = torch.where(th < 0.0, th + M_PI2, th)
        tth = th * M_4RPI
        fo = torch.floor(tth).to(torch.int32)
        do0 = tth - fo.to(torch.float32)
        fo0 = fo & 7
        fo1 = (fo0 + 1) & 7
        ww = torch.where(ok, desc_gauss * mod, 0.0)
        bins = torch.arange(8, dtype=torch.int32, device=dev)
        A = ((fo0[..., None] == bins) * ((1.0 - do0) * ww)[..., None]
             + (fo1[..., None] == bins) * (do0 * ww)[..., None])
        B = torch.einsum("nyxb,xt->nytb", A, TX)
        out[e] = torch.einsum("nytb,ys->nstb", B, TX).reshape(-1, 128)
    return out


def normalize(desc, settings: dict):
    mult = 2.0 ** settings["norm_multiplier"]
    if settings["norm_mode"] == "RootSift":
        s = desc.sum(dim=-1, keepdim=True)
        out = torch.sqrt(desc / torch.where(s > 0.0, s, 1.0)) * mult
        return torch.where(s > 0.0, out, 0.0)
    n1 = torch.sqrt((desc * desc).sum(dim=-1, keepdim=True))
    clamped = torch.minimum(desc, 0.2 * n1)
    n2sq = (clamped * clamped).sum(dim=-1, keepdim=True)
    inv = torch.rsqrt(torch.where(n2sq > 0.0, n2sq, 1.0)) * mult
    return torch.where(n2sq > 0.0, clamped * inv, 0.0)


def quantize(desc, settings: dict) -> np.ndarray:
    """The descriptors as the user receives them (Config.desc_transfer)."""
    mode = settings["desc_transfer"]
    if mode == "f32":
        return desc.cpu().numpy()
    bound = 2.0 ** settings["norm_multiplier"]
    levels = 65535.0 if mode == "u16" else 255.0
    q = torch.round(torch.clamp(desc, 0.0, bound) * (levels / bound))
    dt = np.uint16 if mode == "u16" else np.uint8
    return (q.cpu().numpy().astype(dt).astype(np.float32)
            * np.float32(bound / levels))


# --- the extraction ---------------------------------------------------

def extract(image: np.ndarray, settings: dict, device="cuda",
            pyramid_dtype=torch.float32, plan: Plan | None = None) -> dict:
    """Features of one (H, W) uint8 image: numpy ``xpos, ypos, sigma``
    (input coordinates), ``num_ori``, ``orientation`` (n, 4),
    ``debug_octave``, ``desc_idx`` (n, 4) into ``descriptors`` (rows,
    128), the layout of popsift_torch's FeaturesHost."""
    h, w = image.shape
    plan = plan or make_plan(settings, w, h)
    tables = gauss_tables(settings)
    img = torch.as_tensor(np.array(image, np.uint8), device=device) \
        .to(torch.float32) * (1.0 / 255.0)
    gate = float(np.float32(1.6) * np.float32(plan_peak_threshold(settings)))
    notile = settings["desc_mode"] == "notile"
    consts = desc_tables(device) if notile else None
    up = settings["upscale_factor"]
    parts = []
    src = img
    for o in range(plan.octaves):
        stack, dog = octave_stack(src, o, plan, tables, pyramid_dtype)
        src = stack[plan.levels + 3 - PREV_LEVEL]
        zyx = compact_mask(detect(dog, gate), plan.cand_caps[o])
        x, y, lpos, sigma = refine(dog, zyx, plan, o, plan.ext_caps[o])
        del dog
        field = gradient_field(stack)
        if x.shape[0]:
            num_ori, oris = peaks_from_hist(ori_hist(field, x, y, lpos,
                                                     sigma))
        else:
            num_ori = torch.zeros(0, dtype=torch.int32, device=device)
            oris = torch.zeros((0, 4), dtype=torch.float32, device=device)
        n = num_ori.shape[0]
        num64 = num_ori.to(torch.int64)
        incl = torch.cumsum(num64, 0)
        rows = min(int(incl[-1]) if n else 0, plan.ori_caps[o])
        feat = torch.repeat_interleave(torch.arange(n, device=device),
                                       num64)[:rows]
        first = incl - num64
        ang = oris[feat, torch.arange(rows, device=device) - first[feat]]
        num_eff = torch.clamp(torch.minimum(num64, rows - first), min=0)
        if notile:
            desc = desc_notile(stack, x[feat], y[feat], lpos[feat],
                               sigma[feat], ang, plan.desc_win, *consts)
        else:
            desc = desc_loop(field, x[feat], y[feat], lpos[feat],
                             sigma[feat], ang, plan.desc_win // 2)
        parts.append(dict(
            x=x.cpu().numpy(), y=y.cpu().numpy(), sigma=sigma.cpu().numpy(),
            num_ori=num_eff.to(torch.int32).cpu().numpy(),
            orientations=oris.cpu().numpy(),
            desc=quantize(normalize(desc, settings), settings)))
        del stack, field
    return assemble(parts, up)


def assemble(parts: list, upscale_factor: float) -> dict:
    """The feature arrays (popsift_torch/features.py:_assemble_soa)."""
    keys = ("xpos", "ypos", "sigma", "num_ori", "orientation", "desc_idx",
            "debug_octave")
    out = {k: [] for k in keys}
    kk = np.arange(ORIENTATION_MAX_COUNT, dtype=np.int64)[None, :]
    base = 0
    for o, od in enumerate(parts):
        n = od["x"].shape[0]
        if n:
            scale = np.float32(2.0 ** (o - upscale_factor))
            num = od["num_ori"].astype(np.int32)
            idx0 = base + np.cumsum(num, dtype=np.int64) - num
            keep = kk < num[:, None]
            out["xpos"].append(od["x"] * scale)
            out["ypos"].append(od["y"] * scale)
            out["sigma"].append(od["sigma"] * scale)
            out["num_ori"].append(num)
            out["orientation"].append(
                np.where(keep, od["orientations"], np.float32(0.0))
                .astype(np.float32))
            out["desc_idx"].append(np.where(keep, idx0[:, None] + kk, -1))
            out["debug_octave"].append(np.full(n, o, np.int32))
        base += od["desc"].shape[0]
    empty = dict(xpos=(0,), ypos=(0,), sigma=(0,), num_ori=(0,),
                 orientation=(0, 4), desc_idx=(0, 4), debug_octave=(0,))
    res = {k: (np.concatenate(v, axis=0) if v else np.zeros(empty[k]))
           for k, v in out.items()}
    descs = [od["desc"] for od in parts]
    res["descriptors"] = (np.concatenate(descs, axis=0) if descs
                          else np.zeros((0, 128), np.float32))
    return res
