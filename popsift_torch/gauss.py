"""Gaussian filter bank construction, a copy of popsift_tpu.gauss.

The four table families of the reference (gauss_filter.cu:127-257):

* ``inc``    - incremental level-to-level sigmas sqrt(s_l^2 - s_{l-1}^2)
* ``abs_o0`` - absolute-from-input sigmas for octave 0 (minus initial blur)
* ``abs_oN`` - level-0-to-level-N sigmas for octaves > 0
* ``dd``     - direct-downscale per-octave level-0 sigmas

The tables stay on the host as numpy arrays: the blur kernel receives its
taps by value at launch.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from .config import MAX_OCTAVES, Config, GaussMode

GAUSS_ALIGN = 32   # sift_constants.h:35
GAUSS_LEVELS = 12  # sift_constants.h:37


def _vlfeat_span(sigma: float) -> int:
    # gauss_filter.cu:301-307
    return min(int(math.ceil(4.0 * sigma)) + 1, GAUSS_ALIGN - 1)


def _span_for(mode: GaussMode, sigma: float) -> int:
    """Half-sided filter span including the centre tap
    (gauss_filter.cu:275-327)."""
    if mode in (GaussMode.VLFEAT_COMPUTE, GaussMode.VLFEAT_RELATIVE_ALL):
        return _vlfeat_span(sigma)
    if mode == GaussMode.VLFEAT_RELATIVE:
        spn = _vlfeat_span(sigma)
        return spn + 1 if spn % 2 == 0 else spn
    if mode == GaussMode.OPENCV_COMPUTE:
        span = int(round(2.0 * 4.0 * sigma + 1.0)) | 1
        return min((span >> 1) + 1, GAUSS_ALIGN - 1)
    if mode == GaussMode.FIXED9:
        return 5
    if mode == GaussMode.FIXED15:
        return 8
    raise ValueError(f"invalid Gauss span mode {mode}")


def _filter_from_sigma(mode: GaussMode, sigma: float):
    """One half-sided normalised Gaussian (gauss_filter.cu:341-371):
    un-normalised exp() taps, divided by centre + 2*sum(tail) where the
    reference accumulates each ``2.0f * val`` in float."""
    span = min(_span_for(mode, sigma), GAUSS_ALIGN - 1)
    taps = np.zeros(GAUSS_ALIGN, dtype=np.float64)
    taps[0] = 1.0
    acc = 1.0
    for x in range(1, span):
        val = math.exp(-0.5 * (float(x) / sigma) ** 2)
        taps[x] = val
        acc += np.float32(2.0 * val)
    taps[:span] /= acc
    return taps.astype(np.float32), span


@dataclasses.dataclass(frozen=True)
class GaussTable:
    """One family of per-level filters."""

    sigma: np.ndarray   # (levels,) f32
    span: np.ndarray    # (levels,) i32
    filter: np.ndarray  # (levels, GAUSS_ALIGN) f32


def _build_table(mode: GaussMode, sigmas: list[float]) -> GaussTable:
    spans, filters = [], []
    for s in sigmas:
        if s > 0.0:
            f, spn = _filter_from_sigma(mode, s)
        else:
            f = np.zeros(GAUSS_ALIGN, dtype=np.float32)
            f[0] = 1.0
            spn = 1
        spans.append(spn)
        filters.append(f)
    return GaussTable(sigma=np.asarray(sigmas, dtype=np.float32),
                      span=np.asarray(spans, dtype=np.int32),
                      filter=np.stack(filters))


@dataclasses.dataclass(frozen=True)
class GaussInfo:
    """All four filter families (gauss_filter.h:62-82)."""

    inc: GaussTable
    abs_o0: GaussTable
    abs_oN: GaussTable
    dd: GaussTable
    required_filter_stages: int


def build_gauss_info(config: Config) -> GaussInfo:
    """init_filter (gauss_filter.cu:127-257) without the device upload."""
    sigma0 = float(config.sigma)
    levels = int(config.levels)
    if sigma0 > 2.0:
        raise ValueError("Sigma > 2.0 is not supported.")
    if levels > GAUSS_LEVELS:
        raise ValueError(f"More than {GAUSS_LEVELS} levels not supported.")
    mode = config.gauss_mode
    stages = levels + 3
    initial_blur = (config.initial_blur * (2.0 ** config.upscale_factor)
                    if config.assume_initial_blur else 0.0)

    if config.assume_initial_blur:
        inc_sigmas = [math.sqrt(abs(sigma0 * sigma0
                                    - initial_blur * initial_blur))]
    else:
        inc_sigmas = [sigma0]
    for lvl in range(1, stages):
        sp = sigma0 * 2.0 ** ((lvl - 1) / levels)
        ss = sigma0 * 2.0 ** (lvl / levels)
        inc_sigmas.append(math.sqrt(ss * ss - sp * sp))

    abs_o0_sigmas = []
    for lvl in range(stages):
        ss = sigma0 * 2.0 ** (lvl / levels)
        abs_o0_sigmas.append(
            math.sqrt(abs(ss * ss - initial_blur * initial_blur)))

    abs_oN_sigmas = [0.0]
    for lvl in range(1, stages):
        ss = sigma0 * 2.0 ** (lvl / levels)
        abs_oN_sigmas.append(math.sqrt(ss * ss - sigma0 * sigma0))

    dd_sigmas = []
    for octv in range(MAX_OCTAVES):
        oct_sigma = math.ldexp(sigma0, octv)
        b = math.sqrt(abs(oct_sigma * oct_sigma - initial_blur * initial_blur))
        dd_sigmas.append(math.ldexp(b, -octv))

    return GaussInfo(inc=_build_table(mode, inc_sigmas),
                     abs_o0=_build_table(mode, abs_o0_sigmas),
                     abs_oN=_build_table(mode, abs_oN_sigmas),
                     dd=_build_table(mode, dd_sigmas),
                     required_filter_stages=stages)


def format_gauss_tables(info: GaussInfo, columns: int = 10) -> str:
    """Debug dump in the spirit of print_gauss_filter_symbol
    (gauss_filter.cu:24-121); used by --print-gauss-tables."""
    out = []

    def emit(title: str, table: GaussTable, rows: int) -> None:
        out.append(title)
        for lvl in range(rows):
            spn = int(table.span[lvl])
            full = spn + spn - 1
            m = min(spn, columns)
            taps = " ".join(f"{table.filter[lvl, x]:0.8f}" for x in range(m))
            tail = " ..." if m < spn else ""
            out.append(f"      {lvl} {full} {table.sigma[lvl]:2.6f}: "
                       f"{taps}{tail}")
        out.append("")

    n = info.required_filter_stages
    emit("Gauss tables (incremental)", info.inc, n)
    emit("Gauss tables, absolute filters octave 0", info.abs_o0, n)
    emit("Gauss tables, absolute filters other octaves", info.abs_oN, n)
    emit("Level 0-filters for direct downscaling", info.dd,
         len(info.dd.sigma))
    return "\n".join(out)
