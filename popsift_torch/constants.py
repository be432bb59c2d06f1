"""Derived constants (sift_constants.{h,cu}), a copy of popsift_tpu.constants."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .config import Config

# sift_constants.h:33-54
ORI_NBINS = 36
ORI_WINFACTOR = 1.5
DESC_BINS = 8
DESC_V_SIZE = 128
DESC_MAGNIFY = 3.0
ORIENTATION_MAX_COUNT = 4

M_PI = math.pi
M_PI2 = 2.0 * math.pi
M_4RPI = 4.0 / math.pi


@dataclasses.dataclass(frozen=True)
class ConstInfo:
    """init_constants (sift_constants.cu:22-53).  The two tables live on
    the device the extraction runs on."""

    sigma0: float
    sigma_k: float
    edge_limit: float
    threshold: float           # the peak threshold (popsift.cpp:100)
    max_extrema: int
    max_orientations: int
    norm_multi: int
    desc_gauss: torch.Tensor   # (40, 40) f32 window for grid/notile descs
    desc_tile: torch.Tensor    # (16,) f32 bilinear tile weights


def desc_tables() -> tuple[np.ndarray, np.ndarray]:
    """The 40x40 descriptor Gaussian (sift_constants.cu:34-42) and the
    16 bilinear tile weights (sift_constants.cu:44-47)."""
    dn_step = 1.0 / 8.0
    dn_base = 0.5 * dn_step - 20.0 * dn_step
    idx = np.arange(40, dtype=np.float32)
    dnx = (dn_base + idx * dn_step)[None, :]
    dny = (dn_base + idx * dn_step)[:, None]
    desc_gauss = np.exp(-((dnx * dnx + dny * dny) / 8.0)).astype(np.float32)
    i = np.arange(16, dtype=np.float32)
    nx = -1.0 + 1.0 / 16.0 + i * (1.0 / 8.0)
    desc_tile = (1.0 - np.abs(nx)).astype(np.float32)
    return desc_gauss, desc_tile


def build_const_info(config: Config, device="cpu") -> ConstInfo:
    desc_gauss, desc_tile = desc_tables()
    max_extrema = config.max_extrema
    return ConstInfo(
        sigma0=float(config.sigma),
        sigma_k=2.0 ** (1.0 / config.levels),
        edge_limit=float(config.edge_limit),
        threshold=float(config.get_peak_threshold()),
        max_extrema=max_extrema,
        max_orientations=max_extrema + max_extrema // 4,
        norm_multi=int(config.norm_multiplier),
        desc_gauss=torch.as_tensor(desc_gauss, device=device),
        desc_tile=torch.as_tensor(desc_tile, device=device),
    )
