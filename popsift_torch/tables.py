"""Host tables carried across from the JAX package.

``from_numpy`` turns the fields of ``popsift_tpu.gauss.GaussInfo`` and
``popsift_tpu.constants.ConstInfo``, given as plain numpy arrays and
numbers, into this package's objects, so that both packages can be run on
identical tables.  ``to_numpy`` is its inverse.  Layout:

* ``gauss_arrays``: ``{"inc": {"sigma", "span", "filter"}, "abs_o0": ...,
  "abs_oN": ..., "dd": ..., "required_filter_stages": int}``;
* ``const_arrays``: one entry per ``ConstInfo`` field.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .constants import ConstInfo
from .gauss import GAUSS_ALIGN, GaussInfo, GaussTable

_FAMILIES = ("inc", "abs_o0", "abs_oN", "dd")


def _table(d) -> GaussTable:
    sigma = np.asarray(d["sigma"], np.float32)
    span = np.asarray(d["span"], np.int32)
    filt = np.asarray(d["filter"], np.float32)
    if filt.shape != (sigma.shape[0], GAUSS_ALIGN) \
            or span.shape != sigma.shape:
        raise ValueError(f"bad Gauss table shapes {sigma.shape}, "
                         f"{span.shape}, {filt.shape}")
    return GaussTable(sigma=sigma, span=span, filter=filt)


def from_numpy(gauss_arrays: dict, const_arrays: dict,
               device="cpu") -> tuple[GaussInfo, ConstInfo]:
    gauss = GaussInfo(
        **{f: _table(gauss_arrays[f]) for f in _FAMILIES},
        required_filter_stages=int(gauss_arrays["required_filter_stages"]))
    c = const_arrays
    consts = ConstInfo(
        sigma0=float(c["sigma0"]), sigma_k=float(c["sigma_k"]),
        edge_limit=float(c["edge_limit"]), threshold=float(c["threshold"]),
        max_extrema=int(c["max_extrema"]),
        max_orientations=int(c["max_orientations"]),
        norm_multi=int(c["norm_multi"]),
        desc_gauss=torch.as_tensor(
            np.asarray(c["desc_gauss"], np.float32), device=device),
        desc_tile=torch.as_tensor(
            np.asarray(c["desc_tile"], np.float32), device=device))
    return gauss, consts


def to_numpy(gauss: GaussInfo, consts: ConstInfo) -> tuple[dict, dict]:
    g = {f: {k: np.asarray(v) for k, v in
             dataclasses.asdict(getattr(gauss, f)).items()}
         for f in _FAMILIES}
    g["required_filter_stages"] = gauss.required_filter_stages
    c = {f.name: getattr(consts, f.name)
         for f in dataclasses.fields(consts)}
    c["desc_gauss"] = consts.desc_gauss.cpu().numpy()
    c["desc_tile"] = consts.desc_tile.cpu().numpy()
    return g, c
