"""User-facing feature containers (popsift_tpu/features.py).

:class:`FeaturesHost` keeps numpy structure-of-arrays features and the
descriptor matrix, with the STL-style iteration and the ``print`` text
format of the reference (features.cu:310-330).  :class:`FeaturesDev`
(MatchingMode) keeps the descriptor matrix on the pipeline's device, with
the reverse descriptor-to-feature map and a brute-force :meth:`match`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator

import numpy as np
import torch

from . import tracing
from .constants import ORIENTATION_MAX_COUNT


@dataclasses.dataclass
class Feature:
    """One keypoint (features.h:23-37)."""

    xpos: float
    ypos: float
    sigma: float
    num_ori: int
    orientation: np.ndarray        # (ORIENTATION_MAX_COUNT,)
    desc_idx: np.ndarray           # indices into the descriptors (-1 pad)
    debug_octave: int
    _descriptors: np.ndarray | None = None  # (num_desc, 128)

    @property
    def desc(self) -> list[np.ndarray | None]:
        return [self._descriptors[int(i)] if int(i) >= 0 else None
                for i in self.desc_idx[:ORIENTATION_MAX_COUNT]]

    def print(self, ostr, write_as_uchar: bool = False) -> None:
        """Text output format of Feature::print (features.cu:310-330)."""
        sigval = 1.0 / (self.sigma * self.sigma)
        for ori in range(self.num_ori):
            d = self._descriptors[int(self.desc_idx[ori])]
            ostr.write(f"{_g(self.xpos)} {_g(self.ypos)} "
                       f"{_g(sigval)} 0 {_g(sigval)} ")
            if write_as_uchar:
                # roundf = half away from zero (features.cu:318), not
                # Python's round-half-to-even
                ostr.write(" ".join(
                    str(int(math.copysign(math.floor(abs(float(v)) + 0.5),
                                          float(v)))) for v in d))
            else:
                ostr.write(" ".join(_g3(float(v)) for v in d))
            ostr.write(" \n")


def _g(v: float) -> str:
    """C++ ostream default float formatting (6 significant digits)."""
    return f"{v:.6g}"


def _g3(v: float) -> str:
    """setprecision(3) used for descriptor values (features.cu:322)."""
    return f"{v:.3g}"


class FeaturesBase:
    """features.h:41-56."""

    def __init__(self) -> None:
        self._num_ext = 0
        self._num_ori = 0

    def get_feature_count(self) -> int:
        return self._num_ext

    def get_descriptor_count(self) -> int:
        return self._num_ori


class FeaturesHost(FeaturesBase):
    """Host-side features: numpy SoA + iteration (features.h:69-104)."""

    _EMPTY = dict(
        xpos=((0,), np.float32), ypos=((0,), np.float32),
        sigma=((0,), np.float32), num_ori=((0,), np.int32),
        orientation=((0, ORIENTATION_MAX_COUNT), np.float32),
        desc_idx=((0, ORIENTATION_MAX_COUNT), np.int64),
        debug_octave=((0,), np.int32))

    def __init__(self, features: list[Feature] | None = None,
                 descriptors: np.ndarray | None = None,
                 soa: dict | None = None) -> None:
        super().__init__()
        self._descriptors = (descriptors if descriptors is not None
                             else np.zeros((0, 128), np.float32))
        self._num_ori = int(self._descriptors.shape[0])
        if soa is None:
            soa = {k: np.zeros(shape, dt)
                   for k, (shape, dt) in self._EMPTY.items()}
            if features:
                soa = {k: np.stack([np.asarray(getattr(f, k), dt)
                                    for f in features])
                       for k, (_, dt) in self._EMPTY.items()}
        self._soa = soa
        self._num_ext = int(self._soa["xpos"].shape[0])

    def get_features(self) -> list[Feature]:
        return [self[i] for i in range(self._num_ext)]

    def get_descriptors(self) -> np.ndarray:
        return self._descriptors

    def soa(self) -> dict:
        """The feature arrays by name (xpos, ypos, sigma, num_ori,
        orientation, desc_idx, debug_octave)."""
        return self._soa

    def size(self) -> int:
        return self._num_ext

    def __len__(self) -> int:
        return self._num_ext

    def __iter__(self) -> Iterator[Feature]:
        for i in range(self._num_ext):
            yield self[i]

    def __getitem__(self, i: int) -> Feature:
        s = self._soa
        return Feature(
            xpos=float(s["xpos"][i]), ypos=float(s["ypos"][i]),
            sigma=float(s["sigma"][i]), num_ori=int(s["num_ori"][i]),
            orientation=s["orientation"][i], desc_idx=s["desc_idx"][i],
            debug_octave=int(s["debug_octave"][i]),
            _descriptors=self._descriptors)

    def print(self, ostr, write_as_uchar: bool = False) -> None:
        for f in self:
            f.print(ostr, write_as_uchar)

    def pin(self) -> None:
        """FeaturesHost::pin (features.cu:86-105); the arrays are host
        numpy arrays already, so this does nothing."""

    def unpin(self) -> None:
        """FeaturesHost::unpin (features.cu:107-111)."""


class FeaturesDev(FeaturesBase):
    """Device-resident features for MatchingMode (features.h:106-122):
    ``features``, a dict of numpy ``xpos, ypos, sigma`` (scaled to the
    input image) and ``num_ori``; ``descriptors``, an (m, 128) float32
    tensor on the pipeline's device; ``reverse_map``, the numpy int64
    feature index of each descriptor row."""

    def __init__(self, features: dict, descriptors: torch.Tensor,
                 reverse_map: np.ndarray) -> None:
        super().__init__()
        self._ext = features
        self._ori = descriptors
        self._rev = reverse_map
        self._num_ext = int(features["xpos"].shape[0])
        self._num_ori = int(descriptors.shape[0])

    def get_features(self) -> dict:
        return self._ext

    def get_descriptors(self) -> torch.Tensor:
        return self._ori

    def get_reverse_map(self) -> np.ndarray:
        return self._rev

    def match(self, other: "FeaturesDev", ratio: float = 0.8):
        """Brute-force match on the descriptors' device; returns numpy
        (best_idx, second_idx, accept, best_dist, second_dist)
        (FeaturesDev::match, features.cu:267-304).  With the recorder on,
        the call is a ``match`` host span and each of its five copies to
        the host a ``readback.match`` span inside it."""
        from .ops.match import match_brute_force
        sp = tracing.begin("match") if tracing.HOSTTRACE else None
        out = match_brute_force(self._ori, other._ori, ratio=ratio)
        out = tuple(tracing.to_host(t, "readback.match") for t in out)
        if sp is not None:
            tracing.end(sp)
        return out

    def match_and_print(self, other: "FeaturesDev", ostr,
                        ratio: float = 0.8) -> None:
        """show_distance-style report (features.cu:230-265)."""
        best, second, accept, d1, d2 = self.match(other, ratio)
        l_rev = np.asarray(self._rev)
        r_rev = np.asarray(other._rev)
        for i in range(self._num_ori):
            verdict = "accept" if accept[i] else "reject"
            ostr.write(
                f"{verdict} feat {l_rev[i]:4d} [{i:4d}] matches feat "
                f"{r_rev[best[i]]:4d} [{best[i]:4d}] ( 2nd feat "
                f"{r_rev[second[i]]:4d} [{second[i]:4d}] ) "
                f"dist {d1[i]:.3f} vs {d2[i]:.3f}\n")


Features = FeaturesHost


def _assemble_soa(octaves: list[dict], upscale_factor: float) -> dict:
    """The feature arrays of :func:`assemble_features` (all but the
    descriptors)."""
    parts = {k: [] for k in FeaturesHost._EMPTY}
    base = 0
    kk = np.arange(ORIENTATION_MAX_COUNT, dtype=np.int64)[None, :]
    for o, od in enumerate(octaves):
        n = od["x"].shape[0]
        if n:
            scale = np.float32(2.0 ** (o - upscale_factor))
            num = od["num_ori"].astype(np.int32)
            idx0 = base + np.cumsum(num, dtype=np.int64) - num
            keep = kk < num[:, None]
            parts["xpos"].append(od["x"] * scale)
            parts["ypos"].append(od["y"] * scale)
            parts["sigma"].append(od["sigma"] * scale)
            parts["num_ori"].append(num)
            parts["orientation"].append(
                np.where(keep, od["orientations"], np.float32(0.0))
                .astype(np.float32))
            parts["desc_idx"].append(np.where(keep, idx0[:, None] + kk, -1))
            parts["debug_octave"].append(np.full(n, o, np.int32))
        base += od["desc"].shape[0]
    return {k: (np.concatenate(v, axis=0) if v
                else np.zeros(*FeaturesHost._EMPTY[k]))
            for k, v in parts.items()}


def assemble_features(octaves: list[dict],
                      upscale_factor: float) -> FeaturesHost:
    """Host features from per-octave results (prep_features,
    sift_pyramid.cu:250-280): coordinates and sigma scaled by
    2^(octave - upscale), octaves in ascending order, descriptor rows in
    feature order.

    Each ``octaves[o]`` holds numpy arrays ``x, y, sigma`` (count,),
    ``num_ori`` (count,) already clamped to the descriptor rows the octave
    produced, ``orientations`` (count, 4) and ``desc`` (rows, 128)."""
    soa = _assemble_soa(octaves, upscale_factor)
    descs = [od["desc"] for od in octaves]
    descriptors = (np.concatenate(descs, axis=0) if descs
                   else np.zeros((0, 128), np.float32))
    return FeaturesHost(descriptors=descriptors, soa=soa)


def assemble_features_dev(octaves: list[dict], upscale_factor: float,
                          device) -> FeaturesDev:
    """:func:`assemble_features` with the descriptors left where they are
    (clone_device_descriptors, sift_pyramid.cu:324-362): each
    ``octaves[o]["desc"]`` is a float32 tensor on ``device``, and the
    matrix is their concatenation there.  The features are the host
    features' ``xpos, ypos, sigma, num_ori``; the reverse map repeats each
    feature's index by its ``num_ori``, as the JAX package's packed path
    derives it (popsift_tpu/staged.py:1402-1412)."""
    soa = _assemble_soa(octaves, upscale_factor)
    descs = [od["desc"] for od in octaves]
    descriptors = (torch.cat(descs, dim=0) if descs
                   else torch.zeros((0, 128), dtype=torch.float32,
                                    device=device))
    num = soa["num_ori"]
    m = int(descriptors.shape[0])
    rev = np.repeat(np.arange(num.shape[0], dtype=np.int64), num)[:m]
    features = {k: soa[k] for k in ("xpos", "ypos", "sigma", "num_ori")}
    return FeaturesDev(features, descriptors, rev)
