"""Pairs of photographs in the shape of the Oxford affine protocol.

The scenes are the repository's 640x480 photographs, copied under
``benchmark/data/scenes``.  Each scene's img2..img6 apply one Oxford
transformation family at rising magnitude (zoom and rotation, Gaussian
blur, a viewpoint-like affine, decreasing light, JPEG compression, read
from the checked-in round trips); a copy in numpy of
popsift_torch/eval/oxford.py:make_sequence and
eval/repeatability.py:warp_affine.  The pairs are (img1, imgk), k = 2..6,
of every scene, in a seeded order that is drawn anew for each pass over
them.  Every image a run hands the program carries its own ±1 grey-level
dither, a window at a seeded offset (drawn without replacement) into one
seeded sign field, so no two requests are the same bytes.
"""

from __future__ import annotations

import math

import numpy as np

from ..lib.spec import BENCH_DIR

PURPOSE_DITHER, PURPOSE_OFFSETS, PURPOSE_ORDER = 1, 2, 3
JPEG_QUALITIES = (75, 50, 30, 18, 10)


def read_pgm(path) -> np.ndarray:
    """A binary (P5) 8-bit PGM."""
    with open(path, "rb") as f:
        data = f.read()
    fields, pos = [], 0
    while len(fields) < 4:
        while data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.index(b"\n", pos)
            continue
        end = pos
        while not data[end:end + 1].isspace():
            end += 1
        fields.append(data[pos:end])
        pos = end
    if fields[0] != b"P5" or int(fields[3]) != 255:
        raise ValueError(f"{path}: not an 8-bit binary PGM")
    w, h = int(fields[1]), int(fields[2])
    return np.frombuffer(data, np.uint8, w * h, pos + 1).reshape(h, w)


def gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    span = max(int(math.ceil(3 * sigma)), 1)
    xs = np.arange(-span, span + 1, dtype=np.float64)
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    k /= k.sum()
    f = np.pad(img.astype(np.float64), span, mode="edge")
    h, w = img.shape
    rows = sum(k[i] * f[:, i:i + w] for i in range(k.size))
    out = sum(k[i] * rows[i:i + h, :] for i in range(k.size))
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def warp_affine(img: np.ndarray, A: np.ndarray, t: np.ndarray) -> np.ndarray:
    """out(p) = img(A^-1 (p - t)), bilinear, edges clamped."""
    h, w = img.shape
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    A_inv = np.linalg.inv(A)
    sx = A_inv[0, 0] * (xs - t[0]) + A_inv[0, 1] * (ys - t[1])
    sy = A_inv[1, 0] * (xs - t[0]) + A_inv[1, 1] * (ys - t[1])
    x0 = np.clip(np.floor(sx).astype(int), 0, w - 1)
    y0 = np.clip(np.floor(sy).astype(int), 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    fx = np.clip(sx - np.floor(sx), 0, 1)
    fy = np.clip(sy - np.floor(sy), 0, 1)
    v = (img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x1] * fx * (1 - fy)
         + img[y1, x0] * (1 - fx) * fy + img[y1, x1] * fx * fy)
    return v.astype(img.dtype)


def sequence(img: np.ndarray, family: str, name: str) -> list[np.ndarray]:
    """img2..img6 of one scene."""
    h, w = img.shape
    c = np.array([w / 2.0, h / 2.0])
    out = []
    for k in range(1, 6):
        if family == "blur":
            out.append(gaussian_blur(img, 0.8 * k))
        elif family == "jpeg":
            out.append(read_pgm(BENCH_DIR / "data" / "scenes" / "jpeg"
                                / f"{name}-q{JPEG_QUALITIES[k - 1]}.pgm"))
        elif family == "light":
            out.append(np.clip(np.round(img * (1.0 - 0.15 * k)), 0, 255)
                       .astype(np.uint8))
        elif family == "zoomrot":
            ang = math.radians(6.0 * k)
            A = 1.0 / (1.0 + 0.08 * k) * np.array(
                [[math.cos(ang), -math.sin(ang)],
                 [math.sin(ang), math.cos(ang)]])
            out.append(warp_affine(img, A, c - A @ c))
        elif family == "viewpoint":
            A = np.array([[1.0 - 0.05 * k, 0.08 * k], [0.0, 1.0]])
            out.append(warp_affine(img, A, c - A @ c))
        else:
            raise ValueError(f"unknown family {family!r}")
    return out


class Generator:
    """``params``: ``scenes`` (scene name -> family) and ``dither_margin``,
    the pixels the sign field exceeds an image by each way."""

    def __init__(self, params: dict, seed: int) -> None:
        self.seed = seed
        self.images = {}
        for name, family in params["scenes"].items():
            img1 = read_pgm(BENCH_DIR / "data" / "scenes" / f"{name}.pgm")
            self.images[(name, 1)] = img1.astype(np.int16)
            for k, im in enumerate(sequence(img1, family, name), start=2):
                self.images[(name, k)] = im.astype(np.int16)
        self.pairs = [(name, k) for name in params["scenes"]
                      for k in range(2, 7)]
        self.h, self.w = self.images[self.pairs[0][0], 1].shape
        m = int(params["dither_margin"])
        rng = np.random.default_rng([seed, PURPOSE_DITHER])
        self.signs = (rng.integers(0, 2, (self.h + m, self.w + m),
                                   dtype=np.int16) * 2 - 1)
        self.offsets = m + 1
        self.offset_order = np.random.default_rng(
            [seed, PURPOSE_OFFSETS]).permutation(self.offsets ** 2)
        self._orders = {}

    def describe(self, i: int) -> tuple[str, int, int, int]:
        """(scene, k, offset of img1's dither, offset of imgk's)."""
        cycle, j = divmod(i, len(self.pairs))
        if cycle not in self._orders:
            self._orders[cycle] = np.random.default_rng(
                [self.seed, PURPOSE_ORDER, cycle]).permutation(
                    len(self.pairs))
        name, k = self.pairs[int(self._orders[cycle][j])]
        if 2 * i + 1 >= self.offset_order.size:
            raise RuntimeError(f"the traffic has {self.offset_order.size} "
                               f"distinct dithers; request {i} would repeat "
                               f"one")
        return (name, k, int(self.offset_order[2 * i]),
                int(self.offset_order[2 * i + 1]))

    def _dithered(self, key, offset: int) -> np.ndarray:
        dy, dx = divmod(offset, self.offsets)
        noise = self.signs[dy:dy + self.h, dx:dx + self.w]
        return np.clip(self.images[key] + noise, 0, 255).astype(np.uint8)

    def request(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        """Pair ``i``: (img1, imgk) of its scene, each dithered."""
        name, k, off1, offk = self.describe(i)
        return (self._dithered((name, 1), off1),
                self._dithered((name, k), offk))
