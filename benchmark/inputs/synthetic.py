"""Distinct synthetic frames: seeded windows into a few fixed canvases.

Each canvas is a band-limited random texture with a 1/f-like spectrum
(``make_scene``, a copy of chip_smoke.py's scene generator), which gives a
1080p frame about as many SIFT features as real footage (2,300-2,500).
A frame is the (height, width) window at a seeded offset into one of
the canvases, ``margin`` pixels larger than the frame each way; the
(canvas, offset) pairs of a run are drawn from the seed without
replacement, so no two frames of a run are the same bytes.  The canvases
are the same for every seed: a seed picks other windows of the same
scenes, so every seed asks for the same work, in another order (with a
canvas per seed, the runs' rates followed their seeds by up to 15%).
"""

from __future__ import annotations

import numpy as np

PURPOSE_CANVAS, PURPOSE_ORDER = 1, 2


def make_scene(seed, h: int, w: int) -> np.ndarray:
    """Band-limited random texture (1/f-like spectrum), uint8."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), np.float32)
    for cell, amp in ((128, 1.0), (64, 0.6), (32, 0.35), (16, 0.2),
                      (8, 0.1)):
        base = rng.random((h // cell + 2, w // cell + 2)).astype(np.float32)
        up = np.kron(base, np.ones((cell, cell), np.float32))[:h, :w]
        img += amp * up
    for _ in range(3):
        img = (img + np.roll(img, 1, 0) + np.roll(img, -1, 0)
               + np.roll(img, 1, 1) + np.roll(img, -1, 1)) / 5.0
    img = (img - img.min()) / (img.max() - img.min())
    return (img * 255).astype(np.uint8)


class Generator:
    """``params``: ``width``, ``height``, ``canvases``, ``margin``."""

    def __init__(self, params: dict, seed: int) -> None:
        self.w, self.h = int(params["width"]), int(params["height"])
        m = int(params["margin"])
        n = int(params["canvases"])
        self.canvases = [make_scene([PURPOSE_CANVAS, c], self.h + m,
                                    self.w + m) for c in range(n)]
        self.offsets = m + 1
        self.order = np.random.default_rng([seed, PURPOSE_ORDER]) \
            .permutation(n * self.offsets * self.offsets)

    def describe(self, i: int) -> tuple[int, int, int]:
        """(canvas, dy, dx) of request ``i``."""
        if i >= self.order.size:
            raise RuntimeError(f"the traffic has {self.order.size} distinct "
                               f"frames; request {i} would repeat one")
        k = int(self.order[i])
        c, rest = divmod(k, self.offsets * self.offsets)
        dy, dx = divmod(rest, self.offsets)
        return c, dy, dx

    def request(self, i: int) -> np.ndarray:
        """Frame ``i``: a (height, width) uint8 view into its canvas."""
        c, dy, dx = self.describe(i)
        return self.canvases[c][dy:dy + self.h, dx:dx + self.w]
