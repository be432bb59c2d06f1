"""Distinct float32 photographs: seeded windows into a few fixed canvases.

A photograph here is a band-limited random texture in [0, 1], float32,
as AliceVision hands PopSift its images (FloatImages).  Each canvas sums
the bands of ``synthetic.make_scene`` (cells of 128 down to 8 pixels,
1/f-like amplitudes, its two finest halved), three coarser ones (1,024,
512 and 256 pixels), so that the small octaves of a 24 MP frame (3 to 5,
188x125 pixels at the smallest) carry features as a photograph's do, and
smooths them three times as ``make_scene`` does.  A request is the
(height, width) window at a seeded offset into one of the canvases,
``margin`` pixels larger than the frame each way, drawn from the seed
without replacement as in ``synthetic``.  The canvases are the same for
every seed.  They are built with torch on the host's cores, the
random grids from numpy's seeded generator.
"""

from __future__ import annotations

import numpy as np
import torch

from . import synthetic

# make_scene's bands, its two finest at half their amplitude, under three
# coarser ones: at a threshold of 0.005 a 6000x4000 frame has 27,000-
# 31,000 extrema in octave 0, under a third of the 100,000 an octave may
# keep, and 57,000-62,000 in its six octaves
BANDS = ((1024, 2.0), (512, 1.6), (256, 1.3), (128, 1.0), (64, 0.6),
         (32, 0.35), (16, 0.1), (8, 0.05))


def make_canvas(seed, h: int, w: int) -> np.ndarray:
    """Band-limited random texture, float32 in [0, 1]."""
    rng = np.random.default_rng(seed)
    img = torch.zeros((h, w), dtype=torch.float32)
    for cell, amp in BANDS:
        gh, gw = h // cell + 2, w // cell + 2
        base = torch.from_numpy(rng.random((gh, gw)).astype(np.float32))
        up = base[:, None, :, None].expand(gh, cell, gw, cell) \
            .reshape(gh * cell, gw * cell)[:h, :w]
        img.add_(up, alpha=amp)
    for _ in range(3):
        img = (img + img.roll(1, 0) + img.roll(-1, 0) + img.roll(1, 1)
               + img.roll(-1, 1)) / 5.0
    lo, hi = img.min(), img.max()
    return ((img - lo) / (hi - lo)).numpy()


class Generator(synthetic.Generator):
    """``params``: ``width``, ``height``, ``canvases``, ``margin``;
    ``describe`` and ``request`` as ``synthetic``'s, a request a float32
    view into its canvas."""

    def __init__(self, params: dict, seed: int) -> None:
        self.w, self.h = int(params["width"]), int(params["height"])
        m = int(params["margin"])
        n = int(params["canvases"])
        self.canvases = [make_canvas([synthetic.PURPOSE_CANVAS, c],
                                     self.h + m, self.w + m)
                         for c in range(n)]
        self.offsets = m + 1
        self.order = np.random.default_rng(
            [seed, synthetic.PURPOSE_ORDER]).permutation(
                n * self.offsets * self.offsets)
