"""The traffic generators: the same seed gives the same requests, and no
two requests of a run carry the same bytes."""

import hashlib

import numpy as np
import pytest

from benchmark.inputs import oxford_pairs, synthetic
from benchmark.lib import spec

SEED = 2 ** 31 + 12345


def _digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


@pytest.fixture(scope="module")
def pairs_params():
    bench = spec.benchmark()
    return spec.config(bench, "oxford-match-640")["input"]


def test_synthetic_is_deterministic_and_distinct():
    params = dict(width=96, height=64, canvases=2, margin=8)
    a = synthetic.Generator(params, SEED)
    b = synthetic.Generator(params, SEED)
    c = synthetic.Generator(params, SEED + 1)
    frames = [a.request(i) for i in range(a.order.size)]
    assert all(f.shape == (64, 96) and f.dtype == np.uint8 for f in frames)
    assert all(np.array_equal(f, b.request(i)) for i, f in
               enumerate(frames[:50]))
    assert any(not np.array_equal(frames[i], c.request(i))
               for i in range(10))
    assert len({_digest(f) for f in frames}) == len(frames)
    assert a.describe(3) == b.describe(3)
    with pytest.raises(RuntimeError):
        a.request(a.order.size)


def test_synthetic_1080p_frames_are_windows_of_the_canvases():
    g = synthetic.Generator(dict(width=1920, height=1080, canvases=4,
                                 margin=96), SEED)
    assert g.order.size == 4 * 97 * 97
    c, dy, dx = g.describe(0)
    assert np.shares_memory(g.request(0), g.canvases[c])
    assert g.canvases[c].shape == (1176, 2016)


def test_pairs_are_deterministic_and_distinct(pairs_params):
    a = oxford_pairs.Generator(pairs_params, SEED)
    b = oxford_pairs.Generator(pairs_params, SEED)
    n = 90                                  # more than two passes of 40
    seen = set()
    for i in range(n):
        x1, xk = a.request(i)
        y1, yk = b.request(i)
        assert np.array_equal(x1, y1) and np.array_equal(xk, yk)
        assert x1.shape == (480, 640) and xk.dtype == np.uint8
        seen.update((_digest(x1), _digest(xk)))
    assert len(seen) == 2 * n
    first = [a.describe(i)[:2] for i in range(40)]
    assert sorted(first) == sorted(a.pairs) and len(a.pairs) == 40
    assert first != [a.describe(i)[:2] for i in range(40, 80)]


def test_pairs_dither_is_one_grey_level(pairs_params):
    g = oxford_pairs.Generator(pairs_params, SEED)
    name, k, _, _ = g.describe(5)
    x1, xk = g.request(5)
    d1 = x1.astype(int) - g.images[(name, 1)]
    dk = xk.astype(int) - g.images[(name, k)]
    assert np.abs(d1).max() == 1 and np.abs(dk).max() == 1
    assert (d1 != 0).mean() > 0.9
