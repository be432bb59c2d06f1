"""The port's grid filter (``popsift_torch/ops/filtergrid.py``) against
popsift_tpu's on the CPU.

* **Keep masks and recompaction**, on synthetic multi-octave extrema in
  all three GridFilterModes: the port's compact per-octave ``Extrema``
  against the JAX package's padded ``InitialExtrema`` holding the same
  extrema in their valid leading slots.  Cells include ids past the last
  cell and below 0 (both packages clip them), scales include exact ties
  (the sort is stable), and the cases sit below, at and above the trigger
  ``budget * 1.1 < total`` and where the integer division of the cell
  budget truncates.  Masks and recompacted extrema must be equal exactly.
* **The trigger** against the JAX package's float32 comparison, at totals
  around the boundary where float32 rounds.
* **End to end**: ``filter_max_extrema=100`` in each mode, on the two
  images and with the tolerances of ``torch_parity.py``, against the JAX
  package's jitted extractor; the JAX package's own unfiltered extrema
  of the textured image must exceed the trigger, and the filter must
  have dropped features.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_parity as tp  # noqa: E402

from popsift_tpu import config as jcfg  # noqa: E402
from popsift_tpu import extract as jext  # noqa: E402
from popsift_tpu import gauss as jgauss  # noqa: E402
from popsift_tpu.ops import extrema as jext_ops  # noqa: E402
from popsift_tpu.ops import filtergrid as jfg  # noqa: E402
from popsift_tpu.ops import pyramid as jpyr  # noqa: E402

from popsift_torch import config as tcfg  # noqa: E402
from popsift_torch.ops import filtergrid as tfg  # noqa: E402
from popsift_torch.ops.extrema import Extrema  # noqa: E402

MODES = list(tcfg.GridFilterMode)

# (per-octave counts, grid size, budget)
CASES = {
    "below": ((5, 3, 2), 2, 20),
    "at": ((60, 30, 20), 2, 100),        # 110: float32(110.00..02) = 110
    "above": ((60, 31, 20), 2, 100),     # 111
    "truncates": ((40, 12, 5), 3, 20),
    "large": ((600, 300, 150, 50), 4, 500),
}


def _synthetic(counts, grid, seed):
    """Per octave (port Extrema, JAX InitialExtrema with 7 padding
    slots)."""
    rng = np.random.default_rng(seed)
    n_cells = grid * grid
    port, jax_ = [], []
    for n in counts:
        # cells skewed to a few, with some past the last cell and below 0
        cell = rng.choice(np.arange(-1, n_cells + 2), size=n,
                          p=_skew(n_cells + 3, rng)).astype(np.int32)
        sigma = np.where(rng.random(n) < 0.5,
                         rng.choice([1.6, 2.0, 2.5], size=n),
                         1.6 + 2.0 * rng.random(n)).astype(np.float32)
        x = rng.random(n).astype(np.float32) * 100
        y = rng.random(n).astype(np.float32) * 80
        lpos = rng.integers(1, 4, n).astype(np.int32)
        port.append(Extrema(
            xpos=torch.as_tensor(x), ypos=torch.as_tensor(y),
            lpos=torch.as_tensor(lpos), sigma=torch.as_tensor(sigma),
            cell=torch.as_tensor(cell), count=n, overflow=3))
        pad = 7

        def padded(a, fill):
            return jnp.asarray(np.concatenate([a, np.full(pad, fill,
                                                          a.dtype)]))
        jax_.append(jext_ops.InitialExtrema(
            xpos=padded(x, 0), ypos=padded(y, 0), lpos=padded(lpos, 1),
            sigma=padded(sigma, 0), cell=padded(cell, 0),
            valid=jnp.asarray([True] * n + [False] * pad),
            count=jnp.int32(n), overflow=jnp.int32(3)))
    return port, jax_


def _skew(n, rng):
    p = rng.random(n) ** 3 + 0.02
    return p / p.sum()


def _ct(port, grid, budget):
    """The number of cells over the budget (s_filtergrid.cu:225-257),
    recomputed in numpy, never less than 1."""
    n_cells = grid * grid
    cell = np.clip(np.concatenate([e.cell.numpy() for e in port]), 0,
                   n_cells - 1)
    cnt = np.sort(np.bincount(cell, minlength=n_cells))
    sumup = cnt * np.arange(n_cells - 1, -1, -1) + np.cumsum(cnt)
    return max(int((sumup > budget).sum()), 1)


@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.value)
@pytest.mark.parametrize("case", list(CASES))
def test_keep_masks_and_recompact_match(case, mode):
    counts, grid, budget = CASES[case]
    port, jexts = _synthetic(counts, grid, seed=len(case))
    jmode = jcfg.GridFilterMode(mode.value)
    jkeeps = jfg.grid_filter_keep_masks(jexts, budget, grid, jmode)
    keeps = tfg.grid_filter_keep_masks(port, budget, grid, mode)
    total = sum(counts)
    kept = 0
    for n, k, jk in zip(counts, keeps, jkeeps):
        assert k.dtype == torch.bool and k.shape == (n,)
        np.testing.assert_array_equal(k.numpy(), np.asarray(jk)[:n])
        assert not np.asarray(jk)[n:].any()
        kept += int(k.sum())
    fires = tfg.triggers(budget, total)
    assert fires == (case in ("above", "truncates", "large"))
    assert (kept < total) == fires
    if case == "truncates":
        assert (total - budget) % _ct(port, grid, budget) != 0
    for e, k, je, jk in zip(port, keeps, jexts, jkeeps):
        r = tfg.recompact(e, k)
        jr = jfg.recompact(je, jk)
        c = int(jr.count)
        assert r.count == c and r.overflow == int(jr.overflow) == 3
        for f in ("xpos", "ypos", "lpos", "sigma", "cell"):
            np.testing.assert_array_equal(getattr(r, f).numpy(),
                                          np.asarray(getattr(jr, f))[:c],
                                          err_msg=f)


@pytest.mark.parametrize("budget", [100, 1000, 15252015, 15252016,
                                    15252017, 2 ** 24])
def test_trigger_matches(budget):
    """budget * 1.1 < total in float32, as the JAX package compares."""
    edge = int(budget * 1.1)
    for total in range(edge - 3, edge + 4):
        want = bool(budget * 1.1 < jnp.asarray(total, jnp.int32)
                    .astype(jnp.float32))
        assert tfg.triggers(budget, total) == want, (budget, total)


@pytest.fixture(scope="module")
def jax_total(textured_image) -> int:
    """The JAX package's extrema of the textured image before the filter
    (find_extrema of every octave of build_pyramid_and_dogs), which the
    filter's settings do not change."""
    img = textured_image
    j = tp.jax_config(tcfg.Config())
    h, w = img.shape
    plan = jext.make_plan(j, w, h)
    gauss = jgauss.build_gauss_info(j)

    def fn(im):
        _, dogs = jpyr.build_pyramid_and_dogs(
            im, gauss, plan.dims, plan.levels, plan.gauss_mode,
            plan.scaling_mode, plan.sift_mode, plan.upscale_factor)
        return [jext_ops.find_extrema(
            dogs[o], plan.sift_mode, plan.sigma0, plan.sigma_k,
            plan.peak_threshold, plan.edge_limit, plan.filter_grid_size,
            plan.cand_caps[o], plan.ext_caps[o]).count
            for o in range(plan.octaves)]

    return int(sum(np.asarray(c) for c in
                   jax.jit(fn)(jext.normalize_input(img))))


@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.value)
def test_grid_filter_end_to_end(mode, textured_image, jax_total):
    cfg = tcfg.Config(filter_max_extrema=100, grid_filter_mode=mode)
    total = jax_total
    assert tfg.triggers(100, total), total
    tp.check_images(cfg, textured_image)
    got = tp.port_features(textured_image, cfg)
    assert got.get_feature_count() < total
