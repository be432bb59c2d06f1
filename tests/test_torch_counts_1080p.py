"""Refinement counts at a 1080p octave: the port against the JAX package.

chip_smoke.py's seed-0 1080p scene, octave 2 (5 DoG layers of 540x960,
the busiest octave: about 1580 candidates after the compaction budget).
Each side builds its own pyramid of octaves 0-2 from the image: the JAX
package's ``build_pyramid_and_dogs`` (XLA:CPU) and the port's per-level
form on the CPU.

- On the JAX DoG, the port's ``extract.octave_keypoints`` must give JAX
  ``find_extrema``'s candidates and extrema exactly: the same counts and
  overflows, lpos, and positions within 1e-4 px (XLA:CPU contracts some
  multiply-adds of the 3x3 solve into FMAs, as test_torch_extrema.py
  states).
- On its own DoG, the port's levels differ from XLA:CPU's in the last bit
  (XLA contracts the blur's multiply-adds into FMAs; the port rounds each
  operation, as its kernels do), and over three octaves that moves a few
  extrema: a candidate's refinement crosses a threshold or lands
  elsewhere.  The extrema without a counterpart within 1e-2 px on the
  other side are counted and bounded at 1% of the octave's extrema.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from popsift_tpu import config as jcfg  # noqa: E402
from popsift_tpu import extract as jext  # noqa: E402
from popsift_tpu import gauss as jgauss  # noqa: E402
from popsift_tpu.ops import extrema as jex  # noqa: E402
from popsift_tpu.ops import pyramid as jpyr  # noqa: E402

import popsift_torch as pt  # noqa: E402
from popsift_torch import extract as text  # noqa: E402
from popsift_torch.gauss import build_gauss_info  # noqa: E402
from popsift_torch.ops import pyramid as tpyr  # noqa: E402

OCTAVE = 2


def _scene() -> np.ndarray:
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make_scene(0, 1080, 1920)


def _unmatched(a, b, tol=1e-2) -> int:
    """Extrema of ``a`` (x, y, lpos) with no extremum of ``b`` at the same
    lpos within ``tol`` px."""
    d = np.hypot(a[0][:, None] - b[0][None, :], a[1][:, None] - b[1][None, :])
    d = np.where(a[2][:, None] == b[2][None, :], d, np.inf)
    return int((d.min(axis=1) > tol).sum()) if b[0].size else a[0].size


def test_octave_counts_match_jax_at_1080p():
    scene = _scene()
    cfg = pt.Config()
    plan = text.make_plan(cfg, 1920, 1080)
    gauss = build_gauss_info(cfg)
    src = text.to_unit_image(scene, "cpu")
    for o in range(OCTAVE + 1):
        src, own_dog = tpyr.build_octave(src, o, plan.dims, plan.levels,
                                         gauss, plan.sift_mode,
                                         plan.upscale_factor)

    jc = jcfg.Config()
    jplan = jext.make_plan(jc, 1920, 1080)
    jg = jgauss.build_gauss_info(jc)

    def jax_octave(im):
        im = im.astype(jnp.float32) * (1.0 / 255.0)
        dog = jpyr.build_pyramid_and_dogs(
            im, jg, jplan.dims[:OCTAVE + 1], jplan.levels, jplan.gauss_mode,
            jplan.scaling_mode, jplan.sift_mode, jplan.upscale_factor)[1][-1]
        e = jex.find_extrema(dog, jplan.sift_mode, jplan.sigma0,
                             jplan.sigma_k, jplan.peak_threshold,
                             jplan.edge_limit, jplan.filter_grid_size,
                             jplan.cand_caps[OCTAVE], jplan.ext_caps[OCTAVE])
        c = jex.compact_mask(jex.detect_candidates(
            dog, jplan.sift_mode, jplan.peak_threshold),
            jplan.cand_caps[OCTAVE])
        return dog, e, c[4], c[5]

    jdog, je, jcand, jcand_over = jax.jit(jax_octave)(scene)
    jdog = torch.tensor(np.asarray(jdog))
    n = int(je.count)

    cands, ext = text.octave_keypoints(plan, OCTAVE, jdog)
    assert (cands.count, cands.overflow) == (int(jcand), int(jcand_over))
    assert (ext.count, ext.overflow) == (n, int(je.overflow))
    assert n > 1000
    np.testing.assert_array_equal(ext.lpos.numpy(), np.asarray(je.lpos)[:n])
    np.testing.assert_allclose(ext.xpos.numpy(), np.asarray(je.xpos)[:n],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(ext.ypos.numpy(), np.asarray(je.ypos)[:n],
                               rtol=0, atol=1e-4)

    np.testing.assert_allclose(own_dog.numpy(), jdog.numpy(), rtol=0,
                               atol=1e-3)
    _, own = text.octave_keypoints(plan, OCTAVE, own_dog)
    mine = (own.xpos.numpy(), own.ypos.numpy(), own.lpos.numpy())
    ref = (ext.xpos.numpy(), ext.ypos.numpy(), ext.lpos.numpy())
    moved = _unmatched(mine, ref) + _unmatched(ref, mine)
    print(f"octave {OCTAVE}: {n} extrema on the JAX DoG, {own.count} on the "
          f"port's own; {moved} without a counterpart")
    assert moved <= n // 100, moved
