"""K3 (DoG extremum detection) and the candidate compaction budget of
popsift_torch against popsift_tpu's, on the CPU.

K3's CUDA kernel cannot run here, so a CPU emulation of its schedule (warp
strips of 60 output columns, 2 columns a lane, halo columns in lanes 0 and
31, neighbour columns by shuffles, segments of rows slid down one row at a
time, the separable max/min with the centre excluded, 16-bit or byte
stores; the order in which the cp.async ring delivers rows does not enter
the arithmetic) is
held to ``detect_plain`` and to the JAX package's ``detect_candidates``
on DoGs full of exact ties: values quantised to a few levels, planted
plateaus and signed zeros.  Tolerances: none; masks and candidate lists
are compared exactly.
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

from popsift_tpu import config as jcfg  # noqa: E402
from popsift_tpu.ops import extrema as jex  # noqa: E402

from popsift_torch import config as tcfg  # noqa: E402
from popsift_torch.kernels import detect as tdet  # noqa: E402
from popsift_torch.ops import extrema as tex  # noqa: E402

MODES = ["popsift", "vlfeat", "opencv"]
SIZES = [(8, 15), (16, 30), (33, 60), (67, 129)]
LANES = 32
COLS = tdet.COLS


def _tie_rich_dog(levels, h, w, seed):
    """DoG planes quantised to nine levels, with plateaus of equal values,
    signed zeros, and a few strict peaks and pits so that every mode finds
    extrema."""
    rng = np.random.default_rng(seed)
    dog = (rng.integers(-4, 5, (levels + 2, h, w)) * 1.0).astype(np.float32)
    for _ in range(max(1, h * w // 40)):
        p = rng.integers(0, levels + 2)
        y, x = rng.integers(0, h), rng.integers(0, w)
        dog[p, y:y + rng.integers(1, 4), x:x + rng.integers(1, 5)] = \
            rng.integers(-4, 5)
    zeros = rng.random(dog.shape) < 0.1
    dog[zeros] = np.where(rng.random(int(zeros.sum())) < 0.5, -0.0, 0.0)
    for _ in range(max(2, h * w // 30)):
        p = rng.integers(1, levels + 1)
        y, x = rng.integers(0, h), rng.integers(0, w)
        dog[p, y, x] = np.float32(rng.choice([-1, 1]) * 9.0)
    return dog


def _load_row(plane, r, x, vec):
    """The warp's load of row r (clamped) of one plane, as
    csrc/detect.cu:load_row (columns clamped to the row), and the 3-wide
    and two-sided max/min along x with the neighbour lanes' columns."""
    H, W = plane.shape
    row = plane[min(max(r, 0), H - 1)]
    if vec:
        xa = np.clip(x, 0, W - COLS)
        v = row[xa[:, None] + np.arange(COLS)]
    else:
        v = row[np.clip(x[:, None] + np.arange(COLS), 0, W - 1)]
    left = np.roll(v[:, COLS - 1], 1)             # __shfl_up_sync
    right = np.roll(v[:, 0], -1)                  # __shfl_down_sync
    lv = np.concatenate([left[:, None], v[:, :-1]], axis=1)
    rv = np.concatenate([v[:, 1:], right[:, None]], axis=1)
    px, pn = np.maximum(lv, rv), np.minimum(lv, rv)
    return v, np.maximum(px, v), np.minimum(pn, v), px, pn


def emulate_k3(dog, gate, border, seg, vec=None, group=tdet.GROUP):
    """csrc/detect.cu's schedule on the CPU, warps of ``group`` mask
    layers.  Returns the mask; a byte the schedule does not write stays
    255."""
    P, H, W = dog.shape
    levels = P - 2
    vec = (W % COLS == 0) if vec is None else vec
    mask = np.full((levels, H, W), 255, np.uint8)
    for z0 in range(0, levels, group):
        nz = min(group, levels - z0)
        planes = dog[z0:z0 + nz + 2]
        for strip in range(-(-W // tdet.STRIP)):
            x0 = strip * tdet.STRIP + COLS * (np.arange(LANES) - 1)
            cols = x0[:, None] + np.arange(COLS)
            colok = (cols >= border) & (cols < W - border)
            # lanes 1-30 store their columns inside the row
            lanes = (np.arange(LANES) >= 1) & (np.arange(LANES) <= 30)
            keep = lanes[:, None] & (cols < W)
            for ys in range(0, H, seg):
                ye = min(ys + seg, H)
                ox = [np.zeros((LANES, COLS), np.float32)] * (nz + 2)
                on = list(ox)
                mx, mn, cv = ({}, {}, {})
                for r in range(ys - 1, ye + 1):
                    rows = [_load_row(planes[p], r, x0, vec)
                            for p in range(nz + 2)]
                    nx = [c[1] for c in rows]
                    nn = [c[2] for c in rows]
                    for z in range(nz):
                        p = z + 2
                        y = r - 1
                        if y >= ys:
                            fx = np.maximum(np.maximum(mx[z], nx[p - 2]),
                                            np.maximum(nx[p - 1], nx[p]))
                            fn = np.minimum(np.minimum(mn[z], nn[p - 2]),
                                            np.minimum(nn[p - 1], nn[p]))
                            v = cv[z]
                            m = ((border <= y < H - border) & colok
                                 & ((v > fx) | (v < fn))
                                 & (np.abs(v) >= gate))
                            mask[z0 + z, y, cols[keep]] = m[keep]
                        if ys <= r < ye:
                            c = rows[p - 1]
                            mx[z] = np.maximum(
                                np.maximum(np.maximum(ox[p - 2], ox[p - 1]),
                                           ox[p]),
                                np.maximum(np.maximum(nx[p - 2], nx[p]),
                                           c[3]))
                            mn[z] = np.minimum(
                                np.minimum(np.minimum(on[p - 2], on[p - 1]),
                                           on[p]),
                                np.minimum(np.minimum(nn[p - 2], nn[p]),
                                           c[4]))
                            cv[z] = c[0]
                    ox, on = nx, nn
    return mask


def _gate(mode):
    cfg = tcfg.Config(sift_mode=tcfg.SiftMode(mode))
    return cfg.get_peak_threshold(), tdet.gate_for(
        tcfg.SiftMode(mode), cfg.get_peak_threshold())


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("h,w", SIZES)
def test_k3_schedule_matches_plain_and_jax(mode, h, w, one_thread):
    levels = 3
    dog = _tie_rich_dog(levels, h, w, seed=h * 1000 + w)
    peak, (gate, border) = _gate(mode)
    plain = tdet.detect_plain(torch.as_tensor(dog), gate, border).numpy()
    jmask = np.asarray(jax.jit(lambda d: jex.detect_candidates(
        d, jcfg.SiftMode(mode), peak))(dog))
    np.testing.assert_array_equal(plain.astype(bool), jmask)
    if h > 2 * border + 2:
        assert plain.any(), "the DoG should hold extrema"
    # the kernel's planner's segment, and short ones that put segment
    # boundaries inside the plane; both load paths where the row allows
    plans = {tdet.detect_plan(levels, h, w)} | {
        (seg, group) for seg in (1, 2, 3, 5) for group in (1, tdet.GROUP)}
    for seg, group in sorted(plans):
        for vec in ((False, True) if w % COLS == 0 else (False,)):
            got = emulate_k3(dog, gate, border, seg, vec, group)
            np.testing.assert_array_equal(
                got, plain, err_msg=f"seg {seg} group {group} vec {vec}")


@pytest.mark.parametrize("levels", [1, 4, 5])
def test_k3_schedule_layer_groups(levels, one_thread):
    """More layers than one block's group of three (two groups, the
    second one short) and a single layer."""
    h, w = 21, 136
    dog = _tie_rich_dog(levels, h, w, seed=levels)
    peak, (gate, border) = _gate("popsift")
    plain = tdet.detect_plain(torch.as_tensor(dog), gate, border).numpy()
    jmask = np.asarray(jax.jit(lambda d: jex.detect_candidates(
        d, jcfg.SiftMode.POPSIFT, peak))(dog))
    np.testing.assert_array_equal(plain.astype(bool), jmask)
    for group in (1, 2, tdet.GROUP):
        got = emulate_k3(dog, gate, border, 3, group=group)
        np.testing.assert_array_equal(got, plain, err_msg=f"group {group}")


def test_detect_plan_segments():
    # the default 1080p path's octaves: 16-row segments of three layers
    # at octave 0 (64 strips of 135 segments), one row and one layer a
    # warp from octave 4 on
    planes = ((2160, 3840), (1080, 1920), (540, 960), (270, 480),
              (135, 240), (9, 15))
    assert [tdet.detect_plan(3, h, w) for h, w in planes] \
        == [(16, 3), (9, 3), (3, 3), (2, 3), (1, 1), (1, 1)]
    assert tdet.detect_plan(3, 100000, 4096) == (tdet.SEG_ROWS[1], 3)


def _dense_mask():
    """A (2, 40, 64) mask (five 1024-voxel blocks): 40 set voxels in one
    1024-run, two more blocks over the budget of 16, one under it."""
    rng = np.random.default_rng(5)
    flat = np.zeros(2 * 40 * 64, bool)
    for block, n in ((0, 40), (2, 23), (3, 17), (4, 9)):
        flat[block * 1024 + rng.choice(1024, n, replace=False)] = True
    return flat.reshape(2, 40, 64)


@pytest.mark.parametrize("cap", [30, 57, 1000])
def test_compaction_budget_matches_jax(cap):
    mask = _dense_mask()
    jx, jy, jz, jvalid, jcount, joverflow = jax.jit(
        lambda m: jex.compact_mask(m, cap))(mask)
    tex.reset_budget_dropped()
    c = tex.compact_mask(torch.as_tensor(mask.astype(np.uint8)), cap)
    kept = 16 + 16 + 16 + 9
    assert tex.budget_dropped() == int(mask.sum()) - kept
    assert (c.count, c.overflow) == (int(jcount), int(joverflow))
    assert c.count == min(kept, cap)
    n = c.count
    np.testing.assert_array_equal(c.x.numpy(), np.asarray(jx)[:n])
    np.testing.assert_array_equal(c.y.numpy(), np.asarray(jy)[:n])
    np.testing.assert_array_equal(c.z.numpy(), np.asarray(jz)[:n])
    assert int(np.asarray(jvalid).sum()) == n


def test_compaction_budget_keeps_first_in_raster_order():
    mask = np.zeros((1, 32, 64), bool)
    mask[0, 0, :40] = True          # one run: the first 16 survive
    mask[0, 31, 63] = True          # the last voxel of the second block
    c = tex.compact_mask(torch.as_tensor(mask.astype(np.uint8)), 100)
    assert c.count == 17 and c.overflow == 24
    np.testing.assert_array_equal(c.x.numpy(), list(range(16)) + [63])
    np.testing.assert_array_equal(c.y.numpy(), [0] * 16 + [31])


BUDGET_MASKS = (Path(__file__).parent / "data" / "budget_masks_1080p.npz")


@pytest.mark.parametrize("scene,dropped", [(0, 2), (1, 6), (2, 3)])
def test_compaction_budget_on_the_1080p_masks(scene, dropped):
    """Octave 2 of the 1080p scenes of seeds 0-2 (chip_smoke.make_scene),
    the only default-path octaves whose masks exceed the budget: their set
    positions as K3 computed them on the card (chip_smoke.py checks that
    it still does).  The port's candidates are the JAX package's."""
    data = np.load(BUDGET_MASKS)
    key = f"s{scene}_o2"
    shape = tuple(int(v) for v in data[key + "_shape"])
    cap = int(data[key + "_cap"])
    mask = np.zeros(int(np.prod(shape)), bool)
    mask[data[key]] = True
    mask = mask.reshape(shape)
    jx, jy, jz, _, jcount, joverflow = jax.jit(
        lambda m: jex.compact_mask(m, cap))(mask)
    tex.reset_budget_dropped()
    c = tex.compact_mask(torch.as_tensor(mask.astype(np.uint8)), cap)
    assert tex.budget_dropped() == dropped
    assert (c.count, c.overflow) == (int(jcount), int(joverflow)) \
        == (int(mask.sum()) - dropped, dropped)
    n = c.count
    np.testing.assert_array_equal(c.x.numpy(), np.asarray(jx)[:n])
    np.testing.assert_array_equal(c.y.numpy(), np.asarray(jy)[:n])
    np.testing.assert_array_equal(c.z.numpy(), np.asarray(jz)[:n])
