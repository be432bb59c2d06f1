"""popsift_torch orientation assignment against popsift_tpu's: both sides
get the same JAX gradient field (as numpy) and the same keypoints, so the
stage is judged on its own.

Keypoints are the JAX package's refined extrema of a 240x320 texture plus
random slots (positions up to 2 px outside the image, every blur level,
sigmas up to the configuration's largest) that exercise the window gates.

Tolerances: histograms within rtol 1e-4 (the two sides sum the same
non-negative weights in another order), except slots holding a pixel at a
rounding boundary: XLA:CPU's vectorised arithmetic differs from
PyTorch's in the last bit for a few pixels (13 of the 1.8M bin indices of
octave 0 here), moving the pixel's weight into the next bin or across the
disc's edge.  Such slots are capped at 1 per 100, and every slot's total
weight agrees within rtol 1e-3.  num_ori exactly equal except
slots whose peaks tie, which are counted and capped at 1 per 1000 slots:
a peak within 1e-4 (relative) of the 0.8 x highest acceptance line, or two
accepted peaks within 1e-4 of each other.  Angles within 1e-4 rad (mod 2 pi).
"""

import functools
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
from popsift_tpu.ops import gradients as jgrad  # noqa: E402
from popsift_tpu.ops import orientation as jori  # noqa: E402
from popsift_tpu.ops import pyramid as jpyr  # noqa: E402

from popsift_torch.kernels import binwin as tbin  # noqa: E402
from popsift_torch.ops import orientation as tori  # noqa: E402

H, W = 240, 320
OCTAVES = [0, 1, 2]
N_RANDOM = 600
TIE_RTOL = 1e-4


def _texture(h, w, seed):
    rng = np.random.default_rng(seed)
    img = rng.random((h // 8, w // 8)).astype(np.float32)
    img = np.kron(img, np.ones((8, 8), np.float32))
    for _ in range(2):
        img = (img + np.roll(img, 1, 0) + np.roll(img, -1, 0)
               + np.roll(img, 1, 1) + np.roll(img, -1, 1)) / 5.0
    img = (img - img.min()) / (img.max() - img.min())
    return (img * 255).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def _jax_octaves():
    """Per octave: (field (2L, h, w), xpos, ypos, lpos, sigma) as numpy;
    the keypoints are the octave's refined extrema."""
    img = _texture(H, W, seed=5)
    cfg = jcfg.Config()
    plan = jext.make_plan(cfg, W, H)
    gauss = jgauss.build_gauss_info(cfg)

    def fn(im):
        im = im.astype(jnp.float32) * (1.0 / 255.0)
        stacks, dogs = jpyr.build_pyramid_and_dogs(
            im, gauss, plan.dims, plan.levels, plan.gauss_mode,
            plan.scaling_mode, plan.sift_mode, plan.upscale_factor)
        out = []
        for o in OCTAVES:
            w, h = plan.dims[o]
            g = plan.filter_grid_size
            cx, cy, cz, cv, _, _ = jex.detect_and_compact(
                dogs[o], plan.sift_mode, plan.peak_threshold,
                plan.cand_caps[o])
            ref = jex.refine_extrema_multi(
                [dogs[o]], [(cx, cy, cz + 1, cv)], plan.sift_mode,
                plan.sigma0, plan.sigma_k, plan.peak_threshold,
                plan.edge_limit, [(w / g, h / g)], g)[0]
            ext = jex.compact_extrema(*ref, plan.ext_caps[o])
            field = jgrad.padded_gradient_field(stacks[o], 0, 0)
            out.append((field, ext.xpos, ext.ypos, ext.lpos, ext.sigma,
                        ext.count))
        return out

    res = jax.jit(fn)(img)
    octs = []
    for o, (field, x, y, lp, sg, n) in zip(OCTAVES, res):
        n = int(n)
        octs.append(tuple(np.array(v) for v in (field, x[:n], y[:n],
                                                lp[:n], sg[:n])))
    return plan, octs


def _slots(o):
    """The octave's extrema plus random slots, as numpy arrays."""
    plan, octs = _jax_octaves()
    field, x, y, lp, sg = octs[OCTAVES.index(o)]
    L = field.shape[0] // 2
    h, w = field.shape[1:]
    rng = np.random.default_rng(100 + o)
    smax = jori.max_sigma(plan.sigma0, plan.levels)
    rx = rng.uniform(-2.0, w + 1.0, N_RANDOM).astype(np.float32)
    ry = rng.uniform(-2.0, h + 1.0, N_RANDOM).astype(np.float32)
    rl = rng.integers(0, L, N_RANDOM).astype(np.int32)
    rs = rng.uniform(plan.sigma0, smax, N_RANDOM).astype(np.float32)
    return (field, np.concatenate([x, rx]), np.concatenate([y, ry]),
            np.concatenate([lp, rl]), np.concatenate([sg, rs]), len(x))


@functools.lru_cache(maxsize=None)
def _jax_orientations(o):
    plan, _ = _jax_octaves()
    field, x, y, lp, sg, _ = _slots(o)
    h, w = field.shape[1:]
    L = field.shape[0] // 2
    valid = np.ones(x.shape, bool)

    def fn(f, x, y, lp, sg, v):
        hist = jori._hist_chunked(f, x, y, lp, sg, v, w, h, plan.ori_win,
                                  0, 0, L, 256)
        num, ori = jori.assign_orientations(f, 0, 0, x, y, lp, sg, v, w, h,
                                            plan.ori_win)
        return hist, num, ori

    return tuple(np.array(a) for a in jax.jit(fn)(field, x, y, lp, sg,
                                                  valid))


def _torch_inputs(o):
    field, x, y, lp, sg, n_ext = _slots(o)
    return (torch.as_tensor(field),) + tuple(
        torch.as_tensor(v) for v in (x, y, lp, sg)), n_ext


@functools.lru_cache(maxsize=None)
def _torch_hist(o) -> torch.Tensor:
    return tbin.ori_hist(*_torch_inputs(o)[0])


@pytest.mark.parametrize("o", OCTAVES)
def test_histograms_match(o):
    jhist, _, _ = _jax_orientations(o)
    assert _torch_inputs(o)[1] > 0
    hist = _torch_hist(o).numpy()
    assert hist.shape == jhist.shape
    close = np.isclose(hist, jhist, rtol=1e-4, atol=1e-6).all(axis=1)
    assert (~close).sum() <= len(close) // 100, int((~close).sum())
    np.testing.assert_allclose(hist.sum(axis=1), jhist.sum(axis=1),
                               rtol=1e-3)


def _tied(hist: torch.Tensor) -> np.ndarray:
    """Slots whose acceptance or ranking is decided below TIE_RTOL."""
    _, yval = tbin.peak_candidates(hist)
    out = []
    for row in torch.sort(yval, dim=-1, descending=True).values.numpy():
        peaks = row[np.isfinite(row)].astype(np.float64)
        if peaks.size == 0:
            out.append(False)
            continue
        line = 0.8 * peaks[0]
        acc = peaks[:4][peaks[:4] >= line]
        out.append(bool((np.abs(peaks - line) <= TIE_RTOL * peaks[0]).any()
                        or (np.abs(np.diff(acc)) <= TIE_RTOL * peaks[0])
                        .any()))
    return np.asarray(out, bool)


@pytest.mark.parametrize("o", OCTAVES)
def test_orientations_match(o):
    _, jnum, jori_ = _jax_orientations(o)
    (field, x, y, lp, sg), _ = _torch_inputs(o)
    num, ori = tori.assign_orientations(field, x, y, lp, sg)
    num, ori = num.numpy(), ori.numpy()
    tied = _tied(_torch_hist(o))
    assert tied.sum() <= len(tied) // 1000, int(tied.sum())
    keep = ~tied
    np.testing.assert_array_equal(num[keep], jnum[keep])
    assert (num[keep] > 0).any()
    has = (np.arange(4)[None, :] < jnum[:, None]) & keep[:, None]
    d = np.abs(ori - jori_) % (2 * np.pi)
    d = np.minimum(d, 2 * np.pi - d)[has]
    assert d.max() <= 1e-4, d.max()
    np.testing.assert_array_equal(ori[~has & keep[:, None]], 0.0)


def test_smoothing_and_peaks_on_random_histograms():
    rng = np.random.default_rng(3)
    hist = rng.random((500, 36)).astype(np.float32) ** 4
    hist[:5] = 0.0
    jsm = np.asarray(jax.jit(jori.smooth_histogram_vlfeat)(hist))
    tsm = tbin.smooth_histogram_vlfeat(torch.as_tensor(hist)).numpy()
    np.testing.assert_allclose(tsm, jsm, rtol=1e-6, atol=1e-7)
    jnum, jang = jax.jit(lambda h: jori._peaks_from_hist(
        h, jnp.ones(h.shape[0], bool), 4))(hist)
    num, ang = tbin.peaks_from_hist(torch.as_tensor(hist))
    np.testing.assert_array_equal(num.numpy(), np.asarray(jnum))
    np.testing.assert_allclose(ang.numpy(), np.asarray(jang), rtol=0,
                               atol=1e-5)
    assert (num.numpy()[:5] == 0).all()


def _chip_smoke():
    """chip_smoke.py from the repository root (numpy only at import)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def _histogram_set(name: str) -> np.ndarray:
    """Random histograms, or chip_smoke.py's tie-rich set (flat ones, equal
    spikes, a peak exactly at 0.8 of the highest and one float step below
    it, four-level random ones), on which the card's epilogue is checked."""
    if name == "tie_rich":
        return _chip_smoke().tie_rich_histograms(torch)
    rng = np.random.default_rng(3)
    hist = rng.random((500, 36)).astype(np.float32) ** 4
    hist[:5] = 0.0
    return hist


def _last_bit_decided(hist: np.ndarray) -> np.ndarray:
    """Rows whose num_ori a last-bit difference in the smoothing can
    decide: a peak within TIE_RTOL of the 0.8 x highest acceptance line,
    or a smoothed bin within TIE_RTOL of its larger neighbour (the peak
    test of a plateau)."""
    sm = tbin.smooth_histogram_vlfeat(torch.as_tensor(hist)).numpy()
    sm = sm.astype(np.float64)
    nbr = np.maximum(np.roll(sm, 1, -1), np.roll(sm, -1, -1))
    scale = np.maximum(sm.max(axis=1, keepdims=True), 1e-30)
    plateau = (np.abs(sm - nbr) <= TIE_RTOL * scale).any(axis=1) \
        & (sm.max(axis=1) > 0)
    _, yval = tbin.peak_candidates(torch.as_tensor(hist))
    line = []
    for row in yval.numpy().astype(np.float64):
        peaks = row[np.isfinite(row)]
        line.append(peaks.size > 0 and bool(
            (np.abs(peaks - 0.8 * peaks.max()) <= TIE_RTOL
             * peaks.max()).any()))
    return plateau | np.asarray(line, bool)


@pytest.mark.parametrize("name", ["random", "tie_rich"])
def test_peaks_match_jax(name):
    """The plain epilogue (smoothing, peaks, top-4 acceptance) against the
    JAX package's _peaks_from_hist.  XLA:CPU contracts the smoothing's
    multiplications by f32(1/3) into FMAs from the second pass on, so the
    smoothed bins differ in the last bit: a peak exactly at (or one step
    below) the acceptance line, or a plateau's peak test, can be decided
    the other way.  Such rows are counted and may differ only where
    _last_bit_decided says so; equal peaks stay equal on both sides (each
    bin's arithmetic is the same), so the ranking's ties agree."""
    hist = _histogram_set(name)
    jnum, jang = jax.jit(lambda h: jori._peaks_from_hist(
        h, jnp.ones(h.shape[0], bool), 4))(hist)
    jnum, jang = np.asarray(jnum), np.asarray(jang)
    num, ang = tbin.peaks_from_hist(torch.as_tensor(hist))
    num, ang = num.numpy(), ang.numpy()
    differ = num != jnum
    tied = _last_bit_decided(hist)
    assert not (differ & ~tied).any(), np.nonzero(differ & ~tied)
    assert differ.sum() <= max(2, len(hist) // 20), int(differ.sum())
    np.testing.assert_allclose(ang[~differ], jang[~differ], rtol=0,
                               atol=1e-5)
    assert (num > 0).any() and (num == 0).any()


def _emulate_epilogue(hist: np.ndarray):
    """K5's epilogue (csrc/binwin.cu:ori_epilogue) in float32 numpy, in its
    schedule: the six box passes with f32(1/3); each bin's peak test and
    refinement; the top four by four rounds of two warp reductions over
    lane l's bins l and 32 + l (the largest height key, then the lowest bin
    holding it); acceptance against 0.8 of the first; the angle with
    f32(1/36)."""
    f = np.float32
    third, rbins = f(1.0) / f(3.0), f(1.0) / f(36.0)
    assert third == f(1.0 / 3.0) and rbins == f(1.0 / 36.0)
    h = hist.astype(np.float32)
    for _ in range(6):
        h = ((np.roll(h, 1, -1) + h) + np.roll(h, -1, -1)) * third
    p, s, q = np.roll(h, 1, -1), h, np.roll(h, -1, -1)
    k = np.arange(36)
    with np.errstate(divide="ignore", invalid="ignore"):
        is_peak = (s > p) & (s > q)
        num = np.where(is_peak, (f(3) * p - f(4) * s) + f(1) * q, f(0))
        den = np.where(is_peak, f(2) * ((p - f(2) * s) + q), f(1))
        newbin = num / den
        pred = is_peak & (newbin >= 0) & (newbin <= 2)
        prev_idx = np.where(k == 0, 35, k - 1).astype(np.float32)
        refined = np.where(pred, prev_idx + newbin, f(-1))
        y = np.where(pred, (-(num * num)) / (f(4) * den) + p, f(-np.inf))
    bits = (y + f(0)).astype(np.float32).view(np.uint32)
    key = np.where(bits & 0x80000000, ~bits, bits | 0x80000000)
    key = key.astype(np.uint64)
    n = hist.shape[0]
    lane = np.arange(32)
    key0 = key[:, :32].copy()
    key1 = np.zeros((n, 32), np.uint64)
    key1[:, :4] = key[:, 32:]
    top = np.zeros((n, 4), np.int64)
    rows = np.arange(n)
    for r in range(4):
        first = key0 >= key1
        kk = np.where(first, key0, key1)
        best = kk.max(axis=1)
        cand = np.where(kk == best[:, None], np.where(first, lane, 32 + lane),
                        64)
        b = cand.min(axis=1)
        top[:, r] = b
        low = b < 32
        key0[rows[low], b[low]] = 0
        key1[rows[~low], b[~low] - 32] = 0
    yt = y[rows[:, None], top]
    with np.errstate(invalid="ignore"):
        accept = (yt >= f(0.8) * yt[:, :1]) & np.isfinite(yt)
    chosen = refined[rows[:, None], top]
    chosen = np.where(chosen >= f(36), chosen - f(36), chosen)
    th = f(2.0 * np.pi) * chosen * rbins - f(np.pi)
    return accept.sum(axis=1).astype(np.int32), np.where(accept, th, f(0))


@pytest.mark.parametrize("name", ["random", "tie_rich"])
def test_epilogue_schedule_matches_plain(name, one_thread):
    """The kernel's epilogue schedule, emulated, equals the plain version
    bit for bit: the same num_ori and the same angle bits, ties included."""
    hist = _histogram_set(name)
    num, ang = tbin.peaks_from_hist(torch.as_tensor(hist))
    enum, eang = _emulate_epilogue(hist)
    np.testing.assert_array_equal(enum, num.numpy())
    np.testing.assert_array_equal(eang.view(np.int32),
                                  ang.numpy().view(np.int32))


@pytest.fixture
def one_thread():
    """Bit-for-bit comparisons of CPU computations run on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("levels", [2, 3, 4, 5])
@pytest.mark.parametrize("sigma", [1.2, 1.6, 2.0])
def test_window_sizes_match(levels, sigma):
    assert tori.ori_window_size(sigma, levels) \
        == jori.ori_window_size(sigma, levels)
    assert tori.max_sigma(sigma, levels) == jori.max_sigma(sigma, levels)
