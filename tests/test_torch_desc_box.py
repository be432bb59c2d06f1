"""The footprint that K9 (NoTile), K12 (Grid) and K13 (ILoop) stage from
the stack, and K13's list of the samples that carry weight, on the CPU.

K9, K12 and K13 read K8's (win_y, 128) window of a row only over the row's
footprint box (kernels/desc_grid.py:footprint_box; the kernels stage it
one pixel wider on each side).  The box must hold every pixel the NoTile,
Grid and ILoop forms read: here each window is filled with NaN outside the
box, and the plain forms must give the same descriptors, bit for bit, with
no NaN.  The box's half side, ceil(2.5 bsz sbp + 2), is the ILoop reach;
the NoTile samples reach 2.4375 bsz sbp, their taps one pixel and the
bilinear corner one more, which the "notile" cases show covered.
A box one pixel smaller leaves NaN in every case, so the box is tight.
A NaN read anywhere, even by a sample of zero weight, would reach its
tile's bins (NaN * 0 is NaN).  The rows take every scale up to the
largest an extremum can have (orientation.max_sigma(1.6, 3)), zero scale
included, angles over [0, 2 pi) with the multiples of pi/4 (where bsz =
|cos| + |sin| is largest and smallest) and their float neighbours, and
keypoints at the plane's corners and edges, at half-pixel positions
(where round() picks the window's column) and inside, on a plane larger
than the window and on one smaller than it (clamp addressing).

K13 walks, in every tile, a list of the 32x32 grid's samples with
|nx| < 1 and |ny| < 1 that it compacts once per row with ballots and a
prefix (kernels/desc_grid.py:iloop_sample_list, the kernel's schedule on
the CPU); the list must be exactly those samples, in ascending order, and
the mask must be iloop_body's (recomputed here from its expressions).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from popsift_torch.constants import desc_tables_on  # noqa: E402
from popsift_torch.kernels import desc_grid as tkgrid  # noqa: E402
from popsift_torch.ops.descriptors import desc_window_size  # noqa: E402
from popsift_torch.ops.orientation import max_sigma  # noqa: E402

from test_torch_e2e import one_thread  # noqa: E402

WIN = desc_window_size(1.6, 3)
SIGMA_MAX = max_sigma(1.6, 3)


def _angles(rng):
    base = np.arange(8, dtype=np.float32) * np.float32(np.pi / 4)
    near = np.concatenate([np.nextafter(base[1:], np.float32(0)),
                           np.nextafter(base, np.float32(7))])
    return np.concatenate([base, near, rng.uniform(0, 2 * np.pi, 8)
                           .astype(np.float32)])


def _positions(kind, h, w, rng):
    if kind == "corners":
        xs = [0.0, w - 1.0, 0.0, w - 1.0, 0.49, w - 1.49]
        ys = [0.0, 0.0, h - 1.0, h - 1.0, 0.51, h - 1.51]
    elif kind == "edges":
        xs = [0.0, w - 1.0, w / 2 + 0.5, w / 3 + 0.5, 0.5, w - 1.5]
        ys = [h / 2 + 0.5, h / 3 - 0.5, 0.0, h - 1.0, h / 2 - 0.5, 1.5]
    else:
        xs = list(rng.uniform(1, w - 2, 6))
        ys = list(rng.uniform(1, h - 2, 6))
    return np.asarray(xs, np.float32), np.asarray(ys, np.float32)


def _stack(h, w, seed=3):
    rng = np.random.default_rng(seed)
    st = rng.random((3, h, w)).astype(np.float32)
    for _ in range(2):
        st = (st + np.roll(st, 1, 1) + np.roll(st, 1, 2)) / 3
    return torch.as_tensor(st)


def _rows(kind, h, w, seed):
    """Every (scale, angle) pair at one of the positions of a kind, the
    positions taken in turn."""
    rng = np.random.default_rng(seed)
    xs, ys = _positions(kind, h, w, rng)
    sig = np.concatenate([[0.0, 0.5], np.linspace(1.6, SIGMA_MAX, 5)]) \
        .astype(np.float32)
    ang = _angles(rng)
    S, A = np.meshgrid(np.arange(sig.size), np.arange(ang.size),
                       indexing="ij")
    S, A = S.ravel(), A.ravel()
    P = (S + A) % xs.size
    lv = rng.integers(0, 3, P.size).astype(np.int32)
    return [torch.as_tensor(a) for a in (xs[P], ys[P], lv, sig[S], ang[A])]


def _nan_outside_box(wins, box):
    bx0, bx1, by0, by1 = (b[:, None, None] for b in box)
    r = torch.arange(wins.shape[1])[None, :, None]
    c = torch.arange(wins.shape[2])[None, None, :]
    keep = (r >= by0) & (r <= by1) & (c >= bx0) & (c <= bx1)
    return torch.where(keep, wins, torch.nan)


@pytest.mark.parametrize("kind", ["corners", "edges", "interior"])
@pytest.mark.parametrize("h,w", [(200, 240), (64, 80)])
@pytest.mark.parametrize("mode", ["grid", "iloop", "notile"])
def test_box_covers_every_tap(mode, h, w, kind):
    stack = _stack(h, w)
    x, y, lv, sig, ang = _rows(kind, h, w, seed=h + len(kind))
    tables = desc_tables_on("cpu") if mode == "notile" else ()
    plain = {"grid": tkgrid.desc_grid_rounded_plain,
             "iloop": tkgrid.desc_iloop_plain,
             "notile": tkgrid.desc_grid_plain}[mode]
    wins, x0f, yaf = tkgrid.stack_windows_plain(stack, x, y, lv, WIN)
    box = tkgrid.footprint_box(x, y, sig, ang, WIN)
    assert all(bool((lo <= hi).all()) for lo, hi in zip(box[::2], box[1::2]))
    masked = _nan_outside_box(wins, box)
    assert bool(masked.isnan().any())
    with one_thread():
        want = plain(wins, x, y, x0f, yaf, sig, ang, w, h, *tables)
        got = plain(masked, x, y, x0f, yaf, sig, ang, w, h, *tables)
    assert not bool(got.isnan().any())
    assert torch.equal(got, want)
    # the wrapper's CPU form is the same composition
    fn = {"grid": tkgrid.desc_grid_rounded_stack,
          "iloop": tkgrid.desc_iloop_stack,
          "notile": tkgrid.desc_grid_stack}[mode]
    with one_thread():
        assert torch.equal(fn(stack, x, y, lv, sig, ang, WIN, *tables), want)


@pytest.mark.parametrize("kind", ["corners", "edges", "interior"])
@pytest.mark.parametrize("h,w", [(200, 240), (64, 80)])
@pytest.mark.parametrize("mode", ["grid", "iloop", "notile"])
def test_box_one_pixel_smaller_misses_a_tap(mode, h, w, kind):
    """The box is tight: one pixel less of half side leaves NaN in some
    rows of every case above (of 217: Grid 5-38, ILoop and NoTile 20-65),
    so the cases above would catch a box that is too small."""
    stack = _stack(h, w)
    x, y, lv, sig, ang = _rows(kind, h, w, seed=h + len(kind))
    tables = desc_tables_on("cpu") if mode == "notile" else ()
    plain = {"grid": tkgrid.desc_grid_rounded_plain,
             "iloop": tkgrid.desc_iloop_plain,
             "notile": tkgrid.desc_grid_plain}[mode]
    wins, x0f, yaf = tkgrid.stack_windows_plain(stack, x, y, lv, WIN)
    half = tkgrid.footprint_half(sig, ang) - 1
    box = tkgrid.footprint_box(x, y, sig, ang, WIN, half=half)
    with one_thread():
        got = plain(_nan_outside_box(wins, box), x, y, x0f, yaf, sig, ang,
                    w, h, *tables)
    assert int(got.isnan().any(dim=1).sum()) >= 5


def test_box_is_the_stated_formula():
    """footprint_box: +-ceil(2.5 bsz sbp + 2) around (floor(x - x0),
    floor(y - ya)), clamped to the (120, 128) window, on a few rows worked
    out by hand."""
    x = torch.tensor([100.3, 100.3, 0.0, 10.5])
    y = torch.tensor([50.7, 50.7, 0.0, 7.5])
    sig = torch.tensor([1.5, 1.5, 5.0, 0.0])
    ang = torch.tensor([0.0, math.pi / 4, 0.0, 1.0])
    half = tkgrid.footprint_half(sig, ang)
    # 2.5 * 4.5 + 2 = 13.25; 2.5 * sqrt(2) * 4.5 + 2 = 17.9; 2.5 * 15 + 2
    assert half.tolist() == [14, 18, 40, 2]
    bx0, bx1, by0, by1 = tkgrid.footprint_box(x, y, sig, ang, WIN)
    # x0 = round(x) - 56: 44, 44, -56, -46 (10.5 rounds to even);
    # ya = 8 floor((round(y) - 56) / 8): -8, -8, -56, -48
    assert bx0.tolist() == [56 - 14, 56 - 18, 56 - 40, 56 - 2]
    assert bx1.tolist() == [56 + 14, 56 + 18, 56 + 40, 56 + 2]
    assert by0.tolist() == [58 - 14, 58 - 18, 56 - 40, 55 - 2]
    assert by1.tolist() == [58 + 14, 58 + 18, 56 + 40, 55 + 2]
    big = tkgrid.footprint_box(x[:1], y[:1], torch.tensor([40.0]), ang[:1],
                               WIN)
    assert [int(b) for b in big] == [0, 127, 0, 119]


def _mask_from_iloop_body_expressions(sigma, ang):
    """nn_ok & ok as iloop_body computes them (kernels/desc_grid.py)."""
    cos_t, sin_t = torch.cos(ang), torch.sin(ang)
    bsz = (torch.abs(cos_t) + torch.abs(sin_t))[:, None]
    kk = torch.arange(32, dtype=torch.float32)
    d = -bsz + kk * bsz / 16.0
    dxg = d.repeat(1, 32)
    dyg = d.repeat_interleave(32, dim=1)
    c, s = cos_t[:, None], sin_t[:, None]
    nx = c * dxg + s * dyg
    ny = c * dyg - s * dxg
    ok = (torch.abs(3.0 * sigma) > 0.0)[:, None]
    return (torch.abs(nx) < 1.0) & (torch.abs(ny) < 1.0) & ok


def test_iloop_list_is_the_mask_in_order():
    rng = np.random.default_rng(5)
    ang = torch.as_tensor(np.concatenate([_angles(rng), rng.uniform(
        -np.pi, 3 * np.pi, 40).astype(np.float32)]))
    sig = torch.as_tensor(rng.uniform(0.0, SIGMA_MAX, ang.numel())
                          .astype(np.float32))
    sig[::7] = 0.0
    mask = _mask_from_iloop_body_expressions(sig, ang)
    lst, count = tkgrid.iloop_sample_list(sig, ang)
    assert lst.dtype == torch.int32 and lst.shape == (ang.numel(), 1024)
    for i in range(ang.numel()):
        want = torch.nonzero(mask[i]).flatten().to(torch.int32)
        assert int(count[i]) == want.numel()
        assert torch.equal(lst[i, :want.numel()], want)
        assert bool((lst[i, want.numel():] == -1).all())
    # about 1/bsz^2 of the grid carries weight: at angle 0 all but the
    # first row and column (offset -1), about half at 45 degrees, none at
    # zero scale
    _, few = tkgrid.iloop_sample_list(
        torch.tensor([2.0, 2.0, 0.0]),
        torch.tensor([0.0, math.pi / 4, 0.3]))
    assert int(few[0]) == 31 * 31 and int(few[2]) == 0
    assert abs(int(few[1]) / 1024 - 0.5) < 0.05
