"""K1 (separable blur) of popsift_torch: its tile schedule and its chain
entry, on the CPU.

The CUDA kernels cannot run here, so a CPU emulation of their schedules
is held bit for bit to ``sep_blur_plain``: the fused tile (source rows
with span_v - 1 clamped halo rows and P clamped halo columns, the
horizontal pass over float4-loaded register windows of 2P + 4 values, the
vertical pass over windows of 8 + 2P rows, the DoG from the source
buffer), and the chain entry's cluster (each block's band of rows of the
level and of its horizontal pass kept in shared memory, the vertical
window's halo rows read from the other blocks' bands once the horizontal
pass is whole; then the field, each block's band rows at every level read
from the stack with the image rows above and below).  Window
values a thread does not load are NaN in the emulation, so a read outside
what the kernel loads would show.  Bit comparisons run on one thread
(PyTorch's CPU kernels round each operation; see PERF.md).  The chain
entry's field is held bit for bit to K2's plain version of the emulated
stack.

``blur_chain_plain`` is also held to the JAX package's per-level pyramid
at octaves that ``octave_chain_ok`` refuses, within
``test_levels_and_dogs_match``'s 1e-3 (XLA:CPU contracts multiply-adds).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from popsift_tpu import config as jcfg  # noqa: E402
from popsift_tpu import extract as jext  # noqa: E402
from popsift_tpu import gauss as jgauss  # noqa: E402
from popsift_tpu.ops import pyramid as jpyr  # noqa: E402

from popsift_torch import config as tcfg  # noqa: E402
from popsift_torch import gauss as tgauss  # noqa: E402
from popsift_torch.kernels import blur as tblur  # noqa: E402
from popsift_torch.kernels.grad import grad_field_plain  # noqa: E402
from popsift_torch.kernels.octave import octave_chain_ok  # noqa: E402
from popsift_torch.ops import gradients as tgrad  # noqa: E402
from popsift_torch.ops import pyramid as tpyr  # noqa: E402

PLANES = [(8, 15), (33, 70), (67, 129), (135, 240)]
NAN = float("nan")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _taps(span, seed):
    rng = np.random.default_rng(seed)
    t = rng.random(tblur.MAX_SPAN).astype(np.float32)
    return t / (t[0] + 2 * t[1:span].sum())


def emulate_tile(src, out, dog, th, sh, tv, sv, hscale, ty0, tx0, TH, TW,
                 V, written):
    """One block's tile of csrc/blur.cu:blur_tile, vectorised over its
    items; the arithmetic of each output is the kernel's, in its order."""
    H, W = src.shape
    P = tblur.halo_class(max(sh, sv))
    hv = sv - 1
    nr, sp = TH + 2 * hv, TW + 2 * P
    rows = (ty0 - hv + torch.arange(nr)).clamp(0, H - 1)
    cols = (tx0 - P + torch.arange(sp)).clamp(0, W - 1)
    s_src = src[rows][:, cols]                              # (nr, sp)

    # horizontal: item (row, x0 = 4g); window k <-> s_src column x0 + k,
    # loaded by float4 chunks that meet [P - (sh-1), P + 3 + (sh-1)]
    g4 = TW // 4
    k = torch.arange(2 * P + 4)
    loaded = ((k // 4) * 4 + 3 >= P - (sh - 1)) & ((k // 4) * 4 <= P + 3 + sh - 1)
    win = s_src[:, (4 * torch.arange(g4))[:, None] + k]      # (nr, g4, 2P+4)
    win = torch.where(loaded, win, torch.tensor(NAN))
    s_h = torch.empty(nr, TW)
    for e in range(4):
        a = win[..., P + e] * float(th[0])
        for off in range(1, P + 1):
            if off < sh:
                a = a + (win[..., P + e - off] + win[..., P + e + off]) \
                    * float(th[off])
        if hscale != 1.0:
            a = a * float(hscale)
        s_h[:, e::4] = a

    # vertical: item (group g, column x) of V rows; window k <-> s_h row
    # i0 + hv - P + k, loaded for k in [P - hv, P + V - 1 + hv]
    k = torch.arange(V + 2 * P)
    loaded = (k >= P - hv) & (k <= P + V - 1 + hv)
    for g in range(TH // V):
        i0 = g * V
        r = i0 + hv - P + k
        win = torch.full((V + 2 * P, TW), NAN)
        win[loaded] = s_h[r[loaded]]
        for m in range(V):
            a = win[P + m] * float(tv[0])
            for off in range(1, P + 1):
                if off < sv:
                    a = a + (win[P + m - off] + win[P + m + off]) \
                        * float(tv[off])
            gy = ty0 + i0 + m
            x = torch.arange(TW)
            ok = (tx0 + x) < W
            if gy < H:
                out[gy, tx0 + x[ok]] = a[ok]
                written[gy, tx0 + x[ok]] += 1
                if dog is not None:
                    dog[gy, tx0 + x[ok]] = a[ok] - s_src[i0 + m + hv,
                                                         x[ok] + P]


def emulate_sep_blur(src, th, sh, tv, sv, hscale=1.0):
    H, W = src.shape
    TH, TW = tblur.TILE
    out = torch.full((H, W), NAN)
    dog = torch.full((H, W), NAN)
    written = torch.zeros((H, W), dtype=torch.int32)
    for ty0 in range(0, H, TH):
        for tx0 in range(0, W, TW):
            emulate_tile(src, out, dog, th, sh, tv, sv, hscale, ty0, tx0,
                         TH, TW, tblur.VROWS, written)
    assert bool((written == 1).all()), "an output written other than once"
    return out, dog


def emulate_chain_level(cur, hb, R, H, W, taps, span, nxt, out, dog,
                        written):
    """One level of csrc/blur.cu:chain_level, each block's items
    vectorised: every block's horizontal pass of its own band into its
    band of hb, then (after the cluster barrier) every block's vertical
    pass, its window's rows (the halo rows copied in from the other
    blocks) read from the bands of hb that hold them."""
    P = tblur.halo_class(span)
    hv = span - 1
    nb = len(cur)
    g4 = -(-W // 4)
    k = torch.arange(2 * P + 4)
    loaded = ((k // 4) * 4 + 3 >= P - hv) & ((k // 4) * 4 <= P + 3 + hv)
    cols = ((4 * torch.arange(g4))[:, None] - P + k).clamp(0, W - 1)
    for b in range(nb):
        rb = max(0, min(R, H - b * R))
        # window k <-> column x0 - P + k clamped to the row, loaded by
        # 4-column chunks that meet [P - hv, P + 3 + hv]
        win = torch.where(loaded, cur[b][:rb][:, cols], torch.tensor(NAN))
        h = torch.full((rb, 4 * g4), NAN)
        for e in range(4):
            a = win[..., P + e] * float(taps[0])
            for off in range(1, P + 1):
                if off < span:
                    a = a + (win[..., P + e - off] + win[..., P + e + off]) \
                        * float(taps[off])
            h[:, e::4] = a
        hb[b][:rb] = h[:, :W]
    V = tblur.CHAIN_VROWS
    k = torch.arange(V + 2 * P)
    loaded = (k >= P - hv) & (k <= P + V - 1 + hv)
    for b in range(nb):
        y0 = b * R
        rb = max(0, min(R, H - y0))
        for g in range(-(-rb // V)):
            i0 = g * V
            # window k <-> image row y0 + i0 - P + k (clamped), from the
            # band of hb that holds it
            gy = (y0 + i0 - P + k).clamp(0, H - 1)
            win = torch.full((V + 2 * P, W), NAN)
            for kk in torch.nonzero(loaded).reshape(-1).tolist():
                y = int(gy[kk])
                win[kk] = hb[y // R][y % R]
            for m in range(V):
                if i0 + m >= rb:
                    continue
                a = win[P + m] * float(taps[0])
                for off in range(1, P + 1):
                    if off < span:
                        a = a + (win[P + m - off] + win[P + m + off]) \
                            * float(taps[off])
                nxt[b][i0 + m] = a
                out[y0 + i0 + m] = a
                dog[y0 + i0 + m] = a - cur[b][i0 + m]
                written[y0 + i0 + m] += 1


def emulate_chain_field(stack, nb, R):
    """csrc/blur.cu:band_field after the chain's last barrier: each of the
    nb blocks takes its band's rows at every level of the stack, a warp a
    row, its lanes along x in chunks of 32 KC columns (KC 1, 2 or 4 by the
    row's width); a lane loads at its column clamped to the row, and from
    the image rows above and below, clamped to the image, and stores only
    inside the row.  Returns the central differences (dx, dy), each
    (L, H, W); every pixel must be written once."""
    L, H, W = stack.shape
    KC = 1 if W <= 32 else 2 if W <= 64 else 4
    dx = torch.full((L, H, W), NAN)
    dy = torch.full((L, H, W), NAN)
    written = torch.zeros((L, H, W), dtype=torch.int32)
    for b in range(nb):
        y0 = b * R
        rb = max(0, min(R, H - y0))
        for r in range(L * rb):
            lvl, gy = r // rb, y0 + r % rb
            s = stack[lvl]
            row, up, dn = s[gy], s[max(gy - 1, 0)], s[min(gy + 1, H - 1)]
            for x0 in range(0, W, 32 * KC):
                x = x0 + torch.arange(32 * KC)
                xc = x.clamp(max=W - 1)
                keep = x < W
                d_x = (row[(xc + 1).clamp(max=W - 1)]
                       - row[(xc - 1).clamp(min=0)])
                d_y = dn[xc] - up[xc]
                dx[lvl, gy, x[keep]] = d_x[keep]
                dy[lvl, gy, x[keep]] = d_y[keep]
                written[lvl, gy, x[keep]] += 1
    assert bool((written == 1).all()), "a field pixel written other than once"
    return dx, dy


def emulate_blur_chain(lvl0, filters, spans):
    """csrc/blur.cu:blur_chain: one cluster whose blocks each keep a band
    of rows of the level and of its horizontal pass in shared memory, and
    then the field of every level from the stack.  Returns (stack, dog,
    field)."""
    H, W = lvl0.shape
    L = len(spans)
    nb, R = tblur.chain_bands(H)
    stack = torch.full((L, H, W), NAN)
    dog = torch.full((L - 1, H, W), NAN)
    stack[0] = lvl0
    cur = [torch.full((R, W), NAN) for _ in range(nb)]
    for b in range(nb):
        rb = max(0, min(R, H - b * R))
        cur[b][:rb] = lvl0[b * R:b * R + rb]
    hb = [torch.full((R, W), NAN) for _ in range(nb)]
    for lvl in range(1, L):
        nxt = [torch.full((R, W), NAN) for _ in range(nb)]
        written = torch.zeros((H, W), dtype=torch.int32)
        emulate_chain_level(cur, hb, R, H, W, filters[lvl], spans[lvl], nxt,
                            stack[lvl], dog[lvl - 1], written)
        assert bool((written == 1).all()), f"level {lvl} not covered once"
        cur = nxt
    dx, dy = emulate_chain_field(stack, nb, R)
    # the elementwise rest of K2's expressions, on tensors of the plain
    # version's shape (PyTorch's CPU atan2 may round the last bit by how
    # a call splits into vector and scalar parts)
    field = tgrad.interleave_field(torch.sqrt(dx * dx + dy * dy),
                                   torch.atan2(dy, dx))
    return stack, dog, field


@pytest.mark.parametrize("span", [1, 2, 14, 32])
@pytest.mark.parametrize("h,w", PLANES)
def test_tile_schedule_bit_equal_to_plain(span, h, w):
    rng = np.random.default_rng(h * w + span)
    src = torch.as_tensor(rng.random((h, w)).astype(np.float32) * 255)
    th, tv = _taps(span, 1), _taps(max(1, span - 1), 2)
    sv = max(1, span - 1)
    for hscale in (1.0, 255.0):
        out, dog = emulate_sep_blur(src, th, span, tv, sv, hscale)
        p, pd = tblur.sep_blur_plain(src, th, span, tv, sv, hscale,
                                     with_dog=True)
        assert torch.equal(out, p), (span, h, w, hscale)
        assert torch.equal(dog, pd), (span, h, w, hscale)


CHAIN_SPANS = [(1, 6, 8, 9, 11, 14), (1, 2, 1, 32, 14, 2)]


@pytest.mark.parametrize("spans", CHAIN_SPANS)
@pytest.mark.parametrize("h,w", [(9, 15), (34, 60), (68, 120), (135, 240),
                                 (20, 1100)])
def test_chain_schedule_bit_equal_to_plain(spans, h, w):
    rng = np.random.default_rng(h + w)
    lvl0 = torch.as_tensor(rng.random((h, w)).astype(np.float32) * 255)
    filters = [None] + [_taps(s, lvl) for lvl, s in enumerate(spans)][1:]
    stack, dog, field = emulate_blur_chain(lvl0, filters, spans)
    ps, pd = tblur.blur_chain_plain(lvl0, filters, spans)
    assert torch.equal(stack, ps) and torch.equal(dog, pd)
    assert torch.equal(field, grad_field_plain(ps))
    # on a CPU tensor the wrapper is its plain version
    ks, kd = tblur.blur_chain(lvl0, filters, spans)
    assert torch.equal(ks, ps) and torch.equal(kd, pd)
    # and the plain chain is K1's plain version level by level
    for lvl in range(1, len(spans)):
        o, d = tblur.sep_blur_plain(ps[lvl - 1], filters[lvl], spans[lvl],
                                    filters[lvl], spans[lvl], with_dog=True)
        assert torch.equal(o, ps[lvl]) and torch.equal(d, pd[lvl - 1])


# heights whose clusters hold 1, 1, 2, 4, 8 and 16 blocks; H = 9's last
# band is empty, H = 17's last three hold 2 rows, none and none, H =
# 135's last none
FIELD_PLANES = [(1, 7), (3, 16), (6, 20), (9, 15), (17, 33), (135, 240)]


@pytest.mark.parametrize("h,w", FIELD_PLANES)
def test_chain_field_schedule_bit_equal_to_k2(h, w):
    """The chain entry's field, read band by band with one neighbour row
    each side (from the neighbouring band at a band's first and last
    rows), is K2's plain field of the stack bit for bit; the wrapper with
    ``emit_field`` on a CPU tensor is the plain chain and that field."""
    blocks, rows = tblur.chain_bands(h)
    bands = [max(0, min(rows, h - b * rows)) for b in range(blocks)]
    assert sum(bands) == h
    spans = CHAIN_SPANS[0]
    rng = np.random.default_rng(h * w)
    lvl0 = torch.as_tensor(rng.random((h, w)).astype(np.float32) * 255)
    filters = [None] + [_taps(s, lvl) for lvl, s in enumerate(spans)][1:]
    stack, dog, field = emulate_blur_chain(lvl0, filters, spans)
    ps, pd, pf = tblur.blur_chain_plain(lvl0, filters, spans,
                                        emit_field=True)
    assert torch.equal(stack, ps) and torch.equal(dog, pd)
    assert pf.shape == (2 * len(spans), h, w)
    assert torch.equal(field, pf) and torch.equal(pf, grad_field_plain(ps))
    ks, kd, kf = tblur.blur_chain(lvl0, filters, spans, emit_field=True)
    assert torch.equal(ks, ps) and torch.equal(kd, pd)
    assert torch.equal(kf, pf)


def test_chain_field_planes_cover_every_band_shape():
    got = {h: tblur.chain_bands(h) for h, _ in FIELD_PLANES}
    assert [b for b, _ in got.values()] == [1, 1, 2, 4, 8, 16]

    def bands(h):
        blocks, rows = got[h]
        return [max(0, min(rows, h - b * rows)) for b in range(blocks)]
    assert bands(9) == [3, 3, 3, 0]
    assert bands(17)[-3:] == [2, 0, 0]
    assert bands(135)[-1] == 0


def test_chain_entry_limits():
    spans = (1, 6, 8, 9, 11, 14)
    assert tblur.chain_fits(135, 240, spans)
    assert tblur.chain_fits(256, 256, spans)
    assert not tblur.chain_fits(257, 256, spans)
    # a wide plane's bands outgrow a block's shared memory
    assert not tblur.chain_fits(16, 4096, spans)
    # the default 1080p path's per-level octaves 4-8
    planes = (135, 68, 34, 17, 9)
    assert [tblur.chain_bands(h) for h in planes] \
        == [(16, 9), (16, 5), (16, 3), (8, 3), (4, 3)]
    with pytest.raises(ValueError):
        tblur.blur_chain(torch.zeros(4, 4), [None], (1,))


@functools.lru_cache(maxsize=None)
def _jax_pyramid(h, w):
    rng = np.random.default_rng(h * w)
    img = (rng.random((h, w)) * 255).astype(np.uint8)
    cfg = jcfg.Config()
    plan = jext.make_plan(cfg, w, h)
    gauss = jgauss.build_gauss_info(cfg)

    def fn(im):
        im = im.astype(jnp.float32) * (1.0 / 255.0)
        return jpyr.build_pyramid_and_dogs(
            im, gauss, plan.dims, plan.levels, plan.gauss_mode,
            plan.scaling_mode, plan.sift_mode, plan.upscale_factor)

    stacks, dogs = jax.jit(fn)(img)
    return plan, [np.array(s) for s in stacks], [np.array(d) for d in dogs]


@pytest.mark.parametrize("h,w", [(96, 128), (60, 100)])
def test_blur_chain_plain_matches_jax_per_level(h, w):
    plan, jstacks, jdogs = _jax_pyramid(h, w)
    gauss = tgauss.build_gauss_info(tcfg.Config())
    filters, spans = tpyr.chain_filters(gauss, plan.levels)
    for o in range(plan.octaves):
        jh, jw = jstacks[o].shape[1:]
        assert not octave_chain_ok(jh, jw, spans, emit_field=True)
        stack, dog = tblur.blur_chain_plain(torch.as_tensor(jstacks[o][0]),
                                            filters, spans)
        np.testing.assert_allclose(stack.numpy(), jstacks[o], rtol=0,
                                   atol=1e-3, err_msg=f"octave {o}")
        np.testing.assert_allclose(dog.numpy(), jdogs[o], rtol=0,
                                   atol=1e-3, err_msg=f"dog octave {o}")
