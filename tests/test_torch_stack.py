"""popsift_torch's stack-kernel path (K10 ori_hist_stack, K11
desc_loop_stack) against popsift_tpu, on the CPU.

``POPSIFT_TPU_STACK_KERNELS=1`` sends orientation and loop descriptors to
the kernels that take each pixel's gradient from the blurred stack.

* The plain versions of K10 and K11 against the JAX stack kernels in
  interpret mode, on the inputs of tests/test_kernels.py's stack-kernel
  tests (near-border keypoints included): histograms within rtol/atol
  1e-5 and descriptors within 1e-4 x the largest entry, the JAX tests'
  own tolerances.  The TPU kernels use a polynomial atan2 that is off by
  up to about 2e-7 rad; that can move a pixel across a histogram bin
  edge, so slots whose histograms differ beyond the tolerance are counted
  (at most one may) and must keep their total weight.
* On one thread, K10 and K11's plain versions are bit-equal to K5 and
  K6's on ``grad_field_plain`` of the same stack: the port computes the
  gradient with K2's expressions in both.
* End to end on ``textured_image``, the stack path's features are the
  default path's, bit for bit, and its per-level octaves compute no
  gradient field.
* An octave that K1's chain entry takes gets its field from that entry
  (K2's plain field of its stack, bit for bit), never from K2, and on
  the stack path the entry is asked for none.
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from popsift_tpu.constants import DESC_MAGNIFY  # noqa: E402
from popsift_tpu.kernels import binwin as jbinwin  # noqa: E402

import popsift_torch  # noqa: E402
from popsift_torch import extract as text  # noqa: E402
from popsift_torch.gauss import build_gauss_info  # noqa: E402
from popsift_torch.kernels import blur as tblur  # noqa: E402
from popsift_torch.kernels import binwin  # noqa: E402
from popsift_torch.kernels.grad import grad_field_plain  # noqa: E402
from popsift_torch.ops import descriptors as tdesc  # noqa: E402
from popsift_torch.ops import orientation as tori  # noqa: E402
from popsift_torch.ops import pyramid as tpyr  # noqa: E402

SWITCH = "POPSIFT_TPU_STACK_KERNELS"


@contextlib.contextmanager
def one_thread():
    """PyTorch's CPU kernels evaluate atan2 (and sqrt) in vector or scalar
    form depending on how a call is split across threads, which can move
    the last bit; on one thread, repeated computations are bit-equal."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _smooth_stack(rng, L, h, w):
    stack = rng.random((L, h, w)).astype(np.float32)
    for _ in range(2):
        stack = (stack + np.roll(stack, 1, 1) + np.roll(stack, 1, 2)) / 3
    return stack


def _ori_inputs():
    """tests/test_kernels.py:test_ori_hist_stack_kernel_interpret."""
    rng = np.random.default_rng(21)
    L, h, w = 3, 80, 420
    stack = _smooth_stack(rng, L, h, w)
    n = 16
    x = np.concatenate([rng.uniform(2, w - 3, n - 4),
                        [1.2, w - 2.3, 5.0, w - 5.0]]).astype(np.float32)
    y = np.concatenate([rng.uniform(2, h - 3, n - 4),
                        [1.1, h - 2.2, h - 4.0, 2.5]]).astype(np.float32)
    lv = rng.integers(0, L, n).astype(np.int32)
    sig = rng.uniform(1.2, 3.2, n).astype(np.float32)
    return stack, x, y, lv, sig


def _desc_inputs():
    """tests/test_kernels.py:test_desc_loop_stack_kernel_interpret."""
    rng = np.random.default_rng(23)
    L, h, w = 2, 96, 400
    stack = _smooth_stack(rng, L, h, w)
    n = 12
    x = np.concatenate([rng.uniform(2, w - 3, n - 4),
                        [1.5, w - 2.5, 3.0, w - 4.0]]).astype(np.float32)
    y = np.concatenate([rng.uniform(2, h - 3, n - 4),
                        [1.4, h - 2.1, 2.0, h - 3.5]]).astype(np.float32)
    lv = rng.integers(0, L, n).astype(np.int32)
    sig = rng.uniform(1.0, 2.2, n).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    return stack, x, y, lv, sig, ang


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("value,on", [(None, False), ("", False),
                                      ("0", False), ("1", True)])
def test_switch_is_read_at_call_time(monkeypatch, value, on):
    if value is None:
        monkeypatch.delenv(SWITCH, raising=False)
    else:
        monkeypatch.setenv(SWITCH, value)
    assert binwin.stack_kernels_enabled() is on
    assert jbinwin.stack_kernel_ok((3, 80, 420), 40) is on


def test_ori_hist_stack_matches_jax_interpret(monkeypatch):
    monkeypatch.setenv(SWITCH, "1")
    stack, x, y, lv, sig = _ori_inputs()
    win = 40
    assert jbinwin.stack_kernel_ok(stack.shape, win)
    _, h, w = stack.shape
    lp, ya, xa, dxm, ox1, oy1 = jbinwin._stack_origins(
        jnp.asarray(stack), jnp.asarray(lv), jnp.asarray(x),
        jnp.asarray(y), win)
    ref = np.asarray(jbinwin.ori_hist_stack_pallas(
        jnp.asarray(stack), lp, ya, xa, dxm, ox1, oy1, x, y, sig,
        jnp.ones(x.shape, jnp.int32), win, w, h, interpret=True))
    got = binwin.ori_hist_stack(*_t(stack, x, y, lv, sig)).numpy()
    assert got.shape == (16, 36)
    close = np.isclose(got, ref, rtol=1e-5, atol=1e-5).all(axis=1)
    # a pixel moved across a bin edge by the polynomial atan2
    assert (~close).sum() <= 1, np.flatnonzero(~close)
    np.testing.assert_allclose(got.sum(axis=1), ref.sum(axis=1), rtol=1e-5,
                               atol=1e-5)
    assert (got.sum(axis=1) > 0).all()


def test_desc_loop_stack_matches_jax_interpret(monkeypatch):
    monkeypatch.setenv(SWITCH, "1")
    stack, x, y, lv, sig, ang = _desc_inputs()
    win = 48
    assert jbinwin.stack_kernel_ok(stack.shape, win)
    _, h, w = stack.shape
    lp, ya, xa, dxm, ox1, oy1 = jbinwin._stack_origins(
        jnp.asarray(stack), jnp.asarray(lv), jnp.asarray(x),
        jnp.asarray(y), win)
    ref = np.asarray(jbinwin.desc_loop_stack_pallas(
        jnp.asarray(stack), lp, ya, xa, dxm, ox1, oy1, x, y, sig, ang,
        jnp.ones(x.shape, jnp.int32), win, w, h, DESC_MAGNIFY,
        interpret=True))
    got = binwin.desc_loop_stack(*_t(stack, x, y, lv, sig, ang),
                                 win // 2).numpy()
    assert got.shape == (12, 128)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-4 * max(1.0, float(np.abs(ref).max())))


def _border_slots(rng, L, h, w, n):
    x = np.concatenate([rng.uniform(0, w - 1, n - 6),
                        [0.0, 0.6, w - 1.0, 1.4, w - 1.6, w / 2]])
    y = np.concatenate([rng.uniform(0, h - 1, n - 6),
                        [0.0, h - 1.0, 0.4, h - 1.4, 1.6, h - 0.6]])
    lv = rng.integers(-1, L + 1, n)      # clamped to 0..L-1 by both
    sig = rng.uniform(0.8, 6.0, n)
    sig[-1] = 0.0                        # zero scale: an all-zero row
    ang = rng.uniform(-np.pi, np.pi, n)
    return _t(x.astype(np.float32), y.astype(np.float32),
              lv.astype(np.int32), sig.astype(np.float32),
              ang.astype(np.float32))


@pytest.mark.parametrize("shape", [(6, 61, 97), (4, 33, 40)])
def test_stack_plain_is_field_plain_bit_for_bit(shape):
    rng = np.random.default_rng(31)
    stack = torch.as_tensor(_smooth_stack(rng, *shape))
    x, y, lv, sig, ang = _border_slots(rng, *shape, n=40)
    half = 28
    with one_thread():
        field = grad_field_plain(stack)
        h_field = binwin.ori_hist(field, x, y, lv, sig)
        h_stack = binwin.ori_hist_stack(stack, x, y, lv, sig)
        d_field = binwin.desc_loop(field, x, y, lv, sig, ang, half)
        d_stack = binwin.desc_loop_stack(stack, x, y, lv, sig, ang, half)
    assert torch.equal(h_stack, h_field)
    assert torch.equal(d_stack, d_field)
    assert h_field[:-1].sum(dim=1).gt(0).all()
    assert not d_field[-1].any()


def test_ops_route_to_the_stack_with_the_switch(monkeypatch):
    """The ops take the stack kernels exactly when their caller gives them
    a stack, and need no field then; the switch is read by
    extract_features alone, so the ops do the same with it on or off."""
    rng = np.random.default_rng(5)
    stack = torch.as_tensor(_smooth_stack(rng, 6, 48, 64))
    x, y, lv, sig, ang = _border_slots(rng, 6, 48, 64, n=12)
    field = grad_field_plain(stack)
    with one_thread():
        ref_ori = tori.assign_orientations(field, x, y, lv, sig)
        ref_desc = tdesc.loop_descriptors(field, x, y, lv, sig, ang, 56)
        got = {}
        for value in ("1", "0"):
            monkeypatch.setenv(SWITCH, value)
            got[value] = (
                tori.assign_orientations(None, x, y, lv, sig, stack=stack),
                tdesc.loop_descriptors(None, x, y, lv, sig, ang, 56,
                                       stack=stack),
                tori.assign_orientations(field, x, y, lv, sig),
                tdesc.loop_descriptors(field, x, y, lv, sig, ang, 56))
    for ori, desc, f_ori, f_desc in got.values():
        for a, b, c in zip(ori, f_ori, ref_ori):
            assert torch.equal(a, c) and torch.equal(b, c)
        assert torch.equal(desc, ref_desc) and torch.equal(f_desc, ref_desc)
    assert ref_ori[0].gt(0).any()


def test_switch_is_read_once_per_image(textured_image, monkeypatch):
    """extract_features reads the switch once and hands the answer to every
    octave, so a switch that flips during an extraction cannot mix the
    paths: here it reads "on" first and "off" ever after, and every octave
    still takes K10 and K11."""
    reads = []

    def flipping():
        reads.append(None)
        return len(reads) == 1
    monkeypatch.setattr(text, "stack_kernels_enabled", flipping)
    monkeypatch.setattr(tpyr, "grad_field", _no_field)
    monkeypatch.setattr(text, "grad_field", _no_field)
    calls = []
    real = binwin.desc_loop_stack_octaves

    def spy(stacks, *args):
        calls.append(None)
        return real(stacks, *args)
    monkeypatch.setattr(text, "desc_loop_stack_octaves", spy)
    monkeypatch.setattr(text, "ori_peaks_octaves", _no_field)
    monkeypatch.setattr(text, "desc_loop_octaves", _no_field)
    feats = text.extract_features(textured_image, popsift_torch.Config(),
                                  device="cpu")
    assert len(reads) == 1
    assert feats.get_feature_count() > 0 and calls


@pytest.fixture(scope="module")
def both_paths(textured_image):
    mp = pytest.MonkeyPatch()
    try:
        with one_thread():
            mp.delenv(SWITCH, raising=False)
            default = text.extract_features(textured_image,
                                            popsift_torch.Config(),
                                            device="cpu")
            mp.setenv(SWITCH, "1")
            # no K2 on the per-level octaves: the stack path never reads a
            # field there
            mp.setattr(tpyr, "grad_field", _no_field)
            mp.setattr(text, "grad_field", _no_field)
            stack = text.extract_features(textured_image,
                                          popsift_torch.Config(),
                                          device="cpu")
    finally:
        mp.undo()
    return default, stack


def _no_field(*args):
    raise AssertionError("the stack path used a gradient field")


def test_stack_path_features_equal_default_path(both_paths):
    default, stack = both_paths
    assert default.get_feature_count() == stack.get_feature_count() > 0
    sa, sb = default.soa(), stack.soa()
    for k in sa:
        np.testing.assert_array_equal(sb[k], sa[k], err_msg=k)
    np.testing.assert_array_equal(stack.get_descriptors(),
                                  default.get_descriptors())


def test_stack_path_takes_every_octave(textured_image, monkeypatch):
    """The switch alone gates the path: octaves below the JAX gate's 384
    columns take it too (every octave of this image is narrower)."""
    monkeypatch.setenv(SWITCH, "1")
    plan = text.make_plan(popsift_torch.Config(), textured_image.shape[1],
                          textured_image.shape[0])
    assert min(w for w, _ in plan.dims) < 384
    calls = []
    real = binwin.ori_peaks_stack_octaves

    def spy(stacks, *args):
        calls.extend(tuple(st.shape) for st in stacks)
        return real(stacks, *args)
    monkeypatch.setattr(text, "ori_peaks_stack_octaves", spy)
    monkeypatch.setattr(text, "ori_peaks_octaves", _no_field)
    text.extract_features(textured_image, popsift_torch.Config(),
                          device="cpu")
    assert calls and all(s[2] < 384 for s in calls)


def _no_k2(*args):
    raise AssertionError("K2 ran on an octave that K1's chain entry takes")


@pytest.fixture
def chain_octave(monkeypatch):
    """Octave 0 of a 60x100 image (120x200 after the upscale): too small
    for K7, taken by K1's chain entry.  The entry's calls are recorded by
    their ``emit_field``, and K2 may not run."""
    rng = np.random.default_rng(9)
    img = torch.as_tensor(rng.random((60, 100)).astype(np.float32))
    cfg = popsift_torch.Config()
    plan = text.make_plan(cfg, 100, 60)
    gauss = build_gauss_info(cfg)
    w, h = plan.dims[0]
    _, spans = tpyr.chain_filters(gauss, plan.levels)
    assert tblur.chain_fits(h, w, spans)
    assert not tpyr.chain_eligible(h, w, spans)
    calls = []
    real = tpyr.blur_chain

    def spy(*args, emit_field=False):
        calls.append(emit_field)
        return real(*args, emit_field=emit_field)
    monkeypatch.setattr(tpyr, "blur_chain", spy)
    monkeypatch.setattr(tpyr, "grad_field", _no_k2)

    def outputs(need_field):
        with one_thread():
            return tpyr.octave_outputs(img, 0, plan.dims, plan.levels, gauss,
                                       plan.sift_mode, plan.upscale_factor,
                                       False, need_field=need_field)
    return outputs, calls


def test_chain_octave_field_comes_from_the_chain_entry(chain_octave):
    outputs, calls = chain_octave
    stack, down, dog, field = outputs(True)
    assert calls == [True]
    assert stack.shape == (6, 120, 200) and torch.equal(down, stack[3])
    with one_thread():
        assert torch.equal(field, grad_field_plain(stack))
    assert dog.shape == (5, 120, 200)


def test_stack_path_asks_the_chain_entry_for_no_field(chain_octave):
    outputs, calls = chain_octave
    stack, _, dog, field = outputs(False)
    assert calls == [False] and field is None
    ref_stack, _, ref_dog, _ = outputs(True)
    assert torch.equal(stack, ref_stack) and torch.equal(dog, ref_dog)
