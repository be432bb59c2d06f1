"""Stage 2 in one pass over every octave against its per-octave
composition, and the kernels' octave tables.

``extract.stage2_features`` runs orientation, the descriptor rows,
descriptors, normalisation and quantisation once over the extrema of
every octave.  Here it is held, bit for bit, to a composition of the
single-octave kernel wrappers octave by octave, with the per-octave row
rule (each octave's rows clamped at its own orientation capacity),
followed by the same normalisation and quantisation of the rows laid end
to end, and the octaves' keypoints laid end to end in the one
feature-ordered record it returns (``features.Stage2Result``): in every
descriptor mode and on the stack-kernel path, with a clamp that bites
inside a middle octave's extremum, with a ``ks`` clamp
(``parallel/batch.py``), with empty octaves in the middle and at the
end, and with the descriptors kept on the device.  The kernel tests hold
a table launch of K5, K6 and K9 over three octaves of different sizes to
three one-entry launches, and ``kernels/_lib.octave_table`` (the table
the card's launches take) to its layout on the CPU.

Every test runs on the CPU (the plain versions) and, marked ``card``, on
a CUDA card, where it skips without one.  The file imports no JAX:
``python -m pytest --noconftest -m card tests/test_torch_stage2_batched.py``
runs the card's cases on a machine without it.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import popsift_torch  # noqa: E402
from popsift_torch import extract as text  # noqa: E402
from popsift_torch.config import DescMode, NormMode  # noqa: E402
from popsift_torch.constants import build_const_info  # noqa: E402
from popsift_torch.features import Stage2Result  # noqa: E402
from popsift_torch.gauss import build_gauss_info  # noqa: E402
from popsift_torch.kernels import _lib  # noqa: E402
from popsift_torch.kernels import binwin, desc_grid  # noqa: E402
from popsift_torch.ops import descriptors as tdesc  # noqa: E402

DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.card)]
# the descriptor modes, and the loop mode on the stack kernels (K10, K11)
MODES = ["loop", "notile", "igrid", "grid", "iloop", "stack"]


@pytest.fixture(params=DEVICES)
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return request.param


def _image() -> np.ndarray:
    """A smooth random texture, 96 x 128, with keypoints in five
    octaves."""
    rng = np.random.default_rng(20)
    img = np.kron(rng.random((12, 16)), np.ones((8, 8)))
    for _ in range(2):
        img = (img + np.roll(img, 1, 0) + np.roll(img, -1, 0)
               + np.roll(img, 1, 1) + np.roll(img, -1, 1)) / 5.0
    img = (img - img.min()) / (img.max() - img.min())
    return (img * 255).astype(np.uint8)


_STAGE1 = {}


def _stage1(device):
    """Stage 1 of the image on ``device``: per octave (o, stack, field,
    Extrema), every stack whole and every field made, so that each mode
    reads what it needs."""
    if device not in _STAGE1:
        cfg = popsift_torch.Config()
        img = _image()
        plan = text.make_plan(cfg, img.shape[1], img.shape[0])
        out = text.octave_keypoints_all(
            plan, build_gauss_info(cfg), text.to_unit_image(img, device),
            full_stacks=True, need_field=True)
        _STAGE1[device] = [(o, s, f, e) for o, (s, f, e) in enumerate(out)]
    return _STAGE1[device]


def _setup(mode: str, device):
    cfg = popsift_torch.Config()
    stack_kernels = mode == "stack"
    cfg.set_desc_mode("loop" if stack_kernels else mode)
    img = _image()
    plan = text.make_plan(cfg, img.shape[1], img.shape[0])
    consts = (build_const_info(cfg, device=device)
              if plan.desc_mode in (DescMode.NOTILE, DescMode.IGRID)
              else None)
    return cfg, plan, consts, stack_kernels


def _one_octave_descriptors(plan, consts, stack, field, rows,
                            stack_kernels):
    """The single-octave wrapper of the plan's descriptor mode."""
    win = plan.desc_win
    if plan.desc_mode == DescMode.LOOP:
        if stack_kernels:
            return binwin.desc_loop_stack(stack, *rows, win // 2)
        return binwin.desc_loop(field, *rows, win // 2)
    if plan.desc_mode == DescMode.GRID:
        return desc_grid.desc_grid_rounded_stack(stack, *rows, win)
    if plan.desc_mode == DescMode.ILOOP:
        return desc_grid.desc_iloop_stack(stack, *rows, win)
    return desc_grid.desc_grid_stack(stack, *rows, win, consts.desc_gauss,
                                     consts.desc_tile)


def _per_octave(plan, octaves, desc_transfer, consts, stack_kernels,
                want_dev):
    """Stage 2 composed octave by octave from the single-octave wrappers
    and the per-octave row rule, then one normalisation and quantisation
    of every octave's rows, as the record of the octaves end to end."""
    raws, keypoints, totals, clamped = [], [], [], []
    for o, stack, field, ext in octaves:
        n = ext.count
        kp = (ext.xpos, ext.ypos, ext.lpos, ext.sigma)
        if n:
            num, oris = (binwin.ori_peaks_stack(stack, *kp) if stack_kernels
                         else binwin.ori_peaks(field, *kp))
        else:
            num = torch.zeros(0, dtype=torch.int32, device=stack.device)
            oris = torch.zeros((0, 4), dtype=torch.float32,
                               device=stack.device)
        num = num.to(torch.int64)
        incl = torch.cumsum(num, 0)
        total = int(incl[-1]) if n else 0
        rows = min(total, plan.ori_caps[o])
        feat = torch.repeat_interleave(
            torch.arange(n, device=num.device), num)[:rows]
        first = incl - num
        k = torch.arange(rows, device=num.device) - first[feat]
        num_eff = torch.clamp(torch.minimum(num, rows - first), min=0)
        raws.append(_one_octave_descriptors(
            plan, consts, stack, field,
            tuple(v[feat] for v in kp) + (oris[feat, k],), stack_kernels))
        keypoints.append(np.concatenate((np.stack(
            [ext.xpos.cpu().numpy(), ext.ypos.cpu().numpy(),
             ext.sigma.cpu().numpy(),
             num_eff.to(torch.float32).cpu().numpy()], axis=1),
            oris.cpu().numpy()), axis=1))
        totals.append(total)
        clamped.append(rows)
    raw = torch.cat(raws)
    if plan.norm_mode == NormMode.ROOT_SIFT:
        raw = tdesc.normalize_rootsift(raw, plan.norm_multi)
    else:
        raw = tdesc.normalize_l2(raw, plan.norm_multi)
    desc = (text.quantize_descs_dev if want_dev else text.quantize_descs)(
        raw, desc_transfer, plan.norm_multi)
    return Stage2Result(
        keypoints=np.concatenate(keypoints),
        octave=np.concatenate([np.full(e.count, o, np.int32)
                               for o, _, _, e in octaves]),
        desc=desc, overflow=tuple(e.overflow for _, _, _, e in octaves),
        ori_count=tuple(totals), rows=tuple(clamped))


def _num_ori(res: Stage2Result, o: int) -> np.ndarray:
    """The clamped ``num_ori`` of octave o's extrema."""
    return res.num_ori[res.octave == o]


def _assert_same(got: Stage2Result, want: Stage2Result,
                 want_dev: bool) -> None:
    assert isinstance(got, Stage2Result)
    for k in ("keypoints", "octave", "num_ori", "orientations"):
        g, w = getattr(got, k), getattr(want, k)
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    assert got.ori_count == want.ori_count
    assert got.overflow == want.overflow
    assert got.rows == want.rows
    for o, rows in enumerate(want.rows):
        assert int(_num_ori(got, o).sum()) == rows, o
    if want_dev:
        assert isinstance(got.desc, torch.Tensor)
        assert got.desc.device == want.desc.device
        assert torch.equal(got.desc, want.desc)
    else:
        assert got.desc.dtype == want.desc.dtype == np.float32
        np.testing.assert_array_equal(got.desc, want.desc)


def _check(plan, octaves, cfg, consts, stack_kernels, want_dev=False):
    got = text.stage2_features(plan, octaves, cfg.desc_transfer,
                               consts=consts, stack_kernels=stack_kernels,
                               want_dev=want_dev)
    want = _per_octave(plan, octaves, cfg.desc_transfer, consts,
                       stack_kernels, want_dev)
    _assert_same(got, want, want_dev)
    return want


@pytest.mark.parametrize("mode", MODES)
def test_every_octave_in_one_pass(mode, device):
    cfg, plan, consts, stack_kernels = _setup(mode, device)
    octaves = _stage1(device)
    with_kp = [o for o, _, _, e in octaves if e.count]
    assert len(with_kp) >= 4
    want = _check(plan, octaves, cfg, consts, stack_kernels)
    assert sum(want.rows) > want.keypoints.shape[0]


def _middle_cap(plan, octaves, stack_kernels):
    """A plan whose orientation capacity at a middle octave ends inside an
    extremum with two or more orientations, and that octave."""
    mids = [(o, s, f, e) for o, s, f, e in octaves if e.count][1:-1]
    for o, stack, field, ext in mids:
        kp = (ext.xpos, ext.ypos, ext.lpos, ext.sigma)
        num = (binwin.ori_peaks_stack(stack, *kp) if stack_kernels
               else binwin.ori_peaks(field, *kp))[0].cpu().numpy()
        multi = np.flatnonzero(num[1:] >= 2) + 1
        if multi.size:
            e = int(multi[multi.size // 2])
            cap = int(num[:e].sum()) + 1
            caps = list(plan.ori_caps)
            caps[o] = cap
            return dataclasses.replace(plan, ori_caps=tuple(caps)), o
    raise AssertionError("no middle octave with a multi-orientation "
                         "extremum")


@pytest.mark.parametrize("mode", ["loop", "notile", "stack"])
def test_orientation_capacity_bites_in_a_middle_octave(mode, device):
    cfg, plan, consts, stack_kernels = _setup(mode, device)
    octaves = _stage1(device)
    plan, o = _middle_cap(plan, octaves, stack_kernels)
    want = _check(plan, octaves, cfg, consts, stack_kernels)
    assert want.rows[o] == plan.ori_caps[o] < want.ori_count[o]
    # the cut falls inside an extremum: it keeps one of its orientations
    num = _num_ori(want, o)
    assert num[-1] == 0 and 0 < num[num > 0][-1]
    assert sum(r for i, r in enumerate(want.rows) if i != o) == sum(
        c for i, c in enumerate(want.ori_count) if i != o)


@pytest.mark.parametrize("mode", ["loop", "grid", "stack"])
def test_ks_clamp(mode, device):
    """The first ks[o] extrema of each octave, as parallel/batch.py's key
    clamps them (extract_octaves' ``ks``)."""
    cfg, plan, consts, stack_kernels = _setup(mode, device)
    octaves = _stage1(device)
    ks = tuple(max(e.count // 2, 1) if e.count > 3 else e.count
               for _, _, _, e in octaves)
    clamped = [(o, s, f, text._first(e, k))
               for (o, s, f, e), k in zip(octaves, ks)]
    assert any(e.count < k.count for (_, _, _, e), (_, _, _, k)
               in zip(clamped, octaves))
    _check(plan, clamped, cfg, consts, stack_kernels)


@pytest.mark.parametrize("mode", ["loop", "iloop", "stack"])
def test_empty_octaves_in_the_middle_and_at_the_end(mode, device):
    cfg, plan, consts, stack_kernels = _setup(mode, device)
    octaves = list(_stage1(device))
    with_kp = [i for i, (_, _, _, e) in enumerate(octaves) if e.count]
    for i in (with_kp[1], with_kp[-1]):
        o, s, f, e = octaves[i]
        octaves[i] = (o, s, f, text._first(e, 0))
    want = _check(plan, octaves, cfg, consts, stack_kernels)
    for i in (with_kp[1], with_kp[-1]):
        assert _num_ori(want, i).shape == (0,) and want.rows[i] == 0


@pytest.mark.parametrize("mode", ["loop", "notile", "stack"])
def test_descriptors_kept_on_the_device(mode, device):
    cfg, plan, consts, stack_kernels = _setup(mode, device)
    _check(plan, _stage1(device), cfg, consts, stack_kernels, want_dev=True)


def test_no_extrema_anywhere(device):
    cfg, plan, consts, _ = _setup("loop", device)
    octaves = [(o, s, f, text._first(e, 0)) for o, s, f, e in
               _stage1(device)]
    for want_dev in (False, True):
        got = text.stage2_features(plan, octaves, cfg.desc_transfer,
                                   want_dev=want_dev)
        assert tuple(got.desc.shape) == (0, 128)
        assert got.orientations.shape == (0, 4) and got.octave.shape == (0,)
        assert got.ori_count == got.rows == (0,) * len(octaves)


def test_extract_octaves_ks_matches_the_clamped_pass(device):
    """extract_octaves clamps with ``ks`` before its one pass, as
    KeyedExtractor calls it."""
    cfg, plan, consts, _ = _setup("loop", device)
    octaves = _stage1(device)
    ks = tuple(max(e.count - 2, 0) for _, _, _, e in octaves)
    got, _, _ = text.extract_octaves(_image(), cfg, plan, device,
                                     want_dev=True, ks=ks)
    want = _per_octave(plan, [(o, s, f, text._first(e, k)) for
                              (o, s, f, e), k in zip(octaves, ks)],
                       cfg.desc_transfer, consts, False, True)
    _assert_same(got, want, True)


# ---------------------------------------------------------------------
# The kernels' octave tables


def _three_octaves(device):
    """Three octaves of different sizes from stage 1 (fields, stacks and
    extrema) with their loop-descriptor rows."""
    octaves = [q for q in _stage1(device) if q[3].count][:3]
    assert len({tuple(s.shape) for _, s, _, _ in octaves}) == 3
    rows = []
    for _, stack, field, ext in octaves:
        kp = (ext.xpos, ext.ypos, ext.lpos, ext.sigma)
        num, oris = binwin.ori_peaks(field, *kp)
        feat = torch.repeat_interleave(
            torch.arange(ext.count, device=num.device), num.to(torch.int64))
        first = torch.cumsum(num.to(torch.int64), 0) - num
        k = torch.arange(feat.shape[0], device=num.device) - first[feat]
        rows.append(tuple(v[feat] for v in kp) + (oris[feat, k],))
    return octaves, rows


def _cat(parts):
    return tuple(torch.cat(p) for p in zip(*parts))


def test_table_launch_of_k5_equals_one_entry_launches(device):
    octaves, _ = _three_octaves(device)
    fields = [f for _, _, f, _ in octaves]
    counts = [e.count for _, _, _, e in octaves]
    kps = [(e.xpos, e.ypos, e.lpos, e.sigma) for _, _, _, e in octaves]
    n = sum(counts)
    hist = torch.empty((n, 36), dtype=torch.float32, device=fields[0].device)
    num, ang = binwin.ori_peaks_octaves(fields, counts, *_cat(kps), hist=hist)
    one = [binwin.ori_peaks(f, *kp) for f, kp in zip(fields, kps)]
    assert torch.equal(num, torch.cat([a for a, _ in one]))
    assert torch.equal(ang, torch.cat([b for _, b in one]))
    assert torch.equal(hist, torch.cat([binwin.ori_hist(f, *kp)
                                        for f, kp in zip(fields, kps)]))
    # a table of one entry is the single-octave call
    n0, a0 = binwin.ori_peaks_octaves(fields[:1], counts[:1], *kps[0])
    assert torch.equal(n0, one[0][0]) and torch.equal(a0, one[0][1])
    # the stack form (K10) on the same octaves
    stacks = [s for _, s, _, _ in octaves]
    ns, as_ = binwin.ori_peaks_stack_octaves(stacks, counts, *_cat(kps))
    one_s = [binwin.ori_peaks_stack(s, *kp) for s, kp in zip(stacks, kps)]
    assert torch.equal(ns, torch.cat([a for a, _ in one_s]))
    assert torch.equal(as_, torch.cat([b for _, b in one_s]))


def test_table_launch_of_k6_equals_one_entry_launches(device):
    octaves, rows = _three_octaves(device)
    fields = [f for _, _, f, _ in octaves]
    stacks = [s for _, s, _, _ in octaves]
    counts = [r[0].shape[0] for r in rows]
    half = 28
    got = binwin.desc_loop_octaves(fields, counts, *_cat(rows), half)
    want = torch.cat([binwin.desc_loop(f, *r, half)
                      for f, r in zip(fields, rows)])
    assert torch.equal(got, want) and got.abs().sum() > 0
    assert torch.equal(binwin.desc_loop_octaves(fields[1:2], counts[1:2],
                                                *rows[1], half),
                       binwin.desc_loop(fields[1], *rows[1], half))
    got_s = binwin.desc_loop_stack_octaves(stacks, counts, *_cat(rows), half)
    assert torch.equal(got_s, torch.cat([binwin.desc_loop_stack(s, *r, half)
                                         for s, r in zip(stacks, rows)]))


@pytest.mark.parametrize("kernel", ["grid", "rounded", "iloop"])
def test_table_launch_of_k9_k12_k13_equals_one_entry_launches(kernel,
                                                              device):
    octaves, rows = _three_octaves(device)
    stacks = [s for _, s, _, _ in octaves]
    counts = [r[0].shape[0] for r in rows]
    win = 56
    tables = ()
    if kernel == "grid":
        consts = build_const_info(popsift_torch.Config(), device=device)
        tables = (consts.desc_gauss, consts.desc_tile)
    many, one = {
        "grid": (desc_grid.desc_grid_stack_octaves,
                 desc_grid.desc_grid_stack),
        "rounded": (desc_grid.desc_grid_rounded_stack_octaves,
                    desc_grid.desc_grid_rounded_stack),
        "iloop": (desc_grid.desc_iloop_stack_octaves,
                  desc_grid.desc_iloop_stack)}[kernel]
    got = many(stacks, counts, *_cat(rows), win, *tables)
    want = torch.cat([one(s, *r, win, *tables) for s, r in zip(stacks, rows)])
    assert torch.equal(got, want) and got.abs().sum() > 0
    assert torch.equal(many(stacks[2:], counts[2:], *rows[2], win, *tables),
                       one(stacks[2], *rows[2], win, *tables))


def test_table_rejects_counts_that_do_not_add_up():
    field = torch.zeros((4, 8, 8))
    x = torch.zeros(3)
    with pytest.raises(ValueError):
        binwin.ori_peaks_octaves([field, field], [1, 1], x, x,
                                 x.to(torch.int32), x)
    with pytest.raises(ValueError):
        desc_grid.desc_grid_rounded_stack_octaves([field], [2], x, x,
                                                  x.to(torch.int32), x, x,
                                                  56)


@pytest.mark.parametrize("n_octaves", [2, 9, 25, 30])
def test_octave_table_layout(n_octaves):
    """The card's table: octaves without slots take no entry, each entry's
    first slot counts from the launch's first slot, and a launch holds
    every octave a Config can ask for, no more."""
    srcs = [torch.zeros((2 + o % 3, 4 + o, 5 + o)) for o in range(n_octaves)]
    counts = [(o * 7) % 5 for o in range(n_octaves)]   # some empty
    live = [(s, c) for s, c in zip(srcs, counts) if c]
    if len(live) > _lib.MAX_OCTAVES:
        with pytest.raises(ValueError):
            _lib.octave_table(srcs, counts)
        return
    table, k = _lib.octave_table(srcs, counts)
    fields, _ = _lib.octave_table(srcs, counts, 2)     # two planes a level
    assert k == len(live) and len(table) == 5 * k
    first = 0
    for i, (src, c) in enumerate(live):
        assert tuple(table[5 * i:5 * i + 5]) == (
            src.data_ptr(), first, src.shape[0], src.shape[1], src.shape[2])
        assert fields[5 * i + 2] == src.shape[0] // 2
        first += c
