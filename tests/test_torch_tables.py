"""popsift_torch host tables against popsift_tpu's, field by field, plus
the port's import boundary and its refusal to fall back to the CPU."""

import dataclasses
import enum
import importlib
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

from popsift_tpu import config as jcfg  # noqa: E402
from popsift_tpu import constants as jconst  # noqa: E402
from popsift_tpu import extract as jext  # noqa: E402
from popsift_tpu import gauss as jgauss  # noqa: E402

import popsift_torch  # noqa: E402
from popsift_torch import config as tcfg  # noqa: E402
from popsift_torch import constants as tconst  # noqa: E402
from popsift_torch import extract as text  # noqa: E402
from popsift_torch import gauss as tgauss  # noqa: E402
from popsift_torch import tables  # noqa: E402
from popsift_torch.ops.extrema import Candidates  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SWEEP = [(levels, sigma, up)
         for levels in (2, 3, 4, 5)
         for sigma in (1.2, 1.6, 2.0)
         for up in (0.0, 1.0)]
SIZES = [(64, 48), (160, 120), (128, 96), (640, 480), (1920, 1080)]


def _configs(levels, sigma, up):
    j = jcfg.Config(levels=levels, sigma=sigma, upscale_factor=up)
    t = tcfg.Config(levels=levels, sigma=sigma, upscale_factor=up)
    return j, t


def _plain(v):
    """Enums by value, tuples recursively, so both packages compare."""
    if isinstance(v, enum.Enum):
        return v.value
    if isinstance(v, tuple):
        return tuple(_plain(x) for x in v)
    return v


def _gauss_dict(info):
    out = {}
    for fam in ("inc", "abs_o0", "abs_oN", "dd"):
        t = getattr(info, fam)
        out[fam] = dict(sigma=np.asarray(t.sigma), span=np.asarray(t.span),
                        filter=np.asarray(t.filter))
    out["required_filter_stages"] = info.required_filter_stages
    return out


def _const_dict(ci):
    return {f.name: getattr(ci, f.name) for f in dataclasses.fields(ci)}


def _assert_gauss_equal(a, b):
    for fam in ("inc", "abs_o0", "abs_oN", "dd"):
        for k in ("sigma", "span", "filter"):
            x, y = a[fam][k], b[fam][k]
            assert x.dtype == y.dtype and x.shape == y.shape, (fam, k)
            np.testing.assert_array_equal(x, y, err_msg=f"{fam}.{k}")
    assert a["required_filter_stages"] == b["required_filter_stages"]


@pytest.mark.parametrize("levels,sigma,up", SWEEP)
def test_config_derivations_match(levels, sigma, up):
    j, t = _configs(levels, sigma, up)
    assert t.get_peak_threshold() == j.get_peak_threshold()
    assert _plain(t.static_key()) == _plain(j.static_key())
    for w, h in SIZES:
        assert t.scaled_dims(w, h) == j.scaled_dims(w, h)
        assert t.num_octaves_for(w, h) == j.num_octaves_for(w, h)


@pytest.mark.parametrize("levels,sigma,up", SWEEP)
def test_gauss_info_matches(levels, sigma, up):
    j, t = _configs(levels, sigma, up)
    _assert_gauss_equal(_gauss_dict(tgauss.build_gauss_info(t)),
                        _gauss_dict(jgauss.build_gauss_info(j)))


@pytest.mark.parametrize("mode", [m.value for m in jcfg.GaussMode])
def test_gauss_info_matches_every_span_mode(mode):
    j, t = jcfg.Config(), tcfg.Config()
    j.set_gauss_mode(mode)
    t.set_gauss_mode(mode)
    _assert_gauss_equal(_gauss_dict(tgauss.build_gauss_info(t)),
                        _gauss_dict(jgauss.build_gauss_info(j)))


@pytest.mark.parametrize("mode", [m.value for m in jcfg.GaussMode])
def test_gauss_table_max_span_matches(mode):
    j, t = jcfg.Config(), tcfg.Config()
    j.set_gauss_mode(mode)
    t.set_gauss_mode(mode)
    ji, ti = jgauss.build_gauss_info(j), tgauss.build_gauss_info(t)
    for fam in ("inc", "abs_o0", "abs_oN", "dd"):
        got, want = getattr(ti, fam).max_span, getattr(ji, fam).max_span
        assert type(got) is type(want) is int and got == want, fam


def test_get_can_filter_extrema_matches():
    assert (tcfg.Config().get_can_filter_extrema()
            is jcfg.Config().get_can_filter_extrema() is True)


def test_siftjob_img_matches(monkeypatch):
    """set_img/get_img as the JAX SiftJob has them, and what the worker
    sets: the image as staged onto the pipeline's device (bytes as they
    are, floats normalised), None before the staging and after a failed
    one."""
    from popsift_tpu import pipeline as jpipe
    from popsift_torch import pipeline as tpipe
    img = (np.arange(48, dtype=np.uint8) * 5).reshape(6, 8)
    for mod in (jpipe, tpipe):
        job = mod.SiftJob(8, 6, img, tcfg.Config())
        assert job.get_img() is None
        marker = object()
        job.set_img(marker)
        assert job.get_img() is marker
    img = np.random.default_rng(0).integers(0, 256, (48, 64), np.uint8)
    with popsift_torch.PopSift(popsift_torch.Config(), device="cpu") as ps:
        job = ps.enqueue(64, 48, img)
        job.get()
        got = job.get_img()
        assert got.device.type == "cpu" and got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), img)
    with popsift_torch.PopSift(popsift_torch.Config(), device="cpu",
                               imode=popsift_torch.ImageMode.FLOAT) as ps:
        job = ps.enqueue(64, 48, img.astype(np.float32) / 255.0)
        job.get()
        assert job.get_img().dtype == torch.float32
        np.testing.assert_array_equal(job.get_img().numpy(),
                                      text.normalize_input(img))

    def fail(*_):
        raise RuntimeError("staging failed")
    monkeypatch.setattr(tpipe.StageIn, "stage", fail)
    with popsift_torch.PopSift(popsift_torch.Config(), device="cpu") as ps:
        job = ps.enqueue(64, 48, img)
        with pytest.raises(RuntimeError, match="staging failed"):
            job.get()
        assert job.get_img() is None


# Public members of a mirrored JAX class that the port leaves out, as
# (class, member): the reason, citing ROADMAP Queue 1's "Not ported, by
# design".  Empty: the port has every one.
NOT_PORTED = {}
MIRRORED = ["config.Config", "pipeline.SiftJob", "pipeline.PopSift",
            "gauss.GaussTable", "features.FeaturesHost",
            "features.FeaturesDev"]


def _public(cls) -> set:
    names = {n for n in dir(cls) if not n.startswith("_")}
    if dataclasses.is_dataclass(cls):
        names |= {f.name for f in dataclasses.fields(cls)
                  if not f.name.startswith("_")}
    return names


@pytest.mark.parametrize("path", MIRRORED)
def test_public_surface_is_ported(path):
    """Every public member (methods, properties, class attributes and
    dataclass fields) of the JAX class is in the port's, except those on
    NOT_PORTED, each of which is really missing and has its reason."""
    mod, name = path.split(".")
    jcls = getattr(importlib.import_module(f"popsift_tpu.{mod}"), name)
    tcls = getattr(importlib.import_module(f"popsift_torch.{mod}"), name)
    allowed = {m for (c, m) in NOT_PORTED if c == name}
    assert all(NOT_PORTED[(name, m)].strip() for m in allowed)
    missing = _public(jcls) - _public(tcls)
    assert missing == allowed, sorted(missing ^ allowed)


@pytest.mark.parametrize("levels,sigma,up", SWEEP[::3])
def test_const_info_matches(levels, sigma, up):
    j, t = _configs(levels, sigma, up)
    jc = _const_dict(jconst.build_const_info(j))
    tc = _const_dict(tconst.build_const_info(t))
    for k, v in jc.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(tc[k].numpy(), v, err_msg=k)
        else:
            assert tc[k] == v, k
    assert tconst.ORI_NBINS == jconst.ORI_NBINS
    assert tconst.DESC_MAGNIFY == jconst.DESC_MAGNIFY
    assert tconst.M_4RPI == jconst.M_4RPI and tconst.M_PI2 == jconst.M_PI2


@pytest.mark.parametrize("w,h", SIZES)
@pytest.mark.parametrize("levels,up", [(3, 1.0), (3, 0.0), (2, 1.0),
                                       (5, 0.0)])
def test_make_plan_matches(w, h, levels, up):
    """Every field as the JAX package plans it but the capacities, which
    are the reference's: each octave keeps up to max_extrema extrema
    (1.25x that in descriptor rows), and never fewer candidates than the
    JAX package's fixed buffers hold."""
    j, t = _configs(levels, 1.6, up)
    jp = jext.make_plan(j, w, h)
    tp = text.make_plan(t, w, h)
    caps = ("cand_caps", "ext_caps", "ori_caps")
    for f in dataclasses.fields(jp):
        if f.name not in caps:
            assert _plain(getattr(tp, f.name)) == \
                _plain(getattr(jp, f.name)), f.name
    assert tp.ext_caps == (t.max_extrema,) * tp.octaves
    assert tp.ori_caps == (125056,) * tp.octaves
    assert all(c >= jc for c, jc in zip(tp.cand_caps, jp.cand_caps))


def test_default_plan_at_1080p():
    p = text.make_plan(tcfg.Config(), 1920, 1080)
    assert p.octaves == 9
    assert p.dims[0] == (3840, 2160) and p.dims[-1] == (15, 9)
    # the budget's bound, 16 of each 1024 voxels, and max_extrema
    assert (p.cand_caps[0], p.ext_caps[0]) == (388864, 100000)
    assert (p.ori_win, p.desc_win) == (48, 112)
    g = tgauss.build_gauss_info(tcfg.Config())
    assert [int(s) for s in g.inc.span] == [6, 6, 8, 9, 11, 14]


@pytest.mark.parametrize("levels,sigma,up", SWEEP[::4])
def test_from_numpy_round_trips(levels, sigma, up):
    j, t = _configs(levels, sigma, up)
    g_arr = _gauss_dict(jgauss.build_gauss_info(j))
    c_arr = _const_dict(jconst.build_const_info(j))
    gauss, consts = tables.from_numpy(g_arr, c_arr, device="cpu")
    # the carried tables equal the ones the port builds itself ...
    _assert_gauss_equal(_gauss_dict(gauss),
                        _gauss_dict(tgauss.build_gauss_info(t)))
    own = tconst.build_const_info(t)
    for f in dataclasses.fields(own):
        a, b = getattr(consts, f.name), getattr(own, f.name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f.name
        else:
            assert a == b, f.name
    # ... and survive to_numpy -> from_numpy unchanged
    g2, c2 = tables.to_numpy(gauss, consts)
    _assert_gauss_equal(g2, g_arr)
    for k, v in c_arr.items():
        np.testing.assert_array_equal(np.asarray(c2[k]), np.asarray(v))


@pytest.mark.parametrize("dtype", [np.uint8, np.float32, np.float64])
def test_input_normalisation_matches(dtype):
    rng = np.random.default_rng(9)
    img = rng.integers(0, 256, (12, 17)).astype(dtype)
    if dtype != np.uint8:
        img = img / 255.0
    ref = jext.normalize_input(img)
    host = text.normalize_input(img)
    assert host.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(host, ref)
    if dtype == np.uint8:
        # bytes are scaled on the device by 1/255 (staged.py:169)
        ref = img.astype(np.float32) * np.float32(1.0 / 255.0)
    np.testing.assert_array_equal(text.to_unit_image(img, "cpu").numpy(),
                                  ref)


def test_from_numpy_rejects_bad_shapes():
    j = jcfg.Config()
    g_arr = _gauss_dict(jgauss.build_gauss_info(j))
    g_arr["inc"]["filter"] = g_arr["inc"]["filter"][:, :16]
    with pytest.raises(ValueError):
        tables.from_numpy(g_arr, _const_dict(jconst.build_const_info(j)))


def test_port_imports_neither_jax_nor_popsift_tpu():
    """Every module of popsift_torch, found by walking the package, imports
    without importing JAX or popsift_tpu, and so does each accuracy tool's
    --help, which imports no imaging library (PIL) either."""
    code = ("import pkgutil, sys, importlib, popsift_torch\n"
            "names = [m.name for m in pkgutil.walk_packages(\n"
            "    popsift_torch.__path__, 'popsift_torch.')]\n"
            "for name in names:\n"
            "    importlib.import_module(name)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'popsift_tpu'))\n"
            "print(len(names), names, bad)\n"
            "needed = {'popsift_torch.cli.demo', 'popsift_torch.io.pgm', "
            "'popsift_torch.parallel.batch', 'popsift_torch.parallel.dryrun', "
            "'popsift_torch.eval.repeatability', 'popsift_torch.tracing', "
            "'popsift_torch.device', 'popsift_torch.debugdump', "
            "'popsift_torch.wirecodec', 'popsift_torch.eval.oxford', "
            "'popsift_torch.eval.parity'}\n"
            "import runpy\n"
            "for tool in ('torch_oxford_protocol', 'torch_oxford_parity', "
            "'torch_parity_pack'):\n"
            "    sys.argv = [tool, '--help']\n"
            "    try:\n"
            "        runpy.run_path(f'tools/{tool}.py', run_name='__main__')\n"
            "    except SystemExit as e:\n"
            "        assert e.code == 0, (tool, e.code)\n"
            "    else:\n"
            "        raise AssertionError(tool + ' --help did not exit')\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'popsift_tpu', 'PIL'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad or not needed <= set(names) else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


STUB_NVCC = """#!/bin/sh
echo "$*" >> "{log}"
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
sleep 2
: > "$out"
"""


def test_concurrent_first_uses_build_the_library_once(tmp_path):
    """Three processes that need the kernel library at once, on a tree
    where it is not built (as the ranks of one host do), build it once:
    _lib._ensure_built holds a lock from the check to the end of the
    build.  nvcc is a stub that logs its calls, sleeps and writes its
    output file."""
    from popsift_torch.kernels import _lib
    log = tmp_path / "nvcc.log"
    stub = tmp_path / "bin" / "nvcc"
    stub.parent.mkdir()
    stub.write_text(STUB_NVCC.format(log=log))
    stub.chmod(0o755)
    target = tmp_path / "build" / "libstub.so"
    code = ("import sys\nfrom pathlib import Path\n"
            "from popsift_torch.kernels import _lib\n"
            "print(_lib._ensure_built(Path(sys.argv[1])))\n")
    env = dict(os.environ, PYTHONPATH=REPO,
               PATH=f"{stub.parent}{os.pathsep}{os.environ.get('PATH', '')}")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(target)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0], outs
    assert sorted(o.strip() for o, _ in outs) == ["False", "False", "True"]
    calls = log.read_text().splitlines()
    sources = sorted(_lib.CSRC.glob("*.cu"))
    assert len(calls) == len(sources) + 1, calls
    assert sum(" -shared " in c for c in calls) == 1
    assert target.exists()


def test_popsift_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        popsift_torch.PopSift(popsift_torch.Config())


def test_wrappers_take_the_kernel_path_off_the_cpu(monkeypatch):
    """A wrapper runs its plain version only for CPU tensors: any other
    tensor goes to the kernel library (refused here), never back to the
    plain version."""
    from popsift_torch.kernels import _lib, binwin, blur, desc_grid, \
        detect, grad, octave, refine, windows

    class Refused(Exception):
        pass

    def refuse(device):
        raise Refused(str(device))

    monkeypatch.setattr(_lib, "library", refuse)
    before = _lib.launches()

    def meta(*shape, dtype=torch.float32):
        return torch.empty(*shape, dtype=dtype, device="meta")

    taps = np.ones(4, np.float32)
    p = refine.refine_params(tcfg.SiftMode.POPSIFT, 32, 16, 5, 1.6, 1.26,
                             2.0, 10.0, 16.0, 8.0, 2)
    calls = [
        lambda: blur.sep_blur(meta(16, 32), taps, 4, with_dog=True),
        lambda: blur.blur_chain(meta(16, 32), [taps] * 4, (1, 4, 4, 4)),
        lambda: blur.blur_chain(meta(16, 32), [taps] * 4, (1, 4, 4, 4),
                                emit_field=True),
        lambda: grad.grad_field(meta(6, 16, 32)),
        lambda: detect.detect(meta(5, 16, 32), tcfg.SiftMode.POPSIFT, 2.0),
        lambda: refine.refine(meta(5, 16, 32), *(meta(3, dtype=torch.int32)
                                                 for _ in range(3)), p),
        lambda: binwin.ori_hist(meta(12, 16, 32), meta(3), meta(3),
                                meta(3, dtype=torch.int32), meta(3)),
        lambda: binwin.desc_loop(meta(12, 16, 32), meta(3), meta(3),
                                 meta(3, dtype=torch.int32), meta(3),
                                 meta(3), 56),
        lambda: octave.octave_chain(meta(40, 140), [taps] * 4, (1, 4, 4, 4),
                                    emit_stack=True),
        lambda: windows.gather_windows(meta(6, 16, 32),
                                       *(meta(3, dtype=torch.int32)
                                         for _ in range(3)), 8, 8),
        lambda: desc_grid.desc_grid_stack(
            meta(6, 16, 32), meta(3), meta(3), meta(3, dtype=torch.int32),
            meta(3), meta(3), 112, meta(40, 40), meta(16)),
        lambda: binwin.ori_hist_stack(meta(6, 16, 32), meta(3), meta(3),
                                      meta(3, dtype=torch.int32), meta(3)),
        lambda: binwin.desc_loop_stack(meta(6, 16, 32), meta(3), meta(3),
                                       meta(3, dtype=torch.int32), meta(3),
                                       meta(3), 56),
        lambda: desc_grid.desc_grid_rounded_stack(
            meta(6, 16, 32), meta(3), meta(3), meta(3, dtype=torch.int32),
            meta(3), meta(3), 112),
        lambda: desc_grid.desc_iloop_stack(
            meta(6, 16, 32), meta(3), meta(3), meta(3, dtype=torch.int32),
            meta(3), meta(3), 112),
        lambda: binwin.ori_peaks(meta(12, 16, 32), meta(3), meta(3),
                                 meta(3, dtype=torch.int32), meta(3),
                                 hist=meta(3, 36)),
        lambda: binwin.ori_peaks_stack(meta(6, 16, 32), meta(3), meta(3),
                                       meta(3, dtype=torch.int32), meta(3)),
        lambda: binwin.peaks_of_hist(meta(3, 36)),
        lambda: refine.refine_compact(
            meta(5, 16, 32), Candidates(meta(3, 3, dtype=torch.int32), 3, 0),
            p, 2),
    ]
    for c in calls:
        with pytest.raises(Refused):
            c()
    assert _lib.launches() == before


def test_ctypes_signatures_match_the_c_entries():
    """Each declared ctypes signature has one argument per parameter of its
    C entry in csrc/*.cu, the stream included (a missing one would pass
    the stream as a 32-bit int)."""
    from popsift_torch.kernels import _lib

    decls = {}
    for src in _lib._sources():
        text_ = src.read_text()
        for m in re.finditer(r"PSK_API\s+[\w\s\*]+?\b(psk_\w+)\s*\(([^)]*)\)",
                             text_):
            params = [a for a in m.group(2).split(",") if a.strip()]
            decls[m.group(1)] = len(params)
    assert set(_lib._SIGNATURES) <= set(decls)
    for name, argtypes in _lib._SIGNATURES.items():
        assert len(argtypes) == decls[name], name
    for name in _lib.KERNELS:
        assert f"psk_{name}" in _lib._SIGNATURES


@pytest.mark.parametrize("mutate", [
    lambda c: c.set_mode(tcfg.SiftMode.OPENCV),
    lambda c: c.set_mode(tcfg.SiftMode.VLFEAT),
    lambda c: c.set_gauss_mode("fixed9"),
    lambda c: c.set_gauss_mode("vlfeat-direct"),
    lambda c: c.set_scaling_mode(tcfg.ScalingMode.SCALE_DIRECT),
    lambda c: c.set_filter_max_extrema(100),
    lambda c: c.set_log_mode(tcfg.LogMode.ALL),
])
def test_unimplemented_modes_raise(mutate, tmp_path, monkeypatch):
    """Every setting the port once refused now extracts on the CPU, from
    extract_features and through the pipeline's job: the six modes of the
    JAX package that the port runs, and log_mode=ALL, whose pipeline job
    also writes the --log dump tree into the working directory while
    extract_features writes nothing (popsift_tpu get_extractor)."""
    monkeypatch.chdir(tmp_path)
    cfg = tcfg.Config()
    mutate(cfg)
    img = np.zeros((48, 64), np.uint8)
    feats = text.extract_features(img, cfg, device="cpu")
    assert isinstance(feats, popsift_torch.FeaturesHost)
    assert not any(tmp_path.iterdir())
    with popsift_torch.PopSift(cfg, device="cpu") as ps:
        got = ps.enqueue(64, 48, img).get()
    assert got.get_feature_count() == feats.get_feature_count()
    logged = (tmp_path / "dir-desc" / "desc-pyramid.txt").is_file()
    assert logged == (cfg.log_mode == tcfg.LogMode.ALL)


def test_config_parsers_match():
    for bad in ("nope", "loop2"):
        with pytest.raises(ValueError):
            tcfg.Config().set_desc_mode(bad)
    with pytest.raises(ValueError):
        tcfg.Config(desc_transfer="u4")
    t, j = tcfg.Config(), jcfg.Config()
    t.set_downsampling(1)
    j.set_downsampling(1)
    t.set_initial_blur(0.0)
    j.set_initial_blur(0.0)
    assert _plain(t.static_key()) == _plain(j.static_key())
