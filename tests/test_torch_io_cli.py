"""popsift_torch's PGM I/O and command-line tools against popsift_tpu's, on
the CPU.

* ``io/pgm.py``: ``read_pgm`` equals the JAX package's numpy reader
  (``_read_pgm_py``) and its ``read_pgm`` (the native one where it is
  built) on P2/P5/P3/P6 files with 8- and 16-bit samples and comments in
  the header, raises the same ``ValueError`` on bad files, and
  ``write_pgm``/``rgb_to_grey`` are exact.
* ``gauss.format_gauss_tables`` is byte for byte the JAX package's for
  every GaussMode.
* ``cli/common.py``: the two packages' parsers have the same option
  strings, types, defaults and help, and ``config_from_args`` builds the
  same Config field for field for argvs that together use every flag.
* ``cli/demo.py`` in-process on the CPU (``POPSIFT_TPU_PLATFORM=cpu``):
  ``output-features.txt`` equals ``FeaturesHost.print`` of
  ``extract_features(device="cpu")`` byte for byte, and its rows, parsed,
  hold to the JAX package's ``get_extractor`` at ``test_torch_e2e.py``'s
  end-to-end tolerances (plus half a printed digit); ``--dont-write``,
  ``--float-mode`` and directory input.
* ``cli/match.py``: its report equals ``FeaturesDev.match_and_print`` of a
  MatchingMode pipeline, with accepted matches; a missing file returns 1.
"""

import argparse
import dataclasses
import enum
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

from popsift_tpu import gauss as jgauss  # noqa: E402
from popsift_tpu.cli import common as jcommon  # noqa: E402
from popsift_tpu.io import pgm as jpgm  # noqa: E402

import popsift_torch as pt  # noqa: E402
from popsift_torch import gauss as tgauss  # noqa: E402
from popsift_torch.cli import common as tcommon  # noqa: E402
from popsift_torch.cli import demo as tdemo  # noqa: E402
from popsift_torch.cli import match as tmatch  # noqa: E402
from popsift_torch.extract import extract_features  # noqa: E402
from popsift_torch.io import pgm as tpgm  # noqa: E402

from torch_parity import (DESC_TOL, SIGMA_RTOL, XY_ATOL,  # noqa: E402
                          jax_config, jax_features, one_thread,
                          tied_features)


def _pnm_files(tmp_path):
    """(name, path) of PNM files in every format the reader takes."""
    rng = np.random.default_rng(5)
    grey = rng.integers(0, 256, (5, 7), dtype=np.uint8)
    rgb = rng.integers(0, 256, (5, 7, 3), dtype=np.uint8)
    wide = rng.integers(0, 65536, (5, 7), dtype=np.uint16)
    wide_rgb = rng.integers(0, 65536, (5, 7, 3), dtype=np.uint16)
    files = {
        "p5": b"P5\n7 5\n255\n" + grey.tobytes(),
        "p5-comments": b"P5\n# made by a test\n7 # width\n5\n255\n"
                       + grey.tobytes(),
        "p5-16bit": b"P5\n7 5\n65535\n" + wide.astype(">u2").tobytes(),
        "p6": b"P6\n7 5\n255\n" + rgb.tobytes(),
        "p6-16bit": b"P6 7 5 65535\n" + wide_rgb.astype(">u2").tobytes(),
        "p2": b"P2\n# ascii\n7 5\n255\n"
              + " ".join(str(int(v)) for v in grey.ravel()).encode(),
        "p2-16bit": b"P2\n7 5\n65535\n"
                    + "\n".join(str(int(v)) for v in wide.ravel()).encode(),
        "p3": b"P3\n7 5\n255\n"
              + " ".join(str(int(v)) for v in rgb.ravel()).encode(),
    }
    out = {}
    for name, data in files.items():
        p = tmp_path / f"{name}.pnm"
        p.write_bytes(data)
        out[name] = str(p)
    return out


PNM_KINDS = ["p5", "p5-comments", "p5-16bit", "p6", "p6-16bit", "p2",
             "p2-16bit", "p3"]


@pytest.mark.parametrize("kind", PNM_KINDS)
def test_read_pgm_matches_jax(kind, tmp_path):
    path = _pnm_files(tmp_path)[kind]
    got = tpgm.read_pgm(path)
    assert got.dtype == np.uint8 and got.shape == (5, 7)
    np.testing.assert_array_equal(got, jpgm._read_pgm_py(path))
    np.testing.assert_array_equal(got, jpgm.read_pgm(path))


@pytest.mark.parametrize("data", [
    b"P4\n7 5\n255\n" + bytes(35),          # bad magic
    b"XY",                                   # no PNM at all
    b"P5\n7 5\n0\n" + bytes(35),            # maxval 0
    b"P5\n7 5\n70000\n" + bytes(70),        # maxval over 16 bits
    b"P5\n7 5",                              # truncated header
    b"P2\n# only a comment\n",               # truncated header
])
def test_read_pgm_errors_match_jax(data, tmp_path):
    p = tmp_path / "bad.pgm"
    p.write_bytes(data)
    with pytest.raises(ValueError) as want:
        jpgm._read_pgm_py(str(p))
    with pytest.raises(ValueError) as got:
        tpgm.read_pgm(str(p))
    assert str(got.value) == str(want.value)


def test_write_pgm_roundtrip(tmp_path):
    img = (np.arange(20 * 30) * 7 % 256).astype(np.uint8).reshape(20, 30)
    p = tmp_path / "t.pgm"
    tpgm.write_pgm(str(p), img)
    np.testing.assert_array_equal(tpgm.read_pgm(str(p)), img)
    q = tmp_path / "j.pgm"
    jpgm.write_pgm(str(q), img)
    assert p.read_bytes() == q.read_bytes()


def test_rgb_to_grey_exact():
    rng = np.random.default_rng(9)
    rgb = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    rgb[0, :3] = [[255, 255, 255], [0, 0, 0], [200, 0, 0]]
    got = tpgm.rgb_to_grey(rgb)
    np.testing.assert_array_equal(got, jpgm.rgb_to_grey(rgb))
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    np.testing.assert_array_equal(got, (4899 * r + 9617 * g + 1868 * b)
                                  >> 14)
    assert got[0, 0] == 255 and got[0, 1] == 0


@pytest.mark.parametrize("mode", [m.value for m in pt.GaussMode])
def test_format_gauss_tables_matches_jax(mode):
    cfg = pt.Config()
    cfg.set_gauss_mode(mode)
    if mode in ("fixed9", "fixed15"):
        cfg.set_levels(3)
    got = tgauss.format_gauss_tables(tgauss.build_gauss_info(cfg))
    want = jgauss.format_gauss_tables(jgauss.build_gauss_info(
        jax_config(cfg)))
    assert got == want
    assert got.startswith("Gauss tables (incremental)\n")


# argvs that together set every flag of add_common_options
ARGVS = [
    [],
    ["-v", "--octaves", "3", "--levels", "4", "--sigma", "1.4"],
    ["--threshold", "0.03", "--edge-threshold", "12", "--downsampling",
     "0"],
    ["--edge-limit", "8", "--initial-blur", "0.6", "--gauss-mode",
     "vlfeat-direct", "--desc-mode", "grid"],
    ["--popsift-mode", "--direct-scaling", "--norm-multi", "9",
     "--norm-mode", "classic"],
    ["--vlfeat-mode", "--root-sift", "--filter-max-extrema", "500",
     "--filter-grid", "3", "--filter-sort", "down"],
    ["--opencv-mode", "--print-gauss-tables", "--gauss-mode", "opencv",
     "--desc-mode", "notile"],
    ["--log", "--print-dev-info", "--print-time-info", "--write-as-uchar",
     "--dont-write", "--pgmread-loading", "--float-mode"],
    ["-l", "--gauss-mode", "fixed15", "--filter-sort", "up",
     "--desc-mode", "iloop", "--norm-mode", "RootSift"],
    ["--gauss-mode", "relative", "--desc-mode", "igrid", "--downsampling",
     "-1", "--filter-max-extrema", "100", "--filter-sort", "random"],
]


def _parser(common, log_short=True):
    p = argparse.ArgumentParser(prog="t")
    common.add_common_options(p, log_short=log_short)
    return p


def _field_values(cfg):
    return {f.name: (getattr(cfg, f.name).value
                     if isinstance(getattr(cfg, f.name), enum.Enum)
                     else getattr(cfg, f.name))
            for f in dataclasses.fields(cfg)}


def test_argvs_use_every_flag():
    used = {t for argv in ARGVS for t in argv if t.startswith("-")}
    unused = [a.dest for a in _parser(tcommon)._actions
              if a.dest != "help" and not used & set(a.option_strings)]
    assert not unused


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a) or "none")
def test_config_from_args_matches_jax(argv):
    got = tcommon.config_from_args(_parser(tcommon).parse_args(argv))
    want = jcommon.config_from_args(_parser(jcommon).parse_args(argv))
    assert _field_values(got) == _field_values(want)
    assert set(_field_values(got)) == {f.name for f in
                                       dataclasses.fields(want)}


@pytest.mark.parametrize("log_short", [True, False])
def test_parsers_match_jax(log_short):
    def surface(common):
        return [(tuple(a.option_strings), a.dest, a.type, a.default,
                 a.help, a.nargs, a.const, type(a).__name__)
                for a in _parser(common, log_short)._actions]
    assert surface(tcommon) == surface(jcommon)


@pytest.mark.parametrize("value, device", [
    (None, "cuda"), ("", "cuda"), ("gpu", "cuda"), ("cuda", "cuda"),
    ("cpu", "cpu"), ("CPU", "cpu"), ("tpu", None)])
def test_platform_device(value, device, monkeypatch):
    if value is None:
        monkeypatch.delenv("POPSIFT_TPU_PLATFORM", raising=False)
    else:
        monkeypatch.setenv("POPSIFT_TPU_PLATFORM", value)
    if device is None:
        with pytest.raises(ValueError):
            tcommon.platform_device()
    else:
        assert tcommon.platform_device() == device


def _printed(feats) -> str:
    buf = io.StringIO()
    feats.print(buf)
    return buf.getvalue()


@pytest.fixture
def cli_env(tmp_path, monkeypatch):
    monkeypatch.setenv("POPSIFT_TPU_PLATFORM", "cpu")
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _demo(args, capsys):
    with one_thread():
        rc = tdemo.main(args)
    return rc, capsys.readouterr()


def _counts_line(feats) -> str:
    return (f"Number of feature points: {feats.get_feature_count()} number "
            f"of feature descriptors: {feats.get_descriptor_count()}")


def _parse_rows(text: str) -> np.ndarray:
    rows = [line.split() for line in text.splitlines()]
    assert rows and all(len(r) == 133 for r in rows)
    return np.array(rows, dtype=np.float64)


def test_demo_output_matches_extract_and_jax(textured_image, cli_env,
                                             capsys):
    img = textured_image
    tpgm.write_pgm(str(cli_env / "img.pgm"), img)
    rc, out = _demo(["-i", "img.pgm"], capsys)
    assert rc == 0
    with one_thread():
        feats = extract_features(img, pt.Config(), device="cpu")
    text = (cli_env / "output-features.txt").read_text()
    assert text == _printed(feats)
    assert out.err.splitlines()[-1] == _counts_line(feats)
    rows = _parse_rows(text)

    # the rows against the JAX package's features, one row per descriptor
    ref = jax_features(img, pt.Config())
    assert ref.get_feature_count() > 0
    s = ref._soa
    tied = tied_features(img, pt.Config())
    feat = np.repeat(np.arange(ref.get_feature_count()), s["num_ori"])
    assert rows.shape[0] == ref.get_descriptor_count() == feat.size
    sigval = 1.0 / (s["sigma"].astype(np.float64) ** 2)
    for col, want, tol in ((0, s["xpos"], XY_ATOL), (1, s["ypos"], XY_ATOL)):
        want = want.astype(np.float64)[feat]
        # 6 significant digits printed: half a digit of the value
        assert (np.abs(rows[:, col] - want)
                <= tol + 5e-6 * np.abs(want)).all()
    for col in (2, 4):
        assert np.allclose(rows[:, col], sigval[feat],
                           rtol=2 * SIGMA_RTOL + 5e-6, atol=0)
    assert (rows[:, 3] == 0).all()
    keep = ~tied[feat]
    desc = ref.get_descriptors().astype(np.float64)
    idx = np.concatenate([s["desc_idx"][i, :n] for i, n in
                          enumerate(s["num_ori"])])
    # 3 significant digits printed
    err = np.abs(rows[keep, 5:] - desc[idx[keep]])
    assert (err <= DESC_TOL + 5e-3 * np.abs(desc[idx[keep]])).all()


def test_demo_dont_write_float_mode_and_directory(textured_image, cli_env,
                                                  capsys):
    a = textured_image
    b = np.ascontiguousarray(textured_image[::-1, ::-1])
    d = cli_env / "imgs"
    (d / "sub").mkdir(parents=True)
    tpgm.write_pgm(str(d / "a.pgm"), a)
    tpgm.write_pgm(str(d / "sub" / "b.pgm"), b)

    rc, out = _demo(["-i", str(d), "--dont-write"], capsys)
    assert rc == 0
    assert not (cli_env / "output-features.txt").exists()
    with one_thread():
        fa = extract_features(a, pt.Config(), device="cpu")
        fb = extract_features(b, pt.Config(), device="cpu")
    assert [ln for ln in out.err.splitlines()
            if ln.startswith("Number")] == [_counts_line(fa),
                                            _counts_line(fb)]

    # each job rewrites the file: the last image's features remain, and
    # repeated -i takes the files in order
    rc, out = _demo(["-i", str(d / "sub" / "b.pgm"), "-i",
                     str(d / "a.pgm")], capsys)
    assert rc == 0
    assert (cli_env / "output-features.txt").read_text() == _printed(fa)

    # --float-mode uploads the bytes divided by 256
    rc, out = _demo(["-i", str(d / "a.pgm"), "--float-mode"], capsys)
    assert rc == 0
    with one_thread():
        ff = extract_features(a.astype(np.float32) / 256.0, pt.Config(),
                              device="cpu")
    assert (cli_env / "output-features.txt").read_text() == _printed(ff)
    assert out.err.splitlines()[-1] == _counts_line(ff)

    (cli_env / "empty").mkdir()
    rc, out = _demo(["-i", str(cli_env / "empty")], capsys)
    assert rc == 1 and "No files in" in out.err


def test_match_output(textured_image, cli_env, capsys):
    a = textured_image
    b = np.ascontiguousarray(np.roll(textured_image, (3, -5), (0, 1)))
    tpgm.write_pgm(str(cli_env / "a.pgm"), a)
    tpgm.write_pgm(str(cli_env / "b.pgm"), b)
    with one_thread():
        rc = tmatch.main(["-l", "a.pgm", "-r", "b.pgm"])
    out = capsys.readouterr().out
    assert rc == 0
    with one_thread(), pt.PopSift(pt.Config(), mode=pt.ProcessingMode.
                                  MATCHING, device="cpu") as ps:
        left = ps.enqueue(160, 120, a).get_dev()
        right = ps.enqueue(160, 120, b).get_dev()
        buf = io.StringIO()
        left.match_and_print(right, buf)
    head = []
    for f in (left, right):
        head += [f"Number of features:    {f.get_feature_count()}",
                 f"Number of descriptors: {f.get_descriptor_count()}"]
    lines = out.splitlines()
    assert lines[:4] == head
    assert "\n".join(lines[4:]) + "\n" == buf.getvalue()
    assert len(lines) == 4 + left.get_descriptor_count()
    assert sum(ln.startswith("accept") for ln in lines) > 10

    assert tmatch.main(["-l", "a.pgm", "-r", "missing.pgm"]) == 1
    assert "is not a regular file" in capsys.readouterr().out
