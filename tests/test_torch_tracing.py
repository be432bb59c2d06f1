"""popsift_torch's tracing and device modules against popsift_tpu's, on the
CPU.

* The three tests of ``tests/test_hosttrace.py`` for the port: a string
  kwarg is counted, never cast, so the summary survives it; snapshots
  count and sum; and a child interpreter with ``POPSIFT_TPU_HOSTTRACE=1``
  runs ``PopSift(device="cpu")`` to ``uninit``, whose summary on stderr
  names the pipeline's spans.
* ``_collect_spans`` folds one event list as the JAX package's does.
* Every scope of an extraction is in a torch.profiler profile of
  ``extract_features`` on the CPU; ``trace(dir)`` writes a Chrome trace.
* ``BriefDuration.report`` and the limit checks of ``DeviceProperties``
  print and return what the JAX package's do; ``set`` raises for a device
  that does not exist.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

from popsift_tpu import device as jdevice  # noqa: E402
from popsift_tpu import tracing as jtracing  # noqa: E402

import popsift_torch as pt  # noqa: E402
from popsift_torch import device as tdevice  # noqa: E402
from popsift_torch import tracing  # noqa: E402
from popsift_torch.extract import extract_features  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_summary_survives_string_kwargs(monkeypatch, capsys):
    """A non-numeric kwarg value must be counted, not float-cast."""
    monkeypatch.setattr(tracing, "HOSTTRACE", True)
    tracing._trace_events.clear()
    tracing.host_trace("upload.start", 1)
    tracing.host_trace("upload.end", 1)
    tracing.host_trace("compile_program", "lbl", label="fused[True]((1,2))")
    tracing.host_trace("fetch_bytes", 0, n=1234.0)
    tracing.host_trace_summary()  # must not raise
    assert not tracing._trace_events
    err = capsys.readouterr().err
    assert "# host trace:" in err
    assert "#compile_program" in err
    assert "#fetch_bytes" in err
    assert "upload" in err


def test_snapshot_counts_and_sums(monkeypatch):
    monkeypatch.setattr(tracing, "HOSTTRACE", True)
    tracing._trace_events.clear()
    tracing.host_trace("fetch_bytes", 0, n=100.0)
    tracing.host_trace("fetch_bytes", 1, n=50.0)
    tracing.host_trace("compile_program", "a", n=1)
    snap = tracing.host_trace_snapshot()
    assert snap["#fetch_bytes"] == (2, 150.0)
    assert snap["#compile_program"] == (1, 1.0)
    # non-destructive by default; destructive with clear=True
    assert tracing.host_trace_snapshot(clear=True) == snap
    assert tracing.host_trace_snapshot() == {}
    # off: one boolean test, nothing recorded
    monkeypatch.setattr(tracing, "HOSTTRACE", False)
    tracing.host_trace("fetch_bytes", 2, n=5.0)
    assert tracing._trace_events == []


_PIPELINE_SCRIPT = r"""
import numpy as np
from popsift_torch import Config, PopSift, ProcessingMode

rng = np.random.default_rng(0)
img = np.kron(rng.random((12, 16)).astype(np.float32),
              np.ones((8, 8), np.float32))
img = (img * 255).astype(np.uint8)
h, w = img.shape
with PopSift(Config(), device="cpu") as ps:
    jobs = [ps.enqueue(w, h, img) for _ in range(2)]
    for j in jobs:
        assert j.get().get_feature_count() > 0
with PopSift(Config(), mode=ProcessingMode.MATCHING, device="cpu",
             workers=2) as ps:
    assert ps.enqueue(w, h, img).get_dev().get_feature_count() > 0
print("OK")
"""


def test_pipeline_uninit_with_hosttrace_enabled():
    # one PyTorch thread in the child too (test_torch_threads.py says why)
    env = dict(os.environ, POPSIFT_TPU_HOSTTRACE="1", OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", _PIPELINE_SCRIPT],
                       capture_output=True, text=True, timeout=600, env=env,
                       cwd=REPO)
    assert r.returncode == 0, r.stderr[-4000:]
    assert "OK" in r.stdout
    # one summary per pipeline
    assert r.stderr.count("# host trace:") == 2
    names = {line.split()[1] for line in r.stderr.splitlines()
             if line.startswith("#   ")}
    for name in ("job", "extract", "stage1.o0", "stage2.o0", "filter",
                 "assemble", "#candidates", "#extrema", "#descriptors"):
        assert name in names, (name, r.stderr[-2000:])


def test_collect_spans_matches_jax():
    rng = np.random.default_rng(1)
    events = []
    t = 100.0
    for i in range(40):
        t += float(rng.uniform(1e-4, 1e-2))
        kind = i % 4
        if kind == 0:
            events.append((t, "job.start", i // 4))
        elif kind == 1:
            events.append((t, "job.end", i // 4))
        elif kind == 2:
            events.append((t, "bytes", i, {"n": float(i)}))
        else:
            events.append((t, "stage.start", 0))
    events = [e if len(e) == 4 else e + ({},) for e in events]
    events.append((t + 1.0, "stage.end", 0, {}))
    events.append((t + 2.0, "label", 0, {"s": "text"}))
    order = rng.permutation(len(events))
    shuffled = [events[i] for i in order]
    got = tracing._collect_spans(shuffled)
    want = jtracing._collect_spans(shuffled)
    assert dict(got) == dict(want)
    assert set(got) == {"job", "#bytes", "stage", "#label"}


def test_scopes_in_profile():
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(2)
    img = (np.kron(rng.random((12, 16)), np.ones((8, 8))) * 255).astype(
        np.uint8)
    cfg = pt.Config()
    cfg.set_filter_max_extrema(10)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        feats = extract_features(img, cfg, device="cpu")
    assert feats.get_feature_count() > 0
    keys = {e.key for e in prof.key_averages()}
    assert set(tracing.SCOPES) <= keys, set(tracing.SCOPES) - keys


def test_trace_writes_chrome_trace(tmp_path, monkeypatch):
    monkeypatch.delenv("POPSIFT_TPU_TRACE", raising=False)
    with tracing.trace():
        torch.ones(3).sum()
    assert not any(tmp_path.iterdir())
    with tracing.trace(str(tmp_path / "a")):
        with tracing.scope("pyramid", "cpu"):
            torch.ones(3).sum()
    monkeypatch.setenv("POPSIFT_TPU_TRACE", str(tmp_path / "b"))
    with tracing.trace():
        torch.ones(3).sum()
    for d in ("a", "b"):
        files = list((tmp_path / d).iterdir())
        assert len(files) == 1 and files[0].suffix == ".json"
        doc = json.loads(files[0].read_text())
        assert "traceEvents" in doc
    names = {e.get("name") for e in json.loads(
        next((tmp_path / "a").iterdir()).read_text())["traceEvents"]}
    assert "pyramid" in names


def test_brief_duration_report_matches_jax(capsys):
    for elapsed in (0.0, 1.2345678e-3, 12.5):
        a = tracing.BriefDuration("Extraction (drain)")
        b = jtracing.BriefDuration("Extraction (drain)")
        a._elapsed = b._elapsed = elapsed
        a.report()
        got = capsys.readouterr().err
        b.report()
        assert got == capsys.readouterr().err
    with tracing.BriefDuration("block"):
        pass
    assert capsys.readouterr().err.startswith("block: ")


@pytest.mark.parametrize("warn", [True, False])
def test_limit_checks_match_jax(warn, capsys):
    td, jd = tdevice.DeviceProperties(), jdevice.DeviceProperties()
    sizes = [1, 640, 1 << 13, (1 << 15) - 1, 1 << 15, (1 << 15) + 1,
             1 << 16]
    for w in sizes:
        for h in sizes:
            for got, want in (
                    (td.check_limit_input(w, h, warn),
                     jd.check_limit_input(w, h, warn)),
                    (td.check_limit_scaled(w, h, 6, warn),
                     jd.check_limit_scaled(w, h, 6, warn))):
                assert got == want
    out = capsys.readouterr().err
    assert ("exceeds" in out) == warn
    assert tdevice.MAX_INPUT_DIM == jdevice.MAX_INPUT_DIM
    assert tdevice.MAX_OCTAVE0_PIXELS == jdevice.MAX_OCTAVE0_PIXELS


def test_device_set_raises_for_absent_device(capsys):
    props = tdevice.DeviceProperties()
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    for bad in (-1, n, n + 5):
        with pytest.raises(ValueError, match="does not exist"):
            props.set(bad)
    props.print()
    out = capsys.readouterr().out
    assert out.strip() and ("no CUDA device" in out) == (n == 0)
