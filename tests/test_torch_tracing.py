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
* The host-span recorder: a CPU pipeline's two jobs give each span its
  job's request and the parent of the documented nesting; every readback
  site a CPU extraction reaches (the plain K4 compaction included) and
  the matcher's copies record their span under their scope; ``enable``
  switches the recorder at run time and adds no profiler range; under
  ``trace(dir)`` the appended host spans lie on the profiler's clock.
"""

import collections
import json
import os
import statistics
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
    for name in ("job", "extract", "stage1.o0", "stage2", "filter",
                 "assemble", "#candidates", "#extrema", "#descriptors",
                 "#stage2.octaves"):
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


def _image(seed=0):
    rng = np.random.default_rng(seed)
    return (np.kron(rng.random((12, 16)), np.ones((8, 8))) * 255).astype(
        np.uint8)


@pytest.fixture
def recorder():
    """The recorder on and empty; off and empty afterwards."""
    was = tracing.HOSTTRACE
    tracing.host_trace_snapshot(clear=True)
    tracing.enable(True)
    yield
    tracing.enable(was)
    tracing.host_trace_snapshot(clear=True)


# each span's parent in an extraction (stage names without their octave)
_PARENT = {"queue": "job", "upload": "job", "extract": "job",
           "stage1": "extract", "filter": "extract", "stage2": "extract",
           "assemble": "extract", "pyramid": "stage1", "detect": "stage1",
           "orientation": "stage2", "descriptors": "stage2",
           "download": "stage2", "readback.compact": "detect",
           "readback.refine_status": "detect",
           "readback.recompact": "filter", "readback.rows": "orientation",
           "readback.download": "download"}


def _kind(name):
    return name.split(".o")[0] if name.startswith("stage") else name


def test_pipeline_spans_carry_request_and_parent(recorder):
    img = _image()
    h, w = img.shape
    cfg = pt.Config()
    cfg.set_filter_max_extrema(10)       # the filter's recompaction too
    with pt.PopSift(cfg, device="cpu") as ps:
        jobs = [ps.enqueue(w, h, img) for _ in range(2)]
        for j in jobs:
            assert j.get().get_feature_count() > 0
        spans = tracing.host_spans()
    requests = [j.request for j in jobs]
    assert len(set(requests)) == 2 and None not in requests
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans)
    for r in requests:
        mine = [s for s in spans if s.request == r]
        roots = [s for s in mine if s.name == "job"]
        assert len(roots) == 1 and roots[0].parent is None
        names = collections.Counter(_kind(s.name) for s in mine)
        assert set(names) == set(_PARENT) | {"job"}, names
        for s in mine:
            if s.name == "job":
                continue
            parent = by_id[s.parent]
            assert parent.request == r
            assert _kind(parent.name) == _PARENT[_kind(s.name)], s
            assert parent.start <= s.start <= s.end <= parent.end, s
        # the worker opened all but the two spans opened at enqueue
        threads = {s.thread for s in mine if s.name not in ("job", "queue")}
        assert len(threads) == 1
        assert threads != {roots[0].thread}
    assert {s.request for s in spans} == set(requests)


def test_readback_sites_record_under_their_scope(recorder):
    cfg = pt.Config()
    cfg.set_filter_max_extrema(10)
    feats = extract_features(_image(1), cfg, device="cpu", want_dev=True)
    spans = tracing.host_spans()
    by_id = {s.id: s for s in spans}
    readbacks = [s for s in spans if s.name.startswith("readback.")]
    assert {s.name for s in readbacks} == {
        n for n in _PARENT if n.startswith("readback.")}
    for s in readbacks:
        assert by_id[s.parent].name == _PARENT[s.name], s
        assert s.request is None              # outside a pipeline job
    # one stage-2 pass, whose download is one copy of the keypoints'
    # numbers: MatchingMode keeps the descriptors on the device
    n_oct = sum(1 for s in spans if s.name == "download")
    n_down = sum(s.name == "readback.download" for s in readbacks)
    assert n_oct == 1 and n_down == 1
    assert sum(s.name == "readback.rows" for s in readbacks) == 1
    # the plain K4 compaction is reached once per octave with candidates
    assert sum(s.name == "readback.refine_status" for s in readbacks) \
        == sum(s.name == "detect" for s in spans)

    tracing.host_trace_snapshot(clear=True)
    best = feats.match(feats)[0]
    np.testing.assert_array_equal(best, np.arange(best.shape[0]))
    spans = tracing.host_spans()
    (match,) = [s for s in spans if s.name == "match"]
    copies = [s for s in spans if s.name == "readback.match"]
    assert len(copies) == 5
    assert all(s.parent == match.id for s in copies)
    snap = tracing.host_trace_snapshot()
    assert snap["readback.match"][0] == 5 and snap["match"][0] == 1


def test_enable_switches_the_recorder_without_profiler_ranges(recorder):
    from torch.profiler import ProfilerActivity, profile
    img = _image(2)
    ranges = {}
    for on in (False, True):
        tracing.enable(on)
        assert tracing.HOSTTRACE is on
        tracing.host_trace_snapshot(clear=True)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            extract_features(img, pt.Config(), device="cpu")
        ranges[on] = collections.Counter(
            e.name for e in prof.events()
            if e.name in tracing.SCOPES or e.name.startswith(
                ("readback", "stage", "extract", "job")))
        snap = tracing.host_trace_snapshot(clear=True)
        if on:
            assert snap["extract"][0] == 1
            assert snap["pyramid"][0] == ranges[on]["pyramid"]
        else:
            assert snap == {} and tracing.host_spans() == []
    assert ranges[True] == ranges[False]
    assert set(ranges[True]) == set(tracing.SCOPES)


def test_trace_appends_host_spans_on_the_profilers_clock(tmp_path):
    was = tracing.HOSTTRACE
    img = _image(3)
    h, w = img.shape
    with tracing.trace(str(tmp_path)):
        assert tracing.HOSTTRACE
        extract_features(img, pt.Config(), device="cpu")
        with pt.PopSift(pt.Config(), device="cpu") as ps:
            assert ps.enqueue(w, h, img).get().get_feature_count() > 0
    assert tracing.HOSTTRACE is was
    (path,) = tmp_path.iterdir()
    events = json.loads(path.read_text())["traceEvents"]
    hosts = [e for e in events if e.get("cat") == "host_span"]
    assert all({"request", "id", "parent"} <= set(e["args"])
               for e in hosts)
    # job and queue cross threads: async pairs; the rest complete events
    pairs = collections.Counter((e["name"], e["ph"]) for e in hosts
                                if e["ph"] in "be")
    assert pairs == {("job", "b"): 1, ("job", "e"): 1, ("queue", "b"): 1,
                     ("queue", "e"): 1}
    # the profiler's pyramid ranges and the host spans, paired in order on
    # each thread (the caller's and the worker's)
    def starts(cat):
        by_tid = collections.defaultdict(list)
        for e in events:
            if e.get("cat") == cat and e.get("name") == "pyramid":
                by_tid[e["tid"]].append(float(e["ts"]))
        return {t: sorted(v) for t, v in by_tid.items()}
    prof, host = starts("user_annotation"), starts("host_span")
    assert set(prof) == set(host) and len(host) == 2
    gaps = [abs(a - b) for t in host for a, b in zip(host[t], prof[t],
                                                       strict=True)]
    assert statistics.median(gaps) < 500.0, gaps   # us


def test_to_host_records_one_wait_per_nonempty_copy(recorder):
    a = tracing.to_host(torch.arange(3), "readback.x")
    b = tracing.to_host(torch.empty(0), "readback.x")
    np.testing.assert_array_equal(a, [0, 1, 2])
    assert b.shape == (0,)
    assert tracing.host_trace_snapshot()["readback.x"][0] == 1


def test_recorder_under_contending_threads(recorder):
    """More threads than cores open nested spans under their own requests
    with a short switch interval: no span is lost, no id or request is
    shared, and every parent is a span of the same thread and request."""
    import threading
    n_threads, n_spans = 4 * (os.cpu_count() or 1), 200
    requests = [tracing.new_request() for _ in range(n_threads)]
    assert len(set(requests)) == n_threads

    def work(r):
        tracing.set_request(r)
        for _ in range(n_spans):
            outer = tracing.begin("outer")
            tracing.end(tracing.begin("inner"))
            tracing.end(outer)
        tracing.set_request(None)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(r,))
                   for r in requests]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    spans = tracing.host_spans()
    assert len(spans) == 2 * n_threads * n_spans
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans)
    for s in spans:
        if s.name == "inner":
            parent = by_id[s.parent]
            assert parent.name == "outer"
            assert (parent.request, parent.thread) == (s.request, s.thread)
        else:
            assert s.parent is None
    assert collections.Counter(s.request for s in spans) == {
        r: 2 * n_spans for r in requests}
