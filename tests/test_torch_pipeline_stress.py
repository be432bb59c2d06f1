"""Concurrency and error handling of popsift_torch's host pipeline on the
CPU: the scenarios of tests/test_pipeline_stress.py and
tests/test_thread_race.py that apply to the port (it has no upload pool,
no upload cache and no bucket keys), at 64x80 so that they run in
seconds.

* Many jobs through ``workers=2`` and ``workers=3`` in both modes: every
  job completes once, and the same frame gives the same features bit for
  bit whichever worker extracted it.  ExtractingMode runs one worker
  whatever ``workers`` says; MatchingMode runs that many.
* Mixed shapes in one pipeline, and a ``configure()`` in mid-stream:
  the jobs enqueued before it keep their configuration.
* Every 13th job fails (the port's extraction is patched to raise on one
  frame, and to hand out each other frame's features, extracted once,
  so that the many jobs cost no extraction each): only those jobs fail;
  ``get_host`` / ``get_dev`` raise the error, ``get_base`` and the
  deprecated ``execute`` return None, as in popsift_tpu (the port raised
  from both before).
* ``uninit`` joins every worker; ``device=0`` and the default device
  raise without CUDA; ``popsift_torch.__all__`` holds popsift_tpu's names.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import popsift_tpu  # noqa: E402

import popsift_torch as pt  # noqa: E402
from popsift_torch import pipeline as tpipe  # noqa: E402

MATCHING = pt.ProcessingMode.MATCHING
EXTRACTING = pt.ProcessingMode.EXTRACTING


def _img(seed, h, w):
    rng = np.random.default_rng(seed)
    img = rng.random((h // 8 + 1, w // 8 + 1)).astype(np.float32)
    img = np.kron(img, np.ones((8, 8), np.float32))[:h, :w]
    for _ in range(2):
        img = (img + np.roll(img, 1, 0) + np.roll(img, 1, 1)) / 3.0
    img = (img - img.min()) / max(img.max() - img.min(), 1e-6)
    return (img * 255).astype(np.uint8)


def _arrays(f):
    """A result's arrays, host or device features alike."""
    if isinstance(f, pt.FeaturesDev):
        out = dict(f.get_features())
        out["desc"] = f.get_descriptors().numpy()
        out["rev"] = f.get_reverse_map()
        return out
    return dict(f.soa(), desc=f.get_descriptors())


def _same(a, b) -> bool:
    a, b = _arrays(a), _arrays(b)
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k])
                                        for k in a)


@pytest.fixture(scope="module")
def frames():
    return [_img(i, 64, 80) for i in range(3)]


@pytest.fixture(scope="module")
def reference(frames):
    """Each frame's features from a one-worker pipeline, per mode."""
    out = {}
    for mode in (EXTRACTING, MATCHING):
        with pt.PopSift(pt.Config(), mode=mode, device="cpu") as ps:
            jobs = [ps.enqueue(80, 64, f) for f in frames]
            out[mode] = [j.get_base() for j in jobs]
    return out


@pytest.mark.parametrize("workers", [2, 3])
@pytest.mark.parametrize("mode", [EXTRACTING, MATCHING])
def test_many_jobs_same_frame_same_result(frames, reference, mode,
                                          workers):
    with pt.PopSift(pt.Config(), mode=mode, device="cpu",
                    workers=workers) as ps:
        assert len(ps._threads) == (workers if mode == MATCHING else 1)
        jobs = [(i, ps.enqueue(80, 64, frames[i]))
                for _ in range(2) for i in range(len(frames))]
        results = [(i, j.get_base()) for i, j in jobs]
    for i, f in results:
        assert f is not None
        assert isinstance(f, pt.FeaturesDev if mode == MATCHING
                          else pt.FeaturesHost)
        assert _same(f, reference[mode][i]), i
    assert reference[mode][0].get_feature_count() > 0


def test_mixed_shapes(frames):
    other = _img(5, 72, 96)
    with pt.PopSift(pt.Config(), mode=MATCHING, device="cpu",
                    workers=2) as ps:
        jobs = [ps.enqueue(80, 64, frames[0]), ps.enqueue(96, 72, other),
                ps.enqueue(80, 64, frames[0]), ps.enqueue(96, 72, other)]
        feats = [j.get_dev() for j in jobs]
    assert _same(feats[0], feats[2]) and _same(feats[1], feats[3])
    assert all(f.get_feature_count() > 0 for f in feats)
    assert feats[1].get_features()["xpos"].max() > 80  # the wider frame


def test_configure_mid_stream_keeps_in_flight_configs(frames, reference):
    strict = pt.Config()
    strict.set_threshold(0.08)
    frames = frames[:2]
    with pt.PopSift(pt.Config(), device="cpu") as ps:
        before = [ps.enqueue(80, 64, f) for f in frames]
        assert ps.configure(strict) and ps.apply_configuration()
        after = [ps.enqueue(80, 64, f) for f in frames]
        before = [j.get() for j in before]
        after = [j.get() for j in after]
    with pt.PopSift(strict, device="cpu") as ps:
        expect = [ps.enqueue(80, 64, f).get() for f in frames]
    assert all(_same(a, b) for a, b in zip(before, reference[EXTRACTING]))
    assert all(_same(a, b) for a, b in zip(after, expect))
    assert sum(f.get_feature_count() for f in after) < sum(
        f.get_feature_count() for f in before)


@pytest.fixture
def failing_frame(monkeypatch):
    """A frame whose extraction raises in the pipeline's workers; every
    other frame is extracted once per mode and its features handed out
    again after that."""
    bad = _img(99, 64, 80)
    real = tpipe.extract_features
    done = {}
    lock = threading.Lock()

    def extract(image, *args, want_dev=False, **kwargs):
        # the worker passes the image it uploaded (SiftJob.get_img)
        arr = np.asarray(image)
        if np.array_equal(arr, bad):
            raise RuntimeError("injected extraction failure")
        key = (arr.tobytes(), arr.shape, want_dev)
        with lock:
            if key not in done:
                done[key] = real(image, *args, want_dev=want_dev, **kwargs)
            return done[key]

    monkeypatch.setattr(tpipe, "extract_features", extract)
    return bad


@pytest.mark.parametrize("mode,workers", [(EXTRACTING, 3), (MATCHING, 1),
                                          (MATCHING, 3)])
def test_every_13th_job_fails_alone(frames, failing_frame, mode, workers):
    with pt.PopSift(pt.Config(), mode=mode, device="cpu",
                    workers=workers) as ps:
        jobs = [ps.enqueue(80, 64, failing_frame if k % 13 == 12
                           else frames[k % len(frames)])
                for k in range(40)]
        failed = []
        for k, job in enumerate(jobs):
            get = job.get_dev if mode == MATCHING else job.get_host
            try:
                f = get()
            except RuntimeError as e:
                assert "injected" in str(e)
                assert job.get_base() is None
                failed.append(k)
                with pytest.raises(RuntimeError, match="injected"):
                    (job.get_host if mode == MATCHING else job.get_dev)()
            else:
                assert f is not None and job.get_base() is f
    assert failed == [12, 25, 38]


def test_failed_job_semantics_as_in_jax(failing_frame):
    """get_base() and execute() return None for a failed job (the port
    raised from both before); get()/get_host()/get_dev() raise."""
    with pt.PopSift(pt.Config(), device="cpu") as ps:
        job = ps.enqueue(80, 64, failing_frame)
        assert job.get_base() is None
        for get in (job.get, job.get_host, job.get_dev):
            with pytest.raises(RuntimeError, match="injected"):
                get()
        ps.init(80, 64)
        assert ps.execute(failing_frame) is None
        ok = ps.execute(_img(1, 64, 80))
        assert isinstance(ok, pt.FeaturesHost) and ok.get_feature_count()


def test_uninit_joins_every_worker(frames):
    ps = pt.PopSift(pt.Config(), mode=MATCHING, device="cpu", workers=3)
    threads = list(ps._threads)
    assert len(threads) == 3 and all(t.is_alive() for t in threads)
    jobs = [ps.enqueue(80, 64, f) for f in frames[:2]]
    ps.uninit()
    assert not any(t.is_alive() for t in threads)
    assert all(j._f.done() for j in jobs)   # queued jobs were finished
    ps.uninit()                              # a second call does nothing
    assert threading.active_count() >= 1


def _without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")


@pytest.mark.parametrize("device", [0, "cuda", "cuda:0"])
def test_cuda_device_raises_without_cuda(device):
    _without_cuda()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.PopSift(pt.Config(), device=device)


def test_default_device_raises_without_cuda():
    _without_cuda()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.PopSift()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.PopSift(mode=MATCHING, workers=2)


def test_unknown_device_kind_raises():
    with pytest.raises(ValueError):
        pt.PopSift(pt.Config(), device="meta")


def test_exports_match_jax():
    assert set(popsift_tpu.__all__) <= set(pt.__all__)
    for name in popsift_tpu.__all__:
        assert hasattr(pt, name), name
    assert pt.MAX_LEVELS == popsift_tpu.MAX_LEVELS
    assert pt.MAX_OCTAVES == popsift_tpu.MAX_OCTAVES
    assert pt.Features is pt.FeaturesHost
    assert issubclass(pt.FeaturesDev, pt.FeaturesBase)
