"""popsift_torch's MatchingMode on the CPU: ``FeaturesDev``,
``SiftJob.get_dev`` and ``FeaturesDev.match``, held to the port's own
ExtractingMode and to popsift_tpu's MatchingMode.

The frames are 128x160 crops, the same window, of the repository's real
pair ``tests/data/scenes/china.pgm`` / ``china_l.pgm``.

* Port against port: ``PopSift(device="cpu", mode=MATCHING)`` gives a
  ``FeaturesDev`` (``get_host`` None) whose descriptors are bit-equal to
  the ExtractingMode ``FeaturesHost`` of the same frame, as are xpos,
  ypos, sigma and num_ori; the reverse map repeats each feature index by
  its num_ori.  A self-match gives each row itself, accepted, except rows
  whose descriptor has an exact copy in the frame (two extrema refined to
  the same point): those match the first copy, at the same distance as
  the second best, and are rejected.
* ``match_and_print`` writes JAX ``FeaturesDev.match_and_print``'s text
  byte for byte, on the same numpy arrays.
* The slice as a whole: one JAX ``PopSift(MATCHING)`` run on the pair.
  Feature counts are equal.  A feature whose orientation peaks tie may
  get another num_ori in the two packages (tests/test_torch_e2e.py), so
  descriptor rows are paired by (feature, orientation), and features with
  another num_ori are counted, at most 1% of the features.  Paired rows
  must agree on the best right (feature, orientation) and on ``accept``,
  except rows whose two nearest distances lie within 1e-5 of each other
  on either side; those rows and the unpaired ones are counted, at most
  1% of the rows.
"""

import io
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

import popsift_tpu  # noqa: E402
from popsift_tpu import features as jfeat  # noqa: E402

import popsift_torch as pt  # noqa: E402
from popsift_torch.extract import (extract_features,  # noqa: E402
                                   quantize_descs, quantize_descs_dev)
from popsift_torch.features import (Stage2Result,  # noqa: E402
                                    assemble_features_dev)

SCENES = Path(__file__).parent / "data" / "scenes"
H, W = 128, 160
NEAR_TIE = 1e-5
MOST_DIFFERING = 0.01


def _read_pgm(path: Path) -> np.ndarray:
    data = path.read_bytes()
    fields = []
    pos = 0
    while len(fields) < 4:
        while data[pos:pos + 1].isspace():
            pos += 1
        end = pos
        while not data[end:end + 1].isspace():
            end += 1
        fields.append(data[pos:end])
        pos = end
    assert fields[0] == b"P5" and int(fields[3]) == 255
    w, h = int(fields[1]), int(fields[2])
    return np.frombuffer(data, np.uint8, w * h, pos + 1).reshape(h, w)


def _crop(name: str) -> np.ndarray:
    return np.ascontiguousarray(_read_pgm(SCENES / name)[100:228, 200:360])


@pytest.fixture(scope="module")
def pair():
    return _crop("china.pgm"), _crop("china_l.pgm")


@pytest.fixture(scope="module")
def port(pair):
    """The port's ExtractingMode and MatchingMode results of the pair, and
    the MatchingMode jobs."""
    with pt.PopSift(pt.Config(), device="cpu") as ps:
        host = [ps.enqueue(W, H, img).get() for img in pair]
    with pt.PopSift(pt.Config(), mode=pt.ProcessingMode.MATCHING,
                    device="cpu") as ps:
        jobs = [ps.enqueue(W, H, img) for img in pair]
        dev = [j.get_dev() for j in jobs]
    return host, dev, jobs


@pytest.fixture(scope="module")
def jax_side(pair):
    """One JAX PopSift(MATCHING) run on the pair, and its match.  The
    right frame, which holds more features, goes first: the bucket key
    seeded from the first frame then holds the second, and the run
    compiles no regrown program (a cold run takes about a minute)."""
    cfg = popsift_tpu.Config()
    with popsift_tpu.PopSift(cfg, mode=popsift_tpu.ProcessingMode.MATCHING
                             ) as ps:
        jobs = [ps.enqueue(W, H, img) for img in pair[::-1]]
        r, l = (j.get_dev() for j in jobs)
    return (l, r), l.match(r)


def test_get_dev_equals_the_extracting_features(port):
    host, dev, jobs = port
    for h, d, job in zip(host, dev, jobs):
        assert d is not None and job.get_host() is None
        assert job.get() is None and job.get_base() is d
        assert isinstance(d, pt.FeaturesDev)
        desc = d.get_descriptors()
        assert isinstance(desc, torch.Tensor)
        assert desc.dtype == torch.float32 and desc.device.type == "cpu"
        assert d.get_feature_count() == h.get_feature_count() > 20
        assert d.get_descriptor_count() == h.get_descriptor_count()
        np.testing.assert_array_equal(desc.numpy(), h.get_descriptors())
        for k in ("xpos", "ypos", "sigma", "num_ori"):
            got = d.get_features()[k]
            assert isinstance(got, np.ndarray)
            assert got.dtype == h.soa()[k].dtype
            np.testing.assert_array_equal(got, h.soa()[k], err_msg=k)


def test_extracting_jobs_have_no_dev_features(port, pair):
    with pt.PopSift(pt.Config(), device="cpu") as ps:
        job = ps.enqueue(W, H, pair[0])
        assert job.get_dev() is None
        assert isinstance(job.get_host(), pt.FeaturesHost)


def test_reverse_map(port):
    for d in port[1]:
        num = d.get_features()["num_ori"]
        rev = d.get_reverse_map()
        assert rev.dtype == np.int64
        np.testing.assert_array_equal(
            rev, np.repeat(np.arange(num.shape[0]), num)[:len(rev)])
        assert len(rev) == d.get_descriptor_count() == int(num.sum())


def duplicate_rows(desc: np.ndarray) -> np.ndarray:
    """For each row, the first row with an equal descriptor."""
    _, first, inverse = np.unique(desc, axis=0, return_index=True,
                                  return_inverse=True)
    return first[inverse.reshape(-1)]


def check_self_match(d) -> int:
    """A frame matched with itself: each row its own best, accepted, but
    for exact copies.  Returns the number of rows with a copy."""
    best, second, accept, d1, d2 = d.match(d)
    m = d.get_descriptor_count()
    first = duplicate_rows(d.get_descriptors().cpu().numpy())
    copied = np.bincount(first, minlength=m)[first] > 1
    np.testing.assert_array_equal(best[~copied], np.arange(m)[~copied])
    assert accept[~copied].all()
    np.testing.assert_array_equal(best[copied], first[copied])
    assert not accept[copied].any()
    np.testing.assert_array_equal(d1[copied], d2[copied])
    return int(copied.sum())


def test_self_match(port):
    for d in port[1]:
        assert check_self_match(d) <= 0.02 * d.get_descriptor_count()


def test_match_and_print_matches_jax(port):
    """The text of JAX FeaturesDev.match_and_print on the same arrays."""
    l, r = port[1]
    ours = io.StringIO()
    l.match_and_print(r, ours)

    def jax_dev(d):
        return jfeat.FeaturesDev(dict(d.get_features()),
                                 jnp.asarray(d.get_descriptors().numpy()),
                                 d.get_reverse_map())

    theirs = io.StringIO()
    jax_dev(l).match_and_print(jax_dev(r), theirs)
    assert ours.getvalue() == theirs.getvalue()
    assert ours.getvalue().count("\n") == l.get_descriptor_count()
    assert "accept feat" in ours.getvalue()


def test_match_returns_numpy(port):
    l, r = port[1]
    best, second, accept, d1, d2 = l.match(r)
    assert [a.dtype for a in (best, second, accept, d1, d2)] == [
        np.int32, np.int32, np.bool_, np.float32, np.float32]
    assert best.shape == (l.get_descriptor_count(),)
    assert 0 < accept.sum() < len(accept)


@pytest.mark.parametrize("mode", ["u16", "u8", "f32"])
def test_device_rounding_equals_the_host_rounding(mode):
    rng = np.random.default_rng(3)
    d = torch.as_tensor(rng.random((257, 128)).astype(np.float32) * 1.2
                        - 0.1)
    for norm_multi in (0, 9):
        scaled = d * float(2 ** norm_multi)
        dev = quantize_descs_dev(scaled, mode, norm_multi)
        assert dev.dtype == torch.float32
        np.testing.assert_array_equal(
            dev.numpy(), quantize_descs(scaled, mode, norm_multi))


@pytest.mark.parametrize("mode", ["u8", "f32"])
def test_want_dev_with_other_transfers(pair, mode):
    cfg = pt.Config()
    cfg.set_desc_transfer(mode)
    img = np.ascontiguousarray(pair[1][:64, :80])
    host = extract_features(img, cfg, device="cpu")
    dev = extract_features(img, cfg, device="cpu", want_dev=True)
    assert host.get_descriptor_count() > 0
    np.testing.assert_array_equal(dev.get_descriptors().numpy(),
                                  host.get_descriptors())


def test_empty_features_dev():
    empty = assemble_features_dev(Stage2Result(
        keypoints=np.zeros((0, 8), np.float32), octave=np.zeros(0, np.int32),
        desc=torch.zeros((0, 128)), overflow=(), ori_count=(), rows=()),
        1.0, "cpu")
    assert empty.get_feature_count() == empty.get_descriptor_count() == 0
    assert tuple(empty.get_descriptors().shape) == (0, 128)
    assert empty.get_reverse_map().shape == (0,)
    one = pt.FeaturesDev(dict(xpos=np.zeros(1, np.float32),
                              ypos=np.zeros(1, np.float32),
                              sigma=np.ones(1, np.float32),
                              num_ori=np.ones(1, np.int32)),
                         torch.ones(1, 128), np.zeros(1, np.int64))
    best, _, accept, _, d2 = empty.match(one)
    assert best.shape == accept.shape == (0,)
    best, _, accept, _, d2 = one.match(one)
    assert best[0] == 0 and accept[0] and np.isinf(d2[0])


def _row_keys(rev: np.ndarray) -> list:
    """(feature, orientation) of each descriptor row."""
    rev = np.asarray(rev)
    start = np.r_[0, np.flatnonzero(np.diff(rev)) + 1]
    k = np.arange(len(rev)) - np.repeat(start, np.diff(np.r_[start,
                                                              len(rev)]))
    return list(zip(rev.tolist(), k.tolist()))


def test_matching_slice_against_jax(port, jax_side):
    (jl, jr), (jbest, _, jacc, jd1, jd2) = jax_side
    tl, tr = port[1]
    tbest, _, tacc, td1, td2 = tl.match(tr)
    tied = 0
    for j, t in ((jl, tl), (jr, tr)):
        assert j.get_feature_count() == t.get_feature_count()
        tied += int((np.asarray(j.get_features()["num_ori"])
                     != t.get_features()["num_ori"]).sum())
    jl_keys, jr_keys = (_row_keys(d.get_reverse_map()) for d in (jl, jr))
    tl_keys, tr_keys = (_row_keys(d.get_reverse_map()) for d in (tl, tr))
    at = {k: i for i, k in enumerate(tl_keys)}
    unpaired = near = 0
    for i, key in enumerate(jl_keys):
        if key not in at:
            unpaired += 1
            continue
        t = at[key]
        if (jr_keys[jbest[i]] == tr_keys[tbest[t]]
                and bool(jacc[i]) == bool(tacc[t])):
            continue
        tie = min(jd2[i] - jd1[i], td2[t] - td1[t]) <= NEAR_TIE
        assert tie, (f"row {key}: JAX best {jr_keys[jbest[i]]} accept "
                     f"{bool(jacc[i])} ({jd1[i]} vs {jd2[i]}), port "
                     f"{tr_keys[tbest[t]]} {bool(tacc[t])} ({td1[t]} vs "
                     f"{td2[t]})")
        near += 1
    rows = len(jl_keys)
    print(f"{rows} JAX rows: {unpaired} unpaired, {near} differing at a "
          f"near tie; {tied} features with another num_ori")
    assert unpaired + near <= MOST_DIFFERING * rows
    assert tied <= MOST_DIFFERING * (jl.get_feature_count()
                                     + jr.get_feature_count())
    assert abs(len(jl_keys) - len(tl_keys)) <= tied
    assert 0 < int(np.sum(tacc)) < len(tacc)
