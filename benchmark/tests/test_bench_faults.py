"""A run with the timed path broken underneath comes out not correct.

Each test drives the whole of a run but the look for a card
(``run.execute`` on the CPU, where the program runs its plain versions,
at a size a test run holds) with one fault planted in the program where
its answer is produced, and sees ``correct`` false with the number that
catches it over its limit.  A sound run of the same size is correct.
"""

import numpy as np
import pytest

from benchmark import run
from benchmark.inputs import oxford_pairs
from benchmark.lib import spec

popsift_torch = pytest.importorskip("popsift_torch")
from popsift_torch import extract as port_extract  # noqa: E402
from popsift_torch import features as port_features  # noqa: E402

SEED = 2 ** 31 + 4242


def _overrides(cell):
    bench = spec.benchmark()
    w = spec.cell(bench, cell)
    config = spec.config(bench, w["config"])
    traffic = dict(spec.traffic(w["traffic"]), sample=1000, warmup=1)
    if config["input"]["kind"] == "synthetic":
        config["input"].update(width=128, height=96, canvases=2, margin=8)
    return {"config": config, "traffic": traffic}


def _run(cell, seconds=1.0):
    return run.execute(cell, SEED, seconds, False, device="cpu",
                       overrides=_overrides(cell))


def _over(result):
    return sorted(k for k, v in result["checks"].items()
                  if v["value"] is None or v["value"] > v["limit"])


def _patch_host(monkeypatch, alter):
    """Alter each FeaturesHost where the extraction assembles it."""
    real = port_extract.assemble_features
    calls = []

    def broken(octaves, up):
        feats = real(octaves, up)
        calls.append(1)
        return alter(feats, len(calls))

    monkeypatch.setattr(port_extract, "assemble_features", broken)


def _host(soa, desc):
    return port_features.FeaturesHost(descriptors=desc, soa=soa)


def test_a_sound_run_is_correct():
    res = _run("1080p-default.batch8")
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 2
    assert _over(res) == []


def _shift_one_keypoint(f, n):
    soa = {k: np.array(v, copy=True) for k, v in f.soa().items()}
    soa["xpos"][0] += 0.05 * soa["sigma"][0]
    return _host(soa, f.get_descriptors())


def _alter_one_descriptor(f, n):
    d = np.array(f.get_descriptors(), copy=True)
    d[0, 5] += 0.05
    return _host(f.soa(), d)


def _alter_one_orientation(f, n):
    soa = {k: np.array(v, copy=True) for k, v in f.soa().items()}
    soa["orientation"][0, 0] += 0.05
    return _host(soa, f.get_descriptors())


def _half_left_out(f, n):
    """Every second image of the batch comes back without its features."""
    return port_features.FeaturesHost() if n % 2 == 0 else f


_previous = {}


def _answers_swapped(f, n):
    """Each image gets the features of the image before it."""
    out = _previous.get("f", f)
    _previous["f"] = f
    return out


@pytest.mark.parametrize("alter,number", [
    (_shift_one_keypoint, "pos_gap"),
    (_alter_one_descriptor, "desc_gap"),
    (_alter_one_orientation, "angle_gap"),
    (_half_left_out, "miss_share"),
    (_answers_swapped, "miss_share"),
])
def test_a_broken_extraction_is_not_correct(monkeypatch, alter, number):
    _previous.clear()
    _patch_host(monkeypatch, alter)
    res = _run("1080p-default.batch8")
    assert not res["correct"]
    assert number in _over(res)


@pytest.fixture
def small_photographs(monkeypatch):
    """The pairs cell's photographs cut to 96x128, so that the CPU runs a
    pair in a second."""
    real = oxford_pairs.read_pgm
    monkeypatch.setattr(oxford_pairs, "read_pgm",
                        lambda p: np.ascontiguousarray(real(p)[160:256,
                                                               200:328]))


def _patch_match(monkeypatch, alter):
    real = port_features.FeaturesDev.match

    def broken(self, other, ratio=0.8):
        return alter(*(np.array(a, copy=True)
                       for a in real(self, other, ratio)))

    monkeypatch.setattr(port_features.FeaturesDev, "match", broken)


def _wrong_best(best, second, accept, d1, d2):
    best[0], second[0] = second[0], best[0]
    return best, second, accept, d1, d2


def _flipped_accept(best, second, accept, d1, d2):
    return best, second, ~accept, d1, d2


def test_a_sound_pairs_run_is_correct(small_photographs):
    res = _run("oxford-640.pairs", 2.0)
    assert res["correct"] and res["attempted"] >= 1


@pytest.mark.parametrize("alter,number", [
    (_wrong_best, "dist_gap"), (_flipped_accept, "accept_miss")])
def test_a_broken_match_is_not_correct(monkeypatch, small_photographs,
                                       alter, number):
    _patch_match(monkeypatch, alter)
    res = _run("oxford-640.pairs", 2.0)
    assert not res["correct"]
    assert number in _over(res)


def test_an_altered_device_descriptor_is_not_correct(monkeypatch,
                                                      small_photographs):
    real = port_extract.assemble_features_dev

    def broken(octaves, up, device):
        f = real(octaves, up, device)
        if f.get_descriptor_count():
            f.get_descriptors()[0, 3] += 0.05
        return f

    monkeypatch.setattr(port_extract, "assemble_features_dev", broken)
    res = _run("oxford-640.pairs", 2.0)
    assert not res["correct"]
    assert "desc_gap" in _over(res)
