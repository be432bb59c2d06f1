"""A configuration names its own plain reference and image mode.

``"reference": "<m>"`` in a configuration file makes
``benchmark/reference/<m>.py`` judge it everywhere the reference is
used: the settings, the plan behind ``pyramid_roofline``, the check of a
run and the control.  ``"image_mode": "float"`` builds PopSift with
FloatImages.  A configuration without either key is judged and run as
before.  Stub modules stand in for a new reference and a new input
generator, put in ``sys.modules`` under their package's name; each run
here is ``run.execute`` on the CPU at 128x96."""

import collections
import sys
import types

import numpy as np
import pytest
import torch

from benchmark import control, run
from benchmark.inputs import synthetic
from benchmark.lib import spec
from benchmark.reference import sift

popsift_torch = pytest.importorskip("popsift_torch")

SEED = 2 ** 31 + 2121
CELL = "1080p-default.batch8"

# run.plan_info of the three configurations before a configuration could
# name its reference (their input sizes; 640x480 is the pairs' scenes)
FULL_HD = dict(input_w=1920, input_h=1080,
               dims=((3840, 2160), (1920, 1080), (960, 540), (480, 270),
                     (240, 135), (120, 68), (60, 34), (30, 17), (15, 9)),
               levels=3, spans=[6, 6, 8, 9, 11, 14])
PLANS = {
    "popsift-1080p": FULL_HD,
    "popsift-1080p-notile": FULL_HD,
    "oxford-match-640": dict(
        input_w=640, input_h=480,
        dims=((1280, 960), (640, 480), (320, 240), (160, 120), (80, 60),
              (40, 30), (20, 15)),
        levels=3, spans=[6, 6, 8, 9, 11, 14]),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_the_accepted_configurations_keep_sift_and_bytes(name):
    config = spec.config(spec.benchmark(), name)
    assert "reference" not in config and "image_mode" not in config
    ref = spec.reference_of(config)
    assert ref is sift and ref.__name__ == "benchmark.reference.sift"
    assert spec.image_mode_of(config) == "byte"
    want = PLANS[name]
    settings = ref.settings_of(config["popsift_config"])
    assert run.plan_info(ref, settings, want["input_w"],
                         want["input_h"]) == want


def _stub_reference(monkeypatch, name, extract=None):
    """``benchmark.reference.<name>``: sift's functions, counted, with
    ``extract`` in place of sift's where given."""
    calls = collections.Counter()
    mod = types.ModuleType(f"benchmark.reference.{name}")

    def settings_of(popsift_config):
        calls["settings_of"] += 1
        return sift.settings_of(popsift_config)

    def make_plan(settings, w, h):
        calls["make_plan", w, h] += 1
        return sift.make_plan(settings, w, h)

    def gauss_tables(settings):
        calls["gauss_tables"] += 1
        return sift.gauss_tables(settings)

    def counted_extract(image, settings, device,
                        pyramid_dtype=torch.float32):
        calls["extract", str(pyramid_dtype), str(image.dtype)] += 1
        return (extract or sift.extract)(image, settings, device,
                                         pyramid_dtype)

    mod.settings_of, mod.make_plan = settings_of, make_plan
    mod.gauss_tables, mod.extract = gauss_tables, counted_extract
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    return calls


def _overrides(**keys):
    bench = spec.benchmark()
    config = spec.config(bench, spec.cell(bench, CELL)["config"])
    config["input"].update(width=128, height=96, canvases=2, margin=8)
    config.update(keys)
    traffic = dict(spec.traffic(spec.cell(bench, CELL)["traffic"]),
                   sample=3, warmup=1)
    return {"config": config, "traffic": traffic}


def _execute(overrides, device="cpu"):
    return run.execute(CELL, SEED, 1.0, False, device=device,
                       overrides=overrides)


def _no_features(image, settings, device, pyramid_dtype=torch.float32):
    out = sift.extract(image, settings, device, pyramid_dtype)
    keep = np.zeros(out["xpos"].shape[0], bool)
    res = {k: out[k][keep] for k in ("xpos", "ypos", "sigma", "num_ori",
                                      "orientation", "desc_idx",
                                      "debug_octave")}
    res["descriptors"] = out["descriptors"][:0]
    return res


def test_the_named_reference_judges_the_run(monkeypatch):
    calls = _stub_reference(monkeypatch, "stub_sift")
    res = _execute(_overrides(reference="stub_sift"))
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 1
    assert calls["settings_of"] == 1
    assert calls["make_plan", 128, 96] == 1 and calls["gauss_tables"] == 1
    assert calls["extract", "torch.float32", "uint8"] == 3
    assert sum(calls.values()) == 6


def test_a_reference_that_disagrees_makes_the_run_not_correct(monkeypatch):
    """The same program on the same seed, judged by a reference that
    finds nothing: only the named module can have made it not correct."""
    calls = _stub_reference(monkeypatch, "stub_empty", _no_features)
    res = _execute(_overrides(reference="stub_empty"))
    assert res["failed"] == 0 and not res["correct"]
    assert res["checks"]["miss_share"]["value"] == 1.0
    assert calls["extract", "torch.float32", "uint8"] == 3


def test_the_named_reference_is_the_control(monkeypatch):
    """sift's control is not correct on these seeds
    (test_bench_reference.py); a reference that ignores the control's
    bfloat16 agrees with itself, so the control reads correct: it ran
    the named module at both precisions."""

    def float32_only(image, settings, device, pyramid_dtype=torch.float32):
        return sift.extract(image, settings, device, torch.float32)

    calls = _stub_reference(monkeypatch, "stub_f32", float32_only)
    ov = _overrides(reference="stub_f32")
    ov["traffic"]["sample"] = 1
    for seed in (3, 77):
        checks, correct = control.control_numbers(CELL, seed, "cpu", 12, ov)
        assert correct, checks
    assert calls["settings_of"] == 2
    assert calls["extract", "torch.float32", "uint8"] == 2
    assert calls["extract", "torch.bfloat16", "uint8"] == 2
    checks, correct = control.control_numbers(
        CELL, 3, "cpu", 12, _overrides() | {"traffic": ov["traffic"]})
    assert not correct


@pytest.mark.parametrize("key,value", [
    ("reference", "no_such_reference"), ("reference", "../sift"),
    ("reference", "sift.extract"), ("reference", ""), ("reference", 7),
    ("reference", "match"),
    ("image_mode", "half"), ("image_mode", "Float"), ("image_mode", 1),
])
def test_a_bad_name_stops_the_set_up(key, value):
    ov = _overrides(**{key: value})
    with pytest.raises(SystemExit, match=f"'{key}'"):
        spec.reference_of(ov["config"])
        spec.image_mode_of(ov["config"])
    # before the card is touched: this machine's "cuda:0" would fail later
    with pytest.raises(SystemExit, match=f"'{key}'"):
        _execute(ov, device="cuda:0")
    if key == "reference":
        with pytest.raises(SystemExit, match="'reference'"):
            control.control_numbers(CELL, 3, "cpu", 12, ov)


def test_main_stops_on_a_bad_name_before_it_looks_for_a_card(monkeypatch):
    bad = _overrides(image_mode="half")["config"]
    monkeypatch.setattr(spec, "config", lambda bench, name: bad)
    monkeypatch.setattr(run, "set_environment", lambda config, trace: None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: pytest.fail(
        "looked for a card before checking the configuration"))
    with pytest.raises(SystemExit, match="'image_mode'"):
        run.main(["--workload", CELL, "--seed", "5", "--seconds", "1"])


class FloatFrames(synthetic.Generator):
    """The synthetic frames in [0, 1] as float32, each the float32 image
    that the program's byte path makes from the frame's bytes."""

    def request(self, i):
        return super().request(i).astype(np.float32) * np.float32(1 / 255)


def _float_reference(image, settings, device, pyramid_dtype=torch.float32):
    """sift on the bytes that the float frame was made from."""
    assert image.dtype == np.float32
    return sift.extract(np.rint(image * 255.0).astype(np.uint8), settings,
                        device, pyramid_dtype)


@pytest.fixture
def float_frames(monkeypatch):
    mod = types.ModuleType("benchmark.inputs.stub_float_frames")
    mod.Generator = FloatFrames
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    built = []

    class Recorded(popsift_torch.PopSift):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            built.append(self)

    monkeypatch.setattr(popsift_torch, "PopSift", Recorded)
    yield built
    for ps in built:
        ps.uninit()


def _float_overrides(**keys):
    ov = _overrides(reference="stub_float", **keys)
    ov["config"]["input"]["kind"] = "stub_float_frames"
    return ov


def test_float_images_go_through_the_cpu_path(monkeypatch, float_frames):
    calls = _stub_reference(monkeypatch, "stub_float", _float_reference)
    res = _execute(_float_overrides(image_mode="float"))
    assert [ps._image_mode for ps in float_frames] == \
        [popsift_torch.PopSift.FloatImages]
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 1
    assert calls["extract", "torch.float32", "float32"] == 3
    assert max(v["value"] for v in res["checks"].values()) == 0


def test_float_frames_in_byte_mode_fail(monkeypatch, float_frames):
    """Without the key the pipeline takes bytes, as before, and refuses
    the float frames."""
    _stub_reference(monkeypatch, "stub_float", _float_reference)
    with pytest.raises(RuntimeError, match="Image mode error"):
        _execute(_float_overrides())
    assert [ps._image_mode for ps in float_frames] == \
        [popsift_torch.PopSift.ByteImages]
