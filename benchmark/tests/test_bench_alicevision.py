"""AliceVision's popSIFT deployment in the harness: the configuration
``alicevision-popsift-24mp`` names ``sift_filtered`` and float images,
its reference refuses what it does not implement and filters as
s_filtergrid.cu does, its photographs are float32 windows into fixed
canvases, and a small run of its cell on the CPU is correct and reads
its per-layer metrics."""

import numpy as np
import pytest

from benchmark import run
from benchmark.inputs import photo_float
from benchmark.lib import spec
from benchmark.reference import sift_filtered

pytest.importorskip("popsift_torch")

CELL = "av-photo-24mp.live"
CONFIG = "alicevision-popsift-24mp"


def _config():
    return spec.config(spec.benchmark(), CONFIG)


def test_the_cell_resolves_to_sift_filtered_and_float():
    bench = spec.benchmark()
    cell = spec.cell(bench, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        (CONFIG, "live", 1)
    config = _config()
    assert spec.reference_of(config) is sift_filtered
    assert spec.image_mode_of(config) == "float"
    settings = sift_filtered.settings_of(config["popsift_config"])
    assert (settings["filter_max_extrema"], settings["grid_filter_mode"],
            settings["upscale_factor"]) == (20000, "down", 0.0)
    assert run.plan_info(sift_filtered, settings, 6000, 4000) == dict(
        input_w=6000, input_h=4000,
        dims=((6000, 4000), (3000, 2000), (1500, 1000), (750, 500),
              (375, 250), (188, 125)),
        levels=3, spans=[8, 6, 8, 9, 11, 14])
    assert [m["name"] for m in spec.metrics_of(bench, CELL, False)] == \
        ["images_per_s", "setup_s"]
    # the batch cells' metrics where their declarations may list the cell,
    # the cell's own, and the batch cells' readers under the cell's names
    assert [m["name"] for m in spec.metrics_of(bench, CELL, True)] == [
        "handoff_ms.batch", "stage1_host_ms.batch",
        "launches_per_image.batch", "device_idle_pct.batch",
        "filter_ms.photo", "overflow_per_image.photo",
        "pyramid_roofline.photo", "readback_ms.photo",
        "readbacks_per_image.photo", "dispatch_ms.photo",
        "upload_ms.photo", "stage2_pass_ms.photo"]


@pytest.mark.parametrize("key,value", [
    ("grid_filter_mode", "random"), ("ext_capacity", 4096),
    ("ori_capacity", 4096), ("sift_mode", "opencv"),
    ("gauss_mode", "relative"), ("desc_mode", "grid"),
    ("filter_grid_size", 0), ("no_such_setting", 1)])
def test_settings_of_refuses_what_it_does_not_implement(key, value):
    popsift_config = dict(_config()["popsift_config"], **{key: value})
    with pytest.raises(ValueError, match="reference"):
        sift_filtered.settings_of(popsift_config)


def test_random_scale_is_taken_with_the_filter_off():
    popsift_config = dict(_config()["popsift_config"],
                          grid_filter_mode="random", filter_max_extrema=-1)
    assert sift_filtered.settings_of(popsift_config)["grid_filter_mode"] \
        == "random"


def test_make_plan_keeps_up_to_max_extrema():
    settings = sift_filtered.settings_of(_config()["popsift_config"])
    plan = sift_filtered.make_plan(settings, 6000, 4000)
    assert plan.ext_caps == (100000,) * 6
    assert plan.ori_caps == (125056,) * 6
    # 16 candidates of each 1,024 voxels of the mask
    assert plan.cand_caps[0] == -(-6000 * 4000 * 3 // 1024) * 16


@pytest.mark.parametrize("largest_first", [True, False])
def test_grid_filter_by_hand(largest_first):
    """Cells of 1, 2, 3 and 10 extrema, budget 8: sumup 4, 7, 9, 16, so
    ct = 2, tailaverage 6.5, (16 - 8) / 2 = 4 and newlimit ceil(2.5) = 3;
    the crowded cell keeps its three largest (smallest) scales."""
    cells = np.array([3] * 10 + [0] + [1] * 2 + [2] * 3)
    scales = np.float32([5, 9, 1, 9, 2, 8, 3, 7, 4, 6, 1, 1, 1, 1, 1, 1])
    keep = sift_filtered.grid_filter(cells, scales, 8, 2, largest_first)
    assert keep[10:].all() and keep.sum() == 9
    want = [1, 3, 5] if largest_first else [2, 4, 6]
    assert np.flatnonzero(keep[:10]).tolist() == want
    # no filter when 8 * 1.1 is not below the total
    assert sift_filtered.grid_filter(cells[:8], scales[:8], 8, 2,
                                     largest_first).all()


def test_photographs_are_float_windows_of_fixed_canvases():
    params = dict(width=96, height=64, canvases=2, margin=8)
    a = photo_float.Generator(params, 2 ** 31 + 3)
    b = photo_float.Generator(params, 5)
    for ca, cb in zip(a.canvases, b.canvases):
        np.testing.assert_array_equal(ca, cb)
    frames = [a.request(i) for i in range(6)]
    assert all(f.shape == (64, 96) and f.dtype == np.float32
               and 0.0 <= f.min() and f.max() <= 1.0 for f in frames)
    assert len({f.tobytes() for f in frames}) == 6
    assert [a.describe(i) for i in range(6)] != \
        [b.describe(i) for i in range(6)]


def test_a_small_traced_run_on_the_cpu_is_correct():
    config = _config()
    config["input"].update(width=320, height=240, canvases=2, margin=8)
    config["popsift_config"]["filter_max_extrema"] = 150
    traffic = dict(spec.traffic("live"), sample=2, warmup=1, slice=2)
    from popsift_torch import tracing
    was = tracing.HOSTTRACE
    tracing.enable(True)       # as POPSIFT_TPU_HOSTTRACE=1 does in a run
    try:
        res = run.execute(CELL, 2 ** 31 + 23, 1.0, True, device="cpu",
                          overrides={"config": config, "traffic": traffic})
    finally:
        tracing.enable(was)
    assert res["correct"] and res["failed"] == 0, res["checks"]
    metrics = res["metrics"]
    assert metrics["overflow_per_image.photo"]["value"] == 0.0
    for name in ("handoff_ms.batch", "stage1_host_ms.batch",
                 "launches_per_image.batch", "device_idle_pct.batch",
                 "filter_ms.photo", "readback_ms.photo",
                 "readbacks_per_image.photo", "dispatch_ms.photo",
                 "upload_ms.photo", "stage2_pass_ms.photo"):
        assert metrics[name]["value"] >= 0.0, name
    # no device time in the pyramid scope on the CPU: nothing, not 0
    assert "pyramid_roofline.photo" not in metrics
