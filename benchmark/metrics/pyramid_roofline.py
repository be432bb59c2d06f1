"""The scale space's share of its roofline: the least time the card
needs for the slice's images' pyramids (benchmark/lib/work.py: the
source read once, the L+3 Gaussian levels and L+2 DoG planes written
once in float32, against 3.35 TB/s, or their blur operations against
67 TFLOP/s, the larger), over the device time of every operation the
program launched inside its ``pyramid`` scope."""

from benchmark.lib import work


def read(run):
    if run.trace is None:
        return None
    device_s = run.trace["scope_device_s"].get("pyramid", 0.0)
    if device_s <= 0.0:
        return None
    p = run.plan
    bound = work.pyramid_seconds(p["input_w"], p["input_h"], p["dims"],
                                 p["levels"], p["spans"])
    return 100.0 * bound * run.slice_requests / device_s
