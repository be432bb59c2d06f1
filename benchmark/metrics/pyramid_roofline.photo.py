"""The scale space's share of its roofline on float32 photographs: the
least time the card needs for the slice's images' pyramids
(benchmark/lib/work.py, with the octave-0 source read as float32, four
bytes a pixel, where ``work.pyramid_bytes`` counts the one byte of a
uint8 image), over the device time of every operation the program
launched inside its ``pyramid`` scope."""

from benchmark.lib import work


def read(run):
    if run.trace is None:
        return None
    device_s = run.trace["scope_device_s"].get("pyramid", 0.0)
    if device_s <= 0.0:
        return None
    p = run.plan
    source = (work.F32 - 1) * p["input_w"] * p["input_h"]
    bound = max((work.pyramid_bytes(p["input_w"], p["input_h"], p["dims"],
                                    p["levels"]) + source)
                / work.PEAK_BYTES_PER_S,
                work.pyramid_flops(p["dims"], p["spans"])
                / work.PEAK_F32_FLOPS)
    return 100.0 * bound * run.slice_requests / device_s
