"""The work of a stage counted from its shapes, and the card's peaks.

The counts follow what the stage has to compute, not what today's
kernels read and write, so a bound reads the same work whatever
implements it.
"""

from __future__ import annotations

# NVIDIA's H100 SXM data sheet, dense rates, at the full 700 W
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
F32 = 4


def pyramid_bytes(input_w: int, input_h: int, dims, levels: int) -> int:
    """Bytes the scale space of one image must move at least: per octave
    its source read once (the uint8 input for octave 0, the float32 seed
    level for a later octave) and its L+3 Gaussian levels and L+2 DoG
    planes written once in float32.  The gradient field is derived data
    and left out."""
    total = 0
    for o, (w, h) in enumerate(dims):
        total += input_w * input_h if o == 0 else w * h * F32
        total += (2 * levels + 5) * w * h * F32
    return total


def pyramid_flops(dims, spans) -> int:
    """Floating-point operations of one image's scale space: each level
    one separable blur, a multiply and an add for each of the 2 span - 1
    taps of each of its two passes (``spans[l]`` taps of a half filter),
    and one subtraction a DoG pixel.  A later octave's level 0 is picked
    from the octave before, with no blur."""
    blur = [2 * 2 * (2 * s - 1) for s in spans]
    total = 0
    for o, (w, h) in enumerate(dims):
        total += w * h * (sum(blur[0 if o == 0 else 1:]) + len(spans) - 1)
    return total


def pyramid_seconds(input_w: int, input_h: int, dims, levels: int,
                    spans) -> float:
    """The least time the card needs for one image's scale space: the
    larger of its bytes over the memory peak and its operations over the
    float32 peak."""
    return max(pyramid_bytes(input_w, input_h, dims, levels)
               / PEAK_BYTES_PER_S,
               pyramid_flops(dims, spans) / PEAK_F32_FLOPS)
