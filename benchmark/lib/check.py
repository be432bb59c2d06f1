"""The numbers that decide ``correct``: the program's sampled outputs
against the plain reference on the same inputs, and the control, the
reference one precision step down put in the program's place."""

from __future__ import annotations

import contextlib

import torch

from ..reference import match as ref_match
from ..reference import sift
from . import judge


@contextlib.contextmanager
def tf32(on: bool):
    """cuBLAS and cuDNN float32 products in TF32 (``on``) or IEEE float32
    for the block."""
    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    old = (mm.allow_tf32, cudnn.allow_tf32)
    mm.allow_tf32 = cudnn.allow_tf32 = on
    try:
        yield
    finally:
        mm.allow_tf32, cudnn.allow_tf32 = old


def program_arrays(kind: str, output):
    """A sampled output as host arrays, before the program is freed."""
    if kind == "extract":
        return judge.host_features(output)
    fa, fb, m = output
    return (judge.device_features(fa), judge.device_features(fb), m)


def reference(image, settings: dict, device, control: bool = False,
              ref=sift):
    """The features of ``ref`` (a module of ``benchmark/reference/``) on
    one image; with ``control`` the control's."""
    dtype = torch.bfloat16 if control else torch.float32
    with tf32(control), torch.no_grad():
        return judge.reference_features(
            ref.extract(image, settings, device, pyramid_dtype=dtype))


def _merge(into: dict, numbers: dict) -> None:
    for k, v in numbers.items():
        into[k] = max(into.get(k, 0), v)


def numbers(kind: str, samples: list, gen, settings: dict, device,
            ratio: float = 0.8, control: bool = False, ref=sift) -> dict:
    """The largest of each number over ``samples``, (index, arrays) of
    :func:`program_arrays`, or with ``control`` only the indices, whose
    outputs the control then makes; ``ref`` is the configuration's
    reference module."""
    out: dict = {}
    for index, prog in samples:
        request = gen.request(index)
        if kind == "extract":
            want = reference(request, settings, device, ref=ref)
            got = reference(request, settings, device, True, ref) \
                if control else prog
            _merge(out, judge.compare_features(got, want))
            continue
        refs = [reference(im, settings, device, ref=ref) for im in request]
        if control:
            fa, fb = (reference(im, settings, device, True, ref)
                      for im in request)
            m = None
            if fa["descriptors"].shape[0] and fb["descriptors"].shape[0]:
                m = ref_match.match(fa["descriptors"], fb["descriptors"],
                                    ratio, device, torch.float32, tf32=True)
        else:
            fa, fb, m = prog
        for got, want in zip((fa, fb), refs):
            nums = judge.compare_features(got, want)
            nums.pop("angle_gap", None)
            _merge(out, nums)
        if m is not None:
            d64 = ref_match.distances(fa["descriptors"], fb["descriptors"],
                                      device)
            _merge(out, judge.compare_matches(
                fa["descriptors"], fb["descriptors"], m, d64.cpu().numpy(),
                ratio))
        else:
            _merge(out, dict(dist_gap=0.0, accept_miss=0))
    return out
