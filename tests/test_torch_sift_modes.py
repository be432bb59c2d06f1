"""The OpenCV and VLFeat SiftModes, and the OpenCV and VLFeat-relative
Gauss tables, end to end against popsift_tpu on the CPU.

``extract_features(img, cfg, device="cpu")`` against the JAX package's
jitted extractor (``popsift_tpu.extract.get_extractor``) for the same
settings, on the conftest ``textured_image`` and a 120x160 hopper crop,
with the end-to-end tolerances of ``test_torch_e2e.py``
(``torch_parity.py`` says which and why).  The SiftModes differ in the
input's sub-pixel shift, K3's contrast gate and border and K4's Newton
step rules; the two Gauss modes only in their tables.
"""

import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import torch_parity as tp  # noqa: E402

from popsift_torch import config as tcfg  # noqa: E402

CASES = {
    "sift_mode=opencv": dict(sift_mode=tcfg.SiftMode.OPENCV),
    "sift_mode=vlfeat": dict(sift_mode=tcfg.SiftMode.VLFEAT),
    "gauss_mode=opencv": dict(gauss_mode=tcfg.GaussMode.OPENCV_COMPUTE),
    "gauss_mode=vlfeat-hw-interpolated": dict(
        gauss_mode=tcfg.GaussMode.VLFEAT_RELATIVE),
}


@pytest.mark.parametrize("case", list(CASES))
def test_mode_end_to_end(case, textured_image):
    tp.check_images(tcfg.Config(**CASES[case]), textured_image)
