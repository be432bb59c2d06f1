"""The port's pyramid strategies end to end against popsift_tpu on the CPU.

Fixed9, Fixed15 and VLFeat-relative-all (``gauss_mode`` "vlfeat-direct"),
``scaling_mode=direct`` and Fixed9 with direct scaling:
``popsift_torch.extract.extract_features(img, cfg, device="cpu")``
against the JAX package's jitted extractor
(``popsift_tpu.extract.get_extractor``) for the same settings, on the
conftest ``textured_image`` and a 120x160 hopper crop, with the
end-to-end tolerances of ``test_torch_e2e.py`` (``torch_parity.py`` says
which and why).  Each case must find features on both images.
"""

import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import torch_parity as tp  # noqa: E402

from popsift_torch import config as tcfg  # noqa: E402

CASES = {
    "fixed9": dict(gauss_mode=tcfg.GaussMode.FIXED9),
    "fixed15": dict(gauss_mode=tcfg.GaussMode.FIXED15),
    "vlfeat-direct": dict(gauss_mode=tcfg.GaussMode.VLFEAT_RELATIVE_ALL),
    "direct": dict(scaling_mode=tcfg.ScalingMode.SCALE_DIRECT),
    "fixed9-direct": dict(gauss_mode=tcfg.GaussMode.FIXED9,
                          scaling_mode=tcfg.ScalingMode.SCALE_DIRECT),
}


@pytest.mark.parametrize("case", list(CASES))
def test_pyramid_strategy_end_to_end(case, textured_image):
    tp.check_images(tcfg.Config(**CASES[case]), textured_image)
