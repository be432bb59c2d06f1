"""Settings the port accepted without an end-to-end test, against
popsift_tpu on the CPU: ``norm_mode=classic`` (L2 descriptors), float
input (``ImageMode.FLOAT``: a [0, 1] float32 image), and non-default
``levels``, ``sigma`` and upscale (no upscaling, ``upscale_factor=0``).
The sigma is below the default: at 1.8 the JAX package's rolled window
gather refuses the descriptor window (``win <= 120``,
popsift_tpu/kernels/windows2.py:27).

``extract_features(img, cfg, device="cpu")`` against the JAX package's
jitted extractor (``popsift_tpu.extract.get_extractor``) for the same
settings, on the conftest ``textured_image`` and a 120x160 hopper crop,
with the end-to-end tolerances of ``test_torch_e2e.py``
(``torch_parity.py`` says which and why).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import torch_parity as tp  # noqa: E402

from popsift_torch import config as tcfg  # noqa: E402

CASES = {
    "norm_mode=classic": dict(norm_mode=tcfg.NormMode.CLASSIC),
    "levels=4": dict(levels=4),
    "sigma=1.4": dict(sigma=1.4),
    "upscale_factor=0": dict(upscale_factor=0.0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_setting_end_to_end(case, textured_image):
    tp.check_images(tcfg.Config(**CASES[case]), textured_image)


def test_float_input_end_to_end(textured_image):
    """A float32 image in [0, 1] (the packages take it as it is) rather
    than bytes."""
    tp.check_images(tcfg.Config(), textured_image,
                    image=lambda im: im.astype(np.float32) / 255.0)
