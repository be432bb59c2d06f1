"""popsift_torch: SIFT feature extraction in PyTorch with hand-written
CUDA kernels for Hopper (H100), ported from the JAX package popsift_tpu.

This package imports neither JAX nor popsift_tpu.  Extraction runs on a
CUDA device by default; ``device="cpu"`` runs the plain PyTorch version of
every kernel instead.

    from popsift_torch import Config, PopSift
    with PopSift(Config()) as ps:
        features = ps.enqueue(w, h, u8_image).get()
"""

from .config import (Config, DescMode, GaussMode, GridFilterMode,  # noqa
                     ImageMode, LogMode, NormMode, ProcessingMode,
                     ScalingMode, SiftMode)
from .extract import extract_features, make_plan  # noqa: F401
from .features import Feature, Features, FeaturesHost  # noqa: F401
from .pipeline import AllocTest, PopSift, SiftJob  # noqa: F401
