"""popsift_torch: SIFT feature extraction in PyTorch with hand-written
CUDA kernels for Hopper (H100), ported from the JAX package popsift_tpu.

This package imports neither JAX nor popsift_tpu.  Extraction runs on a
CUDA device by default; ``device="cpu"`` runs the plain PyTorch version of
every kernel instead.

    from popsift_torch import Config, PopSift, ProcessingMode
    with PopSift(Config()) as ps:
        features = ps.enqueue(w, h, u8_image).get()
    with PopSift(Config(), mode=ProcessingMode.MATCHING, workers=2) as ps:
        left = ps.enqueue(w, h, a).get_dev()      # descriptors on the card
        right = ps.enqueue(w, h, b).get_dev()
        best, second, accept, d1, d2 = left.match(right)
"""

from .config import (MAX_LEVELS, MAX_OCTAVES, Config, DescMode,  # noqa
                     GaussMode, GridFilterMode, ImageMode, LogMode,
                     NormMode, ProcessingMode, ScalingMode, SiftMode)
from .extract import extract_features, make_plan  # noqa: F401
from .features import (Feature, Features, FeaturesBase,  # noqa: F401
                       FeaturesDev, FeaturesHost)
from .pipeline import AllocTest, PopSift, SiftJob  # noqa: F401

__all__ = [
    "Config", "DescMode", "GaussMode", "GridFilterMode", "ImageMode",
    "LogMode", "NormMode", "ProcessingMode", "ScalingMode", "SiftMode",
    "MAX_LEVELS", "MAX_OCTAVES",
    "Feature", "Features", "FeaturesBase", "FeaturesDev", "FeaturesHost",
    "PopSift", "SiftJob",
]
