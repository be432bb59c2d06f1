"""Runtime configuration of the PyTorch/CUDA PopSift port.

A copy of ``popsift_tpu.config`` with the same field names, defaults and
string parsers, so that a user can switch packages without relearning the
knobs.  The port keeps its own copy because importing anything from
``popsift_tpu`` imports JAX.

Every mode of the JAX package is implemented, the ``log_mode=ALL`` dump
tree included (:mod:`popsift_torch.debugdump`).
"""

from __future__ import annotations

import dataclasses
import enum
import math

MAX_OCTAVES = 20  # sift_conf.h:12
MAX_LEVELS = 10   # sift_conf.h:13


class GaussMode(enum.Enum):
    """Gauss filter span/table policy (sift_conf.h:38-46)."""

    VLFEAT_COMPUTE = "vlfeat"
    VLFEAT_RELATIVE = "vlfeat-hw-interpolated"
    VLFEAT_RELATIVE_ALL = "vlfeat-direct"
    OPENCV_COMPUTE = "opencv"
    FIXED9 = "fixed9"
    FIXED15 = "fixed15"


_GAUSS_MODE_ALIASES = {
    "vlfeat": GaussMode.VLFEAT_COMPUTE,
    "vlfeat-hw-interpolated": GaussMode.VLFEAT_RELATIVE,
    "relative": GaussMode.VLFEAT_RELATIVE,
    "vlfeat-direct": GaussMode.VLFEAT_RELATIVE_ALL,
    "opencv": GaussMode.OPENCV_COMPUTE,
    "fixed9": GaussMode.FIXED9,
    "fixed15": GaussMode.FIXED15,
}


class SiftMode(enum.Enum):
    """Numerical-convention emulation mode (sift_conf.h:51-61)."""

    POPSIFT = "popsift"
    OPENCV = "opencv"
    VLFEAT = "vlfeat"


class LogMode(enum.Enum):
    NONE = "none"
    ALL = "all"


class ScalingMode(enum.Enum):
    SCALE_DIRECT = "direct"
    SCALE_DEFAULT = "indirect"


class DescMode(enum.Enum):
    """Descriptor extraction strategy (sift_conf.h:85-97)."""

    LOOP = "loop"
    ILOOP = "iloop"
    GRID = "grid"
    IGRID = "igrid"
    NOTILE = "notile"


class NormMode(enum.Enum):
    ROOT_SIFT = "RootSift"
    CLASSIC = "classic"


class GridFilterMode(enum.Enum):
    RANDOM_SCALE = "random"
    LARGEST_SCALE_FIRST = "down"
    SMALLEST_SCALE_FIRST = "up"


class ProcessingMode(enum.Enum):
    EXTRACTING = "extracting"
    MATCHING = "matching"


class ImageMode(enum.Enum):
    BYTE = "byte"
    FLOAT = "float"


_DESC_TRANSFERS = ("f32", "u16", "u8", "u8p")


@dataclasses.dataclass
class Config:
    """Extraction parameters. Defaults match sift_conf.cu:18-41."""

    octaves: int = -1
    levels: int = 3
    sigma: float = 1.6
    edge_limit: float = 10.0
    threshold: float = 0.04
    upscale_factor: float = 1.0
    gauss_mode: GaussMode = GaussMode.VLFEAT_COMPUTE
    sift_mode: SiftMode = SiftMode.POPSIFT
    log_mode: LogMode = LogMode.NONE
    scaling_mode: ScalingMode = ScalingMode.SCALE_DEFAULT
    desc_mode: DescMode = DescMode.LOOP
    grid_filter_mode: GridFilterMode = GridFilterMode.RANDOM_SCALE
    verbose: bool = False
    max_extrema: int = 100000
    filter_max_extrema: int = -1
    filter_grid_size: int = 2
    assume_initial_blur: bool = True
    initial_blur: float = 0.5
    norm_mode: NormMode = NormMode.ROOT_SIFT
    norm_multiplier: int = 0
    print_gauss_tables: bool = False
    # capacity knobs: -1 derives them from the image size (make_plan)
    ext_capacity: int = -1
    ori_capacity: int = -1
    # precision of the returned descriptors: "u16" rounds them to 16-bit
    # fixed point scaled by 2^norm_multiplier, "u8"/"u8p" to 8 bits,
    # "f32" keeps the floats
    desc_transfer: str = "u16"

    def __post_init__(self) -> None:
        self.set_desc_transfer(self.desc_transfer)

    def set_desc_transfer(self, mode: str) -> None:
        if mode not in _DESC_TRANSFERS:
            raise ValueError(
                "desc_transfer must be one of 'f32', 'u16', 'u8', 'u8p' "
                f"(got {mode!r})")
        self.desc_transfer = mode

    # setter API mirroring the reference (sift_conf.h:143-334)
    def set_gauss_mode(self, m) -> None:
        if isinstance(m, str):
            if m not in _GAUSS_MODE_ALIASES:
                raise ValueError(
                    "Bad Gauss mode. Options: vlfeat (default), "
                    "vlfeat-hw-interpolated, vlfeat-direct, opencv, fixed9, "
                    "fixed15, relative")
            self.gauss_mode = _GAUSS_MODE_ALIASES[m]
        else:
            self.gauss_mode = GaussMode(m)

    def set_mode(self, m: SiftMode) -> None:
        self.sift_mode = SiftMode(m)

    def set_log_mode(self, mode: LogMode = LogMode.ALL) -> None:
        self.log_mode = LogMode(mode)

    def set_scaling_mode(self,
                         mode: ScalingMode = ScalingMode.SCALE_DEFAULT) -> None:
        self.scaling_mode = ScalingMode(mode)

    def set_verbose(self, on: bool = True) -> None:
        self.verbose = on

    def set_desc_mode(self, m) -> None:
        if isinstance(m, str):
            try:
                self.desc_mode = DescMode(m)
            except ValueError:
                raise ValueError(
                    "specified descriptor extraction mode must be one of "
                    "loop, iloop, grid, igrid or notile") from None
        else:
            self.desc_mode = DescMode(m)

    def set_downsampling(self, v: float) -> None:
        self.upscale_factor = -float(v)  # sift_conf.cu:235, stored negated

    def set_octaves(self, v: int) -> None:
        self.octaves = int(v)

    def set_levels(self, v: int) -> None:
        self.levels = int(v)

    def set_sigma(self, v: float) -> None:
        self.sigma = float(v)

    def set_edge_limit(self, v: float) -> None:
        self.edge_limit = float(v)

    def set_threshold(self, v: float) -> None:
        self.threshold = float(v)

    def set_initial_blur(self, blur: float) -> None:
        self.assume_initial_blur = blur != 0.0
        self.initial_blur = float(blur)

    def set_filter_max_extrema(self, ext: int) -> None:
        self.filter_max_extrema = int(ext)

    def set_filter_grid_size(self, sz: int) -> None:
        self.filter_grid_size = int(sz)

    def set_filter_sorting(self, m) -> None:
        if isinstance(m, str):
            try:
                self.grid_filter_mode = GridFilterMode(m)
            except ValueError:
                raise ValueError(
                    "filter sorting mode must be one of up, down or random"
                ) from None
        else:
            self.grid_filter_mode = GridFilterMode(m)

    def set_norm_mode(self, m) -> None:
        if isinstance(m, str):
            try:
                self.norm_mode = NormMode(m)
            except ValueError:
                raise ValueError(
                    "Bad Normalization mode. Options: RootSift (L1-like, "
                    "default), classic (L2-like)") from None
        else:
            self.norm_mode = NormMode(m)

    def set_use_root_sift(self, on: bool) -> None:
        self.norm_mode = NormMode.ROOT_SIFT if on else NormMode.CLASSIC

    def get_use_root_sift(self) -> bool:
        return self.norm_mode == NormMode.ROOT_SIFT

    def set_normalization_multiplier(self, mul: int) -> None:
        self.norm_multiplier = int(mul)

    def set_print_gauss_tables(self) -> None:
        self.print_gauss_tables = True

    # derived values
    def get_peak_threshold(self) -> float:
        """sift_conf.cu:276-279."""
        return self.threshold * 0.5 * 255.0 / self.levels

    def has_initial_blur(self) -> bool:
        return self.assume_initial_blur

    def get_upscale_factor(self) -> float:
        return self.upscale_factor

    def get_max_extrema(self) -> int:
        return self.max_extrema

    def get_filter_max_extrema(self) -> int:
        return self.filter_max_extrema

    def get_filter_grid_size(self) -> int:
        return self.filter_grid_size

    def get_can_filter_extrema(self) -> bool:
        return True

    def scaled_dims(self, w: int, h: int) -> tuple[int, int]:
        """Octave-0 dimensions after upscaling (popsift.cpp:109-126)."""
        scale_factor = 2.0 ** self.upscale_factor
        return (int(math.ceil(w * scale_factor)),
                int(math.ceil(h * scale_factor)))

    def num_octaves_for(self, w: int, h: int) -> int:
        """Auto octave count (popsift.cpp:118-122): log2(min(w,h))-3+scale,
        clamped to MAX_OCTAVES."""
        if self.octaves >= 0:
            return min(max(self.octaves, 1), MAX_OCTAVES)
        scale_factor = 2.0 ** self.upscale_factor
        oct_ = int(math.floor(math.log(min(w, h)) / math.log(2.0) - 3.0
                              + scale_factor))
        return min(max(oct_, 1), MAX_OCTAVES)

    def static_key(self) -> tuple:
        return (
            self.octaves, self.levels, self.sigma, self.edge_limit,
            self.threshold, self.upscale_factor, self.scaling_mode,
            self.max_extrema, self.gauss_mode, self.sift_mode,
            self.assume_initial_blur, self.initial_blur, self.norm_mode,
            self.norm_multiplier, self.desc_mode, self.filter_max_extrema,
            self.filter_grid_size, self.grid_filter_mode,
            self.ext_capacity, self.ori_capacity, self.desc_transfer,
        )

    def equal(self, other: "Config") -> bool:
        return self.static_key() == other.static_key()

    def __eq__(self, other) -> bool:
        if not isinstance(other, Config):
            return NotImplemented
        return self.equal(other)

    def __hash__(self) -> int:
        return hash(self.static_key())

    def clone(self) -> "Config":
        return dataclasses.replace(self)


def check_supported(config: Config) -> None:
    """Raise, as the JAX package's pyramid does (popsift_tpu/ops/
    pyramid.py:236-240), on a Fixed9/Fixed15 configuration without
    levels + 3 == 6."""
    if (config.gauss_mode in (GaussMode.FIXED9, GaussMode.FIXED15)
            and max(2, config.levels) + 3 != 6):
        raise ValueError(
            "Unsupported number of levels for making all octaves at once")
