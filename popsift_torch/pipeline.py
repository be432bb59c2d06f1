"""The PopSift host pipeline (popsift_tpu/pipeline.py, popsift.{h,cpp}).

``PopSift.enqueue`` copies the image, queues a :class:`SiftJob` and
returns it at once; one worker thread extracts the jobs in order on the
pipeline's device and fulfils each job's future, errors included
(popsift.cpp:306-383).  A job takes the stack-kernel path (K10 and K11,
``POPSIFT_TPU_STACK_KERNELS``) as the switch stands when the worker starts
that job, not when it was enqueued.
"""

from __future__ import annotations

import enum
import queue
import sys
import threading
from concurrent.futures import Future

import numpy as np
import torch

from .config import Config, ImageMode, ProcessingMode
from .extract import extract_features
from .features import FeaturesBase, FeaturesHost

# Shape preflight (the reference checks texture limits,
# popsift.cpp:168-196; here the octave-0 stack must fit device memory)
MAX_INPUT_DIM = 1 << 15
MAX_OCTAVE0_PIXELS = 1 << 26  # 64 MPix after upscaling


class AllocTest(enum.Enum):
    """popsift.h:139-147."""

    Ok = 0
    ImageExceedsLinearTextureLimit = 1
    ImageExceedsLayeredSurfaceLimit = 2


class SiftJob:
    """Async extraction job (popsift.h:44-100).  The constructor copies
    the image so the caller's buffer can be reused at once."""

    def __init__(self, w: int, h: int, image_data: np.ndarray,
                 config: Config) -> None:
        self._w = w
        self._h = h
        self._image_data = np.array(image_data, copy=True).reshape(h, w)
        self._config = config
        self._f: Future = Future()

    def get(self) -> FeaturesHost:
        return self.get_host()

    def get_base(self) -> FeaturesBase:
        return self._f.result()

    def get_host(self) -> FeaturesHost:
        return self._f.result()


class PopSift:
    """The pipeline object (popsift.h:105-317).  ``device`` is where the
    extraction runs: "cuda" (the default) needs a CUDA device and raises
    without one; "cpu" runs the kernels' plain PyTorch versions."""

    ByteImages = ImageMode.BYTE
    FloatImages = ImageMode.FLOAT

    def __init__(self, config: Config | None = None,
                 mode: ProcessingMode = ProcessingMode.EXTRACTING,
                 imode: ImageMode = ImageMode.BYTE,
                 device="cuda") -> None:
        self._device = torch.device(device)
        if self._device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "PopSift(device='cuda'): no CUDA device is available; "
                "pass device='cpu' to run the plain PyTorch versions")
        if ProcessingMode(mode) != ProcessingMode.EXTRACTING:
            raise NotImplementedError(
                "popsift_torch implements ProcessingMode.EXTRACTING only")
        self._image_mode = ImageMode(imode)
        self._config = config.clone() if config is not None else Config()
        self._config.levels = max(2, self._config.levels)
        self._queue: queue.Queue = queue.Queue()
        self._thread = threading.Thread(target=self._extract_loop,
                                        daemon=True)
        self._thread.start()
        self._isInit = True

    def configure(self, config: Config, force: bool = False) -> bool:
        """Replace the configuration; jobs already queued keep theirs."""
        self._config = config.clone()
        self._config.levels = max(2, self._config.levels)
        return True

    def uninit(self) -> None:
        if not getattr(self, "_isInit", False):
            return
        self._queue.put(None)
        self._thread.join()
        self._isInit = False

    def __del__(self) -> None:
        try:
            self.uninit()
        except Exception:  # noqa: BLE001 - interpreter shutdown
            pass

    def __enter__(self) -> "PopSift":
        return self

    def __exit__(self, *exc) -> None:
        self.uninit()

    def test_texture_fit(self, width: int, height: int) -> AllocTest:
        if width > MAX_INPUT_DIM or height > MAX_INPUT_DIM:
            return AllocTest.ImageExceedsLinearTextureLimit
        w, h = self._config.scaled_dims(width, height)
        if w * h > MAX_OCTAVE0_PIXELS:
            return AllocTest.ImageExceedsLayeredSurfaceLimit
        return AllocTest.Ok

    def test_texture_fit_error_string(self, err: AllocTest, width: int,
                                      height: int) -> str:
        if err == AllocTest.Ok:
            return "?    No error.\n"
        if err == AllocTest.ImageExceedsLinearTextureLimit:
            return (f"E    Cannot load unscaled image.\n"
                    f"E    It exceeds the max input size {MAX_INPUT_DIM}.\n"
                    f"E    Got ({width},{height})\n")
        up = self._config.get_upscale_factor()
        return (f"E    Cannot use upscaling factor {up} "
                f"(i.e. scaling by {2.0 ** up}).\n"
                f"E    The first octave would exceed the device memory "
                f"budget.\nE    Increase downsampling to fit.\n")

    def enqueue(self, w: int, h: int, image_data) -> SiftJob | None:
        """Submit an image (popsift.cpp:243-291); None if it is too big."""
        arr = np.asarray(image_data)
        if self._image_mode == ImageMode.BYTE:
            if arr.dtype != np.uint8:
                raise RuntimeError(
                    "Image mode error\nE    Cannot load float images into "
                    "a PopSift pipeline configured for byte images")
        else:
            if arr.dtype == np.uint8:
                raise RuntimeError(
                    "Image mode error\nE    Cannot load byte images into a "
                    "PopSift pipeline configured for float images")
            arr = arr.astype(np.float32)
        fit = self.test_texture_fit(w, h)
        if fit != AllocTest.Ok:
            print("Image too large\n"
                  + self.test_texture_fit_error_string(fit, w, h),
                  file=sys.stderr)
            return None
        job = SiftJob(w, h, arr, self._config)
        self._queue.put(job)
        return job

    # deprecated blocking API (popsift.h:262-278)
    def init(self, w: int, h: int) -> None:
        self._deprecated_dims = (w, h)

    def execute(self, image_data) -> FeaturesBase | None:
        w, h = self._deprecated_dims
        job = self.enqueue(w, h, image_data)
        return job.get_base() if job is not None else None

    def _extract_loop(self) -> None:
        while True:
            job = self._queue.get()
            if job is None:
                return
            try:
                feats = extract_features(job._image_data, job._config,
                                         self._device)
            except Exception as e:  # noqa: BLE001 - reported via the job
                job._f.set_exception(e)
            else:
                job._f.set_result(feats)
