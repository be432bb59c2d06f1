"""The PopSift host pipeline (popsift_tpu/pipeline.py, popsift.{h,cpp}).

``PopSift.enqueue`` copies the image, queues a :class:`SiftJob` and
returns it at once; worker threads extract the jobs on the pipeline's
device and fulfil each job's future, errors included
(popsift.cpp:306-383).  ExtractingMode runs one worker, which extracts
the jobs in order and downloads the features (``get`` / ``get_host``).
MatchingMode runs ``workers`` of them, as the JAX package runs that many
match-prepare threads; each leaves its job's descriptors on the device
(``get_dev``).  A job takes the stack-kernel path (K10 and K11,
``POPSIFT_TPU_STACK_KERNELS``) as the switch stands when a worker starts
that job, not when it was enqueued.

On a CUDA device each worker makes the pipeline's device current before
its first launch: a new host thread starts on device 0, and the kernels
read the current device (csrc/octave.cu's shared-memory grant).  The
workers share the device's current stream, so tensors need no
``record_stream`` between them; the count readbacks between stages then
also wait for the other workers' work queued before them.  Per-thread
state: refine_compact's pinned status pair (kernels/refine.py).  Process-
wide: the launch counts (kernels/_lib.py) and the compaction budget's
tally (ops/extrema.py), which with several workers are sums over the
images in flight, not counts of one image.

With ``log_mode=ALL`` an ExtractingMode worker writes the job's ``--log``
dump tree into the working directory before it hands out the features
(popsift_tpu/pipeline.py:552-557, :mod:`popsift_torch.debugdump`).

Tracing (:mod:`popsift_torch.tracing`): ``enqueue`` gives each job its
request number (``SiftJob.request``), and with the recorder on
(``POPSIFT_TPU_HOSTTRACE=1`` or ``tracing.enable()``) opens the job's
root span ``job``, which ends when a worker has finished the job, and its
``queue`` span, which ends when a worker takes it.  The worker makes the
job's number its thread's request, so the job's ``upload`` span (the H2D
copy from pageable memory) and every span of its extraction carry it.
``uninit`` prints the host trace's summary.
"""

from __future__ import annotations

import enum
import queue
import sys
import threading
from concurrent.futures import Future

import numpy as np
import torch

from .config import Config, ImageMode, LogMode, ProcessingMode
from .debugdump import dump_all
# Shape preflight (the reference checks texture limits,
# popsift.cpp:168-196; here the octave-0 stack must fit device memory)
from .device import MAX_INPUT_DIM, MAX_OCTAVE0_PIXELS
from .extract import extract_features, normalize_input
from .features import FeaturesBase, FeaturesDev, FeaturesHost
from . import tracing


class AllocTest(enum.Enum):
    """popsift.h:139-147."""

    Ok = 0
    ImageExceedsLinearTextureLimit = 1
    ImageExceedsLayeredSurfaceLimit = 2


class SiftJob:
    """Async extraction job (popsift.h:44-100).  The constructor copies
    the image so the caller's buffer can be reused at once.  A failed job
    holds None and its error: ``get_base`` returns None, ``get_host`` and
    ``get_dev`` raise the error (popsift_tpu/pipeline.py:86-108).
    ``get_img`` is the image the worker uploaded to the pipeline's device
    (SiftJob::setImg): None before the upload and after a failed one.
    ``request`` is the number ``PopSift.enqueue`` gave the job, which its
    host spans carry."""

    def __init__(self, w: int, h: int, image_data: np.ndarray,
                 config: Config) -> None:
        self._w = w
        self._h = h
        self._image_data = np.array(image_data, copy=True).reshape(h, w)
        self._config = config
        self._err: BaseException | None = None
        self._device_image: torch.Tensor | None = None
        self._f: Future = Future()
        self.request: int | None = None
        self._root = self._queued = None    # open host spans

    def set_img(self, device_image: torch.Tensor | None) -> None:
        self._device_image = device_image

    def get_img(self) -> torch.Tensor | None:
        return self._device_image

    def set_features(self, f: FeaturesBase | None) -> None:
        self._f.set_result(f)

    def set_error(self, err: BaseException) -> None:
        self._err = err
        self._f.set_result(None)

    def get(self) -> FeaturesHost | None:
        return self.get_host()

    def get_base(self) -> FeaturesBase | None:
        return self._f.result()

    def get_host(self) -> FeaturesHost | None:
        r = self._f.result()
        if self._err is not None:
            raise self._err
        return r if isinstance(r, FeaturesHost) else None

    def get_dev(self) -> FeaturesDev | None:
        r = self._f.result()
        if self._err is not None:
            raise self._err
        return r if isinstance(r, FeaturesDev) else None


def _device(device) -> torch.device:
    """An int n is ``cuda:n``; "cuda" without an index is the current
    CUDA device, fixed here so that every worker thread uses it."""
    dev = torch.device(f"cuda:{device}" if isinstance(device, int)
                       else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"PopSift(device={device!r}): no CUDA device is available; "
                f"pass device='cpu' to run the plain PyTorch versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"PopSift(device={device!r}): only "
                f"{torch.cuda.device_count()} CUDA device(s)")
    elif dev.type != "cpu":
        raise ValueError(f"PopSift(device={device!r}): a CUDA device or "
                         f"'cpu'")
    return dev


def upload_image(image: np.ndarray, device: torch.device) -> torch.Tensor:
    """The job's image on ``device`` as the JAX pipeline uploads it
    (popsift_tpu/pipeline.py:369-376): bytes as they are, other input
    normalised on the host first."""
    if image.dtype != np.uint8:
        image = normalize_input(image)
    return torch.from_numpy(np.ascontiguousarray(image)).to(device)


class PopSift:
    """The pipeline object (popsift.h:105-317).  ``device`` is where the
    extraction runs: an int n or "cuda:n" (the default "cuda": the current
    CUDA device) needs that CUDA device and raises without it; "cpu" runs
    the kernels' plain PyTorch versions.  ``workers`` is the number of
    MatchingMode worker threads; ExtractingMode runs one.  Extraction is
    bound by the host's PyTorch dispatch, and on an H100 a second worker
    makes a pair of 1080p frames slower, not faster
    (tools/torch_match_workers.py)."""

    ByteImages = ImageMode.BYTE
    FloatImages = ImageMode.FLOAT

    def __init__(self, config: Config | None = None,
                 mode: ProcessingMode = ProcessingMode.EXTRACTING,
                 imode: ImageMode = ImageMode.BYTE,
                 device: int | str = "cuda", workers: int = 1) -> None:
        self._device = _device(device)
        self._proc_mode = ProcessingMode(mode)
        self._image_mode = ImageMode(imode)
        self._config = config.clone() if config is not None else Config()
        self._config.levels = max(2, self._config.levels)
        self._queue: queue.Queue = queue.Queue()
        n = (max(1, int(workers))
             if self._proc_mode == ProcessingMode.MATCHING else 1)
        self._threads = [threading.Thread(target=self._worker_loop,
                                          daemon=True) for _ in range(n)]
        for t in self._threads:
            t.start()
        self._isInit = True

    def configure(self, config: Config, force: bool = False) -> bool:
        """Replace the configuration; jobs already queued keep theirs."""
        self._config = config.clone()
        self._config.levels = max(2, self._config.levels)
        return True

    def apply_configuration(self, force: bool = False) -> bool:
        """applyConfiguration (popsift.cpp:91-107): each job carries its
        configuration and the tables it needs are built per extraction,
        so there is nothing to apply."""
        return True

    def uninit(self) -> None:
        """Finish the queued jobs and join every worker."""
        if not getattr(self, "_isInit", False):
            return
        for _ in self._threads:
            self._queue.put(None)
        for t in self._threads:
            t.join()
        try:
            tracing.host_trace_summary()
        except Exception as e:  # diagnostics must never fail shutdown
            print(f"[warning] host-trace summary failed: {e}",
                  file=sys.stderr)
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
        job.request = tracing.new_request()
        if tracing.HOSTTRACE:
            job._root = tracing.begin_detached("job", job.request)
            job._queued = tracing.begin_detached("queue", job.request,
                                                 job._root)
        self._queue.put(job)
        return job

    # deprecated blocking API (popsift.h:262-278)
    def init(self, w: int, h: int) -> None:
        self._deprecated_dims = (w, h)

    def execute(self, image_data) -> FeaturesBase | None:
        """Extract one image and wait: its features, or None if it is too
        big or its extraction failed (popsift_tpu/pipeline.py:398-404)."""
        w, h = self._deprecated_dims
        job = self.enqueue(w, h, image_data)
        return job.get_base() if job is not None else None

    def _worker_loop(self) -> None:
        if self._device.type == "cuda":
            torch.cuda.set_device(self._device)
        want_dev = self._proc_mode == ProcessingMode.MATCHING
        while True:
            job = self._queue.get()
            if job is None:
                return
            tracing.set_request(job.request, job._root)
            if job._queued is not None:
                tracing.end(job._queued)
            try:
                sp = tracing.begin("upload") if tracing.HOSTTRACE else None
                job.set_img(upload_image(job._image_data, self._device))
                if sp is not None:
                    tracing.end(sp)
                feats = extract_features(job.get_img(), job._config,
                                         self._device, want_dev=want_dev)
                if (not want_dev
                        and job._config.log_mode == LogMode.ALL):
                    dump_all(job._config, job, "pyramid",
                             device=self._device)
            except BaseException as e:  # noqa: BLE001 - reported via the job
                self._job_done(job)
                job.set_error(e)
            else:
                self._job_done(job)
                job.set_features(feats)

    @staticmethod
    def _job_done(job: SiftJob) -> None:
        if job._root is not None:
            tracing.end(job._root)
        tracing.set_request(None)
