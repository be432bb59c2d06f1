"""The PopSift host pipeline (popsift_tpu/pipeline.py, popsift.{h,cpp}).

``PopSift.enqueue`` takes the image in, queues a :class:`SiftJob` and
returns it at once; the caller may then reuse its array.  On a CUDA
device it stages the image straight into the job's device tensor, band
by band, through a small ring of page-locked host slots that the
``PopSift`` owns (:class:`StageIn`): the card's DMA of one band runs on a
stream of its own while the host copies the next into another slot, and
a float64 image is cast to float32 band by band.  A 24 MP float
photograph's 96 MB takes 23 bands of 4 MB; a 1080p byte frame takes one.
On the CPU the job keeps a host copy of the image, which its upload
shares.  Worker threads extract the jobs on the pipeline's device and
fulfil each job's future, errors included (popsift.cpp:306-383).
ExtractingMode runs one worker, which extracts the jobs in order and
downloads the features (``get`` / ``get_host``).  MatchingMode runs
``workers`` of them, as the JAX package runs that many match-prepare
threads; each leaves its job's descriptors on the device (``get_dev``).
A job takes the stack-kernel path (K10 and K11,
``POPSIFT_TPU_STACK_KERNELS``) as the switch stands when a worker starts
that job, not when it was enqueued.

On a CUDA device each worker makes the pipeline's device current before
its first launch: a new host thread starts on device 0, and the kernels
read the current device (csrc/octave.cu's shared-memory grant).  The
workers share the device's current stream, so tensors need no
``record_stream`` between them; the count readbacks between stages then
also wait for the other workers' work queued before them.  A staged image
is the exception: it was allocated on the ring's stream, so the worker
makes its stream wait for the job's staging and records its stream on the
tensor before any kernel reads it.  Per-thread state: refine_compact's
pinned status pair (kernels/refine.py).  Process-wide: the launch counts
(kernels/_lib.py) and the compaction budget's tally (ops/extrema.py),
which with several workers are sums over the images in flight, not
counts of one image.

With ``log_mode=ALL`` an ExtractingMode worker writes the job's ``--log``
dump tree into the working directory before it hands out the features
(popsift_tpu/pipeline.py:552-557, :mod:`popsift_torch.debugdump`).

Tracing (:mod:`popsift_torch.tracing`): ``enqueue`` gives each job its
request number (``SiftJob.request``), and with the recorder on
(``POPSIFT_TPU_HOSTTRACE=1`` or ``tracing.enable()``) opens the job's
root span ``job`` first, which ends when a worker has finished the job;
on a CUDA device its ``stage_in`` span over the banded copy on the
caller's thread, with the series ``#stage_in.bands`` (the bands of the
image); and its ``queue`` span, which ends when a worker takes it.  The
worker makes the job's number its thread's request, so the job's
``upload`` span (on a CUDA device the wait for the staging, on the CPU
the image's upload) and every span of its extraction carry it.
``uninit`` prints the host trace's summary.
"""

from __future__ import annotations

import contextlib
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
    """Async extraction job (popsift.h:44-100).  The caller's buffer can
    be reused as soon as the job exists: the constructor copies
    ``image_data`` into the job's host buffer, or, given None, leaves the
    image to ``PopSift.enqueue``, which on a CUDA device stages it onto
    the card before it returns.  A failed job holds None and its error:
    ``get_base`` returns None, ``get_host`` and ``get_dev`` raise the
    error (popsift_tpu/pipeline.py:86-108).  ``get_img`` is the image a
    worker set on the pipeline's device (SiftJob::setImg): None before a
    worker takes the job and after a failed upload or staging.
    ``request`` is the number ``PopSift.enqueue`` gave the job, which its
    host spans carry."""

    def __init__(self, w: int, h: int, image_data: np.ndarray | None,
                 config: Config) -> None:
        self._w = w
        self._h = h
        self._image_data = (None if image_data is None else
                            np.array(image_data, copy=True).reshape(h, w))
        self._config = config
        self._err: BaseException | None = None
        self._device_image: torch.Tensor | None = None
        # StageIn.stage's tensor and event, or the error it raised
        self._staged = self._ready = self._stage_err = None
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


# The stage-in ring: SLOTS host slots of SLOT_BYTES each.  A slot is
# small enough to stay in the host's last-level cache from its fill to
# its DMA, and large enough that a band's fixed cost (one copy_, one
# event record, a few us of Python) is small against its copy; it holds
# at least one row of the widest input, MAX_INPUT_DIM float32 pixels.
SLOT_BYTES = 4 << 20
SLOTS = 3
_TORCH_DTYPES = {np.dtype(np.uint8): torch.uint8,
                 np.dtype(np.float32): torch.float32}


class StageIn:
    """A ring of host slots through which :meth:`stage` copies an image
    onto ``device``, band by band.  On a CUDA device the slots are
    page-locked, each band's copy runs on the ring's own stream and each
    slot's event holds the slot until its DMA has ended, so the host fills
    the next slot while the card takes the last.  On the CPU the same
    code runs with plain slots, no stream and no events.  One caller
    stages at a time."""

    def __init__(self, device: torch.device) -> None:
        self._device = device
        cuda = device.type == "cuda"
        self._slot_bytes = SLOT_BYTES
        self._slots = torch.empty((SLOTS, SLOT_BYTES), dtype=torch.uint8,
                                  pin_memory=cuda)
        self._host = self._slots.numpy()
        self._stream = torch.cuda.Stream(device) if cuda else None
        self._events = ([torch.cuda.Event() for _ in range(SLOTS)]
                        if cuda else None)
        self._views: dict = {}
        self._next = 0
        self._lock = threading.Lock()

    def stage(self, image: np.ndarray, dtype
              ) -> tuple[torch.Tensor, "torch.cuda.Event | None", int]:
        """``image`` (h, w) as ``dtype`` (uint8 or float32, cast as
        ``astype`` casts) in a new tensor on the device.  Returns the
        tensor, on a CUDA device the event recorded on the ring's stream
        after its last band (None on the CPU), and the number of bands.
        Every row has left ``image`` when it returns."""
        dtype = np.dtype(dtype)
        h, w = image.shape
        band = self._slot_bytes // (w * dtype.itemsize)
        cuda = self._stream is not None
        # A worker extracting an earlier image waits for the GIL each time
        # this thread takes it back, after every call that lets it go: a
        # torch op, numpy's copy, an event's wait.  So a band makes two
        # such calls, the copy into its slot and the DMA, and an image one
        # more, its allocation; the stream is entered in one call that
        # keeps the GIL (and sets the device).
        with self._lock, self._stream if cuda else contextlib.nullcontext():
            dst = torch.empty((h, w), dtype=_TORCH_DTYPES[dtype],
                              device=self._device)
            for r0 in range(0, h, band):
                n = min(band, h - r0)
                k = self._next
                self._next = (k + 1) % SLOTS
                if cuda and not self._events[k].query():
                    self._events[k].synchronize()
                host, slot = self._slot(k, dtype, n, w)
                np.copyto(host, image[r0:r0 + n], casting="unsafe")
                dst[r0:r0 + n].copy_(slot, non_blocking=cuda)
                if cuda:
                    self._events[k].record(self._stream)
            ready = None
            if cuda:
                ready = torch.cuda.Event()
                ready.record(self._stream)
        return dst, ready, -(-h // band)

    def _slot(self, k: int, dtype: np.dtype, n: int, w: int
              ) -> tuple[np.ndarray, torch.Tensor]:
        """Slot ``k``'s first ``n`` rows of ``w`` pixels of ``dtype``, as a
        numpy array and a tensor over the same bytes.  The views are kept
        for the shapes of the images staged last, since making a tensor's
        view lets the GIL go."""
        key = (k, dtype, n, w)
        views = self._views.get(key)
        if views is None:
            if len(self._views) >= 4 * SLOTS:
                self._views.clear()
            nbytes = n * w * dtype.itemsize
            views = self._views[key] = (
                self._host[k, :nbytes].view(dtype).reshape(n, w),
                self._slots[k, :nbytes].view(_TORCH_DTYPES[dtype]).view(n, w))
        return views


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
        # on a CUDA device enqueue stages each image onto the card
        self._stage_in = (StageIn(self._device)
                          if self._device.type == "cuda" else None)
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
            if self._stage_in is None:
                # SiftJob copies the image: no second copy of a float32 one
                arr = arr.astype(np.float32, copy=False)
        fit = self.test_texture_fit(w, h)
        if fit != AllocTest.Ok:
            print("Image too large\n"
                  + self.test_texture_fit_error_string(fit, w, h),
                  file=sys.stderr)
            return None
        request = tracing.new_request()
        root = (tracing.begin_detached("job", request)
                if tracing.HOSTTRACE else None)
        if self._stage_in is None:
            job = SiftJob(w, h, arr, self._config)
        else:
            job = SiftJob(w, h, None, self._config)
            self._stage(job, arr.reshape(h, w), request, root)
        job.request, job._root = request, root
        if root is not None:
            job._queued = tracing.begin_detached("queue", request, root)
        self._queue.put(job)
        return job

    def _stage(self, job: SiftJob, image: np.ndarray, request: int,
               root: tuple | None) -> None:
        """Stage ``image`` onto the card for ``job``; a CUDA error is the
        job's, which the worker reports through it."""
        sp = (tracing.begin_detached("stage_in", request, root)
              if root is not None else None)
        dtype = (np.uint8 if self._image_mode == ImageMode.BYTE
                 else np.float32)
        try:
            job._staged, job._ready, bands = self._stage_in.stage(image,
                                                                  dtype)
        except RuntimeError as e:  # a CUDA error, raised by the worker
            job._stage_err = e
            return
        if sp is not None:
            tracing.end(sp)
            tracing.host_trace("stage_in.bands", request, n=bands)

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
                job.set_img(self._take_image(job))
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

    def _take_image(self, job: SiftJob) -> torch.Tensor:
        """The job's image on the device: its upload where it has a host
        copy, else its staged tensor; on a CUDA device once this thread's
        stream waits for the staging and the allocator knows that stream
        reads the tensor."""
        if self._stage_in is None:
            return upload_image(job._image_data, self._device)
        if job._stage_err is not None:
            raise job._stage_err
        img, job._staged = job._staged, None
        if job._ready is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(job._ready)
            img.record_stream(stream)
        return img

    def _job_done(self, job: SiftJob) -> None:
        """Close the job's spans."""
        if job._root is not None:
            tracing.end(job._root)
        tracing.set_request(None)
