"""Build, load and call the CUDA kernel library.

The kernels live in ``popsift_torch/csrc/*.cu`` behind a plain C
interface.  At first use on a CUDA device they are compiled for Hopper
(``sm_90a``), one ``nvcc`` process per source started together, linked
into one shared library under ``build/popsift_torch/`` and loaded with
``ctypes``.  The library's file name carries a hash of the sources and
flags, so an edited source is rebuilt and an unchanged one is reused.
The build runs under an exclusive lock on a file beside the library
(:func:`_ensure_built`), so ranks that start together on a fresh tree
build it once and the others load what it built.

Each wrapper counts its own launches here (:func:`count`); a run resets
the counts with :func:`reset_launches` and reads them with
:func:`launches`.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "popsift_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC")

KERNELS = ("sep_blur", "grad_field", "detect", "refine", "ori_hist",
           "desc_loop", "octave_chain", "gather_windows", "desc_grid_stack",
           "ori_hist_stack", "desc_loop_stack", "desc_grid_rounded_stack",
           "desc_iloop_stack", "blur_chain")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "psk_sep_blur": [_P, _P, _P, _I, _I, _P, _I, _P, _I, _F, _P],
    "psk_blur_chain": [_P, _P, _P, _I, _I, _I, _P, _P, _P],
    "psk_grad_field": [_P, _P, _I, _I, _I, _P],
    "psk_detect": [_P, _P, _I, _I, _I, _F, _I, _I, _I, _P],
    "psk_refine": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P],
    "psk_refine_compact": [_P, _P, _I, _P, _I, _P, _P, _P],
    "psk_ori_hist": [_P, _I, _I, _I, _P, _P, _P, _P, _I, _P, _P, _P, _P],
    "psk_ori_peaks_of_hist": [_P, _I, _P, _P, _P],
    "psk_desc_loop": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _P, _P],
    "psk_octave_chain": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _I, _I, _I,
                         _I, _P],
    "psk_gather_windows": [_P, _I, _I, _P, _P, _P, _I, _I, _I, _P, _P],
    "psk_desc_grid_stack": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I,
                            _I, _P, _P, _P, _P],
    "psk_ori_hist_stack": [_P, _I, _I, _I, _P, _P, _P, _P, _I, _P, _P, _P,
                           _P],
    "psk_desc_loop_stack": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _P,
                            _P],
    "psk_desc_grid_rounded_stack": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _I,
                                    _I, _I, _I, _P, _P],
    "psk_desc_iloop_stack": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I,
                             _I, _P, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_launches = dict.fromkeys(KERNELS, 0)
build_info: dict = {}


def count(name: str) -> None:
    with _lock:
        _launches[name] += 1


def launches() -> dict:
    with _lock:
        return dict(_launches)


def reset_launches() -> None:
    with _lock:
        for k in _launches:
            _launches[k] = 0


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                       "build popsift_torch's kernels")


def _build(target: Path) -> None:
    nvcc = _nvcc()
    obj_dir = target.parent / (target.stem + ".obj")
    obj_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src in _sources():
        obj = obj_dir / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src),
               "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log = []
    failed = []
    for src, _obj, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name} (rc={proc.returncode})\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    (target.parent / (target.stem + ".log")).write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp = target.with_suffix(f".tmp{os.getpid()}")
    link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
            *[str(obj) for _s, obj, _p in procs]]
    res = subprocess.run(link, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
    os.replace(tmp, target)
    build_info["build_seconds"] = time.perf_counter() - t0


def _ensure_built(target: Path) -> bool:
    """Build ``target`` unless it exists, holding an exclusive lock on
    ``<target>.lock`` from the check to the end of the build: of
    processes that start together one builds, and the others wait and
    find the library.  Returns whether this process built it."""
    target.parent.mkdir(parents=True, exist_ok=True)
    with open(target.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if target.exists():
                return False
            _build(target)
            return True
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _check_device(device: torch.device) -> None:
    cap = torch.cuda.get_device_capability(device)
    if tuple(cap) != (9, 0):
        raise RuntimeError(
            f"popsift_torch's kernels are built for compute capability 9.0 "
            f"(Hopper, sm_90a); {torch.cuda.get_device_name(device)} has "
            f"{cap[0]}.{cap[1]}")


def library(device: torch.device) -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _check_device(device)
            target = BUILD_DIR / f"libpopsift_torch_{_digest()}.so"
            build_info["log_path"] = str(target.with_suffix(".log"))
            if not _ensure_built(target):
                build_info.setdefault("build_seconds", 0.0)
            lib = ctypes.CDLL(str(target))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.psk_error_string.argtypes = [ctypes.c_int]
            lib.psk_error_string.restype = ctypes.c_char_p
            build_info["path"] = str(target)
            _lib = lib
        return _lib


def stream(device: torch.device) -> int:
    """The device's current stream, as the raw pointer PyTorch keeps (the
    public torch.cuda.current_stream(device).cuda_stream builds a Stream
    object, about 10 us on the H100's host)."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def call(name: str, device: torch.device, *args,
         count_as: str | None = None) -> None:
    """Launch C entry ``psk_<name>``, raise on a CUDA error, and count the
    launch under ``count_as`` (``name`` by default)."""
    lib = library(device)
    rc = getattr(lib, "psk_" + name)(*args, stream(device))
    if rc != 0:
        msg = lib.psk_error_string(rc).decode()
        raise RuntimeError(f"popsift_torch kernel {name}: CUDA error "
                           f"{rc} ({msg})")
    count(count_as or name)


def check_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """Common input checks of a kernel wrapper; returns the device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: all tensors must be on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    return dev
