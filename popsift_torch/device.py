"""Device introspection, the counterpart of popsift_tpu/device.py and of
popsift::cuda::device_prop_t (common/device_prop.{h,cu}): enumerate the
CUDA devices, pretty-print their properties, select one, and validate
shape limits before allocation."""

from __future__ import annotations

import sys

import torch

# The CUDA limits of the reference were 2D texture limits
# (device_prop.cu:95+); here they are input-shape sanity and the memory
# budget of the octave-0 stack and its derived fields.
MAX_INPUT_DIM = 1 << 15
MAX_OCTAVE0_PIXELS = 1 << 26  # 64 MPix after upscaling


class DeviceProperties:
    """device_prop_t analog over ``torch.cuda``'s devices (none on a
    machine without a CUDA device)."""

    def __init__(self) -> None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        self._props = [torch.cuda.get_device_properties(i) for i in range(n)]
        self._current = torch.cuda.current_device() if n else 0

    def set(self, n: int, print_info: bool = False) -> None:
        """Select device n (device_prop.cu:72-81): it becomes the current
        CUDA device."""
        if n < 0 or n >= len(self._props):
            raise ValueError(
                f"device {n} does not exist "
                f"({len(self._props)} devices available)")
        torch.cuda.set_device(n)
        self._current = n
        if print_info:
            self.print()

    def current(self) -> torch.device:
        return torch.device("cuda", self._current)

    def print(self, file=None) -> None:
        """Pretty-printer (device_prop.cu:40-70)."""
        file = file or sys.stdout
        if not self._props:
            print("no CUDA device", file=file)
        for i, p in enumerate(self._props):
            marker = "*" if i == self._current else " "
            print(f"{marker} device {i}: {p.name} compute capability "
                  f"{p.major}.{p.minor} SMs={p.multi_processor_count} "
                  f"memory={p.total_memory / 2 ** 30:.1f}GiB", file=file)

    # limit validators (checkLimit_* analogs, device_prop.h:58-106)
    def check_limit_input(self, w: int, h: int, warn: bool = True) -> bool:
        ok = w <= MAX_INPUT_DIM and h <= MAX_INPUT_DIM
        if not ok and warn:
            print(f"Input size {w}x{h} exceeds the supported maximum "
                  f"dimension {MAX_INPUT_DIM}", file=sys.stderr)
        return ok

    def check_limit_scaled(self, w: int, h: int, depth: int,
                           warn: bool = True) -> bool:
        ok = w * h <= MAX_OCTAVE0_PIXELS
        if not ok and warn:
            print(f"Scaled octave 0 ({w}x{h}x{depth}) exceeds the "
                  f"device memory budget; increase downsampling",
                  file=sys.stderr)
        return ok
