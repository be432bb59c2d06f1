// Shared definitions of the popsift_torch CUDA kernels.
//
// Every kernel file exports plain C entry points (PSK_API) that launch on
// the stream they are given and return cudaGetLastError(), so a launch
// the CUDA runtime refuses is reported by the Python wrapper at the call
// site.  The library is built with --fmad=false and without
// --use_fast_math: each multiply and add rounds on its own, as in the
// element-wise PyTorch versions the kernels are checked against.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define PSK_API extern "C" __attribute__((visibility("default")))

namespace psk {

constexpr float kPi = 3.14159265358979323846f;      // f32(pi)
constexpr float kPi2 = 6.28318530717958647692f;     // f32(2 pi)
constexpr float k4RPi = 1.27323954473516268615f;    // f32(4 / pi)

inline int status() { return static_cast<int>(cudaGetLastError()); }

inline int blocks_for(long long n, int threads) {
    return static_cast<int>((n + threads - 1) / threads);
}

}  // namespace psk
