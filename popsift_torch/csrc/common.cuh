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

// The octaves of one launch of a per-slot kernel (K5, K6, K9-K13).  The
// slots of every octave lie end to end in the launch's arrays: entry i's
// source (gradient field or blurred stack) holds slots first[i] ..
// first[i + 1] - 1, and the last entry's run to the launch's end.  The
// table is a kernel parameter, passed by value: no copy to the card.  It
// holds every octave a Config can ask for (MAX_OCTAVES, sift_conf.h:12), so
// one launch takes a whole image.
constexpr int kMaxOctaves = 20;

struct OctaveTable {
    const float* src[kMaxOctaves];
    int first[kMaxOctaves];
    int L[kMaxOctaves];
    int H[kMaxOctaves];
    int W[kMaxOctaves];
    int n;
};

struct Octave {
    const float* src;
    int L, H, W;
};

// The octave of ``slot``: the last entry whose first slot is at most
// ``slot``.  Every index is a constant after unrolling, so the table stays
// in the parameter bank.
__device__ __forceinline__ Octave octave_of(const OctaveTable& t, int slot) {
    Octave o{t.src[0], t.L[0], t.H[0], t.W[0]};
#pragma unroll
    for (int i = 1; i < kMaxOctaves; ++i)
        if (i < t.n && slot >= t.first[i])
            o = Octave{t.src[i], t.L[i], t.H[i], t.W[i]};
    return o;
}

// The table of a C entry's ``n`` quintuples (source pointer, first slot,
// L, H, W) as int64 in host memory; false when n is outside
// 1..kMaxOctaves.
inline bool octave_table(const long long* entries, int n, OctaveTable& t) {
    if (n < 1 || n > kMaxOctaves) return false;
    t = OctaveTable{};
    t.n = n;
    for (int i = 0; i < n; ++i) {
        const long long* e = entries + 5 * i;
        t.src[i] = reinterpret_cast<const float*>(e[0]);
        t.first[i] = static_cast<int>(e[1]);
        t.L[i] = static_cast<int>(e[2]);
        t.H[i] = static_cast<int>(e[3]);
        t.W[i] = static_cast<int>(e[4]);
    }
    return true;
}

}  // namespace psk
