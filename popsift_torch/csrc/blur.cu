// K1: separable Gaussian blur with clamp addressing, optional x hscale and
// optional DoG output.
//
// Replaces popsift_tpu/kernels/blur.py:sep_blur_fused and
// sep_blur_fused_with_dog (_blur_kernel).  It computes the order of the
// JAX package's XLA form (blur.py:133-137, ops/pyramid.py:blur_1d):
// horizontal taps (centre, then (left + right) * t[off] for rising off),
// then the optional scale, then the vertical taps in the same order.  The
// Pallas kernel runs the vertical pass first and is not the one copied.
//
// Bound on the H100: device-memory bytes.  Each pass does 2 * span flops
// per pixel for 8 bytes of compulsory traffic, far below the card's
// flop/byte balance.  Simple design: one thread per output pixel in two
// passes through a scratch plane (the extra plane write and read costs 2x
// the byte floor); neighbouring threads read neighbouring addresses and
// the taps' re-reads hit L1/L2.  A shared-memory tile that keeps the
// intermediate on chip is the next step.
#include "common.cuh"

namespace {

struct Taps {
    float t[32];
    int span;
};

__global__ void blur_rows(const float* __restrict__ src,
                          float* __restrict__ dst, int H, int W, Taps tp,
                          float hscale) {
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (x >= W || y >= H) return;
    const float* row = src + static_cast<size_t>(y) * W;
    float acc = row[x] * tp.t[0];
    for (int off = 1; off < tp.span; ++off) {
        const float l = row[max(x - off, 0)];
        const float r = row[min(x + off, W - 1)];
        acc = acc + (l + r) * tp.t[off];
    }
    if (hscale != 1.0f) acc = acc * hscale;
    dst[static_cast<size_t>(y) * W + x] = acc;
}

__global__ void blur_cols(const float* __restrict__ tmp,
                          const float* __restrict__ src,
                          float* __restrict__ out, float* __restrict__ dog,
                          int H, int W, Taps tp) {
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (x >= W || y >= H) return;
    const size_t i = static_cast<size_t>(y) * W + x;
    float acc = tmp[i] * tp.t[0];
    for (int off = 1; off < tp.span; ++off) {
        const float u = tmp[static_cast<size_t>(max(y - off, 0)) * W + x];
        const float d = tmp[static_cast<size_t>(min(y + off, H - 1)) * W + x];
        acc = acc + (u + d) * tp.t[off];
    }
    out[i] = acc;
    if (dog != nullptr) dog[i] = acc - src[i];
}

Taps make_taps(const float* taps, int span) {
    Taps tp{};
    tp.span = span < 1 ? 1 : (span > 32 ? 32 : span);
    for (int k = 0; k < tp.span; ++k) tp.t[k] = taps[k];
    return tp;
}

}  // namespace

// out = blur_v(hscale * blur_h(src)); dog (may be null) = out - src.
// taps_h / taps_v are host arrays of at least span_h / span_v floats.
PSK_API int psk_sep_blur(const float* src, float* tmp, float* out,
                         float* dog, int H, int W, const float* taps_h,
                         int span_h, const float* taps_v, int span_v,
                         float hscale, void* stream) {
    const Taps th = make_taps(taps_h, span_h);
    const Taps tv = make_taps(taps_v, span_v);
    const dim3 block(32, 8);
    const dim3 grid((W + 31) / 32, (H + 7) / 8);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    blur_rows<<<grid, block, 0, s>>>(src, tmp, H, W, th, hscale);
    blur_cols<<<grid, block, 0, s>>>(tmp, src, out, dog, H, W, tv);
    return psk::status();
}

PSK_API const char* psk_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
