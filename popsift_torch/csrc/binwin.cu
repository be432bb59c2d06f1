// K5 / K10: 36-bin orientation histogram per extremum, and K6 / K11:
// loop-mode 4x4x8 descriptor per (extremum, orientation).  K5 and K6 read
// each pixel's gradient from the interleaved field [mag_l; theta_l]; K10
// and K11 compute it from the blurred level itself, as the reference does
// (s_gradiant.h:55-69).  The binning is one template, instantiated on
// where the gradient comes from, so the four kernels share it.
//
// Replace popsift_tpu/kernels/binwin.py:ori_hist_fused (_ori_kernel),
// desc_loop_fused (_desc_kernel), ori_hist_stack_pallas
// (_ori_stack_kernel) and desc_loop_stack_pallas (_desc_stack_kernel).
// The Pallas kernels DMA 8/128-aligned slabs and roll them to the
// keypoint; the stack variants also need a polynomial atan2 and take only
// octaves of at least 384 columns.  Here each block reads the pixels of
// its keypoint's support directly, at every octave.  The support is
// exact: the orientation disc of radius round(4.5 sigma)
// (s_orientation.cu:104-162) and, for descriptors, the box that covers
// |u|_inf < 2.5 in rotated SBP = 3 sigma units (s_desc_loop.cu:18-139);
// pixels outside it add exactly zero in the JAX form.  Both supports lie
// in the 1-pixel interior, so the central differences of K10 and K11
// never leave the level; they are K2's expressions (grad.cu:26-30), and
// with --fmad=false K10 and K11 are bit-equal to K5 and K6 run on K2's
// field of the same stack.
//
// Determinism: histogram ties decide num_ori, so there are no float
// atomics, and every sum is taken in a fixed order: the result is the
// same on every run.  K5/K10: one block of 128 threads per keypoint, each
// thread owning a column of a [36 bins][128] shared histogram, summed per
// bin in a fixed rotated order (conflict-free).  K6/K11: see desc_loop.
//
// Bound on the H100: the gathered reads (a few KB per keypoint) and the
// per-pixel transcendental work; both are small next to the pyramid.  The
// stack variants read one level instead of two field planes and do K2's
// sqrt and atan2 per visited pixel.  What holds K6/K11 back is instruction
// throughput: a rotation, an exp and the binning for each pixel of each tile
// that reaches it.  desc_loop turns the scatter into a gather: one warp
// per tile of the 4 x 4 grid visits only the pixels of its tile's rotated
// square, with its lanes busy whatever the rows' lengths, and owns that
// tile's bins, so a row needs no 128-bin histogram per thread; the price
// is that a pixel near a tile border is visited by each tile it reaches
// (K11 takes its gradient each time).
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kOriBins = 36;
constexpr int kDescBins = 128;
constexpr int kDescWarps = 16;  // a descriptor row's warps, one per tile
constexpr int kReads = 2;       // pixels a descriptor lane reads at once

// A pixel's gradient magnitude and angle at level lp.  kStack = false:
// read from the (2L, H, W) field; true: central differences of the
// (L, H, W) stack, for interior pixels only.
template <bool kStack>
struct Gradient {
    const float* mag;    // the field's mag_l, or the stack's level l
    const float* theta;  // the field's theta_l (unused for the stack)
    int W;

    __device__ Gradient(const float* src, int lp, int H, int W_) : W(W_) {
        const size_t hw = static_cast<size_t>(H) * W_;
        if (kStack) {
            mag = src + lp * hw;
            theta = nullptr;
        } else {
            mag = src + (2 * lp) * hw;
            theta = src + (2 * lp + 1) * hw;
        }
    }

    __device__ __forceinline__ void at(int ii, int jj, float& m,
                                       float& t) const {
        const size_t pix = static_cast<size_t>(ii) * W + jj;
        if (kStack) {
            const float dx = mag[pix + 1] - mag[pix - 1];
            const float dy = mag[pix + W] - mag[pix - W];
            m = sqrtf(dx * dx + dy * dy);
            t = atan2f(dy, dx);
        } else {
            m = mag[pix];
            t = theta[pix];
        }
    }
};

template <bool kStack>
__global__ void ori_hist(const float* __restrict__ src, int H, int W, int L,
                         const float* __restrict__ xs,
                         const float* __restrict__ ys,
                         const int* __restrict__ lpos,
                         const float* __restrict__ sigmas,
                         float* __restrict__ out) {
    __shared__ float hist[kOriBins * kThreads];
    const int t = threadIdx.x;
    const int slot = blockIdx.x;
    for (int b = 0; b < kOriBins; ++b) hist[b * kThreads + t] = 0.0f;

    const float x = xs[slot];
    const float y = ys[slot];
    const float sigma = sigmas[slot];
    const int rx = static_cast<int>(rintf(x));
    const int ry = static_cast<int>(rintf(y));
    const int rad = static_cast<int>(rintf(3.0f * (1.5f * sigma)));
    const Gradient<kStack> grad(src, min(max(lpos[slot], 0), L - 1), H, W);

    // xmin/xmax/ymin/ymax gates (s_orientation.cu:114-117)
    const int xmin = max(1, rx - rad), xmax = min(W - 2, rx + rad);
    const int ymin = max(1, ry - rad), ymax = min(H - 2, ry + rad);
    const int bw = xmax - xmin + 1, bh = ymax - ymin + 1;
    const float sigw = 1.5f * sigma;
    const float factor = -0.5f / (sigw * sigw);
    if (bw > 0 && bh > 0) {
        for (int q = t; q < bw * bh; q += kThreads) {
            const int ii = ymin + q / bw;
            const int jj = xmin + q % bw;
            const float dxf = static_cast<float>(jj) - x;
            const float dyf = static_cast<float>(ii) - y;
            // int truncation of the squared distance (s_orientation.cu:142)
            const int sq = static_cast<int>(dxf * dxf + dyf * dyf);
            if (sq > rad * rad) continue;
            float mag, theta;
            grad.at(ii, jj, mag, theta);
            const float wgt = mag * expf(static_cast<float>(sq) * factor);
            int b = static_cast<int>(
                rintf(36.0f * (theta + psk::kPi) / psk::kPi2));
            if (b == kOriBins) b = 0;
            if (b < 0 || b >= kOriBins) continue;
            hist[b * kThreads + t] += wgt;
        }
    }
    __syncthreads();
    if (t < kOriBins) {
        float s = 0.0f;
        for (int j = 0; j < kThreads; ++j)
            s += hist[t * kThreads + ((j + t) % kThreads)];
        out[static_cast<size_t>(slot) * kOriBins + t] = s;
    }
}

// The pixel offsets dx from the keypoint's column, on one row, for which
// k dx lies in (p, q), widened by a pixel each side, intersected into
// [a, b]; an empty set makes b < a - 2.
__device__ __forceinline__ void clip_offsets(float k, float p, float q,
                                             float& a, float& b) {
    if (fabsf(k) >= 1e-3f) {
        const float u = p / k, v = q / k;
        a = fmaxf(a, fminf(u, v) - 1.0f);
        b = fminf(b, fmaxf(u, v) + 1.0f);
    } else if (!(p < 0.1f && q > -0.1f)) {
        // |k dx| < 0.1 on the box: no pixel of the row satisfies it
        b = a - 4.0f;
    }
}

// One block of 16 warps per descriptor row, warp w on tile w of the 4 x 4
// grid (ty = w / 4, tx = w % 4).  A warp walks its tile's support: on each
// row, the columns where the tile's square |u - c|_inf < 1 can hold (the
// interval the rotation gives, widened by a pixel), inside the box of the
// square rotated into the image and the descriptor's box.  It takes the
// rows 32 at a time, lane r finding row r's interval, and lays their
// pixels end to end, lane i taking pixels i, i + 32, ..., so the lanes stay
// busy whatever the rows' lengths.  A lane skips a pixel with wx == 0 or
// wy == 0 before it reads its gradient, and reads the gradients of kReads
// pixels before it bins any, so that the reads overlap.  Each lane adds its
// pixels' two bins into its own column of eight bins in shared memory, in
// a fixed order; the warp then sums the columns with a shuffle butterfly,
// which gives every lane the same bits, and lane b writes bin b.
template <bool kStack>
__global__ void __launch_bounds__(32 * kDescWarps)
desc_loop(const float* __restrict__ src, int H, int W, int L,
          const float* __restrict__ xs, const float* __restrict__ ys,
          const int* __restrict__ lpos, const float* __restrict__ sigmas,
          const float* __restrict__ angs, int half,
          float* __restrict__ out) {
    // per warp: each row's first column and the running end of the rows'
    // pixels laid end to end; per thread: its column of the tile's 8 bins
    __shared__ int s_lo[kDescWarps][32];
    __shared__ int s_end[kDescWarps][32];
    __shared__ float s_bins[8][32 * kDescWarps];
    const int slot = blockIdx.x;
    const int tile = threadIdx.x / 32;  // ty * 4 + tx
    const int lane = threadIdx.x % 32;
    const float cy = static_cast<float>(tile / 4) - 1.5f;
    const float cx = static_cast<float>(tile % 4) - 1.5f;
    float* bins = &s_bins[0][threadIdx.x];
#pragma unroll
    for (int b = 0; b < 8; ++b) bins[32 * kDescWarps * b] = 0.0f;

    const float x = xs[slot];
    const float y = ys[slot];
    const float ang = angs[slot];
    const float sbp = fabsf(3.0f * sigmas[slot]);  // DESC_MAGNIFY * sigma
    const int rx = static_cast<int>(rintf(x));
    const int ry = static_cast<int>(rintf(y));
    const Gradient<kStack> grad(src, min(max(lpos[slot], 0), L - 1), H, W);

    if (sbp > 0.0f) {
        const float cos_t = cosf(ang);
        const float sin_t = sinf(ang);
        const float rsbp = 1.0f / sbp;
        // |u|_inf < 2.5 => |d| < 2.5 * sqrt(2) * sbp; one pixel of margin,
        // never beyond the static window of the JAX form
        const int R = min(half, static_cast<int>(3.5355339f * sbp) + 2);
        // the tile's square in the image: centre and half extent, with a
        // pixel of margin
        const float ccx = x + sbp * (cos_t * cx - sin_t * cy);
        const float ccy = y + sbp * (sin_t * cx + cos_t * cy);
        const float ext = sbp * (fabsf(cos_t) + fabsf(sin_t)) + 1.0f;
        // 1-px interior gate (binwin.py:263) and the descriptor's box
        const int xlo =
            max(max(1, rx - R), static_cast<int>(floorf(ccx - ext)));
        const int xhi =
            min(min(W - 2, rx + R), static_cast<int>(ceilf(ccx + ext)));
        const int ylo =
            max(max(1, ry - R), static_cast<int>(floorf(ccy - ext)));
        const int yhi =
            min(min(H - 2, ry + R), static_cast<int>(ceilf(ccy + ext)));
        int* lo_of = s_lo[tile];
        int* end_of = s_end[tile];
        for (int r0 = ylo; r0 <= yhi; r0 += 32) {
            // lane r: row r0 + r.  ux = (c dx + s dy) / sbp within 1 of cx,
            // uy = (c dy - s dx) / sbp within 1 of cy
            const float dyr = static_cast<float>(r0 + lane) - y;
            float a = static_cast<float>(xlo) - x - 1.0f;
            float b = static_cast<float>(xhi) - x + 1.0f;
            clip_offsets(cos_t, sbp * (cx - 1.0f) - sin_t * dyr,
                         sbp * (cx + 1.0f) - sin_t * dyr, a, b);
            clip_offsets(-sin_t, sbp * (cy - 1.0f) - cos_t * dyr,
                         sbp * (cy + 1.0f) - cos_t * dyr, a, b);
            const int lo = max(xlo, static_cast<int>(floorf(x + a)));
            const int hi = min(xhi, static_cast<int>(ceilf(x + b)));
            int end = r0 + lane <= yhi && hi >= lo ? hi - lo + 1 : 0;
#pragma unroll
            for (int off = 1; off < 32; off *= 2) {
                const int t = __shfl_up_sync(0xffffffffu, end, off);
                if (lane >= off) end += t;
            }
            lo_of[lane] = lo;
            end_of[lane] = end;
            __syncwarp();
            const int total = end_of[31];
            int r = 0;
            for (int k0 = 0; k0 < total; k0 += 32 * kReads) {
                float ux[kReads], uy[kReads], wx[kReads], wy[kReads];
                float mag[kReads], theta[kReads];
                bool use[kReads];
#pragma unroll
                for (int u = 0; u < kReads; ++u) {
                    const int k = k0 + 32 * u + lane;
                    use[u] = k < total;
                    if (!use[u]) continue;
                    while (end_of[r] <= k) ++r;
                    const int ii = r0 + r;
                    const int jj = lo_of[r] + k - (r > 0 ? end_of[r - 1] : 0);
                    const float dxf = static_cast<float>(jj) - x;
                    const float dyf = static_cast<float>(ii) - y;
                    // rotated coordinates in SBP units (s_desc_loop.cu:87-90),
                    // times the reciprocal (the plain version divides: the
                    // two differ in the last bit)
                    ux[u] = (cos_t * dxf + sin_t * dyf) * rsbp;
                    uy[u] = (cos_t * dyf - sin_t * dxf) * rsbp;
                    wy[u] = fmaxf(0.0f, 1.0f - fabsf(uy[u] - cy));
                    wx[u] = fmaxf(0.0f, 1.0f - fabsf(ux[u] - cx));
                    use[u] = wy[u] != 0.0f && wx[u] != 0.0f;
                    if (use[u]) grad.at(ii, jj, mag[u], theta[u]);
                }
#pragma unroll
                for (int u = 0; u < kReads; ++u) {
                    if (!use[u]) continue;
                    const float ww =
                        expf(-(ux[u] * ux[u] + uy[u] * uy[u]) / 8.0f);
                    const float wgt = mag[u] * ww;
                    float th = theta[u] - ang;
                    if (th < 0.0f) th = th + psk::kPi2;
                    if (th >= psk::kPi2) th = th - psk::kPi2;
                    const float tth = th * psk::k4RPi;
                    int fo0 = static_cast<int>(floorf(tth));
                    const float do0 = tth - static_cast<float>(fo0);
                    fo0 = min(max(fo0, 0), 7);
                    const int fo1 = fo0 + 1 == 8 ? 0 : fo0 + 1;
                    const float lo_w = wy[u] * (wx[u] * (wgt * (1.0f - do0)));
                    const float hi_w = wy[u] * (wx[u] * (wgt * do0));
                    bins[32 * kDescWarps * fo0] += lo_w;
                    bins[32 * kDescWarps * fo1] += hi_w;
                }
            }
            // the next rows' intervals overwrite this warp's tables
            __syncwarp();
        }
    }
    float acc[8];
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[b] = bins[32 * kDescWarps * b];
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
#pragma unroll
        for (int b = 0; b < 8; ++b)
            acc[b] += __shfl_xor_sync(0xffffffffu, acc[b], off);
    if (lane < 8) {
        float v = acc[0];
#pragma unroll
        for (int b = 1; b < 8; ++b)
            if (lane == b) v = acc[b];
        out[static_cast<size_t>(slot) * kDescBins + tile * 8 + lane] = v;
    }
}

template <bool kStack>
int launch_ori_hist(const float* src, int L, int H, int W, const float* x,
                    const float* y, const int* lpos, const float* sigma,
                    int n, float* out, void* stream) {
    ori_hist<kStack><<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        src, H, W, L, x, y, lpos, sigma, out);
    return psk::status();
}

template <bool kStack>
int launch_desc_loop(const float* src, int L, int H, int W, const float* x,
                     const float* y, const int* lpos, const float* sigma,
                     const float* angle, int n, int half, float* out,
                     void* stream) {
    desc_loop<kStack><<<n, 32 * kDescWarps, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        src, H, W, L, x, y, lpos, sigma, angle, half, out);
    return psk::status();
}

}  // namespace

// field: (2L, H, W); x, y, sigma: (n,) f32; lpos: (n,) i32; out: (n, 36).
PSK_API int psk_ori_hist(const float* field, int L, int H, int W,
                         const float* x, const float* y, const int* lpos,
                         const float* sigma, int n, float* out,
                         void* stream) {
    return launch_ori_hist<false>(field, L, H, W, x, y, lpos, sigma, n, out,
                                  stream);
}

// stack: (L, H, W); the rest as psk_ori_hist.
PSK_API int psk_ori_hist_stack(const float* stack, int L, int H, int W,
                               const float* x, const float* y,
                               const int* lpos, const float* sigma, int n,
                               float* out, void* stream) {
    return launch_ori_hist<true>(stack, L, H, W, x, y, lpos, sigma, n, out,
                                 stream);
}

// angle: (n,) f32; half: half the static descriptor window; out: (n, 128).
PSK_API int psk_desc_loop(const float* field, int L, int H, int W,
                          const float* x, const float* y, const int* lpos,
                          const float* sigma, const float* angle, int n,
                          int half, float* out, void* stream) {
    return launch_desc_loop<false>(field, L, H, W, x, y, lpos, sigma, angle,
                                   n, half, out, stream);
}

// stack: (L, H, W); the rest as psk_desc_loop.
PSK_API int psk_desc_loop_stack(const float* stack, int L, int H, int W,
                                const float* x, const float* y,
                                const int* lpos, const float* sigma,
                                const float* angle, int n, int half,
                                float* out, void* stream) {
    return launch_desc_loop<true>(stack, L, H, W, x, y, lpos, sigma, angle,
                                  n, half, out, stream);
}

