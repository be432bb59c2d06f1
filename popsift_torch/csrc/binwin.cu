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
// atomics.  Each of the 128 threads of a block owns a private histogram
// column in shared memory (layout [bin][thread], so a thread's updates
// always hit bank thread % 32), accumulates its pixels in a fixed order,
// and after a barrier thread b sums bin b over the 128 columns in a fixed
// rotated order (conflict-free).  The result is the same on every run.
//
// Bound on the H100: the gathered reads (a few KB per keypoint) and the
// per-pixel transcendental work; both are small next to the pyramid.  The
// stack variants read one level instead of two field planes and do K2's
// sqrt and atan2 per visited pixel.  Simple design: one block per keypoint
// slot; the descriptor kernels' 64 KB of private histograms (128 bins x
// 128 threads) limit them to 3 blocks per SM.  Smaller private histograms
// (warp-shared with a fixed-order merge) are the next step.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kOriBins = 36;
constexpr int kDescBins = 128;

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

template <bool kStack>
__global__ void desc_loop(const float* __restrict__ src, int H, int W,
                          int L, const float* __restrict__ xs,
                          const float* __restrict__ ys,
                          const int* __restrict__ lpos,
                          const float* __restrict__ sigmas,
                          const float* __restrict__ angs, int half,
                          float* __restrict__ out) {
    extern __shared__ float hist[];  // [kDescBins][kThreads]
    const int t = threadIdx.x;
    const int slot = blockIdx.x;
    for (int b = 0; b < kDescBins; ++b) hist[b * kThreads + t] = 0.0f;

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
        // |u|_inf < 2.5 => |d| < 2.5 * sqrt(2) * sbp; one pixel of margin,
        // never beyond the static window of the JAX form
        const int R = min(half, static_cast<int>(3.5355339f * sbp) + 2);
        // 1-px interior gate (binwin.py:263)
        const int xlo = max(1, rx - R), xhi = min(W - 2, rx + R);
        const int ylo = max(1, ry - R), yhi = min(H - 2, ry + R);
        const int bw = xhi - xlo + 1, bh = yhi - ylo + 1;
        if (bw > 0 && bh > 0) {
            for (int q = t; q < bw * bh; q += kThreads) {
                const int ii = ylo + q / bw;
                const int jj = xlo + q % bw;
                const float dxf = static_cast<float>(jj) - x;
                const float dyf = static_cast<float>(ii) - y;
                // rotated coordinates in SBP units (s_desc_loop.cu:87-90)
                const float ux = (cos_t * dxf + sin_t * dyf) / sbp;
                const float uy = (cos_t * dyf - sin_t * dxf) / sbp;
                float mag, theta;
                grad.at(ii, jj, mag, theta);
                const float ww = expf(-(ux * ux + uy * uy) / 8.0f);
                const float wgt = mag * ww;
                float th = theta - ang;
                if (th < 0.0f) th = th + psk::kPi2;
                if (th >= psk::kPi2) th = th - psk::kPi2;
                const float tth = th * psk::k4RPi;
                int fo0 = static_cast<int>(floorf(tth));
                const float do0 = tth - static_cast<float>(fo0);
                fo0 = min(max(fo0, 0), 7);
                const int fo1 = fo0 + 1 == 8 ? 0 : fo0 + 1;
                const float lo = wgt * (1.0f - do0);
                const float hi = wgt * do0;
                for (int ty = 0; ty < 4; ++ty) {
                    const float wy = fmaxf(
                        0.0f, 1.0f - fabsf(uy - (static_cast<float>(ty) - 1.5f)));
                    if (wy == 0.0f) continue;
                    for (int tx = 0; tx < 4; ++tx) {
                        const float wx = fmaxf(
                            0.0f,
                            1.0f - fabsf(ux - (static_cast<float>(tx) - 1.5f)));
                        if (wx == 0.0f) continue;
                        float* cell = hist + ((ty * 4 + tx) * 8) * kThreads + t;
                        cell[fo0 * kThreads] += wy * (wx * lo);
                        cell[fo1 * kThreads] += wy * (wx * hi);
                    }
                }
            }
        }
    }
    __syncthreads();
    float s = 0.0f;
    for (int j = 0; j < kThreads; ++j)
        s += hist[t * kThreads + ((j + t) % kThreads)];
    out[static_cast<size_t>(slot) * kDescBins + t] = s;  // [ty][tx][b]
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
    const int smem = kDescBins * kThreads * static_cast<int>(sizeof(float));
    cudaError_t err = cudaFuncSetAttribute(
        desc_loop<kStack>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    desc_loop<kStack><<<n, kThreads, smem,
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
