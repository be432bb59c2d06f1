// K5: 36-bin orientation histogram per extremum, and K6: loop-mode 4x4x8
// descriptor per (extremum, orientation), both read straight from the
// interleaved gradient field [mag_l; theta_l].
//
// Replace popsift_tpu/kernels/binwin.py:ori_hist_fused (_ori_kernel) and
// desc_loop_fused (_desc_kernel).  The Pallas kernels DMA 8/128-aligned
// slabs and roll them to the keypoint; here each block reads the pixels
// of its keypoint's support directly.  The support is exact: the
// orientation disc of radius round(4.5 sigma) (s_orientation.cu:104-162)
// and, for descriptors, the box that covers |u|_inf < 2.5 in rotated
// SBP = 3 sigma units (s_desc_loop.cu:18-139); pixels outside it add
// exactly zero in the JAX form.
//
// Determinism: histogram ties decide num_ori, so there are no float
// atomics.  Each of the 128 threads of a block owns a private histogram
// column in shared memory (layout [bin][thread], so a thread's updates
// always hit bank thread % 32), accumulates its pixels in a fixed order,
// and after a barrier thread b sums bin b over the 128 columns in a fixed
// rotated order (conflict-free).  The result is the same on every run.
//
// Bound on the H100: the gathered field reads (a few KB per keypoint)
// and the per-pixel transcendental work; both are small next to the
// pyramid.  Simple design: one block per keypoint slot; K6's 64 KB of
// private histograms (128 bins x 128 threads) limit it to 3 blocks per
// SM.  Smaller private histograms (warp-shared with a fixed-order
// merge) are the next step.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kOriBins = 36;
constexpr int kDescBins = 128;

__global__ void ori_hist(const float* __restrict__ field, int H, int W,
                         int L, const float* __restrict__ xs,
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
    const int lp = min(max(lpos[slot], 0), L - 1);
    const size_t hw = static_cast<size_t>(H) * W;
    const float* mag = field + (2 * lp) * hw;
    const float* theta = field + (2 * lp + 1) * hw;

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
            const size_t pix = static_cast<size_t>(ii) * W + jj;
            const float wgt = mag[pix] * expf(static_cast<float>(sq) * factor);
            int b = static_cast<int>(
                rintf(36.0f * (theta[pix] + psk::kPi) / psk::kPi2));
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

__global__ void desc_loop(const float* __restrict__ field, int H, int W,
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
    const int lp = min(max(lpos[slot], 0), L - 1);
    const size_t hw = static_cast<size_t>(H) * W;
    const float* mag = field + (2 * lp) * hw;
    const float* theta = field + (2 * lp + 1) * hw;

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
                const size_t pix = static_cast<size_t>(ii) * W + jj;
                const float ww = expf(-(ux * ux + uy * uy) / 8.0f);
                const float wgt = mag[pix] * ww;
                float th = theta[pix] - ang;
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

}  // namespace

// field: (2L, H, W); x, y, sigma: (n,) f32; lpos: (n,) i32; out: (n, 36).
PSK_API int psk_ori_hist(const float* field, int L, int H, int W,
                         const float* x, const float* y, const int* lpos,
                         const float* sigma, int n, float* out,
                         void* stream) {
    ori_hist<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        field, H, W, L, x, y, lpos, sigma, out);
    return psk::status();
}

// angle: (n,) f32; half: half the static descriptor window; out: (n, 128).
PSK_API int psk_desc_loop(const float* field, int L, int H, int W,
                          const float* x, const float* y, const int* lpos,
                          const float* sigma, const float* angle, int n,
                          int half, float* out, void* stream) {
    const int smem = kDescBins * kThreads * static_cast<int>(sizeof(float));
    cudaFuncSetAttribute(desc_loop,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    desc_loop<<<n, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        field, H, W, L, x, y, lpos, sigma, angle, half, out);
    return psk::status();
}
