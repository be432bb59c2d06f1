// K9: NoTile/IGrid descriptors from per-slot windows.  One block per
// descriptor row: the rotated 40x40 sample grid, four bilinear samples for
// the rotated gradient, hypotf / atan2f, the desc_gauss weight, the two
// orientation bins, and the contraction with the triangle tile weights
// into 4 x 4 x 8 bins.
//
// Replaces the XLA contraction popsift_tpu/ops/descriptors.py:
// grid_descriptors_windowed_mm (and its gather form
// grid_descriptors_windowed, whose arithmetic it follows): the JAX package
// runs this step as XLA matmuls for the TPU's matrix unit, not as Pallas.
// The reference runs it as a CUDA kernel (s_desc_notile.cu:31-129).
// Window-local coordinates, clamps and evaluation order are those of
// _bilinear_win and grid_descriptors_windowed.
//
// Bound on the H100: device-memory bytes (each block reads its 61,440-byte
// window once; ~170k operations per row are far below the card's
// flop/byte balance).  Design: the window is copied to dynamic shared
// memory with 16-byte loads; each thread computes whole samples and
// stores (bin, low weight, high weight); the contraction then runs in a
// fixed order, first over the 16 columns of each x tile (yxb,xt->ytb) and
// then over the 16 rows of each y tile (ytb,ys->stb), one output per
// thread.  No atomics, so the result is the same from run to run.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGrid = 40;
constexpr int kSamples = kGrid * kGrid;
constexpr int kWinX = 128;

__device__ __forceinline__ float bilinear(const float* win, int win_y,
                                          float px, float py, float xlo,
                                          float xhi, float ylo, float yhi) {
    px = fminf(fmaxf(px, xlo), xhi);
    py = fminf(fmaxf(py, ylo), yhi);
    const float x0f = floorf(px);
    const float y0f = floorf(py);
    const float fx = px - x0f;
    const float fy = py - y0f;
    const int x0 = min(max(static_cast<int>(x0f), 0), kWinX - 2);
    const int y0 = min(max(static_cast<int>(y0f), 0), win_y - 2);
    const float* p = win + y0 * kWinX + x0;
    return (p[0] * (1.0f - fx) + p[1] * fx) * (1.0f - fy)
           + (p[kWinX] * (1.0f - fx) + p[kWinX + 1] * fx) * fy;
}

__global__ void __launch_bounds__(kThreads)
desc_grid(const float* __restrict__ wins, int win_y,
          const float* __restrict__ xs, const float* __restrict__ ys,
          const float* __restrict__ x0s, const float* __restrict__ y0s,
          const float* __restrict__ sigmas, const float* __restrict__ angs,
          int W, int H, const float* __restrict__ gauss,
          const float* __restrict__ tile, float* __restrict__ out) {
    extern __shared__ float4 win4[];
    __shared__ int s_bin[kSamples];
    __shared__ float s_lo[kSamples];
    __shared__ float s_hi[kSamples];
    __shared__ float s_b[kGrid * 32];  // [y][tx][bin]
    const float* win = reinterpret_cast<const float*>(win4);
    const int slot = blockIdx.x;
    const int t = threadIdx.x;

    const float4* src = reinterpret_cast<const float4*>(
        wins + static_cast<size_t>(slot) * win_y * kWinX);
    for (int i = t; i < win_y * kWinX / 4; i += kThreads) win4[i] = src[i];

    const float x = xs[slot];
    const float y = ys[slot];
    const float x0f = x0s[slot];
    const float y0f = y0s[slot];
    const float sbp = fabsf(3.0f * sigmas[slot]);
    const bool ok = sbp > 0.0f;
    const float c = cosf(angs[slot]);
    const float s = sinf(angs[slot]);
    // image bounds in window-local coordinates (texture clamp addressing)
    const float xlo = 0.0f - x0f;
    const float xhi = static_cast<float>(W - 1) - x0f;
    const float ylo = 0.0f - y0f;
    const float yhi = static_cast<float>(H - 1) - y0f;
    __syncthreads();

    for (int k = t; k < kSamples; k += kThreads) {
        const int iy = k / kGrid;
        const int ix = k - iy * kGrid;
        // sample offsets -2.5 + 1/16 + i/8 (s_desc_notile.cu:29,57-58)
        const float sx = -2.4375f + static_cast<float>(ix) * 0.125f;
        const float sy = -2.4375f + static_cast<float>(iy) * 0.125f;
        const float ptx = c * sx - s * sy;
        const float pty = c * sy + s * sx;
        const float pxr = (x + ptx * sbp) - x0f;
        const float pyr = (y + pty * sbp) - y0f;
        const float dx =
            bilinear(win, win_y, pxr + c, pyr + s, xlo, xhi, ylo, yhi)
            - bilinear(win, win_y, pxr - c, pyr - s, xlo, xhi, ylo, yhi);
        const float dy =
            bilinear(win, win_y, pxr - s, pyr + c, xlo, xhi, ylo, yhi)
            - bilinear(win, win_y, pxr + s, pyr - c, xlo, xhi, ylo, yhi);
        const float mod = hypotf(dx, dy);
        float th = atan2f(dy, dx);
        if (th < 0.0f) th = th + psk::kPi2;
        const float tth = th * psk::k4RPi;
        const float fo = floorf(tth);
        const float do0 = tth - fo;
        const float ww = ok ? gauss[k] * mod : 0.0f;
        s_bin[k] = static_cast<int>(fo) & 7;
        s_lo[k] = (1.0f - do0) * ww;
        s_hi[k] = do0 * ww;
    }
    __syncthreads();

    // x tiles: B[y][tx][b] = sum_j A[y][8 tx + j][b] * tile[j]
    for (int k = t; k < kGrid * 32; k += kThreads) {
        const int yy = k >> 5;
        const int tx = (k >> 3) & 3;
        const int b = k & 7;
        float acc = 0.0f;
        for (int j = 0; j < 16; ++j) {
            const int i = yy * kGrid + 8 * tx + j;
            const int b0 = s_bin[i];
            const float a = b0 == b ? s_lo[i]
                                    : (((b0 + 1) & 7) == b ? s_hi[i] : 0.0f);
            acc = acc + a * tile[j];
        }
        s_b[k] = acc;
    }
    __syncthreads();

    // y tiles: D[ty][tx][b] = sum_j B[8 ty + j][tx][b] * tile[j]
    if (t < 128) {
        const int ty = t >> 5;
        const int rest = t & 31;
        float acc = 0.0f;
        for (int j = 0; j < 16; ++j)
            acc = acc + s_b[((8 * ty + j) << 5) + rest] * tile[j];
        out[static_cast<size_t>(slot) * 128 + t] = acc;
    }
}

}  // namespace

// wins: (n, win_y, 128) windows (win_y a multiple of 4); x, y: keypoint
// positions; x0, y0: window origins as floats; sigma, angle: (n,) f32;
// W, H: the octave's size; gauss: (40, 40); tile: (16,); out: (n, 128).
PSK_API int psk_desc_grid(const float* wins, int win_y, const float* x,
                          const float* y, const float* x0, const float* y0,
                          const float* sigma, const float* angle, int n,
                          int W, int H, const float* gauss,
                          const float* tile, float* out, void* stream) {
    const int smem = win_y * kWinX * static_cast<int>(sizeof(float));
    cudaError_t err = cudaFuncSetAttribute(
        desc_grid, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    desc_grid<<<n, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        wins, win_y, x, y, x0, y0, sigma, angle, W, H, gauss, tile, out);
    return psk::status();
}
