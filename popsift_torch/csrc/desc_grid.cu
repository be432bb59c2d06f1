// K9: NoTile/IGrid descriptors from per-slot windows.  One block per
// descriptor row: the rotated 40x40 sample grid, four bilinear samples for
// the rotated gradient, hypotf / atan2f, the desc_gauss weight, the two
// orientation bins, and the contraction with the triangle tile weights
// into 4 x 4 x 8 bins.  K12 (Grid) and K13 (ILoop) read the same windows.
//
// K9 replaces the XLA contraction popsift_tpu/ops/descriptors.py:
// grid_descriptors_windowed_mm (and its gather form
// grid_descriptors_windowed, whose arithmetic it follows): the JAX package
// runs this step as XLA matmuls for the TPU's matrix unit, not as Pallas.
// The reference runs it as a CUDA kernel (s_desc_notile.cu:31-129).
// Window-local coordinates, clamps and evaluation order are those of
// _bilinear_win and grid_descriptors_windowed.
//
// K12 replaces grid_rounded_descriptors_windowed_mm (arithmetic of
// _grid_rounded_body through grid_rounded_descriptors_windowed; reference
// s_desc_grid.cu:18-121): per tile a rotated 16x16 grid, each sample
// rounded to a pixel (rintf: jnp.round rounds half to even), the weights
// recomputed at the rounded pixel, a sample skipped where the triangle
// weight goes negative (s_desc_grid.cu:86), axis-aligned central
// differences from integer taps clipped to the image and then to the
// window, and th -= angle.  K13 replaces iloop_descriptors_windowed_mm
// (_iloop_body through iloop_descriptors_windowed; s_desc_iloop.cu:
// 18-130): per tile an axis-aligned 32x32 grid over the rotated tile's
// bounding box, four bilinear taps per sample (K9's sampler), no angle
// subtraction.
//
// Bound on the H100: device-memory bytes (each block reads its 61,440-byte
// window once; ~170k operations per NoTile row, ~0.4M per Grid row and
// ~2M per ILoop row are below the card's flop/byte balance).  Design: the
// window is copied to dynamic shared memory with 16-byte loads.  K9: each
// thread computes whole samples and stores (bin, low weight, high weight);
// the contraction then runs in a fixed order, first over the 16 columns of
// each x tile (yxb,xt->ytb) and then over the 16 rows of each y tile
// (ytb,ys->stb), one output per thread.  K12 and K13 walk the 16 tiles in
// turn: each thread adds its samples of the tile (one for Grid, four for
// ILoop) into 8 bin registers in a fixed order, and warp b sums bin b over
// the 256 threads in a fixed order (8 sequential adds per lane, then a
// butterfly of shuffles).  No atomics, so every result is the same from
// run to run.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGrid = 40;
constexpr int kSamples = kGrid * kGrid;
constexpr int kWinX = 128;
constexpr int kTiles = 16;
constexpr int kBins = 8;
static_assert(kThreads == 32 * kBins, "tile_bins: one warp per bin");

// Copies row slot's (win_y, 128) window into shared memory, 16 bytes a load.
__device__ __forceinline__ void load_window(float4* win4, const float* wins,
                                            int win_y, int slot) {
    const float4* src = reinterpret_cast<const float4*>(
        wins + static_cast<size_t>(slot) * win_y * kWinX);
    for (int i = threadIdx.x; i < win_y * kWinX / 4; i += kThreads)
        win4[i] = src[i];
}

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

    load_window(win4, wins, win_y, slot);

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


// The 8 bins of one tile: thread t's partial sums acc are reduced over the
// block in a fixed order, and out[tile * 8 + b] is written by warp b.
// part is a [8][kThreads] slice of shared memory that no warp still reads.
__device__ __forceinline__ void tile_bins(const float (&acc)[kBins],
                                          float* part, float* out,
                                          int tile) {
    const int t = threadIdx.x;
#pragma unroll
    for (int b = 0; b < kBins; ++b) part[b * kThreads + t] = acc[b];
    __syncthreads();
    const int warp = t >> 5;
    const int lane = t & 31;
    float v = 0.0f;
#pragma unroll
    for (int k = 0; k < kThreads / 32; ++k)
        v = v + part[warp * kThreads + lane + 32 * k];
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) v = v + __shfl_xor_sync(~0u, v, m);
    if (lane == 0) out[tile * kBins + warp] = v;
}

// One sample's two orientation bins: acc[fo0] += (1 - do0) * wgt and
// acc[(fo0 + 1) % 8] += do0 * wgt, with th already in [0, 2 pi).
__device__ __forceinline__ void add_sample(float (&acc)[kBins], float th,
                                           float wgt) {
    const float tth = th * psk::k4RPi;
    const float fo = floorf(tth);
    const float do0 = tth - fo;
    const int fo0 = min(max(static_cast<int>(fo), 0), 7);
    const int fo1 = (fo0 + 1) & 7;
    const float lo = (1.0f - do0) * wgt;
    const float hi = do0 * wgt;
#pragma unroll
    for (int b = 0; b < kBins; ++b)
        acc[b] = acc[b] + ((b == fo0 ? lo : 0.0f) + (b == fo1 ? hi : 0.0f));
}

__device__ __forceinline__ float wrap_2pi(float th) {
    if (th < 0.0f) th = th + psk::kPi2;
    if (th >= psk::kPi2) th = th - psk::kPi2;
    return th;
}

__global__ void __launch_bounds__(kThreads)
desc_grid_rounded(const float* __restrict__ wins, int win_y,
                  const float* __restrict__ xs, const float* __restrict__ ys,
                  const float* __restrict__ x0s,
                  const float* __restrict__ y0s,
                  const float* __restrict__ sigmas,
                  const float* __restrict__ angs, int W, int H,
                  float* __restrict__ out) {
    extern __shared__ float4 win4[];
    __shared__ float s_part[2][kBins * kThreads];
    const float* win = reinterpret_cast<const float*>(win4);
    const int slot = blockIdx.x;
    const int t = threadIdx.x;
    load_window(win4, wins, win_y, slot);

    const float x = xs[slot];
    const float y = ys[slot];
    const int x0 = static_cast<int>(x0s[slot]);
    const int y0 = static_cast<int>(y0s[slot]);
    const float a = angs[slot];
    const float sbp = fabsf(3.0f * sigmas[slot]);
    const bool ok = sbp > 0.0f;
    const float safe = ok ? sbp : 1.0f;
    const float c = cosf(a);
    const float s = sinf(a);
    const float csbp = c * sbp;
    const float ssbp = s * sbp;
    // this thread's sample of every tile: (xd, yd) = (t % 16, t / 16) on
    // the local grid (k + 0.5) / 8 - 1 (s_desc_grid.cu:69)
    const float u = (static_cast<float>(t & 15) + 0.5f) / 8.0f - 1.0f;
    const float v = (static_cast<float>(t >> 4) + 0.5f) / 8.0f - 1.0f;
    const float pixox = c * u - s * v;
    const float pixoy = c * v + s * u;
    float* dst = out + static_cast<size_t>(slot) * 128;
    __syncthreads();

    auto tap = [&](int yy, int xx) {
        const int xr = min(max(xx - x0, 0), kWinX - 1);
        const int yr = min(max(yy - y0, 0), win_y - 1);
        return win[yr * kWinX + xr];
    };
    for (int tile = 0; tile < kTiles; ++tile) {
        const float ox = static_cast<float>(tile & 3) - 1.5f;
        const float oy = static_cast<float>(tile >> 2) - 1.5f;
        // tile centre, then the sample rounded to a pixel (s_desc_grid.cu:71)
        const float ptx = (csbp * ox - ssbp * oy) + x;
        const float pty = (csbp * oy + ssbp * ox) + y;
        const float px = rintf(ptx + pixox * sbp);
        const float py = rintf(pty + pixoy * sbp);
        // recomputed rotated-local coordinates of the rounded pixel
        const float rx = (px - ptx) / safe;
        const float ry = (py - pty) / safe;
        const float nx = c * rx + s * ry;
        const float ny = c * ry - s * rx;
        const int ix0 = min(max(static_cast<int>(px), 0), W - 1);
        const int iy0 = min(max(static_cast<int>(py), 0), H - 1);
        const float gdx = tap(iy0, min(ix0 + 1, W - 1))
                          - tap(iy0, max(ix0 - 1, 0));
        const float gdy = tap(min(iy0 + 1, H - 1), ix0)
                          - tap(max(iy0 - 1, 0), ix0);
        const float mod = hypotf(gdx, gdy);
        const float th = wrap_2pi(atan2f(gdy, gdx) - a);
        const float dnx = nx + ox;
        const float dny = ny + oy;
        const float ww = expf(-(dnx * dnx + dny * dny) / 8.0f);
        const float wx = 1.0f - fabsf(nx);
        const float wy = 1.0f - fabsf(ny);
        const bool good = wx >= 0.0f && wy >= 0.0f && ok;
        float acc[kBins] = {};
        add_sample(acc, th, good ? ww * wx * wy * mod : 0.0f);
        tile_bins(acc, s_part[tile & 1], dst, tile);
    }
}

__global__ void __launch_bounds__(kThreads)
desc_iloop(const float* __restrict__ wins, int win_y,
           const float* __restrict__ xs, const float* __restrict__ ys,
           const float* __restrict__ x0s, const float* __restrict__ y0s,
           const float* __restrict__ sigmas,
           const float* __restrict__ angs, int W, int H,
           float* __restrict__ out) {
    constexpr int kPer = 1024 / kThreads;  // samples per thread and tile
    extern __shared__ float4 win4[];
    __shared__ float s_part[2][kBins * kThreads];
    const float* win = reinterpret_cast<const float*>(win4);
    const int slot = blockIdx.x;
    const int t = threadIdx.x;
    load_window(win4, wins, win_y, slot);

    const float x = xs[slot];
    const float y = ys[slot];
    const float x0f = x0s[slot];
    const float y0f = y0s[slot];
    const float a = angs[slot];
    const float sbp = fabsf(3.0f * sigmas[slot]);
    const bool ok = sbp > 0.0f;
    const float c = cosf(a);
    const float s = sinf(a);
    const float csbp = c * sbp;
    const float ssbp = s * sbp;
    // image bounds in window-local coordinates (texture clamp addressing)
    const float xlo = 0.0f - x0f;
    const float xhi = static_cast<float>(W - 1) - x0f;
    const float ylo = 0.0f - y0f;
    const float yhi = static_cast<float>(H - 1) - y0f;
    // this thread's samples k = t + 256 j of the 32x32 grid, the same in
    // every tile: offsets -bsz + k bsz / 16 (s_desc_iloop.cu:60-75)
    const float bsz = fabsf(c) + fabsf(s);
    float offx[kPer], offy[kPer], nxs[kPer], nys[kPer];
    bool inside[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
        const int k = t + kThreads * j;
        const float dxg = -bsz + static_cast<float>(k & 31) * bsz / 16.0f;
        const float dyg = -bsz + static_cast<float>(k >> 5) * bsz / 16.0f;
        nxs[j] = c * dxg + s * dyg;
        nys[j] = c * dyg - s * dxg;
        inside[j] = fabsf(nxs[j]) < 1.0f && fabsf(nys[j]) < 1.0f && ok;
        offx[j] = dxg * sbp;
        offy[j] = dyg * sbp;
    }
    float* dst = out + static_cast<size_t>(slot) * 128;
    __syncthreads();

    auto bil = [&](float px, float py) {
        return bilinear(win, win_y, px - x0f, py - y0f, xlo, xhi, ylo, yhi);
    };
    for (int tile = 0; tile < kTiles; ++tile) {
        const float ox = static_cast<float>(tile & 3) - 1.5f;
        const float oy = static_cast<float>(tile >> 2) - 1.5f;
        const float ptx = csbp * ox - ssbp * oy;
        const float pty = csbp * oy + ssbp * ox;
        float acc[kBins] = {};
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
            const float jj = (x + ptx) + offx[j];
            const float ii = (y + pty) + offy[j];
            const float gdx = bil(jj + c, ii + s) - bil(jj - c, ii - s);
            const float gdy = bil(jj - s, ii + c) - bil(jj + s, ii - c);
            const float mod = hypotf(gdx, gdy);
            const float th = wrap_2pi(atan2f(gdy, gdx));
            const float dnx = nxs[j] + ox;
            const float dny = nys[j] + oy;
            const float ww = expf(-(dnx * dnx + dny * dny) / 8.0f);
            add_sample(acc, th,
                       inside[j] ? ww * (1.0f - fabsf(nxs[j]))
                                       * (1.0f - fabsf(nys[j])) * mod
                                 : 0.0f);
        }
        tile_bins(acc, s_part[tile & 1], dst, tile);
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

// Grid (K12) and ILoop (K13): the arguments of psk_desc_grid without the
// two descriptor tables.
PSK_API int psk_desc_grid_rounded(const float* wins, int win_y,
                                  const float* x, const float* y,
                                  const float* x0, const float* y0,
                                  const float* sigma, const float* angle,
                                  int n, int W, int H, float* out,
                                  void* stream) {
    const int smem = win_y * kWinX * static_cast<int>(sizeof(float));
    cudaError_t err = cudaFuncSetAttribute(
        desc_grid_rounded, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    desc_grid_rounded<<<n, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
        wins, win_y, x, y, x0, y0, sigma, angle, W, H, out);
    return psk::status();
}

PSK_API int psk_desc_iloop(const float* wins, int win_y, const float* x,
                           const float* y, const float* x0, const float* y0,
                           const float* sigma, const float* angle, int n,
                           int W, int H, float* out, void* stream) {
    const int smem = win_y * kWinX * static_cast<int>(sizeof(float));
    cudaError_t err = cudaFuncSetAttribute(
        desc_iloop, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    desc_iloop<<<n, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        wins, win_y, x, y, x0, y0, sigma, angle, W, H, out);
    return psk::status();
}
