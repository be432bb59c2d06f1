// K9: NoTile/IGrid descriptors, K12: Grid and K13: ILoop descriptors, each
// of a row read straight from the octave's blurred stack.  One block per
// descriptor row.
//
// K9 replaces the XLA contraction popsift_tpu/ops/descriptors.py:
// grid_descriptors_windowed_mm (and its gather form
// grid_descriptors_windowed, whose arithmetic it follows): the JAX package
// runs this step as XLA matmuls for the TPU's matrix unit, not as Pallas.
// The reference runs it as a CUDA kernel (s_desc_notile.cu:31-129): the
// rotated 40x40 sample grid, four bilinear samples for the rotated
// gradient, hypotf / atan2f, the desc_gauss weight, the two orientation
// bins, and the contraction with the triangle tile weights into 4 x 4 x 8
// bins.  Window-local coordinates, clamps and evaluation order are those of
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
// subtraction.  All three read the octave's (L, H, W) stack through K8's
// exact-origin window of the row (column x0 = round(x) - win/2, rows from
// ya = 8 floor((round(y) - win/2) / 8), win_y x 128, clamp addressing)
// without writing it: window pixel (r, c) is
// plane[clamp(ya + r)][clamp(x0 + c)], and every index, clamp and
// coordinate stays in window-local terms, so the values are those of K8
// followed by the window forms.
//
// Bound on the H100: operations (~0.16M a NoTile row, ~0.25M a Grid row
// and ~1.5M an ILoop row against the few KB of stack pixels a row's
// samples reach, most of them shared with neighbouring rows in L2); in
// practice instruction issue.
//
// Common design: one block of 8 warps per row.  The block stages only the
// row's footprint, the box of +-(ceil(2.5 bsz sbp + 2) + 1) px around the
// keypoint in window-local terms (bsz = |cos| + |sin|), clamped to the
// window: the ILoop samples reach 2.5 bsz sbp (Grid and NoTile 2.4375 bsz
// sbp) and the taps one more pixel, and the last pixel is slack for
// cosf / sinf against torch's (kernels/desc_grid.py:footprint_box is the
// same formula without it, and the CPU tests show that every tap lies
// inside).  The box goes to dynamic shared memory, four loads in flight
// per lane; a row whose box holds more pixels than the launch's capacity
// reads its taps from the stack through L2 in the same kernel (a
// block-uniform branch).  Tap indices are clamped to the box, which equals
// the window-local clamps whenever the box covers the taps and keeps every
// read inside it; on a row whose box lies inside the image, the clamps of
// the sample coordinates to the image change nothing and are left out
// (K9, K13).  No atomics: every result is the same from run to run.
//
// Design of K9: warp w computes the samples of grid rows 5 w .. 5 w + 4
// and keeps them, as (bin, low weight, high weight), in its own 1.8 KB of
// shared memory; 20 of its lanes then walk the x tiles of those rows
// (lane (row, tx): j = 0..15 in order, adding each sample's two non-zero
// terms to its two bins; the zeros that the window form adds to the six
// other bins are +0.0 on sums of non-negative terms).  One block barrier after the
// staging and one before the y tiles (128 sums of 16 in the order
// j = 0..15, one a thread: the order of the sums leaves nothing to split);
// a row of zero scale writes zeros without staging.  The values and the
// order of every sum are those of K8's window followed by the window
// form's kernel, bit for bit.
//
// Design of K12 and K13: K13 first compacts the samples of its 32x32 grid
// that carry weight (|nx| < 1, |ny| < 1: the set depends on the angle
// alone) into a shared table in ascending order, each entry its offsets
// times sbp and (nx, ny) (a ballot per 32 samples and a prefix of the
// counts); the others add exactly +0.0 to sums of non-negative terms, so
// skipping them changes no bit.  K12 keeps its 256 rotated grid offsets
// times sbp in a table too (they are the same in every tile) and skips a
// point whose triangle weight is negative before its taps.  Each warp
// owns whole tiles (2 of the 16): its lanes walk the tile's samples (the
// table, or the 256 points) in a fixed order, each adding to its two bins
// in its own column of shared memory, and the tile's bins are summed over
// the lanes by fixed shuffle butterflies, so no block barrier is paid per
// tile.
// The kernels are bound by instruction issue (about 300 instructions a
// K13 sample in the sm_90a SASS at --fmad=false: four bilinear taps,
// hypotf, atan2f, expf, two bins); registers are capped for three blocks
// an SM.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// three blocks of a row each on an SM (at most 85 registers)
constexpr int kMinBlocks = 3;
constexpr int kGrid = 40;
constexpr int kWinX = 128;
constexpr int kTiles = 16;
constexpr int kBins = 8;

__device__ __forceinline__ float wrap_2pi(float th) {
    if (th < 0.0f) th = th + psk::kPi2;
    if (th >= psk::kPi2) th = th - psk::kPi2;
    return th;
}

// A lane's 8 bins of the tile it walks live in shared memory, [warp][bin]
// [lane] (bank = lane), so a sample adds to its two bins without selects.
__device__ __forceinline__ void bins_zero(float* bins) {
#pragma unroll
    for (int b = 0; b < kBins; ++b) bins[b * 32] = 0.0f;
}

// One sample's two orientation bins: bin fo0 += (1 - do0) * wgt and bin
// (fo0 + 1) % 8 += do0 * wgt, with th already in [0, 2 pi).
__device__ __forceinline__ void bins_add(float* bins, float th, float wgt) {
    const float tth = th * psk::k4RPi;
    const float fo = floorf(tth);
    const float do0 = tth - fo;
    const int fo0 = min(max(static_cast<int>(fo), 0), 7);
    const int fo1 = (fo0 + 1) & 7;
    bins[fo0 * 32] = bins[fo0 * 32] + (1.0f - do0) * wgt;
    bins[fo1 * 32] = bins[fo1 * 32] + do0 * wgt;
}

// The tile's 8 bins, summed over the warp's lanes by a butterfly of
// shuffles per bin (a fixed order), written by lanes 0-7.
__device__ __forceinline__ void bins_out(const float* bins, float* out,
                                         int tile) {
    const int lane = threadIdx.x & 31;
    float mine = 0.0f;
#pragma unroll
    for (int b = 0; b < kBins; ++b) {
        float v = bins[b * 32];
#pragma unroll
        for (int m = 16; m > 0; m >>= 1) v = v + __shfl_xor_sync(~0u, v, m);
        if (lane == b) mine = v;
    }
    if (lane < kBins) out[tile * kBins + lane] = mine;
}

// A row of K9/K12/K13: its plane, K8's window origin (x0, ya) in the plane,
// the footprint box [bx0, bx1] x [by0, by1] in window-local pixels, and
// whether the unclamped box lies inside the image (then no sample
// coordinate reaches the image bounds and their clamps change nothing).
struct RowWindow {
    const float* plane;
    int H, W;
    int x0, ya;
    int bx0, bx1, by0, by1;
    int bw;
    bool interior;
};

// K8's window of the row and the row's footprint box (the formula of
// kernels/desc_grid.py:footprint_box, one pixel wider on each side).
__device__ __forceinline__ RowWindow row_window(
        const float* stack, int L, int H, int W, int lpos, float x, float y,
        float sbp, float bsz, int win, int win_y) {
    RowWindow r;
    const int lp = min(max(lpos, 0), L - 1);
    r.plane = stack + static_cast<size_t>(lp) * H * W;
    r.H = H;
    r.W = W;
    r.x0 = static_cast<int>(rintf(x)) - win / 2;
    const int y0 = static_cast<int>(rintf(y)) - win / 2;
    r.ya = y0 - (((y0 % 8) + 8) % 8);
    const int half =
        static_cast<int>(fminf(ceilf(2.5f * bsz * sbp + 2.0f), 256.0f)) + 1;
    const int fx = static_cast<int>(floorf(x - static_cast<float>(r.x0)));
    const int fy = static_cast<int>(floorf(y - static_cast<float>(r.ya)));
    r.bx0 = max(fx - half, 0);
    r.bx1 = min(fx + half, kWinX - 1);
    r.by0 = max(fy - half, 0);
    r.by1 = min(fy + half, win_y - 1);
    r.bw = r.bx1 - r.bx0 + 1;
    r.interior = r.x0 + fx - half >= 0 && r.x0 + fx + half <= W - 1
                 && r.ya + fy - half >= 0 && r.ya + fy + half <= H - 1;
    return r;
}

// Copies the row's box of K8's window into shared memory: warp w takes
// box rows w, w + 8, ...; each lane holds up to four loads of a row in
// flight (x0 has no alignment, so 4-byte loads).
__device__ __forceinline__ void stage_box(float* box, const RowWindow& r) {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int bh = r.by1 - r.by0 + 1;
#pragma unroll 2
    for (int i = warp; i < bh; i += kWarps) {
        const int yy = min(max(r.ya + r.by0 + i, 0), r.H - 1);
        const float* src = r.plane + static_cast<size_t>(yy) * r.W;
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int c = lane + 32 * j;
            v[j] = c < r.bw ? __ldg(src + min(max(r.x0 + r.bx0 + c, 0),
                                              r.W - 1))
                            : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int c = lane + 32 * j;
            if (c < r.bw) box[i * r.bw + c] = v[j];
        }
    }
}

// Window pixel (yr, xr), both window-local and inside the box: from the
// staged box, or from the plane with K8's clamp addressing.
template <bool kStaged>
__device__ __forceinline__ float window_px(const RowWindow& r,
                                           const float* box, int yr,
                                           int xr) {
    if (kStaged) return box[(yr - r.by0) * r.bw + (xr - r.bx0)];
    const int yy = min(max(r.ya + yr, 0), r.H - 1);
    const int xx = min(max(r.x0 + xr, 0), r.W - 1);
    return __ldg(r.plane + static_cast<size_t>(yy) * r.W + xx);
}

// _bilinear_win at window-local (px, py): the coordinate clamped to the
// image bounds in window-local terms (kClamp; a no-op on interior rows),
// the tap corner to the box (inside the window's [0, 126] x
// [0, win_y - 2]).
template <bool kStaged, bool kClamp>
__device__ __forceinline__ float box_bilinear(const RowWindow& r,
                                              const float* box, float px,
                                              float py, float xlo,
                                              float xhi, float ylo,
                                              float yhi) {
    if (kClamp) {
        px = fminf(fmaxf(px, xlo), xhi);
        py = fminf(fmaxf(py, ylo), yhi);
    }
    const float x0f = floorf(px);
    const float y0f = floorf(py);
    const float fx = px - x0f;
    const float fy = py - y0f;
    const int xi = min(max(static_cast<int>(x0f), r.bx0), r.bx1 - 1);
    const int yi = min(max(static_cast<int>(y0f), r.by0), r.by1 - 1);
    const float v00 = window_px<kStaged>(r, box, yi, xi);
    const float v01 = window_px<kStaged>(r, box, yi, xi + 1);
    const float v10 = window_px<kStaged>(r, box, yi + 1, xi);
    const float v11 = window_px<kStaged>(r, box, yi + 1, xi + 1);
    return (v00 * (1.0f - fx) + v01 * fx) * (1.0f - fy)
           + (v10 * (1.0f - fx) + v11 * fx) * fy;
}

// K9: warp w owns grid rows 5 w .. 5 w + 4 (200 samples); a row's entries
// are padded to 41, which spreads the x-tile walk's reads over the banks.
constexpr int kRowsPerWarp = kGrid / kWarps;
constexpr int kRowPad = kGrid + 1;
constexpr int kWarpSamples = kRowsPerWarp * kGrid;
constexpr int kWarpPad = kRowsPerWarp * kRowPad;
// B[y][tx][b] of the x tiles at b * kBStride + 4 y + tx: the y-tile lanes
// (tx, b) of one output row read 32 banks
constexpr int kBStride = 4 * kGrid + 4;
static_assert(kRowsPerWarp * kWarps == kGrid, "whole grid rows a warp");

// The warp's 200 samples of the NoTile grid (grid_descriptors_windowed,
// s_desc_notile.cu:31-129): the rotated-derivative gradient from four
// bilinear samples, hypotf, atan2f, the Gaussian weight and the two
// orientation bins, kept as (bin, low weight, high weight).  The
// expressions are those of _bilinear_win and grid_descriptors_windowed
// in window-local coordinates.
template <bool kStaged, bool kClamp>
__device__ void grid_samples(const RowWindow& r, const float* box,
                             const float* __restrict__ gauss, float x,
                             float y, float sbp, float c, float s,
                             float2* wts, unsigned char* bins) {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const float x0f = static_cast<float>(r.x0);
    const float y0f = static_cast<float>(r.ya);
    // image bounds in window-local coordinates (texture clamp addressing)
    const float xlo = 0.0f - x0f;
    const float xhi = static_cast<float>(r.W - 1) - x0f;
    const float ylo = 0.0f - y0f;
    const float yhi = static_cast<float>(r.H - 1) - y0f;
    auto bil = [&](float px, float py) {
        return box_bilinear<kStaged, kClamp>(r, box, px, py, xlo, xhi, ylo,
                                             yhi);
    };
    for (int f = lane; f < kWarpSamples; f += 32) {
        const int row = f / kGrid;
        const int ix = f - row * kGrid;
        const int iy = warp * kRowsPerWarp + row;
        // sample offsets -2.5 + 1/16 + i/8 (s_desc_notile.cu:29,57-58)
        const float sx = -2.4375f + static_cast<float>(ix) * 0.125f;
        const float sy = -2.4375f + static_cast<float>(iy) * 0.125f;
        const float ptx = c * sx - s * sy;
        const float pty = c * sy + s * sx;
        const float pxr = (x + ptx * sbp) - x0f;
        const float pyr = (y + pty * sbp) - y0f;
        const float dx = bil(pxr + c, pyr + s) - bil(pxr - c, pyr - s);
        const float dy = bil(pxr - s, pyr + c) - bil(pxr + s, pyr - c);
        const float mod = hypotf(dx, dy);
        float th = atan2f(dy, dx);
        if (th < 0.0f) th = th + psk::kPi2;
        const float tth = th * psk::k4RPi;
        const float fo = floorf(tth);
        const float do0 = tth - fo;
        const float ww = __ldg(gauss + iy * kGrid + ix) * mod;
        const int at = row * kRowPad + ix;
        wts[at] = make_float2((1.0f - do0) * ww, do0 * ww);
        bins[at] = static_cast<unsigned char>(static_cast<int>(fo) & 7);
    }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
desc_grid_stack(const float* __restrict__ stack, int L, int H, int W,
                const int* __restrict__ lpos, const float* __restrict__ xs,
                const float* __restrict__ ys,
                const float* __restrict__ sigmas,
                const float* __restrict__ angs, int win, int win_y,
                int capacity, const float* __restrict__ gauss,
                const float* __restrict__ tile, float* __restrict__ out) {
    extern __shared__ float box[];
    __shared__ float2 s_wts[kWarps][kWarpPad];
    __shared__ unsigned char s_bin[kWarps][kWarpPad];
    __shared__ float s_b[kBins * kBStride];
    __shared__ float s_tile[16];
    const int slot = blockIdx.x;
    const int t = threadIdx.x;
    const int warp = t >> 5;
    const int lane = t & 31;
    const float x = xs[slot];
    const float y = ys[slot];
    const float sbp = fabsf(3.0f * sigmas[slot]);
    const float c = cosf(angs[slot]);
    const float s = sinf(angs[slot]);
    float* dst = out + static_cast<size_t>(slot) * 128;
    if (!(sbp > 0.0f)) {
        // every sample's weight is 0, and so is every sum of the window form
        if (t < 128) dst[t] = 0.0f;
        return;
    }
    const RowWindow r = row_window(stack, L, H, W, lpos[slot], x, y, sbp,
                                   fabsf(c) + fabsf(s), win, win_y);
    const bool staged = r.bw * (r.by1 - r.by0 + 1) <= capacity;
    if (staged) stage_box(box, r);
    if (t < 16) s_tile[t] = tile[t];
    __syncthreads();

    float2* wts = s_wts[warp];
    unsigned char* bins = s_bin[warp];
    if (!staged)
        grid_samples<false, true>(r, box, gauss, x, y, sbp, c, s, wts, bins);
    else if (r.interior)
        grid_samples<true, false>(r, box, gauss, x, y, sbp, c, s, wts, bins);
    else
        grid_samples<true, true>(r, box, gauss, x, y, sbp, c, s, wts, bins);
    __syncwarp();

    // x tiles of the warp's rows, lane (row, tx) for 20 lanes:
    // B[y][tx][b] = sum_j A[y][8 tx + j][b] * tile[j] in the order
    // j = 0..15.  A sample is non-zero in its two bins only, and the terms
    // left out are +0.0 added to a sum of non-negative terms, which
    // changes no bit.
    if (lane < kRowsPerWarp * 4) {
        const int row = lane >> 2;
        const int tx = lane & 3;
        const float2* w = wts + row * kRowPad + 8 * tx;
        const unsigned char* b = bins + row * kRowPad + 8 * tx;
        float* sb = s_b + 4 * (warp * kRowsPerWarp + row) + tx;
#pragma unroll
        for (int k = 0; k < kBins; ++k) sb[k * kBStride] = 0.0f;
#pragma unroll 4
        for (int j = 0; j < 16; ++j) {
            const float2 v = w[j];
            const int b0 = b[j];
            const int b1 = (b0 + 1) & 7;
            sb[b0 * kBStride] = sb[b0 * kBStride] + v.x * s_tile[j];
            sb[b1 * kBStride] = sb[b1 * kBStride] + v.y * s_tile[j];
        }
    }
    __syncthreads();

    // y tiles: D[ty][tx][b] = sum_j B[8 ty + j][tx][b] * tile[j], in the
    // order j = 0..15, one output a thread
    if (t < 128) {
        const int ty = t >> 5;
        const float* col = s_b + (t & 7) * kBStride + ((t >> 3) & 3)
                           + 32 * ty;
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < 16; ++j) acc = acc + col[4 * j] * s_tile[j];
        dst[t] = acc;
    }
}

// K12's tiles of this warp (grid_rounded_body, one lane per rounded point
// in turn).  pts[j]: point j's rotated local-grid offset times sbp, the
// same in every tile.
template <bool kStaged>
__device__ void grid_rounded_tiles(const RowWindow& r, const float* box,
                                   const float2* pts, float* bins, float x,
                                   float y, float a, float sbp, bool ok,
                                   float c, float s, float* dst) {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const float safe = ok ? sbp : 1.0f;
    const float csbp = c * sbp;
    const float ssbp = s * sbp;
    const int W = r.W;
    const int H = r.H;
    // integer taps clipped to the image, then to the window (here: the box)
    auto tap = [&](int yy, int xx) {
        const int xr = min(max(xx - r.x0, r.bx0), r.bx1);
        const int yr = min(max(yy - r.ya, r.by0), r.by1);
        return window_px<kStaged>(r, box, yr, xr);
    };
    for (int tile = warp; tile < kTiles; tile += kWarps) {
        const float ox = static_cast<float>(tile & 3) - 1.5f;
        const float oy = static_cast<float>(tile >> 2) - 1.5f;
        // tile centre, then the sample rounded to a pixel (s_desc_grid.cu:71)
        const float ptx = (csbp * ox - ssbp * oy) + x;
        const float pty = (csbp * oy + ssbp * ox) + y;
        bins_zero(bins);
        for (int j = lane; j < 256; j += 32) {
            const float2 po = pts[j];
            const float px = rintf(ptx + po.x);
            const float py = rintf(pty + po.y);
            // recomputed rotated-local coordinates of the rounded pixel
            const float rx = (px - ptx) / safe;
            const float ry = (py - pty) / safe;
            const float nx = c * rx + s * ry;
            const float ny = c * ry - s * rx;
            const float wx = 1.0f - fabsf(nx);
            const float wy = 1.0f - fabsf(ny);
            if (!(wx >= 0.0f && wy >= 0.0f && ok)) continue;
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
            bins_add(bins, th, ww * wx * wy * mod);
        }
        bins_out(bins, dst, tile);
    }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
desc_grid_rounded_stack(const float* __restrict__ stack, int L, int H, int W,
                        const int* __restrict__ lpos,
                        const float* __restrict__ xs,
                        const float* __restrict__ ys,
                        const float* __restrict__ sigmas,
                        const float* __restrict__ angs, int win, int win_y,
                        int capacity, float* __restrict__ out) {
    extern __shared__ float box[];
    __shared__ float s_bins[kWarps * kBins * 32];
    __shared__ float2 s_pts[256];
    static_assert(kThreads == 256, "one point of the 16x16 grid a thread");
    const int slot = blockIdx.x;
    const int t = threadIdx.x;
    const float x = xs[slot];
    const float y = ys[slot];
    const float a = angs[slot];
    const float sbp = fabsf(3.0f * sigmas[slot]);
    const bool ok = sbp > 0.0f;
    const float c = cosf(a);
    const float s = sinf(a);
    const RowWindow r = row_window(stack, L, H, W, lpos[slot], x, y, sbp,
                                   fabsf(c) + fabsf(s), win, win_y);
    const bool staged = r.bw * (r.by1 - r.by0 + 1) <= capacity;
    if (staged && ok) stage_box(box, r);
    {
        // point (xd, yd) = (t % 16, t / 16) of the local grid
        // (k + 0.5) / 8 - 1 (s_desc_grid.cu:69), rotated
        const float u = (static_cast<float>(t & 15) + 0.5f) / 8.0f - 1.0f;
        const float v = (static_cast<float>(t >> 4) + 0.5f) / 8.0f - 1.0f;
        const float pixox = c * u - s * v;
        const float pixoy = c * v + s * u;
        s_pts[t] = make_float2(pixox * sbp, pixoy * sbp);
    }
    __syncthreads();
    float* dst = out + static_cast<size_t>(slot) * 128;
    float* bins = s_bins + (t >> 5) * kBins * 32 + (t & 31);
    if (staged)
        grid_rounded_tiles<true>(r, box, s_pts, bins, x, y, a, sbp, ok, c, s,
                                 dst);
    else
        grid_rounded_tiles<false>(r, box, s_pts, bins, x, y, a, sbp, ok, c,
                                  s, dst);
}

// The offsets (dxg, dyg) of sample k of the 32x32 ILoop grid in SBP
// units, -bsz + i bsz / 16 (s_desc_iloop.cu:60-75), and its rotated
// coordinates (nx, ny).
__device__ __forceinline__ void iloop_point(int k, float bsz, float c,
                                            float s, float& dxg, float& dyg,
                                            float& nx, float& ny) {
    dxg = -bsz + static_cast<float>(k & 31) * bsz / 16.0f;
    dyg = -bsz + static_cast<float>(k >> 5) * bsz / 16.0f;
    nx = c * dxg + s * dyg;
    ny = c * dyg - s * dxg;
}

// K13's tiles of this warp (iloop_body over the row's list of the samples
// that carry weight: pts[i] = (dxg sbp, dyg sbp, nx, ny) of the i-th).
template <bool kStaged, bool kClamp>
__device__ void iloop_tiles(const RowWindow& r, const float* box,
                            const float4* pts, int count, float* bins,
                            float x, float y, float sbp, float c, float s,
                            float* dst) {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const float csbp = c * sbp;
    const float ssbp = s * sbp;
    const float x0f = static_cast<float>(r.x0);
    const float y0f = static_cast<float>(r.ya);
    // image bounds in window-local coordinates (texture clamp addressing)
    const float xlo = 0.0f - x0f;
    const float xhi = static_cast<float>(r.W - 1) - x0f;
    const float ylo = 0.0f - y0f;
    const float yhi = static_cast<float>(r.H - 1) - y0f;
    auto bil = [&](float px, float py) {
        return box_bilinear<kStaged, kClamp>(r, box, px - x0f, py - y0f,
                                             xlo, xhi, ylo, yhi);
    };
    for (int tile = warp; tile < kTiles; tile += kWarps) {
        const float ox = static_cast<float>(tile & 3) - 1.5f;
        const float oy = static_cast<float>(tile >> 2) - 1.5f;
        const float ptx = csbp * ox - ssbp * oy;
        const float pty = csbp * oy + ssbp * ox;
        bins_zero(bins);
        for (int i = lane; i < count; i += 32) {
            const float4 p = pts[i];
            const float nx = p.z;
            const float ny = p.w;
            const float jj = (x + ptx) + p.x;
            const float ii = (y + pty) + p.y;
            const float gdx = bil(jj + c, ii + s) - bil(jj - c, ii - s);
            const float gdy = bil(jj - s, ii + c) - bil(jj + s, ii - c);
            const float mod = hypotf(gdx, gdy);
            const float th = wrap_2pi(atan2f(gdy, gdx));
            const float dnx = nx + ox;
            const float dny = ny + oy;
            const float ww = expf(-(dnx * dnx + dny * dny) / 8.0f);
            bins_add(bins, th,
                     ww * (1.0f - fabsf(nx)) * (1.0f - fabsf(ny)) * mod);
        }
        bins_out(bins, dst, tile);
    }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
desc_iloop_stack(const float* __restrict__ stack, int L, int H, int W,
                 const int* __restrict__ lpos, const float* __restrict__ xs,
                 const float* __restrict__ ys,
                 const float* __restrict__ sigmas,
                 const float* __restrict__ angs, int win, int win_y,
                 int capacity, float* __restrict__ out) {
    constexpr int kChunks = 1024 / 32;     // ballots of 32 grid samples
    constexpr int kPer = kChunks / kWarps;
    extern __shared__ float box[];
    __shared__ float4 s_pts[1024];
    __shared__ unsigned s_mask[kChunks];
    __shared__ float s_bins[kWarps * kBins * 32];
    const int slot = blockIdx.x;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const float x = xs[slot];
    const float y = ys[slot];
    const float a = angs[slot];
    const float sbp = fabsf(3.0f * sigmas[slot]);
    const bool ok = sbp > 0.0f;
    const float c = cosf(a);
    const float s = sinf(a);
    const float bsz = fabsf(c) + fabsf(s);
    const RowWindow r = row_window(stack, L, H, W, lpos[slot], x, y, sbp,
                                   bsz, win, win_y);
    const bool staged = r.bw * (r.by1 - r.by0 + 1) <= capacity;
    if (staged && ok) stage_box(box, r);

    // the samples that carry weight: chunk q of 32 holds k = 32 q + lane
    bool inside[kPer];
    float4 pt[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
        float dxg, dyg, nx, ny;
        iloop_point(32 * (warp + kWarps * j) + lane, bsz, c, s, dxg, dyg,
                    nx, ny);
        pt[j] = make_float4(dxg * sbp, dyg * sbp, nx, ny);
        inside[j] = fabsf(nx) < 1.0f && fabsf(ny) < 1.0f && ok;
        const unsigned m = __ballot_sync(~0u, inside[j]);
        if (lane == 0) s_mask[warp + kWarps * j] = m;
    }
    __syncthreads();
    // exclusive prefix of the chunks' counts, then each sample's place
    const int mine = __popc(s_mask[lane]);
    int incl = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int t = __shfl_up_sync(~0u, incl, d);
        if (lane >= d) incl = incl + t;
    }
    const int count = __shfl_sync(~0u, incl, 31);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
        const int q = warp + kWarps * j;
        const int base = __shfl_sync(~0u, incl - mine, q);
        if (inside[j])
            s_pts[base + __popc(s_mask[q] & ((1u << lane) - 1u))] = pt[j];
    }
    __syncthreads();
    float* dst = out + static_cast<size_t>(slot) * 128;
    float* bins = s_bins + warp * kBins * 32 + lane;
    if (!staged)
        iloop_tiles<false, true>(r, box, s_pts, count, bins, x, y, sbp, c, s,
                                 dst);
    else if (r.interior)
        iloop_tiles<true, false>(r, box, s_pts, count, bins, x, y, sbp, c, s,
                                 dst);
    else
        iloop_tiles<true, true>(r, box, s_pts, count, bins, x, y, sbp, c, s,
                                dst);
}

}  // namespace

// NoTile (K9), Grid (K12) and ILoop (K13) from the stack.  stack:
// (L, H, W) f32; lpos: (n,) i32 (clamped to 0..L-1 here); x, y, sigma,
// angle: (n,) f32; win: the descriptor window (K8's exact origins), win_y
// its rows; capacity: floats of dynamic shared memory for a row's footprint
// (0: every row reads the stack through L2); K9 also takes gauss: (40, 40)
// and tile: (16,); out: (n, 128).
template <typename Kernel, typename... Tables>
static int launch_stack_rows(Kernel kernel, const float* stack, int L,
                             int H, int W, const int* lpos, const float* x,
                             const float* y, const float* sigma,
                             const float* angle, int n, int win, int win_y,
                             int capacity, float* out, void* stream,
                             Tables... tables) {
    const int smem = capacity * static_cast<int>(sizeof(float));
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<n, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        stack, L, H, W, lpos, x, y, sigma, angle, win, win_y, capacity,
        tables..., out);
    return psk::status();
}

PSK_API int psk_desc_grid_stack(const float* stack, int L, int H, int W,
                                const int* lpos, const float* x,
                                const float* y, const float* sigma,
                                const float* angle, int n, int win,
                                int win_y, int capacity, const float* gauss,
                                const float* tile, float* out,
                                void* stream) {
    return launch_stack_rows(desc_grid_stack, stack, L, H, W, lpos, x, y,
                             sigma, angle, n, win, win_y, capacity, out,
                             stream, gauss, tile);
}

PSK_API int psk_desc_grid_rounded_stack(const float* stack, int L, int H,
                                        int W, const int* lpos,
                                        const float* x, const float* y,
                                        const float* sigma,
                                        const float* angle, int n, int win,
                                        int win_y, int capacity, float* out,
                                        void* stream) {
    return launch_stack_rows(desc_grid_rounded_stack, stack, L, H, W, lpos,
                             x, y, sigma, angle, n, win, win_y, capacity,
                             out, stream);
}

PSK_API int psk_desc_iloop_stack(const float* stack, int L, int H, int W,
                                 const int* lpos, const float* x,
                                 const float* y, const float* sigma,
                                 const float* angle, int n, int win,
                                 int win_y, int capacity, float* out,
                                 void* stream) {
    return launch_stack_rows(desc_iloop_stack, stack, L, H, W, lpos, x, y,
                             sigma, angle, n, win, win_y, capacity, out,
                             stream);
}
