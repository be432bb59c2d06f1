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
// One launch takes the slots of several octaves: a table of up to 20
// octaves (psk::OctaveTable, a kernel parameter) gives each run of slots
// its source and shape, and a block reads its octave from it first.  The
// per-slot arithmetic does not depend on the table, so a slot's results
// are those of a launch over its octave alone, bit for bit.
//
// K5 and K10 also pick the histogram's peaks (ori_peaks), which the JAX
// package does in XLA (popsift_tpu/ops/orientation.py:_peaks_from_hist):
// they write num_ori and the angles, and the histogram only on request.
//
// Determinism: histogram ties decide num_ori, so there are no float
// atomics, and every sum is taken in a fixed order: the result is the
// same on every run.  K5/K10: see ori_peaks; K6/K11: see desc_loop.
//
// Bound on the H100: the gathered reads (a few KB per keypoint) and the
// per-pixel transcendental work; both are small next to the pyramid, and
// at a thousand keypoints an octave K5/K10 are latency-bound: one short
// wave of blocks, each a chain of row scan, pixel rounds, column sums and
// the epilogue's shuffles.  The stack variants read one level instead of
// two field planes and do K2's sqrt and atan2 per visited pixel.  What
// holds K6/K11 back is instruction
// throughput: a rotation, an exp and the binning for each pixel of each tile
// that reaches it.  desc_loop turns the scatter into a gather: one warp
// per tile of the 4 x 4 grid visits only the pixels of its tile's rotated
// square, with its lanes busy whatever the rows' lengths, and owns that
// tile's bins, so a row needs no 128-bin histogram per thread; the price
// is that a pixel near a tile border is visited by each tile it reaches
// (K11 takes its gradient each time).
#include "common.cuh"

namespace {

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

// ---------------------------------------------------------------------
// K5 / K10: the histogram and its peaks in one launch.
//
// A block of kOriWarps warps per extremum walks the orientation disc by
// row intervals: thread r finds row r's columns (those with dx^2 < rad^2
// + 1 - dy^2, widened by kSlack; the exact int-truncated distance test
// still decides every pixel), a block scan lays the rows end to end, and
// thread t takes pixels t, t + kOriThreads, ..., so no pixel costs a
// division.  Each thread adds its pixels into its own column of a
// [36][kOriThreads] shared histogram, in pixel order.  Each warp then
// sums its 32 columns per bin, lane l taking bins l and l + 32 in an order
// rotated by the lane (conflict-free), and warp 0 adds the four warps'
// partial sums in warp order: a fixed order, the same bits on every run.
//
// The epilogue (ori_epilogue) runs on one warp, lane l owning bin l and,
// on lanes 0-3, bin 32 + l: six VLFeat box passes through shared memory,
// the peak test and the quadratic refinement, and top-4 acceptance in
// four rounds of two warp reductions (the largest height as an ordered
// unsigned key, then the lowest bin holding it: ties go to the lower bin,
// as lax.top_k and a stable descending sort do).  Every expression is the
// plain version's (kernels/binwin.py:peak_candidates, peaks_from_hist) in
// its order, and the divisions by a Python scalar are the multiplications
// by f32(1/3) and f32(1/36) that PyTorch's CUDA division by a scalar
// performs, so with --fmad=false num_ori and the angles are bit-equal to
// the plain version run on the kernel's own histogram.  With a block's
// warps all resident, each instruction waits its turn among the SM's
// warps, so the design counts instructions more than latencies.
constexpr int kOriWarps = 4;
constexpr int kOriThreads = 32 * kOriWarps;
constexpr int kOriReads = 2;        // pixels a thread reads at once
constexpr int kMaxOri = 4;          // ORIENTATION_MAX_COUNT
constexpr int kNoBin = 64;          // above every bin
constexpr float kSlack = 0.25f;     // px; row bounds' margin for rounding
constexpr float kThird = 1.0f / 3.0f;              // f32(1/3)
constexpr float kRBins = 1.0f / kOriBins;          // f32(1/36)

// An unsigned key in the order of the float heights (-0 taken as +0, NaN
// never occurs: every height is finite or -inf).
__device__ __forceinline__ unsigned height_key(float y) {
    const unsigned b = __float_as_uint(y + 0.0f);
    return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// One histogram's epilogue on a warp; hist: the warp's [2][36] shared
// buffers, hist[0] holding the histogram.  Lane 0 writes num_ori, lanes
// 0-3 the four angles.
__device__ void ori_epilogue(float (*hist)[kOriBins], int lane, int slot,
                             int* __restrict__ num_out,
                             float* __restrict__ ang_out) {
    constexpr unsigned kAll = 0xffffffffu;
    const bool two = lane < kOriBins - 32;  // lanes owning a second bin
    const int k1 = 32 + lane;
    const int prev0 = lane == 0 ? kOriBins - 1 : lane - 1;
    const int prev1 = k1 - 1;
    const int next1 = k1 + 1 == kOriBins ? 0 : k1 + 1;
    int cur = 0;
#pragma unroll
    for (int pass = 0; pass < 6; ++pass) {
        const float* h = hist[cur];
        float* o = hist[cur ^ 1];
        __syncwarp();
        o[lane] = (h[prev0] + h[lane] + h[lane + 1]) * kThird;
        if (two) o[k1] = (h[prev1] + h[k1] + h[next1]) * kThird;
        cur ^= 1;
    }
    __syncwarp();
    const float* sm = hist[cur];
    float* yv = hist[cur ^ 1];  // the heights, then the refined positions
    float ref0, ref1 = -1.0f, y1 = -INFINITY;
    float y0;
    {
        // peak_candidates of bin k with neighbours p and q
        auto peak = [](float p, float s, float q, int k, float& y,
                       float& refined) {
            const bool is_peak = s > p && s > q;  // s > max(p, q)
            const float num = is_peak ? 3.0f * p - 4.0f * s + 1.0f * q : 0.0f;
            const float den = is_peak ? 2.0f * (p - 2.0f * s + q) : 1.0f;
            const float newbin = num / den;
            const bool pred = is_peak && newbin >= 0.0f && newbin <= 2.0f;
            const float prev_idx = k == 0 ? static_cast<float>(kOriBins - 1)
                                          : static_cast<float>(k - 1);
            refined = pred ? prev_idx + newbin : -1.0f;
            y = pred ? -(num * num) / (4.0f * den) + p : -INFINITY;
        };
        peak(sm[prev0], sm[lane], sm[lane + 1], lane, y0, ref0);
        if (two) peak(sm[prev1], sm[k1], sm[next1], k1, y1, ref1);
    }
    unsigned key0 = height_key(y0);
    unsigned key1 = two ? height_key(y1) : 0u;
    int top[kMaxOri];
#pragma unroll
    for (int r = 0; r < kMaxOri; ++r) {
        // the lane's best untaken bin (bin lane first on equal keys)
        const bool first = key0 >= key1;
        const unsigned key = first ? key0 : key1;
        const unsigned best = __reduce_max_sync(kAll, key);
        const unsigned bin = __reduce_min_sync(
            kAll, key == best ? static_cast<unsigned>(first ? lane : k1)
                              : static_cast<unsigned>(kNoBin));
        if (bin == static_cast<unsigned>(lane)) key0 = 0u;
        if (bin == static_cast<unsigned>(k1)) key1 = 0u;
        top[r] = static_cast<int>(bin);
    }
    // every taken key is 0, below every height's (height_key(-inf) > 0)
    __syncwarp();
    yv[lane] = y0;
    if (two) yv[k1] = y1;
    __syncwarp();
    const float best_y = yv[top[0]];
    int mine = top[0];
#pragma unroll
    for (int r = 1; r < kMaxOri; ++r)
        if (lane == r) mine = top[r];
    const float y = yv[mine];
    const bool accept = lane < kMaxOri && y >= 0.8f * best_y && isfinite(y);
    const unsigned accepted = __ballot_sync(kAll, accept);
    __syncwarp();
    yv[lane] = ref0;
    if (two) yv[k1] = ref1;
    __syncwarp();
    if (lane < kMaxOri) {
        float chosen = yv[mine];
        chosen = chosen >= static_cast<float>(kOriBins)
                     ? chosen - static_cast<float>(kOriBins)
                     : chosen;
        const float th = psk::kPi2 * chosen * kRBins - psk::kPi;
        ang_out[static_cast<size_t>(slot) * kMaxOri + lane] =
            accept ? th : 0.0f;
    }
    if (lane == 0) num_out[slot] = __popc(accepted);
}

template <bool kStack>
__global__ void __launch_bounds__(kOriThreads)
ori_peaks(const psk::OctaveTable octaves,
          const float* __restrict__ xs, const float* __restrict__ ys,
          const int* __restrict__ lpos, const float* __restrict__ sigmas,
          float* __restrict__ hist_out, int* __restrict__ num_out,
          float* __restrict__ ang_out) {
    __shared__ float s_bins[kOriBins][kOriThreads];
    __shared__ int s_lo[kOriThreads];      // a row's first column
    __shared__ int s_start[kOriThreads];   // its first pixel's index
    __shared__ int s_end[kOriThreads];     // one past its last
    __shared__ float s_dy2[kOriThreads];   // dy * dy
    __shared__ int s_wsum[kOriWarps];
    __shared__ float s_part[kOriWarps][kOriBins];
    __shared__ float s_hist[2][kOriBins];
    const int t = threadIdx.x;
    const int lane = t % 32;
    const int warp = t / 32;
    const int slot = blockIdx.x;
    const float x = xs[slot];
    const float y = ys[slot];
    const float sigma = sigmas[slot];
    const int lp = lpos[slot];
    const psk::Octave oct = psk::octave_of(octaves, slot);
    const int H = oct.H, W = oct.W;
#pragma unroll
    for (int b = 0; b < kOriBins; ++b) s_bins[b][t] = 0.0f;

    const int rx = static_cast<int>(rintf(x));
    const int ry = static_cast<int>(rintf(y));
    const int rad = static_cast<int>(rintf(3.0f * (1.5f * sigma)));
    const Gradient<kStack> grad(oct.src, min(max(lp, 0), oct.L - 1), H, W);

    // xmin/xmax/ymin/ymax gates (s_orientation.cu:114-117)
    const int xmin = max(1, rx - rad), xmax = min(W - 2, rx + rad);
    const int ymin = max(1, ry - rad), ymax = min(H - 2, ry + rad);
    const float sigw = 1.5f * sigma;
    const float factor = -0.5f / (sigw * sigw);
    const int rad2 = rad * rad;
    const float lim = static_cast<float>(rad2 + 1);
    if (xmax >= xmin) {
        for (int r0 = ymin; r0 <= ymax; r0 += kOriThreads) {
            // thread t: the columns of row r0 + t that the disc can hold;
            // none when dy^2 >= rad^2 + 1, for then int(dx^2 + dy^2) >
            // rad^2 whatever dx
            const int ii = r0 + t;
            int lo = xmin, len = 0;
            const float dyf = static_cast<float>(ii) - y;
            const float dy2 = dyf * dyf;
            if (ii <= ymax && dy2 < lim) {
                const float half = sqrtf(lim - dy2) + kSlack;
                lo = max(xmin, static_cast<int>(floorf(x - half)));
                const int hi = min(xmax, static_cast<int>(ceilf(x + half)));
                len = max(hi - lo + 1, 0);
            }
            int end = len;
#pragma unroll
            for (int off = 1; off < 32; off *= 2) {
                const int v = __shfl_up_sync(0xffffffffu, end, off);
                if (lane >= off) end += v;
            }
            if (lane == 31) s_wsum[warp] = end;
            __syncthreads();
            for (int w = 0; w < warp; ++w) end += s_wsum[w];
            s_lo[t] = lo;
            s_start[t] = end - len;
            s_end[t] = end;
            s_dy2[t] = dy2;
            __syncthreads();
            const int total = s_end[kOriThreads - 1];
            int r = 0;
            for (int k0 = 0; k0 < total; k0 += kOriThreads * kOriReads) {
                float mag[kOriReads], theta[kOriReads];
                int sq[kOriReads];
                bool use[kOriReads];
#pragma unroll
                for (int u = 0; u < kOriReads; ++u) {
                    const int k = k0 + kOriThreads * u + t;
                    use[u] = k < total;
                    if (!use[u]) continue;
                    while (s_end[r] <= k) ++r;
                    const int jj = s_lo[r] + (k - s_start[r]);
                    const float dxf = static_cast<float>(jj) - x;
                    // int truncation of the squared distance
                    // (s_orientation.cu:142)
                    sq[u] = static_cast<int>(dxf * dxf + s_dy2[r]);
                    use[u] = sq[u] <= rad2;
                    if (use[u]) grad.at(r0 + r, jj, mag[u], theta[u]);
                }
#pragma unroll
                for (int u = 0; u < kOriReads; ++u) {
                    if (!use[u]) continue;
                    const float wgt =
                        mag[u] * expf(static_cast<float>(sq[u]) * factor);
                    int b = static_cast<int>(
                        rintf(36.0f * (theta[u] + psk::kPi) / psk::kPi2));
                    if (b == kOriBins) b = 0;
                    if (b < 0 || b >= kOriBins) continue;
                    s_bins[b][t] += wgt;
                }
            }
            // the next rows' intervals overwrite the tables
            __syncthreads();
        }
    }
    __syncthreads();
    float part0 = 0.0f, part1 = 0.0f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
        const int c = 32 * warp + ((j + lane) & 31);
        part0 += s_bins[lane][c];
        if (lane < kOriBins - 32) part1 += s_bins[32 + lane][c];
    }
    s_part[warp][lane] = part0;
    if (lane < kOriBins - 32) s_part[warp][32 + lane] = part1;
    __syncthreads();
    if (warp != 0) return;
    const bool two = lane < kOriBins - 32;
    float h0 = s_part[0][lane];
    float h1 = two ? s_part[0][32 + lane] : 0.0f;
#pragma unroll
    for (int w = 1; w < kOriWarps; ++w) {
        h0 += s_part[w][lane];
        if (two) h1 += s_part[w][32 + lane];
    }
    s_hist[0][lane] = h0;
    if (two) s_hist[0][32 + lane] = h1;
    if (hist_out != nullptr) {
        float* h = hist_out + static_cast<size_t>(slot) * kOriBins;
        h[lane] = h0;
        if (two) h[32 + lane] = h1;
    }
    ori_epilogue(s_hist, lane, slot, num_out, ang_out);
}

// The epilogue alone, on (n, 36) histograms given in device memory: one
// warp per histogram.
__global__ void __launch_bounds__(kOriThreads)
ori_peaks_of_hist(const float* __restrict__ hist, int n,
                  int* __restrict__ num_out, float* __restrict__ ang_out) {
    __shared__ float s_hist[kOriWarps][2][kOriBins];
    const int lane = threadIdx.x % 32;
    const int warp = threadIdx.x / 32;
    const int slot = blockIdx.x * kOriWarps + warp;
    if (slot >= n) return;  // the whole warp
    const float* h = hist + static_cast<size_t>(slot) * kOriBins;
    s_hist[warp][0][lane] = h[lane];
    if (lane < kOriBins - 32) s_hist[warp][0][32 + lane] = h[32 + lane];
    ori_epilogue(s_hist[warp], lane, slot, num_out, ang_out);
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
desc_loop(const psk::OctaveTable octaves,
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
    const psk::Octave oct = psk::octave_of(octaves, slot);
    const int H = oct.H, W = oct.W;
    const Gradient<kStack> grad(oct.src, min(max(lpos[slot], 0), oct.L - 1),
                                H, W);

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
int launch_ori_peaks(const long long* table, int n_octaves, const float* x,
                     const float* y, const int* lpos, const float* sigma,
                     int n, float* hist, int* num, float* ang, void* stream) {
    psk::OctaveTable octaves;
    if (!psk::octave_table(table, n_octaves, octaves))
        return static_cast<int>(cudaErrorInvalidValue);
    ori_peaks<kStack><<<n, kOriThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        octaves, x, y, lpos, sigma, hist, num, ang);
    return psk::status();
}

template <bool kStack>
int launch_desc_loop(const long long* table, int n_octaves, const float* x,
                     const float* y, const int* lpos, const float* sigma,
                     const float* angle, int n, int half, float* out,
                     void* stream) {
    psk::OctaveTable octaves;
    if (!psk::octave_table(table, n_octaves, octaves))
        return static_cast<int>(cudaErrorInvalidValue);
    desc_loop<kStack><<<n, 32 * kDescWarps, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        octaves, x, y, lpos, sigma, angle, half, out);
    return psk::status();
}

}  // namespace

// octaves: n_octaves (field, first slot, L, H, W) int64 quintuples in
// host memory, each field (2L, H, W), the slots of every octave end to
// end (psk::OctaveTable); x, y, sigma: (n,) f32; lpos: (n,) i32; num: (n,)
// i32 and ang: (n, 4) f32, the orientations; hist: (n, 36), or null.
PSK_API int psk_ori_hist(const long long* octaves, int n_octaves,
                         const float* x, const float* y, const int* lpos,
                         const float* sigma, int n, float* hist, int* num,
                         float* ang, void* stream) {
    return launch_ori_peaks<false>(octaves, n_octaves, x, y, lpos, sigma, n,
                                   hist, num, ang, stream);
}

// octaves: as psk_ori_hist, each source an (L, H, W) stack; the rest as
// psk_ori_hist.
PSK_API int psk_ori_hist_stack(const long long* octaves, int n_octaves,
                               const float* x, const float* y,
                               const int* lpos, const float* sigma, int n,
                               float* hist, int* num, float* ang,
                               void* stream) {
    return launch_ori_peaks<true>(octaves, n_octaves, x, y, lpos, sigma, n,
                                  hist, num, ang, stream);
}

// hist: (n, 36) given; num, ang as psk_ori_hist.
PSK_API int psk_ori_peaks_of_hist(const float* hist, int n, int* num,
                                  float* ang, void* stream) {
    ori_peaks_of_hist<<<psk::blocks_for(n, kOriWarps), kOriThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(hist, n, num,
                                                             ang);
    return psk::status();
}

// octaves: as psk_ori_hist; angle: (n,) f32; half: half the static
// descriptor window; out: (n, 128).
PSK_API int psk_desc_loop(const long long* octaves, int n_octaves,
                          const float* x, const float* y, const int* lpos,
                          const float* sigma, const float* angle, int n,
                          int half, float* out, void* stream) {
    return launch_desc_loop<false>(octaves, n_octaves, x, y, lpos, sigma,
                                   angle, n, half, out, stream);
}

// octaves: as psk_ori_hist_stack; the rest as psk_desc_loop.
PSK_API int psk_desc_loop_stack(const long long* octaves, int n_octaves,
                                const float* x, const float* y,
                                const int* lpos, const float* sigma,
                                const float* angle, int n, int half,
                                float* out, void* stream) {
    return launch_desc_loop<true>(octaves, n_octaves, x, y, lpos, sigma,
                                  angle, n, half, out, stream);
}
