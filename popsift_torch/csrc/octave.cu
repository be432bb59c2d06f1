// K7: the fused octave chain.  From level 0 of an octave it writes every
// level of the incremental chain (level l = separable blur of level l-1 by
// inc.filter[l], clamp addressing at the image edge), the L-1 DoG layers
// and the interleaved [mag; theta] gradient field, in one launch.
//
// Replaces popsift_tpu/kernels/octave.py:octave_chain_fused
// (_chain_kernel).  It computes exactly what K1 per level plus K2 compute
// (blur.cu, grad.cu), in their order: horizontal taps (centre, then
// (left + right) * t[off] for rising off), then vertical taps, DoG as
// level - previous, central differences, sqrtf(dx*dx + dy*dy) and atan2f.
// The Pallas kernel blurs vertically first and needs a polynomial atan2;
// neither is copied.  Built with --fmad=false, every value is bit-equal to
// the per-level path.
//
// Bound on the H100: device-memory bytes for the compulsory traffic (one
// read of level 0, 4 + 12 (+ 4 per stack level) bytes written per pixel
// and level); the per-level path moved each level through device memory
// three more times (K1's scratch plane, K1's re-read, K2's re-read).
// Design: one block per output tile of T x T pixels.  Level 0 is loaded
// once into shared memory with the chain's whole halo (sum of span-1 over
// the levels, plus 1 for the gradient); each level is then computed on a
// region that shrinks by its span-1 per side, in two buffers: the
// horizontal pass writes the scratch buffer, the vertical pass writes the
// new level over the old one (each thread reads the old value at its own
// position for the DoG before it overwrites it).  Positions of a region
// outside the image hold the value at the clamped position (level 0 is
// loaded so; after each pass of a tile at the image edge the out-of-image
// columns, then rows, are copied from the edge), which is the per-level
// edge clamp of the reference's texture reads and lets the tap loops run
// without clamps.  The taps are unrolled for each span (a template per
// span), and each thread of the vertical pass computes kRows rows from one
// register window of the column.  What bounds the kernel is instruction
// issue: the halo recompute costs about 3x the minimal arithmetic at
// T = 64, and --fmad=false makes each tap three instructions; that is the
// price of bit-equality and of never writing an intermediate level to
// device memory.
#include "common.cuh"

namespace {

constexpr int kMaxLevels = 16;
constexpr int kMaxSpan = 32;
constexpr int kRows = 4;  // rows per thread in the vertical pass

struct Chain {
    float t[kMaxLevels][kMaxSpan];  // taps of level l (index 0 unused)
    int span[kMaxLevels];
    int halo[kMaxLevels];  // context around the tile that level l needs
    int levels;
};

// One block's geometry: buffer element (by, bx) is image position
// (by + oy, bx + ox); the tile's outputs are image rows [ty0, yend) and
// columns [tx0, xend).
struct Tile {
    int H, W, P, oy, ox, ty0, tx0, yend, xend, size;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return min(max(v, lo), hi);
}

// tmp = horizontal taps of cur over buffer rows [r0, r1), columns [c0, c1)
template <int S>
__device__ __forceinline__ void horizontal(const float* cur, float* tmp,
                                           const float* taps, int P, int r0,
                                           int r1, int c0, int c1) {
    float t[S];
#pragma unroll
    for (int k = 0; k < S; ++k) t[k] = taps[k];
    for (int r = r0 + threadIdx.y; r < r1; r += blockDim.y)
        for (int c = c0 + threadIdx.x; c < c1; c += blockDim.x) {
            const float* p = cur + r * P + c;
            float acc = p[0] * t[0];
#pragma unroll
            for (int off = 1; off < S; ++off)
                acc = acc + (p[-off] + p[off]) * t[off];
            tmp[r * P + c] = acc;
        }
}

// cur = vertical taps of tmp over buffer rows [r0, r1), columns [c0, c1);
// the DoG (new - old) is written for the tile's own outputs
template <int S>
__device__ __forceinline__ void vertical(float* cur, const float* tmp,
                                         const float* taps, const Tile& g,
                                         int r0, int r1, int c0, int c1,
                                         float* __restrict__ dog) {
    float t[S];
#pragma unroll
    for (int k = 0; k < S; ++k) t[k] = taps[k];
    const int P = g.P;
    for (int rg = r0 + kRows * threadIdx.y; rg < r1;
         rg += kRows * blockDim.y)
        for (int c = c0 + threadIdx.x; c < c1; c += blockDim.x) {
            // rows rg-(S-1) .. rg+kRows-1+(S-1); the buffers carry kRows
            // spare rows, so the window never leaves the allocation
            float v[kRows + 2 * S - 2];
            const float* p = tmp + (rg - (S - 1)) * P + c;
#pragma unroll
            for (int j = 0; j < kRows + 2 * S - 2; ++j) v[j] = p[j * P];
            const int x = c + g.ox;
            const bool xout = x >= g.tx0 && x < g.xend;
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
                const int r = rg + i;
                if (r >= r1) break;
                float acc = v[i + S - 1] * t[0];
#pragma unroll
                for (int off = 1; off < S; ++off)
                    acc = acc
                          + (v[i + S - 1 - off] + v[i + S - 1 + off]) * t[off];
                float& dst = cur[r * P + c];
                const int y = r + g.oy;
                if (xout && y >= g.ty0 && y < g.yend)
                    dog[static_cast<size_t>(y) * g.W + x] = acc - dst;
                dst = acc;
            }
        }
}

// Level l from level l-1 (in cur) for span S.  hp / hn: the halos of
// levels l-1 and l.
template <int S>
__device__ __forceinline__ void blur_level(float* cur, float* tmp,
                                           const float* taps, const Tile& g,
                                           int hp, int hn,
                                           float* __restrict__ dog) {
    const int P = g.P;
    // buffer extents of the two regions, and of the image inside them
    const int pr0 = g.ty0 - hp - g.oy, pr1 = g.ty0 + g.size + hp - g.oy;
    const int nr0 = g.ty0 - hn - g.oy, nr1 = g.ty0 + g.size + hn - g.oy;
    const int nc0 = g.tx0 - hn - g.ox, nc1 = g.tx0 + g.size + hn - g.ox;
    const int ir0 = max(nr0, -g.oy), ir1 = min(nr1, g.H - g.oy);
    const int ic0 = max(nc0, -g.ox), ic1 = min(nc1, g.W - g.ox);

    horizontal<S>(cur, tmp, taps, P, pr0, pr1, ic0, ic1);
    __syncthreads();
    if (ic0 > nc0 || ic1 < nc1) {
        // out-of-image columns of the scratch rows: the edge column
        for (int r = pr0 + threadIdx.y; r < pr1; r += blockDim.y)
            for (int c = nc0 + threadIdx.x; c < nc1; c += blockDim.x)
                if (c < ic0 || c >= ic1)
                    tmp[r * P + c] = tmp[r * P + clampi(c, ic0, ic1 - 1)];
        __syncthreads();
    }
    vertical<S>(cur, tmp, taps, g, ir0, ir1, nc0, nc1, dog);
    __syncthreads();
    if (ir0 > nr0 || ir1 < nr1) {
        // out-of-image rows of the new level: the edge row
        for (int r = nr0 + threadIdx.y; r < nr1; r += blockDim.y)
            for (int c = nc0 + threadIdx.x; c < nc1; c += blockDim.x)
                if (r < ir0 || r >= ir1)
                    cur[r * P + c] = cur[clampi(r, ir0, ir1 - 1) * P + c];
        __syncthreads();
    }
}

__global__ void __launch_bounds__(512)
octave_chain(const float* __restrict__ lvl0, float* __restrict__ stack,
             float* __restrict__ dog, float* __restrict__ field, int H,
             int W, int tile, int stack_level, Chain ch) {
    extern __shared__ float smem[];
    // the taps, spans and halos are indexed by the level at run time:
    // shared copies keep them out of per-thread local memory
    __shared__ float s_taps[kMaxLevels][kMaxSpan];
    __shared__ int s_span[kMaxLevels];
    __shared__ int s_halo[kMaxLevels];
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    for (int i = tid; i < kMaxLevels * kMaxSpan; i += blockDim.x * blockDim.y)
        s_taps[i / kMaxSpan][i % kMaxSpan] = ch.t[i / kMaxSpan][i % kMaxSpan];
    if (tid < kMaxLevels) {
        s_span[tid] = ch.span[tid];
        s_halo[tid] = ch.halo[tid];
    }
    Tile g;
    const int h0 = ch.halo[0];
    g.H = H;
    g.W = W;
    g.size = tile;
    g.P = tile + 2 * h0;  // pitch of both buffers
    g.ty0 = blockIdx.y * tile;
    g.tx0 = blockIdx.x * tile;
    g.oy = g.ty0 - h0;
    g.ox = g.tx0 - h0;
    g.yend = min(g.ty0 + tile, H);
    g.xend = min(g.tx0 + tile, W);
    const int P = g.P;
    float* cur = smem;
    float* tmp = smem + (P + kRows) * P;
    const size_t hw = static_cast<size_t>(H) * W;

    // level 0 over the whole region, out-of-image positions clamped
    for (int r = threadIdx.y; r < P; r += blockDim.y) {
        const float* row =
            lvl0 + static_cast<size_t>(clampi(r + g.oy, 0, H - 1)) * W;
        for (int c = threadIdx.x; c < P; c += blockDim.x)
            cur[r * P + c] = row[clampi(c + g.ox, 0, W - 1)];
    }
    __syncthreads();

    for (int l = 0; l < ch.levels; ++l) {
        if (l > 0) {
            float* dl = dog + (l - 1) * hw;
            const float* t = s_taps[l];
            const int hp = s_halo[l - 1];
            const int hn = s_halo[l];
            switch (s_span[l]) {
#define PSK_SPAN(S) \
    case S: blur_level<S>(cur, tmp, t, g, hp, hn, dl); break;
                PSK_SPAN(1) PSK_SPAN(2) PSK_SPAN(3) PSK_SPAN(4)
                PSK_SPAN(5) PSK_SPAN(6) PSK_SPAN(7) PSK_SPAN(8)
                PSK_SPAN(9) PSK_SPAN(10) PSK_SPAN(11) PSK_SPAN(12)
                PSK_SPAN(13) PSK_SPAN(14) PSK_SPAN(15) PSK_SPAN(16)
                PSK_SPAN(17) PSK_SPAN(18) PSK_SPAN(19) PSK_SPAN(20)
                PSK_SPAN(21) PSK_SPAN(22) PSK_SPAN(23) PSK_SPAN(24)
                PSK_SPAN(25) PSK_SPAN(26) PSK_SPAN(27) PSK_SPAN(28)
                PSK_SPAN(29) PSK_SPAN(30) PSK_SPAN(31) PSK_SPAN(32)
#undef PSK_SPAN
                default: break;
            }
        }
        // level l is complete in cur: write its stack plane and field
        const bool keep = stack_level < 0 || stack_level == l;
        float* splane = stack + (stack_level < 0 ? l : 0) * hw;
        for (int y = g.ty0 + threadIdx.y; y < g.yend; y += blockDim.y)
            for (int x = g.tx0 + threadIdx.x; x < g.xend; x += blockDim.x) {
                const size_t i = static_cast<size_t>(y) * W + x;
                const float* p = cur + (y - g.oy) * P + (x - g.ox);
                if (keep) splane[i] = p[0];
                const float dx = p[1] - p[-1];
                const float dy = p[P] - p[-P];
                field[2 * l * hw + i] = sqrtf(dx * dx + dy * dy);
                field[(2 * l + 1) * hw + i] = atan2f(dy, dx);
            }
        // the next level's horizontal pass only reads cur and writes tmp,
        // which no thread reads any more: no barrier is needed here
    }
}

}  // namespace

// lvl0: (H, W); stack: (L, H, W) when stack_level < 0, else (1, H, W)
// holding level stack_level; dog: (L-1, H, W); field: (2L, H, W).
// taps: (L, 32) host array (row 0 unused); spans: (L,) host array; tile:
// the output tile edge, with 2 (P + 4) P floats of dynamic shared memory
// per block (and 2.2 KB of static), P = tile + 2 halo, halo = sum over
// l >= 1 of (span_l - 1), plus 1.
PSK_API int psk_octave_chain(const float* lvl0, float* stack, float* dog,
                             float* field, int L, int H, int W,
                             const float* taps, const int* spans, int tile,
                             int stack_level, void* stream) {
    if (L < 1 || L > kMaxLevels || tile < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    Chain ch{};
    ch.levels = L;
    for (int l = 0; l < L; ++l) {
        ch.span[l] = spans[l] < 1 ? 1 : (spans[l] > kMaxSpan ? kMaxSpan
                                                              : spans[l]);
        for (int k = 0; k < ch.span[l]; ++k)
            ch.t[l][k] = taps[l * kMaxSpan + k];
    }
    ch.halo[L - 1] = 1;
    for (int l = L - 1; l > 0; --l)
        ch.halo[l - 1] = ch.halo[l] + ch.span[l] - 1;
    const int P = tile + 2 * ch.halo[0];
    const size_t smem = 2ull * (P + kRows) * P * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        octave_chain, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 block(32, 16);
    const dim3 grid((W + tile - 1) / tile, (H + tile - 1) / tile);
    octave_chain<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
        lvl0, stack, dog, field, H, W, tile, stack_level, ch);
    return psk::status();
}
