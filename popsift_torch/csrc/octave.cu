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
// and level), with instruction throughput close behind: --fmad=false makes
// each tap three instructions, and every pixel of every level takes a sqrtf
// and an atan2f.  What holds it back is instruction throughput: 128
// registers a thread leave one block of 16 warps per SM, and the two
// barriers a step make those warps move through the phases together.
//
// Design: a block owns a strip of `strip` output columns over a segment
// of `seg` output rows, and slides down it kRows rows per step.  Every
// level keeps two rings of rows in shared memory, each row as wide as
// the strip plus that level's halo on both sides:
//   - the level's own rows (the horizontal pass of the next level reads
//     the newest; the central differences and the next level's DoG read
//     older ones);
//   - for l >= 1, the horizontal blur of level l-1's rows, 2 span - 2 +
//     kRows deep, the window of the vertical pass.
// At base row b, level l produces rows [b + lead_l, + kRows) from what
// level l-1 produced one step earlier, lead_l = halo_l + kRows (L-1-l)
// (halo_l is what the levels after it and the gradient consume).  So a
// step has two phases and two barriers whatever the number of levels:
// B: every level's horizontal pass and the cp.async of level 0's next rows
//    (16-byte copies where the strip's columns are aligned);
// C: every level's vertical pass, with the DoG of the rows it produces,
//    and every level's stack and field rows of the step before.
// Within a phase the work of all levels is one flat list, each level's
// items padded to whole warps, so every warp runs one level's span at a
// time and the block's threads stay busy while the levels' widths shrink:
// a horizontal item is kCols adjacent outputs of one row, computed from one
// register window read with 16-byte loads; a vertical item is kRows rows
// of one column, from one register window; the field takes whole rows,
// one warp each.  Each row of every level is computed once per strip; the
// neighbouring strip recomputes only the halo columns, and a segment its
// vertical halo once.  The per-level edge clamp: level 0's columns are
// loaded clamped; a vertical item of an out-of-image column computes the
// edge column instead, so every level's row holds its own edge value
// outside the image; out-of-image rows are never stored, and ring reads
// clamp the row to the level's own row 0 or H-1 (the vertical window
// through a table of row offsets built in phase B).  Ring slots advance
// by kRows a step, so no step divides.  The taps are unrolled per span (a
// template per span).
#include <mutex>

#include "common.cuh"

namespace {

constexpr int kMaxLevels = 16;
constexpr int kMaxSpan = 32;
// rows per step, horizontal outputs per item, threads per block;
// kernels/octave.py holds the same numbers (ROWS, COLS) for its planner
constexpr int kRows = 8;
constexpr int kCols = 8;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
static_assert(kCols % 4 == 0 && kThreads % 32 == 0, "chain tiling");


struct Chain {
    float t[kMaxLevels][kMaxSpan];  // taps of level l (index 0 unused)
    int span[kMaxLevels];
    int halo[kMaxLevels];    // rows/columns of level l the block needs
    int lead[kMaxLevels];    // rows level l runs ahead of the base row
    int width[kMaxLevels];   // strip + 2 halo
    int roff[kMaxLevels];    // level l's own ring: offset (floats),
    int rpitch[kMaxLevels];  // row pitch and depth in rows
    int rdepth[kMaxLevels];
    int hoff[kMaxLevels];    // level l's horizontal-pass ring (l >= 1)
    int hpitch[kMaxLevels];
    int hdepth[kMaxLevels];
    int woff[kMaxLevels];    // level l's window table (ints, l >= 1)
    int groups[kMaxLevels];  // level l's horizontal items per row
    int hend[kMaxLevels];    // end of level l's items in phase B's list
    int vend[kMaxLevels];    // and in phase C's (hend[0] = vend[0] = 0)
    int levels;
};

// One block's geometry.
struct Geo {
    int H, W, x0, y0, y1, wc, strip;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return min(max(v, lo), hi);
}

__device__ __host__ __forceinline__ int posmod(int a, int m) {
    const int r = a % m;
    return r < 0 ? r + m : r;
}

// a ring slot from a slot index plus an offset, -m <= s < 2m
__device__ __forceinline__ int wrap(int s, int m) {
    s += s < 0 ? m : 0;
    return s >= m ? s - m : s;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Phase B: level 0's rows of step b, clamped, into its ring (slot P0 for
// its first row); rows the block does not need are not loaded.  An item
// is four columns of a row: one 16-byte copy where they lie inside the
// image and `vec` says the addresses are 16-byte aligned, else four.
__device__ __forceinline__ void load_level0(const Chain& c, float* smem,
                                            const float* __restrict__ lvl0,
                                            const Geo& g, int b, int P0,
                                            bool vec) {
    const int h = c.halo[0];
    const int n = (c.width[0] + 3) / 4;
    const int xb = g.x0 - h;  // image column of buffer column 0
    for (int i = threadIdx.x; i < kRows * n; i += kThreads) {
        int j = 0;
#pragma unroll
        for (int k = 1; k < kRows; ++k) j += i >= k * n ? 1 : 0;
        const int col = 4 * (i - j * n);
        const int r = b + c.lead[0] + j;
        if (r < max(0, g.y0 - h) || r >= min(g.H, g.y1 + h)) continue;
        float* dst = smem + c.roff[0] + wrap(P0 + j, c.rdepth[0]) * c.rpitch[0]
                     + col;
        const float* row = lvl0 + static_cast<size_t>(r) * g.W;
        if (vec && xb + col >= 0 && xb + col + 4 <= g.W) {
            cp_async16(dst, row + xb + col);
        } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
                cp_async4(dst + e, row + clampi(xb + col + e, 0, g.W - 1));
        }
    }
}

// Phase B: one horizontal item of level l: row j of the rows level l-1
// produced in the step before (its ring slot Pp belongs to the row it
// produces now), output columns [kCols gi, + kCols) of level l's
// horizontal ring at slot Q + j.  Output column c reads level l-1's
// buffer columns [c, c + 2S - 2].
template <int S>
__device__ __forceinline__ void hpass(const Chain& c, float* smem, int l,
                                      const Geo& g, int b, int Pp, int Q,
                                      int j, int gi) {
    constexpr int kWin = (kCols + 2 * S - 2 + 3) / 4 * 4;
    const int hp = c.halo[l - 1];
    const int r = b + c.lead[l - 1] - kRows + j;
    if (r < max(0, g.y0 - hp) || r >= min(g.H, g.y1 + hp)) return;
    float t[S];
#pragma unroll
    for (int k = 0; k < S; ++k) t[k] = c.t[l][k];
    const int slot = wrap(Pp - kRows + j, c.rdepth[l - 1]);
    const float* src =
        smem + c.roff[l - 1] + slot * c.rpitch[l - 1] + kCols * gi;
    float* dst = smem + c.hoff[l] + wrap(Q + j, c.hdepth[l]) * c.hpitch[l]
                 + kCols * gi;
    float v[kWin];
    const float4* p = reinterpret_cast<const float4*>(src);
#pragma unroll
    for (int q = 0; q < kWin / 4; ++q) {
        const float4 f = p[q];
        v[4 * q] = f.x;
        v[4 * q + 1] = f.y;
        v[4 * q + 2] = f.z;
        v[4 * q + 3] = f.w;
    }
    float o[kCols];
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
        float acc = v[i + S - 1] * t[0];
#pragma unroll
        for (int off = 1; off < S; ++off)
            acc = acc + (v[i + S - 1 - off] + v[i + S - 1 + off]) * t[off];
        o[i] = acc;
    }
#pragma unroll
    for (int q = 0; q < kCols / 4; ++q)
        reinterpret_cast<float4*>(dst)[q] =
            make_float4(o[4 * q], o[4 * q + 1], o[4 * q + 2], o[4 * q + 3]);
}

// Phase B: the row offsets of every level's vertical window of this step
// in its horizontal ring, the rows clamped to the image.
__device__ __forceinline__ void window_tables(const Chain& c, float* smem,
                                              const Geo& g, int b,
                                              const int* Q) {
    int* tab = reinterpret_cast<int*>(smem);
    for (int l = 1; l < c.levels; ++l) {
        const int n = c.hdepth[l];  // 2 span - 2 + kRows
        const int base = b + c.lead[l - 1] - kRows;  // the row at slot Q
        const int first = base + kRows - n;
        for (int j = threadIdx.x; j < n; j += kThreads) {
            const int row = clampi(first + j, 0, g.H - 1);
            tab[c.woff[l] + j] =
                wrap(Q[l] + clampi(row - base, -n, n - 1), n) * c.hpitch[l];
        }
    }
}

// Phase C: one vertical item of level l: buffer column col of level l's
// rows of step b (ring slot P) from its horizontal ring, and their DoG
// against level l-1 (ring slot Pp for level l-1's row of this step)
// inside the segment.
template <int S>
__device__ __forceinline__ void vpass(const Chain& c, float* smem, int l,
                                      const Geo& g, int b, int P, int Pp,
                                      int col, float* __restrict__ dog) {
    const int h = c.halo[l];
    const int r0 = b + c.lead[l];
    const int lo = max(0, g.y0 - h), hi = min(g.H, g.y1 + h);
    if (r0 + kRows <= lo || r0 >= hi) return;
    constexpr int kWin = kRows + 2 * S - 2;
    float t[S];
#pragma unroll
    for (int k = 0; k < S; ++k) t[k] = c.t[l][k];
    const int* tab = reinterpret_cast<const int*>(smem) + c.woff[l];
    // an out-of-image column holds the edge column's value
    const int cs = clampi(g.x0 - h + col, 0, g.W - 1) - (g.x0 - h);
    const float* hring = smem + c.hoff[l] + cs;
    float v[kWin];
#pragma unroll
    for (int j = 0; j < kWin; ++j) v[j] = hring[tab[j]];
    float* ring = smem + c.roff[l] + col;
    const int D = c.rdepth[l], pitch = c.rpitch[l];
    // level l-1 at the same row: lead_{l-1} - lead_l = kRows + S - 1 rows
    // behind its newest, and S - 1 columns further into its buffer
    const float* prev = smem + c.roff[l - 1] + (S - 1) + col;
    const int Dp = c.rdepth[l - 1], pp = c.rpitch[l - 1];
    const int x = g.x0 - h + col;
    const bool xin = x >= g.x0 && x < g.x0 + g.wc;
    float* dl = dog + (l - 1) * static_cast<size_t>(g.H) * g.W + x;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
        const int r = r0 + i;
        if (r < lo || r >= hi) continue;
        float acc = v[i + S - 1] * t[0];
#pragma unroll
        for (int off = 1; off < S; ++off)
            acc = acc + (v[i + S - 1 - off] + v[i + S - 1 + off]) * t[off];
        ring[wrap(P + i, D) * pitch] = acc;
        if (xin && r >= g.y0 && r < g.y1)
            dl[static_cast<size_t>(r) * g.W] =
                acc - prev[wrap(Pp + i - kRows - S + 1, Dp) * pp];
    }
}

// Phase C: row j of level l's stack and field rows that the step before
// completed (the field needs the row below), inside the segment, one warp;
// P: the ring slot of the row level l produces in this step.
__device__ __forceinline__ void outputs(const Chain& c, const float* smem,
                                        int l, int j, const Geo& g, int b,
                                        int P, int stack_level,
                                        float* __restrict__ stack,
                                        float* __restrict__ field) {
    const int rn = b + c.lead[l];
    const int q = rn - kRows - 1 + j;
    if (q < g.y0 || q >= g.y1) return;
    const int h = c.halo[l];
    const int D = c.rdepth[l], pitch = c.rpitch[l];
    const float* ring = smem + c.roff[l] + h;
    const float* mid = ring + wrap(P + q - rn, D) * pitch;
    const float* up = ring + wrap(P + max(q - 1, 0) - rn, D) * pitch;
    const float* dn = ring + wrap(P + min(q + 1, g.H - 1) - rn, D) * pitch;
    const size_t hw = static_cast<size_t>(g.H) * g.W;
    const size_t base = static_cast<size_t>(q) * g.W + g.x0;
    float* srow = stack_level < 0 || stack_level == l
                      ? stack + (stack_level < 0 ? l : 0) * hw + base
                      : nullptr;
    float* mrow = field + 2 * l * hw + base;
    float* trow = mrow + hw;
    for (int x = threadIdx.x % 32; x < g.wc; x += 32) {
        const float v = mid[x];
        if (srow) srow[x] = v;
        const float dx = mid[x + 1] - mid[x - 1];
        const float dy = dn[x] - up[x];
        mrow[x] = sqrtf(dx * dx + dy * dy);
        trow[x] = atan2f(dy, dx);
    }
}

#define PSK_SPANS(X)                                                        \
    X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13)    \
    X(14) X(15) X(16) X(17) X(18) X(19) X(20) X(21) X(22) X(23) X(24)       \
    X(25) X(26) X(27) X(28) X(29) X(30) X(31) X(32)

__global__ void __launch_bounds__(kThreads, 1)
octave_chain(const float* __restrict__ lvl0, float* __restrict__ stack,
             float* __restrict__ dog, float* __restrict__ field, int H,
             int W, int strip, int seg, int stack_level,
             const __grid_constant__ Chain ch) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    // the taps and the layout are indexed by the level at run time; as a
    // grid constant they are read from the constant bank, without a copy
    const Chain& c = ch;
    // the ring slots of the rows each level produces in this step (P) and
    // of the rows each horizontal pass writes (Q), by step parity
    __shared__ int sP[2][kMaxLevels];
    __shared__ int sQ[2][kMaxLevels];
    Geo g;
    g.H = H;
    g.W = W;
    g.strip = strip;
    g.x0 = blockIdx.x * strip;
    g.y0 = blockIdx.y * seg;
    g.y1 = min(H, g.y0 + seg);
    g.wc = min(strip, W - g.x0);
    const int L = ch.levels;
    const int warp = threadIdx.x / 32;
    // level 0 in 16-byte copies where the strip's columns allow
    const bool vec = (g.x0 - ch.halo[0]) % 4 == 0 && W % 4 == 0
                     && (reinterpret_cast<uintptr_t>(lvl0) & 15) == 0;
    // level l needs rows [max(0, y0 - halo_l), min(H, y1 + halo_l)); the
    // first step produces none of them yet for any level
    const int b0 = max(-ch.lead[0], g.y0 - ch.halo[0] - ch.lead[0]);
    if (threadIdx.x < L) {
        const int l = threadIdx.x;
        sP[0][l] = posmod(b0 + ch.lead[l], ch.rdepth[l]);
        if (l > 0)
            sQ[0][l] = posmod(b0 + ch.lead[l - 1] - kRows, ch.hdepth[l]);
    }
    int cur = 0;
    for (int b = b0; b < g.y1 + kRows; b += kRows, cur ^= 1) {
        cp_async_wait_all();
        __syncthreads();
        // phase B
        load_level0(c, smem, lvl0, g, b, sP[cur][0], vec);
        cp_async_commit();
        int l = 1;
        for (int k = threadIdx.x; k < c.hend[L - 1]; k += kThreads) {
            while (k >= c.hend[l]) ++l;
            const int i = k - c.hend[l - 1];
            const int G = c.groups[l];
            if (i >= kRows * G) continue;
            int j = 0;
#pragma unroll
            for (int r = 1; r < kRows; ++r) j += i >= r * G ? 1 : 0;
            switch (c.span[l]) {
#define PSK_H(S)                                                             \
    case S:                                                                  \
        hpass<S>(c, smem, l, g, b, sP[cur][l - 1], sQ[cur][l], j, i - j * G); \
        break;
                PSK_SPANS(PSK_H)
#undef PSK_H
                default: break;
            }
        }
        window_tables(c, smem, g, b, sQ[cur]);
        __syncthreads();
        // phase C
        l = 1;
        for (int k = threadIdx.x; k < c.vend[L - 1]; k += kThreads) {
            while (k >= c.vend[l]) ++l;
            const int col = k - c.vend[l - 1];
            if (col >= c.width[l]) continue;
            switch (c.span[l]) {
#define PSK_V(S)                                                          \
    case S:                                                               \
        vpass<S>(c, smem, l, g, b, sP[cur][l], sP[cur][l - 1], col, dog); \
        break;
                PSK_SPANS(PSK_V)
#undef PSK_V
                default: break;
            }
        }
        for (int u = warp; u < L * kRows; u += kWarps)
            outputs(c, smem, u / kRows, u % kRows, g, b, sP[cur][u / kRows],
                    stack_level, stack, field);
        if (threadIdx.x < L) {
            const int l = threadIdx.x;
            sP[cur ^ 1][l] = wrap(sP[cur][l] + kRows, c.rdepth[l]);
            if (l > 0) sQ[cur ^ 1][l] = wrap(sQ[cur][l] + kRows, c.hdepth[l]);
        }
    }
    cp_async_wait_all();
}

int round4(int n) { return (n + 3) / 4 * 4; }
int round32(int n) { return (n + 31) / 32 * 32; }
int groups(int w) { return (w + kCols - 1) / kCols; }

// The block's shared-memory layout for a strip width: the rings (floats),
// then the window tables (ints); returns its size in 4-byte words.  Also
// the phase lists.  kernels/octave.py:chain_smem sizes the same layout for
// its planner, and psk_octave_chain refuses a plan whose size differs.
int layout(Chain& ch, int strip) {
    int off = 0;
    const int L = ch.levels;
    for (int l = 0; l < L; ++l) {
        const int w = strip + 2 * ch.halo[l];
        ch.width[l] = w;
        ch.groups[l] = groups(w);
        if (l > 0) {
            ch.hoff[l] = off;
            ch.hpitch[l] = kCols * groups(w);
            ch.hdepth[l] = 2 * ch.span[l] - 2 + kRows;
            off += ch.hpitch[l] * ch.hdepth[l];
        }
        // the stack and field rows read kRows + 2 rows behind those the
        // vertical pass writes in the same phase
        int pitch = round4(w);
        int depth = 2 * kRows + 2;
        if (l + 1 < L) {
            // the next level's horizontal pass reads whole float4 windows;
            // its DoG reads a row kRows + span - 1 behind the newest while
            // this level writes kRows more
            const int s = ch.span[l + 1];
            const int wn = w - 2 * (s - 1);
            pitch = max(pitch, kCols * (groups(wn) - 1)
                                   + round4(kCols + 2 * s - 2));
            depth = 2 * kRows + max(2, s - 1);
        }
        ch.roff[l] = off;
        ch.rpitch[l] = pitch;
        ch.rdepth[l] = depth;
        off += pitch * depth;
    }
    for (int l = 1; l < L; ++l) {
        ch.woff[l] = off;
        off += ch.hdepth[l];
    }
    ch.hend[0] = ch.vend[0] = 0;
    for (int l = 1; l < L; ++l) {
        ch.hend[l] = ch.hend[l - 1] + round32(kRows * ch.groups[l]);
        ch.vend[l] = ch.vend[l - 1] + round32(ch.width[l]);
    }
    return off;
}

}  // namespace

// lvl0: (H, W); stack: (L, H, W) when stack_level < 0, else (1, H, W)
// holding level stack_level; dog: (L-1, H, W); field: (2L, H, W).
// taps: (L, 32) host array (row 0 unused); spans: (L,) host array; strip,
// seg, smem: the block's output columns and rows and its dynamic shared
// memory in bytes (kernels/octave.py:chain_plan), which must be the size
// of this strip's layout.
PSK_API int psk_octave_chain(const float* lvl0, float* stack, float* dog,
                             float* field, int L, int H, int W,
                             const float* taps, const int* spans, int strip,
                             int seg, int smem, int stack_level,
                             void* stream) {
    if (L < 2 || L > kMaxLevels || strip < 1 || seg < 1)
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
    for (int l = 0; l < L; ++l)
        ch.lead[l] = ch.halo[l] + kRows * (L - 1 - l);
    if (layout(ch, strip) * static_cast<int>(sizeof(float)) != smem)
        return static_cast<int>(cudaErrorInvalidValue);
    // the attributes are the function's, per device: set them when the
    // size grows past what this device was given (the grant only grows,
    // so a launch never meets a smaller grant than its own)
    static std::mutex lock;
    static int granted[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
    std::lock_guard<std::mutex> guard(lock);
    if (smem > granted[dev]) {
        err = cudaFuncSetAttribute(
            octave_chain, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return static_cast<int>(err);
        err = cudaFuncSetAttribute(
            octave_chain, cudaFuncAttributePreferredSharedMemoryCarveout,
            cudaSharedmemCarveoutMaxShared);
        if (err != cudaSuccess) return static_cast<int>(err);
        granted[dev] = smem;
    }
    const dim3 grid((W + strip - 1) / strip, (H + seg - 1) / seg);
    octave_chain<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        lvl0, stack, dog, field, H, W, strip, seg, stack_level, ch);
    return psk::status();
}
