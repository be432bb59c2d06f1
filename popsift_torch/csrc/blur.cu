// K1: separable Gaussian blur with clamp addressing, optional x hscale and
// optional DoG output, and its chain entry: every level of a small octave
// from its level 0 in one launch.
//
// Replaces popsift_tpu/kernels/blur.py:sep_blur_fused and
// sep_blur_fused_with_dog (_blur_kernel).  It computes the order of the
// JAX package's XLA form (blur.py:133-137, ops/pyramid.py:blur_1d):
// horizontal taps (centre, then (left + right) * t[off] for rising off),
// then the optional scale, then the vertical taps in the same order.  The
// Pallas kernel runs the vertical pass first and is not the one copied.
//
// Bound on the H100: device-memory bytes.  Each pass does 3 operations per
// tap and pixel (at span 14, 84 a pixel) for 8 bytes of compulsory
// traffic (12 with the DoG), below the card's operation/byte balance.
//
// Design of sep_blur: a block computes a tile of output rows and columns
// in one pass.
// It copies the tile's source rows, with span_v - 1 clamped halo rows
// above and below and P clamped halo columns on each side (P, the halo
// class, is the smallest of 4, 8, 16, 32 that holds both spans' span - 1),
// into shared memory by 16-byte loads where the row is aligned; runs the
// horizontal pass over all those rows into a second shared buffer (a
// thread computes 4 adjacent outputs from a register window of 2P + 4
// values read as float4s); then the vertical pass (a thread computes 8
// rows of one column from a window of 8 + 2P values) and writes the
// output and the DoG, whose source value it takes from the first buffer.
// The intermediate plane never leaves the SM.  Windows are indexed by
// compile-time offsets (the tap loops are unrolled to P and guarded by the
// span), so they stay in registers.
//
// The chain entry (psk_blur_chain) computes levels 1..L-1 of a small
// octave in one launch of one thread-block cluster (up to 16 blocks; the
// octaves it takes have at most 2^16 pixels).  Each block keeps a band of
// rows of the current level in its shared memory for the whole launch.
// A level: the block's horizontal pass of its band; a cluster barrier
// (release/acquire); the span - 1 halo rows of that pass copied from the
// neighbouring blocks' shared memory (distributed shared memory, 16-byte
// copies); the vertical pass into the next level's band, the stack and the
// DoG.  Level 0 is read from device memory once and nothing else is.  The
// buffers of the horizontal pass alternate by level, so one barrier a
// level suffices.  Small octaves are latency-bound: a level is a few
// phases of a few hundred cycles of dependent work on each block (the
// parent's per-level form spreads each level over two launches of many
// blocks instead).  The tap arithmetic is blur_tile's, so every level is
// bit-equal to the per-level call.
//
// The chain entry may also write the octave's gradient field, K2's
// (csrc/grad.cu), which it replaces on these octaves.  After the chain's
// last barrier every level of every band is in the stack, in L2, and each
// block computes the field of its band's rows at every level from there:
// a warp a row, its lanes along x, up to 4 chunks of 32 columns loaded
// before their arithmetic, so that their latencies overlap.  That pass
// adds one round of latency to the launch, and on the larger octaves the
// field's instructions on the cluster's 16 SMs (K2 spreads them over the
// card).  Computing each level's field inside the chain's phases
// instead, from the bands in shared memory, put more dependent latency
// on every level's critical path and took more device time on every
// octave (PERF.md, section 6).  The expressions and their order are
// K2's, built with --fmad=false, so the field is bit-equal to K2 on the
// same stack.
#include <cooperative_groups.h>

#include <mutex>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBatch = 8;        // source chunks a thread has in flight
constexpr int kMaxSpan = 32;
constexpr int kMaxLevels = 16;
constexpr int kMaxCluster = 16;  // non-portable cluster size on the H100
// sep_blur: threads, output rows of a vertical item, tile rows and columns
// (kernels/blur.py VROWS, TILE)
constexpr int kThreads = 256, kVRows = 8;
constexpr int kTileRows = 64, kTileCols = 128;
// blur_chain: threads of a block, output rows of a vertical item, and the
// rows of a block's band it aims at (kernels/blur.py CHAIN_VROWS,
// CHAIN_BAND)
constexpr int kChainThreads = 512, kChainVRows = 2, kChainBand = 4;
// the shared memory a chain block may use (kernels/blur.py CHAIN_SMEM)
constexpr int kChainSmem = 232448 - 1024;

__host__ __device__ inline int halo_rows(int span_v) { return span_v - 1; }

struct ChainBands {
    int blocks, rows;   // blocks of the cluster, rows of a band
};

// The cluster's blocks (a power of two up to kMaxCluster) and the rows of
// each block's band (the last band may be shorter).
ChainBands chain_bands(int H) {
    ChainBands b;
    const int want = (H + kChainBand - 1) / kChainBand;
    b.blocks = 1;
    while (b.blocks < want && b.blocks < kMaxCluster) b.blocks *= 2;
    b.rows = (H + b.blocks - 1) / b.blocks;
    return b;
}

// rows of a chain block's buffer of the horizontal pass: its band in the
// middle, P rows above it and P + kChainVRows below (the halo rows of the
// pass, and rows that vertical items past the band read and discard)
__host__ __device__ inline int chain_vb_rows(int rows, int p) {
    return rows + 2 * p + kChainVRows;
}

// floats of a chain block's shared memory: its band of the current and of
// the next level, and two buffers of the horizontal pass
__host__ __device__ inline int chain_smem_floats(int rows, int W, int p) {
    return 2 * rows * W + 2 * chain_vb_rows(rows, p) * W;
}

struct Taps {
    float t[kMaxSpan];
    int span;
};

struct BlurArgs {
    Taps h, v;
    float hscale;
    int vec;   // rows are 16-byte aligned
};

struct ChainArgs {
    float t[kMaxLevels][kMaxSpan];
    int span[kMaxLevels];
    int levels;
    int rows;   // of a band
};

// floats of shared memory of one tile: the clamped source rows, and the
// horizontal pass's
__host__ __device__ inline int tile_smem_floats(int th, int tw, int p,
                                                int span_v) {
    const int nr = th + 2 * halo_rows(span_v);
    return nr * (tw + 2 * p) + nr * tw;
}

__device__ __forceinline__ float4 load4(const float* row, int gx, int W,
                                        bool vec) {
    if (vec && gx >= 0 && gx + 3 < W)
        return __ldcg(reinterpret_cast<const float4*>(row + gx));
    return make_float4(__ldcg(row + min(max(gx, 0), W - 1)),
                       __ldcg(row + min(max(gx + 1, 0), W - 1)),
                       __ldcg(row + min(max(gx + 2, 0), W - 1)),
                       __ldcg(row + min(max(gx + 3, 0), W - 1)));
}

// One tile: out[ty0 .. ty0+th, tx0 .. tx0+tw] of
// blur_v(hscale * blur_h(src)) and dog = out - src, clamped at the edges,
// by NT threads.  th is a multiple of VR, tw of 4; smem holds
// tile_smem_floats().
template <int P, int VR, int NT>
__device__ void blur_tile(const float* src, float* out, float* dog, int H,
                          int W, const float* th_taps, int sh,
                          const float* tv_taps, int sv, float hscale,
                          bool vec, int ty0, int tx0, int th, int tw,
                          float* smem) {
    const int hv = halo_rows(sv);
    const int nr = th + 2 * hv;          // rows of both buffers
    const int sp = tw + 2 * P;           // pitch of the source buffer
    float* s_src = smem;                 // nr x sp: clamped source
    float* s_h = smem + nr * sp;         // nr x tw: horizontal pass
    const int tid = threadIdx.x;

    // source rows ty0 - hv .. ty0 + th + hv, columns tx0 - P ..
    // tx0 + tw + P, kBatch chunks of 4 loaded before any is stored so
    // that their latencies overlap
    const int q4 = sp / 4;
    const int chunks = nr * q4;
    for (int base = tid; base < chunks; base += NT * kBatch) {
        float4 v[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
            const int i = base + b * NT;
            if (i < chunks) {
                const int j = i / q4, q = i - j * q4;
                const int gy = min(max(ty0 - hv + j, 0), H - 1);
                v[b] = load4(src + static_cast<size_t>(gy) * W,
                             tx0 - P + 4 * q, W, vec);
            }
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
            const int i = base + b * NT;
            if (i < chunks) {
                const int j = i / q4, q = i - j * q4;
                *reinterpret_cast<float4*>(s_src + j * sp + 4 * q) = v[b];
            }
        }
    }
    __syncthreads();

    // horizontal pass: 4 outputs per item; window index k is source
    // column x0 - P + k, output e sits at P + e
    const int g4 = tw / 4;
    const int klo = P - (sh - 1), khi = P + 3 + (sh - 1);
    float tap[P + 1];
#pragma unroll
    for (int off = 0; off <= P; ++off) tap[off] = off < sh ? th_taps[off] : 0.0f;
    for (int i = tid; i < nr * g4; i += NT) {
        const int j = i / g4, x0 = 4 * (i - j * g4);
        const float* srow = s_src + j * sp + x0;
        float win[2 * P + 4];
#pragma unroll
        for (int q = 0; q < (2 * P + 4) / 4; ++q) {
            if (4 * q + 3 >= klo && 4 * q <= khi) {
                const float4 v = *reinterpret_cast<const float4*>(srow + 4 * q);
                win[4 * q] = v.x; win[4 * q + 1] = v.y;
                win[4 * q + 2] = v.z; win[4 * q + 3] = v.w;
            }
        }
        float acc[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            float a = win[P + e] * tap[0];
#pragma unroll
            for (int off = 1; off <= P; ++off)
                if (off < sh)
                    a = a + (win[P + e - off] + win[P + e + off]) * tap[off];
            if (hscale != 1.0f) a = a * hscale;
            acc[e] = a;
        }
        *reinterpret_cast<float4*>(s_h + j * tw + x0) =
            make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
    __syncthreads();

    // vertical pass: VR outputs of one column per item; window index k is
    // buffer row i0 + hv - P + k, output m sits at P + m
    const int groups = th / VR;
    const int vlo = P - hv, vhi = P + VR - 1 + hv;
#pragma unroll
    for (int off = 0; off <= P; ++off) tap[off] = off < sv ? tv_taps[off] : 0.0f;
    for (int i = tid; i < groups * tw; i += NT) {
        const int g = i / tw, x = i - g * tw;
        const int i0 = g * VR;
        const int gx = tx0 + x;
        float win[VR + 2 * P];
#pragma unroll
        for (int k = 0; k < VR + 2 * P; ++k)
            if (k >= vlo && k <= vhi) win[k] = s_h[(i0 + hv - P + k) * tw + x];
#pragma unroll
        for (int m = 0; m < VR; ++m) {
            float a = win[P + m] * tap[0];
#pragma unroll
            for (int off = 1; off <= P; ++off)
                if (off < sv)
                    a = a + (win[P + m - off] + win[P + m + off]) * tap[off];
            const int gy = ty0 + i0 + m;
            if (gy < H && gx < W) {
                const size_t o = static_cast<size_t>(gy) * W + gx;
                out[o] = a;
                if (dog != nullptr)
                    dog[o] = a - s_src[(i0 + m + hv) * sp + x + P];
            }
        }
    }
    __syncthreads();
}

template <int P>
__global__ void __launch_bounds__(kThreads)
sep_blur(const float* src, float* out, float* dog, int H, int W,
         const __grid_constant__ BlurArgs a) {
    extern __shared__ __align__(16) float smem[];
    blur_tile<P, kVRows, kThreads>(
        src, out, dog, H, W, a.h.t, a.h.span, a.v.t, a.v.span, a.hscale,
        a.vec != 0, blockIdx.y * kTileRows, blockIdx.x * kTileCols,
        kTileRows, kTileCols, smem);
}

// One level of the chain on a block's band of rb rows from y0 (R rows a
// band): the horizontal pass of the band into rows P .. P+rb-1 of vb; a
// cluster barrier; the band's span - 1 halo rows of that pass copied into
// the rows above and below from the blocks that hold them (distributed
// shared memory); the vertical pass into the next level's band, the stack
// and the DoG.  vb alternates between two buffers by level, so a block
// that runs ahead writes the other one while its neighbours still copy
// from this one, and one barrier a level suffices.  The arithmetic is
// blur_tile's, in its order.
template <int P, int VR, int NT>
__device__ void chain_level(cg::cluster_group& cluster, const float* cur,
                            float* vb, float* next, float* out, float* dog,
                            int H, int W, int R, int y0, int rb,
                            const float* taps, int span) {
    const int hv = halo_rows(span);
    const int tid = threadIdx.x;
    float tap[P + 1];
#pragma unroll
    for (int off = 0; off <= P; ++off) tap[off] = off < span ? taps[off] : 0.0f;

    // horizontal: 4 outputs per item; window index k is column x0 - P + k
    // (clamped to the row), output e sits at P + e
    const int g4 = (W + 3) / 4;
    const int klo = P - hv, khi = P + 3 + hv;
    const bool vec = W % 4 == 0;
    for (int i = tid; i < rb * g4; i += NT) {
        const int j = i / g4, x0 = 4 * (i - j * g4);
        const float* row = cur + j * W;
        float win[2 * P + 4];
#pragma unroll
        for (int q = 0; q < (2 * P + 4) / 4; ++q) {
            if (4 * q + 3 >= klo && 4 * q <= khi) {
                const int gx = x0 - P + 4 * q;
                if (vec && gx >= 0 && gx + 3 < W) {
                    const float4 v = *reinterpret_cast<const float4*>(row + gx);
                    win[4 * q] = v.x; win[4 * q + 1] = v.y;
                    win[4 * q + 2] = v.z; win[4 * q + 3] = v.w;
                } else {
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        win[4 * q + e] = row[min(max(gx + e, 0), W - 1)];
                }
            }
        }
        float* hrow = vb + (P + j) * W;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            float a = win[P + e] * tap[0];
#pragma unroll
            for (int off = 1; off <= P; ++off)
                if (off < span)
                    a = a + (win[P + e - off] + win[P + e + off]) * tap[off];
            if (x0 + e < W) hrow[x0 + e] = a;
        }
    }
    // every band's horizontal pass is whole
    cluster.sync();

    // halo rows -hv .. -1 and rb .. rb+hv-1 of the band (image rows
    // clamped), from the band rows of the vb of the block that holds them
    const int w4 = vec ? W / 4 : W;
    for (int i = tid; i < 2 * hv * w4; i += NT) {
        const int j = i / w4, c = i - j * w4;
        const int r = j < hv ? j - hv : rb + j - hv;
        const int gy = min(max(y0 + r, 0), H - 1);
        const int owner = gy / R;
        const float* src = cluster.map_shared_rank(vb, owner)
                           + (P + gy - owner * R) * W;
        float* dst = vb + (P + r) * W;
        if (vec)
            reinterpret_cast<float4*>(dst)[c] =
                reinterpret_cast<const float4*>(src)[c];
        else
            dst[c] = src[c];
    }
    __syncthreads();

    // vertical: VR outputs of one column per item; window index k is vb
    // row i0 + k (image row y0 + i0 - P + k), output m sits at P + m; rows
    // outside the band's span - 1 halo feed no output that is stored
    const int groups = (rb + VR - 1) / VR;
    for (int i = tid; i < groups * W; i += NT) {
        const int g = i / W, x = i - g * W;
        const int i0 = g * VR;
        float win[VR + 2 * P];
        const float* col = vb + i0 * W + x;
#pragma unroll
        for (int k = 0; k < VR + 2 * P; ++k) win[k] = col[k * W];
#pragma unroll
        for (int m = 0; m < VR; ++m) {
            if (i0 + m < rb) {
                float a = win[P + m] * tap[0];
#pragma unroll
                for (int off = 1; off <= P; ++off)
                    if (off < span)
                        a = a + (win[P + m - off] + win[P + m + off])
                                * tap[off];
                const int o = (i0 + m) * W + x;
                const size_t go = static_cast<size_t>(y0 + i0 + m) * W + x;
                next[o] = a;
                out[go] = a;
                dog[go] = a - cur[o];
            }
        }
    }
    // the next level's horizontal pass reads this band
    __syncthreads();
}

// The field of a band's rows y0 .. y0+rb-1 at levels 0 .. L-1 of the
// stack, in field (2L, H, W): a warp a row, its lanes along x, KC chunks
// of 32 columns at a time, all their loads before any arithmetic (clamped
// columns: a lane past the row computes a value it does not store).  The
// stack is read through L2 (__ldcg), where the other blocks' writes are.
// K2's expressions in its order.
template <int KC>
__device__ void band_field(const float* stack, float* field, int L, int H,
                           int W, int y0, int rb) {
    const int lane = threadIdx.x & 31;
    const size_t hw = static_cast<size_t>(H) * W;
    for (int r = threadIdx.x >> 5; r < L * rb; r += kChainThreads / 32) {
        const int l = r / rb, gy = y0 + r - l * rb;
        const float* s = stack + l * hw;
        const float* row = s + static_cast<size_t>(gy) * W;
        const float* up = s + static_cast<size_t>(max(gy - 1, 0)) * W;
        const float* dn = s + static_cast<size_t>(min(gy + 1, H - 1)) * W;
        float* mag = field + 2 * l * hw + static_cast<size_t>(gy) * W;
        for (int x0 = lane; x0 - lane < W; x0 += 32 * KC) {
            float r1[KC], r0[KC], d[KC], u[KC];
#pragma unroll
            for (int k = 0; k < KC; ++k) {
                const int x = min(x0 + 32 * k, W - 1);
                r1[k] = __ldcg(row + min(x + 1, W - 1));
                r0[k] = __ldcg(row + max(x - 1, 0));
                d[k] = __ldcg(dn + x);
                u[k] = __ldcg(up + x);
            }
#pragma unroll
            for (int k = 0; k < KC; ++k) {
                const float dx = r1[k] - r0[k];
                const float dy = d[k] - u[k];
                const float m = sqrtf(dx * dx + dy * dy);
                const float t = atan2f(dy, dx);
                const int x = x0 + 32 * k;
                if (x < W) {
                    mag[x] = m;
                    mag[hw + x] = t;
                }
            }
        }
    }
}

template <int P>
__global__ void __launch_bounds__(kChainThreads)
blur_chain(float* stack, float* dog, float* field, int H, int W,
           const __grid_constant__ ChainArgs c) {
    extern __shared__ __align__(16) float smem[];
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = static_cast<int>(cluster.block_rank());
    const size_t hw = static_cast<size_t>(H) * W;
    const int R = c.rows;
    const int y0 = rank * R;
    const int rb = max(0, min(R, H - y0));   // rows of this band
    float* band[2] = {smem, smem + R * W};
    float* vb[2] = {smem + 2 * R * W,
                    smem + 2 * R * W + chain_vb_rows(R, P) * W};
    for (int i = threadIdx.x; i < rb * W; i += kChainThreads)
        band[0][i] = __ldcg(stack + static_cast<size_t>(y0) * W + i);
    __syncthreads();
    for (int l = 1; l < c.levels; ++l)
        chain_level<P, kChainVRows, kChainThreads>(
            cluster, band[(l - 1) & 1], vb[l & 1], band[l & 1],
            stack + l * hw, dog + (l - 1) * hw, H, W, R, y0, rb,
            c.t[l], c.span[l]);
    // no block may leave while another can still copy from its buffers,
    // and every level of every band is in the stack
    cluster.sync();
    if (field == nullptr) return;
    // as many chunks of 32 columns at a time as a row has, up to 4
    if (W <= 32)
        band_field<1>(stack, field, c.levels, H, W, y0, rb);
    else if (W <= 64)
        band_field<2>(stack, field, c.levels, H, W, y0, rb);
    else
        band_field<4>(stack, field, c.levels, H, W, y0, rb);
}

int halo_class(int span) {
    const int need = span - 1;
    return need <= 4 ? 4 : need <= 8 ? 8 : need <= 16 ? 16 : 32;
}

Taps make_taps(const float* taps, int span) {
    Taps tp{};
    tp.span = span;
    for (int k = 0; k < span; ++k) tp.t[k] = taps[k];
    return tp;
}

bool aligned(const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The dynamic shared memory attribute (and, for the chain, the
// non-portable cluster size) of one kernel instance, which CUDA keeps per
// device: granted on each device before its first launch there.
constexpr int kMaxDevices = 64;

struct Grants {
    std::mutex lock;
    bool done[kMaxDevices] = {};
};

template <typename K>
int grant(Grants& g, K kernel, int smem, bool cluster) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 0 || dev >= kMaxDevices)
        return static_cast<int>(cudaErrorInvalidDevice);
    std::lock_guard<std::mutex> guard(g.lock);
    if (g.done[dev]) return 0;
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess && cluster)
        e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e == cudaSuccess) g.done[dev] = true;
    return static_cast<int>(e);
}

template <int P>
int launch_blur(const float* src, float* out, float* dog, int H, int W,
                const BlurArgs& a, cudaStream_t s) {
    const int smem =
        4 * tile_smem_floats(kTileRows, kTileCols, P, a.v.span);
    const int most =
        4 * tile_smem_floats(kTileRows, kTileCols, P, P + 1);
    static Grants grants;
    const int granted = grant(grants, sep_blur<P>, most, false);
    if (granted != 0) return granted;
    const dim3 grid((W + kTileCols - 1) / kTileCols,
                    (H + kTileRows - 1) / kTileRows);
    sep_blur<P><<<grid, kThreads, smem, s>>>(src, out, dog, H, W, a);
    return psk::status();
}

template <int P>
int launch_chain(float* stack, float* dog, float* field, int H, int W,
                 ChainArgs& c, cudaStream_t s) {
    const ChainBands b = chain_bands(H);
    const int smem = 4 * chain_smem_floats(b.rows, W, P);
    if (smem > kChainSmem) return static_cast<int>(cudaErrorInvalidValue);
    static Grants grants;
    const int granted = grant(grants, blur_chain<P>, kChainSmem, true);
    if (granted != 0) return granted;
    c.rows = b.rows;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(b.blocks);
    cfg.blockDim = dim3(kChainThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = b.blocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e =
        cudaLaunchKernelEx(&cfg, blur_chain<P>, stack, dog, field, H, W, c);
    if (e != cudaSuccess) return static_cast<int>(e);
    return psk::status();
}

}  // namespace

// out = blur_v(hscale * blur_h(src)); dog (may be null) = out - src.
// taps_h / taps_v are host arrays of at least span_h / span_v floats.
PSK_API int psk_sep_blur(const float* src, float* out, float* dog, int H,
                         int W, const float* taps_h, int span_h,
                         const float* taps_v, int span_v, float hscale,
                         void* stream) {
    if (span_h < 1 || span_h > kMaxSpan || span_v < 1 || span_v > kMaxSpan)
        return static_cast<int>(cudaErrorInvalidValue);
    if (H < 1 || W < 1) return 0;
    BlurArgs a{};
    a.h = make_taps(taps_h, span_h);
    a.v = make_taps(taps_v, span_v);
    a.hscale = hscale;
    a.vec = W % 4 == 0 && aligned(src);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (halo_class(max(span_h, span_v))) {
        case 4: return launch_blur<4>(src, out, dog, H, W, a, s);
        case 8: return launch_blur<8>(src, out, dog, H, W, a, s);
        case 16: return launch_blur<16>(src, out, dog, H, W, a, s);
        default: return launch_blur<32>(src, out, dog, H, W, a, s);
    }
}

// stack: (levels, H, W) with level 0 written; dog: (levels - 1, H, W);
// field (may be null): (2 levels, H, W).  Level l >= 1 = the blur of level
// l - 1 by taps[l] (spans[l] taps, both directions), dog[l - 1] = level l
// - level l-1, field[2l] and field[2l + 1] = K2's mag and theta of level
// l.  taps: levels x 32 host floats, spans: levels host ints (index 0
// unused).
PSK_API int psk_blur_chain(float* stack, float* dog, float* field,
                           int levels, int H, int W, const float* taps,
                           const int* spans, void* stream) {
    if (levels < 2 || levels > kMaxLevels)
        return static_cast<int>(cudaErrorInvalidValue);
    if (H < 1 || W < 1) return 0;
    ChainArgs c{};
    c.levels = levels;
    int widest = 1;
    for (int l = 1; l < levels; ++l) {
        if (spans[l] < 1 || spans[l] > kMaxSpan)
            return static_cast<int>(cudaErrorInvalidValue);
        c.span[l] = spans[l];
        for (int k = 0; k < spans[l]; ++k) c.t[l][k] = taps[l * kMaxSpan + k];
        widest = max(widest, spans[l]);
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (halo_class(widest)) {
        case 4: return launch_chain<4>(stack, dog, field, H, W, c, s);
        case 8: return launch_chain<8>(stack, dog, field, H, W, c, s);
        case 16: return launch_chain<16>(stack, dog, field, H, W, c, s);
        default: return launch_chain<32>(stack, dog, field, H, W, c, s);
    }
}

PSK_API const char* psk_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
