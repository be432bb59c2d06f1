// K3: dense DoG extremum mask - strict 26-neighbour test, the SiftMode
// contrast gate and the border exclusion.
//
// Replaces popsift_tpu/kernels/detect.py:detect_pallas and
// detect_packed_pallas (_kernel).  The bit-packed word layout there is a
// TPU artefact (sublane packing for compact_words); this kernel writes one
// byte per voxel and the compaction stays in PyTorch (nonzero() keeps the
// raster order).
//
// Bound on the H100: device-memory bytes.  The compulsory traffic is one
// read of each of the levels + 2 DoG planes and one mask byte written per
// voxel of the levels mask layers (23 B per pixel at 3 levels; 0.057 ms at
// 3840x2160); the test is about 56 operations per voxel, far below the
// card's rate.  A thread per voxel that loads its 27 values is bound by
// load issue instead (27 requests per voxel and layer, each plane fetched
// by the blocks of three layers).
//
// Design: a warp owns a strip of columns over a segment of rows and slides
// down it.  Its lanes hold 2 adjacent columns each; lanes 0 and 31 only
// load the strip's halo columns, so strips overlap by two lanes and the
// neighbour columns of every output come from the next lanes by shuffles.
// At each row step the warp loads the new row of every DoG plane of its
// group of up to three mask layers (one layer and one row a warp on a
// plane too small to fill the card), once, by cp.async (8 bytes a lane
// where rows are aligned) into a ring of four rows in shared memory, three
// rows ahead of the row it works on: the loads in flight take no
// registers, and a lane reads back only what it copied itself.  The 3x3x3
// test is separable with the centre excluded exactly: per plane and row
// the 3-wide max and min (and, for the centre row of the centre plane, the
// max and min of its two side values); a layer keeps the partial max/min
// over the rows it has seen and finishes it when the row below arrives.  Max and min are exact in any order, so
// the mask is bit-equal to detect_plain's, ties and signed zeros included.
// A lane stores its two mask bytes of a row as one 16-bit word where the
// row is aligned.  Every mask byte, border included, is written once.
#include "common.cuh"

namespace {

constexpr int kCols = 2;                 // columns of a lane
constexpr int kStrip = 30 * kCols;       // output columns of a warp
constexpr int kWarps = 4;                // strips of a block
constexpr int kGroup = 3;                // the most mask layers of a warp
constexpr int kPlanes = kGroup + 2;      // DoG planes they read
constexpr unsigned kFull = 0xffffffffu;

constexpr int kRing = 4;                 // rows of a warp's ring

struct Raw {
    float v[kCols];
};

__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         int bytes) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    if (bytes == 8)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                     :: "r"(d), "l"(src));
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                     :: "r"(d), "l"(src));
}

// Start the copy of row r (clamped) of one plane at the lane's columns
// x .. x+1 (clamped to the row; those past the edge only feed the masked
// border columns) into the lane's two floats of a ring slot.
template <bool kVec>
__device__ __forceinline__ void issue_row(float* slot, const float* plane,
                                          int r, int H, int W, int x) {
    const float* row =
        plane + static_cast<size_t>(min(max(r, 0), H - 1)) * W;
    if (kVec) {
        cp_async(slot, row + min(max(x, 0), W - kCols), 8);
    } else {
        cp_async(slot, row + min(max(x, 0), W - 1), 4);
        cp_async(slot + 1, row + min(max(x + 1, 0), W - 1), 4);
    }
}

template <bool kVec>
__global__ void __launch_bounds__(32 * kWarps, 4)
detect(const float* __restrict__ dog, uint8_t* __restrict__ mask,
       int levels, int H, int W, float gate, int border, int seg,
       int group) {
    const int lane = threadIdx.x;
    const int strip = blockIdx.x * kWarps + threadIdx.y;
    if (strip * kStrip >= W) return;  // the whole warp
    // lane 0 holds the strip's left halo columns, lane 31 its right ones
    const int x = strip * kStrip + (lane - 1) * kCols;
    const bool store = lane >= 1 && lane <= 30 && x < W;
    const int z0 = blockIdx.z * group;
    const int nz = min(group, levels - z0);
    const int np = nz + 2;
    const int ys = blockIdx.y * seg;
    const int ye = min(ys + seg, H);
    const size_t hw = static_cast<size_t>(H) * W;
    const float* planes = dog + z0 * hw;

    // per plane, the 3-wide max/min of the row above the newest one
    float ox[kPlanes][kCols], on[kPlanes][kCols];
    // per layer, the pending row's centre value and its partial max/min
    // over the two rows seen so far
    float cv[kGroup][kCols], mx[kGroup][kCols], mn[kGroup][kCols];
#pragma unroll
    for (int p = 0; p < kPlanes; ++p)
#pragma unroll
        for (int j = 0; j < kCols; ++j) ox[p][j] = on[p][j] = 0.0f;
#pragma unroll
    for (int z = 0; z < kGroup; ++z)
#pragma unroll
        for (int j = 0; j < kCols; ++j) cv[z][j] = mx[z][j] = mn[z][j] = 0.0f;

    bool colok[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j)
        colok[j] = x + j >= border && x + j < W - border;

    // the ring: row r of the segment's rows ys-1 .. ye in slot
    // (r - ys + 1) % kRing; rows ys-1 .. ys+1 are started here, and each
    // step starts the row kRing - 1 below its own (an empty group past ye)
    __shared__ __align__(16) float ring[kWarps][kRing][kPlanes][32 * kCols];
    float(*wring)[kPlanes][32 * kCols] = ring[threadIdx.y];
    for (int k = 0; k < kRing - 1; ++k) {
#pragma unroll
        for (int p = 0; p < kPlanes; ++p)
            if (p < np)
                issue_row<kVec>(&wring[k][p][kCols * lane], planes + p * hw,
                                ys - 1 + k, H, W, x);
        asm volatile("cp.async.commit_group;\n" ::);
    }
    // row r arrives: row r-1 (when r-1 >= ys) is finished and stored, and
    // row r becomes the pending row (when r >= ys)
    for (int r = ys - 1; r <= ye; ++r) {
        const int ahead = r + kRing - 1;
        if (ahead <= ye) {
            const int k = (ahead - ys + 1) % kRing;
#pragma unroll
            for (int p = 0; p < kPlanes; ++p)
                if (p < np)
                    issue_row<kVec>(&wring[k][p][kCols * lane],
                                    planes + p * hw, ahead, H, W, x);
        }
        asm volatile("cp.async.commit_group;\n" ::);
        asm volatile("cp.async.wait_group %0;\n" :: "n"(kRing - 1));
        Raw cur[kPlanes];
        const int k = (r - ys + 1) % kRing;
#pragma unroll
        for (int p = 0; p < kPlanes; ++p) {
            const float2 q =
                *reinterpret_cast<const float2*>(&wring[k][p][kCols * lane]);
            cur[p].v[0] = q.x;
            cur[p].v[1] = q.y;
        }
        float nx[kPlanes][kCols], nn[kPlanes][kCols];
        float px[kPlanes][kCols], pn[kPlanes][kCols];
#pragma unroll
        for (int p = 0; p < kPlanes; ++p) {
            if (p < np) {
                const float* v = cur[p].v;
                const float left = __shfl_up_sync(kFull, v[kCols - 1], 1);
                const float right = __shfl_down_sync(kFull, v[0], 1);
#pragma unroll
                for (int j = 0; j < kCols; ++j) {
                    const float l = j == 0 ? left : v[j - 1];
                    const float rr = j == kCols - 1 ? right : v[j + 1];
                    px[p][j] = fmaxf(l, rr);
                    pn[p][j] = fminf(l, rr);
                    nx[p][j] = fmaxf(px[p][j], v[j]);
                    nn[p][j] = fminf(pn[p][j], v[j]);
                }
            }
            if (p < 2) continue;
            const int z = p - 2;   // centre plane p - 1
            if (z >= nz) continue;
            const int y = r - 1;
            if (y >= ys) {
                const bool rowok = y >= border && y < H - border;
                uint32_t word = 0;
#pragma unroll
                for (int j = 0; j < kCols; ++j) {
                    const float fx = fmaxf(fmaxf(mx[z][j], nx[p - 2][j]),
                                           fmaxf(nx[p - 1][j], nx[p][j]));
                    const float fn = fminf(fminf(mn[z][j], nn[p - 2][j]),
                                           fminf(nn[p - 1][j], nn[p][j]));
                    const float v = cv[z][j];
                    const bool m = rowok && colok[j] && (v > fx || v < fn)
                                   && fabsf(v) >= gate;
                    word |= static_cast<uint32_t>(m) << (8 * j);
                }
                if (store) {
                    uint8_t* out = mask + (z0 + z) * hw
                                   + static_cast<size_t>(y) * W + x;
                    if (kVec) {
                        *reinterpret_cast<uint16_t*>(out) =
                            static_cast<uint16_t>(word);
                    } else {
#pragma unroll
                        for (int j = 0; j < kCols; ++j)
                            if (x + j < W)
                                out[j] = static_cast<uint8_t>(word >> (8 * j));
                    }
                }
            }
            if (r >= ys && r < ye) {
#pragma unroll
                for (int j = 0; j < kCols; ++j) {
                    mx[z][j] = fmaxf(
                        fmaxf(fmaxf(ox[p - 2][j], ox[p - 1][j]), ox[p][j]),
                        fmaxf(fmaxf(nx[p - 2][j], nx[p][j]), px[p - 1][j]));
                    mn[z][j] = fminf(
                        fminf(fminf(on[p - 2][j], on[p - 1][j]), on[p][j]),
                        fminf(fminf(nn[p - 2][j], nn[p][j]), pn[p - 1][j]));
                    cv[z][j] = cur[p - 1].v[j];
                }
            }
        }
#pragma unroll
        for (int p = 0; p < kPlanes; ++p)
            if (p < np) {
#pragma unroll
                for (int j = 0; j < kCols; ++j) {
                    ox[p][j] = nx[p][j];
                    on[p][j] = nn[p][j];
                }
            }
    }
}

}  // namespace

// dog: (levels + 2, H, W); mask: (levels, H, W) bytes.  ``seg`` is the
// rows of a warp's segment and ``group`` (1..3) its mask layers
// (kernels/detect.py:detect_plan).
PSK_API int psk_detect(const float* dog, uint8_t* mask, int levels, int H,
                       int W, float gate, int border, int seg, int group,
                       void* stream) {
    if (group < 1 || group > kGroup)
        return static_cast<int>(cudaErrorInvalidValue);
    if (levels < 1 || H < 1 || W < 1 || seg < 1) return 0;
    const dim3 block(32, kWarps);
    const int strips = (W + kStrip - 1) / kStrip;
    const dim3 grid((strips + kWarps - 1) / kWarps, (H + seg - 1) / seg,
                    (levels + group - 1) / group);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool vec = W % kCols == 0
                     && reinterpret_cast<uintptr_t>(dog) % 8 == 0
                     && reinterpret_cast<uintptr_t>(mask) % 2 == 0;
    if (vec)
        detect<true><<<grid, block, 0, s>>>(dog, mask, levels, H, W, gate,
                                            border, seg, group);
    else
        detect<false><<<grid, block, 0, s>>>(dog, mask, levels, H, W, gate,
                                             border, seg, group);
    return psk::status();
}
