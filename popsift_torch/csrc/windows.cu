// K8: batched window gather with clamp addressing.  Window i is the
// (wy, wx) block of plane[lpos[i]] whose top-left corner is (ya[i], xa[i]);
// positions outside the (H, W) plane read the nearest edge pixel.
//
// Replaces popsift_tpu/kernels/windows2.py:gather_windows_exact
// (gather_windows_rolled_pallas, the pallas_call at windows2.py:76: exact
// x origin, (win_y, 128) windows) and popsift_tpu/kernels/windows.py:
// gather_windows_aligned (gather_windows_aligned_pallas, the pallas_call at
// windows.py:106: (8, 128)-aligned origins, (win_y, 128 k) windows): the
// same copy with other origins and extents, so one kernel serves both.
// The JAX callers edge-pad the whole stack first (pad 120 rows and 256
// columns); clamped addressing gives the same values from the unpadded
// plane, so the padded copy is never written.
//
// Bound on the H100: device-memory bytes, with no arithmetic.  The
// windows it writes are about 90% (exact) and 95% (aligned) of its
// compulsory bytes, and the stack of a descriptor octave at 1080p (12 MB
// at octave 2) stays in the 50 MB L2, so the writes bound it.  Design:
// - a work item is a band of kRows rows by a 128-column chunk of one
//   window; a warp takes an equal run of consecutive items, and the grid
//   holds no more warps than the card keeps resident at once, so it runs
//   in one wave with no tail;
// - a lane moves 4 columns of kRows rows: all its loads, then 16-byte
//   streaming stores (st.global.cs), so a warp writes a 512-byte row
//   chunk per instruction and the stores do not push the stack, which
//   neighbouring windows read again, out of L2;
// - an item inside the plane reads with no clamp, an item across the
//   plane's edge or outside it clamps each row and column (one kernel,
//   two instances of load_band).  Reads are 4-byte __ldg's, a warp's
//   four load instructions covering the same 512 bytes: an exact origin
//   is not 16-byte aligned in general, and reading the covering aligned
//   float4s and shifting them into place by warp shuffles took 128
//   registers against 64 and was 5-9% slower on the H100 (PERF.md, K8).
//   Output rows whose width is not a multiple of 4 take 4-byte stores.
#include "common.cuh"

#include <atomic>

namespace {

constexpr int kWarps = 8;    // warps a block
constexpr int kRows = 8;     // rows of a work item
constexpr int kChunk = 128;  // columns of a work item: 32 lanes x 4

// Columns x..x+3 of rows y0..y0+nr-1 of one level, clamped to the plane
// where kClamp is set (a band across the plane's edge or outside it).
template <bool kClamp>
__device__ __forceinline__ void load_band(const float* __restrict__ src,
                                          int H, int W, int y0, int x,
                                          int nr, float (&e)[kRows][4]) {
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
        if (k < nr) {
            const int y = kClamp ? min(max(y0 + k, 0), H - 1) : y0 + k;
            const float* row = src + static_cast<size_t>(y) * W;
#pragma unroll
            for (int j = 0; j < 4; ++j)
                e[k][j] = __ldg(row + (kClamp ? min(max(x + j, 0), W - 1)
                                              : x + j));
        }
    }
}

__global__ void __launch_bounds__(kWarps * 32)
gather_windows(const float* __restrict__ plane, int H, int W,
               const int* __restrict__ lpos, const int* __restrict__ ya,
               const int* __restrict__ xa, int wy, int wx, int bands,
               int chunks, int items, int per_warp,
               float* __restrict__ out) {
    const int lane = threadIdx.x & 31;
    const long long start =
        (static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5))
        * per_warp;
    if (start >= items) return;
    const int first = static_cast<int>(start);
    const int last = static_cast<int>(min(start + per_warp,
                                          static_cast<long long>(items)));
    const bool vec = (wx & 3) == 0;  // output rows are 16-byte aligned
    const int c = 4 * lane;          // this lane's first column of a chunk
    // the first item's (window, band, chunk); later items step through them
    int chunk = first % chunks;
    int band = (first / chunks) % bands;
    int i = first / chunks / bands;
    for (int t = first; t < last; ++t) {
        const int r0 = band * kRows;
        const int c0 = chunk * kChunk;
        const int nr = min(kRows, wy - r0);
        const int nc = min(kChunk, wx - c0);
        const int y0 = __ldg(ya + i) + r0;
        const int x0 = __ldg(xa + i) + c0;
        const float* src =
            plane + static_cast<size_t>(__ldg(lpos + i)) * H * W;
        float* dst = out + (static_cast<size_t>(i) * wy + r0) * wx + c0;
        if (c < nc) {
            float e[kRows][4];
            if (vec && y0 >= 0 && y0 + nr <= H && x0 >= 0 && x0 + nc <= W)
                load_band<false>(src, H, W, y0, x0 + c, nr, e);
            else
                load_band<true>(src, H, W, y0, x0 + c, nr, e);
#pragma unroll
            for (int k = 0; k < kRows; ++k) {
                if (k < nr) {
                    float* d = dst + static_cast<size_t>(k) * wx + c;
                    if (vec) {
                        __stcs(reinterpret_cast<float4*>(d),
                               make_float4(e[k][0], e[k][1], e[k][2],
                                           e[k][3]));
                    } else {
#pragma unroll
                        for (int j = 0; j < 4; ++j)
                            if (c + j < nc) __stcs(d + j, e[k][j]);
                    }
                }
            }
        }
        if (++chunk == chunks) {
            chunk = 0;
            if (++band == bands) {
                band = 0;
                ++i;
            }
        }
    }
}

}  // namespace

// plane: (L, H, W); lpos, ya, xa: (n,) i32 (lpos already clamped to
// 0..L-1); out: (n, wy, wx).
PSK_API int psk_gather_windows(const float* plane, int H, int W,
                               const int* lpos, const int* ya,
                               const int* xa, int n, int wy, int wx,
                               float* out, void* stream) {
    const int bands = (wy + kRows - 1) / kRows;
    const int chunks = (wx + kChunk - 1) / kChunk;
    const long long items = static_cast<long long>(n) * bands * chunks;
    if (n <= 0 || wy <= 0 || wx <= 0) return 0;
    if (items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    // the warps this device keeps resident at once, asked once a device
    static std::atomic<int> resident[64];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
    int warps = resident[dev].load(std::memory_order_relaxed);
    if (warps == 0) {
        int sms = 0, per_sm = 0;
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
        if (err != cudaSuccess) return static_cast<int>(err);
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, gather_windows, kWarps * 32, 0);
        if (err != cudaSuccess) return static_cast<int>(err);
        warps = max(sms * per_sm, 1) * kWarps;
        resident[dev].store(warps, std::memory_order_relaxed);
    }
    // as few items a warp as lets the resident warps take them all, and
    // only the warps that this needs: one wave
    const int per_warp = static_cast<int>((items + warps - 1) / warps);
    const long long used = (items + per_warp - 1) / per_warp;
    const int blocks = static_cast<int>((used + kWarps - 1) / kWarps);
    gather_windows<<<blocks, kWarps * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        plane, H, W, lpos, ya, xa, wy, wx, bands, chunks,
        static_cast<int>(items), per_warp, out);
    return psk::status();
}
