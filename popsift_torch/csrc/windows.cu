// K8: batched window gather with clamp addressing.  Window i is the
// (wy, wx) block of plane[lpos[i]] whose top-left corner is (ya[i], xa[i]);
// positions outside the (H, W) plane read the nearest edge pixel.
//
// Replaces popsift_tpu/kernels/windows2.py:gather_windows_exact
// (gather_windows_rolled_pallas, exact x origin, (win_y, 128) windows) and
// popsift_tpu/kernels/windows.py:gather_windows_aligned
// (gather_windows_aligned_pallas, (8, 128)-aligned origins): the two are
// the same copy with other origins and extents, so one kernel serves both.
// The JAX callers edge-pad the whole stack first (pad 120 rows and 256
// columns); clamped addressing gives the same values from the unpadded
// plane, so the padded copy is never written.
//
// Bound on the H100: device-memory bytes (one read of each distinct source
// pixel, one write of each window pixel; no arithmetic).  Design: one
// block per window, 32 x 8 threads; a warp reads and writes 32
// neighbouring floats of one row, and rows of neighbouring windows that
// overlap are re-read from L2.
#include "common.cuh"

namespace {

__global__ void gather_windows(const float* __restrict__ plane, int H,
                               int W, const int* __restrict__ lpos,
                               const int* __restrict__ ya,
                               const int* __restrict__ xa, int wy, int wx,
                               float* __restrict__ out) {
    const int i = blockIdx.x;
    const float* src = plane + static_cast<size_t>(lpos[i]) * H * W;
    const int y0 = ya[i];
    const int x0 = xa[i];
    float* dst = out + static_cast<size_t>(i) * wy * wx;
    for (int r = threadIdx.y; r < wy; r += blockDim.y) {
        const int y = min(max(y0 + r, 0), H - 1);
        const float* row = src + static_cast<size_t>(y) * W;
        for (int c = threadIdx.x; c < wx; c += blockDim.x)
            dst[r * wx + c] = row[min(max(x0 + c, 0), W - 1)];
    }
}

}  // namespace

// plane: (L, H, W); lpos, ya, xa: (n,) i32 (lpos already clamped to
// 0..L-1); out: (n, wy, wx).
PSK_API int psk_gather_windows(const float* plane, int H, int W,
                               const int* lpos, const int* ya,
                               const int* xa, int n, int wy, int wx,
                               float* out, void* stream) {
    const dim3 block(32, 8);
    gather_windows<<<n, block, 0, static_cast<cudaStream_t>(stream)>>>(
        plane, H, W, lpos, ya, xa, wy, wx, out);
    return psk::status();
}
