// K2: interleaved gradient field [mag_0; theta_0; mag_1; ...] of a blurred
// stack, central differences with clamp addressing.
//
// Replaces popsift_tpu/kernels/grad.py:gradient_field_fused
// (_grad_kernel).  The Pallas kernel needs a polynomial atan2 because
// Mosaic has none; here atan2f is the CUDA maths library's, and the field
// is unpadded (2L, H, W).
//
// Bound on the H100: device-memory bytes (4 bytes read and 8 written per
// pixel and level for ~30 flops).  Simple design: one thread per pixel
// and level; the four neighbour reads are coalesced along x and re-read
// from L1/L2, so traffic stays near the byte floor.
#include "common.cuh"

namespace {

__global__ void grad_field(const float* __restrict__ stack,
                           float* __restrict__ field, int H, int W) {
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    const int l = blockIdx.z;
    if (x >= W || y >= H) return;
    const size_t hw = static_cast<size_t>(H) * W;
    const float* s = stack + l * hw;
    const size_t row = static_cast<size_t>(y) * W;
    const float dx = s[row + min(x + 1, W - 1)] - s[row + max(x - 1, 0)];
    const float dy = s[static_cast<size_t>(min(y + 1, H - 1)) * W + x]
                     - s[static_cast<size_t>(max(y - 1, 0)) * W + x];
    field[2 * l * hw + row + x] = sqrtf(dx * dx + dy * dy);
    field[(2 * l + 1) * hw + row + x] = atan2f(dy, dx);
}

}  // namespace

PSK_API int psk_grad_field(const float* stack, float* field, int L, int H,
                           int W, void* stream) {
    const dim3 block(32, 8);
    const dim3 grid((W + 31) / 32, (H + 7) / 8, L);
    grad_field<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        stack, field, H, W);
    return psk::status();
}
