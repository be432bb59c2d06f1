// K3: dense DoG extremum mask - strict 26-neighbour test, the SiftMode
// contrast gate and the border exclusion.
//
// Replaces popsift_tpu/kernels/detect.py:detect_pallas and
// detect_packed_pallas (_kernel).  The bit-packed word layout there is a
// TPU artefact (sublane packing for compact_words); this kernel writes one
// byte per voxel and the compaction stays in PyTorch (nonzero() keeps the
// raster order).
//
// Bound on the H100: device-memory bytes (levels+2 DoG planes read once,
// one mask byte written per searchable voxel; ~55 compares per voxel).
// Simple design: one thread per (layer, y, x); the 26 neighbour reads are
// coalesced along x and come back from L1/L2, so DRAM traffic stays near
// one read of each plane.
#include "common.cuh"

namespace {

__global__ void detect(const float* __restrict__ dog,
                       uint8_t* __restrict__ mask, int H, int W, float gate,
                       int border) {
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    const int z = blockIdx.z;  // mask layer; DoG layer z + 1
    if (x >= W || y >= H) return;
    const size_t hw = static_cast<size_t>(H) * W;
    uint8_t m = 0;
    if (x >= border && x < W - border && y >= border && y < H - border) {
        const float* c = dog + (z + 1) * hw;
        const float v = c[static_cast<size_t>(y) * W + x];
        float mx = -INFINITY;
        float mn = INFINITY;
        for (int dz = -1; dz <= 1; ++dz) {
            const float* p = c + dz * static_cast<long long>(hw);
            for (int dy = -1; dy <= 1; ++dy) {
                const float* r = p + static_cast<size_t>(y + dy) * W + x;
                for (int dx = -1; dx <= 1; ++dx) {
                    if (dz == 0 && dy == 0 && dx == 0) continue;
                    const float nb = r[dx];
                    mx = fmaxf(mx, nb);
                    mn = fminf(mn, nb);
                }
            }
        }
        m = ((v > mx) || (v < mn)) && (fabsf(v) >= gate);
    }
    mask[z * hw + static_cast<size_t>(y) * W + x] = m;
}

}  // namespace

// dog: (levels + 2, H, W); mask: (levels, H, W) bytes.
PSK_API int psk_detect(const float* dog, uint8_t* mask, int levels, int H,
                       int W, float gate, int border, void* stream) {
    const dim3 block(32, 8);
    const dim3 grid((W + 31) / 32, (H + 7) / 8, levels);
    detect<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        dog, mask, H, W, gate, border);
    return psk::status();
}
