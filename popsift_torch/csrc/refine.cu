// K4: sub-voxel Newton refinement of DoG extremum candidates, the whole
// loop of popsift_tpu/ops/extrema.py:refine_extrema_multi in one thread
// per candidate.
//
// Replaces popsift_tpu/kernels/refine.py:gather27 and
// kernels/refine_batch.py:gather27_batch_pallas, which only fetch the
// 3x3x3 neighbourhood per Newton iteration and leave the solve and the
// per-mode step rule to XLA.  Here each thread reads its neighbourhood
// straight from the DoG (with gather27's clamps, refine.py:147-149: the
// centre is clamped into the (Hp, Wp) edge-padded volume whose surplus
// replicates the last true row/column), runs up to 5 iterations of the
// _solve3 closed form and the PopSift/VLFeat/OpenCV step rule (no move on
// the last iteration), then the signed 1.5 px rejection, verify(), the
// contrast and the edge tests.  Every expression keeps the JAX package's
// operation order; with --fmad=false the results match the element-wise
// PyTorch version bit for bit (powf aside).
//
// Bound on the H100: latency.  The data are tiny (27 floats per candidate
// per iteration, a few thousand candidates per octave) and the loop is
// serial per candidate, so the kernel is a single short wave; the
// gathered reads are uncoalesced but hit L2.  Simple design: one thread
// per candidate, 128 threads per block.
#include "common.cuh"

namespace {

constexpr int kMaxIterations = 5;  // s_extrema.cu:362

struct Params {
    int H, W;         // true octave dims
    int Hp, Wp;       // dims of the volume gather27 clamps into
    int n_layers;     // DoG layers (== maxlevel)
    int mode;         // 0 PopSift, 1 OpenCV, 2 VLFeat
    float sigma0, sigma_k;
    float contr_thr;  // f32(2 * peak_threshold)
    float edge_thr;   // f32((r + 1)^2 / r)
    float gwd, ghd;   // grid cell width / height
    int grid_width;
};

__device__ inline float at(const float* __restrict__ dog, const Params& p,
                           int z, int y, int x) {
    return dog[(static_cast<size_t>(z) * p.H + min(y, p.H - 1)) * p.W
               + min(x, p.W - 1)];
}

__global__ void refine(const float* __restrict__ dog,
                       const int* __restrict__ cx, const int* __restrict__ cy,
                       const int* __restrict__ cz, int n, Params p,
                       float* __restrict__ xn_o, float* __restrict__ yn_o,
                       int* __restrict__ lpos_o, float* __restrict__ sigma_o,
                       int* __restrict__ cell_o, uint8_t* __restrict__ ok_o) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const bool opencv = p.mode == 1;
    const bool vlfeat = p.mode == 2;

    int nx = cx[i], ny = cy[i], nz = cz[i];
    float v = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
    float Dx = 0.f, Dy = 0.f, Dz = 0.f, DDx = 0.f, DDy = 0.f, DDz = 0.f;
    float DXx = 0.f, DXy = 0.f, DXz = 0.f;
    bool done = false, failed = false;
    int done_iter = kMaxIterations + 1;

    for (int it = 1; it <= kMaxIterations && !done && !failed; ++it) {
        const int z = min(max(nz, 1), p.n_layers - 2);
        const int y = min(max(ny, 1), p.Hp - 2);
        const int x = min(max(nx, 1), p.Wp - 2);
        float w[3][3][3];
        for (int a = 0; a < 3; ++a)
            for (int b = 0; b < 3; ++b)
                for (int c = 0; c < 3; ++c)
                    w[a][b][c] = at(dog, p, z + a - 1, y + b - 1, x + c - 1);
#define P(a, b, c) w[1 + (a)][1 + (b)][1 + (c)]
        if (it == 1) v = P(0, 0, 0);
        const float nDx = 0.5f * (P(0, 0, 1) - P(0, 0, -1));
        const float nDy = 0.5f * (P(0, 1, 0) - P(0, -1, 0));
        const float nDz = 0.5f * (P(1, 0, 0) - P(-1, 0, 0));
        const float c = P(0, 0, 0);
        const float nDDx = P(0, 0, 1) + P(0, 0, -1) - 2.0f * c;
        const float nDDy = P(0, 1, 0) + P(0, -1, 0) - 2.0f * c;
        const float nDDz = P(1, 0, 0) + P(-1, 0, 0) - 2.0f * c;
        const float nDXx = 0.25f * (P(0, 1, 1) + P(0, -1, -1)
                                    - P(0, 1, -1) - P(0, -1, 1));
        const float nDXy = 0.25f * (P(1, 0, 1) + P(-1, 0, -1)
                                    - P(1, 0, -1) - P(-1, 0, 1));
        const float nDXz = 0.25f * (P(1, 1, 0) + P(-1, -1, 0)
                                    - P(1, -1, 0) - P(-1, 1, 0));
#undef P
        // _solve3 (s_solve.h:25-86) with A = [[DDx, DXx, DXy],
        // [DXx, DDy, DXz], [DXy, DXz, DDz]] and b = -(Dx, Dy, Dz)
        const float A00 = nDDx, A01 = nDXx, A02 = nDXy;
        const float A11 = nDDy, A12 = nDXz, A22 = nDDz;
        const float bx = -nDx, by = -nDy, bz = -nDz;
        const float det0 = A11 * A22 - A12 * A12;
        const float det1 = A12 * A02 - A01 * A22;
        const float det2 = A01 * A12 - A11 * A02;
        const float det3 = A00 * A22 - A02 * A02;
        const float det4 = A01 * A02 - A00 * A12;
        const float det5 = A00 * A11 - A01 * A01;
        const float det = A00 * det0 + A01 * det1 + A02 * det2;
        const bool sok = det != 0.0f;
        const float rsd = sok ? 1.0f / det : 0.0f;
        const float i00 = det0 * rsd, i01 = det1 * rsd, i02 = det2 * rsd;
        const float i11 = det3 * rsd, i12 = det4 * rsd, i22 = det5 * rsd;
        const float sx = sok ? i00 * bx + i01 * by + i02 * bz : 0.0f;
        const float sy = sok ? i01 * bx + i11 * by + i12 * bz : 0.0f;
        const float sz = sok ? i02 * bx + i12 * by + i22 * bz : 0.0f;
        const bool solve_break = !sok;
        const bool last_it = it == kMaxIterations;

        bool new_done, new_fail = false;
        int nnx = nx, nny = ny, nnz = nz;
        if (opencv) {
            const bool conv = fabsf(sx) < 0.5f && fabsf(sy) < 0.5f
                              && fabsf(sz) < 0.5f;
            const int mx = nx + static_cast<int>(rintf(sx));
            const int my = ny + static_cast<int>(rintf(sy));
            const int mz = nz + static_cast<int>(rintf(sz));
            const bool oob = mx < 5 || mx >= p.W - 5 || my < 5
                             || my >= p.H - 5 || mz < 1
                             || mz > p.n_layers - 2;
            new_done = conv || solve_break;
            new_fail = !solve_break && !conv && oob;
            if (!conv && !solve_break) {
                nnx = mx;
                nny = my;
                nnz = mz;
            }
        } else {
            const int tx = ((sx >= 0.6f && nx < p.W - 2) ? 1 : 0)
                           + ((sx <= -0.6f && nx > 1) ? -1 : 0);
            const int ty = ((sy >= 0.6f && ny < p.H - 2) ? 1 : 0)
                           + ((sy <= -0.6f && ny > 1) ? -1 : 0);
            const int tz = vlfeat ? 0
                           : ((sz >= 0.6f && nz < p.n_layers - 1) ? 1 : 0)
                             + ((sz <= -0.6f && nz > 1) ? -1 : 0);
            const bool no_move = tx == 0 && ty == 0 && tz == 0;
            new_done = solve_break || (!last_it && no_move);
            if (!solve_break && !last_it && !no_move) {
                nnx = nx + tx;
                nny = ny + ty;
                nnz = nz + tz;
            }
        }
        nx = nnx;
        ny = nny;
        nz = nnz;
        dx = sx; dy = sy; dz = sz;
        Dx = nDx; Dy = nDy; Dz = nDz;
        DDx = nDDx; DDy = nDDy; DDz = nDDz;
        DXx = nDXx; DXy = nDXy; DXz = nDXz;
        if (new_done) {
            done = true;
            done_iter = it;
        }
        if (new_fail) failed = true;
    }

    bool ok = !failed;
    if (opencv) {
        ok = ok && done_iter < kMaxIterations;
    } else {
        ok = ok && !(dx >= 1.5f || dy >= 1.5f || dz >= 1.5f);
    }
    const float xn = static_cast<float>(nx) + dx;
    const float yn = static_cast<float>(ny) + dy;
    const float sn = static_cast<float>(nz) + dz;
    if (!opencv) {
        ok = ok && !(xn < 0.0f || xn > static_cast<float>(p.W) - 1.0f
                     || yn < 0.0f || yn > static_cast<float>(p.H) - 1.0f
                     || sn < 0.0f || sn > static_cast<float>(p.n_layers));
    }
    const float contr = v + 0.5f * (Dx * dx + Dy * dy + Dz * dz);
    const float tr = DDx + DDy;
    const float det = DDx * DDy - DXx * DXx;
    const float edgeval = tr * tr / (det == 0.0f ? 1.0f : det);
    ok = ok && det > 0.0f && fabsf(contr) >= p.contr_thr
         && edgeval < p.edge_thr;

    xn_o[i] = xn;
    yn_o[i] = yn;
    lpos_o[i] = static_cast<int>(rintf(sn));
    sigma_o[i] = p.sigma0 * powf(p.sigma_k, sn);
    cell_o[i] = static_cast<int>(floorf(yn / p.ghd)) * p.grid_width
                + static_cast<int>(floorf(xn / p.gwd));
    ok_o[i] = ok ? 1 : 0;
}

}  // namespace

PSK_API int psk_refine(const float* dog, const int* cx, const int* cy,
                       const int* cz, int n, int n_layers, int H, int W,
                       int Hp, int Wp, int mode, float sigma0, float sigma_k,
                       float contr_thr, float edge_thr, float gwd, float ghd,
                       int grid_width, float* xn, float* yn, int* lpos,
                       float* sigma, int* cell, uint8_t* ok, void* stream) {
    const Params p{H, W, Hp, Wp, n_layers, mode, sigma0, sigma_k,
                   contr_thr, edge_thr, gwd, ghd, grid_width};
    const int threads = 128;
    refine<<<psk::blocks_for(n, threads), threads, 0,
             static_cast<cudaStream_t>(stream)>>>(
        dog, cx, cy, cz, n, p, xn, yn, lpos, sigma, cell, ok);
    return psk::status();
}
