// K4: sub-voxel Newton refinement of DoG extremum candidates, the whole
// loop of popsift_tpu/ops/extrema.py:refine_extrema_multi in one thread
// per candidate, and the compaction of the survivors
// (popsift_tpu/ops/extrema.py:compact_extrema).
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
// Candidates come as compact_mask leaves them: (n, 3) int32 rows of
// (mask layer, y, x); the kernel adds the mask layer's 1 itself.
//
// Bound on the H100: latency.  The data are tiny (27 floats per candidate
// per iteration, a few thousand candidates per octave) and the loop is
// serial per candidate, so the kernel is a single short wave; the
// gathered reads are uncoalesced but hit L2.  One thread per candidate in
// blocks of one warp, so that the wave spreads over as many SMs as there
// are warps of candidates.  The caller's cost was on the host (column
// copies, allocations, a synchronising nonzero and five gathers), so the
// compaction is a second, one-block kernel of the same entry: the refine
// kernel writes each warp's survivor count, and the compaction scans the
// counts and copies each survivor to its place in candidate order,
// clamped at the capacity, with the count and overflow written straight
// to pinned host memory; the entry's one synchronisation waits for them.
// Integer counts only: no atomics, the same order on every run.
#include "common.cuh"

// One octave's scalars, as the wrapper's ctypes structure lays them out
// (kernels/refine.py:_ParamsC).
struct RefineParams {
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

namespace {

using Params = RefineParams;

constexpr int kMaxIterations = 5;  // s_extrema.cu:362
constexpr int kRefineThreads = 32;
constexpr int kCompactThreads = 1024;

__device__ inline float at(const float* __restrict__ dog, const Params& p,
                           int z, int y, int x) {
    return dog[(static_cast<size_t>(z) * p.H + min(y, p.H - 1)) * p.W
               + min(x, p.W - 1)];
}

struct Refined {
    float xn, yn, sigma;
    int lpos, cell;
    bool ok;
};

// One candidate at integer (nx, ny) on DoG layer nz.
__device__ Refined refine_one(const float* __restrict__ dog, const Params& p,
                              int nx, int ny, int nz) {
    const bool opencv = p.mode == 1;
    const bool vlfeat = p.mode == 2;

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

    Refined r;
    r.xn = xn;
    r.yn = yn;
    r.lpos = static_cast<int>(rintf(sn));
    r.sigma = p.sigma0 * powf(p.sigma_k, sn);
    r.cell = static_cast<int>(floorf(yn / p.ghd)) * p.grid_width
             + static_cast<int>(floorf(xn / p.gwd));
    r.ok = ok;
    return r;
}

// Per candidate i of the (n, 3) rows zyx: the refined outputs, and, when
// warp_counts is given, each warp's number of survivors.
__global__ void __launch_bounds__(kRefineThreads)
refine(const float* __restrict__ dog, const int* __restrict__ zyx, int n,
       Params p, float* __restrict__ xn_o, float* __restrict__ yn_o,
       int* __restrict__ lpos_o, float* __restrict__ sigma_o,
       int* __restrict__ cell_o, int* __restrict__ ok_o,
       int* __restrict__ warp_counts) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    bool ok = false;
    if (i < n) {
        const Refined r = refine_one(dog, p, zyx[3 * i + 2], zyx[3 * i + 1],
                                     zyx[3 * i] + 1);
        xn_o[i] = r.xn;
        yn_o[i] = r.yn;
        lpos_o[i] = r.lpos;
        sigma_o[i] = r.sigma;
        cell_o[i] = r.cell;
        ok_o[i] = r.ok ? 1 : 0;
        ok = r.ok;
    }
    if (warp_counts == nullptr) return;
    const unsigned kept = __ballot_sync(0xffffffffu, ok);
    const int lane = threadIdx.x % 32;
    if (lane == 0 && i < n) warp_counts[i / 32] = __popc(kept);
}

// One block: the exclusive scan of the warps' survivor counts, a chunk of
// 2 * kCompactThreads warps at a time, and each survivor copied to its
// place in candidate order if that is below cap; status = (count,
// overflow).
__global__ void __launch_bounds__(kCompactThreads)
compact(const int* __restrict__ warp_counts, int n, int cap,
        const float* __restrict__ xn, const float* __restrict__ yn,
        const int* __restrict__ lpos, const float* __restrict__ sigma,
        const int* __restrict__ cell, const int* __restrict__ ok,
        float* __restrict__ xo, float* __restrict__ yo,
        int* __restrict__ lo, float* __restrict__ so,
        int* __restrict__ co, int* __restrict__ status) {
    __shared__ int s_base[2 * kCompactThreads];
    __shared__ int s_wsum[kCompactThreads / 32];
    const int t = threadIdx.x;
    const int lane = t % 32;
    const int warp = t / 32;
    const int nw = (n + 31) / 32;
    int carry = 0;
    for (int c0 = 0; c0 < nw; c0 += 2 * kCompactThreads) {
        const int w0 = c0 + 2 * t;
        const int a = w0 < nw ? warp_counts[w0] : 0;
        const int b = w0 + 1 < nw ? warp_counts[w0 + 1] : 0;
        int incl = a + b;
#pragma unroll
        for (int off = 1; off < 32; off *= 2) {
            const int v = __shfl_up_sync(0xffffffffu, incl, off);
            if (lane >= off) incl += v;
        }
        if (lane == 31) s_wsum[warp] = incl;
        __syncthreads();
        if (warp == 0) {
            int v = s_wsum[lane];
#pragma unroll
            for (int off = 1; off < 32; off *= 2) {
                const int u = __shfl_up_sync(0xffffffffu, v, off);
                if (lane >= off) v += u;
            }
            s_wsum[lane] = v;
        }
        __syncthreads();
        const int first =
            carry + incl - (a + b) + (warp > 0 ? s_wsum[warp - 1] : 0);
        s_base[2 * t] = first;
        s_base[2 * t + 1] = first + a;
        const int chunk_total = s_wsum[kCompactThreads / 32 - 1];
        __syncthreads();
        const int c1 = min(nw, c0 + 2 * kCompactThreads);
        for (int w = c0 + warp; w < c1; w += kCompactThreads / 32) {
            const int i = 32 * w + lane;
            const bool keep = i < n && ok[i] != 0;
            const unsigned kept = __ballot_sync(0xffffffffu, keep);
            const int pos =
                s_base[w - c0] + __popc(kept & ((1u << lane) - 1u));
            if (keep && pos < cap) {
                xo[pos] = xn[i];
                yo[pos] = yn[i];
                lo[pos] = lpos[i];
                so[pos] = sigma[i];
                co[pos] = cell[i];
            }
        }
        carry += chunk_total;
        // s_base and s_wsum are the next chunk's
        __syncthreads();
    }
    if (t == 0) {
        const int count = min(carry, cap);
        status[0] = count;
        status[1] = carry - count;
    }
}


}  // namespace

// dog: (n_layers, H, W); zyx: (n, 3) i32 rows (mask layer, y, x); p: the
// octave's scalars (host memory).  Per candidate: xn, yn, sigma (f32), lpos,
// cell, ok (i32), each (n,).
PSK_API int psk_refine(const float* dog, const int* zyx, int n,
                       const RefineParams* p, float* xn, float* yn, int* lpos,
                       float* sigma, int* cell, int* ok, void* stream) {
    refine<<<psk::blocks_for(n, kRefineThreads), kRefineThreads, 0,
             static_cast<cudaStream_t>(stream)>>>(
        dog, zyx, n, *p, xn, yn, lpos, sigma, cell, ok, nullptr);
    return psk::status();
}

// The same refinement, then the survivors compacted in candidate order and
// clamped at cap (n >= 1, cap >= 1), with (count, overflow) written to
// status, pinned host memory that the kernel writes through unified
// addressing; the call returns when they are there.  buf: int32 words, m
// = min(n, cap): the outputs xpos, ypos, lpos, sigma, cell, m each, then
// scratch of 6n + ceil(n / 32) words.  Two launches.
PSK_API int psk_refine_compact(const float* dog, const int* zyx, int n,
                               const RefineParams* p, int cap, int* buf,
                               int* status, void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int m = n < cap ? n : cap;
    int* scratch = buf + 5 * m;
    float* xn = reinterpret_cast<float*>(scratch);
    float* yn = reinterpret_cast<float*>(scratch + n);
    int* lp = scratch + 2 * n;
    float* sg = reinterpret_cast<float*>(scratch + 3 * n);
    int* cell = scratch + 4 * n;
    int* ok = scratch + 5 * n;
    int* warp_counts = scratch + 6 * n;
    refine<<<psk::blocks_for(n, kRefineThreads), kRefineThreads, 0, st>>>(
        dog, zyx, n, *p, xn, yn, lp, sg, cell, ok, warp_counts);
    int rc = psk::status();
    if (rc != 0) return rc;
    compact<<<1, kCompactThreads, 0, st>>>(
        warp_counts, n, cap, xn, yn, lp, sg, cell, ok,
        reinterpret_cast<float*>(buf), reinterpret_cast<float*>(buf + m),
        buf + 2 * m, reinterpret_cast<float*>(buf + 3 * m), buf + 4 * m,
        status);
    rc = psk::status();
    if (rc != 0) return rc;
    return static_cast<int>(cudaStreamSynchronize(st));
}
