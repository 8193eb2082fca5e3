// RG-LRU diagonal linear recurrence for Hopper (sm_90a), hand-written CUDA
// C++ with a plain C entry point.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan.py
// (rglru_scan + _kernel):  h_t = exp(log_a_t)·h_{t−1} + b_t over axis 1 of
// [B, L, W], fp32, h_0 = 0.  It computes the same function, not the same
// blocks: the TPU kernel walks sequence tiles in order with the carry in
// VMEM and runs a log-depth doubling scan inside each [bl, bw] tile, because
// its vector unit wants whole tiles.
//
// What bounds it on the card: it reads log_a and b once and writes h once,
// 12 bytes an element (100.7 MB at the recurrentgemma-9b serving shape
// B=4, L=512, W=4096: 30 us at 3.35 TB/s) for 3 operations, so bytes bound
// it.  The design keeps the bytes at 12 an element, in one launch with no
// scratch and no flags between blocks, and keeps many loads in flight:
//   * a block owns one (batch, COLS vector columns): 32 lanes with float4
//     ("vec4", for W % 4 == 0), 8 lanes with floats ("scalar", every other
//     W).  At the serving shape that is B·W/32 = 512 blocks of 8 warps, two
//     resident an SM.  The block walks L in tiles of TILE = 256 steps and
//     holds the carry across them (two tiles at L = 512);
//   * within a tile each thread takes a segment of SEG = 8 steps of one
//     column and issues all 16 of its loads before any use; a warp's load
//     reads 4 rows × 128 contiguous bytes (vec4).  2 blocks × 256 threads
//     × 256 bytes put 128 KB of loads in flight an SM;
//   * each thread composes its segment serially into an aggregate
//     (∏a, h from 0);
//   * a scan over the tile's NSEG = 32 segments combines the aggregates in
//     the order (a₁,b₁)∘(a₂,b₂) = (a₁a₂, b₁a₂ + b₂): warp shuffles over a
//     warp's 4 segments, then the warps' totals through shared memory,
//     folded in warp order from the previous tile's carry (every thread of
//     a column folds the same values in the same order, so all hold the
//     same next carry);
//   * each thread re-runs its segment from its incoming h out of registers
//     and stores h.  Loads and stores are streaming (evict-first): nothing
//     is read twice.
//
// Rounding: serial within a segment, a shuffle tree within a warp, serial
// across warps and tiles, each step one fmaf.  That order differs from the
// TPU kernel's doubling scan, so results agree at the reference's atol
// 1e-5 / rtol 1e-3, not bit for bit; tests/test_torch_rglru.py emulates it
// on the CPU.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (src/repro_torch/kernels/build.py does this).

#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int COLS = 8;                  // vector columns a block owns
constexpr int NSEG = NTHREADS / COLS;    // segments a tile (32)
constexpr int SEG = 8;                   // steps a segment
constexpr int TILE = NSEG * SEG;         // steps a tile (256)
constexpr int NWARPS = NTHREADS / 32;    // each warp holds 32 / COLS = 4 segments
constexpr unsigned FULL = 0xffffffffu;

template <int VEC>
__device__ __forceinline__ void load(const float* p, float (&v)[VEC]) {
    if constexpr (VEC == 4) {
        const float4 t = __ldcs(reinterpret_cast<const float4*>(p));
        v[0] = t.x;
        v[1] = t.y;
        v[2] = t.z;
        v[3] = t.w;
    } else {
        v[0] = __ldcs(p);
    }
}

template <int VEC>
__device__ __forceinline__ void store(float* p, const float (&v)[VEC]) {
    if constexpr (VEC == 4) {
        __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
    } else {
        __stcs(p, v[0]);
    }
}

// log_a, b, h: [B, L, W] fp32, contiguous, W % VEC == 0 (16-byte aligned
// with VEC = 4).  Grid (ceil(W / (COLS·VEC)), B).  Thread t takes column
// t % COLS and segment t / COLS of each tile.
template <int VEC>
__global__ void __launch_bounds__(NTHREADS, 2)
rglru_scan_kernel(const float* __restrict__ log_a, const float* __restrict__ b,
                  float* __restrict__ h, int L, int W) {
    __shared__ float tot_a[NWARPS][COLS * VEC];   // each warp's inclusive aggregate
    __shared__ float tot_h[NWARPS][COLS * VEC];
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int col = tid % COLS, seg = tid / COLS;
    const int w0 = (blockIdx.x * COLS + col) * VEC;
    const bool active = w0 < W;                   // W % VEC == 0: all VEC lanes or none
    const size_t base = size_t(blockIdx.y) * L * W + w0;

    float carry[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) carry[v] = 0.f;

    for (int t0 = 0; t0 < L; t0 += TILE) {
        const int s0 = t0 + seg * SEG;            // the segment's first step

        // every load of the segment before any use; steps past L are the
        // identity (a = exp(0) = 1, b = 0)
        float a[SEG][VEC], x[SEG][VEC];
#pragma unroll
        for (int j = 0; j < SEG; ++j) {
            if (active && s0 + j < L) {
                const size_t off = base + size_t(s0 + j) * W;
                load<VEC>(log_a + off, a[j]);
                load<VEC>(b + off, x[j]);
            } else {
#pragma unroll
                for (int v = 0; v < VEC; ++v) a[j][v] = x[j][v] = 0.f;
            }
        }
#pragma unroll
        for (int j = 0; j < SEG; ++j)
#pragma unroll
            for (int v = 0; v < VEC; ++v) a[j][v] = expf(a[j][v]);

        // the segment's aggregate (A, H): h_out = A·h_in + H
        float A[VEC], H[VEC];
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
            A[v] = a[0][v];
            H[v] = x[0][v];
        }
#pragma unroll
        for (int j = 1; j < SEG; ++j)
#pragma unroll
            for (int v = 0; v < VEC; ++v) {
                H[v] = fmaf(a[j][v], H[v], x[j][v]);
                A[v] *= a[j][v];
            }

        // inclusive scan over the warp's segments (lanes COLS apart):
        // earlier (pa, ph) then (A, H) is (pa·A, ph·A + H)
#pragma unroll
        for (int off = COLS; off < 32; off *= 2)
#pragma unroll
            for (int v = 0; v < VEC; ++v) {
                const float pa = __shfl_up_sync(FULL, A[v], off);
                const float ph = __shfl_up_sync(FULL, H[v], off);
                if (lane >= off) {
                    H[v] = fmaf(ph, A[v], H[v]);
                    A[v] *= pa;
                }
            }
        // exclusive: the aggregate of the warp's earlier segments
        float EA[VEC], EH[VEC];
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
            EA[v] = __shfl_up_sync(FULL, A[v], COLS);
            EH[v] = __shfl_up_sync(FULL, H[v], COLS);
            if (lane < COLS) {
                EA[v] = 1.f;
                EH[v] = 0.f;
            }
        }
        if (lane >= 32 - COLS)
#pragma unroll
            for (int v = 0; v < VEC; ++v) {
                tot_a[warp][col * VEC + v] = A[v];
                tot_h[warp][col * VEC + v] = H[v];
            }
        __syncthreads();

        // fold the warps' totals in order from the carry: h entering this
        // warp, and the carry into the next tile
        float hin[VEC];
#pragma unroll
        for (int v = 0; v < VEC; ++v) hin[v] = carry[v];
#pragma unroll
        for (int wp = 0; wp < NWARPS; ++wp)
#pragma unroll
            for (int v = 0; v < VEC; ++v) {
                if (wp == warp) hin[v] = carry[v];
                carry[v] = fmaf(tot_a[wp][col * VEC + v], carry[v], tot_h[wp][col * VEC + v]);
            }

        // h entering the segment, then the segment again from registers
#pragma unroll
        for (int v = 0; v < VEC; ++v) hin[v] = fmaf(EA[v], hin[v], EH[v]);
#pragma unroll
        for (int j = 0; j < SEG; ++j) {
#pragma unroll
            for (int v = 0; v < VEC; ++v) hin[v] = fmaf(a[j][v], hin[v], x[j][v]);
            if (active && s0 + j < L) store<VEC>(h + base + size_t(s0 + j) * W, hin);
        }
        __syncthreads();                          // totals read before the next tile's
    }
}

}  // namespace

// variant: 0 = "scalar" (4-byte lanes, any W), 1 = "vec4" (float4 lanes,
// W % 4 == 0 and 16-byte aligned pointers).  Returns the cudaError_t of the
// launch (0 on success).  The caller validates shapes and the (block_l,
// block_w) contract.
extern "C" int rglru_scan_fwd(const void* log_a, const void* b, void* h, int B, int L,
                              int W, int variant, void* stream) {
    if (B < 1 || B > 65535 || L < 1 || W < 1 || (variant != 0 && variant != 1))
        return int(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* la = static_cast<const float*>(log_a);
    const float* bb = static_cast<const float*>(b);
    float* hh = static_cast<float*>(h);
    if (variant == 1) {
        if (W % 4 || (reinterpret_cast<uintptr_t>(la) | reinterpret_cast<uintptr_t>(bb) |
                      reinterpret_cast<uintptr_t>(hh)) % 16)
            return int(cudaErrorMisalignedAddress);
        const dim3 grid((W / 4 + COLS - 1) / COLS, B);
        rglru_scan_kernel<4><<<grid, NTHREADS, 0, st>>>(la, bb, hh, L, W);
    } else {
        const dim3 grid((W + COLS - 1) / COLS, B);
        rglru_scan_kernel<1><<<grid, NTHREADS, 0, st>>>(la, bb, hh, L, W);
    }
    return int(cudaGetLastError());
}
