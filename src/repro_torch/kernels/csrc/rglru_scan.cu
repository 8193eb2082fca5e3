// RG-LRU diagonal linear recurrence for Hopper (sm_90a), hand-written CUDA
// C++ with a plain C entry point.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan.py
// (rglru_scan + _kernel):  h_t = exp(log_a_t)·h_{t−1} + b_t over axis 1 of
// [B, L, W], fp32.  It computes the same function, not the same blocks:
// the TPU kernel walks sequence tiles in order with the carry in VMEM and
// runs a log-depth doubling scan inside each tile, because its vector unit
// wants whole [bl, bw] tiles.  Here every (batch, width lane) is one thread
// that runs the exact recurrence serially over L in fp32 registers; threads
// of a warp take neighbouring lanes, so every load and store is coalesced
// along W.  Its rounding order differs from the log-depth scan's, which is
// why it is held at the reference's atol 1e-5 / rtol 1e-3 and not bit for
// bit.
//
// What bounds it on the card: it reads log_a and b once and writes h once,
// 12 bytes per element (100.7 MB at the recurrentgemma-9b serving shape
// B=4, L=512, W=4096: ~30 us at 3.35 TB/s) for 3 operations, so bytes bound
// it.  The loads do not depend on the carry, so the unrolled loop keeps
// several in flight per thread; 16,384 lanes give about four warps per SM.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (src/repro_torch/kernels/build.py does this).

#include <cuda_runtime.h>

#include <stddef.h>

namespace {

constexpr int NTHREADS = 128;

// log_a, b, h: [B, L, W] fp32, contiguous.
__global__ void __launch_bounds__(NTHREADS)
rglru_scan_kernel(const float* __restrict__ log_a, const float* __restrict__ b,
                  float* __restrict__ h, int L, int W) {
    const int w = blockIdx.x * NTHREADS + threadIdx.x;
    if (w >= W) return;
    size_t off = size_t(blockIdx.y) * L * W + w;
    float hv = 0.f;
#pragma unroll 8
    for (int t = 0; t < L; ++t, off += W) {
        hv = expf(log_a[off]) * hv + b[off];
        h[off] = hv;
    }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  The caller
// validates shapes and the (block_l, block_w) contract.
extern "C" int rglru_scan_fwd(const void* log_a, const void* b, void* h, int B,
                              int L, int W, void* stream) {
    if (B < 1 || L < 1 || W < 1) return int(cudaErrorInvalidValue);
    const dim3 grid((W + NTHREADS - 1) / NTHREADS, B);
    rglru_scan_kernel<<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(log_a), static_cast<const float*>(b),
        static_cast<float*>(h), L, W);
    return int(cudaGetLastError());
}
