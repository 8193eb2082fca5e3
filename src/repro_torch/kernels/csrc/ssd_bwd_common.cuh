// What both variants of the Mamba2 SSD backward share: ssd_scan_bwd.cu (fma)
// and ssd_scan_bwd_sm90.cu (mma).  Each file's note has the formulas; the two
// passes here sum dB, dC and da over their partials in a fixed order (no
// atomics).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>

namespace ssd_bwd {

constexpr int NTHREADS = 256;
constexpr int MAX_Q = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);
}

struct Dims {
    int Bt, L, H, N, Q, NC;
};

// ---- ssd_bwd_reduce_heads and ssd_bwd_reduce_da ------------------------------
// dB and dC from `parts` partials per position [Bt, L, parts, N], summed in
// order; da from the per-chunk partials, summed over batches and chunks in order.
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
ssd_bwd_reduce_heads(const float* __restrict__ db_part, const float* __restrict__ dc_part,
                     T* __restrict__ dbm, T* __restrict__ dcm, int parts, Dims d) {
    const size_t idx = size_t(blockIdx.x) * NTHREADS + threadIdx.x;
    if (idx >= size_t(d.Bt) * d.L * d.N) return;
    const size_t pos = idx / d.N, n = idx % d.N;
    float sb = 0.f, sc = 0.f;
    for (int k = 0; k < parts; ++k) {
        const size_t o = (pos * parts + k) * d.N + n;
        sb += db_part[o];
        sc += dc_part[o];
    }
    dbm[idx] = from_f32<T>(sb);
    dcm[idx] = from_f32<T>(sc);
}

__global__ void __launch_bounds__(NTHREADS)
ssd_bwd_reduce_da(const float* __restrict__ da_part, float* __restrict__ da, Dims d) {
    for (int hh = threadIdx.x; hh < d.H; hh += NTHREADS) {
        float s = 0.f;
        for (int bc = 0; bc < d.Bt * d.NC; ++bc) s += da_part[size_t(bc) * d.H + hh];
        da[hh] = s;
    }
}

}  // namespace ssd_bwd
