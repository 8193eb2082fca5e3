// Mamba2 SSD chunked scan for Hopper (sm_90a), hand-written CUDA C++ with a
// plain C entry point, in two variants that the caller names: "mma"
// (ssd_scan_sm90.cuh; bf16 x/B/C at P in {16, 32, 64, 128}, N a multiple of
// 16 up to 128, Q a multiple of 16 up to 256, chunks in parallel on the
// tensor cores) and "fma" (this file; every other call, fp32 FMAs on the CUDA
// cores).
//
// The FMA variant replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py
// (ssd_scan + _kernel).  Per (batch, head), over the chunks of Q positions in
// order, all in fp32:
//   cum = cumsum(dt·a)                                             [Q]
//   y   = ((C Bᵀ) ⊙ tril(exp(cum_i − cum_j)) ⊙ dt_j) X              (intra)
//       + exp(cum_i) ⊙ (C h_prevᵀ)                                  (inter)
//   h   = exp(cum_{Q−1})·h_prev + Xᵀ(B ⊙ exp(cum_{Q−1} − cum)·dt)   (state)
// It computes the same function, not the same blocks:
//   * one thread block per (batch, head); the TPU's sequential chunk grid
//     axis becomes a loop over chunks inside the block, with the [P,N] fp32
//     state in shared memory the whole time;
//   * a chunk of up to 256 rows does not fit in shared memory with its
//     [Q,Q] scores, so rows i and columns j are tiled by 64; column tiles
//     wholly above the diagonal are exact zeros and are skipped;
//   * every row tile reads h_prev; the state is updated only after all rows
//     of the chunk have used it;
//   * the state the kernel ends with is written out when the caller asks
//     (h_out != nullptr): the TPU kernel drops its carry, but serving needs
//     it to seed decode.
//
// What bounds it on the card: at the mamba2-370m serving shape (Bt=4,
// L=512, H=32, P=64, N=128, Q=256, bf16 x/B/C) the bytes it must move
// (~22.3 MB: x and y 8.4 MB each, the fp32 state 4.2 MB) take ~6.7 us at
// 3.35 TB/s; the products the function needs (~3.3 GFLOP, C·Bᵀ counted once
// per batch since the heads share it) take ~3.3 us at the bf16 tensor-core
// peak, so bytes bound it.  This design recomputes C·Bᵀ per head over whole
// diagonal tiles (~6.2 GFLOP) with fp32 FMAs on the CUDA cores to keep the
// reference's numerics (67 TFLOP/s, so ~92 us of arithmetic), which is its
// real limit; Bt·H = 128 blocks are about one wave on 132 SMs.  Shared-
// memory tiles are padded (stride N+1, 64+1) so the inner loops are free
// of bank conflicts.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (src/repro_torch/kernels/build.py does this).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>

#include "ssd_scan_sm90.cuh"

namespace {

constexpr int NTHREADS = 256;
constexpr int TQ = 64;                 // rows i and columns j per tile
constexpr int TG = 16;                 // 16 x 16 thread grid over a tile
constexpr int RPT = TQ / TG;           // rows (and score columns) per thread
constexpr int MAX_Q = 256;
constexpr int MAX_N = 128;
constexpr int SS = TQ + 1;             // padded score row stride

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);   // round to nearest even, as astype(bf16)
}

size_t smem_bytes(int P, int N) {
    const size_t ns = size_t(N) + 1;
    return sizeof(float) * (3 * size_t(MAX_Q) + size_t(P) * ns + 2 * size_t(TQ) * ns +
                            size_t(TQ) * P + size_t(TQ) * SS);
}

// x, y: [Bt, L, H, P]; dt: [Bt, L, H] fp32; a: [H] fp32; bm, cm: [Bt, L, N];
// h_out: [Bt, H, P, N] fp32 or null.  All contiguous; L % Q == 0.
template <typename T, int P>
__global__ void __launch_bounds__(NTHREADS)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const T* __restrict__ bm,
                const T* __restrict__ cm, T* __restrict__ y,
                float* __restrict__ h_out, int L, int H, int N, int Q) {
    constexpr int OPT = P / TG;          // y columns per thread
    constexpr int SP = NTHREADS / 32;    // state rows p per pass (8)
    constexpr int CP = P / SP;           // state rows per thread
    constexpr int CN = MAX_N / 32;       // state columns per thread (n < N)
    const int NS = N + 1;

    extern __shared__ float smem[];
    float* cum = smem;                   // [MAX_Q]
    float* dts = cum + MAX_Q;            // [MAX_Q]
    float* wq = dts + MAX_Q;             // [MAX_Q] exp(cum_last − cum)·dt
    float* hs = wq + MAX_Q;              // [P][NS] the carried state
    float* ci = hs + P * NS;             // [TQ][NS] C rows of the tile
    float* bj = ci + TQ * NS;            // [TQ][NS] B rows (⊙ w in the update)
    float* xj = bj + TQ * NS;            // [TQ][P]  X rows
    float* ss = xj + TQ * P;             // [TQ][SS] masked scores

    const int tid = threadIdx.x;
    const int tc = tid % TG;
    const int tr = tid / TG;
    const int sn = tid % 32;             // state mapping: column lane
    const int sp = tid / 32;             //                row group
    const int bh = blockIdx.x;
    const int b = bh / H;
    const int hh = bh % H;
    const float ah = a[hh];

    const size_t xrow = size_t(H) * P;   // stride between positions of x, y
    const T* xb = x + size_t(b) * L * xrow + size_t(hh) * P;
    T* yb = y + size_t(b) * L * xrow + size_t(hh) * P;
    const float* dtb = dt + size_t(b) * L * H + hh;
    const T* bb = bm + size_t(b) * L * N;
    const T* cb = cm + size_t(b) * L * N;

    for (int idx = tid; idx < P * NS; idx += NTHREADS) hs[idx] = 0.f;

    const int nt = (Q + TQ - 1) / TQ;    // tiles per chunk
    for (int c0 = 0; c0 < L; c0 += Q) {
        __syncthreads();                 // previous chunk's state update done
        for (int i = tid; i < Q; i += NTHREADS) dts[i] = dtb[size_t(c0 + i) * H];
        __syncthreads();
        if (tid == 0) {                  // serial cumulative sum, as the reference
            float run = 0.f;
            for (int i = 0; i < Q; ++i) {
                run += dts[i] * ah;
                cum[i] = run;
            }
        }

        // ---- y of every row tile, from h_prev ------------------------------
        for (int it = 0; it < nt; ++it) {
            const int i0 = it * TQ;
            __syncthreads();             // cum ready; previous tile's ci reads done
            for (int idx = tid; idx < TQ * N; idx += NTHREADS) {
                const int r = idx / N, n = idx % N;
                ci[r * NS + n] = i0 + r < Q ? to_f32(cb[size_t(c0 + i0 + r) * N + n]) : 0.f;
            }
            float acc[RPT][OPT];
#pragma unroll
            for (int r = 0; r < RPT; ++r)
#pragma unroll
                for (int c = 0; c < OPT; ++c) acc[r][c] = 0.f;

            for (int jt = 0; jt <= it; ++jt) {
                const int j0 = jt * TQ;
                __syncthreads();         // ci loaded; previous bj/xj/ss reads done
                for (int idx = tid; idx < TQ * N; idx += NTHREADS) {
                    const int r = idx / N, n = idx % N;
                    bj[r * NS + n] = j0 + r < Q ? to_f32(bb[size_t(c0 + j0 + r) * N + n]) : 0.f;
                }
                for (int idx = tid; idx < TQ * P; idx += NTHREADS) {
                    const int r = idx / P, p = idx % P;
                    xj[idx] = j0 + r < Q ? to_f32(xb[size_t(c0 + j0 + r) * xrow + p]) : 0.f;
                }
                __syncthreads();

                // scores C_i·B_j: rows tr + r·TG, columns tc + c·TG
                float s[RPT][RPT];
#pragma unroll
                for (int r = 0; r < RPT; ++r)
#pragma unroll
                    for (int c = 0; c < RPT; ++c) s[r][c] = 0.f;
#pragma unroll 4
                for (int n = 0; n < N; ++n) {
                    float cv[RPT], bv[RPT];
#pragma unroll
                    for (int r = 0; r < RPT; ++r) cv[r] = ci[(tr + r * TG) * NS + n];
#pragma unroll
                    for (int c = 0; c < RPT; ++c) bv[c] = bj[(tc + c * TG) * NS + n];
#pragma unroll
                    for (int r = 0; r < RPT; ++r)
#pragma unroll
                        for (int c = 0; c < RPT; ++c) s[r][c] = fmaf(cv[r], bv[c], s[r][c]);
                }
                // ⊙ decay ⊙ dt_j under the causal mask (exp only where kept:
                // above the diagonal exp(cum_i − cum_j) can overflow)
#pragma unroll
                for (int r = 0; r < RPT; ++r) {
                    const int i = i0 + tr + r * TG;
#pragma unroll
                    for (int c = 0; c < RPT; ++c) {
                        const int j = j0 + tc + c * TG;
                        float v = 0.f;
                        if (j <= i && i < Q) v = s[r][c] * expf(cum[i] - cum[j]) * dts[j];
                        ss[(tr + r * TG) * SS + tc + c * TG] = v;
                    }
                }
                __syncthreads();

                // acc += scores · X_j: rows tr + r·TG, columns tc + c·TG
#pragma unroll 4
                for (int jj = 0; jj < TQ; ++jj) {
                    float sv[RPT];
#pragma unroll
                    for (int r = 0; r < RPT; ++r) sv[r] = ss[(tr + r * TG) * SS + jj];
#pragma unroll
                    for (int c = 0; c < OPT; ++c) {
                        const float xv = xj[jj * P + tc + c * TG];
#pragma unroll
                        for (int r = 0; r < RPT; ++r) acc[r][c] = fmaf(sv[r], xv, acc[r][c]);
                    }
                }
            }

            // inter-chunk: + exp(cum_i) ⊙ (C_i · h_prevᵀ)
            float t[RPT][OPT];
#pragma unroll
            for (int r = 0; r < RPT; ++r)
#pragma unroll
                for (int c = 0; c < OPT; ++c) t[r][c] = 0.f;
#pragma unroll 4
            for (int n = 0; n < N; ++n) {
                float cv[RPT], hv[OPT];
#pragma unroll
                for (int r = 0; r < RPT; ++r) cv[r] = ci[(tr + r * TG) * NS + n];
#pragma unroll
                for (int c = 0; c < OPT; ++c) hv[c] = hs[(tc + c * TG) * NS + n];
#pragma unroll
                for (int r = 0; r < RPT; ++r)
#pragma unroll
                    for (int c = 0; c < OPT; ++c) t[r][c] = fmaf(cv[r], hv[c], t[r][c]);
            }
#pragma unroll
            for (int r = 0; r < RPT; ++r) {
                const int i = i0 + tr + r * TG;
                if (i >= Q) continue;
                const float e = expf(cum[i]);
#pragma unroll
                for (int c = 0; c < OPT; ++c)
                    yb[size_t(c0 + i) * xrow + tc + c * TG] = from_f32<T>(acc[r][c] + e * t[r][c]);
            }
        }

        // ---- state update, after every row has read h_prev -----------------
        __syncthreads();
        const float c_last = cum[Q - 1];
        for (int i = tid; i < Q; i += NTHREADS) wq[i] = expf(c_last - cum[i]) * dts[i];
        float sacc[CP][CN];
#pragma unroll
        for (int p = 0; p < CP; ++p)
#pragma unroll
            for (int c = 0; c < CN; ++c) sacc[p][c] = 0.f;
        for (int jt = 0; jt < nt; ++jt) {
            const int j0 = jt * TQ;
            __syncthreads();             // wq ready; previous tile's reads done
            for (int idx = tid; idx < TQ * N; idx += NTHREADS) {
                const int r = idx / N, n = idx % N;
                bj[r * NS + n] = j0 + r < Q
                    ? to_f32(bb[size_t(c0 + j0 + r) * N + n]) * wq[j0 + r] : 0.f;
            }
            for (int idx = tid; idx < TQ * P; idx += NTHREADS) {
                const int r = idx / P, p = idx % P;
                xj[idx] = j0 + r < Q ? to_f32(xb[size_t(c0 + j0 + r) * xrow + p]) : 0.f;
            }
            __syncthreads();
#pragma unroll 4
            for (int jj = 0; jj < TQ; ++jj) {
                float xv[CP], bv[CN];
#pragma unroll
                for (int p = 0; p < CP; ++p) xv[p] = xj[jj * P + sp + p * SP];
#pragma unroll
                for (int c = 0; c < CN; ++c) {
                    const int n = sn + c * 32;
                    bv[c] = n < N ? bj[jj * NS + n] : 0.f;
                }
#pragma unroll
                for (int p = 0; p < CP; ++p)
#pragma unroll
                    for (int c = 0; c < CN; ++c) sacc[p][c] = fmaf(xv[p], bv[c], sacc[p][c]);
            }
        }
        const float gamma = expf(c_last);
        // each thread owns its (p, n) entries: no other thread touches them here
#pragma unroll
        for (int p = 0; p < CP; ++p)
#pragma unroll
            for (int c = 0; c < CN; ++c) {
                const int n = sn + c * 32;
                if (n < N) {
                    float* hp = hs + (sp + p * SP) * NS + n;
                    *hp = *hp * gamma + sacc[p][c];
                }
            }
    }

    if (h_out != nullptr) {
        __syncthreads();
        float* hb = h_out + size_t(bh) * P * N;
        for (int idx = tid; idx < P * N; idx += NTHREADS)
            hb[idx] = hs[(idx / N) * NS + idx % N];
    }
}

template <typename T, int P>
int launch(const void* x, const float* dt, const float* a, const void* bm,
           const void* cm, void* y, float* h_out, int Bt, int L, int H, int N,
           int Q, cudaStream_t stream) {
    const size_t smem = smem_bytes(P, N);
    cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
    ssd_scan_kernel<T, P><<<Bt * H, NTHREADS, smem, stream>>>(
        static_cast<const T*>(x), dt, a, static_cast<const T*>(bm),
        static_cast<const T*>(cm), static_cast<T*>(y), h_out, L, H, N, Q);
    return int(cudaGetLastError());
}

template <typename T>
int dispatch_p(int P, const void* x, const float* dt, const float* a,
               const void* bm, const void* cm, void* y, float* h_out, int Bt,
               int L, int H, int N, int Q, cudaStream_t stream) {
    switch (P) {
        case 16: return launch<T, 16>(x, dt, a, bm, cm, y, h_out, Bt, L, H, N, Q, stream);
        case 32: return launch<T, 32>(x, dt, a, bm, cm, y, h_out, Bt, L, H, N, Q, stream);
        case 64: return launch<T, 64>(x, dt, a, bm, cm, y, h_out, Bt, L, H, N, Q, stream);
        case 128: return launch<T, 128>(x, dt, a, bm, cm, y, h_out, Bt, L, H, N, Q, stream);
        default: return int(cudaErrorInvalidValue);
    }
}

}  // namespace

// Returns the cudaError_t of the first launch that fails (0 on success).
// dtype of x, B, C and y: 0 = fp32, 1 = bf16; dt and a are fp32.  h_out may
// be null.  variant: 0 = fma, 1 = mma; the mma variant takes the caller's
// scratch, states [Bt, L/Q, H, P, N] and cum [Bt, L/Q, H, Q] in fp32 and
// h_in [Bt, L/Q, H, P, N] in bf16, which the fma variant ignores.  The caller validates shapes; a shape or dtype
// the named variant does not take (fma: P outside {16, 32, 64, 128}, N
// outside [1, 128], Q outside [1, 256] or L % Q != 0) returns
// cudaErrorInvalidValue without launching, and no variant stands in for
// another.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* a,
                            const void* bm, const void* cm, void* y, void* h_out,
                            void* states, void* h_in, void* cum, int Bt, int L, int H, int P,
                            int N, int Q, int dtype, int variant, void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* dtf = static_cast<const float*>(dt);
    const float* af = static_cast<const float*>(a);
    float* hf = static_cast<float*>(h_out);
    if (variant == 1)
        return dtype == 1 ? ssd_sm90::dispatch(P, x, dtf, af, bm, cm, y, hf,
                                               static_cast<float*>(states), h_in,
                                               static_cast<float*>(cum), Bt, L, H, N, Q, st)
                          : int(cudaErrorInvalidValue);
    if (variant != 0 || N < 1 || N > MAX_N || Q < 1 || Q > MAX_Q || L % Q != 0)
        return int(cudaErrorInvalidValue);
    if (dtype == 0)
        return dispatch_p<float>(P, x, dtf, af, bm, cm, y, hf, Bt, L, H, N, Q, st);
    if (dtype == 1)
        return dispatch_p<__nv_bfloat16>(P, x, dtf, af, bm, cm, y, hf, Bt, L, H, N, Q, st);
    return int(cudaErrorInvalidValue);
}
