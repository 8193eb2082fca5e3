// Causal / sliding-window / tanh-softcap GQA flash-attention forward for
// Hopper (sm_90a), hand-written CUDA C++ with a plain C entry point.  Two
// variants: "wgmma" (flash_attention_sm90.cuh; bf16 at head dims 16, 32, 64,
// 96, 128 and 256, on the tensor cores) and "fma" (this file; fp32 at every head dim and bf16 at
// head dim 8, on the CUDA cores).  The caller names the variant.
//
// The FMA variant replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py (flash_attention_fwd + _kernel).  It
// computes the same function, not the same blocks:
//   * one thread block per (batch·head, 64-row q tile); the TPU's sequential
//     kv grid axis becomes a loop over 64-key tiles inside the block;
//   * running max, denominator and the fp32 output accumulator live in
//     registers; q, k (transposed) and v tiles and the probability tile live
//     in shared memory as fp32;
//   * kv tiles that causal/window masking empties are skipped;
//   * GQA without KV replication: q head h reads kv head h / (H / Hkv).
//   * head dims 8, 16, 32, 64, 96, 128 and 256 in fp32, 8 in bf16; at 256 the block has 256
//     threads and the padded fp32 tiles take 214.5 KB of the 227 KB of
//     shared memory a block may opt into.
//
// Numerics kept from the TPU kernel: q, k, v are upcast to fp32; every
// product is a full-precision fp32 FMA (no TF32); p stays fp32; masking uses
// the finite NEG_INF = -2.3819763e38 (with -inf, exp(m_prev - m_next) is
// NaN on rows whose first processed tile is fully masked); the denominator
// is clamped at 1e-37.  The window applies with or without causal masking,
// as in the TPU kernel: row i sees keys j > i - window.
//
// What bounds it on the card: at the yi-9b prefill shape in fp32 (B=4,
// L=512, H=32, Hkv=4, hd=128) the bytes it must move (~75 MB) take ~22 us
// at 3.35 TB/s and the causal products (~8.6 GFLOP) ~128 us at the fp32
// CUDA-core peak (67 TFLOP/s), so operations bound it.  The skipped tiles
// halve the causal work, the smem tiles are padded so the inner loops are
// free of bank conflicts, and the heaviest causal q tiles are scheduled
// first.  fp32 stays here because its 2e-5 tolerance rules out TF32.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (src/repro_torch/kernels/build.py does this).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>

#include "flash_attention_sm90.cuh"

namespace {

constexpr float NEG_INF = -2.3819763e38f;
constexpr int BQ = 64;                  // q rows per block
constexpr int BK = 64;                  // keys per kv tile
constexpr int TR = 16;                  // row groups
constexpr int RPT = BQ / TR;            // rows per thread (4)

// Threads per block: 128 (8 lanes share a group of rows) up to hd 128; 256
// (16 lanes) at hd 256, so the per-thread accumulator stays at 16 columns
// × 4 rows instead of 32 × 4, which would spill.
template <int HD>
struct Threads { static constexpr int n = HD == 256 ? 256 : 128; };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);   // round to nearest even, as astype(bf16)
}

template <int HD>
constexpr size_t smem_bytes() {
    return sizeof(float) * (size_t(BQ) * (HD + 1) + size_t(HD) * (BK + 1) +
                            size_t(BK) * HD + size_t(BQ) * (BK + 1));
}

// q, o: [B, L, H, HD]; k, v: [B, S, Hkv, HD]; all contiguous.
template <typename T, int HD>
__global__ void __launch_bounds__(Threads<HD>::n)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int L, int S, int H, int Hkv, int causal,
                 int window, float softcap, float scale) {
    constexpr int NTHREADS = Threads<HD>::n;
    constexpr int TC = NTHREADS / TR;    // lanes that share one group of rows
    constexpr int CPT = BK / TC;         // score columns per thread
    constexpr int QS = HD + 1;           // padded row strides: conflict-free
    constexpr int KS = BK + 1;
    constexpr int PS = BK + 1;
    constexpr int OPT = HD / TC;         // output columns per thread
    static_assert(HD % TC == 0, "each lane of a row group takes whole output columns");

    extern __shared__ float smem[];
    float* qs = smem;                    // [BQ][QS]
    float* kt = qs + BQ * QS;            // [HD][KS]  k tile, transposed
    float* vs = kt + HD * KS;            // [BK][HD]
    float* ps = vs + BK * HD;            // [BQ][PS]  probabilities

    const int tid = threadIdx.x;
    const int tc = tid % TC;
    const int tr = tid / TC;
    const int iq = gridDim.x - 1 - blockIdx.x;   // heaviest causal tiles first
    const int bh = blockIdx.y;
    const int b = bh / H;
    const int h = bh % H;
    const int hk = h / (H / Hkv);
    const int q_lo = iq * BQ;
    const int q_hi = min(q_lo + BQ, L) - 1;

    const size_t q_row = size_t(H) * HD;         // stride between positions
    const size_t kv_row = size_t(Hkv) * HD;
    const T* qb = q + size_t(b) * L * q_row + size_t(h) * HD;
    const T* kb = k + size_t(b) * S * kv_row + size_t(hk) * HD;
    const T* vb = v + size_t(b) * S * kv_row + size_t(hk) * HD;
    T* ob = o + size_t(b) * L * q_row + size_t(h) * HD;

    for (int idx = tid; idx < BQ * HD; idx += NTHREADS) {
        const int r = idx / HD, d = idx % HD;
        const int qi = q_lo + r;
        qs[r * QS + d] = qi < L ? to_f32(qb[size_t(qi) * q_row + d]) : 0.f;
    }

    float m[RPT], l[RPT], acc[RPT][OPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
        m[r] = NEG_INF;
        l[r] = 0.f;
#pragma unroll
        for (int c = 0; c < OPT; ++c) acc[r][c] = 0.f;
    }

    int nk = (S + BK - 1) / BK;
    if (causal) nk = min(nk, q_hi / BK + 1);

    for (int ik = 0; ik < nk; ++ik) {
        const int k_lo = ik * BK;
        // uniform across the block: tiles wholly before every row's window
        if (window && k_lo + BK - 1 <= q_lo - window) continue;

        __syncthreads();                 // previous tile's kt/vs/ps reads done
        for (int idx = tid; idx < BK * HD; idx += NTHREADS) {
            const int j = idx / HD, d = idx % HD;
            const int kj = k_lo + j;
            const bool in = kj < S;
            kt[d * KS + j] = in ? to_f32(kb[size_t(kj) * kv_row + d]) : 0.f;
            vs[j * HD + d] = in ? to_f32(vb[size_t(kj) * kv_row + d]) : 0.f;
        }
        __syncthreads();

        // scores: rows tr + r·TR, columns tc + c·TC
        float s[RPT][CPT];
#pragma unroll
        for (int r = 0; r < RPT; ++r)
#pragma unroll
            for (int c = 0; c < CPT; ++c) s[r][c] = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) {
            float qv[RPT], kv[CPT];
#pragma unroll
            for (int r = 0; r < RPT; ++r) qv[r] = qs[(tr + r * TR) * QS + d];
#pragma unroll
            for (int c = 0; c < CPT; ++c) kv[c] = kt[d * KS + tc + c * TC];
#pragma unroll
            for (int r = 0; r < RPT; ++r)
#pragma unroll
                for (int c = 0; c < CPT; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
        }

        // scale, softcap, mask, online softmax
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
            const int row = tr + r * TR;
            const int qi = q_lo + row;
            float mc = NEG_INF;
#pragma unroll
            for (int c = 0; c < CPT; ++c) {
                const int kj = k_lo + tc + c * TC;
                float x = s[r][c] * scale;
                if (softcap != 0.f) x = softcap * tanhf(x / softcap);
                bool ok = kj < S;
                if (causal) ok = ok && kj <= qi;
                if (window) ok = ok && kj > qi - window;
                s[r][c] = ok ? x : NEG_INF;
                mc = fmaxf(mc, s[r][c]);
            }
#pragma unroll
            for (int off = 1; off < TC; off <<= 1)
                mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, off));
            const float mn = fmaxf(m[r], mc);
            const float corr = expf(m[r] - mn);
            float rs = 0.f;
#pragma unroll
            for (int c = 0; c < CPT; ++c) {
                const float p = expf(s[r][c] - mn);
                ps[row * PS + tc + c * TC] = p;
                rs += p;
            }
#pragma unroll
            for (int off = 1; off < TC; off <<= 1)
                rs += __shfl_xor_sync(0xffffffffu, rs, off);
            l[r] = corr * l[r] + rs;
            m[r] = mn;
#pragma unroll
            for (int c = 0; c < OPT; ++c) acc[r][c] *= corr;
        }
        __syncthreads();                 // probability tile complete

        // acc += P · V: rows tr + r·TR, output columns tc + c·TC
#pragma unroll 4
        for (int j = 0; j < BK; ++j) {
            float pv[RPT];
#pragma unroll
            for (int r = 0; r < RPT; ++r) pv[r] = ps[(tr + r * TR) * PS + j];
#pragma unroll
            for (int c = 0; c < OPT; ++c) {
                const float vv = vs[j * HD + tc + c * TC];
#pragma unroll
                for (int r = 0; r < RPT; ++r) acc[r][c] = fmaf(pv[r], vv, acc[r][c]);
            }
        }
    }

#pragma unroll
    for (int r = 0; r < RPT; ++r) {
        const int qi = q_lo + tr + r * TR;
        if (qi >= L) continue;
        const float lf = fmaxf(l[r], 1e-37f);
        // the row's log-sum-exp of the scaled, capped, masked logits; m and
        // l are the same in every lane of the row group
        if (lse != nullptr && tc == 0) lse[size_t(bh) * L + qi] = m[r] + logf(lf);
#pragma unroll
        for (int c = 0; c < OPT; ++c)
            ob[size_t(qi) * q_row + tc + c * TC] = from_f32<T>(acc[r][c] / lf);
    }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int L,
           int S, int H, int Hkv, int causal, int window, float softcap,
           float scale, cudaStream_t stream) {
    const size_t smem = smem_bytes<HD>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (err != cudaSuccess) return int(err);
    const dim3 grid((L + BQ - 1) / BQ, B * H);
    flash_fwd_kernel<T, HD><<<grid, Threads<HD>::n, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), lse, L, S, H, Hkv, causal,
        window, softcap, scale);
    return int(cudaGetLastError());
}

int dispatch_hd_f32(int hd, const void* q, const void* k, const void* v, void* o, float* lse,
                    int B, int L, int S, int H, int Hkv, int causal, int window,
                    float softcap, float scale, cudaStream_t stream) {
    switch (hd) {
        case 8: return launch<float, 8>(q, k, v, o, lse, B, L, S, H, Hkv, causal, window, softcap, scale, stream);
        case 16: return launch<float, 16>(q, k, v, o, lse, B, L, S, H, Hkv, causal, window, softcap, scale, stream);
        case 32: return launch<float, 32>(q, k, v, o, lse, B, L, S, H, Hkv, causal, window, softcap, scale, stream);
        case 64: return launch<float, 64>(q, k, v, o, lse, B, L, S, H, Hkv, causal, window, softcap, scale, stream);
        case 96: return launch<float, 96>(q, k, v, o, lse, B, L, S, H, Hkv, causal, window, softcap, scale, stream);
        case 128: return launch<float, 128>(q, k, v, o, lse, B, L, S, H, Hkv, causal, window, softcap, scale, stream);
        case 256: return launch<float, 256>(q, k, v, o, lse, B, L, S, H, Hkv, causal, window, softcap, scale, stream);
        default: return int(cudaErrorInvalidValue);
    }
}

}  // namespace

// lse, when not null: fp32 [B, H, L], each row's log-sum-exp m + log(max(l,
// 1e-37)) of its scaled, capped, masked logits, for the backward pass; a
// null pointer skips the store.
// Returns the cudaError_t of the launch (0 on success).  dtype: 0 = fp32,
// 1 = bf16; variant: 0 = fma (fp32 at every head dim, bf16 at 8), 1 = wgmma
// (bf16 at 16, 32, 64, 96, 128 and 256).  The caller validates shapes; a variant that does not
// take the dtype or head dim returns cudaErrorInvalidValue without
// launching, and no variant stands in for another.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, float* lse, int B, int L, int S, int H, int Hkv,
                                   int hd, int dtype, int variant, int causal,
                                   int window, float softcap, float scale,
                                   void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (variant == 1)
        return dtype == 1 ? sm90::dispatch_hd(hd, q, k, v, o, lse, B, L, S, H, Hkv, causal,
                                              window, softcap, scale, st)
                          : int(cudaErrorInvalidValue);
    if (variant != 0) return int(cudaErrorInvalidValue);
    if (dtype == 0)
        return dispatch_hd_f32(hd, q, k, v, o, lse, B, L, S, H, Hkv, causal, window, softcap, scale, st);
    if (dtype == 1 && hd == 8)
        return launch<__nv_bfloat16, 8>(q, k, v, o, lse, B, L, S, H, Hkv, causal, window, softcap, scale, st);
    return int(cudaErrorInvalidValue);
}
