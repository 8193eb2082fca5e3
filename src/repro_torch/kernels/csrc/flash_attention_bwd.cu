// Causal / sliding-window / tanh-softcap GQA flash-attention backward for
// Hopper (sm_90a), hand-written CUDA C++ with a plain C entry point.
//
// No TPU kernel: the JAX package's gradient of flash attention is jnp code,
// the custom_vjp backward src/repro/models/flash.py::_flash_bwd_impl (the
// FlashAttention-2 backward: recompute each [bq, bk] tile from q, k and the
// forward's log-sum-exp, in two sweeps).  This is its counterpart on the
// card, computing the same function:
//
//   delta = rowsum(do · out)                       (fp32)
//   p     = exp(s_cap − lse), s_cap the scaled, capped, masked logits
//   ds    = p · (dp − delta) · (1 − tanh²(s / softcap)) , zero where masked
//   dv    = Σ pᵀ · do,  dk = Σ dsᵀ · q · scale,  dq = Σ ds · k · scale
//
// with causal masking, a sliding window (with or without causal) and the
// softcap, as the forward takes them.  Deterministic (no atomics), as the
// reference's two sweeps are, in launches on the caller's stream:
//   * delta: one warp a (batch, position, head) row;
//   * dk/dv: one block per (batch, kv head, kv tile), looping over the G
//     query heads of its kv head and the q tiles that can see the tile, so
//     dk and dv of a kv head sum over its G heads inside the block.  Where
//     those blocks are too few to fill the card (GQA at batch 1: 32 of 128
//     keys at a sharded rank's shape), the wgmma variant shares the G heads
//     among `kv_splits` blocks, each summing its share into fp32 partials,
//     and a reduction adds them in a fixed order;
//   * dq: one block per (batch, head, q tile), looping over the kv tiles
//     it can see.
// Blocks run the heaviest causal tiles first.
// Tiles that the causal mask or the window empties are skipped.  That is
// exact wherever a row sees at least one key (every row does when L <= S):
// a skipped tile's p is exp(NEG_INF − lse) = 0 in the reference and its ds
// is masked.  The two sweeps recompute s and dp in each, 7 products
// against FA2's 5, in exchange for no atomics and no fp32 dq scratch.
//
// Two variants, as the forward has:
//   * "wgmma": bf16 at head dims 16, 32, 64, 96, 128 and 256
//     (flash_attention_bwd_sm90.cuh): both sweeps on wgmma, the streamed
//     tiles loaded by TMA into an mbarrier ring by a producer warp, two
//     consumer warpgroups a block; p and ds go from the accumulator fragments
//     into wgmma's A registers (rounded to bf16 there: the reference keeps
//     them fp32; the CPU emulation kernels/ref.flash_bwd_mma_emulated holds
//     that rounding against the JAX reference's gradients).  Its note says
//     how the registers are shared out.
//   * "fma": fp32 at every head dim (8 … 256) and bf16 at head dim 8.
//     fp32 FMAs on the CUDA cores (no TF32: the fp32 tolerance is 1e-4),
//     32 × 32 tiles held in shared memory as fp32.
//
// What bounds it on the card: at yi-9b's training shape (q [2,2048,32,128],
// k/v [2,2048,4,128], causal) the five products over the visible pairs are
// 171.8 GFLOP, 0.174 ms at the bf16 tensor-core peak, and the bytes it must
// move (~151 MB) 0.045 ms at 3.35 TB/s: operations bound it.  The wgmma
// variant keeps the tensor cores fed from TMA-loaded shared memory (no
// thread spends registers or instructions on a copy, and the B operands are
// read by the hardware, not reloaded by every warp), overlaps one
// warpgroup's softmax-side arithmetic with the other's products, and pays
// for determinism with the two recomputed products (7 against FA2's 5);
// PERF.md has its times against the bound and against cuDNN's backward.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (src/repro_torch/kernels/build.py does this).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

#include "flash_attention_bwd_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
    return __float2bfloat16(x);   // round to nearest even, as astype(bf16)
}

// ---- the mask: sm90::Mask, shared with the wgmma sweeps ---------------------

using sm90::Mask;

// p and ds of one (query, key) pair from its raw products s = q·k and dp =
// do·v and its query's lse and delta; zero where masked
__device__ __forceinline__ void p_ds(float s, float dp, float lse, float delta, float scale,
                                     float softcap, bool ok, float& p, float& ds) {
    if (!ok) {
        p = 0.f;
        ds = 0.f;
        return;
    }
    float x = s * scale;
    float d = 1.f;
    if (softcap != 0.f) {
        const float t = tanhf(x / softcap);
        x = softcap * t;
        d = 1.f - t * t;
    }
    p = expf(x - lse);
    ds = p * (dp - delta) * d;
}

// ---- delta ----------------------------------------------------------------

// delta[b, h, i] = Σ_d do[b, i, h, d] · out[b, i, h, d] in fp32: one warp a
// row of [B·L·H] rows of hd
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, int L, int H, int hd, int rows) {
    const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (row >= rows) return;                  // uniform across the warp
    const size_t base = size_t(row) * hd;
    float acc = 0.f;
    for (int d = lane; d < hd; d += 32)
        acc = fmaf(to_f32(o[base + d]), to_f32(dout[base + d]), acc);
#pragma unroll
    for (int off = 16; off; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
        const int h = row % H;
        const int bi = row / H;
        delta[(size_t(bi / L) * H + h) * L + bi % L] = acc;
    }
}

template <typename T>
int launch_delta(const void* o, const void* dout, float* delta, int B, int L, int H, int hd,
                 cudaStream_t stream) {
    const int rows = B * L * H;
    flash_bwd_delta_kernel<T><<<(rows + 7) / 8, 256, 0, stream>>>(
        static_cast<const T*>(o), static_cast<const T*>(dout), delta, L, H, hd, rows);
    return int(cudaGetLastError());
}

// The two sweeps share one shape.  A block owns a tile of "rows" and loops
// over tiles of "columns":
//   dk/dv (KV): rows are keys (R1 = k, R2 = v), columns queries (C1 = q,
//               C2 = do) of each of the kv head's G query heads;
//                 sᵀ = R1·C1ᵀ, dpᵀ = R2·C2ᵀ, dv += pᵀ·C2, dk += dsᵀ·C1;
//   dq (!KV):   rows are queries (R1 = q, R2 = do), columns keys (C1 = k,
//               C2 = v);  s = R1·C1ᵀ, dp = R2·C2ᵀ, dq += ds·C1.
// lse and delta belong to the query: a column's under KV, a row's else.

// ---- the fma variant -------------------------------------------------------

constexpr int F_BR = 32;                 // rows per block
constexpr int F_BC = 32;                 // columns per tile
constexpr int F_NT = 256;                // threads: 32 row groups × 8 lanes

template <int HD>
constexpr size_t fma_smem_bytes() {
    return sizeof(float) * (2 * size_t(F_BR) * (HD + 1) + 2 * size_t(F_BC) * (HD + 1) +
                            2 * size_t(F_BR) * (F_BC + 1) + 2 * 32);
}

template <typename T, int HD, bool KV>
__global__ void __launch_bounds__(F_NT)
flash_bwd_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv, Mask m,
                     int H, int Hkv, float softcap, float scale) {
    constexpr int RS = HD + 1;           // padded row strides: conflict-free
    constexpr int PS = F_BC + 1;
    constexpr int CPT = HD / 8 > 0 ? HD / 8 : 1;   // accumulator columns per thread
    static_assert(HD % 8 == 0, "8 lanes share a row's columns");

    extern __shared__ float fsm[];
    float* r1 = fsm;                     // [F_BR][RS]
    float* r2 = r1 + F_BR * RS;
    float* c1 = r2 + F_BR * RS;          // [F_BC][RS]
    float* c2 = c1 + F_BC * RS;
    float* ps = c2 + F_BC * RS;          // [F_BR][PS] probabilities
    float* dss = ps + F_BR * PS;         // [F_BR][PS] ds
    float* lse_s = dss + F_BR * PS;      // [32] of the tile's queries
    float* del_s = lse_s + 32;

    const int tid = threadIdx.x;
    const int tr = tid / 8, tc = tid % 8;
    const int G = H / Hkv;
    const int tile = KV ? blockIdx.x : gridDim.x - 1 - blockIdx.x;
    const int heads = KV ? Hkv : H;
    const int b = blockIdx.y / heads;
    const int hr = blockIdx.y % heads;   // KV: the kv head; else the q head
    const int hk = KV ? hr : hr / G;
    const int n_rows = KV ? m.S : m.L;
    const int row_lo = tile * F_BR;
    const int row_hi = min(row_lo + F_BR, n_rows) - 1;
    const size_t q_row = size_t(H) * HD, kv_row = size_t(Hkv) * HD;
    const T* kb = k + size_t(b) * m.S * kv_row + size_t(hk) * HD;
    const T* vb = v + size_t(b) * m.S * kv_row + size_t(hk) * HD;

    {
        const size_t qoff = size_t(b) * m.L * q_row + size_t(hr) * HD;
        const T* s1 = KV ? kb : q + qoff;
        const T* s2 = KV ? vb : dout + qoff;
        const size_t st = KV ? kv_row : q_row;
        for (int idx = tid; idx < F_BR * HD; idx += F_NT) {
            const int r = idx / HD, d = idx % HD;
            const int gr = row_lo + r;
            const bool in = gr < n_rows;
            r1[r * RS + d] = in ? to_f32(s1[size_t(gr) * st + d]) : 0.f;
            r2[r * RS + d] = in ? to_f32(s2[size_t(gr) * st + d]) : 0.f;
        }
        if (!KV && tid < F_BR) {
            const int gr = row_lo + tid;
            const size_t li = (size_t(b) * H + hr) * m.L + gr;
            lse_s[tid] = gr < m.L ? lse[li] : 0.f;
            del_s[tid] = gr < m.L ? delta[li] : 0.f;
        }
    }

    float acc_a[CPT], acc_b[CPT];        // KV: dv, dk; else dq in acc_b
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc_a[j] = acc_b[j] = 0.f;

    int lo, hi;
    if (KV) m.rows_seeing(row_lo, row_hi, lo, hi);
    else m.keys_seen(row_lo, row_hi, lo, hi);
    const int n_cols = KV ? m.L : m.S;

    for (int g = 0; g < (KV ? G : 1) && lo <= hi; ++g) {
        const int hq = KV ? hk * G + g : hr;
        const size_t qoff = size_t(b) * m.L * q_row + size_t(hq) * HD;
        const T* src1 = KV ? q + qoff : kb;
        const T* src2 = KV ? dout + qoff : vb;
        const size_t cst = KV ? q_row : kv_row;
        for (int ct = lo / F_BC; ct <= hi / F_BC; ++ct) {
            const int col_lo = ct * F_BC;
            __syncthreads();             // the previous tile's reads are done
            for (int idx = tid; idx < F_BC * HD; idx += F_NT) {
                const int c = idx / HD, d = idx % HD;
                const int gc = col_lo + c;
                const bool in = gc < n_cols;
                c1[c * RS + d] = in ? to_f32(src1[size_t(gc) * cst + d]) : 0.f;
                c2[c * RS + d] = in ? to_f32(src2[size_t(gc) * cst + d]) : 0.f;
            }
            if (KV && tid < F_BC) {
                const int gc = col_lo + tid;
                const size_t li = (size_t(b) * H + hq) * m.L + gc;
                lse_s[tid] = gc < m.L ? lse[li] : 0.f;
                del_s[tid] = gc < m.L ? delta[li] : 0.f;
            }
            __syncthreads();

            // s and dp of row tr, columns tc + 8j
            float s[4], dp[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) s[j] = dp[j] = 0.f;
#pragma unroll 8
            for (int d = 0; d < HD; ++d) {
                const float a1 = r1[tr * RS + d], a2 = r2[tr * RS + d];
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    s[j] = fmaf(a1, c1[(tc + 8 * j) * RS + d], s[j]);
                    dp[j] = fmaf(a2, c2[(tc + 8 * j) * RS + d], dp[j]);
                }
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int c = tc + 8 * j;
                const int gr = row_lo + tr, gc = col_lo + c;
                const int ql = KV ? c : tr;
                float p, ds;
                p_ds(s[j], dp[j], lse_s[ql], del_s[ql], scale, softcap,
                     KV ? m.ok(gc, gr) : m.ok(gr, gc), p, ds);
                ps[tr * PS + c] = p;
                dss[tr * PS + c] = ds;
            }
            __syncthreads();             // p and ds complete

#pragma unroll 4
            for (int c = 0; c < F_BC; ++c) {
                const float pv = ps[tr * PS + c], dsv = dss[tr * PS + c];
#pragma unroll
                for (int j = 0; j < CPT; ++j) {
                    const int d = tc + 8 * j;
                    if (KV) acc_a[j] = fmaf(pv, c2[c * RS + d], acc_a[j]);
                    acc_b[j] = fmaf(dsv, c1[c * RS + d], acc_b[j]);
                }
            }
        }
    }

    const int gr = row_lo + tr;
    if (gr >= n_rows) return;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
        const int d = tc + 8 * j;
        if (KV) {
            const size_t o = size_t(b) * m.S * kv_row + size_t(gr) * kv_row + size_t(hk) * HD + d;
            dv[o] = from_f32<T>(acc_a[j]);
            dk[o] = from_f32<T>(acc_b[j] * scale);
        } else {
            dq[size_t(b) * m.L * q_row + size_t(gr) * q_row + size_t(hr) * HD + d] =
                from_f32<T>(acc_b[j] * scale);
        }
    }
}

template <typename T, int HD, bool KV>
int launch_fma_sweep(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* delta, void* dq, void* dk, void* dv,
                     int B, const Mask& m, int H, int Hkv, float softcap, float scale,
                     cudaStream_t stream) {
    const size_t smem = fma_smem_bytes<HD>();
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_fma_kernel<T, HD, KV>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           int(smem));
    if (err != cudaSuccess) return int(err);
    const dim3 grid(((KV ? m.S : m.L) + F_BR - 1) / F_BR, B * (KV ? Hkv : H));
    flash_bwd_fma_kernel<T, HD, KV><<<grid, F_NT, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), static_cast<T*>(dk),
        static_cast<T*>(dv), m, H, Hkv, softcap, scale);
    return int(cudaGetLastError());
}

template <typename T, int HD>
int launch_fma(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dq, void* dk, void* dv, int B,
               const Mask& m, int H, int Hkv, float softcap, float scale,
               cudaStream_t stream) {
    const int err = launch_fma_sweep<T, HD, true>(q, k, v, dout, lse, delta, dq, dk, dv, B, m,
                                                  H, Hkv, softcap, scale, stream);
    if (err) return err;
    return launch_fma_sweep<T, HD, false>(q, k, v, dout, lse, delta, dq, dk, dv, B, m, H,
                                          Hkv, softcap, scale, stream);
}

// ---- the wgmma variant's reduction -------------------------------------------

// dk and dv from the dk/dv sweep's `splits` fp32 partial sums (dk's then
// dv's, each [splits][n]), added in a fixed order: 4 elements a thread
__global__ void __launch_bounds__(256)
flash_bwd_kv_reduce_kernel(const float* __restrict__ part, bf16* __restrict__ dk,
                           bf16* __restrict__ dv, size_t n, int splits) {
    const size_t i = (size_t(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
    if (i >= n) return;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), c = a;
    for (int s = 0; s < splits; ++s) {
        const float4 x = *reinterpret_cast<const float4*>(part + s * n + i);
        const float4 y = *reinterpret_cast<const float4*>(part + (splits + s) * n + i);
        a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
        c.x += y.x; c.y += y.y; c.z += y.z; c.w += y.w;
    }
    __nv_bfloat162* k2 = reinterpret_cast<__nv_bfloat162*>(dk + i);
    __nv_bfloat162* v2 = reinterpret_cast<__nv_bfloat162*>(dv + i);
    k2[0] = __floats2bfloat162_rn(a.x, a.y);
    k2[1] = __floats2bfloat162_rn(a.z, a.w);
    v2[0] = __floats2bfloat162_rn(c.x, c.y);
    v2[1] = __floats2bfloat162_rn(c.z, c.w);
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, const void* dout,
                 const float* lse, const float* delta, void* dq, void* dk, void* dv,
                 float* part, int splits, int B, const Mask& m, int H, int Hkv, float softcap,
                 float scale, cudaStream_t stream) {
    int err = sm90::launch_bwd_dkdv<HD>(q, k, v, dout, lse, delta, dk, dv, part, splits, B,
                                        m.L, m.S, H, Hkv, m.causal, m.window, softcap, scale,
                                        stream);
    if (err) return err;
    if (splits > 1) {
        const size_t n = size_t(B) * m.S * Hkv * HD;
        flash_bwd_kv_reduce_kernel<<<unsigned((n / 4 + 255) / 256), 256, 0, stream>>>(
            part, static_cast<bf16*>(dk), static_cast<bf16*>(dv), n, splits);
        err = int(cudaGetLastError());
        if (err) return err;
    }
    return sm90::launch_bwd_dq<HD>(q, k, v, dout, lse, delta, dq, B, m.L, m.S, H, Hkv,
                                   m.causal, m.window, softcap, scale, stream);
}

#define FLASH_BWD_ARGS q, k, v, dout, lse, delta, dq, dk, dv, B, m, H, Hkv, softcap, scale, st
#define FLASH_BWD_WGMMA_ARGS \
    q, k, v, dout, lse, delta, dq, dk, dv, part, splits, B, m, H, Hkv, softcap, scale, st

int dispatch_wgmma(int hd, const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dq, void* dk, void* dv,
                   float* part, int splits, int B, const Mask& m, int H, int Hkv,
                   float softcap, float scale, cudaStream_t st) {
    switch (hd) {
        case 16: return launch_wgmma<16>(FLASH_BWD_WGMMA_ARGS);
        case 32: return launch_wgmma<32>(FLASH_BWD_WGMMA_ARGS);
        case 64: return launch_wgmma<64>(FLASH_BWD_WGMMA_ARGS);
        case 96: return launch_wgmma<96>(FLASH_BWD_WGMMA_ARGS);
        case 128: return launch_wgmma<128>(FLASH_BWD_WGMMA_ARGS);
        case 256: return launch_wgmma<256>(FLASH_BWD_WGMMA_ARGS);
        default: return int(cudaErrorInvalidValue);
    }
}

int dispatch_fma_f32(int hd, const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* delta, void* dq, void* dk, void* dv, int B,
                     const Mask& m, int H, int Hkv, float softcap, float scale,
                     cudaStream_t st) {
    switch (hd) {
        case 8: return launch_fma<float, 8>(FLASH_BWD_ARGS);
        case 16: return launch_fma<float, 16>(FLASH_BWD_ARGS);
        case 32: return launch_fma<float, 32>(FLASH_BWD_ARGS);
        case 64: return launch_fma<float, 64>(FLASH_BWD_ARGS);
        case 96: return launch_fma<float, 96>(FLASH_BWD_ARGS);
        case 128: return launch_fma<float, 128>(FLASH_BWD_ARGS);
        case 256: return launch_fma<float, 256>(FLASH_BWD_ARGS);
        default: return int(cudaErrorInvalidValue);
    }
}

bool wgmma_takes(int hd) {
    return hd == 16 || hd == 32 || hd == 64 || hd == 96 || hd == 128 || hd == 256;
}

}  // namespace

// q, out, dout, dq: [B, L, H, hd]; k, v, dk, dv: [B, S, Hkv, hd]; lse and
// delta: fp32 [B, H, L] (lse the forward's; delta is written here and read
// by the two sweeps).  All contiguous; the wgmma variant also needs q, k,
// v, dout 16-byte aligned (TMA).  kv_splits (the wgmma variant; 1 for fma):
// the dk/dv sweep's blocks a (batch, kv head, kv tile) share its G query
// heads among, each summing its share into fp32 partials in `part` (2 ·
// kv_splits · B·S·Hkv·hd floats; null when kv_splits is 1) that a
// reduction adds in a fixed order: more blocks where one a kv tile is too
// few to fill the card, and still no atomics.  dtype: 0 = fp32, 1 = bf16;
// variant: 0 = fma (fp32 at every head dim, bf16 at 8), 1 = wgmma (bf16 at
// 16, 32, 64, 96, 128 and 256).  The caller validates shapes; a variant
// that does not take the dtype or head dim returns cudaErrorInvalidValue
// without launching, and no variant stands in for another.  Returns the
// cudaError_t of the launches (0 on success).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* out, const void* dout, const float* lse,
                                   float* delta, void* dq, void* dk, void* dv, int B, int L,
                                   int S, int H, int Hkv, int hd, int dtype, int variant,
                                   int causal, int window, float softcap, float scale,
                                   int kv_splits, float* part, void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool takes = variant == 1 ? dtype == 1 && wgmma_takes(hd)
                     : variant == 0 ? (dtype == 0 && (hd == 8 || wgmma_takes(hd))) ||
                                      (dtype == 1 && hd == 8)
                                    : false;
    if (!takes || kv_splits < 1 || kv_splits > H / Hkv || (variant == 0 && kv_splits != 1) ||
        (kv_splits > 1 && part == nullptr))
        return int(cudaErrorInvalidValue);
    const Mask m{L, S, causal, window};
    const int splits = kv_splits;
    int err = dtype == 1 ? launch_delta<bf16>(out, dout, delta, B, L, H, hd, st)
                         : launch_delta<float>(out, dout, delta, B, L, H, hd, st);
    if (err) return err;
    if (variant == 1) return dispatch_wgmma(hd, FLASH_BWD_WGMMA_ARGS);
    if (dtype == 0) return dispatch_fma_f32(hd, FLASH_BWD_ARGS);
    return launch_fma<bf16, 8>(FLASH_BWD_ARGS);
}
