// Backward of the Mamba2 SSD chunked scan for Hopper (sm_90a), hand-written
// CUDA C++ with a plain C entry point.
//
// No TPU kernel computes it: the JAX package differentiates its chunked
// oracle (src/repro/models/ssm.py:99, ssd_chunked) by autodiff, and its
// Pallas kernel (src/repro/kernels/ssd_scan.py) has no backward.  Given the
// cotangents dy of y and dh_last of the final state (null: zero), it
// returns dx, ddt, da, dB and dC of the forward that ssd_scan.cu computes,
// h0 = 0.  Per (batch b, chunk c, head h), with cum the within-chunk cumsum
// of dt·a, last = cum_{Q−1}, L_ij = exp(cum_i − cum_j) for j ≤ i, cb_ij =
// C_i·B_j, r_ij = dy_i·x_j, w_j = exp(last − cum_j)·dt_j, γ_c = exp(last_c)
// and h_in[c] the state entering chunk c:
//   G_NC = dh_last, G_c = γ_c·G_{c+1} + Σ_i exp(cum_i)·dy_i ⊗ C_i,
//   dS_c = G_{c+1}, dγ_c = ⟨G_{c+1}, h_in[c]⟩;
//   dx_j  = Σ_{i≥j} cb_ij·L_ij·dt_j·dy_i + w_j·(dS_c B_j)
//   dB_j  = Σ_i r_ij·L_ij·dt_j·C_i + w_j·dS_cᵀx_j          (summed over heads)
//   dC_i  = Σ_j r_ij·L_ij·dt_j·B_j + exp(cum_i)·h_in[c]ᵀdy_i (summed over heads)
//   ddt_j = Σ_i r_ij·cb_ij·L_ij + (x_j·dS_c B_j)·exp(last − cum_j)
//   dcum_i = Σ_j t_ij − Σ_k t_ki + exp(cum_i)·dy_i·(h_in[c] C_i)
//            − (x_i·dS_c B_i)·w_i,  t_ij = r_ij·cb_ij·L_ij·dt_j,
//   and at i = Q−1 also d(last) = Σ_j (x_j·dS_c B_j)·w_j + dγ_c·γ_c;
//   d(dt·a)_k = Σ_{i≥k} dcum_i; ddt_k += d(dt·a)_k·a; da = Σ d(dt·a)_k·dt_k.
// kernels/ref.py (ssd_chunked_bwd) writes the same formulas in plain torch.
//
// Design (the "fma" variant: fp32 calls and shapes the mma variant in
// ssd_scan_bwd_sm90.cu does not take): every product in fp32 FMAs on the
// CUDA cores from x, B, C, dy in bf16 or fp32; seven launches on the
// caller's stream, through scratch the caller allocates:
//   1. ssd_bwd_states, a block per (b, c, h): cum (serial, as the fma
//      forward), S_c = Σ_j w_j·x_j ⊗ B_j and U_c = Σ_i exp(cum_i)·dy_i ⊗ C_i;
//   2. ssd_bwd_state_pass, a thread per (b, h, p, n): h_in[c] in fp32 (the mma
//      forward's scratch h_in is bf16, too coarse for gradients), then G
//      from the last chunk back; dS_c overwrites S_c;
//   3. ssd_bwd_cols, a block per (b, c, h, 64 columns j): loops over the row
//      tiles i ≥ j, recomputing the cb and r tiles, and finishes every
//      column-indexed output: dx, the head's dB, ddt's direct part, the
//      column half of dcum;
//   4. ssd_bwd_rows, a block per (b, c, h, 64 rows i): loops over the column
//      tiles j ≤ i and finishes the row-indexed ones: the head's dC and the
//      row half of dcum;
//   5. ssd_bwd_dcum, a block per (b, c, h): dγ, d(last), the reverse cumsum,
//      ddt and the chunk's share of da;
//   6. ssd_bwd_reduce_heads: dB and dC summed over heads in head order;
//   7. ssd_bwd_reduce_da: da summed over batches and chunks in order.
// Passes 6 and 7 live in ssd_bwd_common.cuh, shared with the mma variant.
// No atomics: every sum runs in a fixed order, so the gradient is the same
// from run to run.  A chunk of 256 rows of fp32 x, dy, B and C does not fit
// in shared memory, so passes 3 and 4 tile rows and columns by 64, skip the
// tiles above the diagonal, and hold one tile of each side.  The decay is
// exp(cum_i − cum_j), taken only where j ≤ i, never exp(cum_i)·exp(−cum_j),
// which overflows once cum falls below −88 (ref.SSD_STRESS_CASE does).
//
// What bounds it on the card: at the mamba2-370m training shape (Bt 2, L
// 2048, H 32, P 64, N 128, Q 256, bf16) the function must move ~33 MB
// (x, dy, dx 8.4 MB each; ~10 us at 3.35 TB/s) and needs ~26 GFLOP of
// products (~26 us at the bf16 tensor-core peak), so operations bound it.
// This design does those products in fp32 on the CUDA cores (67 TFLOP/s),
// recomputes cb and r in both passes 3 and 4 and sends the per-head dB/dC
// partials and fp32 states through memory: simple and right first; the mma
// variant takes the bf16 calls onto the tensor cores.  The multiplying
// passes hold a block an SM (their shared memory allows one or two), so they
// are built for one block an SM and may take up to 255 registers.
// Shared-memory rows are padded to an odd stride, so the inner loops are
// free of bank conflicts.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (src/repro_torch/kernels/build.py does this).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>

#include "ssd_bwd_common.cuh"

namespace {

using ssd_bwd::MAX_Q;
using ssd_bwd::NTHREADS;
constexpr int TQ = 64;                 // rows i and columns j per tile
constexpr int TG = 16;                 // 16 x 16 thread grid over a tile
constexpr int RPT = TQ / TG;           // rows (and columns) per thread
constexpr int MAX_N = 128;
constexpr int NCOL = MAX_N / TG;       // n columns per thread (n < N)
constexpr int SS = TQ + 1;             // padded score row stride
// floats ahead of the tiles in passes 3 and 4: cum, dt, the column sums
// [TG][TQ] and u_j [TQ]
constexpr int HEAD = 2 * MAX_Q + TG * TQ + TQ;

using ssd_bwd::Dims;
using ssd_bwd::from_f32;
using ssd_bwd::to_f32;

// the 16 lanes of a half warp (one tr row of the thread grid) summed in a
// fixed tree order; every lane gets the sum
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
    for (int off = 8; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off, 16);
    return v;
}

// rows [r0, r0 + TQ) of a [.., width] slab with row stride `gstride` into
// shared rows `sstride` apart, zero past `rows`, scaled by `scale[r]` if given
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int sstride, const T* src, size_t gstride,
                                          int rows, int width, const float* scale, int tid) {
    for (int idx = tid; idx < TQ * width; idx += NTHREADS) {
        const int r = idx / width, k = idx % width;
        float v = 0.f;
        if (r < rows) {
            v = to_f32(src[size_t(r) * gstride + k]);
            if (scale != nullptr) v *= scale[r];
        }
        dst[r * sstride + k] = v;
    }
}

// ---- 1. ssd_bwd_states ----------------------------------------------------
// S_c = Σ_j w_j x_j ⊗ B_j and U_c = Σ_i exp(cum_i) dy_i ⊗ C_i, [P, N] each,
// and cum.  Grid Bt·NC·H.
template <typename T, int P>
__global__ void __launch_bounds__(NTHREADS, 1)
ssd_bwd_states(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a, const T* __restrict__ bm, const T* __restrict__ cm,
               const T* __restrict__ dy, float* __restrict__ cum_out,
               float* __restrict__ s_out, float* __restrict__ u_out, Dims d) {
    constexpr int SP = NTHREADS / 32;    // state rows p per pass
    constexpr int CP = P / SP;           // state rows per thread
    constexpr int CN = MAX_N / 32;       // state columns per thread
    const int N = d.N, Q = d.Q, H = d.H, NS = N + 1;
    extern __shared__ float smem[];
    float* cum = smem;                   // [MAX_Q]
    float* dts = cum + MAX_Q;            // [MAX_Q]
    float* wq = dts + MAX_Q;             // [MAX_Q] the row weights of this product
    float* xs = wq + MAX_Q;              // [TQ][P]  x·w or dy·exp(cum)
    float* bs = xs + TQ * P;             // [TQ][NS] B or C

    const int tid = threadIdx.x, sn = tid % 32, sp = tid / 32;
    const int bch = blockIdx.x, hh = bch % H, c = (bch / H) % d.NC, b = bch / (H * d.NC);
    const int c0 = c * Q;
    const size_t xrow = size_t(H) * P;
    const float* dtb = dt + (size_t(b) * d.L + c0) * H + hh;
    for (int i = tid; i < Q; i += NTHREADS) dts[i] = dtb[size_t(i) * H];
    __syncthreads();
    if (tid == 0) {
        const float ah = a[hh];
        float run = 0.f;
        for (int i = 0; i < Q; ++i) {
            run += dts[i] * ah;
            cum[i] = run;
        }
    }
    __syncthreads();
    for (int i = tid; i < Q; i += NTHREADS) {
        cum_out[size_t(bch) * Q + i] = cum[i];
        wq[i] = expf(cum[Q - 1] - cum[i]) * dts[i];
    }
    const size_t pn0 = size_t(bch) * P * N;

    for (int which = 0; which < 2; ++which) {
        const T* rows = which == 0 ? x : dy;
        const T* cols = which == 0 ? bm : cm;
        float* out = which == 0 ? s_out : u_out;
        if (which == 1) {
            __syncthreads();
            for (int i = tid; i < Q; i += NTHREADS) wq[i] = expf(cum[i]);
        }
        float acc[CP][CN];
#pragma unroll
        for (int p = 0; p < CP; ++p)
#pragma unroll
            for (int k = 0; k < CN; ++k) acc[p][k] = 0.f;
        for (int j0 = 0; j0 < Q; j0 += TQ) {
            const int nr = min(TQ, Q - j0);
            __syncthreads();             // weights ready; previous tile's reads done
            load_rows(xs, P, rows + (size_t(b) * d.L + c0 + j0) * xrow + size_t(hh) * P, xrow,
                      nr, P, wq + j0, tid);
            load_rows(bs, NS, cols + (size_t(b) * d.L + c0 + j0) * N, size_t(N), nr, N,
                      (const float*)nullptr, tid);
            __syncthreads();
#pragma unroll 4
            for (int jj = 0; jj < TQ; ++jj) {
                float xv[CP], bv[CN];
#pragma unroll
                for (int p = 0; p < CP; ++p) xv[p] = xs[jj * P + sp + p * SP];
#pragma unroll
                for (int k = 0; k < CN; ++k) {
                    const int n = sn + k * 32;
                    bv[k] = n < N ? bs[jj * NS + n] : 0.f;
                }
#pragma unroll
                for (int p = 0; p < CP; ++p)
#pragma unroll
                    for (int k = 0; k < CN; ++k) acc[p][k] = fmaf(xv[p], bv[k], acc[p][k]);
            }
        }
#pragma unroll
        for (int p = 0; p < CP; ++p)
#pragma unroll
            for (int k = 0; k < CN; ++k) {
                const int n = sn + k * 32;
                if (n < N) out[pn0 + size_t(sp + p * SP) * N + n] = acc[p][k];
            }
    }
}

// ---- 2. ssd_bwd_state_pass ------------------------------------------------
// A thread per (b, h, p, n): h_in[c] forward, then G backward; dS_c = G_{c+1}
// overwrites S_c (s_io).
__global__ void __launch_bounds__(NTHREADS)
ssd_bwd_state_pass(const float* __restrict__ cum, float* __restrict__ s_io,
                   const float* __restrict__ u, float* __restrict__ h_in,
                   const float* __restrict__ dh_last, int P, Dims d) {
    const size_t pn = size_t(P) * d.N;
    const size_t idx = size_t(blockIdx.x) * NTHREADS + threadIdx.x;
    if (idx >= size_t(d.Bt) * d.H * pn) return;
    const int bh = int(idx / pn);
    const size_t e = idx % pn;
    const int b = bh / d.H, hh = bh % d.H;
    float hcur = 0.f;
    for (int c = 0; c < d.NC; ++c) {
        const size_t bch = (size_t(b) * d.NC + c) * d.H + hh;
        const size_t off = bch * pn + e;
        h_in[off] = hcur;
        hcur = fmaf(expf(cum[bch * d.Q + d.Q - 1]), hcur, s_io[off]);
    }
    float g = dh_last != nullptr ? dh_last[idx] : 0.f;
    for (int c = d.NC - 1; c >= 0; --c) {
        const size_t bch = (size_t(b) * d.NC + c) * d.H + hh;
        const size_t off = bch * pn + e;
        const float next = g;
        g = fmaf(expf(cum[bch * d.Q + d.Q - 1]), g, u[off]);
        s_io[off] = next;
    }
}

// cb and r of one (i, j) tile pair: rows i = tr + r·TG, columns j = tc + c·TG
template <int P>
__device__ __forceinline__ void tile_products(const float* ci, const float* bj, const float* dyi,
                                              const float* xj, int N, int tr, int tc,
                                              float (&cb)[RPT][RPT], float (&rr)[RPT][RPT]) {
    const int NS = N + 1;
    constexpr int PS = P + 1;
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int c = 0; c < RPT; ++c) cb[r][c] = rr[r][c] = 0.f;
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
            for (int c = 0; c < RPT; ++c) cb[r][c] = fmaf(cv[r], bv[c], cb[r][c]);
    }
#pragma unroll 4
    for (int p = 0; p < P; ++p) {
        float dv[RPT], xv[RPT];
#pragma unroll
        for (int r = 0; r < RPT; ++r) dv[r] = dyi[(tr + r * TG) * PS + p];
#pragma unroll
        for (int c = 0; c < RPT; ++c) xv[c] = xj[(tc + c * TG) * PS + p];
#pragma unroll
        for (int r = 0; r < RPT; ++r)
#pragma unroll
            for (int c = 0; c < RPT; ++c) rr[r][c] = fmaf(dv[r], xv[c], rr[r][c]);
    }
}

size_t tile_smem_floats(int P, int N) {
    const size_t ns = size_t(N) + 1, ps = size_t(P) + 1;
    const size_t side = TQ * ps + TQ * ns;                  // one tile of x/dy and B/C
    const size_t other = side + 2 * size_t(TQ) * SS;       // the other side + two score tiles
    const size_t state = size_t(P) * ns;                   // dS_c or h_in[c]
    return HEAD + side + (other > state ? other : state);
}

// ---- 3. ssd_bwd_cols ------------------------------------------------------
// Grid (ceil(Q/TQ), Bt·NC·H): the column tile jt of one (b, c, h).
template <typename T, int P>
__global__ void __launch_bounds__(NTHREADS, 1)
ssd_bwd_cols(const T* __restrict__ x, const float* __restrict__ dt, const T* __restrict__ bm,
             const T* __restrict__ cm, const T* __restrict__ dy, const float* __restrict__ cum_in,
             const float* __restrict__ ds, T* __restrict__ dx, float* __restrict__ db_part,
             float* __restrict__ ddt, float* __restrict__ dcol, float* __restrict__ uw, Dims d) {
    constexpr int PS = P + 1;
    constexpr int PC = P / TG;           // p columns per thread
    const int N = d.N, Q = d.Q, H = d.H, NS = N + 1;
    extern __shared__ float smem[];
    float* cum = smem;                   // [MAX_Q]
    float* dts = cum + MAX_Q;            // [MAX_Q]
    float* red = dts + MAX_Q;            // [TG][TQ] column sums
    float* uj = red + TG * TQ;           // [TQ]
    float* xj = uj + TQ;                 // [TQ][PS]
    float* bj = xj + TQ * PS;            // [TQ][NS]
    float* dyi = bj + TQ * NS;           // [TQ][PS]  } or dS [P][NS] in
    float* ci = dyi + TQ * PS;           // [TQ][NS]  } the epilogue
    float* s1 = ci + TQ * NS;            // [TQ][SS]  cb·L·dt, [i][j]
    float* s2 = s1 + TQ * SS;            // [TQ][SS]  r·L·dt,  [i][j]
    float* dsm = dyi;

    const int tid = threadIdx.x, tr = tid / TG, tc = tid % TG;
    const int jt = blockIdx.x, bch = blockIdx.y;
    const int hh = bch % H, c = (bch / H) % d.NC, b = bch / (H * d.NC);
    const int c0 = c * Q, j0 = jt * TQ;
    const size_t xrow = size_t(H) * P;
    const size_t row0 = size_t(b) * d.L + c0;                // first position of the chunk
    for (int i = tid; i < Q; i += NTHREADS) {
        cum[i] = cum_in[size_t(bch) * Q + i];
        dts[i] = dt[(row0 + i) * H + hh];
    }
    const int nj = min(TQ, Q - j0);
    load_rows(xj, PS, x + (row0 + j0) * xrow + size_t(hh) * P, xrow, nj, P,
              (const float*)nullptr, tid);
    load_rows(bj, NS, bm + (row0 + j0) * N, size_t(N), nj, N, (const float*)nullptr, tid);

    float acc_x[RPT][PC], acc_b[RPT][NCOL], vcol[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
        vcol[r] = 0.f;
#pragma unroll
        for (int k = 0; k < PC; ++k) acc_x[r][k] = 0.f;
#pragma unroll
        for (int k = 0; k < NCOL; ++k) acc_b[r][k] = 0.f;
    }

    for (int i0 = j0; i0 < Q; i0 += TQ) {
        const int ni = min(TQ, Q - i0);
        __syncthreads();                 // previous tile's reads done
        load_rows(dyi, PS, dy + (row0 + i0) * xrow + size_t(hh) * P, xrow, ni, P,
                  (const float*)nullptr, tid);
        load_rows(ci, NS, cm + (row0 + i0) * N, size_t(N), ni, N, (const float*)nullptr, tid);
        __syncthreads();
        float cb[RPT][RPT], rr[RPT][RPT];
        tile_products<P>(ci, bj, dyi, xj, N, tr, tc, cb, rr);
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
            const int i = i0 + tr + r * TG;
#pragma unroll
            for (int k = 0; k < RPT; ++k) {
                const int j = j0 + tc + k * TG;
                float v1 = 0.f, v2 = 0.f;
                if (i < Q && j <= i) {   // exp only where kept
                    const float l = expf(cum[i] - cum[j]);
                    const float m = l * dts[j];
                    v1 = cb[r][k] * m;
                    v2 = rr[r][k] * m;
                    vcol[k] = fmaf(rr[r][k] * cb[r][k], l, vcol[k]);
                }
                s1[(tr + r * TG) * SS + tc + k * TG] = v1;
                s2[(tr + r * TG) * SS + tc + k * TG] = v2;
            }
        }
        __syncthreads();
        // dx_j += Σ_i s1_ij dy_i and dB_j += Σ_i s2_ij C_i: rows j = tr + r·TG
#pragma unroll 2
        for (int ii = 0; ii < TQ; ++ii) {
            float sv1[RPT], sv2[RPT];
#pragma unroll
            for (int r = 0; r < RPT; ++r) {
                sv1[r] = s1[ii * SS + tr + r * TG];
                sv2[r] = s2[ii * SS + tr + r * TG];
            }
#pragma unroll
            for (int k = 0; k < PC; ++k) {
                const float dv = dyi[ii * PS + tc + k * TG];
#pragma unroll
                for (int r = 0; r < RPT; ++r) acc_x[r][k] = fmaf(sv1[r], dv, acc_x[r][k]);
            }
#pragma unroll
            for (int k = 0; k < NCOL; ++k) {
                const int n = tc + k * TG;
                const float cv = n < N ? ci[ii * NS + n] : 0.f;
#pragma unroll
                for (int r = 0; r < RPT; ++r) acc_b[r][k] = fmaf(sv2[r], cv, acc_b[r][k]);
            }
        }
    }

    // column sums of r·cb·L over the 16 thread rows, in order
    __syncthreads();
#pragma unroll
    for (int k = 0; k < RPT; ++k) red[tr * TQ + tc + k * TG] = vcol[k];
    // dS_c into the freed tiles
    const size_t pn = size_t(P) * N;
    for (int idx = tid; idx < P * N; idx += NTHREADS)
        dsm[(idx / N) * NS + idx % N] = ds[size_t(bch) * pn + idx];
    __syncthreads();
    float vsum = 0.f;
    if (tid < TQ)
        for (int t = 0; t < TG; ++t) vsum += red[t * TQ + tid];

    const float last = cum[Q - 1];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
        const int jl = tr + r * TG, j = j0 + jl;
        const float w = j < Q ? expf(last - cum[j]) * dts[j] : 0.f;
        // dS_c B_j → dx and u_j = x_j·(dS_c B_j)
        float up = 0.f;
#pragma unroll
        for (int k = 0; k < PC; ++k) {
            const int p = tc + k * TG;
            float sb = 0.f;
            for (int n = 0; n < N; ++n) sb = fmaf(bj[jl * NS + n], dsm[p * NS + n], sb);
            acc_x[r][k] = fmaf(w, sb, acc_x[r][k]);
            up = fmaf(xj[jl * PS + p], sb, up);
        }
        up = half_warp_sum(up);
        if (tc == 0) uj[jl] = up;
        // w_j·dS_cᵀ x_j → dB
#pragma unroll
        for (int k = 0; k < NCOL; ++k) {
            const int n = tc + k * TG;
            if (n >= N) continue;
            float sx = 0.f;
            for (int p = 0; p < P; ++p) sx = fmaf(dsm[p * NS + n], xj[jl * PS + p], sx);
            acc_b[r][k] = fmaf(w, sx, acc_b[r][k]);
        }
        if (j < Q) {
            const size_t pos = row0 + j;
#pragma unroll
            for (int k = 0; k < PC; ++k)
                dx[pos * xrow + size_t(hh) * P + tc + k * TG] = from_f32<T>(acc_x[r][k]);
#pragma unroll
            for (int k = 0; k < NCOL; ++k) {
                const int n = tc + k * TG;
                if (n < N) db_part[(pos * H + hh) * N + n] = acc_b[r][k];
            }
        }
    }
    __syncthreads();
    if (tid < TQ && j0 + tid < Q) {
        const int j = j0 + tid;
        const float u = uj[tid];
        const float e = expf(last - cum[j]);
        const size_t o = (row0 + j) * H + hh;
        ddt[o] = fmaf(u, e, vsum);
        dcol[o] = -dts[j] * vsum - u * e * dts[j];
        uw[o] = u * e * dts[j];
    }
}

// ---- 4. ssd_bwd_rows ------------------------------------------------------
// Grid (ceil(Q/TQ), Bt·NC·H): the row tile it of one (b, c, h).
template <typename T, int P>
__global__ void __launch_bounds__(NTHREADS, 1)
ssd_bwd_rows(const T* __restrict__ x, const float* __restrict__ dt, const T* __restrict__ bm,
             const T* __restrict__ cm, const T* __restrict__ dy, const float* __restrict__ cum_in,
             const float* __restrict__ h_in, float* __restrict__ dc_part,
             float* __restrict__ drow, Dims d) {
    constexpr int PS = P + 1;
    constexpr int PC = P / TG;
    const int N = d.N, Q = d.Q, H = d.H, NS = N + 1;
    extern __shared__ float smem[];
    float* cum = smem;                   // [MAX_Q]
    float* dts = cum + MAX_Q;            // [MAX_Q]
    float* dyi = smem + HEAD;            // [TQ][PS]
    float* ci = dyi + TQ * PS;           // [TQ][NS]
    float* xj = ci + TQ * NS;            // [TQ][PS]  } or h_in[c] [P][NS] in
    float* bj = xj + TQ * PS;            // [TQ][NS]  } the epilogue
    float* s2 = bj + TQ * NS;            // [TQ][SS]  r·L·dt, [i][j]
    float* hs = xj;

    const int tid = threadIdx.x, tr = tid / TG, tc = tid % TG;
    const int it = blockIdx.x, bch = blockIdx.y;
    const int hh = bch % H, c = (bch / H) % d.NC, b = bch / (H * d.NC);
    const int c0 = c * Q, i0 = it * TQ;
    const size_t xrow = size_t(H) * P;
    const size_t row0 = size_t(b) * d.L + c0;
    for (int i = tid; i < Q; i += NTHREADS) {
        cum[i] = cum_in[size_t(bch) * Q + i];
        dts[i] = dt[(row0 + i) * H + hh];
    }
    const int ni = min(TQ, Q - i0);
    load_rows(dyi, PS, dy + (row0 + i0) * xrow + size_t(hh) * P, xrow, ni, P,
              (const float*)nullptr, tid);
    load_rows(ci, NS, cm + (row0 + i0) * N, size_t(N), ni, N, (const float*)nullptr, tid);

    float acc_c[RPT][NCOL], trow[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
        trow[r] = 0.f;
#pragma unroll
        for (int k = 0; k < NCOL; ++k) acc_c[r][k] = 0.f;
    }
    for (int j0 = 0; j0 <= i0; j0 += TQ) {
        const int nj = min(TQ, Q - j0);
        __syncthreads();
        load_rows(xj, PS, x + (row0 + j0) * xrow + size_t(hh) * P, xrow, nj, P,
                  (const float*)nullptr, tid);
        load_rows(bj, NS, bm + (row0 + j0) * N, size_t(N), nj, N, (const float*)nullptr, tid);
        __syncthreads();
        float cb[RPT][RPT], rr[RPT][RPT];
        tile_products<P>(ci, bj, dyi, xj, N, tr, tc, cb, rr);
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
            const int i = i0 + tr + r * TG;
#pragma unroll
            for (int k = 0; k < RPT; ++k) {
                const int j = j0 + tc + k * TG;
                float v2 = 0.f;
                if (i < Q && j <= i) {
                    const float m = expf(cum[i] - cum[j]) * dts[j];
                    v2 = rr[r][k] * m;
                    trow[r] = fmaf(v2, cb[r][k], trow[r]);
                }
                s2[(tr + r * TG) * SS + tc + k * TG] = v2;
            }
        }
        __syncthreads();
        // dC_i += Σ_j s2_ij B_j: rows i = tr + r·TG
#pragma unroll 2
        for (int jj = 0; jj < TQ; ++jj) {
            float sv[RPT];
#pragma unroll
            for (int r = 0; r < RPT; ++r) sv[r] = s2[(tr + r * TG) * SS + jj];
#pragma unroll
            for (int k = 0; k < NCOL; ++k) {
                const int n = tc + k * TG;
                const float bv = n < N ? bj[jj * NS + n] : 0.f;
#pragma unroll
                for (int r = 0; r < RPT; ++r) acc_c[r][k] = fmaf(sv[r], bv, acc_c[r][k]);
            }
        }
    }

    // h_in[c] into the freed tiles
    __syncthreads();
    const size_t pn = size_t(P) * N;
    for (int idx = tid; idx < P * N; idx += NTHREADS)
        hs[(idx / N) * NS + idx % N] = h_in[size_t(bch) * pn + idx];
    __syncthreads();
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
        const int il = tr + r * TG, i = i0 + il;
        const float e = i < Q ? expf(cum[i]) : 0.f;
        // dy_i·(h_in C_i)
        float hp = 0.f;
#pragma unroll
        for (int k = 0; k < PC; ++k) {
            const int p = tc + k * TG;
            float hc = 0.f;
            for (int n = 0; n < N; ++n) hc = fmaf(ci[il * NS + n], hs[p * NS + n], hc);
            hp = fmaf(dyi[il * PS + p], hc, hp);
        }
        hp = half_warp_sum(hp);
        const float t = half_warp_sum(trow[r]);
        // exp(cum_i)·h_inᵀ dy_i → dC
#pragma unroll
        for (int k = 0; k < NCOL; ++k) {
            const int n = tc + k * TG;
            if (n >= N) continue;
            float hd = 0.f;
            for (int p = 0; p < P; ++p) hd = fmaf(hs[p * NS + n], dyi[il * PS + p], hd);
            acc_c[r][k] = fmaf(e, hd, acc_c[r][k]);
        }
        if (i < Q) {
            const size_t pos = row0 + i;
#pragma unroll
            for (int k = 0; k < NCOL; ++k) {
                const int n = tc + k * TG;
                if (n < N) dc_part[(pos * H + hh) * N + n] = acc_c[r][k];
            }
            if (tc == 0) drow[pos * H + hh] = fmaf(e, hp, t);
        }
    }
}

// ---- 5. ssd_bwd_dcum ------------------------------------------------------
// Grid Bt·NC·H: dγ, d(last), the reverse cumsum of dcum, ddt, da per chunk.
__global__ void __launch_bounds__(NTHREADS)
ssd_bwd_dcum(const float* __restrict__ dt, const float* __restrict__ a,
             const float* __restrict__ cum_in, const float* __restrict__ ds,
             const float* __restrict__ h_in, const float* __restrict__ drow,
             const float* __restrict__ dcol, const float* __restrict__ uw,
             float* __restrict__ ddt, float* __restrict__ da_part, int P, Dims d) {
    __shared__ float dcum[MAX_Q];
    __shared__ float dda[MAX_Q];
    __shared__ float part[NTHREADS];
    const int tid = threadIdx.x, bch = blockIdx.x, Q = d.Q, H = d.H;
    const int hh = bch % H, c = (bch / H) % d.NC, b = bch / (H * d.NC);
    const size_t row0 = size_t(b) * d.L + size_t(c) * Q;
    const size_t pn = size_t(P) * d.N;
    float g = 0.f;
    for (size_t e = tid; e < pn; e += NTHREADS)
        g = fmaf(ds[size_t(bch) * pn + e], h_in[size_t(bch) * pn + e], g);
    part[tid] = g;
    for (int i = tid; i < Q; i += NTHREADS) {
        const size_t o = (row0 + i) * H + hh;
        dcum[i] = drow[o] + dcol[o];
    }
    __syncthreads();
    for (int s = NTHREADS / 2; s > 0; s /= 2) {      // dγ, a fixed tree
        if (tid < s) part[tid] += part[tid + s];
        __syncthreads();
    }
    if (tid == 0) {
        const float last = cum_in[size_t(bch) * Q + Q - 1];
        float dl = part[0] * expf(last);
        for (int j = 0; j < Q; ++j) dl += uw[(row0 + j) * H + hh];
        float run = 0.f, dap = 0.f;
        for (int k = Q - 1; k >= 0; --k) {
            run += dcum[k] + (k == Q - 1 ? dl : 0.f);
            dda[k] = run;
            dap = fmaf(run, dt[(row0 + k) * H + hh], dap);
        }
        da_part[bch] = dap;
    }
    __syncthreads();
    const float ah = a[hh];
    for (int k = tid; k < Q; k += NTHREADS) {
        const size_t o = (row0 + k) * H + hh;
        ddt[o] = fmaf(dda[k], ah, ddt[o]);
    }
}

struct Args {
    const void *x, *dt, *a, *bm, *cm, *dy, *dh_last;
    void *dx, *ddt, *da, *dbm, *dcm;
    float *cum, *states, *u, *h_in, *db_part, *dc_part, *drow, *dcol, *uw, *da_part;
};

template <typename KernelT>
cudaError_t allow_smem(KernelT* k, size_t bytes) {
    return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
}

#define SSD_BWD_CHECK(expr)                        \
    do {                                           \
        cudaError_t e_ = (expr);                   \
        if (e_ != cudaSuccess) return int(e_);     \
    } while (0)

template <typename T, int P>
int launch(const Args& g, Dims d, cudaStream_t st) {
    const T* x = static_cast<const T*>(g.x);
    const T* bm = static_cast<const T*>(g.bm);
    const T* cm = static_cast<const T*>(g.cm);
    const T* dy = static_cast<const T*>(g.dy);
    const float* dt = static_cast<const float*>(g.dt);
    const float* a = static_cast<const float*>(g.a);
    float* ddt = static_cast<float*>(g.ddt);
    const int nbch = d.Bt * d.NC * d.H;
    const int nt = (d.Q + TQ - 1) / TQ;

    const size_t s1 = sizeof(float) * (3 * size_t(MAX_Q) + size_t(TQ) * P +
                                       size_t(TQ) * (d.N + 1));
    SSD_BWD_CHECK(allow_smem(ssd_bwd_states<T, P>, s1));
    ssd_bwd_states<T, P><<<nbch, NTHREADS, s1, st>>>(x, dt, a, bm, cm, dy, g.cum, g.states, g.u,
                                                   d);
    SSD_BWD_CHECK(cudaGetLastError());

    const size_t nstate = size_t(d.Bt) * d.H * P * d.N;
    ssd_bwd_state_pass<<<unsigned((nstate + NTHREADS - 1) / NTHREADS), NTHREADS, 0, st>>>(
        g.cum, g.states, g.u, g.h_in, static_cast<const float*>(g.dh_last), P, d);
    SSD_BWD_CHECK(cudaGetLastError());

    const size_t s3 = sizeof(float) * tile_smem_floats(P, d.N);
    SSD_BWD_CHECK(allow_smem(ssd_bwd_cols<T, P>, s3));
    ssd_bwd_cols<T, P><<<dim3(nt, nbch), NTHREADS, s3, st>>>(
        x, dt, bm, cm, dy, g.cum, g.states, static_cast<T*>(g.dx), g.db_part, ddt, g.dcol,
        g.uw, d);
    SSD_BWD_CHECK(cudaGetLastError());

    SSD_BWD_CHECK(allow_smem(ssd_bwd_rows<T, P>, s3));
    ssd_bwd_rows<T, P><<<dim3(nt, nbch), NTHREADS, s3, st>>>(x, dt, bm, cm, dy, g.cum, g.h_in,
                                                           g.dc_part, g.drow, d);
    SSD_BWD_CHECK(cudaGetLastError());

    ssd_bwd_dcum<<<nbch, NTHREADS, 0, st>>>(dt, a, g.cum, g.states, g.h_in, g.drow, g.dcol,
                                          g.uw, ddt, g.da_part, P, d);
    SSD_BWD_CHECK(cudaGetLastError());

    const size_t nbn = size_t(d.Bt) * d.L * d.N;
    ssd_bwd::ssd_bwd_reduce_heads<T><<<unsigned((nbn + NTHREADS - 1) / NTHREADS), NTHREADS, 0, st>>>(
        g.db_part, g.dc_part, static_cast<T*>(g.dbm), static_cast<T*>(g.dcm), d.H, d);
    SSD_BWD_CHECK(cudaGetLastError());

    ssd_bwd::ssd_bwd_reduce_da<<<1, NTHREADS, 0, st>>>(g.da_part, static_cast<float*>(g.da), d);
    return int(cudaGetLastError());
}

template <typename T>
int dispatch_p(int P, const Args& g, Dims d, cudaStream_t st) {
    switch (P) {
        case 16: return launch<T, 16>(g, d, st);
        case 32: return launch<T, 32>(g, d, st);
        case 64: return launch<T, 64>(g, d, st);
        case 128: return launch<T, 128>(g, d, st);
        default: return int(cudaErrorInvalidValue);
    }
}

}  // namespace

// x, dy, dx: [Bt, L, H, P]; dt, ddt: [Bt, L, H] fp32; a, da: [H] fp32; bm,
// cm, dbm, dcm: [Bt, L, N]; dh_last: [Bt, H, P, N] fp32 or null.  x, B, C,
// dy and their gradients share dtype (0 = fp32, 1 = bf16).  Scratch, all
// fp32 and supplied by the caller: cum [Bt, L/Q, H, Q]; states, u, h_in
// [Bt, L/Q, H, P, N]; db_part, dc_part [Bt, L, H, N]; drow, dcol, uw [Bt,
// L, H]; da_part [Bt, L/Q, H].  All contiguous.  Returns the cudaError_t of
// the first launch that fails (0 on success); a shape it does not take (P
// outside {16, 32, 64, 128}, N outside [1, 128], Q outside [1, 256], L % Q
// != 0) returns cudaErrorInvalidValue without launching.
extern "C" int ssd_scan_bwd(const void* x, const void* dt, const void* a, const void* bm,
                            const void* cm, const void* dy, const void* dh_last, void* dx,
                            void* ddt, void* da, void* dbm, void* dcm, void* cum, void* states,
                            void* u, void* h_in, void* db_part, void* dc_part, void* drow,
                            void* dcol, void* uw, void* da_part, int Bt, int L, int H, int P,
                            int N, int Q, int dtype, void* stream) {
    if (Bt < 1 || L < 1 || H < 1 || N < 1 || N > MAX_N || Q < 1 || Q > MAX_Q || L % Q != 0)
        return int(cudaErrorInvalidValue);
    const Args g{x, dt, a, bm, cm, dy, dh_last, dx, ddt, da, dbm, dcm,
                 static_cast<float*>(cum), static_cast<float*>(states),
                 static_cast<float*>(u), static_cast<float*>(h_in),
                 static_cast<float*>(db_part), static_cast<float*>(dc_part),
                 static_cast<float*>(drow), static_cast<float*>(dcol),
                 static_cast<float*>(uw), static_cast<float*>(da_part)};
    const Dims d{Bt, L, H, N, Q, L / Q};
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return dispatch_p<float>(P, g, d, st);
    if (dtype == 1) return dispatch_p<__nv_bfloat16>(P, g, d, st);
    return int(cudaErrorInvalidValue);
}
