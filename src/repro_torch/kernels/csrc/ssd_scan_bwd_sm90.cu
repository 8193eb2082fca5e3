// Backward of the Mamba2 SSD chunked scan on Hopper's tensor cores (sm_90a),
// hand-written CUDA C++ with a plain C entry point: the "mma" variant, for
// bf16 x, B, C, dy with P in {16, 32, 64, 128}, N a multiple of 16 up to 128
// and Q a multiple of 16 up to 256 (the forward's mma domain).  Every other
// call runs the fma variant, ssd_scan_bwd.cu, whose note has the formulas;
// both compute the same gradients, h0 = 0, and no TPU kernel computes them
// (the JAX package takes autodiff of src/repro/models/ssm.py:99 ssd_chunked).
//
// Design: seven launches on the caller's stream, through scratch the caller
// allocates; every product is mma.sync m16n8k16 on bf16 operands into fp32
// accumulators (helpers in ssd_mma.cuh, shared with the forward):
//   1. ssd_bwd_mma_states, a block per (b, c, h): cum by the forward's block
//      scan, S_c = (X ⊙ w)ᵀB and U_c = (dy ⊙ exp(cum))ᵀC;
//   2. ssd_bwd_mma_state_pass, a thread per 4 of (b, h, p, n): h_in[c] and
//      dS_c in fp32, written split into bf16 hi and lo for passes 3 and 4,
//      and dγ_c = ⟨dS_c, h_in[c]⟩ summed by warp;
//   3. ssd_bwd_mma_cols, a block per (b, c, 64 columns j, group of G heads):
//      C·Bᵀ of the block's columns against every row tile i ≥ j, once for
//      the group, kept in shared memory as fp32 fragments; then head by head
//      dy·xᵀ, the masked scores, dx, ddt's direct part and the column half of
//      dcum, and dB summed over the group's heads in registers;
//   4. ssd_bwd_mma_rows, a block per (b, c, 64 rows i, group): the same for
//      the row-indexed outputs, dC summed over the group and the row half of
//      dcum, computing dy·xᵀ again;
//   5. ssd_bwd_mma_dcum, a block per (b, c, h), a thread per row: dγ,
//      d(last), the reverse cumsum of dcum, ddt and the chunk's share of da;
//   6.–7. ssd_bwd_reduce_heads (the H/G group partials of dB and dC in group
//      order) and ssd_bwd_reduce_da (ssd_bwd_common.cuh).
// Passes 3 and 4 run 8 warps, two on each 16-row strip of the block's tile:
// in the loop over tiles each warp takes two of the four 16-column pairs of
// the other index, and the second warp's partials join the first's through
// shared memory; a head's state terms split the output columns between the
// two.  A tile pair's copies go through two cp.async stages, the next under
// this one's products.  No atomics: every sum runs in a fixed order, so two
// launches on the same inputs give the same bits.
//
// Numerics (kernels/ref.py ssd_chunked_bwd_mma emulates each rounding; the
// CPU tests hold it against jax.vjp and the plain version):
//   * C·Bᵀ and dy·xᵀ multiply bf16 values, so they are exact up to fp32
//     summation order; ddt and dcum take t_ij = r_ij·cb_ij·L_ij·dt_j from
//     them in registers, never from a rounded score;
//   * every fp32 operand is split into bf16 hi = bf16(v) and lo = bf16(v −
//     hi), two products into one accumulator: X ⊙ w, dy ⊙ exp(cum), dS_c and
//     h_in[c] feed ddt and da (held at 1e-4 of their scale), the masked
//     scores feed dx, dB, dC, which one more rounding would put outside rtol
//     1e-2 on top of their own bf16 rounding;
//   * the state terms of dB and dC multiply bf16 x or dy by the split dS_c
//     or h_in[c] and scale each row by w_j or exp(cum_i) after the product;
//   * the decay is exp(cum_i − cum_j), taken only where j ≤ i, never
//     exp(cum_i)·exp(−cum_j) (ref.SSD_STRESS_CASE drives cum below −88).
//     For j before the 64-row tile of i, and only where cum never rises (a ≤
//     0, dt ≥ 0, checked per block and head), it is the product of
//     exp(cum_i − cum_i0) and exp(cum_i0 − cum_j), both at most 1, as in the
//     forward; the state carried across chunks stays fp32.
//
// What bounds it: at the mamba2-370m training shape (Bt 2, L 2048, H 32, P
// 64, N 128, Q 256) the function moves ~56 MB and needs ~26 GFLOP, 26 us at
// the bf16 peak, so operations bound it.  This design issues ~58 GFLOP of
// mma.sync (the hi/lo splits, whole 16-column pairs on the diagonal, dy·xᵀ
// in both passes 3 and 4), below wgmma's rate, from one block of 8 warps an
// SM (C·Bᵀ's fragments take 64 KB of shared memory).  Measured on the card,
// passes 3 and 4 take most of the time.  Taking work out of them
// (launch/ssd_bwd_experiments.py ablate, PERF.md §6): the dB/dC products,
// 35 % of their mma work, cost 17 % of their time, the per-head state terms
// 25 %, the diagonal tiles' exps 4 %; the tensor cores do not bind.
// Shared-memory rows are padded by 16 bytes, so the 8 rows an ldmatrix
// reads fall in distinct banks.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (src/repro_torch/kernels/build.py does this).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

#include "ssd_bwd_common.cuh"
#include "ssd_mma.cuh"

namespace {

using namespace ssd_sm90;
using ssd_bwd::Dims;

constexpr int MAX_Q = 256;
constexpr int MAX_N = 128;
constexpr int T = 64;                     // rows of a tile of i or of j
constexpr int MAX_T = MAX_Q / T;          // tiles of a chunk
constexpr int SN = MAX_N + 8;             // padded row stride of an N-wide bf16 tile
constexpr int STATE_THREADS = 256;        // pass 1: 8 warps
constexpr int PASS_THREADS = 256;         // pass 2
constexpr int PAIR_THREADS = 256;         // passes 3 and 4: 2 warps a strip of 16 rows
constexpr int CB_TILE = T * T;            // floats of one C·Bᵀ tile
constexpr int DCUM_THREADS = MAX_Q;       // pass 5: a thread per row of the chunk

// the 4 lanes of a quad (one row of an mma fragment) summed; every lane gets it
__device__ __forceinline__ float quad_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    return v;
}

// ==========================================================================
// 1. chunk states S_c and U_c
// ==========================================================================

template <int P>
struct StatesCfg {
    static constexpr int SP = P + 8;                  // padded X / dy row stride
    static constexpr int WARPS_M = P / 16;            // warps along P
    static constexpr int NTW = P / 8;                 // n8 tiles per warp (N = 128)
    static constexpr int STAGE = T * SP * 2 + T * SN * 2;
    static constexpr int SMEM = 3 * MAX_Q * 4 + 8 * 4 + 2 * STAGE;
};

// x, dy: [Bt, L, H, P]; bm, cm: [Bt, L, N]; cum_out: [Bt, nc, H, Q];
// s_out, u_out: [Bt, nc, H, P, N] fp32.  The K tiles of the two products run
// as one sequence of 2·ceil(Q/64) tiles through two shared-memory stages.
template <int P>
__global__ void __launch_bounds__(STATE_THREADS, 1)
ssd_bwd_mma_states(const bf16* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ a, const bf16* __restrict__ bm,
                   const bf16* __restrict__ cm, const bf16* __restrict__ dy,
                   float* __restrict__ cum_out, float* __restrict__ s_out,
                   float* __restrict__ u_out, Dims d) {
    using C = StatesCfg<P>;
    extern __shared__ __align__(16) unsigned char ssd_smem[];
    float* cum_s = reinterpret_cast<float*>(ssd_smem);   // [MAX_Q]
    float* w_s = cum_s + MAX_Q;                       // [MAX_Q] exp(last − cum)·dt
    float* e_s = w_s + MAX_Q;                         // [MAX_Q] exp(cum)
    float* wtot = e_s + MAX_Q;                        // [8] warp totals of the scan
    unsigned char* stages = reinterpret_cast<unsigned char*>(wtot + 8);

    const int N = d.N, Q = d.Q, H = d.H;
    const int bch = blockIdx.x, h = bch % H, c = (bch / H) % d.NC, b = bch / (H * d.NC);
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const size_t row0 = size_t(b) * d.L + size_t(c) * Q;
    const size_t xrow = size_t(H) * P;
    const int ntiles = (Q + T - 1) / T;
    auto xs_of = [&](int s) { return reinterpret_cast<bf16*>(stages + s * C::STAGE); };
    auto bs_of = [&](int s) { return xs_of(s) + T * C::SP; };
    // tile k: X and B for k < ntiles, dy and C after
    auto fetch = [&](int k) {
        const bool second = k >= ntiles;
        const int j0 = (k % ntiles) * T, rows = min(T, Q - j0);
        load_tile(xs_of(k % 2), C::SP, (second ? dy : x) + (row0 + j0) * xrow + size_t(h) * P,
                  xrow, rows, P, tid, STATE_THREADS);
        load_tile(bs_of(k % 2), SN, (second ? cm : bm) + (row0 + j0) * N, N, rows, N, tid,
                  STATE_THREADS);
        cp_async_commit();
    };
    fetch(0);

    // cum = cumsum(dt·a): the forward's Kogge-Stone scan in each warp, then
    // over the warp totals
    const float dv = tid < Q ? dt[(row0 + tid) * H + h] : 0.f;
    float v = dv * a[h];
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
        const float u = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += u;
    }
    if (lane == 31) wtot[warp] = v;
    __syncthreads();
    if (warp == 0) {
        float t = lane < 8 ? wtot[lane] : 0.f;
#pragma unroll
        for (int off = 1; off < 8; off *= 2) {
            const float u = __shfl_up_sync(0xffffffffu, t, off);
            if (lane >= off) t += u;
        }
        __syncwarp();
        if (lane < 8) wtot[lane] = t;
    }
    __syncthreads();
    if (warp > 0) v += wtot[warp - 1];
    if (tid < Q) {
        cum_s[tid] = v;
        cum_out[size_t(bch) * Q + tid] = v;
    }
    __syncthreads();
    if (tid < Q) {
        w_s[tid] = expf(cum_s[Q - 1] - v) * dv;
        e_s[tid] = expf(v);
    }

    const int wm = warp % C::WARPS_M, wn = warp / C::WARPS_M;
    const int p0 = wm * 16, nbase = wn * C::NTW * 8;
    const int g = lane / 4, t = lane % 4;
    float acc[C::NTW][4];
#pragma unroll
    for (int i = 0; i < C::NTW; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][k] = 0.f;

    for (int k = 0; k < 2 * ntiles; ++k) {
        const int j0 = (k % ntiles) * T, rows = min(T, Q - j0);
        if (k + 1 < 2 * ntiles) {
            __syncthreads();                          // tile k − 1's stage is free
            fetch(k + 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();                              // tile k (and the weights) visible
        const bf16* xs = xs_of(k % 2);
        const bf16* bs = bs_of(k % 2);
        const float* wv = (k < ntiles ? w_s : e_s) + j0;
        // acc[p][n] += Σ_k (rows ⊙ weight)[k][p] · cols[k][n], split hi + lo
        for (int k0 = 0; k0 < rows; k0 += 16) {
            uint32_t xf[4], ahi[4], alo[4];
            ldsm_x4_t(xf, xs + (k0 + lane % 8 + lane / 16 * 8) * C::SP + p0 + (lane / 8) % 2 * 8);
            const float w0 = wv[k0 + 2 * t], w1 = wv[k0 + 2 * t + 1];
            const float w8 = wv[k0 + 8 + 2 * t], w9 = wv[k0 + 9 + 2 * t];
            split_scaled(xf[0], w0, w1, ahi[0], alo[0]);
            split_scaled(xf[1], w0, w1, ahi[1], alo[1]);
            split_scaled(xf[2], w8, w9, ahi[2], alo[2]);
            split_scaled(xf[3], w8, w9, ahi[3], alo[3]);
#pragma unroll
            for (int np = 0; np < C::NTW / 2; ++np) {
                const int n0 = nbase + np * 16;
                if (n0 < N) {
                    uint32_t bf[4];
                    ldsm_x4_t(bf, bs + (k0 + lane % 8 + (lane / 8) % 2 * 8) * SN + n0 +
                                      lane / 16 * 8);
                    mma(acc[2 * np], ahi, bf[0], bf[1]);
                    mma(acc[2 * np + 1], ahi, bf[2], bf[3]);
                    mma(acc[2 * np], alo, bf[0], bf[1]);
                    mma(acc[2 * np + 1], alo, bf[2], bf[3]);
                }
            }
        }
        if (k == ntiles - 1 || k == 2 * ntiles - 1) {
            float* out = (k < ntiles ? s_out : u_out) + size_t(bch) * P * N;
#pragma unroll
            for (int i = 0; i < C::NTW; ++i) {
                const int n = nbase + i * 8 + 2 * t;
                if (n < N) {
                    *reinterpret_cast<float2*>(out + size_t(p0 + g) * N + n) =
                        make_float2(acc[i][0], acc[i][1]);
                    *reinterpret_cast<float2*>(out + size_t(p0 + g + 8) * N + n) =
                        make_float2(acc[i][2], acc[i][3]);
                }
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
            }
        }
    }
}

// ==========================================================================
// 2. the state across chunks
// ==========================================================================

// (v.x, v.y, v.z, v.w) split into bf16 hi and lo, four of each
__device__ __forceinline__ void split4(float4 v, uint2& hi, uint2& lo) {
    split2(v.x, v.y, hi.x, lo.x);
    split2(v.z, v.w, hi.y, lo.y);
}

// h_in[c] forward, then G backward, in fp32 as the fma variant's state pass
// (the same fused multiply-adds), a thread per 4 consecutive (p, n) of one
// (b, h).  Passes 3 and 4 read h_in[c] and dS_c = G_{c+1} only split into
// bf16 hi and lo ([2, Bt, nc, H, P, N]: hi, then lo, `half4` uint2 apart), so
// that is all it writes of them, with dγ_c = ⟨dS_c, h_in[c]⟩ summed over each
// warp's 128 (p, n) (h_in[c] read back as hi + lo): [Bt, nc, H, P·N/128].
__global__ void __launch_bounds__(PASS_THREADS)
ssd_bwd_mma_state_pass(const float* __restrict__ cum, const float4* __restrict__ s,
                       const float4* __restrict__ u, const float4* __restrict__ dh_last,
                       uint2* __restrict__ h_split, uint2* __restrict__ ds_split,
                       float* __restrict__ dgamma_part, int PN4, size_t half4, Dims d) {
    const size_t idx = size_t(blockIdx.x) * PASS_THREADS + threadIdx.x;
    // P·N is a multiple of 256, so a warp never straddles two (b, h)
    if (idx >= size_t(d.Bt) * d.H * PN4) return;
    const size_t bh = idx / PN4, e4 = idx % PN4;
    const int b = int(bh / d.H), h = int(bh % d.H);
    const int wpart = int(e4 / 32), nparts = PN4 / 32;
    float4 hc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c = 0; c < d.NC; ++c) {
        const size_t bch = (size_t(b) * d.NC + c) * d.H + h;
        const size_t off = bch * PN4 + e4;
        split4(hc, h_split[off], h_split[half4 + off]);
        const float gamma = expf(cum[bch * d.Q + d.Q - 1]);
        const float4 sv = s[off];
        hc = make_float4(fmaf(gamma, hc.x, sv.x), fmaf(gamma, hc.y, sv.y),
                         fmaf(gamma, hc.z, sv.z), fmaf(gamma, hc.w, sv.w));
    }
    float4 gv = dh_last != nullptr ? dh_last[idx] : make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c = d.NC - 1; c >= 0; --c) {
        const size_t bch = (size_t(b) * d.NC + c) * d.H + h;
        const size_t off = bch * PN4 + e4;
        const float4 next = gv;
        const float gamma = expf(cum[bch * d.Q + d.Q - 1]);
        const float4 uv = u[off];
        gv = make_float4(fmaf(gamma, gv.x, uv.x), fmaf(gamma, gv.y, uv.y),
                         fmaf(gamma, gv.z, uv.z), fmaf(gamma, gv.w, uv.w));
        split4(next, ds_split[off], ds_split[half4 + off]);
        const uint2 hh = h_split[off], hl = h_split[half4 + off];
        float part = next.x * (lo_f32(hh.x) + lo_f32(hl.x));
        part = fmaf(next.y, hi_f32(hh.x) + hi_f32(hl.x), part);
        part = fmaf(next.z, lo_f32(hh.y) + lo_f32(hl.y), part);
        part = fmaf(next.w, hi_f32(hh.y) + hi_f32(hl.y), part);
#pragma unroll
        for (int off2 = 16; off2 > 0; off2 /= 2) part += __shfl_xor_sync(0xffffffffu, part, off2);
        if (threadIdx.x % 32 == 0) dgamma_part[bch * nparts + wpart] = part;
    }
}

// ==========================================================================
// 3. and 4. the pair products
// ==========================================================================

template <int P>
struct PairCfg {
    static constexpr int SP = P + 8;                  // padded x / dy row stride
    static constexpr int PG = P / 16;                 // 16-column groups over P
    static constexpr int X_TILE = T * SP;             // bf16 of an x or dy tile
    static constexpr int N_TILE = T * SN;             // bf16 of a B or C tile
    static constexpr int STAGE = X_TILE + N_TILE;
    // dS_c or h_in[c], hi and lo, lives in the two stages in a head's
    // prologue, and the second role's fp32 partials of dx, dB or dC after
    // the last tile
    static_assert(2 * P * SN <= 2 * STAGE, "the split state must fit in the stages");
    static_assert(T * (MAX_N + 4) * 4 <= 2 * STAGE * 2, "the partials must fit in the stages");
    // cum, dt, the decay's factors, the second role's row sums; C·Bᵀ
    // fragments; the resident N tile and x/dy tile; two stages
    static constexpr int SMEM = (3 * MAX_Q + 2 * T) * 4 + MAX_T * CB_TILE * 4 +
                                (N_TILE + X_TILE + 2 * STAGE) * 2;
};

// A block's 8 warps take the 4 strips of 16 rows of its 64-row tile, two
// warps a strip.  In the loop over tiles each role (warp / 4) takes two of
// the four 16-column pairs of the other index, so no score is computed
// twice, and sums its products over them into accumulators of every output
// column; the second role's partials join the first's through shared memory
// after the last tile, in that order.  In a head's prologue each role takes
// half of the 16-column groups of the state terms, the first role the odd
// one out.
__device__ __forceinline__ int first_group(int groups, int role) {
    return role ? (groups + 1) / 2 : 0;
}
__device__ __forceinline__ int group_count(int groups, int role) {
    return role ? groups / 2 : (groups + 1) / 2;
}

// the fragment slot of C·Bᵀ tile k, strip w, n8 tile n, lane l
__device__ __forceinline__ int cb_slot(int k, int w, int n, int l) {
    return ((k * 4 + w) * 8 + n) * 32 + l;
}

// C·Bᵀ fragments of one 64×64 tile for the warp's strip: A rows from `as`
// (the strip's 16 rows), B rows from `bs` (the tile's 64 rows, `nb` of them
// real); each role computes its two of the four 16-column pairs
__device__ __forceinline__ void cb_tile(float4* cbs, int k, const bf16* as, const bf16* bs,
                                        int nb, int N, int strip, int role, int lane) {
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < MAX_N / 16; ++kk) {
        if (kk * 16 >= N) break;
        uint32_t af[4];
        ldsm_x4(af, as + (lane % 16) * SN + kk * 16 + lane / 16 * 8);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
            const int np = 2 * role + q;
            if (np * 16 < nb) {
                uint32_t bf[4];
                ldsm_x4(bf, bs + (np * 16 + lane % 8 + lane / 16 * 8) * SN + kk * 16 +
                                (lane / 8) % 2 * 8);
                mma(s[2 * q], af, bf[0], bf[1]);
                mma(s[2 * q + 1], af, bf[2], bf[3]);
            }
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
        cbs[cb_slot(k, strip, 4 * role + i, lane)] = make_float4(s[i][0], s[i][1], s[i][2],
                                                                 s[i][3]);
}

// the second role's fragment partials [groups][2][4] of its strip into
// `xch` (fp32, rows `stride` apart), the first role's plus them out through
// `out(row, col, v0, v1)`; every thread calls it after the block's last read
// of the stages `xch` overlays, and it synchronises the block before and after
// the partials go through
template <int GROUPS, typename Out>
__device__ __forceinline__ void join_roles(float (&acc)[GROUPS][2][4], int cols, float* xch,
                                           int stride, int strip, int role, bool active, int g,
                                           int t, Out out) {
    const int r0 = strip * 16 + g, r1 = r0 + 8;
    __syncthreads();                                  // every warp is done with the stages
    if (active && role == 1) {
#pragma unroll
        for (int gi = 0; gi < GROUPS; ++gi) {
            if (gi * 16 >= cols) break;
#pragma unroll
            for (int q = 0; q < 2; ++q) {
                const int n = gi * 16 + q * 8 + 2 * t;
                *reinterpret_cast<float2*>(xch + r0 * stride + n) =
                    make_float2(acc[gi][q][0], acc[gi][q][1]);
                *reinterpret_cast<float2*>(xch + r1 * stride + n) =
                    make_float2(acc[gi][q][2], acc[gi][q][3]);
            }
        }
    }
    __syncthreads();
    if (active && role == 0) {
#pragma unroll
        for (int gi = 0; gi < GROUPS; ++gi) {
            if (gi * 16 >= cols) break;
#pragma unroll
            for (int q = 0; q < 2; ++q) {
                const int n = gi * 16 + q * 8 + 2 * t;
                const float2 u = *reinterpret_cast<const float2*>(xch + r0 * stride + n);
                const float2 v = *reinterpret_cast<const float2*>(xch + r1 * stride + n);
                out(r0, n, acc[gi][q][0] + u.x, acc[gi][q][1] + u.y);
                out(r1, n, acc[gi][q][2] + v.x, acc[gi][q][3] + v.y);
            }
        }
    }
}

// x, dy, dx: [Bt, L, H, P]; cum: [Bt, nc, H, Q]; ds_split: dS_c split, hi
// then lo `half` apart, [Bt, nc, H, P, N] bf16; db_part: [Bt, L, H/G, N]
// fp32; ddt, dcol, uw: [Bt, L, H].  Grid ceil(Q/64)·Bt·nc·(H/G), column tile
// 0 (the most row tiles) first.  A strip is 16 columns j; its fragments hold
// rows j, columns i.
template <int P>
__global__ void __launch_bounds__(PAIR_THREADS, 1)
ssd_bwd_mma_cols(const bf16* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ a, const bf16* __restrict__ bm,
                 const bf16* __restrict__ cm, const bf16* __restrict__ dy,
                 const float* __restrict__ cum_in, const bf16* __restrict__ ds_split,
                 size_t half, bf16* __restrict__ dx, float* __restrict__ db_part,
                 float* __restrict__ ddt, float* __restrict__ dcol, float* __restrict__ uw,
                 int G, Dims d) {
    using C = PairCfg<P>;
    extern __shared__ __align__(16) unsigned char ssd_smem[];
    float* cum_s = reinterpret_cast<float*>(ssd_smem);   // [MAX_Q]
    float* dt_s = cum_s + MAX_Q;                      // [MAX_Q]
    float* ef_s = dt_s + MAX_Q;                       // [MAX_Q] exp(cum_i − cum_{i's tile start})
    float* red = ef_s + MAX_Q;                        // [2][T] the second role's u_j, Σ r·cb·L
    float4* cbs = reinterpret_cast<float4*>(red + 2 * T);   // C·Bᵀ fragments
    bf16* bsm = reinterpret_cast<bf16*>(cbs + MAX_T * CB_TILE / 4);   // B_j [T][SN]
    bf16* xsm = bsm + C::N_TILE;                      // x_j [T][SP]
    bf16* stages = xsm + C::X_TILE;
    auto ys_of = [&](int s) { return stages + s * C::STAGE; };   // dy_i [T][SP]
    auto cs_of = [&](int s) { return ys_of(s) + C::X_TILE; };    // C_i [T][SN]
    bf16* dsh = stages;                               // dS_c hi [P][SN]
    bf16* dsl = stages + P * SN;                      // dS_c lo
    float* xch = reinterpret_cast<float*>(stages);    // the second role's partials

    const int N = d.N, Q = d.Q, H = d.H, nc = d.NC;
    const int ntq = (Q + T - 1) / T, ng = H / G;
    const int per_tile = gridDim.x / ntq;
    const int jt = blockIdx.x / per_tile;
    const int rem = blockIdx.x % per_tile, grp = rem % ng, bc = rem / ng;
    const int c = bc % nc, b = bc / nc;
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, g = lane / 4, t = lane % 4;
    const int strip = warp % 4, role = warp / 4;
    const int pg0 = first_group(C::PG, role), pg1 = pg0 + group_count(C::PG, role);
    const int nb0 = first_group(N / 16, role), nb1 = nb0 + group_count(N / 16, role);
    const int j0 = jt * T, nj = min(T, Q - j0), nit = ntq - jt;
    const bool active = strip * 16 < nj;              // Q is a multiple of 16
    const int jl0 = strip * 16 + g, jl1 = jl0 + 8;    // the thread's rows in the tile
    const int jr0 = j0 + jl0, jr1 = j0 + jl1;
    const size_t row0 = size_t(b) * d.L + size_t(c) * Q;
    const size_t xrow = size_t(H) * P;
    const bf16* bstrip = bsm + strip * 16 * SN;       // the strip's B rows
    const bf16* xstrip = xsm + strip * 16 * C::SP;    // the strip's x rows

    // C·Bᵀ for every row tile i ≥ j, once for all the group's heads
    load_tile(bsm, SN, bm + (row0 + j0) * N, N, nj, N, tid, PAIR_THREADS);
    auto fetch_c = [&](int k) {
        const int i0 = (jt + k) * T;
        load_tile(cs_of(k % 2), SN, cm + (row0 + i0) * N, N, min(T, Q - i0), N, tid,
                  PAIR_THREADS);
        cp_async_commit();
    };
    fetch_c(0);
    for (int k = 0; k < nit; ++k) {
        if (k + 1 < nit) {
            __syncthreads();
            fetch_c(k + 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        if (active)
            cb_tile(cbs, k, bstrip, cs_of(k % 2), min(T, Q - (jt + k) * T), N, strip, role,
                    lane);
    }

    float dbacc[MAX_N / 16][2][4];                    // dB of the strip, the role's share
#pragma unroll
    for (int i = 0; i < MAX_N / 16; ++i)
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
            for (int e = 0; e < 4; ++e) dbacc[i][q][e] = 0.f;

    for (int hh = 0; hh < G; ++hh) {
        const int h = grp * G + hh;
        const size_t bch = (size_t(b) * nc + c) * H + h;
        __syncthreads();                              // the stages, x_j and red are free
        load_tile(xsm, C::SP, x + (row0 + j0) * xrow + size_t(h) * P, xrow, nj, P, tid,
                  PAIR_THREADS);
        load_tile(dsh, SN, ds_split + bch * size_t(P) * N, N, P, N, tid, PAIR_THREADS);
        load_tile(dsl, SN, ds_split + half + bch * size_t(P) * N, N, P, N, tid, PAIR_THREADS);
        cp_async_commit();
        bool ok = true;                               // dt ≥ 0 in this thread's rows
        for (int i = tid; i < Q; i += PAIR_THREADS) {
            cum_s[i] = cum_in[bch * Q + i];
            dt_s[i] = dt[(row0 + i) * H + h];
            ok = ok && dt_s[i] >= 0.f;
        }
        cp_async_wait<0>();
        // With a ≤ 0 and dt ≥ 0 cum never rises, so for j before the row
        // tile of i (j < i0 ≤ i) exp(cum_i − cum_j) = exp(cum_i − cum_i0)·
        // exp(cum_i0 − cum_j), both factors at most 1: two exps a thread and
        // tile instead of one an element, and neither factor can overflow.
        const bool decays = __syncthreads_and(ok && a[h] <= 0.f);
        for (int i = tid; i < Q; i += PAIR_THREADS) ef_s[i] = expf(cum_s[i] - cum_s[i / T * T]);

        const float last = cum_s[Q - 1];
        const float cj0 = active ? cum_s[jr0] : 0.f, cj1 = active ? cum_s[jr1] : 0.f;
        const float dj0 = active ? dt_s[jr0] : 0.f, dj1 = active ? dt_s[jr1] : 0.f;
        const float el0 = expf(last - cj0), el1 = expf(last - cj1);
        const float w0 = el0 * dj0, w1 = el1 * dj1;
        float dxacc[C::PG][2][4];                     // dx of the strip, the role's share
        float u0 = 0.f, u1 = 0.f;
#pragma unroll
        for (int i = 0; i < C::PG; ++i)
#pragma unroll
            for (int q = 0; q < 2; ++q)
#pragma unroll
                for (int e = 0; e < 4; ++e) dxacc[i][q][e] = 0.f;
        if (active) {
            // dS_c B_j (dS split) over the role's columns p, a 16-column group
            // at a time: dx's state term w_j·dS_c B_j and the role's part of
            // u_j = x_j·dS_c B_j
#pragma unroll
            for (int gi = 0; gi < C::PG; ++gi) {
                if (gi < pg0 || gi >= pg1) continue;
                float sb[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
                for (int kk = 0; kk < MAX_N / 16; ++kk) {
                    if (kk * 16 >= N) break;
                    uint32_t af[4], bh[4], bl[4];
                    ldsm_x4(af, bstrip + (lane % 16) * SN + kk * 16 + lane / 16 * 8);
                    const int o = (gi * 16 + lane % 8 + lane / 16 * 8) * SN + kk * 16 +
                                  (lane / 8) % 2 * 8;
                    ldsm_x4(bh, dsh + o);
                    ldsm_x4(bl, dsl + o);
                    mma(sb[0], af, bh[0], bh[1]);
                    mma(sb[1], af, bh[2], bh[3]);
                    mma(sb[0], af, bl[0], bl[1]);
                    mma(sb[1], af, bl[2], bl[3]);
                }
#pragma unroll
                for (int q = 0; q < 2; ++q) {
                    const int p = gi * 16 + q * 8 + 2 * t;
                    const uint32_t xa = *reinterpret_cast<const uint32_t*>(xsm + jl0 * C::SP + p);
                    const uint32_t xb = *reinterpret_cast<const uint32_t*>(xsm + jl1 * C::SP + p);
                    const float* v = sb[q];
                    u0 += lo_f32(xa) * v[0] + hi_f32(xa) * v[1];
                    u1 += lo_f32(xb) * v[2] + hi_f32(xb) * v[3];
                    dxacc[gi][q][0] = w0 * v[0];
                    dxacc[gi][q][1] = w0 * v[1];
                    dxacc[gi][q][2] = w1 * v[2];
                    dxacc[gi][q][3] = w1 * v[3];
                }
            }
            u0 = quad_sum(u0);
            u1 = quad_sum(u1);
            if (role == 1 && t == 0) {
                red[jl0] = u0;
                red[jl1] = u1;
            }
            // dB's state term w_j·dS_cᵀx_j over the role's columns n: x_j ·
            // (dS split), each row times w_j, a 16-column group at a time
#pragma unroll
            for (int gi = 0; gi < MAX_N / 16; ++gi) {
                if (gi < nb0 || gi >= nb1) continue;
                float tmp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
                for (int kk = 0; kk < P / 16; ++kk) {
                    uint32_t af[4], bh[4], bl[4];
                    ldsm_x4(af, xstrip + (lane % 16) * C::SP + kk * 16 + lane / 16 * 8);
                    const int o = (kk * 16 + lane % 8 + (lane / 8) % 2 * 8) * SN + gi * 16 +
                                  lane / 16 * 8;
                    ldsm_x4_t(bh, dsh + o);
                    ldsm_x4_t(bl, dsl + o);
                    mma(tmp[0], af, bh[0], bh[1]);
                    mma(tmp[1], af, bh[2], bh[3]);
                    mma(tmp[0], af, bl[0], bl[1]);
                    mma(tmp[1], af, bl[2], bl[3]);
                }
#pragma unroll
                for (int q = 0; q < 2; ++q) {
                    dbacc[gi][q][0] += w0 * tmp[q][0];
                    dbacc[gi][q][1] += w0 * tmp[q][1];
                    dbacc[gi][q][2] += w1 * tmp[q][2];
                    dbacc[gi][q][3] += w1 * tmp[q][3];
                }
            }
        }
        __syncthreads();                              // dS_c read: the stages are free

        auto fetch_i = [&](int k) {
            const int i0 = (jt + k) * T, rows = min(T, Q - i0);
            load_tile(ys_of(k % 2), C::SP, dy + (row0 + i0) * xrow + size_t(h) * P, xrow, rows,
                      P, tid, PAIR_THREADS);
            load_tile(cs_of(k % 2), SN, cm + (row0 + i0) * N, N, rows, N, tid, PAIR_THREADS);
            cp_async_commit();
        };
        fetch_i(0);
        float vs0 = 0.f, vs1 = 0.f;                   // Σ_i r·cb·L of the thread's rows
        for (int k = 0; k < nit; ++k) {
            if (k + 1 < nit) {
                __syncthreads();
                fetch_i(k + 1);
                cp_async_wait<1>();
            } else {
                cp_async_wait<0>();
            }
            __syncthreads();
            const int i0 = (jt + k) * T, ni = min(T, Q - i0);
            // the role's 16-column pairs i of the tile that reach the strip's
            // rows j ≤ i
            const int np0 = max(2 * role, k == 0 ? strip : 0);
            const int np1 = min(2 * role + 2, ni / 16);
            if (!active || np0 >= np1) continue;
            const bf16* ys = ys_of(k % 2);
            const bf16* cs = cs_of(k % 2);
            const bool factored = decays && k > 0;    // every i of the tile past the strip
            const float rf0 = factored ? expf(cum_s[i0] - cj0) : 0.f;
            const float rf1 = factored ? expf(cum_s[i0] - cj1) : 0.f;
            float r[4][4];                            // rᵀ[j][i] = x_j·dy_i, the role's pairs
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int e = 0; e < 4; ++e) r[i][e] = 0.f;
#pragma unroll
            for (int kk = 0; kk < P / 16; ++kk) {
                uint32_t af[4];
                ldsm_x4(af, xstrip + (lane % 16) * C::SP + kk * 16 + lane / 16 * 8);
#pragma unroll
                for (int q = 0; q < 2; ++q) {
                    const int np = 2 * role + q;
                    if (np >= np0 && np < np1) {
                        uint32_t bf[4];
                        ldsm_x4(bf, ys + (np * 16 + lane % 8 + lane / 16 * 8) * C::SP + kk * 16 +
                                        (lane / 8) % 2 * 8);
                        mma(r[2 * q], af, bf[0], bf[1]);
                        mma(r[2 * q + 1], af, bf[2], bf[3]);
                    }
                }
            }
#pragma unroll
            for (int q = 0; q < 2; ++q) {
                const int np = 2 * role + q;
                if (np < np0 || np >= np1) continue;
                uint32_t m1h[4], m1l[4], m2h[4], m2l[4];
#pragma unroll
                for (int hf = 0; hf < 2; ++hf) {
                    const float4 cb = cbs[cb_slot(k, strip, 2 * np + hf, lane)];
                    const int i = i0 + np * 16 + hf * 8 + 2 * t;
                    float l00, l01, l10, l11;
                    if (factored) {
                        const float f0 = ef_s[i], f1 = ef_s[i + 1];
                        l00 = f0 * rf0;
                        l01 = f1 * rf0;
                        l10 = f0 * rf1;
                        l11 = f1 * rf1;
                    } else {                          // the decay only where j ≤ i
                        const float ci0 = cum_s[i], ci1 = cum_s[i + 1];
                        l00 = i >= jr0 ? __expf(ci0 - cj0) : 0.f;
                        l01 = i + 1 >= jr0 ? __expf(ci1 - cj0) : 0.f;
                        l10 = i >= jr1 ? __expf(ci0 - cj1) : 0.f;
                        l11 = i + 1 >= jr1 ? __expf(ci1 - cj1) : 0.f;
                    }
                    const float* rv = r[2 * q + hf];
                    vs0 += rv[0] * cb.x * l00 + rv[1] * cb.y * l01;
                    vs1 += rv[2] * cb.z * l10 + rv[3] * cb.w * l11;
                    split2(cb.x * l00 * dj0, cb.y * l01 * dj0, m1h[2 * hf], m1l[2 * hf]);
                    split2(cb.z * l10 * dj1, cb.w * l11 * dj1, m1h[2 * hf + 1], m1l[2 * hf + 1]);
                    split2(rv[0] * l00 * dj0, rv[1] * l01 * dj0, m2h[2 * hf], m2l[2 * hf]);
                    split2(rv[2] * l10 * dj1, rv[3] * l11 * dj1, m2h[2 * hf + 1], m2l[2 * hf + 1]);
                }
                // dx_j += Σ_i (cb·L·dt)_ji dy_i
#pragma unroll
                for (int gi = 0; gi < C::PG; ++gi) {
                    uint32_t bd[4];
                    ldsm_x4_t(bd, ys + (np * 16 + lane % 8 + (lane / 8) % 2 * 8) * C::SP +
                                      gi * 16 + lane / 16 * 8);
                    mma(dxacc[gi][0], m1h, bd[0], bd[1]);
                    mma(dxacc[gi][1], m1h, bd[2], bd[3]);
                    mma(dxacc[gi][0], m1l, bd[0], bd[1]);
                    mma(dxacc[gi][1], m1l, bd[2], bd[3]);
                }
                // dB_j += Σ_i (r·L·dt)_ji C_i
#pragma unroll
                for (int gi = 0; gi < MAX_N / 16; ++gi) {
                    if (gi * 16 >= N) break;
                    uint32_t bc4[4];
                    ldsm_x4_t(bc4, cs + (np * 16 + lane % 8 + (lane / 8) % 2 * 8) * SN + gi * 16 +
                                       lane / 16 * 8);
                    mma(dbacc[gi][0], m2h, bc4[0], bc4[1]);
                    mma(dbacc[gi][1], m2h, bc4[2], bc4[3]);
                    mma(dbacc[gi][0], m2l, bc4[0], bc4[1]);
                    mma(dbacc[gi][1], m2l, bc4[2], bc4[3]);
                }
            }
        }

        // the roles' partials joined, the first role's first: Σ r·cb·L and
        // dx; then the column-indexed outputs
        vs0 = quad_sum(vs0);
        vs1 = quad_sum(vs1);
        if (active && role == 1 && t == 0) {
            red[T + jl0] = vs0;
            red[T + jl1] = vs1;
        }
        bf16* dxb = dx + (row0 + j0) * xrow + size_t(h) * P;
        join_roles(dxacc, P, xch, P + 4, strip, role, active, g, t,
                   [&](int row, int p, float v0, float v1) {
                       *reinterpret_cast<uint32_t*>(dxb + row * xrow + p) = pack(v0, v1);
                   });
        if (active && role == 0 && t == 0) {
#pragma unroll
            for (int q2 = 0; q2 < 2; ++q2) {
                const int jl = q2 ? jl1 : jl0;
                const float vs = (q2 ? vs1 : vs0) + red[T + jl];
                const float u = (q2 ? u1 : u0) + red[jl];
                const float el = q2 ? el1 : el0, dj = q2 ? dj1 : dj0;
                const size_t o = (row0 + j0 + jl) * H + h;
                ddt[o] = fmaf(u, el, vs);
                dcol[o] = -dj * vs - u * el * dj;
                uw[o] = u * el * dj;
            }
        }
    }

    join_roles(dbacc, N, xch, MAX_N + 4, strip, role, active, g, t,
               [&](int row, int n, float v0, float v1) {
                   *reinterpret_cast<float2*>(db_part + ((row0 + j0 + row) * ng + grp) * N + n) =
                       make_float2(v0, v1);
               });
}

// h_split: h_in[c] split, hi then lo `half` apart, [Bt, nc, H, P, N] bf16;
// dc_part: [Bt, L, H/G, N] fp32; drow: [Bt, L, H].  Grid ceil(Q/64)·Bt·nc·
// (H/G), the last row tile (the most column tiles) first.  A strip is 16
// rows i; its fragments hold rows i, columns j.
template <int P>
__global__ void __launch_bounds__(PAIR_THREADS, 1)
ssd_bwd_mma_rows(const bf16* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ a, const bf16* __restrict__ bm,
                 const bf16* __restrict__ cm, const bf16* __restrict__ dy,
                 const float* __restrict__ cum_in, const bf16* __restrict__ h_split,
                 size_t half, float* __restrict__ dc_part, float* __restrict__ drow, int G,
                 Dims d) {
    using C = PairCfg<P>;
    extern __shared__ __align__(16) unsigned char ssd_smem[];
    float* cum_s = reinterpret_cast<float*>(ssd_smem);   // [MAX_Q]
    float* dt_s = cum_s + MAX_Q;                      // [MAX_Q]
    float* colf_s = dt_s + MAX_Q;                     // [MAX_Q] exp(cum_i0 − cum_j)·dt_j, j < i0
    float* red = colf_s + MAX_Q;                      // [2][T] the second role's hp_i, Σ_j t_ij
    float4* cbs = reinterpret_cast<float4*>(red + 2 * T);   // C·Bᵀ fragments
    bf16* csm = reinterpret_cast<bf16*>(cbs + MAX_T * CB_TILE / 4);   // C_i [T][SN]
    bf16* ysm = csm + C::N_TILE;                      // dy_i [T][SP]
    bf16* stages = ysm + C::X_TILE;
    auto xs_of = [&](int s) { return stages + s * C::STAGE; };   // x_j [T][SP]
    auto bs_of = [&](int s) { return xs_of(s) + C::X_TILE; };    // B_j [T][SN]
    bf16* hsh = stages;                               // h_in[c] hi [P][SN]
    bf16* hsl = stages + P * SN;                      // h_in[c] lo
    float* xch = reinterpret_cast<float*>(stages);    // the second role's partials

    const int N = d.N, Q = d.Q, H = d.H, nc = d.NC;
    const int ntq = (Q + T - 1) / T, ng = H / G;
    const int per_tile = gridDim.x / ntq;
    const int it = ntq - 1 - int(blockIdx.x) / per_tile;
    const int rem = blockIdx.x % per_tile, grp = rem % ng, bc = rem / ng;
    const int c = bc % nc, b = bc / nc;
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, g = lane / 4, t = lane % 4;
    const int strip = warp % 4, role = warp / 4;
    const int pg0 = first_group(C::PG, role), pg1 = pg0 + group_count(C::PG, role);
    const int nb0 = first_group(N / 16, role), nb1 = nb0 + group_count(N / 16, role);
    const int i0 = it * T, ni = min(T, Q - i0), njt = it + 1;
    const bool active = strip * 16 < ni;
    const int il0 = strip * 16 + g, il1 = il0 + 8;
    const int ir0 = i0 + il0, ir1 = i0 + il1;
    const size_t row0 = size_t(b) * d.L + size_t(c) * Q;
    const size_t xrow = size_t(H) * P;
    const bf16* cstrip = csm + strip * 16 * SN;       // the strip's C rows
    const bf16* ystrip = ysm + strip * 16 * C::SP;    // the strip's dy rows

    // C·Bᵀ for every column tile j ≤ i, once for all the group's heads
    load_tile(csm, SN, cm + (row0 + i0) * N, N, ni, N, tid, PAIR_THREADS);
    auto fetch_b = [&](int k) {
        const int j0 = k * T;
        load_tile(bs_of(k % 2), SN, bm + (row0 + j0) * N, N, min(T, Q - j0), N, tid,
                  PAIR_THREADS);
        cp_async_commit();
    };
    fetch_b(0);
    for (int k = 0; k < njt; ++k) {
        if (k + 1 < njt) {
            __syncthreads();
            fetch_b(k + 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        if (active)
            cb_tile(cbs, k, cstrip, bs_of(k % 2), min(T, Q - k * T), N, strip, role, lane);
    }

    float dcacc[MAX_N / 16][2][4];                    // dC of the strip, the role's share
#pragma unroll
    for (int i = 0; i < MAX_N / 16; ++i)
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
            for (int e = 0; e < 4; ++e) dcacc[i][q][e] = 0.f;

    for (int hh = 0; hh < G; ++hh) {
        const int h = grp * G + hh;
        const size_t bch = (size_t(b) * nc + c) * H + h;
        __syncthreads();                              // the stages, dy_i and red are free
        load_tile(ysm, C::SP, dy + (row0 + i0) * xrow + size_t(h) * P, xrow, ni, P, tid,
                  PAIR_THREADS);
        load_tile(hsh, SN, h_split + bch * size_t(P) * N, N, P, N, tid, PAIR_THREADS);
        load_tile(hsl, SN, h_split + half + bch * size_t(P) * N, N, P, N, tid, PAIR_THREADS);
        cp_async_commit();
        bool ok = true;                               // dt ≥ 0 in this thread's rows
        for (int i = tid; i < Q; i += PAIR_THREADS) {
            cum_s[i] = cum_in[bch * Q + i];
            dt_s[i] = dt[(row0 + i) * H + h];
            ok = ok && dt_s[i] >= 0.f;
        }
        cp_async_wait<0>();
        // as in the columns pass: below the block's rows (j < i0 ≤ i) the
        // decay is exp(cum_i − cum_i0)·exp(cum_i0 − cum_j), where cum never rises
        const bool decays = __syncthreads_and(ok && a[h] <= 0.f);
        for (int j = tid; j < i0; j += PAIR_THREADS)
            colf_s[j] = expf(cum_s[i0] - cum_s[j]) * dt_s[j];

        const float ci0 = active ? cum_s[ir0] : 0.f, ci1 = active ? cum_s[ir1] : 0.f;
        const float rf0 = decays && active ? expf(ci0 - cum_s[i0]) : 0.f;
        const float rf1 = decays && active ? expf(ci1 - cum_s[i0]) : 0.f;
        const float e0 = expf(ci0), e1 = expf(ci1);
        float hp0 = 0.f, hp1 = 0.f;
        if (active) {
            // h_in[c] C_i (h_in split) over the role's columns p, a 16-column
            // group at a time → the role's part of hp_i = dy_i·(h_in[c] C_i)
#pragma unroll
            for (int gi = 0; gi < C::PG; ++gi) {
                if (gi < pg0 || gi >= pg1) continue;
                float hc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
                for (int kk = 0; kk < MAX_N / 16; ++kk) {
                    if (kk * 16 >= N) break;
                    uint32_t af[4], bh[4], bl[4];
                    ldsm_x4(af, cstrip + (lane % 16) * SN + kk * 16 + lane / 16 * 8);
                    const int o = (gi * 16 + lane % 8 + lane / 16 * 8) * SN + kk * 16 +
                                  (lane / 8) % 2 * 8;
                    ldsm_x4(bh, hsh + o);
                    ldsm_x4(bl, hsl + o);
                    mma(hc[0], af, bh[0], bh[1]);
                    mma(hc[1], af, bh[2], bh[3]);
                    mma(hc[0], af, bl[0], bl[1]);
                    mma(hc[1], af, bl[2], bl[3]);
                }
#pragma unroll
                for (int q = 0; q < 2; ++q) {
                    const int p = gi * 16 + q * 8 + 2 * t;
                    const uint32_t ya = *reinterpret_cast<const uint32_t*>(ysm + il0 * C::SP + p);
                    const uint32_t yb = *reinterpret_cast<const uint32_t*>(ysm + il1 * C::SP + p);
                    hp0 += lo_f32(ya) * hc[q][0] + hi_f32(ya) * hc[q][1];
                    hp1 += lo_f32(yb) * hc[q][2] + hi_f32(yb) * hc[q][3];
                }
            }
            hp0 = quad_sum(hp0);
            hp1 = quad_sum(hp1);
            if (role == 1 && t == 0) {
                red[il0] = hp0;
                red[il1] = hp1;
            }
            // dC's state term exp(cum_i)·h_in[c]ᵀdy_i over the role's columns
            // n: dy_i · (h_in split), each row times exp(cum_i), a 16-column group at a time
#pragma unroll
            for (int gi = 0; gi < MAX_N / 16; ++gi) {
                if (gi < nb0 || gi >= nb1) continue;
                float tmp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
                for (int kk = 0; kk < P / 16; ++kk) {
                    uint32_t af[4], bh[4], bl[4];
                    ldsm_x4(af, ystrip + (lane % 16) * C::SP + kk * 16 + lane / 16 * 8);
                    const int o = (kk * 16 + lane % 8 + (lane / 8) % 2 * 8) * SN + gi * 16 +
                                  lane / 16 * 8;
                    ldsm_x4_t(bh, hsh + o);
                    ldsm_x4_t(bl, hsl + o);
                    mma(tmp[0], af, bh[0], bh[1]);
                    mma(tmp[1], af, bh[2], bh[3]);
                    mma(tmp[0], af, bl[0], bl[1]);
                    mma(tmp[1], af, bl[2], bl[3]);
                }
#pragma unroll
                for (int q = 0; q < 2; ++q) {
                    dcacc[gi][q][0] += e0 * tmp[q][0];
                    dcacc[gi][q][1] += e0 * tmp[q][1];
                    dcacc[gi][q][2] += e1 * tmp[q][2];
                    dcacc[gi][q][3] += e1 * tmp[q][3];
                }
            }
        }
        __syncthreads();                              // h_in read: the stages are free

        auto fetch_j = [&](int k) {
            const int j0 = k * T, rows = min(T, Q - j0);
            load_tile(xs_of(k % 2), C::SP, x + (row0 + j0) * xrow + size_t(h) * P, xrow, rows, P,
                      tid, PAIR_THREADS);
            load_tile(bs_of(k % 2), SN, bm + (row0 + j0) * N, N, rows, N, tid, PAIR_THREADS);
            cp_async_commit();
        };
        fetch_j(0);
        float tr0 = 0.f, tr1 = 0.f;                   // Σ_j t_ij of the thread's rows
        for (int k = 0; k < njt; ++k) {
            if (k + 1 < njt) {
                __syncthreads();
                fetch_j(k + 1);
                cp_async_wait<1>();
            } else {
                cp_async_wait<0>();
            }
            __syncthreads();
            const int j0 = k * T, nj = min(T, Q - j0);
            // the role's 16-column pairs j of the tile at or before the strip's rows
            const int np1 = min(2 * role + 2, k == it ? min(nj / 16, strip + 1) : nj / 16);
            if (!active || 2 * role >= np1) continue;
            const bf16* xs = xs_of(k % 2);
            const bf16* bs = bs_of(k % 2);
            const bool factored = decays && k < it;   // every j of the tile before the strip
            float r[4][4];                            // r[i][j] = dy_i·x_j, the role's pairs
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int e = 0; e < 4; ++e) r[i][e] = 0.f;
#pragma unroll
            for (int kk = 0; kk < P / 16; ++kk) {
                uint32_t af[4];
                ldsm_x4(af, ystrip + (lane % 16) * C::SP + kk * 16 + lane / 16 * 8);
#pragma unroll
                for (int q = 0; q < 2; ++q) {
                    const int np = 2 * role + q;
                    if (np < np1) {
                        uint32_t bf[4];
                        ldsm_x4(bf, xs + (np * 16 + lane % 8 + lane / 16 * 8) * C::SP + kk * 16 +
                                        (lane / 8) % 2 * 8);
                        mma(r[2 * q], af, bf[0], bf[1]);
                        mma(r[2 * q + 1], af, bf[2], bf[3]);
                    }
                }
            }
#pragma unroll
            for (int q = 0; q < 2; ++q) {
                const int np = 2 * role + q;
                if (np >= np1) continue;
                uint32_t m2h[4], m2l[4];
#pragma unroll
                for (int hf = 0; hf < 2; ++hf) {
                    const float4 cb = cbs[cb_slot(k, strip, 2 * np + hf, lane)];
                    const int j = j0 + np * 16 + hf * 8 + 2 * t;
                    const float* rv = r[2 * q + hf];
                    float m00, m01, m10, m11;
                    if (factored) {
                        const float f0 = colf_s[j], f1 = colf_s[j + 1];
                        m00 = rv[0] * rf0 * f0;
                        m01 = rv[1] * rf0 * f1;
                        m10 = rv[2] * rf1 * f0;
                        m11 = rv[3] * rf1 * f1;
                    } else {                          // the decay only where j ≤ i
                        const float cj0 = cum_s[j], cj1 = cum_s[j + 1];
                        const float d0 = dt_s[j], d1 = dt_s[j + 1];
                        m00 = j <= ir0 ? rv[0] * __expf(ci0 - cj0) * d0 : 0.f;
                        m01 = j + 1 <= ir0 ? rv[1] * __expf(ci0 - cj1) * d1 : 0.f;
                        m10 = j <= ir1 ? rv[2] * __expf(ci1 - cj0) * d0 : 0.f;
                        m11 = j + 1 <= ir1 ? rv[3] * __expf(ci1 - cj1) * d1 : 0.f;
                    }
                    tr0 += m00 * cb.x + m01 * cb.y;
                    tr1 += m10 * cb.z + m11 * cb.w;
                    split2(m00, m01, m2h[2 * hf], m2l[2 * hf]);
                    split2(m10, m11, m2h[2 * hf + 1], m2l[2 * hf + 1]);
                }
                // dC_i += Σ_j (r·L·dt)_ij B_j
#pragma unroll
                for (int gi = 0; gi < MAX_N / 16; ++gi) {
                    if (gi * 16 >= N) break;
                    uint32_t bb[4];
                    ldsm_x4_t(bb, bs + (np * 16 + lane % 8 + (lane / 8) % 2 * 8) * SN + gi * 16 +
                                      lane / 16 * 8);
                    mma(dcacc[gi][0], m2h, bb[0], bb[1]);
                    mma(dcacc[gi][1], m2h, bb[2], bb[3]);
                    mma(dcacc[gi][0], m2l, bb[0], bb[1]);
                    mma(dcacc[gi][1], m2l, bb[2], bb[3]);
                }
            }
        }

        // the roles' partials of Σ_j t_ij and hp_i joined, the first role's first
        tr0 = quad_sum(tr0);
        tr1 = quad_sum(tr1);
        if (active && role == 1 && t == 0) {
            red[T + il0] = tr0;
            red[T + il1] = tr1;
        }
        __syncthreads();
        if (active && role == 0 && t == 0) {
            drow[(row0 + ir0) * H + h] = fmaf(e0, hp0 + red[il0], tr0 + red[T + il0]);
            drow[(row0 + ir1) * H + h] = fmaf(e1, hp1 + red[il1], tr1 + red[T + il1]);
        }
    }

    join_roles(dcacc, N, xch, MAX_N + 4, strip, role, active, g, t,
               [&](int row, int n, float v0, float v1) {
                   *reinterpret_cast<float2*>(dc_part + ((row0 + i0 + row) * ng + grp) * N + n) =
                       make_float2(v0, v1);
               });
}

// ==========================================================================
// 5. dcum, ddt and da per (b, c, h)
// ==========================================================================

// the block's 256 values summed in a fixed order (lanes by a shuffle tree,
// then the 8 warp sums in order); every thread gets the sum
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
    for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
    __syncthreads();
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < DCUM_THREADS / 32; ++w) s += red[w];
    __syncthreads();                                  // red may be written again
    return s;
}

// What the fma variant's ssd_bwd_dcum computes, a thread per row k of the
// chunk instead of one thread walking it: dγ (the state pass's ≤ 128 warp
// sums, summed in order), d(last) =
// dγ·γ + Σ_j uw_j, the reverse cumsum d(dt·a)_k = Σ_{i≥k} dcum_i (a shuffle
// scan in each warp, then the totals of the warps after it), ddt += d(dt·a)·a
// and the chunk's share of da.  Grid Bt·nc·H.
__global__ void __launch_bounds__(DCUM_THREADS)
ssd_bwd_mma_dcum(const float* __restrict__ dt, const float* __restrict__ a,
                 const float* __restrict__ cum, const float* __restrict__ dgamma_part,
                 const float* __restrict__ drow, const float* __restrict__ dcol,
                 const float* __restrict__ uw, float* __restrict__ ddt,
                 float* __restrict__ da_part, int nparts, Dims d) {
    __shared__ float red[DCUM_THREADS / 32];
    __shared__ float wtot[DCUM_THREADS / 32];
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int bch = blockIdx.x, Q = d.Q, H = d.H;
    const int h = bch % H, c = (bch / H) % d.NC, b = bch / (H * d.NC);
    const size_t row0 = size_t(b) * d.L + size_t(c) * Q;
    float g = 0.f;                                    // the state pass's warp sums of dγ
    for (int k = tid; k < nparts; k += DCUM_THREADS) g += dgamma_part[size_t(bch) * nparts + k];
    const float dgamma = block_sum(g, red);
    const bool in = tid < Q;
    const size_t o = (row0 + tid) * H + h;
    const float suw = block_sum(in ? uw[o] : 0.f, red);
    const float dlast = fmaf(dgamma, expf(cum[size_t(bch) * Q + Q - 1]), suw);
    float v = in ? drow[o] + dcol[o] + (tid == Q - 1 ? dlast : 0.f) : 0.f;
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
        const float u = __shfl_down_sync(0xffffffffu, v, off);
        if (lane + off < 32) v += u;
    }
    if (lane == 0) wtot[warp] = v;
    __syncthreads();
    for (int w = warp + 1; w < DCUM_THREADS / 32; ++w) v += wtot[w];
    const float dtv = in ? dt[o] : 0.f;
    const float dap = block_sum(v * dtv, red);
    if (in) ddt[o] = fmaf(v, a[h], ddt[o]);
    if (tid == 0) da_part[bch] = dap;
}

// ==========================================================================
// launch
// ==========================================================================

struct Args {
    const void *x, *dt, *a, *bm, *cm, *dy, *dh_last;
    void *dx, *ddt, *da, *dbm, *dcm;
    float *cum, *states, *u, *dgamma_part, *db_part, *dc_part, *drow, *dcol, *uw, *da_part;
    bf16 *h_split, *ds_split;
};

template <typename KernelT>
cudaError_t allow_smem(KernelT* k, int bytes) {
    return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

#define SSD_BWD_CHECK(expr)                        \
    do {                                           \
        cudaError_t e_ = (expr);                   \
        if (e_ != cudaSuccess) return int(e_);     \
    } while (0)

template <int P>
int launch(const Args& g, Dims d, int G, cudaStream_t st) {
    const bf16* x = static_cast<const bf16*>(g.x);
    const bf16* bm = static_cast<const bf16*>(g.bm);
    const bf16* cm = static_cast<const bf16*>(g.cm);
    const bf16* dy = static_cast<const bf16*>(g.dy);
    const float* dt = static_cast<const float*>(g.dt);
    const float* a = static_cast<const float*>(g.a);
    float* ddt = static_cast<float*>(g.ddt);
    const int nbch = d.Bt * d.NC * d.H;

    SSD_BWD_CHECK(allow_smem(ssd_bwd_mma_states<P>, StatesCfg<P>::SMEM));
    ssd_bwd_mma_states<P><<<nbch, STATE_THREADS, StatesCfg<P>::SMEM, st>>>(
        x, dt, a, bm, cm, dy, g.cum, g.states, g.u, d);
    SSD_BWD_CHECK(cudaGetLastError());

    const int pn4 = P * d.N / 4;
    const size_t half = size_t(d.Bt) * d.NC * d.H * P * d.N;      // bf16 of hi (then lo)
    const size_t nstate4 = size_t(d.Bt) * d.H * pn4;
    ssd_bwd_mma_state_pass<<<unsigned((nstate4 + PASS_THREADS - 1) / PASS_THREADS),
                             PASS_THREADS, 0, st>>>(
        g.cum, reinterpret_cast<const float4*>(g.states), reinterpret_cast<const float4*>(g.u),
        static_cast<const float4*>(g.dh_last), reinterpret_cast<uint2*>(g.h_split),
        reinterpret_cast<uint2*>(g.ds_split), g.dgamma_part, pn4, half / 4, d);
    SSD_BWD_CHECK(cudaGetLastError());

    const int pairs = (d.Q + T - 1) / T * d.Bt * d.NC * (d.H / G);
    SSD_BWD_CHECK(allow_smem(ssd_bwd_mma_cols<P>, PairCfg<P>::SMEM));
    ssd_bwd_mma_cols<P><<<pairs, PAIR_THREADS, PairCfg<P>::SMEM, st>>>(
        x, dt, a, bm, cm, dy, g.cum, g.ds_split, half, static_cast<bf16*>(g.dx), g.db_part, ddt,
        g.dcol, g.uw, G, d);
    SSD_BWD_CHECK(cudaGetLastError());

    SSD_BWD_CHECK(allow_smem(ssd_bwd_mma_rows<P>, PairCfg<P>::SMEM));
    ssd_bwd_mma_rows<P><<<pairs, PAIR_THREADS, PairCfg<P>::SMEM, st>>>(
        x, dt, a, bm, cm, dy, g.cum, g.h_split, half, g.dc_part, g.drow, G, d);
    SSD_BWD_CHECK(cudaGetLastError());

    ssd_bwd_mma_dcum<<<nbch, DCUM_THREADS, 0, st>>>(
        dt, a, g.cum, g.dgamma_part, g.drow, g.dcol, g.uw, ddt, g.da_part, pn4 / 32, d);
    SSD_BWD_CHECK(cudaGetLastError());

    const size_t nbn = size_t(d.Bt) * d.L * d.N;
    ssd_bwd::ssd_bwd_reduce_heads<bf16>
        <<<unsigned((nbn + ssd_bwd::NTHREADS - 1) / ssd_bwd::NTHREADS), ssd_bwd::NTHREADS, 0,
           st>>>(g.db_part, g.dc_part, static_cast<bf16*>(g.dbm), static_cast<bf16*>(g.dcm),
                 d.H / G, d);
    SSD_BWD_CHECK(cudaGetLastError());

    ssd_bwd::ssd_bwd_reduce_da<<<1, ssd_bwd::NTHREADS, 0, st>>>(
        g.da_part, static_cast<float*>(g.da), d);
    return int(cudaGetLastError());
}

}  // namespace

// x, dy, dx: [Bt, L, H, P] bf16; dt, ddt: [Bt, L, H] fp32; a, da: [H] fp32;
// bm, cm, dbm, dcm: [Bt, L, N] bf16; dh_last: [Bt, H, P, N] fp32 or null.
// Scratch supplied by the caller, fp32: cum [Bt, L/Q, H, Q]; states, u [Bt,
// L/Q, H, P, N]; dgamma_part [Bt, L/Q, H, P·N/128]; db_part, dc_part [Bt, L,
// H/G, N]; drow, dcol, uw [Bt, L, H]; da_part [Bt, L/Q, H]; bf16: h_split,
// ds_split [2, Bt, L/Q, H, P, N] (h_in[c] and dS_c split, hi then lo).  G =
// heads_per_block heads share a block of passes 3 and 4 and its C·Bᵀ.  All
// contiguous, x, dy, B, C, dh_last on 16-byte boundaries.  Returns the
// cudaError_t of the first launch that fails (0 on success); a shape it does
// not take (P outside {16, 32, 64, 128}, N or Q not a multiple of 16 in [16,
// 128] or [16, 256], L % Q != 0, H % G != 0) returns cudaErrorInvalidValue
// without launching.
extern "C" int ssd_scan_bwd_mma(const void* x, const void* dt, const void* a, const void* bm,
                                const void* cm, const void* dy, const void* dh_last, void* dx,
                                void* ddt, void* da, void* dbm, void* dcm, void* cum,
                                void* states, void* u, void* dgamma_part, void* db_part,
                                void* dc_part,
                                void* drow, void* dcol, void* uw, void* da_part, void* h_split,
                                void* ds_split, int Bt, int L, int H, int P, int N, int Q,
                                int heads_per_block, void* stream) {
    const int G = heads_per_block;
    if (Bt < 1 || L < 1 || H < 1 || G < 1 || H % G || N < 16 || N > MAX_N || N % 16 ||
        Q < 16 || Q > MAX_Q || Q % 16 || L % Q)
        return int(cudaErrorInvalidValue);
    const Args g{x, dt, a, bm, cm, dy, dh_last, dx, ddt, da, dbm, dcm,
                 static_cast<float*>(cum), static_cast<float*>(states),
                 static_cast<float*>(u), static_cast<float*>(dgamma_part),
                 static_cast<float*>(db_part), static_cast<float*>(dc_part),
                 static_cast<float*>(drow), static_cast<float*>(dcol),
                 static_cast<float*>(uw), static_cast<float*>(da_part),
                 static_cast<bf16*>(h_split), static_cast<bf16*>(ds_split)};
    const Dims d{Bt, L, H, N, Q, L / Q};
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (P) {
        case 16: return launch<16>(g, d, G, st);
        case 32: return launch<32>(g, d, G, st);
        case 64: return launch<64>(g, d, G, st);
        case 128: return launch<128>(g, d, G, st);
        default: return int(cudaErrorInvalidValue);
    }
}
