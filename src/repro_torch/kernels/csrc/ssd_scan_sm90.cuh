// Mamba2 SSD chunked scan for bf16 on Hopper's tensor cores (sm_90a):
// mma.sync m16n8k16 products with fp32 accumulation, fed by ldmatrix, and
// cp.async copies into shared memory.  Included by ssd_scan.cu, whose entry
// point launches it for bf16 x/B/C with P in {16, 32, 64, 128}, N a multiple
// of 16 up to 128 and Q a multiple of 16 up to 256 (the "mma" variant);
// every other call keeps the FMA kernel there.
//
// Replaces, for those calls, the Pallas TPU kernel src/repro/kernels/ssd_scan.py
// (ssd_scan + _kernel), plus the final state that serving needs.  The TPU
// kernel walks the chunks of one (batch, head) in order with the [P,N] state
// in VMEM; here the chunks run in parallel, as Mamba2's decomposition into
// three passes (c = chunk, cum = cumsum(dt·a) within the chunk):
//   1. chunk_state, one block per (batch, head, chunk): cum by a
//      warp-shuffle block scan, w_j = exp(cum_last − cum_j)·dt_j,
//      S_c = Xᵀ(B ⊙ w) [P,N] on the tensor cores; writes S_c and cum (fp32)
//      to the caller's scratch;
//   2. state_pass, one thread per 4 of (b, h, p, n): h_in[0] = 0,
//      h_in[c+1] = exp(cum_last_c)·h_in[c] + S_c in fp32, in the reference's
//      order; writes bf16(h_in[c]) for c ≥ 1 (chunk 0 reads no state) and
//      the state after the last chunk to h_out when asked for;
//   3. chunk_scan, one block per (batch, head, chunk, 128 rows), the
//      heaviest row tiles first, 8 warps of 16 rows each:
//      y_i = exp(cum_i)·(C_i·h_in[c]ᵀ)
//          + Σ_{j ≤ i} (C_i·B_jᵀ)·exp(cum_i − cum_j)·dt_j · X_j,
//      16-column pairs above a warp's diagonal skipped, the masked scores
//      going from the C·Bᵀ accumulator fragment straight into the A fragment
//      of the product with X (as FlashAttention-2 does with mma.sync).
// Both multiplying passes copy their 64-row tiles through two shared-memory
// stages with cp.async, so the next tile's copy runs under this one's products.
//
// Numerics (tests/test_torch_ssm.py emulates each rounding on the CPU):
//   * C·Bᵀ and C·h multiply bf16 values; B, C and X are bf16 already, so
//     C·Bᵀ is exact up to fp32 summation order;
//   * S_c needs an fp32 operand, X ⊙ w.  One bf16 rounding of it puts the
//     final state ~5× outside its 2e-4 tolerance, so it is split into
//     hi = bf16(v) and lo = bf16(v − hi), two products into one fp32
//     accumulator (the state then lands ~0.01× the tolerance);
//   * the masked scores and h_in are rounded once to bf16 for the products
//     that feed y only (y is bf16 and held at 5e-2; the emulation puts it at
//     ≤ 0.26× that limit);
//   * the decay is exp(cum_i − cum_j), evaluated only where j ≤ i, never
//     exp(cum_i)·exp(−cum_j), which overflows once cum_j < −88.  Below the
//     rows of a pass-3 block (j < i0 ≤ i), and only where cum never rises
//     (a ≤ 0, dt ≥ 0, checked per block), it is the product of
//     exp(cum_i − cum_i0) and exp(cum_i0 − cum_j), both at most 1;
//   * the block scan sums cum in another order than the reference's serial
//     cumsum, ~1e-7 relative: far inside 2e-4 at |cum| up to a few hundred;
//   * the tolerances hold under the reference's contract, a < 0.  A head
//     whose cum rises by several units in a chunk (a > 0) makes outputs that
//     grow and cancel beyond what one bf16 rounding of the scores holds.
//
// What bounds it: at the mamba2-370m serving shape (Bt=4, L=512, H=32, P=64,
// N=128, Q=256) the function moves ~22.3 MB (6.7 us at 3.35 TB/s) and needs
// ~3.3 GFLOP (3.3 us at the bf16 tensor-core peak), so bytes bound it.
// This design does ~6 GFLOP on the tensor cores (C·Bᵀ per head, the hi/lo
// split), sends ~11 MB of scratch through L2 (fp32 S_c, bf16 h_in) and reads
// B and C once per head, in three launches of 256, 1024 and 512 blocks.
// Measured on the card, pass 3 costs most, and neither its loads nor its
// products alone explain its time; a pass-3 block of two heads sharing
// C·Bᵀ ran slower (179 registers, one block an SM).  PERF.md has the numbers.
//
// Shared-memory rows are padded by 16 bytes, so the 8 rows an ldmatrix
// reads fall in distinct banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "ssd_mma.cuh"

namespace ssd_sm90 {

constexpr int MAX_Q = 256;
constexpr int MAX_N = 128;
constexpr int TILE = 64;                  // rows of a K tile (pass 1), of a column tile (pass 3)
constexpr int ROWS = 128;                 // rows of a chunk a pass-3 block takes
constexpr int SN = MAX_N + 8;             // padded row stride of an N-wide bf16 tile
constexpr int STATE_THREADS = 256;        // pass 1: 8 warps
constexpr int SCAN_THREADS = 256;         // pass 3: 8 warps of 16 rows
constexpr int PASS_THREADS = 256;         // pass 2

// ==========================================================================
// pass 1: chunk states
// ==========================================================================

template <int P>
struct StateCfg {
    static constexpr int SP = P + 8;                  // padded X row stride
    static constexpr int WARPS_M = P / 16;            // warps along P
    static constexpr int WARPS_N = 8 / WARPS_M;       // warps along N
    static constexpr int NT = P / 8;                  // n8 tiles per warp (N = 128)
    static constexpr int STAGE = TILE * SP * 2 + TILE * SN * 2;   // X and B rows
    static constexpr int SMEM = 2 * MAX_Q * 4 + 8 * 4 + 2 * STAGE;
};

// x: [Bt, L, H, P] bf16; dt: [Bt, L, H]; a: [H]; bm: [Bt, L, N] bf16.
// states: [Bt, nc, H, P, N] fp32 (S_c); cum: [Bt, nc, H, Q] fp32.
// K tiles of 64 rows go through two shared-memory stages: the copy of tile
// k+1 runs while tile k is multiplied.
template <int P>
__global__ void __launch_bounds__(STATE_THREADS, 1)
ssd_chunk_state_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ a, const bf16* __restrict__ bm,
                       float* __restrict__ states, float* __restrict__ cum, int L,
                       int H, int N, int Q, int nc) {
    using C = StateCfg<P>;
    extern __shared__ __align__(16) unsigned char ssd_smem[];
    float* cum_s = reinterpret_cast<float*>(ssd_smem);   // [MAX_Q]
    float* w_s = cum_s + MAX_Q;                       // [MAX_Q] exp(cum_last − cum)·dt
    float* wtot = w_s + MAX_Q;                        // [8] warp totals of the scan
    unsigned char* stages = reinterpret_cast<unsigned char*>(wtot + 8);

    const int c = int(blockIdx.x % nc), bh = int(blockIdx.x / nc);
    const int h = bh % H, b = bh / H;
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const size_t row0 = size_t(b) * L + size_t(c) * Q;    // first position of the chunk
    const size_t xrow = size_t(H) * P;
    const bf16* xb = x + row0 * xrow + size_t(h) * P;
    const bf16* bb = bm + row0 * N;
    const int ntiles = (Q + TILE - 1) / TILE;
    // stage s: X rows [TILE][SP], then B rows [TILE][SN]
    auto xs_of = [&](int s) { return reinterpret_cast<bf16*>(stages + s * C::STAGE); };
    auto bs_of = [&](int s) { return xs_of(s) + TILE * C::SP; };
    auto fetch = [&](int kt) {
        const int j0 = kt * TILE, rows = min(TILE, Q - j0);
        load_tile(xs_of(kt % 2), C::SP, xb + j0 * xrow, xrow, rows, P, tid, STATE_THREADS);
        load_tile(bs_of(kt % 2), SN, bb + size_t(j0) * N, N, rows, N, tid, STATE_THREADS);
        cp_async_commit();
    };
    fetch(0);

    // cum = cumsum(dt·a): a Kogge-Stone scan in each warp, then over the warp totals
    const float d = tid < Q ? dt[(row0 + tid) * H + h] : 0.f;
    float v = d * a[h];
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
        cum[((size_t(b) * nc + c) * H + h) * Q + tid] = v;
    }
    __syncthreads();
    if (tid < Q) w_s[tid] = expf(cum_s[Q - 1] - v) * d;

    const int wm = warp % C::WARPS_M, wn = warp / C::WARPS_M;
    const int p0 = wm * 16, nbase = wn * C::NT * 8;
    const int g = lane / 4, t = lane % 4;
    float acc[C::NT][4];
#pragma unroll
    for (int i = 0; i < C::NT; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][k] = 0.f;

    for (int kt = 0; kt < ntiles; ++kt) {
        const int j0 = kt * TILE, rows = min(TILE, Q - j0);
        if (kt + 1 < ntiles) {
            __syncthreads();                          // tile kt − 1's stage is free
            fetch(kt + 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();                              // tile kt (and w_s) visible
        const bf16* xs = xs_of(kt % 2);
        const bf16* bs = bs_of(kt % 2);

        // S[p][n] += Σ_k (X ⊙ w)[k][p] · B[k][n], X ⊙ w split into bf16 hi + lo
        for (int k0 = 0; k0 < rows; k0 += 16) {
            uint32_t xf[4], ahi[4], alo[4];
            ldsm_x4_t(xf, xs + (k0 + lane % 8 + lane / 16 * 8) * C::SP + p0 +
                              (lane / 8) % 2 * 8);
            // xf[0], xf[1] hold rows k0 + 2t, +1; xf[2], xf[3] rows k0 + 8 + 2t, +1
            const float w0 = w_s[j0 + k0 + 2 * t], w1 = w_s[j0 + k0 + 2 * t + 1];
            const float w8 = w_s[j0 + k0 + 8 + 2 * t], w9 = w_s[j0 + k0 + 9 + 2 * t];
            split_scaled(xf[0], w0, w1, ahi[0], alo[0]);
            split_scaled(xf[1], w0, w1, ahi[1], alo[1]);
            split_scaled(xf[2], w8, w9, ahi[2], alo[2]);
            split_scaled(xf[3], w8, w9, ahi[3], alo[3]);
#pragma unroll
            for (int np = 0; np < C::NT / 2; ++np) {
                const int n0 = nbase + np * 16;
                if (n0 < N) {
                    uint32_t bf[4];
                    ldsm_x4_t(bf, bs + (k0 + lane % 8 + (lane / 8) % 2 * 8) * SN + n0 +
                                      lane / 16 * 8);
                    mma(acc[2 * np], ahi, bf[0], bf[1]);
                    mma(acc[2 * np], alo, bf[0], bf[1]);
                    mma(acc[2 * np + 1], ahi, bf[2], bf[3]);
                    mma(acc[2 * np + 1], alo, bf[2], bf[3]);
                }
            }
        }
    }

    float* sb = states + ((size_t(b) * nc + c) * H + h) * size_t(P) * N;
#pragma unroll
    for (int i = 0; i < C::NT; ++i) {
        const int n = nbase + i * 8 + 2 * t;
        if (n < N) {
            *reinterpret_cast<float2*>(sb + size_t(p0 + g) * N + n) =
                make_float2(acc[i][0], acc[i][1]);
            *reinterpret_cast<float2*>(sb + size_t(p0 + g + 8) * N + n) =
                make_float2(acc[i][2], acc[i][3]);
        }
    }
}

// ==========================================================================
// pass 2: the carry across chunks
// ==========================================================================

// h·γ + S, rounded as written (no fused multiply-add), as the reference
__device__ __forceinline__ float carry(float h, float gamma, float s) {
    return __fadd_rn(__fmul_rn(h, gamma), s);
}

// states: S_c [Bt, nc, H, P, N]; h_in: bf16(h_in[c]) out for c ≥ 1, the
// operand pass 3 multiplies; h_out: [Bt, H, P, N] or null.  One thread per 4
// consecutive (p, n), so each fp32 access moves 16 bytes.
__global__ void __launch_bounds__(PASS_THREADS)
ssd_state_pass_kernel(const float* __restrict__ states, const float* __restrict__ cum,
                      bf16* __restrict__ h_in, float* __restrict__ h_out, int nc, int H,
                      int PN4, int Q, size_t total4) {
    const size_t idx = size_t(blockIdx.x) * PASS_THREADS + threadIdx.x;
    if (idx >= total4) return;
    const size_t bh = idx / PN4, pn4 = idx % PN4;
    const size_t b = bh / H, h = bh % H;
    float4 hc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c = 0; c < nc; ++c) {
        const size_t bch = (b * nc + c) * H + h;
        const float4 sv = reinterpret_cast<const float4*>(states)[bch * PN4 + pn4];
        if (c > 0)
            reinterpret_cast<uint2*>(h_in)[bch * PN4 + pn4] =
                make_uint2(pack(hc.x, hc.y), pack(hc.z, hc.w));
        const float gamma = expf(cum[bch * Q + Q - 1]);
        hc = make_float4(carry(hc.x, gamma, sv.x), carry(hc.y, gamma, sv.y),
                         carry(hc.z, gamma, sv.z), carry(hc.w, gamma, sv.w));
    }
    if (h_out != nullptr) reinterpret_cast<float4*>(h_out)[idx] = hc;
}

// ==========================================================================
// pass 3: y
// ==========================================================================

template <int P>
struct ScanCfg {
    static constexpr int SP = P + 8;
    static constexpr int PT = P / 8;                  // n8 tiles of y per warp
    static constexpr int STAGE = TILE * SN * 2 + TILE * SP * 2;   // B and X rows
    // h_in[c] (as bf16 [P][SN]) is used before column tile 1 is copied and
    // lives in its stage
    static_assert(P * SN * 2 <= STAGE, "h_in must fit in a stage");
    static constexpr int SMEM = 3 * MAX_Q * 4 + ROWS * SN * 2 + 2 * STAGE;
};

// y: [Bt, L, H, P] bf16; h_in: bf16(h_in[c]) [Bt, nc, H, P, N] for c ≥ 1.
// A block takes ROWS rows of a chunk, a warp 16 of them.  Column tiles of 64
// go through two shared-memory stages: the copy of tile j+1 runs while tile
// j is multiplied.
template <int P>
__global__ void __launch_bounds__(SCAN_THREADS, P >= 128 ? 1 : 2)
ssd_chunk_scan_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ a, const bf16* __restrict__ bm,
                      const bf16* __restrict__ cm, const bf16* __restrict__ h_in,
                      const float* __restrict__ cum, bf16* __restrict__ y, int L, int H,
                      int N, int Q, int nc) {
    using C = ScanCfg<P>;
    extern __shared__ __align__(16) unsigned char ssd_smem[];
    float* cum_s = reinterpret_cast<float*>(ssd_smem);   // [MAX_Q]
    float* dt_s = cum_s + MAX_Q;                      // [MAX_Q]
    float* colf_s = dt_s + MAX_Q;                     // [MAX_Q] exp(cum_i0 − cum_j)·dt_j, j < i0
    bf16* cs = reinterpret_cast<bf16*>(colf_s + MAX_Q);   // [ROWS][SN] C rows of the block
    // stage s: B rows [TILE][SN], then X rows [TILE][SP] of a column tile
    auto bs_of = [&](int s) { return cs + ROWS * SN + s * (C::STAGE / 2); };
    auto xs_of = [&](int s) { return bs_of(s) + TILE * SN; };
    bf16* hs = bs_of(1);                              // [P][SN] bf16(h_in[c])

    const int nt = (Q + ROWS - 1) / ROWS;
    const int per_tile = gridDim.x / nt;             // blocks per row tile: Bt·H·nc
    const int it = nt - 1 - int(blockIdx.x) / per_tile;   // heaviest row tiles first
    const int c = int(blockIdx.x) % per_tile % nc, bh = int(blockIdx.x) % per_tile / nc;
    const int h = bh % H, b = bh / H;
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int g = lane / 4, t = lane % 4;
    const int i0 = it * ROWS;
    const int r0 = i0 + warp * 16;                    // the warp's first row in the chunk
    const bool active = r0 < Q;                       // Q is a multiple of 16
    const int iend = min(i0 + ROWS, Q);
    const int ncol = (iend + TILE - 1) / TILE;        // column tiles at or below the diagonal
    const size_t row0 = size_t(b) * L + size_t(c) * Q;
    const size_t bch = (size_t(b) * nc + c) * H + h;
    const size_t xrow = size_t(H) * P;

    auto fetch = [&](int jt) {
        const int j0 = jt * TILE, rows = min(TILE, Q - j0);
        load_tile(bs_of(jt % 2), SN, bm + (row0 + j0) * N, N, rows, N, tid, SCAN_THREADS);
        load_tile(xs_of(jt % 2), C::SP, x + (row0 + j0) * xrow + size_t(h) * P, xrow, rows,
                  P, tid, SCAN_THREADS);
    };
    load_tile(cs, SN, cm + (row0 + i0) * N, N, iend - i0, N, tid, SCAN_THREADS);
    if (c > 0) load_tile(hs, SN, h_in + bch * size_t(P) * N, N, P, N, tid, SCAN_THREADS);
    fetch(0);
    cp_async_commit();
    bool ok = true;                                   // dt ≥ 0 in this thread's rows
    for (int i = tid; i < iend; i += SCAN_THREADS) {
        cum_s[i] = cum[bch * Q + i];
        dt_s[i] = dt[(row0 + i) * H + h];
        ok = ok && dt_s[i] >= 0.f;
    }
    cp_async_wait<0>();
    // With a ≤ 0 and dt ≥ 0, cum never rises, so below the block's rows
    // (j < i0 ≤ i) exp(cum_i − cum_j) = exp(cum_i − cum_i0)·exp(cum_i0 − cum_j)
    // with both factors at most 1: one exp per row and per column instead of
    // one per element, and neither factor can overflow.
    const bool decays = __syncthreads_and(ok && a[h] <= 0.f);
    if (decays)
        for (int j = tid; j < i0; j += SCAN_THREADS)
            colf_s[j] = expf(cum_s[i0] - cum_s[j]) * dt_s[j];

    float acc[C::PT][4];
#pragma unroll
    for (int i = 0; i < C::PT; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][k] = 0.f;
    const bf16* ca = cs + (r0 - i0 + lane % 16) * SN + lane / 16 * 8;   // the warp's C rows

    // inter-chunk: exp(cum_i) ⊙ (C_i · h_inᵀ)
    if (c > 0 && active) {
#pragma unroll
        for (int kk = 0; kk < MAX_N / 16; ++kk) {
            if (kk * 16 >= N) break;
            uint32_t cf[4];
            ldsm_x4(cf, ca + kk * 16);
#pragma unroll
            for (int pp = 0; pp < P / 16; ++pp) {
                uint32_t hb[4];
                ldsm_x4(hb, hs + (pp * 16 + lane % 8 + lane / 16 * 8) * SN + kk * 16 +
                                (lane / 8) % 2 * 8);
                mma(acc[2 * pp], cf, hb[0], hb[1]);
                mma(acc[2 * pp + 1], cf, hb[2], hb[3]);
            }
        }
        const float e0 = expf(cum_s[r0 + g]), e1 = expf(cum_s[r0 + g + 8]);
#pragma unroll
        for (int i = 0; i < C::PT; ++i) {
            acc[i][0] *= e0;
            acc[i][1] *= e0;
            acc[i][2] *= e1;
            acc[i][3] *= e1;
        }
    }

    // intra-chunk, column tiles at or below the diagonal
    const int i_0 = min(r0 + g, iend - 1), i_1 = min(r0 + g + 8, iend - 1);
    const float ci0 = cum_s[i_0], ci1 = cum_s[i_1];
    const float rf0 = expf(ci0 - cum_s[i0]), rf1 = expf(ci1 - cum_s[i0]);
    for (int jt = 0; jt < ncol; ++jt) {
        const int j0 = jt * TILE;
        if (jt + 1 < ncol) {
            __syncthreads();                          // h_in or tile jt − 1's stage is free
            fetch(jt + 1);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();                              // tile jt visible
        // 16-column pairs of this tile that reach the warp's rows: all 4 below
        // them, up to and including the one on the diagonal
        const int npairs = active ? max(0, min(4, (r0 - j0) / 16 + 1)) : 0;
        if (npairs == 0) continue;
        const bf16* bs = bs_of(jt % 2);
        const bf16* xs = xs_of(jt % 2);
        const bool factored = decays && j0 + TILE <= i0;

        float s[8][4];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int k = 0; k < 4; ++k) s[i][k] = 0.f;
#pragma unroll
        for (int kk = 0; kk < MAX_N / 16; ++kk) {
            if (kk * 16 >= N) break;
            uint32_t cf[4];
            ldsm_x4(cf, ca + kk * 16);
#pragma unroll
            for (int np = 0; np < 4; ++np) {
                if (np < npairs) {
                    uint32_t bb[4];
                    ldsm_x4(bb, bs + (np * 16 + lane % 8 + lane / 16 * 8) * SN + kk * 16 +
                                    (lane / 8) % 2 * 8);
                    mma(s[2 * np], cf, bb[0], bb[1]);
                    mma(s[2 * np + 1], cf, bb[2], bb[3]);
                }
            }
        }
        // ⊙ exp(cum_i − cum_j)·dt_j where j ≤ i, 0 elsewhere; then · X_j
#pragma unroll
        for (int np = 0; np < 4; ++np) {
            if (np < npairs) {
                uint32_t af[4];
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int j = j0 + np * 16 + half * 8 + 2 * t;
                    float* sv = s[2 * np + half];
                    float v00, v01, v10, v11;
                    if (factored) {
                        const float f0 = colf_s[j], f1 = colf_s[j + 1];
                        v00 = sv[0] * f0 * rf0;
                        v01 = sv[1] * f1 * rf0;
                        v10 = sv[2] * f0 * rf1;
                        v11 = sv[3] * f1 * rf1;
                    } else {
                        const float cj0 = cum_s[j], cj1 = cum_s[j + 1];
                        const float d0 = dt_s[j], d1 = dt_s[j + 1];
                        v00 = j <= i_0 ? sv[0] * __expf(ci0 - cj0) * d0 : 0.f;
                        v01 = j + 1 <= i_0 ? sv[1] * __expf(ci0 - cj1) * d1 : 0.f;
                        v10 = j <= i_1 ? sv[2] * __expf(ci1 - cj0) * d0 : 0.f;
                        v11 = j + 1 <= i_1 ? sv[3] * __expf(ci1 - cj1) * d1 : 0.f;
                    }
                    af[2 * half] = pack(v00, v01);
                    af[2 * half + 1] = pack(v10, v11);
                }
#pragma unroll
                for (int pp = 0; pp < P / 16; ++pp) {
                    uint32_t xb[4];
                    ldsm_x4_t(xb, xs + (np * 16 + lane % 8 + (lane / 8) % 2 * 8) * C::SP +
                                      pp * 16 + lane / 16 * 8);
                    mma(acc[2 * pp], af, xb[0], xb[1]);
                    mma(acc[2 * pp + 1], af, xb[2], xb[3]);
                }
            }
        }
    }
    if (!active) return;

    bf16* yb = y + size_t(h) * P;
#pragma unroll
    for (int i = 0; i < C::PT; ++i) {
        const int p = i * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(yb + (row0 + r0 + g) * xrow + p) =
            pack(acc[i][0], acc[i][1]);
        *reinterpret_cast<uint32_t*>(yb + (row0 + r0 + g + 8) * xrow + p) =
            pack(acc[i][2], acc[i][3]);
    }
}

// ==========================================================================
// launch
// ==========================================================================

template <int P>
int launch(const void* x, const float* dt, const float* a, const void* bm,
           const void* cm, void* y, float* h_out, float* states, bf16* h_in, float* cum,
           int Bt, int L, int H, int N, int Q, cudaStream_t stream) {
    const int nc = L / Q;
    const bf16* xb = static_cast<const bf16*>(x);
    const bf16* bb = static_cast<const bf16*>(bm);
    cudaError_t err = cudaFuncSetAttribute(ssd_chunk_state_kernel<P>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           StateCfg<P>::SMEM);
    if (err != cudaSuccess) return int(err);
    ssd_chunk_state_kernel<P><<<Bt * H * nc, STATE_THREADS, StateCfg<P>::SMEM, stream>>>(
        xb, dt, a, bb, states, cum, L, H, N, Q, nc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);

    if (nc > 1 || h_out != nullptr) {
        const size_t total4 = size_t(Bt) * H * P * N / 4;
        const unsigned blocks = unsigned((total4 + PASS_THREADS - 1) / PASS_THREADS);
        ssd_state_pass_kernel<<<blocks, PASS_THREADS, 0, stream>>>(
            states, cum, h_in, h_out, nc, H, P * N / 4, Q, total4);
        err = cudaGetLastError();
        if (err != cudaSuccess) return int(err);
    }

    err = cudaFuncSetAttribute(ssd_chunk_scan_kernel<P>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               ScanCfg<P>::SMEM);
    if (err != cudaSuccess) return int(err);
    const int nt = (Q + ROWS - 1) / ROWS;
    ssd_chunk_scan_kernel<P><<<Bt * H * nc * nt, SCAN_THREADS, ScanCfg<P>::SMEM, stream>>>(
        xb, dt, a, bb, static_cast<const bf16*>(cm), h_in, cum, static_cast<bf16*>(y), L, H,
        N, Q, nc);
    return int(cudaGetLastError());
}

// P in {16, 32, 64, 128}, N % 16 == 0 and 16 ≤ N ≤ 128, Q % 16 == 0 and
// 16 ≤ Q ≤ 256, L % Q == 0; anything else returns cudaErrorInvalidValue
// without launching.
inline int dispatch(int P, const void* x, const float* dt, const float* a,
                    const void* bm, const void* cm, void* y, float* h_out, float* states,
                    void* h_in, float* cum, int Bt, int L, int H, int N, int Q,
                    cudaStream_t stream) {
    if (N < 16 || N > MAX_N || N % 16 || Q < 16 || Q > MAX_Q || Q % 16 || L % Q ||
        states == nullptr || h_in == nullptr || cum == nullptr)
        return int(cudaErrorInvalidValue);
    bf16* hb = static_cast<bf16*>(h_in);
    switch (P) {
        case 16: return launch<16>(x, dt, a, bm, cm, y, h_out, states, hb, cum, Bt, L, H, N, Q, stream);
        case 32: return launch<32>(x, dt, a, bm, cm, y, h_out, states, hb, cum, Bt, L, H, N, Q, stream);
        case 64: return launch<64>(x, dt, a, bm, cm, y, h_out, states, hb, cum, Bt, L, H, N, Q, stream);
        case 128: return launch<128>(x, dt, a, bm, cm, y, h_out, states, hb, cum, Bt, L, H, N, Q, stream);
        default: return int(cudaErrorInvalidValue);
    }
}

}  // namespace ssd_sm90
