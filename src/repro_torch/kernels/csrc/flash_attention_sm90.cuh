// Flash-attention forward for bf16 on Hopper's tensor cores (sm_90a): wgmma
// for both products, TMA loads into an mbarrier ring, one producer thread and
// one or two consumer warpgroups.  Included by flash_attention.cu, whose entry point
// launches it for bf16 at head dims 16, 32, 64, 96, 128 and 256 (the "wgmma"
// variant); fp32 and head dim 8 keep the FMA kernel there.
//
// Replaces, for those calls, the Pallas TPU kernel
// src/repro/kernels/flash_attention.py (flash_attention_fwd + _kernel).  It
// computes the same function, not the same blocks: causal mask, sliding
// window (with or without causal masking), tanh softcap (precise tanhf),
// GQA with kv head h / (H / Hkv), the finite NEG_INF = -2.3819763e38 (a row
// that is fully masked in a processed tile gets p = 1 there, and the next
// tile's correction exp(NEG_INF - m) = 0 wipes it, as on the TPU) and the
// denominator clamped at 1e-37.
//
// Numerics: S = Q·Kᵀ multiplies bf16 values exactly and sums in fp32; the
// scale, softcap, mask and online softmax run in fp32 on the accumulator
// fragment; the denominator sums fp32 p; p is rounded to bf16 for
// O += P·V (fp32 accumulation), the one rounding the FMA variant does not
// make (ROADMAP Queue 3 b); O / max(l, 1e-37) is rounded to bf16.  Given an
// lse pointer, the epilogue also stores each row's fp32 log-sum-exp
// m + log(max(l, 1e-37)) for the training backward; without one it stores
// nothing more.
//
// Design:
//   * a work item is 128 query rows of one (batch, head), 64 at hd 256; the
//     grid is persistent (one block per SM), each block walking the items
//     heaviest causal q tile first, so one item's loads overlap the last
//     one's tail;
//   * consumer warpgroups take 64 rows each (two, one at hd 256, where the O
//     fragment alone is 128 registers a thread: see Cfg); in the last
//     warpgroup one thread issues the TMA loads (each item's Q, then K and V
//     tiles into a ring of STAGES slots with full/empty mbarriers) and the
//     other threads exit;
//   * kv tiles of 128 keys (64 at hd 128 and 256, to fit the registers);
//   * shared-memory tiles are TMA boxes 64 bf16 wide with the 128-byte
//     swizzle, one box per 64 columns; where hd is not a multiple of 64 the
//     boxes are 32 wide with the 64-byte swizzle (three of them at hd 96) or,
//     at hd 16, one box of 16 with the 32-byte swizzle: the layout the wgmma
//     descriptors name.  Q and K are
//     K-major for S = Q·Kᵀ; V is MN-major for O += P·V, read with the
//     transpose flag; P goes from the S fragment straight into wgmma's
//     A-register fragment;
//   * q, k and v are mapped as 4-D {hd, heads, len, batch} tensors, so a
//     tile that runs past L (or S) is zero-filled instead of reading the
//     next batch's rows;
//   * kv tiles that masking empties are skipped, and only tiles that cross
//     the diagonal, the window's edge or S evaluate the mask, in a loop
//     without branches.
//
// What bounds it: at the yi-9b prefill shape (B=4, L=512, H=32, Hkv=4,
// hd=128) the function moves ~38 MB (11 us at 3.35 TB/s) and does ~8.6
// GFLOP of causal products (9 us at 989 TFLOP/s), so bytes bound it; the
// products run on the tensor cores, the loads overlap them through the
// ring, and each K/V tile is read once per work item (per 128 query rows of
// a head, 64 at hd 256).
//
// The mbarrier, TMA, descriptor and wgmma helpers and the tensor maps'
// encoding are sm90_wgmma.cuh's, shared with the backward.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "sm90_wgmma.cuh"

namespace sm90 {

constexpr float NEG_INF = -2.3819763e38f;
// Per head dim: NWG consumer warpgroups of 64 query rows each, plus one
// producer warpgroup, one block per SM.  ptxas gives every thread of the
// block the registers the launch bound allows (65536 / NTHREADS, rounded down
// to a multiple of 8; this kernel uses no setmaxnreg to move them): 168 with
// two consumer warpgroups, which holds the hd-128 fragments with kv tiles of
// 64 keys (with 128 keys they spill); at hd 256 the O fragment alone is 128
// registers, so one consumer warpgroup takes up to 255.  A row of a tile is
// NCH boxes of AW bf16: 64 where hd is a multiple of 64, else 32 (hd 96: three
// boxes, so that NCH is whole) or hd itself (16).
template <int HD>
struct Cfg {
    static constexpr int NWG = HD == 256 ? 1 : 2;
    static constexpr int NTHREADS = 128 * (NWG + 1);
    static constexpr int BQ = 64 * NWG;                 // q rows per work item
    static constexpr int BK = HD >= 128 ? 64 : 128;     // keys per kv tile
    static constexpr int STAGES = 2;
    static constexpr int AW = HD % 64 == 0 ? 64 : HD % 32 == 0 ? 32 : HD;  // bf16 per box row
    static constexpr int ROWB = AW * 2;                 // 32, 64 or 128 bytes
    static constexpr int NCH = HD / AW;                 // boxes per tile row
    static constexpr uint64_t LAYOUT = swizzle_layout(ROWB);
    static constexpr int Q_BYTES = BQ * HD * 2;
    static constexpr int KV_BYTES = BK * HD * 2;
    static constexpr int BAR_BYTES = 8 * (2 + 3 * STAGES);
    // +1024: the dynamic base is rounded up to the 1024-byte swizzle period
    static constexpr int SMEM = Q_BYTES + 2 * STAGES * KV_BYTES + BAR_BYTES + 1024;
    static_assert(SMEM <= 232448, "over the 227 KB of shared memory a block may have");
};

template <int HD>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
    return make_desc<Cfg<HD>::LAYOUT>(addr, lbo, sbo);
}

// Scales, softcaps and masks the S fragment of one kv tile in place and
// returns its two rows' maxima over the quad.  Element i is query row
// row0 + 8·((i/2)%2), key k_lo + 8·(i/4) + col0 + i%2; row qi may attend
// keys kmin < kj <= kmax.  CAP and MASK are template flags so the element
// loop has no branches.
template <int BK, bool CAP, bool MASK>
__device__ __forceinline__ void score_tile(float (&sacc)[BK / 2], float (&mx)[2],
                                           float scale, float softcap, float inv_cap,
                                           int k_lo, int col0, int row0, int S, int causal,
                                           int window) {
    int kmin[2], kmax[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int qi = row0 + 8 * r;
        kmax[r] = causal ? min(qi, S - 1) : S - 1;
        kmin[r] = window ? qi - window : -1;
    }
    mx[0] = mx[1] = NEG_INF;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
        const int r = (i / 2) % 2;
        float x = sacc[i] * scale;
        if (CAP) x = softcap * tanhf(x * inv_cap);
        if (MASK) {
            const int kj = k_lo + 8 * (i / 4) + col0 + (i % 2);
            x = kj > kmin[r] && kj <= kmax[r] ? x : NEG_INF;
        }
        sacc[i] = x;
        mx[r] = fmaxf(mx[r], x);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
}

// ---- the kernel -----------------------------------------------------------

// One work item: BQ query rows of one (batch, head) and the kv tiles
// [ik_begin, ik_end) that its masks leave non-empty.  Items are numbered
// heaviest causal q tiles first.
struct Item {
    int b, h, hk, q_lo, ik_begin, ik_end;
};

template <int HD>
__device__ __forceinline__ Item item_at(int w, int n_bh, int nq, int L, int S, int H,
                                        int Hkv, int causal, int window) {
    using C = Cfg<HD>;
    Item x;
    const int bh = w % n_bh;
    x.b = bh / H;
    x.h = bh % H;
    x.hk = x.h / (H / Hkv);
    x.q_lo = (nq - 1 - w / n_bh) * C::BQ;
    x.ik_begin = 0;
    x.ik_end = (S + C::BK - 1) / C::BK;
    if (causal) x.ik_end = min(x.ik_end, (min(x.q_lo + C::BQ, L) - 1) / C::BK + 1);
    // tiles wholly before the first row's window are empty for every row.  An
    // item keeps at least one tile: without causal masking, rows past S +
    // window have no key (outside the contract), and an item without tiles
    // would never release Q to the producer.
    if (window) x.ik_begin = min(max(0, (x.q_lo - window + 1) / C::BK), x.ik_end - 1);
    return x;
}

// o: [B, L, H, HD] bf16, contiguous; q/k/v arrive through the tensor maps.
// Persistent: block i takes work items i, i + gridDim.x, ...; the producer
// loads the next item's Q and first K/V tiles while the consumers finish the
// current one.
template <int HD>
__global__ void __launch_bounds__(Cfg<HD>::NTHREADS, 1)
flash_fwd_kernel_wgmma(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int B,
                       int L, int S, int H, int Hkv, int causal, int window, float softcap,
                       float scale) {
    using C = Cfg<HD>;
    constexpr int BQ = C::BQ, BK = C::BK, STAGES = C::STAGES, AW = C::AW,
                  ROWB = C::ROWB, NCH = C::NCH, NCONS = 128 * C::NWG;

    extern __shared__ uint8_t smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023u) & ~1023u;
    const uint32_t q_s = base;                               // [NCH][BQ][AW]
    const uint32_t k_s = q_s + C::Q_BYTES;                   // [STAGES][NCH][BK][AW]
    const uint32_t v_s = k_s + STAGES * C::KV_BYTES;
    const uint32_t bar = v_s + STAGES * C::KV_BYTES;
    const uint32_t q_full = bar, q_empty = bar + 8;
    auto k_full = [&](int s) { return bar + 8u * (2 + s); };
    auto v_full = [&](int s) { return bar + 8u * (2 + STAGES + s); };
    auto empty = [&](int s) { return bar + 8u * (2 + 2 * STAGES + s); };

    const int n_bh = B * H, nq = (L + BQ - 1) / BQ, n_items = nq * n_bh;
    const int tid = threadIdx.x;
    if (tid == 0) {
        mbar_init(q_full, 1);
        mbar_init(q_empty, NCONS);                           // every consumer thread
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(k_full(s), 1);
            mbar_init(v_full(s), 1);
            mbar_init(empty(s), NCONS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (tid >= NCONS) {
        // ================= producer: one thread =================
        if (tid != NCONS) return;
        int it = 0;                                          // kv tiles over all items
        for (int w = blockIdx.x, j = 0; w < n_items; w += gridDim.x, ++j) {
            const Item x = item_at<HD>(w, n_bh, nq, L, S, H, Hkv, causal, window);
            mbar_wait(q_empty, (j & 1) ^ 1);                 // last item's Q read
            mbar_expect_tx(q_full, C::Q_BYTES);
            for (int c = 0; c < NCH; ++c)
                tma_load_4d(q_s + c * BQ * ROWB, &tq, q_full, c * AW, x.h, x.q_lo, x.b);
            for (int ik = x.ik_begin; ik < x.ik_end; ++ik, ++it) {
                const int s = it % STAGES;
                mbar_wait(empty(s), ((it / STAGES) & 1) ^ 1);
                const uint32_t ks = k_s + s * C::KV_BYTES, vs = v_s + s * C::KV_BYTES;
                mbar_expect_tx(k_full(s), C::KV_BYTES);
                for (int c = 0; c < NCH; ++c)
                    tma_load_4d(ks + c * BK * ROWB, &tk, k_full(s), c * AW, x.hk, ik * BK, x.b);
                mbar_expect_tx(v_full(s), C::KV_BYTES);
                for (int c = 0; c < NCH; ++c)
                    tma_load_4d(vs + c * BK * ROWB, &tv, v_full(s), c * AW, x.hk, ik * BK, x.b);
            }
        }
        return;
    }

    // ================= consumers =================
    const int wg = tid / 128;
    const int t = tid % 128;
    const int lane = t % 32;
    const int col0 = 2 * (lane % 4);
    const int trow = wg * 64 + (t / 32) * 16 + lane / 4;
    // no IEEE division in the consumers: its slow path is a call, and a call
    // with 64–128 live accumulator registers spills them
    const float inv_cap = softcap != 0.f ? __fdividef(1.f, softcap) : 0.f;
    // K-major (Q, K): SBO = one 8-row group; LBO unused with a swizzle.
    // MN-major (V): LBO = next box of AW columns, SBO = next 8 keys.
    const uint32_t q_wg = q_s + wg * 64 * ROWB;
    float oacc[HD / 2];
    float sacc[BK / 2];
    uint32_t pf[BK / 4];
    int it = 0;

    for (int w = blockIdx.x, j = 0; w < n_items; w += gridDim.x, ++j) {
        // only the row range and tile range stay live across the tile loop;
        // the epilogue recomputes the rest from w (registers are at the cap)
        const Item x = item_at<HD>(w, n_bh, nq, L, S, H, Hkv, causal, window);
        const int q_lo = x.q_lo, ik_end = x.ik_end;
        const int row0 = q_lo + trow;                    // the thread's row; +8 for r = 1
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) oacc[i] = 0.f;
        float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
        mbar_wait(q_full, j & 1);

        for (int ik = x.ik_begin; ik < ik_end; ++ik, ++it) {
            const int s = it % STAGES;
            const uint32_t ph = (it / STAGES) & 1;
            const uint32_t ks = k_s + s * C::KV_BYTES, vs = v_s + s * C::KV_BYTES;
            const int k_lo = ik * BK;

            // S = Q·Kᵀ.  The empty asm hides q_wg's value from the compiler, so
            // the HD/16 Q descriptors are rebuilt per tile instead of held in
            // registers across the loop.
            uint32_t q_base = q_wg;
            asm volatile("" : "+r"(q_base));
#pragma unroll
            for (int i = 0; i < BK / 2; ++i) sacc[i] = 0.f;
            mbar_wait(k_full(s), ph);
            reg_fence(sacc);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk) {
                const uint32_t c = (kk * 16) / AW, off = ((kk * 16) % AW) * 2;
                wgmma_ss<BK>(sacc,
                             smem_desc<HD>(q_base + c * BQ * ROWB + off, 16, 8 * ROWB),
                             smem_desc<HD>(ks + c * BK * ROWB + off, 16, 8 * ROWB),
                             kk > 0);
            }
            wgmma_commit();
            wgmma_wait0();
            reg_fence(sacc);
            if (ik == ik_end - 1) mbar_arrive(q_empty);    // the producer may reload Q

            // scale, softcap, mask, online softmax, on the fragment; only
            // tiles that cross the diagonal, the window's edge or S mask
            const int wg_lo = q_lo + wg * 64;
            const bool need_mask = k_lo + BK > S || (causal && k_lo + BK - 1 > wg_lo) ||
                                   (window && k_lo <= wg_lo + 63 - window);
            float mx[2];
            if (softcap != 0.f) {
                if (need_mask) score_tile<BK, true, true>(sacc, mx, scale, softcap, inv_cap, k_lo, col0, row0, S, causal, window);
                else score_tile<BK, true, false>(sacc, mx, scale, softcap, inv_cap, k_lo, col0, row0, S, causal, window);
            } else {
                if (need_mask) score_tile<BK, false, true>(sacc, mx, scale, softcap, inv_cap, k_lo, col0, row0, S, causal, window);
                else score_tile<BK, false, false>(sacc, mx, scale, softcap, inv_cap, k_lo, col0, row0, S, causal, window);
            }
            float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                const float mn = fmaxf(m[r], mx[r]);
                corr[r] = ex2((m[r] - mn) * LOG2E);
                m[r] = mn;
            }
#pragma unroll
            for (int i = 0; i < BK / 2; ++i) {
                const float p = ex2((sacc[i] - m[(i / 2) % 2]) * LOG2E);
                sacc[i] = p;
                rs[(i / 2) % 2] += p;
            }
#pragma unroll
            for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
#pragma unroll
            for (int i = 0; i < HD / 2; ++i) oacc[i] *= corr[(i / 2) % 2];
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk) {
                pf[4 * kk + 0] = pack_bf16(sacc[8 * kk + 0], sacc[8 * kk + 1]);
                pf[4 * kk + 1] = pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
                pf[4 * kk + 2] = pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
                pf[4 * kk + 3] = pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
            }

            // O += P·V
            mbar_wait(v_full(s), ph);
            reg_fence(oacc);
            reg_fence(pf);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk) {
                const uint32_t a[4] = {pf[4 * kk], pf[4 * kk + 1], pf[4 * kk + 2],
                                       pf[4 * kk + 3]};
                wgmma_rs<HD>(oacc, a,
                             smem_desc<HD>(vs + kk * 16 * ROWB, BK * ROWB, 8 * ROWB), 1);
            }
            wgmma_commit();
            wgmma_wait0();
            reg_fence(oacc);
            reg_fence(pf);
            mbar_arrive(empty(s));
        }

        // O / max(l, 1e-37) → bf16, rows below L only; with lse, each row's
        // log-sum-exp m + log(max(l, 1e-37)) (m in natural units of the
        // scaled logits) from the quad's first lane, before l is inverted
        const int bh = w % n_bh;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
            l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
            l[r] = fmaxf(l[r], 1e-37f);
            const int qi = row0 + 8 * r;
            if (lse != nullptr && lane % 4 == 0 && qi < L)
                lse[size_t(bh) * L + qi] = m[r] + __logf(l[r]);
            l[r] = __fdividef(1.f, l[r]);
        }
        const size_t q_row = size_t(H) * HD;
        __nv_bfloat16* ob = o + size_t(bh / H) * L * q_row + size_t(bh % H) * HD;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int qi = row0 + 8 * r;
            if (qi >= L) continue;
            __nv_bfloat16* orow = ob + size_t(qi) * q_row + col0;
#pragma unroll
            for (int jj = 0; jj < HD / 8; ++jj) {
                const __nv_bfloat162 v2 = __floats2bfloat162_rn(
                    oacc[4 * jj + 2 * r] * l[r], oacc[4 * jj + 2 * r + 1] * l[r]);
                *reinterpret_cast<__nv_bfloat162*>(orow + 8 * jj) = v2;
            }
        }
    }
}

// ---- host side ------------------------------------------------------------

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int L, int S,
           int H, int Hkv, int causal, int window, float softcap, float scale,
           cudaStream_t stream) {
    using C = Cfg<HD>;
    CUtensorMap tq, tk, tv;
    if (!make_map(&tq, q, HD, H, L, B, C::AW, C::BQ) ||
        !make_map(&tk, k, HD, Hkv, S, B, C::AW, C::BK) ||
        !make_map(&tv, v, HD, Hkv, S, B, C::AW, C::BK))
        return int(cudaErrorInvalidValue);
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return int(err);
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
        return int(cudaGetLastError());
    const int n_items = (L + C::BQ - 1) / C::BQ * B * H;
    flash_fwd_kernel_wgmma<HD><<<n_items < sms ? n_items : sms, C::NTHREADS, C::SMEM, stream>>>(
        tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, B, L, S, H, Hkv, causal, window,
        softcap, scale);
    return int(cudaGetLastError());
}

inline int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o, float* lse,
                       int B, int L, int S, int H, int Hkv, int causal, int window,
                       float softcap, float scale, cudaStream_t stream) {
    switch (hd) {
        case 16: return launch<16>(q, k, v, o, lse, B, L, S, H, Hkv, causal, window, softcap, scale, stream);
        case 32: return launch<32>(q, k, v, o, lse, B, L, S, H, Hkv, causal, window, softcap, scale, stream);
        case 64: return launch<64>(q, k, v, o, lse, B, L, S, H, Hkv, causal, window, softcap, scale, stream);
        case 96: return launch<96>(q, k, v, o, lse, B, L, S, H, Hkv, causal, window, softcap, scale, stream);
        case 128: return launch<128>(q, k, v, o, lse, B, L, S, H, Hkv, causal, window, softcap, scale, stream);
        case 256: return launch<256>(q, k, v, o, lse, B, L, S, H, Hkv, causal, window, softcap, scale, stream);
        default: return int(cudaErrorInvalidValue);
    }
}

}  // namespace sm90
