// Flash-attention backward for bf16 on Hopper's tensor cores (sm_90a): every
// product on wgmma, the streamed tiles loaded by TMA into an mbarrier ring,
// a producer warpgroup and two consumer warpgroups a block.  Included by
// flash_attention_bwd.cu, whose entry point launches it for bf16 at head dims
// 16, 32, 64, 96, 128 and 256 (the "wgmma" variant).
//
// Two sweeps, each the mirror of the other, no atomics (the dk/dv of a kv
// head sum over its query heads inside a block, or through fp32 partials that
// flash_bwd_kv_reduce_kernel adds in a fixed order):
//
//   dk/dv: a block owns KV_ROWS keys of one (batch, kv head) and a share of
//     its G query heads.  K and V stay in shared memory for the whole block;
//     the producer streams each visible (query head, q tile)'s Q and dO tiles
//     (TMA) with the tile's lse and delta (plain loads by the producer's 32
//     lanes, published by their arrivals on the slot's full barrier).  Per q
//     tile each consumer warpgroup computes, for its 64 keys,
//       Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ        (SS: both operands K-major in smem)
//       Pᵀ, dSᵀ on the accumulator fragments (fp32)
//       dV += Pᵀ·dO, dK += dSᵀ·Q          (RS: Pᵀ and dSᵀ, rounded to bf16, go
//                                          from the fragment into wgmma's A
//                                          registers; dO and Q are read
//                                          MN-major with the transpose flag,
//                                          as the forward reads V)
//   dq: a block owns 128 query rows of one (batch, head); Q, dO and the rows'
//     lse and delta stay; K and V tiles stream through the ring.  Per kv tile
//       S = Q·Kᵀ and dP = dO·Vᵀ (SS), dS on the fragment, dQ += dS·K (RS, K
//       read MN-major): the forward's own structure with one more product.
//
// Registers are the hard part.  ptxas sizes a block's registers by its launch
// bound with warps counted in fours: 168 a thread for 384 threads, and for
// 288 as well, so a producer of one warp would save nothing.  The producer is
// a whole warpgroup that gives its registers up (setmaxnreg.dec to 24) and
// the consumers take them (setmaxnreg.inc to 240): 128 · 24 + 256 · 240 =
// 384 · 168.  ptxas compiles the consumer code to the raised count (at 168
// the hd-128 dk/dv sweep spills 1.7 KB a thread).  A dk/dv
// consumer holds its dK and dV fragments (64 keys × DW columns each: DW fp32
// registers for the two) and Sᵀ and dPᵀ (64 keys × BQ queries: BQ registers
// for the two): 128 + 64 at hd 128.  At hd 256 dK and dV alone would be 256,
// so the two warpgroups take the same 64 keys and one half of the head dim
// each (DW = 128), and each computes the whole Sᵀ and dPᵀ: the SS products
// run twice there, as the mma.sync kernel's warp pairs ran them.  The dq
// consumer holds dQ (HD/2) and S and dP (BK registers): BK = 64 keys, 128 at
// head dims 16 and 32, 32 at hd 256, where Q and dO of 128 rows fill 128 KB
// of shared memory.
//
// Numerics (as the mma.sync kernel before it; kernels/ref.flash_bwd_mma_emulated):
// s and dp from bf16 operands into fp32; p = exp(s_cap − lse) and ds = p ·
// (dp − delta) · (1 − tanh²) in fp32, zero where masked; p and ds rounded to
// bf16 once, as the A operands of the RS products; fp32 sums; dk and dq
// scaled by 1/√hd and rounded to bf16 once.
//
// Tiles: TMA zero-fills rows past L or S and the mask drops them; only tiles
// that cross the diagonal, the window's edge, L or S evaluate the mask; a
// warpgroup whose 64 keys (rows) the mask wholly hides from a streamed tile
// skips its products and only releases the slot.  Blocks run heaviest causal
// tile first: the dk/dv sweep's low kv tiles, the dq sweep's high q tiles.

#pragma once

#include "sm90_wgmma.cuh"

namespace sm90 {

template <int HD>
struct BwdCfg {
    static constexpr int AW = HD % 64 == 0 ? 64 : HD % 32 == 0 ? 32 : HD;  // bf16 per box row
    static constexpr int ROWB = AW * 2;
    static constexpr int NCH = HD / AW;                 // boxes per tile row
    static constexpr uint64_t LAYOUT = swizzle_layout(ROWB);
    static constexpr int NWG = 2;                       // consumer warpgroups
    static constexpr int NCONS = 128 * NWG;
    static constexpr int NTHREADS = NCONS + 128;        // + the producer warpgroup
    // registers a thread after setmaxnreg (the note above)
    static constexpr int PRODUCER_REGS = 24;
    static constexpr int CONSUMER_REGS = 240;
    static constexpr int STAGES = 2;
    // dk/dv sweep: KV_ROWS keys a block, DW of the head dim a warpgroup
    static constexpr bool SPLIT_D = HD == 256;
    static constexpr int KV_ROWS = SPLIT_D ? 64 : 64 * NWG;
    static constexpr int DW = SPLIT_D ? HD / 2 : HD;
    static constexpr int BQ = 64;                       // queries a streamed tile
    static constexpr int KV_BYTES = KV_ROWS * HD * 2;
    static constexpr int QT_BYTES = BQ * HD * 2;
    static constexpr int KV_SMEM = 2 * KV_BYTES + STAGES * (2 * QT_BYTES + 2 * BQ * 4) +
                                   8 * (1 + 2 * STAGES) + 1024;
    // dq sweep: Q_ROWS query rows a block, BK keys a streamed tile
    static constexpr int Q_ROWS = 64 * NWG;
    static constexpr int BK = HD == 256 ? 32 : HD >= 64 ? 64 : 128;
    static constexpr int QB_BYTES = Q_ROWS * HD * 2;
    static constexpr int KT_BYTES = BK * HD * 2;
    static constexpr int Q_SMEM = 2 * QB_BYTES + STAGES * 2 * KT_BYTES + 8 * (1 + 2 * STAGES) +
                                  1024;
    static_assert(KV_SMEM <= 232448 && Q_SMEM <= 232448,
                  "over the 227 KB of shared memory a block may have");
    static_assert(NCH % (SPLIT_D ? 2 : 1) == 0, "a warpgroup's half is whole boxes");
};

template <int N>
__device__ __forceinline__ void reg_dealloc() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void reg_alloc() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// blockIdx.x, read anew at each call: a role that decodes its block again
// after its loop holds nothing of the first decode across the loop
__device__ __forceinline__ int block_x() {
    int x;
    asm volatile("mov.u32 %0, %%ctaid.x;\n" : "=r"(x));
    return x;
}

__device__ __forceinline__ void sts_f32(uint32_t addr, float v) {
    asm volatile("st.shared.f32 [%0], %1;\n" :: "r"(addr), "f"(v) : "memory");
}

// two fp32 from shared memory; volatile, so that the loads stay where the
// code puts them (see tile_t)
__device__ __forceinline__ float2 lds_f2(uint32_t addr) {
    float2 v;
    asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr));
    return v;
}

template <int HD>
__device__ __forceinline__ uint64_t bdesc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
    return make_desc<BwdCfg<HD>::LAYOUT>(addr, lbo, sbo);
}

// ---- the mask ----------------------------------------------------------------

// The backward's mask, for both of its variants (these sweeps and the fma
// kernel of flash_attention_bwd.cu): the pairs it keeps, and the ranges of
// rows and keys a tile can reach.
struct Mask {
    int L, S, causal, window;

    // query row qi sees key kj
    __device__ __forceinline__ bool ok(int qi, int kj) const {
        return qi < L && kj < S && (!causal || kj <= qi) && (!window || kj > qi - window);
    }
    // the query rows [lo, hi] that can see a key of [k_lo, k_hi]
    __device__ __forceinline__ void rows_seeing(int k_lo, int k_hi, int& lo, int& hi) const {
        lo = causal ? k_lo : 0;
        hi = window ? min(L - 1, k_hi + window - 1) : L - 1;
    }
    // the keys [lo, hi] that a row of [q_lo, q_hi] can see
    __device__ __forceinline__ void keys_seen(int q_lo, int q_hi, int& lo, int& hi) const {
        lo = window ? max(0, q_lo - window + 1) : 0;
        hi = causal ? min(S - 1, q_hi) : S - 1;
    }
    // whether it keeps a pair of the rows [q_lo, q_hi] and keys [k_lo, k_hi]
    // (written out, not through keys_seen: that form spills 8 bytes in the
    // hd-128 dk/dv sweep)
    __device__ __forceinline__ bool keeps_any(int q_lo, int q_hi, int k_lo, int k_hi) const {
        return q_lo < L && k_lo < S && !(causal && k_lo > min(q_hi, L - 1)) &&
               !(window && min(k_hi, S - 1) <= q_lo - window);
    }
    // ... and whether it keeps every pair of them
    __device__ __forceinline__ bool keeps_all(int q_lo, int q_hi, int k_lo, int k_hi) const {
        return q_hi < L && k_hi < S && (!causal || k_hi <= q_lo) &&
               (!window || k_lo > q_hi - window);
    }
};

// p and ds of one element from its raw products s and dp, its query's lse
// and delta; sets s := p, dp := ds (zero where masked when MASK)
template <bool CAP, bool MASK>
__device__ __forceinline__ void p_ds(float& s, float& dp, float lse, float delta, float scale,
                                     float softcap, float inv_cap, bool ok) {
    float x = s * scale;
    float d = 1.f;
    if (CAP) {
        const float t = tanhf(x * inv_cap);
        x = softcap * t;
        d = 1.f - t * t;
    }
    const float p = ex2((x - lse) * LOG2E);
    float ds = p * (dp - delta);
    if (CAP) ds *= d;
    s = MASK && !ok ? 0.f : p;
    dp = MASK && !ok ? 0.f : ds;
}

// The dk/dv sweep's fragments Sᵀ and dPᵀ (rows: keys krow, krow + 8; columns:
// queries q_lo + 8j + col0 + e) into Pᵀ and dSᵀ; lds is the shared address
// of the tile's lse [BQ] then delta [BQ].  Each column pair's lse and delta
// are loaded just before their use: the empty asm makes the next pair's
// address depend on this pair's result, or the compiler would load all
// BQ/2 pairs first and hold them (32 registers at BQ = 64) beside dK, dV,
// Sᵀ and dPᵀ
template <int BQ, bool CAP, bool MASK>
__device__ __forceinline__ void tile_t(float (&sacc)[BQ / 2], float (&dpacc)[BQ / 2],
                                       uint32_t lds, float scale, float softcap,
                                       float inv_cap, int krow, int q_lo, int col0,
                                       const Mask& m) {
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
        const float2 ls = lds_f2(lds + 4 * (8 * j + col0));
        const float2 dl = lds_f2(lds + 4 * (BQ + 8 * j + col0));
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int i = 4 * j + 2 * h + e;
                const bool ok = !MASK || m.ok(q_lo + 8 * j + col0 + e, krow + 8 * h);
                p_ds<CAP, MASK>(sacc[i], dpacc[i], e ? ls.y : ls.x, e ? dl.y : dl.x, scale,
                                softcap, inv_cap, ok);
            }
        asm volatile("" : "+r"(lds) : "f"(sacc[4 * j + 3]), "f"(dpacc[4 * j + 3]));
    }
}

// The dq sweep's fragments S and dP (rows: queries row0, row0 + 8; columns:
// keys k_lo + 8j + col0 + e) into P and dS
template <int BK, bool CAP, bool MASK>
__device__ __forceinline__ void tile_q(float (&sacc)[BK / 2], float (&dpacc)[BK / 2],
                                       const float (&lr)[2], const float (&dr)[2], float scale,
                                       float softcap, float inv_cap, int row0, int k_lo,
                                       int col0, const Mask& m) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
        const int h = (i / 2) % 2;
        const bool ok = !MASK || m.ok(row0 + 8 * h, k_lo + 8 * (i / 4) + col0 + (i % 2));
        p_ds<CAP, MASK>(sacc[i], dpacc[i], lr[h], dr[h], scale, softcap, inv_cap, ok);
    }
}

// fp32 fragment pairs → bf16 A-register fragments (k-steps of 16 columns)
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N / 4], const float (&f)[N / 2]) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) a[i] = pack_bf16(f[2 * i], f[2 * i + 1]);
}

// ---- the blocks ------------------------------------------------------------------

// A dk/dv block: batch, kv head, head share, its first key, and its visible
// query tiles (nt a head from t0) over the share's heads from g0: n_it in
// all.  Block x takes kv tile x / (B·Hkv·splits) (heaviest causal first),
// then (batch, kv head), then the share.  Each role computes it after
// setmaxnreg, so that nothing is live across the hand-over.
struct KvBlock {
    int b, hk, sp, g0, k_lo, t0, nt, n_it;
};

template <int HD>
__device__ __forceinline__ KvBlock kv_block(int splits, int B, int H, int Hkv, const Mask& m) {
    constexpr int KR = BwdCfg<HD>::KV_ROWS, BQ = BwdCfg<HD>::BQ;
    KvBlock x;
    const int per = B * Hkv * splits, G = H / Hkv, bx = block_x();
    const int bh = bx % per / splits;
    x.sp = bx % splits;
    x.b = bh / Hkv;
    x.hk = bh % Hkv;
    x.g0 = x.sp * G / splits;
    x.k_lo = bx / per * KR;
    // the query rows that can see a key of the block, in tiles of BQ
    int lo, hi;
    m.rows_seeing(x.k_lo, min(x.k_lo + KR, m.S) - 1, lo, hi);
    x.t0 = lo / BQ;
    x.nt = lo <= hi ? hi / BQ - x.t0 + 1 : 0;
    x.n_it = ((x.sp + 1) * G / splits - x.g0) * x.nt;
    return x;
}

// A dq block: batch, head, kv head, its first query row and its visible kv
// tiles [kt0, kt0 + n_it).  Block x takes q tile nq − 1 − x / (B·H)
// (heaviest causal first), then (batch, head).
struct QBlock {
    int b, h, hk, q_lo, kt0, n_it;
};

template <int HD>
__device__ __forceinline__ QBlock q_block(int B, int H, int Hkv, const Mask& m) {
    constexpr int QR = BwdCfg<HD>::Q_ROWS, BK = BwdCfg<HD>::BK;
    QBlock x;
    const int n_bh = B * H, nq = (m.L + QR - 1) / QR, bx = block_x();
    const int bh = bx % n_bh;
    x.b = bh / H;
    x.h = bh % H;
    x.hk = x.h / (H / Hkv);
    x.q_lo = (nq - 1 - bx / n_bh) * QR;
    // the keys a row of the block can see, in tiles of BK
    int lo, hi;
    m.keys_seen(x.q_lo, min(x.q_lo + QR, m.L) - 1, lo, hi);
    x.kt0 = lo / BK;
    x.n_it = lo <= hi ? hi / BK - x.kt0 + 1 : 0;
    return x;
}

// ---- the dk/dv sweep ----------------------------------------------------------

// tq/tdo: [B,L,H,HD] in boxes of BQ rows; tk/tv: [B,S,Hkv,HD] in boxes of
// KV_ROWS rows (kv_block says which block does what).  dk, dv: [B,S,Hkv,HD]
// bf16 (splits = 1) or this share's fp32 partials in part (dk's
// [splits][n], then dv's).
template <int HD>
__global__ void __launch_bounds__(BwdCfg<HD>::NTHREADS, 1)
flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const float* __restrict__ lse,
                     const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, float* __restrict__ part, int splits, int B,
                     int L, int S, int H, int Hkv, int causal, int window, float softcap,
                     float scale) {
    using C = BwdCfg<HD>;
    const Mask m{L, S, causal, window};
    constexpr int BQ = C::BQ, KR = C::KV_ROWS, STAGES = C::STAGES, AW = C::AW,
                  ROWB = C::ROWB, NCH = C::NCH, DW = C::DW, NCONS = C::NCONS;

    extern __shared__ uint8_t smem_raw[];
    const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
    const uint32_t k_s = base;                               // [NCH][KR][AW]
    const uint32_t v_s = k_s + C::KV_BYTES;
    const uint32_t q_s = v_s + C::KV_BYTES;                  // [STAGES][NCH][BQ][AW]
    const uint32_t do_s = q_s + STAGES * C::QT_BYTES;
    const uint32_t ld_s = do_s + STAGES * C::QT_BYTES;       // [STAGES][lse BQ, delta BQ]
    const uint32_t bar = ld_s + STAGES * 2 * BQ * 4;
    const uint32_t kv_full = bar;
    auto full = [&](int s) { return bar + 8u * (1 + s); };
    auto empty = [&](int s) { return bar + 8u * (1 + STAGES + s); };

    const int tid = threadIdx.x;
    if (tid == 0) {
        mbar_init(kv_full, 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full(s), 1 + 32);      // the TMA's arrival and the 32 lanes'
            mbar_init(empty(s), NCONS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (tid >= NCONS) {
        // ================= producer: one warp of the last warpgroup =================
        reg_dealloc<C::PRODUCER_REGS>();
        const int lane = tid - NCONS;
        if (lane >= 32) return;
        const KvBlock x = kv_block<HD>(splits, B, H, Hkv, m);
        if (lane == 0) {
            mbar_expect_tx(kv_full, 2 * C::KV_BYTES);
            for (int c = 0; c < NCH; ++c) {
                tma_load_4d(k_s + c * KR * ROWB, &tk, kv_full, c * AW, x.hk, x.k_lo, x.b);
                tma_load_4d(v_s + c * KR * ROWB, &tv, kv_full, c * AW, x.hk, x.k_lo, x.b);
            }
        }
        for (int it = 0; it < x.n_it; ++it) {
            const int s = it % STAGES;
            const int hq = x.hk * (H / Hkv) + x.g0 + it / x.nt;
            const int q_lo = (x.t0 + it % x.nt) * BQ;
            mbar_wait(empty(s), ((it / STAGES) & 1) ^ 1);
            if (lane == 0) {
                const uint32_t qs = q_s + s * C::QT_BYTES, dos = do_s + s * C::QT_BYTES;
                mbar_expect_tx(full(s), 2 * C::QT_BYTES);
                for (int c = 0; c < NCH; ++c) {
                    tma_load_4d(qs + c * BQ * ROWB, &tq, full(s), c * AW, hq, q_lo, x.b);
                    tma_load_4d(dos + c * BQ * ROWB, &tdo, full(s), c * AW, hq, q_lo, x.b);
                }
            }
            const int row = (x.b * H + hq) * L;
            const uint32_t l = ld_s + (s * 2 * BQ + lane) * 4;
            for (int r = 0; r < BQ; r += 32) {
                const int qi = q_lo + lane + r;
                sts_f32(l + 4 * r, qi < L ? lse[row + qi] : 0.f);
                sts_f32(l + 4 * (BQ + r), qi < L ? delta[row + qi] : 0.f);
            }
            mbar_arrive(full(s));            // releases this lane's lse and delta
        }
        return;
    }

    // ================= consumers =================
    reg_alloc<C::CONSUMER_REGS>();
    const KvBlock x = kv_block<HD>(splits, B, H, Hkv, m);
    const int wg = tid / 128;
    const int t = tid % 128;
    const int lane = t % 32;
    const int col0 = 2 * (lane % 4);
    const int kw_lo = x.k_lo + (C::SPLIT_D ? 0 : wg * 64);   // the warpgroup's 64 keys
    const int krow = kw_lo + (t / 32) * 16 + lane / 4;       // the thread's key; +8 for h = 1
    const uint32_t rows_off = C::SPLIT_D ? 0 : wg * 64 * ROWB;
    const uint32_t dcol = C::SPLIT_D ? wg * (NCH / 2) : 0;   // the first box of its columns
    const float inv_cap = softcap != 0.f ? __fdividef(1.f, softcap) : 0.f;

    float dka[DW / 2], dva[DW / 2];
#pragma unroll
    for (int i = 0; i < DW / 2; ++i) dka[i] = dva[i] = 0.f;
    float sacc[BQ / 2], dpacc[BQ / 2];
    uint32_t pf[BQ / 4], df[BQ / 4];
    mbar_wait(kv_full, 0);

    for (int it = 0; it < x.n_it; ++it) {
        const int s = it % STAGES;
        const int q_lo = (x.t0 + it % x.nt) * BQ, q_hi = q_lo + BQ - 1;
        const bool any = m.keeps_any(q_lo, q_hi, kw_lo, kw_lo + 63);
        mbar_wait(full(s), (it / STAGES) & 1);
        if (any) {
            // the empty asm hides the bases from the compiler, so that the
            // descriptors are rebuilt per tile instead of held in registers
            uint32_t kb = k_s + rows_off, vb = v_s + rows_off;
            uint32_t qs = q_s + s * C::QT_BYTES, dos = do_s + s * C::QT_BYTES;
            asm volatile("" : "+r"(kb), "+r"(vb), "+r"(qs), "+r"(dos));
#pragma unroll
            for (int i = 0; i < BQ / 2; ++i) sacc[i] = dpacc[i] = 0.f;
            reg_fence(sacc);
            reg_fence(dpacc);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk) {
                const uint32_t c = (kk * 16) / AW, off = ((kk * 16) % AW) * 2;
                wgmma_ss<BQ>(sacc, bdesc<HD>(kb + c * KR * ROWB + off, 16, 8 * ROWB),
                             bdesc<HD>(qs + c * BQ * ROWB + off, 16, 8 * ROWB), kk > 0);
            }
            wgmma_commit();
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk) {
                const uint32_t c = (kk * 16) / AW, off = ((kk * 16) % AW) * 2;
                wgmma_ss<BQ>(dpacc, bdesc<HD>(vb + c * KR * ROWB + off, 16, 8 * ROWB),
                             bdesc<HD>(dos + c * BQ * ROWB + off, 16, 8 * ROWB), kk > 0);
            }
            wgmma_commit();
            wgmma_wait0();
            reg_fence(sacc);
            reg_fence(dpacc);

            const bool need_mask = !m.keeps_all(q_lo, q_hi, kw_lo, kw_lo + 63);
            const uint32_t lds = ld_s + s * 2 * BQ * 4;
            if (softcap != 0.f) {
                if (need_mask) tile_t<BQ, true, true>(sacc, dpacc, lds, scale, softcap, inv_cap, krow, q_lo, col0, m);
                else tile_t<BQ, true, false>(sacc, dpacc, lds, scale, softcap, inv_cap, krow, q_lo, col0, m);
            } else {
                if (need_mask) tile_t<BQ, false, true>(sacc, dpacc, lds, scale, softcap, inv_cap, krow, q_lo, col0, m);
                else tile_t<BQ, false, false>(sacc, dpacc, lds, scale, softcap, inv_cap, krow, q_lo, col0, m);
            }
            pack_a<BQ>(pf, sacc);
            pack_a<BQ>(df, dpacc);

            // dV += Pᵀ·dO, dK += dSᵀ·Q over the warpgroup's DW columns
            const uint32_t cb = dcol * BQ * ROWB;
            reg_fence(dva);
            reg_fence(dka);
            reg_fence(pf);
            reg_fence(df);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < BQ / 16; ++kk) {
                const uint32_t a[4] = {pf[4 * kk], pf[4 * kk + 1], pf[4 * kk + 2], pf[4 * kk + 3]};
                wgmma_rs<DW>(dva, a, bdesc<HD>(dos + cb + kk * 16 * ROWB, BQ * ROWB, 8 * ROWB), 1);
            }
#pragma unroll
            for (int kk = 0; kk < BQ / 16; ++kk) {
                const uint32_t a[4] = {df[4 * kk], df[4 * kk + 1], df[4 * kk + 2], df[4 * kk + 3]};
                wgmma_rs<DW>(dka, a, bdesc<HD>(qs + cb + kk * 16 * ROWB, BQ * ROWB, 8 * ROWB), 1);
            }
            wgmma_commit();
            wgmma_wait0();
            reg_fence(dva);
            reg_fence(dka);
            reg_fence(pf);
            reg_fence(df);
        }
        mbar_arrive(empty(s));
    }

    // dK·scale and dV: rows krow (+ 8), columns dcol·AW + 8j + col0 (+ 1)
    const KvBlock y = kv_block<HD>(splits, B, H, Hkv, m);
    const size_t kv_row = size_t(Hkv) * HD;
    const size_t n_kv = size_t(B) * S * kv_row;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int kj = krow + 8 * h;
        if (kj >= S) continue;
        const size_t o = (size_t(y.b) * S + kj) * kv_row + size_t(y.hk) * HD + dcol * AW + col0;
#pragma unroll
        for (int j = 0; j < DW / 8; ++j) {
            const float k0 = dka[4 * j + 2 * h] * scale, k1 = dka[4 * j + 2 * h + 1] * scale;
            const float v0 = dva[4 * j + 2 * h], v1 = dva[4 * j + 2 * h + 1];
            if (splits == 1) {
                *reinterpret_cast<__nv_bfloat162*>(dk + o + 8 * j) = __floats2bfloat162_rn(k0, k1);
                *reinterpret_cast<__nv_bfloat162*>(dv + o + 8 * j) = __floats2bfloat162_rn(v0, v1);
            } else {                                 // this share's fp32 partial sums
                *reinterpret_cast<float2*>(part + y.sp * n_kv + o + 8 * j) = make_float2(k0, k1);
                *reinterpret_cast<float2*>(part + (splits + y.sp) * n_kv + o + 8 * j) =
                    make_float2(v0, v1);
            }
        }
    }
}

// ---- the dq sweep ---------------------------------------------------------------

// tq/tdo: [B,L,H,HD] in boxes of Q_ROWS rows; tk/tv: [B,S,Hkv,HD] in boxes
// of BK rows (q_block says which block does what).  dq: [B,L,H,HD] bf16.
template <int HD>
__global__ void __launch_bounds__(BwdCfg<HD>::NTHREADS, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dq, int B, int L, int S, int H, int Hkv,
                   int causal, int window, float softcap, float scale) {
    using C = BwdCfg<HD>;
    const Mask m{L, S, causal, window};
    constexpr int QR = C::Q_ROWS, BK = C::BK, STAGES = C::STAGES, AW = C::AW,
                  ROWB = C::ROWB, NCH = C::NCH, NCONS = C::NCONS;

    extern __shared__ uint8_t smem_raw[];
    const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
    const uint32_t q_s = base;                               // [NCH][QR][AW]
    const uint32_t do_s = q_s + C::QB_BYTES;
    const uint32_t k_s = do_s + C::QB_BYTES;                 // [STAGES][NCH][BK][AW]
    const uint32_t v_s = k_s + STAGES * C::KT_BYTES;
    const uint32_t bar = v_s + STAGES * C::KT_BYTES;
    const uint32_t q_full = bar;
    auto full = [&](int s) { return bar + 8u * (1 + s); };
    auto empty = [&](int s) { return bar + 8u * (1 + STAGES + s); };

    const int tid = threadIdx.x;
    if (tid == 0) {
        mbar_init(q_full, 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full(s), 1);
            mbar_init(empty(s), NCONS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (tid >= NCONS) {
        // ================= producer: one thread of the last warpgroup =================
        reg_dealloc<C::PRODUCER_REGS>();
        if (tid != NCONS) return;
        const QBlock x = q_block<HD>(B, H, Hkv, m);
        mbar_expect_tx(q_full, 2 * C::QB_BYTES);
        for (int c = 0; c < NCH; ++c) {
            tma_load_4d(q_s + c * QR * ROWB, &tq, q_full, c * AW, x.h, x.q_lo, x.b);
            tma_load_4d(do_s + c * QR * ROWB, &tdo, q_full, c * AW, x.h, x.q_lo, x.b);
        }
        for (int it = 0; it < x.n_it; ++it) {
            const int s = it % STAGES;
            const int k_lo = (x.kt0 + it) * BK;
            mbar_wait(empty(s), ((it / STAGES) & 1) ^ 1);
            const uint32_t ks = k_s + s * C::KT_BYTES, vs = v_s + s * C::KT_BYTES;
            mbar_expect_tx(full(s), 2 * C::KT_BYTES);
            for (int c = 0; c < NCH; ++c) {
                tma_load_4d(ks + c * BK * ROWB, &tk, full(s), c * AW, x.hk, k_lo, x.b);
                tma_load_4d(vs + c * BK * ROWB, &tv, full(s), c * AW, x.hk, k_lo, x.b);
            }
        }
        return;
    }

    // ================= consumers =================
    reg_alloc<C::CONSUMER_REGS>();
    const QBlock x = q_block<HD>(B, H, Hkv, m);
    const int wg = tid / 128;
    const int t = tid % 128;
    const int lane = t % 32;
    const int col0 = 2 * (lane % 4);
    const int rw_lo = x.q_lo + wg * 64;                      // the warpgroup's 64 rows
    const int row0 = rw_lo + (t / 32) * 16 + lane / 4;       // the thread's row; +8 for r = 1
    const float inv_cap = softcap != 0.f ? __fdividef(1.f, softcap) : 0.f;
    float lr[2], dr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int qi = row0 + 8 * r;
        const size_t row = (size_t(x.b) * H + x.h) * L + qi;
        lr[r] = qi < L ? lse[row] : 0.f;
        dr[r] = qi < L ? delta[row] : 0.f;
    }
    float dqa[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dqa[i] = 0.f;
    float sacc[BK / 2], dpacc[BK / 2];
    uint32_t df[BK / 4];
    mbar_wait(q_full, 0);

    for (int it = 0; it < x.n_it; ++it) {
        const int s = it % STAGES;
        const int k_lo = (x.kt0 + it) * BK;
        const bool any = m.keeps_any(rw_lo, rw_lo + 63, k_lo, k_lo + BK - 1);
        mbar_wait(full(s), (it / STAGES) & 1);
        if (any) {
            uint32_t qb = q_s + wg * 64 * ROWB, dob = do_s + wg * 64 * ROWB;
            uint32_t ks = k_s + s * C::KT_BYTES, vs = v_s + s * C::KT_BYTES;
            asm volatile("" : "+r"(qb), "+r"(dob), "+r"(ks), "+r"(vs));
#pragma unroll
            for (int i = 0; i < BK / 2; ++i) sacc[i] = dpacc[i] = 0.f;
            reg_fence(sacc);
            reg_fence(dpacc);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk) {
                const uint32_t c = (kk * 16) / AW, off = ((kk * 16) % AW) * 2;
                wgmma_ss<BK>(sacc, bdesc<HD>(qb + c * QR * ROWB + off, 16, 8 * ROWB),
                             bdesc<HD>(ks + c * BK * ROWB + off, 16, 8 * ROWB), kk > 0);
            }
            wgmma_commit();
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk) {
                const uint32_t c = (kk * 16) / AW, off = ((kk * 16) % AW) * 2;
                wgmma_ss<BK>(dpacc, bdesc<HD>(dob + c * QR * ROWB + off, 16, 8 * ROWB),
                             bdesc<HD>(vs + c * BK * ROWB + off, 16, 8 * ROWB), kk > 0);
            }
            wgmma_commit();
            wgmma_wait0();
            reg_fence(sacc);
            reg_fence(dpacc);

            const bool need_mask = !m.keeps_all(rw_lo, rw_lo + 63, k_lo, k_lo + BK - 1);
            if (softcap != 0.f) {
                if (need_mask) tile_q<BK, true, true>(sacc, dpacc, lr, dr, scale, softcap, inv_cap, row0, k_lo, col0, m);
                else tile_q<BK, true, false>(sacc, dpacc, lr, dr, scale, softcap, inv_cap, row0, k_lo, col0, m);
            } else {
                if (need_mask) tile_q<BK, false, true>(sacc, dpacc, lr, dr, scale, softcap, inv_cap, row0, k_lo, col0, m);
                else tile_q<BK, false, false>(sacc, dpacc, lr, dr, scale, softcap, inv_cap, row0, k_lo, col0, m);
            }
            pack_a<BK>(df, dpacc);

            // dQ += dS·K
            reg_fence(dqa);
            reg_fence(df);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk) {
                const uint32_t a[4] = {df[4 * kk], df[4 * kk + 1], df[4 * kk + 2], df[4 * kk + 3]};
                wgmma_rs<HD>(dqa, a, bdesc<HD>(ks + kk * 16 * ROWB, BK * ROWB, 8 * ROWB), 1);
            }
            wgmma_commit();
            wgmma_wait0();
            reg_fence(dqa);
            reg_fence(df);
        }
        mbar_arrive(empty(s));
    }

    // dQ·scale → bf16, rows below L
    const QBlock y = q_block<HD>(B, H, Hkv, m);
    const size_t q_row = size_t(H) * HD;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int qi = row0 + 8 * r;
        if (qi >= L) continue;
        __nv_bfloat16* out = dq + (size_t(y.b) * L + qi) * q_row + size_t(y.h) * HD + col0;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) = __floats2bfloat162_rn(
                dqa[4 * j + 2 * r] * scale, dqa[4 * j + 2 * r + 1] * scale);
    }
}

// ---- host side --------------------------------------------------------------

// The dk/dv sweep of one call (delta is computed before, by the caller); it
// writes fp32 partials into part where splits > 1, and the caller's
// reduction then runs before the dq sweep.  Returns the first cudaError_t.
template <int HD>
int launch_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                    const float* lse, const float* delta, void* dk, void* dv, float* part,
                    int splits, int B, int L, int S, int H, int Hkv, int causal, int window,
                    float softcap, float scale, cudaStream_t stream) {
    using C = BwdCfg<HD>;
    CUtensorMap tq, tdo, tk, tv;
    if (!make_map(&tq, q, HD, H, L, B, C::AW, C::BQ) ||
        !make_map(&tdo, dout, HD, H, L, B, C::AW, C::BQ) ||
        !make_map(&tk, k, HD, Hkv, S, B, C::AW, C::KV_ROWS) ||
        !make_map(&tv, v, HD, Hkv, S, B, C::AW, C::KV_ROWS))
        return int(cudaErrorInvalidValue);
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkdv_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::KV_SMEM);
    if (err != cudaSuccess) return int(err);
    const int blocks = (S + C::KV_ROWS - 1) / C::KV_ROWS * B * Hkv * splits;
    flash_bwd_dkdv_wgmma<HD><<<blocks, C::NTHREADS, C::KV_SMEM, stream>>>(
        tq, tdo, tk, tv, lse, delta, static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), part, splits, B, L, S, H, Hkv, causal, window, softcap,
        scale);
    return int(cudaGetLastError());
}

template <int HD>
int launch_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                  const float* lse, const float* delta, void* dq, int B, int L, int S, int H,
                  int Hkv, int causal, int window, float softcap, float scale,
                  cudaStream_t stream) {
    using C = BwdCfg<HD>;
    CUtensorMap tq, tdo, tk, tv;
    if (!make_map(&tq, q, HD, H, L, B, C::AW, C::Q_ROWS) ||
        !make_map(&tdo, dout, HD, H, L, B, C::AW, C::Q_ROWS) ||
        !make_map(&tk, k, HD, Hkv, S, B, C::AW, C::BK) ||
        !make_map(&tv, v, HD, Hkv, S, B, C::AW, C::BK))
        return int(cudaErrorInvalidValue);
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::Q_SMEM);
    if (err != cudaSuccess) return int(err);
    const int blocks = (L + C::Q_ROWS - 1) / C::Q_ROWS * B * H;
    flash_bwd_dq_wgmma<HD><<<blocks, C::NTHREADS, C::Q_SMEM, stream>>>(
        tq, tdo, tk, tv, lse, delta, static_cast<__nv_bfloat16*>(dq), B, L, S, H, Hkv, causal,
        window, softcap, scale);
    return int(cudaGetLastError());
}

}  // namespace sm90
