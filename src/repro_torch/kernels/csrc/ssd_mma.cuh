// mma.sync helpers shared by the SSD scan's tensor-core kernels: the forward
// (ssd_scan_sm90.cuh) and the backward (ssd_scan_bwd_sm90.cu).  bf16 operands,
// fp32 accumulators, m16n8k16 products fed by ldmatrix from shared memory,
// and cp.async copies into it; all for sm_90a (sm_80 and later take them).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

namespace ssd_sm90 {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- copies ---------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most N of this thread's committed copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// rows [0, rows) of a bf16 tile with `cols` columns (a multiple of 8) from
// global rows `gstride` elements apart into shared rows `sstride` apart
__device__ __forceinline__ void load_tile(bf16* dst, int sstride, const bf16* src,
                                          size_t gstride, int rows, int cols,
                                          int tid, int nthreads) {
    const int segs = cols / 8;
    for (int idx = tid; idx < rows * segs; idx += nthreads) {
        const int r = idx / segs, s = idx % segs;
        cp_async16(dst + r * sstride + s * 8, src + size_t(r) * gstride + s * 8);
    }
}

// ---- mma.sync -------------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

// d += a·b for one 16×8 tile; a: 16×16 row-major, b: 16×8 column-major.  A
// plain asm statement, not volatile: it touches nothing but its operands, so
// the compiler may interleave independent products with each other and with
// the loads that feed them
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// the two bf16 of a packed pair as fp32
__device__ __forceinline__ float lo_f32(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_f32(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// (v0, v1) split into packed bf16 hi = bf16(v) and lo = bf16(v − hi)
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi, uint32_t& lo) {
    hi = pack(v0, v1);
    lo = pack(v0 - lo_f32(hi), v1 - hi_f32(hi));
}

// (x0·w0, x1·w1) for a packed bf16 pair x, split as split2
__device__ __forceinline__ void split_scaled(uint32_t x, float w0, float w1, uint32_t& hi,
                                             uint32_t& lo) {
    split2(lo_f32(x) * w0, hi_f32(x) * w1, hi, lo);
}

// Fragment addresses for a lane l of ldmatrix.x4 (g = l / 4 and t = l % 4 in
// the mma fragments):
//   A from a row-major [m][k] tile:          row m0 + l%16,            col k0 + l/16·8
//   A from a [k][m] tile (.trans):           row k0 + l%8 + l/16·8,    col m0 + (l/8)%2·8
//   B pair (n8 tiles n0, n0+8) from [n][k]:  row n0 + l%8 + l/16·8,    col k0 + (l/8)%2·8
//   B pair from a [k][n] tile (.trans):      row k0 + l%8 + (l/8)%2·8, col n0 + l/16·8
// A B pair yields {b0, b1} of tile n0 then {b0, b1} of tile n0 + 8.

}  // namespace ssd_sm90
