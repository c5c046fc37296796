// Hopper (sm_90a) building blocks shared by the bf16 flash-attention kernels
// (flash_fwd_sm90.cu, flash_bwd_sm90.cu), in inline PTX:
//
// - cp.async copies from device memory straight into the 128-byte-swizzled tile layout
//   that a wgmma shared-memory descriptor reads, with zero fill through the src-size
//   operand (rows past the sequence, columns past dh);
// - TMA tensor loads (cp.async.bulk.tensor) into the same layout, counted on mbarriers,
//   with the mbarrier operations of a producer/consumer ring (the forward);
// - warpgroup matrix products `wgmma.mma_async ... m64n64k16.f32.bf16.bf16`, with A
//   from shared memory or from registers and B from shared memory, K-major or MN-major;
// - the fences, commits and waits that order them.
//
// Tile layout ("panel"): 64 rows x 64 bf16 (128 bytes a row), 8 KB, 1024-byte aligned.
// Row r's 16-byte chunk c sits at r * 128 + ((c ^ (r % 8)) * 16): the 128-byte swizzle.
// A tile of DH columns is DH / 64 panels one after the other (panel p holds the columns
// 64p .. 64p + 63). The same bytes serve as a K-major operand (rows = M or N, the
// contiguous 64 = K) and as an MN-major one (rows = K, the contiguous 64 = M or N).
// Every product issued here spans at most one panel in its contiguous direction, so
// only the stride between 8-row groups (1024 bytes) enters a descriptor; both of its
// byte-offset fields hold that value.

#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace ucf {
namespace sm90 {

constexpr int PANEL_ROWS = 64;
constexpr uint32_t PANEL_BYTES = 64 * 128;
constexpr uint32_t ROW_BYTES = 128;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The 1024-byte aligned start of the dynamic shared memory (the launch asks for 1 KB more).
__device__ __forceinline__ uint32_t aligned_smem_base(const void* smem) {
  return (smem_u32(smem) + 1023u) & ~1023u;
}

// Byte offset of element e (0 <= e < 64 * panels) of row r in a swizzled tile.
__device__ __forceinline__ uint32_t swizzle_offset(int r, int e) {
  return (uint32_t)(e >> 6) * PANEL_BYTES + (uint32_t)r * ROW_BYTES +
         ((uint32_t)(((e & 63) >> 3) ^ (r & 7)) << 4) + ((uint32_t)(e & 7) << 1);
}

// ------------------------------------------------------------------ cp.async

template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, int src_bytes) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(src_bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src),
                 "n"(BYTES), "r"(src_bytes)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Make this thread's ordinary (generic-proxy) shared-memory writes, cp.async included,
// visible to the async proxy that wgmma reads through. Then a barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows [row0, row0 + 64) x columns [0, 64 * NP) of a strided bf16 slice into the
// swizzled tile at `dst`, by the 128 threads of the block, CB bytes per copy (16 or 8 by
// cp.async; 2 by ordinary loads, for rows not 8-byte aligned). Zeros past `nrows` and
// past `dh`. Ends with no commit: the caller groups its copies.
// threadIdx.x through a volatile asm, so that the compiler cannot hoist the copies'
// address arithmetic out of the callers' tile loops: hoisted, it stays in registers for
// the whole loop, for each of load_tile's copy widths, and the kernels no longer fit
// the register budgets of their __launch_bounds__ without spills.
__device__ __forceinline__ int opaque_tid() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(t));
  return t;
}

template <int CB, int NP>
__device__ __forceinline__ void load_tile_cb(uint32_t dst, const __nv_bfloat16* src,
                                             long long sn, int row0, int nrows, int dh) {
  constexpr int EC = CB / 2;              // elements per copy
  constexpr int CPR = 64 * NP / EC;       // copies per row
  for (int idx = opaque_tid(); idx < PANEL_ROWS * CPR; idx += 128) {
    const int r = idx / CPR;
    const int e = (idx - r * CPR) * EC;
    const int row = row0 + r;
    int valid = (row < nrows) ? dh - e : 0;
    valid = valid < 0 ? 0 : (valid > EC ? EC : valid);
    const __nv_bfloat16* s = valid > 0 ? src + (long long)row * sn + e : src;
    const uint32_t d = dst + swizzle_offset(r, e);
    if constexpr (CB >= 8) {
      cp_async<CB>(d, s, 2 * valid);
    } else {
      const unsigned short x =
          valid > 0 ? __ldg(reinterpret_cast<const unsigned short*>(s)) : (unsigned short)0;
      asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(d), "h"(x) : "memory");
    }
  }
}

template <int NP>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* src, long long sn,
                                          int row0, int nrows, int dh, int cb) {
  switch (cb) {
    case 16: load_tile_cb<16, NP>(dst, src, sn, row0, nrows, dh); break;
    case 8: load_tile_cb<8, NP>(dst, src, sn, row0, nrows, dh); break;
    default: load_tile_cb<2, NP>(dst, src, sn, row0, nrows, dh); break;
  }
}

// ------------------------------------------------------------------ TMA and mbarriers
//
// A tile loaded by `cp.async.bulk.tensor` (TMA) with a tensor map encoded for
// CU_TENSOR_MAP_SWIZZLE_128B and a box of 64 bf16 columns lands in exactly the panel
// layout above: the hardware writes row r's 16-byte chunk c at r * 128 + ((c ^ (r % 8))
// * 16) of a 1024-byte-aligned destination. Completion is counted in bytes on an
// mbarrier in shared memory (expect_tx by the issuing thread, complete_tx by the copy).

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(arrivals) : "memory");
}

// Make the initialised barriers visible to the other threads and to the async proxy
// (TMA); a __syncthreads follows.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// One arrival that also announces `bytes` to come from asynchronous copies.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed (the barrier's current phase
// differs from it): the n-th completion (from 0) is waited for with parity n & 1.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// A box of a 4-d tensor map into shared memory at `dst`, counted on `bar`. Coordinates
// are in elements, innermost first; out-of-range elements arrive as zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* map, uint32_t bar, int c0,
                                            int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Barrier among the `threads` threads (a multiple of 32) that use barrier `id` (1..15;
// 0 is __syncthreads').
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ------------------------------------------------------------------ wgmma

// Shared-memory matrix descriptor: start address, both byte offsets 1024 (the 8-row
// group stride), 128-byte swizzle.
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFFu) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of these registers across the
// asynchronous products (before a wgmma that reads them, after the wait).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define UCF_WGMMA_D32                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "  \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define UCF_WGMMA_D32_OPS(d)                                                             \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),    \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),         \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),      \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),      \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

// d[64 x 64] += A[64 x 16] . B[16 x 64], A and B in shared memory. TRANS_A / TRANS_B:
// 0 = K-major (K contiguous), 1 = MN-major.
//
// Accumulator layout (per thread; warp w of the warpgroup, lane l):
//   d[4c + 2i + j] is row 16w + l/4 + 8i, column 8c + 2(l % 4) + j   (c < 8, i, j < 2).
template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " UCF_WGMMA_D32
      ", %32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : UCF_WGMMA_D32_OPS(d)
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(TRANS_A), "n"(TRANS_B));
}

// d[64 x 64] += A[64 x 16] . B[16 x 64], A in registers: a[0..3] hold, as bf16 pairs
// (lower column in the low half), row l/4 columns 2(l%4)+{0,1}; row l/4 + 8, the same
// columns; row l/4, columns 8 + 2(l%4)+{0,1}; row l/4 + 8, those columns (rows within
// warp w's 16). That is the accumulator layout above: the 16 columns 16t .. 16t + 15 of
// an f32 accumulator become the A operand of one k-step as
//   a[r] = bf16x2(d[8t + 2r], d[8t + 2r + 1]).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " UCF_WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : UCF_WGMMA_D32_OPS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1), "n"(TRANS_B));
}

// d[64 x 16] += A[64 x 16] . B[16 x 16], both in shared memory: the same layout with
// c < 2 (a last key tile of at most 16 keys).
template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n16(float (&d)[8], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, %11, %12;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(TRANS_A), "n"(TRANS_B));
}

#undef UCF_WGMMA_D32
#undef UCF_WGMMA_D32_OPS

// 2^x in one MUFU instruction (relative error about 2^-22; 0 for -inf). The kernels fold
// log2(e) into the scale they already apply to the f32 product, so exp(s) costs one FFMA
// and this.
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The four k-steps' A fragments (16 columns each) of a 64 x 64 f32 accumulator, rounded
// to bf16.
__device__ __forceinline__ void acc_to_a(const float (&d)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[t][r] = pack_bf16(d[8 * t + 2 * r], d[8 * t + 2 * r + 1]);
}

// 16 or 8 if every pointer and every bf16 stride (in bytes) is a multiple of it, else 2:
// the copy width that load_tile may use for all of them.
__host__ inline int copy_bytes(const void* const* ptrs, int n_ptrs, const long long* strides,
                               int n_strides) {
  for (int cb = 16; cb >= 8; cb /= 2) {
    bool ok = true;
    for (int i = 0; i < n_ptrs; ++i) ok = ok && (reinterpret_cast<uintptr_t>(ptrs[i]) % cb == 0);
    for (int i = 0; i < n_strides; ++i) ok = ok && ((strides[i] * 2) % cb == 0);
    if (ok) return cb;
  }
  return 2;
}

}  // namespace sm90
}  // namespace ucf
