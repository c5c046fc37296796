// Hopper (sm_90a) building blocks shared by the bf16 kernels (flash_fwd_sm90.cu,
// flash_bwd_sm90.cu, fused_mlp_sm90.cu), in inline PTX:
//
// - cp.async copies from device memory straight into the 128-byte-swizzled tile layout
//   that a wgmma shared-memory descriptor reads, with zero fill through the src-size
//   operand (rows past the sequence, columns past dh);
// - TMA tensor loads (cp.async.bulk.tensor) into the same layout, counted on mbarriers,
//   with the mbarrier operations of a producer/consumer ring (the forward), and TMA
//   tensor stores from shared memory in bulk async-groups;
// - warpgroup matrix products `wgmma.mma_async ... m64n64k16.f32.bf16.bf16` (and
//   m64n16k16, m64n192k16, m64n256k16), with A from shared memory or from registers and
//   B from shared memory, K-major or MN-major; and the integer product
//   `m64n256k32.s32.s8.s8`, both operands K-major in shared memory (the only layout
//   wgmma takes for 8-bit operands);
// - the fences, commits and waits that order them;
// - thread block clusters: a block's rank, remote mbarrier arrivals and bulk copies into
//   the shared memory of another block of the cluster;
// - on the host, the tensor maps (cuTensorMapEncodeTiled) that the TMA loads read.
//
// Tile layout ("panel"): 64 rows x 64 bf16 (128 bytes a row), 8 KB, 1024-byte aligned.
// Row r's 16-byte chunk c sits at r * 128 + ((c ^ (r % 8)) * 16): the 128-byte swizzle.
// A tile of DH columns is DH / 64 panels one after the other (panel p holds the columns
// 64p .. 64p + 63). The same bytes serve as a K-major operand (rows = M or N, the
// contiguous 64 = K) and as an MN-major one (rows = K, the contiguous 64 = M or N).
// A product that spans at most one panel in its contiguous direction needs only the
// stride between 8-row groups (1024 bytes) in its descriptor (`make_desc`); an
// MN-major B wider than one panel also needs the stride between its panels
// (`make_desc_mn`). An int8 panel is the same 64 x 128 bytes: 128 int8 of K a row, and a
// k32 step of an s8 product is the same 32 bytes as a k16 step of a bf16 one.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

// The box of a 4-d tensor map at coordinates (c0, c1, c2, c3) written from shared memory at
// `src` (laid out as a load of that box would leave it), as a bulk async-group of this
// thread: out-of-range elements are not written. The source must be written, and fenced to
// the async proxy, first.
__device__ __forceinline__ void tma_store_4d(const void* map, uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::
          "l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Until at most N of this thread's bulk groups are pending: READ, have read their shared
// memory source (which may then be rewritten); else, are complete.
template <int N, bool READ>
__device__ __forceinline__ void bulk_wait() {
  if constexpr (READ) {
    asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
  } else {
    asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
  }
}

// Barrier among the `threads` threads (a multiple of 32) that use barrier `id` (1..15;
// 0 is __syncthreads').
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ------------------------------------------------------------------ thread block clusters
//
// A block's shared memory seen from its cluster: `mapa` turns a shared::cta address into
// the shared::cluster address of the same offset in block `rank` of the cluster (every
// block of a kernel has the same layout), which remote mbarrier arrivals and bulk copies
// take.

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// Every thread of every block of the cluster (a block barrier as well).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// An arrival on an mbarrier of a block of the cluster (`cluster_addr` from mapa).
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t cluster_addr) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
                   cluster_addr)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx_cluster(uint32_t cluster_addr,
                                                              uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.release.cluster.shared::cluster.b64 _, [%0], %1;\n" ::"r"(
          cluster_addr),
      "r"(bytes)
      : "memory");
}

// Copy `bytes` (a multiple of 16) of this block's shared memory at `src` to `dst` in a
// block of the cluster, counted in bytes on the mbarrier `bar` of that block (both
// cluster addresses). The source must be written, and fenced to the async proxy, first.
__device__ __forceinline__ void bulk_copy_cluster(uint32_t dst, uint32_t src, uint32_t bytes,
                                                  uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "r"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// ------------------------------------------------------------------ wgmma

// Shared-memory matrix descriptor: start address, both byte offsets 1024 (the 8-row
// group stride), 128-byte swizzle.
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFFu) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// The same for an MN-major operand whose 64-column panels lie `panel_bytes` apart (the
// descriptor's leading byte offset): B of a product more than 64 columns wide.
__device__ __forceinline__ uint64_t make_desc_mn(uint32_t saddr, uint32_t panel_bytes) {
  return (uint64_t)((saddr & 0x3FFFFu) >> 4) | ((uint64_t)((panel_bytes >> 4) & 0x3FFFu) << 16) |
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

template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
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

#define UCF_WGMMA_D128 \
  "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127" \
  "}"
#define UCF_WGMMA_D128_OPS(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
  "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
  "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
  "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), \
  "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), \
  "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
  "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), \
  "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), \
  "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), \
  "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
  "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), \
  "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), \
  "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), \
  "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
  "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), \
  "+f"(d[126]), "+f"(d[127])
#define UCF_WGMMA_D96 \
  "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95" \
  "}"
#define UCF_WGMMA_D96_OPS(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
  "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
  "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
  "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), \
  "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), \
  "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
  "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), \
  "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), \
  "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), \
  "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])

// d[64 x N] += A[64 x 16] . B[16 x N] for N = 256 or 192, both in shared memory: the
// accumulator layout above with c < N / 8. An MN-major B spans N / 64 panels: its
// descriptor carries their stride (`make_desc_mn`).
template <int N, int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_ss_wide(float (&d)[N / 2], uint64_t desc_a,
                                              uint64_t desc_b) {
  static_assert(N == 256 || N == 192, "wgmma_ss_wide takes N = 256 or 192");
  if constexpr (N == 256) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " UCF_WGMMA_D128
        ", %128, %129, p, 1, 1, %131, %132;\n"
        "}\n"
        : UCF_WGMMA_D128_OPS(d)
        : "l"(desc_a), "l"(desc_b), "r"(1), "n"(TRANS_A), "n"(TRANS_B));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 " UCF_WGMMA_D96
        ", %96, %97, p, 1, 1, %99, %100;\n"
        "}\n"
        : UCF_WGMMA_D96_OPS(d)
        : "l"(desc_a), "l"(desc_b), "r"(1), "n"(TRANS_A), "n"(TRANS_B));
  }
}

#define UCF_WGMMA_D128_S32_OPS(d) \
  "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), \
  "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), \
  "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), \
  "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), \
  "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), \
  "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), \
  "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), \
  "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), \
  "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), \
  "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), \
  "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), \
  "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), \
  "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), \
  "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), \
  "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), \
  "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), \
  "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), \
  "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), \
  "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), \
  "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), \
  "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), "+r"(d[120]), "+r"(d[121]), \
  "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), \
  "+r"(d[127])

// d[64 x 256] += A[64 x 32] . B[32 x 256] in int8 with int32 sums (exact: no saturation
// below 2^31), A and B in shared memory, both K-major (8-bit operands have no transposed
// form): the accumulator layout above with c < 32.
__device__ __forceinline__ void wgmma_ss_wide_s8(int (&d)[128], uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " UCF_WGMMA_D128
      ", %128, %129, p;\n"
      "}\n"
      : UCF_WGMMA_D128_S32_OPS(d)
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

#undef UCF_WGMMA_D128
#undef UCF_WGMMA_D128_OPS
#undef UCF_WGMMA_D128_S32_OPS
#undef UCF_WGMMA_D96
#undef UCF_WGMMA_D96_OPS
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

// ------------------------------------------------------------------ host: tensor maps

// cuTensorMapEncodeTiled, reached through the runtime's driver entry point, so that a
// library links against no more than the CUDA runtime.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f,
                                                             12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// Returned for a tensor map that cannot be encoded: ENCODE_FAILED + the driver's CUresult
// (ENCODE_FAILED alone: no cuTensorMapEncodeTiled).
constexpr int ENCODE_FAILED = 10000;

// A 4-d bf16 map of dims (d0 columns, d1 rows, d2, d3) with byte strides (s1, s2, s3)
// and a box of 64 columns by `box_rows` rows, swizzled for the panel layout; zeros for
// elements out of range. g = {d0, d1, d2, d3, s1, s2, s3}. `type` and `box_cols` take
// another element type: a box row must be 128 bytes (64 bf16, 128 int8).
inline int encode(CUtensorMap* map, const void* ptr, const long long (&g)[7], int box_rows,
                  CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  int box_cols = 64) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return ENCODE_FAILED;
  const cuuint64_t dims[4] = {(cuuint64_t)g[0], (cuuint64_t)g[1], (cuuint64_t)g[2],
                              (cuuint64_t)g[3]};
  const cuuint64_t strides[3] = {(cuuint64_t)g[4], (cuuint64_t)g[5], (cuuint64_t)g[6]};
  const cuuint32_t box[4] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, type, 4, const_cast<void*>(ptr), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_FAILED + (int)r;
}

// A row-major bf16 matrix [rows, cols] (row stride `row_elems`) as such a map (dims 2 and
// 3 of size 1: load with tma_load_4d(..., column, row, 0, 0)), read in boxes of 64
// columns by `box_rows` rows (TMA takes rows of a multiple of 16 bytes).
inline int encode_2d(CUtensorMap* map, const void* ptr, long long rows, long long cols,
                     long long row_elems, int box_rows) {
  const long long g[7] = {cols, rows, 1, 1, 2 * row_elems, 2 * row_elems * rows,
                          2 * row_elems * rows};
  return encode(map, ptr, g, box_rows);
}

// A row-major int8 matrix [rows, cols] (row stride `row_bytes`, a multiple of 16) as such a
// map, read in boxes of 128 columns (bytes) by `box_rows` rows: the panel layout again.
inline int encode_2d_s8(CUtensorMap* map, const void* ptr, long long rows, long long cols,
                        long long row_bytes, int box_rows) {
  const long long g[7] = {cols, rows, 1, 1, row_bytes, row_bytes * rows, row_bytes * rows};
  return encode(map, ptr, g, box_rows, CU_TENSOR_MAP_DATA_TYPE_UINT8, 128);
}

}  // namespace sm90
}  // namespace ucf
