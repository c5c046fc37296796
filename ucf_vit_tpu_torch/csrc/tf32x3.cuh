// f32-accurate matrix products on Hopper's tensor cores by the 3xTF32 split, shared by
// the f32 flash-attention kernels (flash_fwd_tf32.cu, flash_bwd_tf32.cu), in inline PTX.
//
// The tensor cores' f32 path is TF32 (a 10-bit mantissa, about three decimal digits).
// Each f32 operand is split as x = hi + lo. hi is x rounded to TF32, to nearest with ties
// away from zero (the rounding of cvt.rna.tf32.f32, by an add and a mask: on sm_90a the
// instruction itself compiles to those plus a compare against infinity and a predicated
// add). lo = x - hi is exact in f32, and goes to the tensor cores as it is: they read a TF32
// operand's top 19 bits, so lo is truncated to TF32 there. That is the split of CUTLASS's
// fast 3xTF32 GEMMs (big half rounded, small half truncated); rounding lo as well made both
// kernels slower at the training shape for no change the f32 tolerances can see (PERF.md,
// Findings). A product is then lo.hi + hi.lo + hi.hi with f32 accumulation, the
// small terms first as CUTLASS orders them; the truncated lo and the dropped lo.lo term
// are each within 2^-21 of the product. The card's dense TF32 rate is 495 TFLOP/s, so an
// f32-accurate product runs at up to 165 TFLOP/s, against 67 on the CUDA cores in f32 FMA.
//
// The instruction is mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 (operands in
// registers; wgmma takes TF32 only K-major from shared memory). Fragments, for lane
// (g = lane / 4, t = lane % 4):
//   A (16 x 8, row):  a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8, col):   b0 (k = t, n = g), b1 (k = t + 4, n = g)
//   C (16 x 8):       c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// A product's C fragment is the next product's A fragment without a shuffle: the sum over
// k does not care about order, so A's k-slots t and t + 4 take C's columns 2t and 2t + 1
// (c_to_a), and B's rows are read in the same permuted order (B row 2t for slot t, 2t + 1
// for slot t + 4: perm_k). B comes from shared memory by 32-bit loads, so the permutation
// costs nothing.
//
// Also the f32 tile loader: rows of a strided slice into shared memory by cp.async (16-byte
// copies where every pointer and stride allows, else 4-byte ones), zero fill past the
// valid rows and past dh, with the row stride DH + 4 floats. With that stride the A and B
// fragment loads above (row g, column t; or row 2t, column g) hit 32 different banks.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "sm90.cuh"

namespace ucf {
namespace tf32x3 {

using sm90::cp_async;
using sm90::cp_async_commit;
using sm90::cp_async_wait_all;
using sm90::exp2_approx;
using sm90::LN2;
using sm90::LOG2E;
using sm90::smem_u32;

// ------------------------------------------------------------------ the split

// x rounded to TF32 (10 mantissa bits), ties away from zero, as the bits of an f32: half
// a TF32 ulp added to the magnitude, the 13 low bits cleared. The same bits as
// cvt.rna.tf32.f32 for every finite x.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));  // truncated to TF32 by the tensor cores
}

struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ FragA split_a(const float (&x)[4]) {
  FragA a;
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(x[i], a.hi[i], a.lo[i]);
  return a;
}

__device__ __forceinline__ FragB split_b(float x0, float x1) {
  FragB b;
  split_tf32(x0, b.hi[0], b.lo[0]);
  split_tf32(x1, b.hi[1], b.lo[1]);
  return b;
}

// ------------------------------------------------------------------ the product

// d += a . b, one TF32 pass.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a . b to f32 accuracy: lo.hi, hi.lo, then hi.hi.
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// ------------------------------------------------------------------ fragment indices

__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }

// Row and column (m, k) of A's element i; (k, n) of B's element i; (m, n) of C's element i.
__device__ __forceinline__ int a_row(int i) { return lane_g() + 8 * (i & 1); }
__device__ __forceinline__ int a_col(int i) { return lane_t() + 4 * (i >> 1); }
__device__ __forceinline__ int b_k(int i) { return lane_t() + 4 * i; }
__device__ __forceinline__ int c_row(int i) { return lane_g() + 8 * (i >> 1); }
__device__ __forceinline__ int c_col(int i) { return 2 * lane_t() + (i & 1); }

// The B row (k) of element i for an A fragment made by c_to_a.
__device__ __forceinline__ int perm_k(int i) { return 2 * lane_t() + i; }

// A C fragment as the A fragment of a product over its columns (k-slots t, t + 4 take
// columns 2t, 2t + 1).
__device__ __forceinline__ void c_to_a(const float (&c)[4], float (&a)[4]) {
  a[0] = c[0];
  a[1] = c[2];
  a[2] = c[1];
  a[3] = c[3];
}

// ------------------------------------------------------------------ warp products

// acc (16 x 8 NT) += A . B^T for A the 16 rows at `sa` and B the 8 NT rows at `sb`, both
// f32 in shared memory with DH columns and row stride DH + 4. Without FULL, the 8-row tiles
// of B from `nvalid` on are skipped; with it there is no branch between the NT
// independent product chains, so the scheduler can interleave them (a branch per tile
// leaves each chain of three dependent HMMAs to run alone).
template <int DH, int NT, bool FULL>
__device__ __forceinline__ void mma3_abt(float (&acc)[NT][4], const float* sa, const float* sb,
                                         int nvalid) {
  constexpr int S = DH + 4;
#pragma unroll
  for (int kk = 0; kk < DH / 8; ++kk) {
    float af[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) af[i] = sa[a_row(i) * S + 8 * kk + a_col(i)];
    const FragA a = split_a(af);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (FULL || 8 * nt < nvalid) {
        const float* br = sb + (8 * nt + lane_g()) * S + 8 * kk;
        mma3(acc[nt], a, split_b(br[b_k(0)], br[b_k(1)]));
      }
    }
  }
}

// acc (16 x DH) += C . B for C a 16 x 8 NT product in registers (C fragments, each element
// passed through op(j, i, c) first) and B the 8 NT rows at `sb` (DH columns, row stride
// DH + 4), read through the permuted index. The 8-row k-steps from `nvalid` on are skipped:
// the DH / 8 chains inside a k-step need no branch between them.
template <int DH, int NT, typename Op>
__device__ __forceinline__ void mma3_cb(float (&acc)[DH / 8][4], const float (&c)[NT][4],
                                        const float* sb, int nvalid, Op op) {
  constexpr int S = DH + 4;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (8 * j < nvalid) {
      float cj[4], af[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) cj[i] = op(j, i, c[j][i]);
      c_to_a(cj, af);
      const FragA a = split_a(af);
      const float* b0 = sb + (8 * j + perm_k(0)) * S + lane_g();
      const float* b1 = sb + (8 * j + perm_k(1)) * S + lane_g();
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) mma3(acc[n], a, split_b(b0[8 * n], b1[8 * n]));
    }
  }
}

// acc += C . B as mma3_cb, the product summed apart from zero and then added to acc by f32
// adds. The tensor cores' f32 accumulation does not round to nearest: carried across
// hundreds of tiles in their accumulator, a sum drifts one way (dk and dv 3e-4 off after
// 32768 query rows); a tile's own sum is short, and the f32 adds round to nearest.
template <int DH, int NT, typename Op>
__device__ __forceinline__ void mma3_cb_add(float (&acc)[DH / 8][4], const float (&c)[NT][4],
                                            const float* sb, int nvalid, Op op) {
  float part[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) part[n][i] = 0.f;
  mma3_cb<DH, NT>(part, c, sb, nvalid, op);
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] += part[n][i];
}

// ------------------------------------------------------------------ tile loads

// 16 if every pointer and every f32 stride (in bytes) is a multiple of 16, else 4: the
// copy width that load_tile may use for all of them.
__host__ inline int copy_bytes(const void* const* ptrs, int n_ptrs, const long long* strides,
                               int n_strides) {
  bool ok = true;
  for (int i = 0; i < n_ptrs; ++i) ok = ok && (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 == 0);
  for (int i = 0; i < n_strides; ++i) ok = ok && ((strides[i] * 4) % 16 == 0);
  return ok ? 16 : 4;
}

template <int CB, int DH>
__device__ __forceinline__ void load_tile_cb(float* dst, const float* src, long long sn,
                                             int row0, int nrows, int dh) {
  constexpr int EC = CB / 4;      // floats per copy
  constexpr int CPR = DH / EC;    // copies per row
  constexpr int STRIDE = DH + 4;  // floats per shared row
  const uint32_t base = smem_u32(dst);
  for (int idx = sm90::opaque_tid(); idx < 64 * CPR; idx += 128) {
    const int r = idx / CPR;
    const int e = (idx - r * CPR) * EC;
    const int row = row0 + r;
    int valid = (row < nrows) ? dh - e : 0;
    valid = valid < 0 ? 0 : (valid > EC ? EC : valid);
    const float* s = valid > 0 ? src + (long long)row * sn + e : src;
    cp_async<CB>(base + 4u * (uint32_t)(r * STRIDE + e), s, 4 * valid);
  }
}

// Rows [row0, row0 + 64) x columns [0, DH) of a strided f32 slice into a shared tile of
// row stride DH + 4, by the 128 threads of the block, cb bytes per copy. Zeros past
// `nrows` and past `dh`. Ends with no commit: the caller groups its copies.
template <int DH>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long sn, int row0,
                                          int nrows, int dh, int cb) {
  if (cb == 16) {
    load_tile_cb<16, DH>(dst, src, sn, row0, nrows, dh);
  } else {
    load_tile_cb<4, DH>(dst, src, sn, row0, nrows, dh);
  }
}

// 64 consecutive floats of `src` from index i0 (zeros past n) into `dst`, by threads
// [t0, t0 + 64) of the block.
__device__ __forceinline__ void load_row_stats(float* dst, const float* src, int i0, int n,
                                               int t0) {
  const int i = (int)threadIdx.x - t0;
  if (i >= 0 && i < 64) {
    const bool ok = i0 + i < n;
    cp_async<4>(smem_u32(dst + i), ok ? src + i0 + i : src, ok ? 4 : 0);
  }
}

}  // namespace tf32x3
}  // namespace ucf
