// Flash-attention forward in bf16 on Hopper's tensor cores (sm_90a: wgmma, cp.async).
//
// Replaces the Pallas TPU kernel `_fwd_kernel` (ucf_vit_tpu/ops/flash_attention.py:68,
// launched by `_flash_fwd_len` :543) for bf16 inputs; csrc/flash_fwd_tf32.cu takes f32.
// It computes the same function:
//   s = (q . k^T) * scale in f32 (scale applied to the f32 product, never folded into
//   the bf16 q), keys >= nkv masked with -0.7 * FLT_MAX (not -inf), online softmax with
//   the running max m, normaliser l and output accumulator in f32, p rounded to bf16 for
//   p . v (as `p.astype(v.dtype)`, :140), o = acc / l (l == 0 guarded) in bf16,
//   lse = m + log(max(l, 1e-37)) as f32 [B*H, Nq].
// With dropout (a template flag) the probabilities are dropped after the l update, by
// the counter hash of attn_dropout.cuh at global (bh, row0 + row, col0 + col).
//
// Bound on the H100 at ViT-L/16's training shape [B*H = 128, N = 257, dh = 64]: the two
// products are 2.16 GFLOP (2.2 us at 989 TFLOP/s) and q, k, v, o in bf16 with lse in f32
// are 16.97 MB (5.1 us at 3.35 TB/s): bound by bytes. A block reads its q tile once and
// the whole of k and v of its head, from L2 after the first of the head's blocks.
//
// Design: one warpgroup (128 threads) per (batch*head, 64-row query tile). The q tile and
// a double-buffered ring of 64-key k and v tiles stay bf16 in shared memory in the
// 128-byte-swizzled layout of sm90.cuh (8 KB a tile at dh 64, 40 KB a block), loaded by
// cp.async straight to the swizzled addresses, so tile j + 1 is in flight while tile j
// is multiplied. s = q . k^T is DH / 16 wgmma m64n64k16 with both operands in shared
// memory (K-major). The softmax runs on the f32 accumulator in its fragment layout: each
// thread holds two rows, 16 columns each, and the row max and sum finish with shuffles
// among the four lanes that share a row. Scores are kept in log2 units (scale * log2(e)
// folded into the one multiply of the f32 product), so each exponential is one
// ex2.approx. Only 96 registers a thread: five blocks an SM, so that ViT-L's 640 blocks
// run in one round, latency hidden by the other blocks. p becomes the register A operand
// of o += p . v (the accumulator layout is the A fragment layout: no shuffle) with v from
// shared memory as an MN-major B. A last key tile of at most 16 keys (a ViT's class token
// leaves one at N = 197 and 257) takes m64n16k16 and one k-step of p . v. Keys past nkv
// read zeros from cp.async's zero fill, so stale shared memory never meets a p of 0. The
// head dim pads to DH = 64 or 128 (zeros past dh); rows are copied 16 bytes at a time
// where the pointers and strides allow it (the packed qkv views at dh 64, 96 and 128),
// else 8 (dh 36) or 2. Inputs are read through (batch, head, row) strides with the last
// dim contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstdint>

#include "attn_dropout.cuh"
#include "sm90.cuh"

namespace {

using namespace ucf::sm90;

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 128;
constexpr float MASK_VALUE = -0.7f * FLT_MAX;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* lse;
  int heads, nq, nkv, dh;
  long long q_sb, q_sh, q_sn;
  long long k_sb, k_sh, k_sn;
  long long v_sb, v_sh, v_sn;
  long long o_sb, o_sh, o_sn;
  float scale;
  uint32_t seed, threshold;
  int row0, col0;
  float inv_keep;
  int copy_bytes;  // cp.async width for q, k, v (sm90.cuh: copy_bytes)
  int pair_store;  // o may be stored as bf16 pairs
};

template <int DH>
constexpr size_t smem_bytes() {
  return (size_t)5 * (DH / 64) * PANEL_BYTES + 1024;  // q, k x 2, v x 2; alignment
}

// One key tile of the online softmax, 8 * NC keys wide (NC = 8: 64 keys; NC = 2: a last
// tile of at most 16): s = q . k^T, m, l and the rescaled accumulator, then o += p . v.
template <int NC, int DH, bool DROPOUT>
__device__ __forceinline__ void attend_tile(const Params& p, uint32_t sQ, uint32_t sK,
                                            uint32_t sV, int q0, int k0, int rq, int cq,
                                            uint32_t slice_key, float scale_log2,
                                            float (&m_run)[2], float (&l_run)[2],
                                            float (&acc)[DH / 64][32]) {
  constexpr int NP = DH / 64;
  // s = q . k^T
  float s[4 * NC];
#pragma unroll
  for (int x = 0; x < 4 * NC; ++x) s[x] = 0.f;
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const uint32_t off = (kk >> 2) * PANEL_BYTES + (kk & 3) * 32;
    if constexpr (NC == 8) {
      wgmma_ss<0, 0>(s, make_desc(sQ + off), make_desc(sK + off));
    } else {
      wgmma_ss_n16<0, 0>(s, make_desc(sQ + off), make_desc(sK + off));
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);

  // online softmax over this thread's rows rq + 8i, columns 8c + cq + jj; only the
  // last key tile can hold keys past nkv
  const bool ragged = k0 + 8 * NC > p.nkv;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        float& x = s[4 * c + 2 * i + jj];
        x *= scale_log2;
        if (ragged && k0 + 8 * c + cq + jj >= p.nkv) x = MASK_VALUE;
        mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_next = fmaxf(m_run[i], mx);
    const float alpha = exp2_approx(m_run[i] - m_next);
    float rs = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        float& x = s[4 * c + 2 * i + jj];
        x = exp2_approx(x - m_next);
        rs += x;
      }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    l_run[i] = alpha * l_run[i] + rs;
    m_run[i] = m_next;
#pragma unroll
    for (int n = 0; n < NP; ++n)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        acc[n][4 * c + 2 * i] *= alpha;
        acc[n][4 * c + 2 * i + 1] *= alpha;
      }
    if constexpr (DROPOUT) {
      const int row = p.row0 + q0 + rq + 8 * i;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          float& x = s[4 * c + 2 * i + jj];
          const bool keep =
              ucf::dropout_keep(slice_key, row, p.col0 + k0 + 8 * c + cq + jj, p.threshold);
          x = keep ? x * p.inv_keep : 0.f;
        }
    }
  }

  // o += p . v: p (bf16) from registers, 16 keys a k-step; v from shared memory (MN-major)
  uint32_t a[NC / 2][4];
#pragma unroll
  for (int t = 0; t < NC / 2; ++t)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[t][r] = pack_bf16(s[8 * t + 2 * r], s[8 * t + 2 * r + 1]);
#pragma unroll
  for (int n = 0; n < NP; ++n) fence_regs(acc[n]);
  wgmma_fence();
#pragma unroll
  for (int t = 0; t < NC / 2; ++t)
#pragma unroll
    for (int n = 0; n < NP; ++n)
      wgmma_rs<1>(acc[n], a[t], make_desc(sV + n * PANEL_BYTES + t * 16 * ROW_BYTES));
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int n = 0; n < NP; ++n) fence_regs(acc[n]);
#pragma unroll
  for (int t = 0; t < NC / 2; ++t) fence_regs(a[t]);
}

// At DH = 64, five blocks an SM (at most 102 registers a thread; 96 used, no spills):
// ViT-L's 640 blocks all fit on the card's 660 slots at once. With dropout, three.
template <int DH, bool DROPOUT>
__global__ void __launch_bounds__(THREADS, DH == 64 ? (DROPOUT ? 3 : 5) : 1)
    flash_fwd_sm90_kernel(const Params p) {
  constexpr int NP = DH / 64;  // panels per tile
  constexpr uint32_t TILE = NP * PANEL_BYTES;
  extern __shared__ uint8_t smem[];
  const uint32_t sQ = aligned_smem_base(smem);
  const uint32_t sK0 = sQ + TILE, sV0 = sQ + 3 * TILE;  // stage s at + s * TILE

  const int bh = blockIdx.x;
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  const int q0 = blockIdx.y * BQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rq = 16 * warp + (lane >> 2);  // this thread's rows: rq and rq + 8
  const int cq = 2 * (lane & 3);           // and columns 8c + cq + {0, 1}

  const __nv_bfloat16* qg = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vg = p.v + b * p.v_sb + h * p.v_sh;
  const uint32_t slice_key = ucf::dropout_slice_key(p.seed, (uint32_t)bh);

  load_tile<NP>(sQ, qg, p.q_sn, q0, p.nq, p.dh, p.copy_bytes);
  load_tile<NP>(sK0, kg, p.k_sn, 0, p.nkv, p.dh, p.copy_bytes);
  load_tile<NP>(sV0, vg, p.v_sn, 0, p.nkv, p.dh, p.copy_bytes);
  cp_async_commit();

  // scores, the running max m and the exponents are kept in log2 units: s * scale *
  // log2(e), so that exp(s - m) is one exp2
  const float scale_log2 = p.scale * LOG2E;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  float acc[NP][32];
#pragma unroll
  for (int n = 0; n < NP; ++n)
#pragma unroll
    for (int x = 0; x < 32; ++x) acc[n][x] = 0.f;

  const int n_tiles = (p.nkv + BK - 1) / BK;
  for (int j = 0; j < n_tiles; ++j) {
    const uint32_t sK = sK0 + (j & 1) * TILE, sV = sV0 + (j & 1) * TILE;
    const int k0 = j * BK;
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();  // tile j has landed; every thread is done with tile j - 1's stage
    if (j + 1 < n_tiles) {
      const uint32_t nxt = ((j + 1) & 1) * TILE;
      load_tile<NP>(sK0 + nxt, kg, p.k_sn, k0 + BK, p.nkv, p.dh, p.copy_bytes);
      load_tile<NP>(sV0 + nxt, vg, p.v_sn, k0 + BK, p.nkv, p.dh, p.copy_bytes);
      cp_async_commit();
    }
    // A ViT's class token leaves a last tile of 1 (N = 257) or 5 (N = 197) keys: up to 16
    // take the 16-key path, a quarter of the work
    if (p.nkv - k0 <= 16) {
      attend_tile<2, DH, DROPOUT>(p, sQ, sK, sV, q0, k0, rq, cq, slice_key, scale_log2, m_run,
                                  l_run, acc);
    } else {
      attend_tile<8, DH, DROPOUT>(p, sQ, sK, sV, q0, k0, rq, cq, slice_key, scale_log2, m_run,
                                  l_run, acc);
    }
  }

  __nv_bfloat16* og = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + rq + 8 * i;
    if (row >= p.nq) continue;
    const float l_inv = (l_run[i] == 0.f) ? 1.f : 1.f / l_run[i];
    __nv_bfloat16* orow = og + (long long)row * p.o_sn;
#pragma unroll
    for (int n = 0; n < NP; ++n)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = 64 * n + 8 * c + cq;
        const float v0 = acc[n][4 * c + 2 * i] * l_inv;
        const float v1 = acc[n][4 * c + 2 * i + 1] * l_inv;
        if (p.pair_store && col + 1 < p.dh) {
          *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (col < p.dh) orow[col] = __float2bfloat16(v0);
          if (col + 1 < p.dh) orow[col + 1] = __float2bfloat16(v1);
        }
      }
    if ((lane & 3) == 0)
      p.lse[(long long)bh * p.nq + row] = m_run[i] * LN2 + logf(fmaxf(l_run[i], 1e-37f));
  }
}

template <int DH, bool DROPOUT>
cudaError_t launch(const Params& p, int bh, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_sm90_kernel<DH, DROPOUT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (p.nq + BQ - 1) / BQ);
  flash_fwd_sm90_kernel<DH, DROPOUT><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool DROPOUT>
cudaError_t dispatch_dh(const Params& p, int bh, cudaStream_t stream) {
  if (p.dh <= 64) return launch<64, DROPOUT>(p, bh, stream);
  if (p.dh <= 128) return launch<128, DROPOUT>(p, bh, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// bf16 q, k, v, o; lse f32 [B*H, Nq]. Strides are in elements, the last dim contiguous.
// dropout: 0 or 1; with 1 the seed, threshold, (row0, col0) offset and inv_keep describe
// the mask. Returns a cudaError_t.
extern "C" int ucf_flash_fwd_sm90(const void* q, const void* k, const void* v, void* o,
                                  void* lse, int batch, int heads, int nq, int nkv, int dh,
                                  long long q_sb, long long q_sh, long long q_sn,
                                  long long k_sb, long long k_sh, long long k_sn,
                                  long long v_sb, long long v_sh, long long v_sn,
                                  long long o_sb, long long o_sh, long long o_sn, float scale,
                                  int dropout, unsigned int seed, unsigned int threshold,
                                  int row0, int col0, float inv_keep, void* stream) {
  if (batch <= 0 || heads <= 0 || nq <= 0 || nkv <= 0 || dh <= 0) return cudaErrorInvalidValue;
  if ((nq + BQ - 1) / BQ > 65535) return cudaErrorInvalidValue;
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.heads = heads;
  p.nq = nq;
  p.nkv = nkv;
  p.dh = dh;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_sn = q_sn;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_sn = k_sn;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_sn = v_sn;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_sn = o_sn;
  p.scale = scale;
  p.seed = seed;
  p.threshold = threshold;
  p.row0 = row0;
  p.col0 = col0;
  p.inv_keep = inv_keep;
  const void* in_ptrs[3] = {q, k, v};
  const long long in_strides[9] = {q_sb, q_sh, q_sn, k_sb, k_sh, k_sn, v_sb, v_sh, v_sn};
  p.copy_bytes = ucf::sm90::copy_bytes(in_ptrs, 3, in_strides, 9);
  p.pair_store = dh % 2 == 0 && (o_sb | o_sh | o_sn) % 2 == 0 &&
                 reinterpret_cast<uintptr_t>(o) % 4 == 0;
  const int bh = batch * heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dropout ? dispatch_dh<true>(p, bh, s) : dispatch_dh<false>(p, bh, s);
}
