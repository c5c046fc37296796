// Flash-attention forward in bf16 on Hopper (sm_90a): TMA loads into an mbarrier ring fed
// by a producer warp, wgmma products with the next key tile's product in flight during
// this tile's softmax, and a persistent grid.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` (ucf_vit_tpu/ops/flash_attention.py:68,
// launched by `_flash_fwd_len` :543) for bf16 inputs; csrc/flash_fwd_tf32.cu takes f32.
// It computes the same function:
//   s = (q . k^T) * scale in f32 (scale applied to the f32 product, never folded into
//   the bf16 q), keys >= nkv masked with -0.7 * FLT_MAX (not -inf), online softmax with
//   the running max m, normaliser l and output accumulator in f32, p rounded to bf16 for
//   p . v (as `p.astype(v.dtype)`, :140), o = acc / l (l == 0 guarded) in bf16,
//   lse = m + log(max(l, 1e-37)) as f32 [B*H, Nq].
// With o_f32 the kernel stores o = acc / l in f32, unrounded: the ring attention
// (ops/ring_attention.py) merges the chunks' outputs in f32, as the JAX ring keeps its
// accumulator.
// With dropout (a template flag) the probabilities are dropped after the l update, by
// the counter hash of attn_dropout.cuh at global (bh, row0 + row, col0 + col).
//
// Bound on the H100: at ViT-L/16's training shape [B*H = 128, N = 257, dh = 64] the two
// products are 2.16 GFLOP (2.2 us at 989 TFLOP/s) and q, k, v, o in bf16 with lse in f32
// are 16.97 MB (5.1 us at 3.35 TB/s): bound by bytes. At mae_long's encoder
// [B*H = 24, N = 8192, dh = 64] the products are 412 GFLOP (0.417 ms): bound by
// operations.
//
// Design. A block is one consumer warpgroup (warps 0-3) and one producer warp (warp 4).
// The grid is persistent: at most as many blocks as fit on the card at once, each
// walking the work items (batch * head, 64-row query tile) item = blockIdx.x,
// + gridDim.x, ... in the same order in both roles.
// - The producer's first lane issues every load by TMA (cp.async.bulk.tensor) from
//   tensor maps encoded on the host (ucf_flash_fwd_sm90 below): the q tile into one of
//   two q buffers, and each 64-key k and v tile into a ring of S stages. A full/empty
//   mbarrier pair guards each buffer: the producer announces the bytes on `full`
//   (expect_tx) and TMA completes them; each consumer warp arrives on `empty` once its
//   products have read the buffer. So the next item's q and first k and v tiles load
//   while the consumers finish the current item, and no thread of the key loop waits at
//   a block-wide barrier. The tiles land in the 128-byte-swizzled panel layout of
//   sm90.cuh (CU_TENSOR_MAP_SWIZZLE_128B, a box of 64 columns by 64 rows): the wgmma
//   descriptors read them as the cp.async tiles were read before. Rows past N and
//   columns past dh arrive as TMA's zero fill.
// - The consumers run s = q . k^T by DH / 16 wgmma m64n64k16 from shared memory, the
//   online softmax on the f32 accumulator in its fragment layout (two rows a thread,
//   finished by shuffles among the four lanes of a row; scores in log2 units so that
//   each exponential is one ex2.approx), and o += p . v with p (bf16) from registers as
//   the A operand. Key tile j + 1's q . k^T and tile j's p . v are issued together; the
//   softmax of tile j + 1 runs while p . v is on the tensor cores (wgmma_wait<1>), and
//   the accumulator is rescaled once p . v has landed. A last key tile of at most 16
//   keys (a ViT's class token leaves one at N = 197 and 257) takes m64n16k16 and one
//   k-step of p . v.
// - Layouts: the tensor maps describe the strided [B, H, N, dh] views as they are
//   (the packed qkv views need no copy). Where the head stride is no multiple of 16
//   bytes (dh 36 packed), the heads merge into dim 0 of the map. TMA takes a box only
//   from a 16-byte aligned column, so head h's box starts at the multiple of 8 at or
//   below column h * stride, and the head sits `off` (< 8) columns into it: the
//   consumers zero q's and k's other columns (the neighbours' data) before the products
//   read them, q and k sharing their offset, and store o from acc's columns
//   [off_v, off_v + dh); v's other columns reach only acc columns that are never
//   stored. ops/flash_attention.py (`fwd_layout`) decides the maps from the strides and
//   pointers before the launch; layouts that TMA cannot address reach this kernel as
//   padded copies.
// - At DH = 64 three blocks an SM (at most 136 registers a thread; with dropout two), at
//   DH = 128 two; S = 3 stages at DH = 64 (66 KB of shared memory a block) and 2 at
//   DH = 128 (97 KB). The head dim pads to DH = 64 or 128 (zeros past dh).

#include <cuda.h>
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
constexpr int CONSUMER_WARPS = 4;  // one warpgroup
constexpr int THREADS = 32 * CONSUMER_WARPS + 32;  // and the producer warp
constexpr float MASK_VALUE = -0.7f * FLT_MAX;

struct Params {
  void* o;  // bf16, or f32 with o_f32
  float* lse;
  int heads, nq, nkv, dh;
  int n_qt;     // query tiles per (batch, head)
  int n_items;  // batch * heads * n_qt
  int q_hcol, k_hcol, v_hcol;  // heads merged into dim 0: head h starts at column h * hcol
  long long o_sb, o_sh, o_sn;
  float scale;
  uint32_t seed, threshold;
  int row0, col0;
  float inv_keep;
  int merged;  // q or k has its heads merged into dim 0 (then both at the same offset)
  int pair_store;  // o may be stored as bf16 pairs
  int o_f32;       // o is f32
};

template <int DH>
__host__ __device__ constexpr int stages() {
  return DH == 64 ? 3 : 2;
}

template <int DH>
__host__ __device__ constexpr uint32_t tile_bytes() {
  return (DH / 64) * PANEL_BYTES;
}

// q buffers 0 and 1, k stages, v stages, then the barriers: q full x 2, q empty x 2,
// kv full x S, kv empty x S
template <int DH>
__host__ __device__ constexpr uint32_t bar_offset() {
  return (2 + 2 * stages<DH>()) * tile_bytes<DH>();
}

template <int DH>
constexpr size_t smem_bytes() {
  return bar_offset<DH>() + 8 * (4 + 2 * stages<DH>()) + 1024;  // + alignment
}

// The online-softmax state of this thread's two query rows: running max (log2 units),
// normaliser, and the output accumulator of DH columns.
template <int DH>
struct RowState {
  float m[2];
  float l[2];
  float acc[DH / 64][32];
};

// Zero the columns of a one-panel tile outside [lo, hi), by the 128 consumer threads (two
// a row); then make the writes visible to the tensor cores' reads.
__device__ __forceinline__ void zero_columns(uint32_t tile, int lo, int hi, int tid) {
  const int r = tid >> 1;
  const unsigned short zero = 0;
  for (int e = tid & 1; e < lo; e += 2)
    asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(tile + swizzle_offset(r, e)), "h"(zero)
                 : "memory");
  for (int e = hi + ((hi ^ tid) & 1); e < 64; e += 2)
    asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(tile + swizzle_offset(r, e)), "h"(zero)
                 : "memory");
  fence_proxy_async();
  named_bar_sync(1, 32 * CONSUMER_WARPS);
}

// s = q . k^T for a key tile 8 * NC keys wide, issued as one wgmma group (not waited for).
template <int NC, int DH>
__device__ __forceinline__ void issue_qk(float (&s)[4 * NC], uint32_t sQ, uint32_t sK) {
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
}

// acc += p . v over KSTEPS k-steps of 16 keys, p from registers, v from shared memory
// (MN-major), issued as one wgmma group.
template <int KSTEPS, int DH>
__device__ __forceinline__ void issue_pv(RowState<DH>& st, const uint32_t (&a)[4][4],
                                         uint32_t sV) {
#pragma unroll
  for (int t = 0; t < KSTEPS; ++t)
#pragma unroll
    for (int n = 0; n < DH / 64; ++n)
      wgmma_rs<1>(st.acc[n], a[t], make_desc(sV + n * PANEL_BYTES + t * 16 * ROW_BYTES));
  wgmma_commit();
}

template <int DH>
__device__ __forceinline__ void fence_state(RowState<DH>& st, uint32_t (&a)[4][4]) {
#pragma unroll
  for (int n = 0; n < DH / 64; ++n) fence_regs(st.acc[n]);
#pragma unroll
  for (int t = 0; t < 4; ++t) fence_regs(a[t]);
}

// The online softmax of one key tile's scores (8 * NC keys from k0) for this thread's
// rows: masks keys past nkv, updates m and l, leaves p = exp(s - m) in s (dropped, with
// dropout) and the accumulator's rescale factor in alpha.
template <int NC, bool DROPOUT>
__device__ __forceinline__ void softmax_tile(const Params& p, float (&s)[4 * NC], int k0,
                                             int row, int cq, uint32_t slice_key,
                                             float scale_log2, float (&m)[2], float (&l)[2],
                                             float (&alpha)[2]) {
  const bool ragged = k0 + 8 * NC > p.nkv;  // only the last key tile can be
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
    const float m_next = fmaxf(m[i], mx);
    alpha[i] = exp2_approx(m[i] - m_next);
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
    l[i] = alpha[i] * l[i] + rs;
    m[i] = m_next;
    if constexpr (DROPOUT) {
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          float& x = s[4 * c + 2 * i + jj];
          const bool keep = ucf::dropout_keep(slice_key, p.row0 + row + 8 * i,
                                              p.col0 + k0 + 8 * c + cq + jj, p.threshold);
          x = keep ? x * p.inv_keep : 0.f;
        }
    }
  }
}

template <int DH>
__device__ __forceinline__ void rescale(RowState<DH>& st, const float (&alpha)[2]) {
#pragma unroll
  for (int n = 0; n < DH / 64; ++n)
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        st.acc[n][4 * c + 2 * i] *= alpha[i];
        st.acc[n][4 * c + 2 * i + 1] *= alpha[i];
      }
}

// p (f32, in s) as the bf16 A fragments of NC / 2 k-steps
template <int NC>
__device__ __forceinline__ void pack_p(const float (&s)[4 * NC], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int t = 0; t < NC / 2; ++t)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[t][r] = pack_bf16(s[8 * t + 2 * r], s[8 * t + 2 * r + 1]);
}

// What a consumer thread needs to walk one work item's key tiles.
struct Walk {
  uint32_t sQ, sK0, sV0, kv_full, kv_empty, q_empty;
  int qrow;  // this thread's first query row, q0 + rq
  int qk_off;  // merged heads: the head's first column in the q and k boxes
  int cq;
  int lane;
  int tid;
  uint32_t slice_key;
  float scale_log2;
};

template <int S>
__device__ __forceinline__ void advance(int& stage, uint32_t& phase) {
  if (++stage == S) {
    stage = 0;
    phase ^= 1;
  }
}

// Key tile 0: wait for it, s = q . k^T, softmax; p goes to `a`.
template <int NC, int DH, bool DROPOUT>
__device__ __forceinline__ void first_tile(const Params& p, const Walk& w, int stage,
                                           uint32_t phase, bool last, RowState<DH>& st,
                                           uint32_t (&a)[4][4]) {
  const uint32_t sK = w.sK0 + stage * tile_bytes<DH>();
  mbar_wait(w.kv_full + 8 * stage, phase);
  if (p.merged) zero_columns(sK, w.qk_off, w.qk_off + p.dh, w.tid);
  float s[4 * NC];
#pragma unroll
  for (int x = 0; x < 4 * NC; ++x) s[x] = 0.f;
  fence_regs(s);
  wgmma_fence();
  issue_qk<NC, DH>(s, w.sQ, sK);
  wgmma_wait<0>();
  fence_regs(s);
  if (last && w.lane == 0) mbar_arrive(w.q_empty);  // q is read by no later product
  float alpha[2];
  softmax_tile<NC, DROPOUT>(p, s, 0, w.qrow, w.cq, w.slice_key, w.scale_log2, st.m, st.l,
                            alpha);
  pack_p<NC>(s, a);  // the accumulator is still 0: no rescale
}

// Key tile j >= 1 (k0 = j * BK) in stage `stage`, tile j - 1's p in `a` and its k and v
// in stage `prev`: issue s = q . k_j^T and acc += p_{j-1} . v_{j-1}, run tile j's softmax
// while p . v runs, then release stage `prev`, rescale and keep p_j in `a`.
template <int NC, int DH, bool DROPOUT>
__device__ __forceinline__ void next_tile(const Params& p, const Walk& w, int k0, int stage,
                                          uint32_t phase, int prev, bool last,
                                          RowState<DH>& st, uint32_t (&a)[4][4]) {
  const uint32_t sK = w.sK0 + stage * tile_bytes<DH>();
  mbar_wait(w.kv_full + 8 * stage, phase);
  if (p.merged) zero_columns(sK, w.qk_off, w.qk_off + p.dh, w.tid);
  float s[4 * NC];
#pragma unroll
  for (int x = 0; x < 4 * NC; ++x) s[x] = 0.f;
  fence_regs(s);
  fence_state(st, a);
  wgmma_fence();
  issue_qk<NC, DH>(s, w.sQ, sK);
  issue_pv<4, DH>(st, a, w.sV0 + prev * tile_bytes<DH>());
  wgmma_wait<1>();  // s has landed; p . v may still run
  fence_regs(s);
  if (last && w.lane == 0) mbar_arrive(w.q_empty);
  float alpha[2];
  softmax_tile<NC, DROPOUT>(p, s, k0, w.qrow, w.cq, w.slice_key, w.scale_log2, st.m, st.l,
                            alpha);
  wgmma_wait<0>();
  fence_state(st, a);
  if (w.lane == 0) mbar_arrive(w.kv_empty + 8 * prev);
  rescale(st, alpha);
  pack_p<NC>(s, a);
}

template <int DH, bool DROPOUT>
__global__ void __launch_bounds__(THREADS, (DH == 64 && !DROPOUT) ? 3 : 2)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v, const Params p) {
  constexpr int NP = DH / 64;  // panels per tile
  constexpr int S = stages<DH>();
  constexpr uint32_t TILE = tile_bytes<DH>();
  extern __shared__ uint8_t smem[];
  const uint32_t base = aligned_smem_base(smem);
  const uint32_t sQ0 = base, sK0 = base + 2 * TILE, sV0 = base + (2 + S) * TILE;
  const uint32_t bars = base + bar_offset<DH>();
  const uint32_t q_full = bars, q_empty = bars + 16;                   // + 8 * buffer
  const uint32_t kv_full = bars + 32, kv_empty = bars + 32 + 8 * S;  // + 8 * stage

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(q_full + 8 * i, 1);
      mbar_init(q_empty + 8 * i, CONSUMER_WARPS);
    }
    for (int s = 0; s < S; ++s) {
      mbar_init(kv_full + 8 * s, 1);
      mbar_init(kv_empty + 8 * s, CONSUMER_WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int n_kt = (p.nkv + BK - 1) / BK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (warp == CONSUMER_WARPS) {  // the producer: one lane issues every load
    if (lane != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    int t = 0;
    for (int item = blockIdx.x; item < p.n_items; item += gridDim.x, ++t) {
      const int bh = item / p.n_qt;
      const int qt = item - bh * p.n_qt;
      const int b = bh / p.heads;
      const int h = bh - b * p.heads;
      const int qb = t & 1;
      // buffer qb's use t / 2 waits for the consumers' release of use t / 2 - 1 (a fresh
      // barrier passes the wait of parity 1)
      mbar_wait(q_empty + 8 * qb, ((t >> 1) & 1) ^ 1);
      mbar_arrive_expect_tx(q_full + 8 * qb, TILE);
#pragma unroll
      for (int n = 0; n < NP; ++n)
        tma_load_4d(sQ0 + qb * TILE + n * PANEL_BYTES, &tm_q, q_full + 8 * qb,
                    64 * n + ((h * p.q_hcol) & ~7), qt * BQ, p.q_hcol ? 0 : h, b);
      for (int j = 0; j < n_kt; ++j) {
        mbar_wait(kv_empty + 8 * stage, phase ^ 1);
        mbar_arrive_expect_tx(kv_full + 8 * stage, 2 * TILE);
#pragma unroll
        for (int n = 0; n < NP; ++n) {
          tma_load_4d(sK0 + stage * TILE + n * PANEL_BYTES, &tm_k, kv_full + 8 * stage,
                      64 * n + ((h * p.k_hcol) & ~7), j * BK, p.k_hcol ? 0 : h, b);
          tma_load_4d(sV0 + stage * TILE + n * PANEL_BYTES, &tm_v, kv_full + 8 * stage,
                      64 * n + ((h * p.v_hcol) & ~7), j * BK, p.v_hcol ? 0 : h, b);
        }
        advance<S>(stage, phase);
      }
    }
    return;
  }

  // the consumer warpgroup
  const int rq = 16 * warp + (lane >> 2);  // this thread's rows: rq and rq + 8
  Walk w;
  w.sK0 = sK0;
  w.sV0 = sV0;
  w.kv_full = kv_full;
  w.kv_empty = kv_empty;
  w.cq = 2 * (lane & 3);  // and columns 8c + cq + {0, 1}
  w.lane = lane;
  w.tid = threadIdx.x;
  // scores, the running max m and the exponents are kept in log2 units: s * scale *
  // log2(e), so that exp(s - m) is one exp2
  w.scale_log2 = p.scale * LOG2E;
  // a last key tile of at most 16 keys takes the 16-key path, a quarter of the work
  const bool narrow_last = p.nkv - (n_kt - 1) * BK <= 16;
  int stage = 0;
  uint32_t phase = 0;
  int t = 0;
  for (int item = blockIdx.x; item < p.n_items; item += gridDim.x, ++t) {
    const int bh = item / p.n_qt;
    const int q0 = (item - bh * p.n_qt) * BQ;
    const int b = bh / p.heads;
    const int h = bh - b * p.heads;
    const int qb = t & 1;
    w.sQ = sQ0 + qb * TILE;
    w.q_empty = q_empty + 8 * qb;
    w.qrow = q0 + rq;
    w.qk_off = (h * p.q_hcol) & 7;
    const int v_off = (h * p.v_hcol) & 7;  // the head's first column of v, and of acc
    w.slice_key = ucf::dropout_slice_key(p.seed, (uint32_t)bh);

    RowState<DH> st;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      st.m[i] = -INFINITY;
      st.l[i] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < NP; ++n)
#pragma unroll
      for (int x = 0; x < 32; ++x) st.acc[n][x] = 0.f;
    uint32_t a[4][4];

    mbar_wait(q_full + 8 * qb, (t >> 1) & 1);
    if (p.merged) zero_columns(w.sQ, w.qk_off, w.qk_off + p.dh, w.tid);
    if (n_kt == 1 && narrow_last) {
      first_tile<2, DH, DROPOUT>(p, w, stage, phase, true, st, a);
    } else {
      first_tile<8, DH, DROPOUT>(p, w, stage, phase, n_kt == 1, st, a);
    }
    int prev = stage;
    advance<S>(stage, phase);
    for (int j = 1; j < n_kt; ++j) {
      const bool last = j == n_kt - 1;
      if (last && narrow_last) {
        next_tile<2, DH, DROPOUT>(p, w, j * BK, stage, phase, prev, true, st, a);
      } else {
        next_tile<8, DH, DROPOUT>(p, w, j * BK, stage, phase, prev, last, st, a);
      }
      prev = stage;
      advance<S>(stage, phase);
    }
    // the last tile's p . v
    fence_state(st, a);
    wgmma_fence();
    if (narrow_last) {
      issue_pv<1, DH>(st, a, sV0 + prev * TILE);
    } else {
      issue_pv<4, DH>(st, a, sV0 + prev * TILE);
    }
    wgmma_wait<0>();
    fence_state(st, a);
    if (lane == 0) mbar_arrive(kv_empty + 8 * prev);

    // o's row `row` starts at obase + row * o_sn; column c of acc is o's c - v_off
    const long long obase = b * p.o_sb + h * p.o_sh - v_off;
    const bool pairs = p.pair_store && (v_off & 1) == 0;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + rq + 8 * i;
      if (row >= p.nq) continue;
      const float l_inv = (st.l[i] == 0.f) ? 1.f : 1.f / st.l[i];
      const long long orow = obase + (long long)row * p.o_sn;
      __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.o) + orow;
      float* of = static_cast<float*>(p.o) + orow;
#pragma unroll
      for (int n = 0; n < NP; ++n)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int col = 64 * n + 8 * c + w.cq;  // of acc; v_off <= col < v_off + dh is o's
          const float v0 = st.acc[n][4 * c + 2 * i] * l_inv;
          const float v1 = st.acc[n][4 * c + 2 * i + 1] * l_inv;
          if (p.o_f32) {
            if (col >= v_off && col < v_off + p.dh) of[col] = v0;
            if (col + 1 >= v_off && col + 1 < v_off + p.dh) of[col + 1] = v1;
          } else if (pairs && col >= v_off && col + 1 < v_off + p.dh) {
            *reinterpret_cast<__nv_bfloat162*>(ob + col) = __floats2bfloat162_rn(v0, v1);
          } else {
            if (col >= v_off && col < v_off + p.dh) ob[col] = __float2bfloat16(v0);
            if (col + 1 >= v_off && col + 1 < v_off + p.dh) ob[col + 1] = __float2bfloat16(v1);
          }
        }
      if ((lane & 3) == 0)
        p.lse[(long long)bh * p.nq + row] = st.m[i] * LN2 + logf(fmaxf(st.l[i], 1e-37f));
    }
  }
}

// ------------------------------------------------------------------ host

int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (counts[dev] == 0 &&
      cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    counts[dev] = 0;
  return counts[dev];
}

template <int DH, bool DROPOUT>
cudaError_t launch(const Params& p, const CUtensorMap& tq, const CUtensorMap& tk,
                   const CUtensorMap& tv, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  // once per instance: the shared-memory opt-in and how many blocks an SM holds
  static int per_sm = 0;
  static const cudaError_t setup = [] {
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_sm90_kernel<DH, DROPOUT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, flash_fwd_sm90_kernel<DH, DROPOUT>, THREADS, smem);
    return err;
  }();
  if (setup != cudaSuccess) return setup;
  const int slots = sm_count() * per_sm;
  if (slots <= 0) return cudaErrorInvalidConfiguration;
  const int grid = p.n_items < slots ? p.n_items : slots;
  flash_fwd_sm90_kernel<DH, DROPOUT><<<grid, THREADS, smem, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

template <bool DROPOUT>
cudaError_t dispatch_dh(const Params& p, const CUtensorMap& tq, const CUtensorMap& tk,
                        const CUtensorMap& tv, cudaStream_t stream) {
  if (p.dh <= 64) return launch<64, DROPOUT>(p, tq, tk, tv, stream);
  if (p.dh <= 128) return launch<128, DROPOUT>(p, tq, tk, tv, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// bf16 q, k, v; o bf16, or f32 with o_f32; lse f32 [B*H, Nq]. Each of q, k, v comes with
// the tensor map that ops/flash_attention.py (`fwd_layout`) chose for it: dims (d0, d1,
// d2, d3), byte strides (s1, s2, s3) and hcol, the column step of a head when the heads
// are merged into dim 0 (then d2 = 1), else 0 (then d2 is the head dim of the map); d1 is
// always the rows. box_cols x box_rows must be the kernel's 64 x 64 tile. o's strides are
// in elements, its last dim contiguous. dropout: 0 or 1; with 1 the seed, threshold,
// (row0, col0) offset and inv_keep describe the mask. Returns a cudaError_t, or
// ENCODE_FAILED (+ CUresult) when a tensor map cannot be encoded.
extern "C" int ucf_flash_fwd_sm90(
    const void* q, const void* k, const void* v, void* o, void* lse, int batch, int heads,
    int nq, int nkv, int dh, long long q_d0, long long q_d1, long long q_d2, long long q_d3,
    long long q_s1, long long q_s2, long long q_s3, int q_hcol, long long k_d0, long long k_d1,
    long long k_d2, long long k_d3, long long k_s1, long long k_s2, long long k_s3, int k_hcol,
    long long v_d0, long long v_d1, long long v_d2, long long v_d3, long long v_s1,
    long long v_s2, long long v_s3, int v_hcol, int box_cols, int box_rows, long long o_sb,
    long long o_sh, long long o_sn, int o_f32, float scale, int dropout, unsigned int seed,
    unsigned int threshold, int row0, int col0, float inv_keep, void* stream) {
  if (batch <= 0 || heads <= 0 || nq <= 0 || nkv <= 0 || dh <= 0 || dh > 128)
    return cudaErrorInvalidValue;
  if (box_cols != 64 || box_rows != BK) return cudaErrorInvalidValue;
  // merged heads: each box starts at the 16-byte boundary at or below its head, which then
  // begins `off` columns in (off < 8); the head must fit the one panel, and q and k must
  // share their offsets
  const int hcols[3] = {q_hcol, k_hcol, v_hcol};
  for (int hcol : hcols)
    if (hcol < 0 || (hcol & 7 && dh + 8 - (hcol & -hcol) > 64)) return cudaErrorInvalidValue;
  if ((q_hcol & 7) != (k_hcol & 7)) return cudaErrorInvalidValue;
  const long long gq[7] = {q_d0, q_d1, q_d2, q_d3, q_s1, q_s2, q_s3};
  const long long gk[7] = {k_d0, k_d1, k_d2, k_d3, k_s1, k_s2, k_s3};
  const long long gv[7] = {v_d0, v_d1, v_d2, v_d3, v_s1, v_s2, v_s3};
  CUtensorMap tq, tk, tv;
  int err = encode(&tq, q, gq, BK);
  if (err == 0) err = encode(&tk, k, gk, BK);
  if (err == 0) err = encode(&tv, v, gv, BK);
  if (err != 0) return err;
  Params p;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.heads = heads;
  p.nq = nq;
  p.nkv = nkv;
  p.dh = dh;
  p.n_qt = (nq + BQ - 1) / BQ;
  const long long items = (long long)batch * heads * p.n_qt;
  if (items > 0x7FFFFFFF) return cudaErrorInvalidValue;
  p.n_items = (int)items;
  p.q_hcol = q_hcol;
  p.k_hcol = k_hcol;
  p.v_hcol = v_hcol;
  p.o_sb = o_sb;
  p.o_sh = o_sh;
  p.o_sn = o_sn;
  p.scale = scale;
  p.seed = seed;
  p.threshold = threshold;
  p.row0 = row0;
  p.col0 = col0;
  p.inv_keep = inv_keep;
  p.merged = q_hcol != 0 || k_hcol != 0;
  p.pair_store = dh % 2 == 0 && (o_sb | o_sh | o_sn) % 2 == 0 &&
                 reinterpret_cast<uintptr_t>(o) % 4 == 0;
  p.o_f32 = o_f32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dropout ? dispatch_dh<true>(p, tq, tk, tv, s) : dispatch_dh<false>(p, tq, tk, tv, s);
}
