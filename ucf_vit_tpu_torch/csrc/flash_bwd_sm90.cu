// Flash-attention backward in bf16 on Hopper's tensor cores (sm_90a: wgmma, cp.async):
// dq, dk and dv in one sweep (fused), dk and dv alone (dkv), or dq alone (dq).
//
// Replaces the Pallas TPU kernels `_bwd_fused_kernel` (ucf_vit_tpu/ops/flash_attention.py
// :249, call :676), without dq `_bwd_dkv_kernel` (:162, call :719), and `_bwd_dq_kernel`
// (:362, call :758) for bf16 inputs; f32 goes to csrc/flash_bwd_tf32.cu. From (q, k, v,
// do, lse, di = rowsum(do * o)) it computes, for each (key tile, query tile):
//   s = (q . k^T) * scale (f32), keys >= nkv masked with -0.7 * FLT_MAX, p = exp(s - lse),
//   p = 0 for rows >= nq; p_v = keep ? p / (1 - rate) : 0; dp = keep ? (do . v^T) /
//   (1 - rate) : 0; ds = p * (dp - di) * scale;
//   dv += bf16(p_v)^T . do,  dk += bf16(ds)^T . q,  dq += bf16(ds) . k
// with the roundings of the TPU kernels (`p_v.astype(do.dtype)` :224 and :321,
// `ds.astype(q.dtype)` :239 and :335, `ds.astype(k.dtype)` :341 and :419) and f32
// accumulation. The keep mask is the counter hash of attn_dropout.cuh at global
// coordinates, so it is the forward's mask.
//
// Bound on the H100 at ViT-L/16's training shape [B*H = 128, N = 257, dh = 64]: the five
// products are 5.41 GFLOP (5.5 us at 989 TFLOP/s) and q, k, v, do, dq, dk, dv in bf16
// with lse and di in f32 are 29.74 MB (8.9 us at 3.35 TB/s): bound by bytes. dq alone
// (three products, dq the only output) is bound by bytes too: 6.3 us at [192, 257, 64].
//
// Design of flash_bwd_sm90_kernel (FlashAttention-3's shape, one warpgroup): one block of
// 128 threads per (batch*head, 64-key tile). k and v stay in shared memory (bf16, the
// 128-byte-swizzled layout of sm90.cuh); the block loops over 64-row query tiles with q,
// do, lse and di double-buffered by cp.async. Per query tile:
//   s^T = k . q^T and dp^T = v . do^T: wgmma with both operands in shared memory,
//     K-major, the next query tile's copies issued while they run; p_v^T and ds^T are
//     formed in f32 registers in the accumulator layout (this thread: keys rw, rw + 8;
//     queries 8c + cq + {0, 1}), p as one ex2.approx of s * scale * log2(e) - lse * log2(e);
//   dv += p_v^T . do and dk += ds^T . q: the A operand straight from those registers
//     (rounded to bf16), do and q as MN-major B; dk and dv stay in f32 registers for the
//     whole sweep and are written once;
//   dq += ds . k (fused only, after dk and dv, so that their A registers are free): ds^T
//     goes to shared memory as bf16 and is read back as an MN-major A with k as an
//     MN-major B; the [64, DH] f32 partial is added into the zeroed f32 workspace
//     [B*H, Nq, dh] with float4 atomics (sm_90), staged through shared memory so that
//     each adds 16 contiguous bytes (half the atomics of adding the fragments' float2
//     pairs); dq's order of sums changes from run to run. The workspace's rows are
//     padded to a multiple of 4 floats (ops/flash_attention.py: _dq_workspace), so every
//     row takes whole float4s and no scalar path is needed.
// At most 168 registers a thread (three blocks an SM) at dh 64 without dropout.
//
// Design of flash_bwd_dq_sm90_kernel (dq, no atomics and no workspace): one warpgroup per
// (batch*head, 64-row query tile). q and do stay in shared memory in the swizzled layout,
// lse and di of this thread's rows in registers; the block loops over 64-key tiles of k
// and v in a ring of two stages by cp.async, the next tile's copies issued after the
// barrier that opens a tile, so that they run under its products. Per key tile:
//   s = q . k^T and dp = do . v^T: wgmma with both operands K-major in shared memory
//     (this thread: rows rw, rw + 8; keys 8c + cq + {0, 1});
//   p = ex2(s * scale * log2(e) - lse * log2(e)), keys >= nkv masked; dp dropped by the
//     hash (the TPU kernel drops only dp, :413-415); ds = p * (dp - di) * scale, all f32
//     in the accumulator registers;
//   dq += bf16(ds) . k: ds as the register A operand (acc_to_a), k as an MN-major B,
//     the product chain of flash_fwd_sm90.cu's o += p . v.
// dq stays in f32 registers for the whole sweep and is written once as bf16: the same
// bits from run to run.
//
// The head dim pads to DH = 64 or 128 (zeros past dh); keys past nkv and rows past nq
// read zeros from cp.async's zero fill. Inputs and outputs go through (batch, head, row)
// strides with the last dim contiguous.

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

enum Kernel { FUSED = 0, DKV = 1, DQ = 2 };

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const float* lse;
  const float* di;
  void* dq;  // fused: the f32 workspace, zeroed by the caller; dq: the bf16 output
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int heads, nq, nkv, dh;
  long long q_sb, q_sh, q_sn;
  long long k_sb, k_sh, k_sn;
  long long v_sb, v_sh, v_sn;
  long long do_sb, do_sh, do_sn;
  long long dq_sb, dq_sh, dq_sn;
  long long dk_sb, dk_sh, dk_sn;
  long long dv_sb, dv_sh, dv_sn;
  float scale;
  uint32_t seed, threshold;
  int row0, col0;
  float inv_keep;
  int copy_bytes;  // cp.async width for q, k, v, do (sm90.cuh: copy_bytes)
  int pair_store;  // the bf16 outputs (dk and dv, or dq) may be stored as pairs
};

template <int DH>
constexpr size_t smem_bytes() {
  // k, v, q x 2, do x 2 (DH / 64 panels each), ds^T (one panel), lse and di x 2, alignment
  return (size_t)6 * (DH / 64) * PANEL_BYTES + PANEL_BYTES + 2 * 2 * BQ * sizeof(float) + 1024;
}

// At DH = 64 without dropout, three blocks an SM (at most 168 registers a thread, no
// spills): ViT-L's 640 blocks then need two rounds of the card's 396 slots, not three.
template <int DH, bool DROPOUT, bool WITH_DQ>
__global__ void __launch_bounds__(THREADS, DH == 64 && !DROPOUT ? 3 : 1)
    flash_bwd_sm90_kernel(const Params p) {
  constexpr int NP = DH / 64;
  constexpr uint32_t TILE = NP * PANEL_BYTES;
  extern __shared__ uint8_t smem[];
  const uint32_t sK = aligned_smem_base(smem);
  const uint32_t sV = sK + TILE;
  const uint32_t sQ0 = sK + 2 * TILE, sdO0 = sK + 4 * TILE;  // stage s at + s * TILE
  const uint32_t sdS = sK + 6 * TILE;
  const uint32_t sStat = sdS + PANEL_BYTES;  // [stage][lse, di][64] f32
  // the same stats through a generic pointer, for ordinary loads
  const float* stat = reinterpret_cast<const float*>(smem + (sStat - smem_u32(smem)));

  const int bh = blockIdx.x;
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  const int k0 = blockIdx.y * BK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rw = 16 * warp + (lane >> 2);  // this thread's accumulator rows: rw, rw + 8
  const int cq = 2 * (lane & 3);           // and columns 8c + cq + {0, 1}
  const uint32_t slice_key = ucf::dropout_slice_key(p.seed, (uint32_t)bh);
  const float scale_log2 = p.scale * LOG2E;  // p = exp2(s * scale * log2(e) - lse * log2(e))
  const bool keys_ragged = k0 + BK > p.nkv;  // only the last key tile holds keys past nkv

  const __nv_bfloat16* qg = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vg = p.v + b * p.v_sb + h * p.v_sh;
  const __nv_bfloat16* dog = p.dout + b * p.do_sb + h * p.do_sh;

  // q, do, lse and di of the query tile at q0 into stage st
  auto load_q_tile = [&](int st, int q0) {
    load_tile<NP>(sQ0 + st * TILE, qg, p.q_sn, q0, p.nq, p.dh, p.copy_bytes);
    load_tile<NP>(sdO0 + st * TILE, dog, p.do_sn, q0, p.nq, p.dh, p.copy_bytes);
    const int which = threadIdx.x >> 6, r = threadIdx.x & 63;
    const bool ok = q0 + r < p.nq;
    const float* src = (which ? p.di : p.lse) + (ok ? (long long)bh * p.nq + q0 + r : 0);
    cp_async<4>(sStat + ((st * 2 + which) * BQ + r) * 4, src, ok ? 4 : 0);
  };

  load_tile<NP>(sK, kg, p.k_sn, k0, p.nkv, p.dh, p.copy_bytes);
  load_tile<NP>(sV, vg, p.v_sn, k0, p.nkv, p.dh, p.copy_bytes);
  load_q_tile(0, 0);
  cp_async_commit();

  float dk[NP][32], dv[NP][32];
#pragma unroll
  for (int n = 0; n < NP; ++n)
#pragma unroll
    for (int x = 0; x < 32; ++x) dk[n][x] = dv[n][x] = 0.f;

  const int n_tiles = (p.nq + BQ - 1) / BQ;
  for (int qt = 0; qt < n_tiles; ++qt) {
    const int st = qt & 1;
    const int q0 = qt * BQ;
    const uint32_t sQ = sQ0 + st * TILE, sdO = sdO0 + st * TILE;
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();  // tile qt has landed; every thread is done with tile qt - 1

    // s^T = k . q^T and dp^T = v . do^T: rows are keys, columns queries
    float s[32], dp[32];
#pragma unroll
    for (int x = 0; x < 32; ++x) s[x] = dp[x] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t off = (kk >> 2) * PANEL_BYTES + (kk & 3) * 32;
      wgmma_ss<0, 0>(s, make_desc(sK + off), make_desc(sQ + off));
    }
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t off = (kk >> 2) * PANEL_BYTES + (kk & 3) * 32;
      wgmma_ss<0, 0>(dp, make_desc(sV + off), make_desc(sdO + off));
    }
    wgmma_commit();
    if (qt + 1 < n_tiles) {  // the next query tile while the products run
      load_q_tile(st ^ 1, q0 + BQ);
      cp_async_commit();
    }
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // s -> p_v^T, dp -> ds^T, in place
    const float* lse_t = stat + (st * 2) * BQ;
    const float* di_t = stat + (st * 2 + 1) * BQ;
    const bool rows_ragged = q0 + BQ > p.nq;
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int qc = 8 * c + cq + jj;
        const bool row_ok = !rows_ragged || q0 + qc < p.nq;
        const float lse_q = lse_t[qc] * LOG2E, di_q = di_t[qc];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int x = 4 * c + 2 * i + jj;
          const int key = k0 + rw + 8 * i;
          float sv = s[x] * scale_log2;
          if (keys_ragged && key >= p.nkv) sv = MASK_VALUE;
          const float pr = row_ok ? exp2_approx(sv - lse_q) : 0.f;
          float pv = pr, dpv = dp[x];
          if constexpr (DROPOUT) {
            const bool keep =
                ucf::dropout_keep(slice_key, p.row0 + q0 + qc, p.col0 + key, p.threshold);
            pv = keep ? pr * p.inv_keep : 0.f;
            dpv = keep ? dpv * p.inv_keep : 0.f;
          }
          s[x] = pv;
          dp[x] = pr * (dpv - di_q) * p.scale;
        }
      }
    uint32_t a_p[4][4], a_ds[4][4];
    acc_to_a(s, a_p);
    acc_to_a(dp, a_ds);

    if constexpr (WITH_DQ) {
      // ds^T as bf16 into shared memory (rows = keys, 64 query columns), for dq below.
      // a_ds[t][r] holds row rw + 8 (r & 1), columns 16t + 8 (r >> 1) + cq + {0, 1}.
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = rw + 8 * (r & 1);
          const uint32_t addr = sdS + swizzle_offset(row, 16 * t + 8 * (r >> 1) + cq);
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(a_ds[t][r]) : "memory");
        }
      fence_proxy_async();
    }

    // dv += p_v^T . do and dk += ds^T . q: A from registers, do and q MN-major
#pragma unroll
    for (int n = 0; n < NP; ++n) {
      fence_regs(dv[n]);
      fence_regs(dk[n]);
    }
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int n = 0; n < NP; ++n) {
        const uint32_t off = n * PANEL_BYTES + t * 16 * ROW_BYTES;
        wgmma_rs<1>(dv[n], a_p[t], make_desc(sdO + off));
        wgmma_rs<1>(dk[n], a_ds[t], make_desc(sQ + off));
      }
    wgmma_commit();

    if constexpr (WITH_DQ) {
      wgmma_wait<0>();  // dk and dv first: p_v and ds leave the registers before dq comes
      __syncthreads();  // every warp's ds^T is in shared memory
      float* dqg = static_cast<float*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
      for (int n = 0; n < NP; ++n) {
        // dq[:, 64n .. 64n + 63] partial = ds . k: ds^T and k both MN-major
        float dq[32];
#pragma unroll
        for (int x = 0; x < 32; ++x) dq[x] = 0.f;
        fence_regs(dq);
        wgmma_fence();
#pragma unroll
        for (int t = 0; t < 4; ++t)
          wgmma_ss<1, 1>(dq, make_desc(sdS + t * 16 * ROW_BYTES),
                         make_desc(sK + n * PANEL_BYTES + t * 16 * ROW_BYTES));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
        // Through shared memory, so that each atomic adds 16 contiguous bytes: the f32
        // [64, 64] partial goes into this stage's q and do tiles (free now: dk, dv and
        // dq have read them), rows 0-31 and 32-63, 256 bytes a row, float4 column
        // groups swizzled by the row (2-way bank conflicts at most).
        auto sdq = [&](int r, int col) {
          return ((r < 32 ? sQ : sdO) + (uint32_t)(r & 31) * 256u) +
                 (uint32_t)((col ^ ((r & 7) << 3)) * 4);
        };
        if (n > 0) __syncthreads();  // the previous panel's reads are done
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 8; ++c)
            asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(sdq(rw + 8 * i, 8 * c + cq)),
                         "f"(dq[4 * c + 2 * i]), "f"(dq[4 * c + 2 * i + 1])
                         : "memory");
        __syncthreads();
#pragma unroll
        for (int it = 0; it < 8; ++it) {
          const int idx = threadIdx.x + 128 * it;
          const int r = idx >> 4, c4 = (idx & 15) * 4;
          float4 x;
          asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                       : "=f"(x.x), "=f"(x.y), "=f"(x.z), "=f"(x.w)
                       : "r"(sdq(r, c4))
                       : "memory");
          float* dst = dqg + (long long)(q0 + r) * p.dq_sn + 64 * n + c4;
          if (q0 + r < p.nq && 64 * n + c4 < p.dh) atomicAdd(reinterpret_cast<float4*>(dst), x);
        }
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int n = 0; n < NP; ++n) {
      fence_regs(dv[n]);
      fence_regs(dk[n]);
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      fence_regs(a_p[t]);
      fence_regs(a_ds[t]);
    }
  }

  __nv_bfloat16* dkg = p.dk + b * p.dk_sb + h * p.dk_sh;
  __nv_bfloat16* dvg = p.dv + b * p.dv_sb + h * p.dv_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = k0 + rw + 8 * i;
    if (row >= p.nkv) continue;
    __nv_bfloat16* dkrow = dkg + (long long)row * p.dk_sn;
    __nv_bfloat16* dvrow = dvg + (long long)row * p.dv_sn;
#pragma unroll
    for (int n = 0; n < NP; ++n)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = 64 * n + 8 * c + cq;
        const int x = 4 * c + 2 * i;
        if (p.pair_store && col + 1 < p.dh) {
          *reinterpret_cast<__nv_bfloat162*>(dkrow + col) =
              __floats2bfloat162_rn(dk[n][x], dk[n][x + 1]);
          *reinterpret_cast<__nv_bfloat162*>(dvrow + col) =
              __floats2bfloat162_rn(dv[n][x], dv[n][x + 1]);
        } else {
          if (col < p.dh) {
            dkrow[col] = __float2bfloat16(dk[n][x]);
            dvrow[col] = __float2bfloat16(dv[n][x]);
          }
          if (col + 1 < p.dh) {
            dkrow[col + 1] = __float2bfloat16(dk[n][x + 1]);
            dvrow[col + 1] = __float2bfloat16(dv[n][x + 1]);
          }
        }
      }
  }
}

template <int DH>
constexpr size_t dq_smem_bytes() {
  // q, do, two stages of k and v (DH / 64 panels each), alignment
  return (size_t)6 * (DH / 64) * PANEL_BYTES + 1024;
}

// Three blocks an SM at DH = 64 (at most 168 registers a thread), two at DH = 128.
template <int DH, bool DROPOUT>
__global__ void __launch_bounds__(THREADS, DH == 64 ? 3 : 2)
    flash_bwd_dq_sm90_kernel(const Params p) {
  constexpr int NP = DH / 64;
  constexpr uint32_t TILE = NP * PANEL_BYTES;
  extern __shared__ uint8_t smem[];
  const uint32_t sQ = aligned_smem_base(smem);
  const uint32_t sdO = sQ + TILE;
  const uint32_t sKV0 = sQ + 2 * TILE;  // stage st: k at + 2 st TILE, v one TILE after it

  const int bh = blockIdx.x;
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  const int q0 = blockIdx.y * BQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rw = 16 * warp + (lane >> 2);  // this thread's accumulator rows: rw, rw + 8
  const int cq = 2 * (lane & 3);           // and columns 8c + cq + {0, 1}
  const uint32_t slice_key = ucf::dropout_slice_key(p.seed, (uint32_t)bh);
  const float scale_log2 = p.scale * LOG2E;  // p = exp2(s * scale * log2(e) - lse * log2(e))

  const __nv_bfloat16* qg = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vg = p.v + b * p.v_sb + h * p.v_sh;
  const __nv_bfloat16* dog = p.dout + b * p.do_sb + h * p.do_sh;

  load_tile<NP>(sQ, qg, p.q_sn, q0, p.nq, p.dh, p.copy_bytes);
  load_tile<NP>(sdO, dog, p.do_sn, q0, p.nq, p.dh, p.copy_bytes);
  load_tile<NP>(sKV0, kg, p.k_sn, 0, p.nkv, p.dh, p.copy_bytes);
  load_tile<NP>(sKV0 + TILE, vg, p.v_sn, 0, p.nkv, p.dh, p.copy_bytes);
  cp_async_commit();

  // lse (times log2(e)) and di of this thread's rows; p = 0 on rows past nq
  float lse2[2], di[2];
  bool row_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + rw + 8 * i;
    row_ok[i] = row < p.nq;
    lse2[i] = row_ok[i] ? p.lse[(long long)bh * p.nq + row] * LOG2E : 0.f;
    di[i] = row_ok[i] ? p.di[(long long)bh * p.nq + row] : 0.f;
  }

  float dq[NP][32];
#pragma unroll
  for (int n = 0; n < NP; ++n)
#pragma unroll
    for (int x = 0; x < 32; ++x) dq[n][x] = 0.f;

  const int n_tiles = (p.nkv + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    const uint32_t sK = sKV0 + 2 * (kt & 1) * TILE, sV = sK + TILE;
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();  // tile kt has landed; every thread's products on tile kt - 1 are done
    if (kt + 1 < n_tiles) {  // the next key tile under this one's products
      const uint32_t nK = sKV0 + 2 * ((kt + 1) & 1) * TILE;
      load_tile<NP>(nK, kg, p.k_sn, k0 + BK, p.nkv, p.dh, p.copy_bytes);
      load_tile<NP>(nK + TILE, vg, p.v_sn, k0 + BK, p.nkv, p.dh, p.copy_bytes);
      cp_async_commit();
    }

    // s = q . k^T and dp = do . v^T: rows are queries, columns keys
    float s[32], dp[32];
#pragma unroll
    for (int x = 0; x < 32; ++x) s[x] = dp[x] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t off = (kk >> 2) * PANEL_BYTES + (kk & 3) * 32;
      wgmma_ss<0, 0>(s, make_desc(sQ + off), make_desc(sK + off));
    }
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t off = (kk >> 2) * PANEL_BYTES + (kk & 3) * 32;
      wgmma_ss<0, 0>(dp, make_desc(sdO + off), make_desc(sV + off));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // dp -> ds, in place
    const bool keys_ragged = k0 + BK > p.nkv;  // only the last key tile holds keys past nkv
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int key = k0 + 8 * c + cq + jj;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int x = 4 * c + 2 * i + jj;
          float sv = s[x] * scale_log2;
          if (keys_ragged && key >= p.nkv) sv = MASK_VALUE;
          const float pr = row_ok[i] ? exp2_approx(sv - lse2[i]) : 0.f;
          float dpv = dp[x];
          if constexpr (DROPOUT) {
            const bool keep =
                ucf::dropout_keep(slice_key, p.row0 + q0 + rw + 8 * i, p.col0 + key, p.threshold);
            dpv = keep ? dpv * p.inv_keep : 0.f;
          }
          dp[x] = pr * (dpv - di[i]) * p.scale;
        }
      }
    uint32_t a_ds[4][4];
    acc_to_a(dp, a_ds);

    // dq += ds . k: A from registers (16 keys a k-step), k MN-major
#pragma unroll
    for (int n = 0; n < NP; ++n) fence_regs(dq[n]);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int n = 0; n < NP; ++n)
        wgmma_rs<1>(dq[n], a_ds[t], make_desc(sK + n * PANEL_BYTES + t * 16 * ROW_BYTES));
    wgmma_commit();
    wgmma_wait<0>();  // before the next tile's barrier: its copies overwrite this k
#pragma unroll
    for (int n = 0; n < NP; ++n) fence_regs(dq[n]);
#pragma unroll
    for (int t = 0; t < 4; ++t) fence_regs(a_ds[t]);
  }

  __nv_bfloat16* dqg = static_cast<__nv_bfloat16*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!row_ok[i]) continue;
    __nv_bfloat16* dqrow = dqg + (long long)(q0 + rw + 8 * i) * p.dq_sn;
#pragma unroll
    for (int n = 0; n < NP; ++n)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = 64 * n + 8 * c + cq;
        const int x = 4 * c + 2 * i;
        if (p.pair_store && col + 1 < p.dh) {
          *reinterpret_cast<__nv_bfloat162*>(dqrow + col) =
              __floats2bfloat162_rn(dq[n][x], dq[n][x + 1]);
        } else {
          if (col < p.dh) dqrow[col] = __float2bfloat16(dq[n][x]);
          if (col + 1 < p.dh) dqrow[col + 1] = __float2bfloat16(dq[n][x + 1]);
        }
      }
  }
}

template <typename Kernel>
cudaError_t run(Kernel kernel, size_t smem, dim3 grid, const Params& p, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DH, bool DROPOUT>
cudaError_t launch(int kind, const Params& p, int bh, cudaStream_t stream) {
  if (kind == DQ) {
    return run(flash_bwd_dq_sm90_kernel<DH, DROPOUT>, dq_smem_bytes<DH>(),
               dim3(bh, (p.nq + BQ - 1) / BQ), p, stream);
  }
  const dim3 grid(bh, (p.nkv + BK - 1) / BK);
  if (kind == DKV) {
    return run(flash_bwd_sm90_kernel<DH, DROPOUT, false>, smem_bytes<DH>(), grid, p, stream);
  }
  return run(flash_bwd_sm90_kernel<DH, DROPOUT, true>, smem_bytes<DH>(), grid, p, stream);
}

template <bool DROPOUT>
cudaError_t dispatch_dh(int kind, const Params& p, int bh, cudaStream_t stream) {
  if (p.dh <= 64) return launch<64, DROPOUT>(kind, p, bh, stream);
  if (p.dh <= 128) return launch<128, DROPOUT>(kind, p, bh, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// kind: 0 = fused (dq is an f32 workspace the caller zeroed: 16-byte aligned, strides
// of 4 floats, rows of at least dh rounded up to 4), 1 = dkv (dq unused), 2 = dq (dq
// the bf16 output; dk and dv unused). bf16 q, k, v, do, dk, dv; lse and di f32 [B*H, Nq].
// Strides are in elements, the last dim contiguous. dropout: 0 or 1; with 1 the seed, threshold, (row0, col0) offset and
// inv_keep describe the forward's mask. Returns a cudaError_t.
extern "C" int ucf_flash_bwd_sm90(int kind, const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse, const void* di, void* dq,
                                  void* dk, void* dv, int batch, int heads, int nq, int nkv,
                                  int dh, long long q_sb, long long q_sh, long long q_sn,
                                  long long k_sb, long long k_sh, long long k_sn,
                                  long long v_sb, long long v_sh, long long v_sn,
                                  long long do_sb, long long do_sh, long long do_sn,
                                  long long dq_sb, long long dq_sh, long long dq_sn,
                                  long long dk_sb, long long dk_sh, long long dk_sn,
                                  long long dv_sb, long long dv_sh, long long dv_sn,
                                  float scale, int dropout, unsigned int seed,
                                  unsigned int threshold, int row0, int col0, float inv_keep,
                                  void* stream) {
  if (batch <= 0 || heads <= 0 || nq <= 0 || nkv <= 0 || dh <= 0) return cudaErrorInvalidValue;
  if (kind != FUSED && kind != DKV && kind != DQ) return cudaErrorInvalidValue;
  if (((kind == DQ ? nq : nkv) + 63) / 64 > 65535) return cudaErrorInvalidValue;
  // dq is added as float4s: a 16-byte aligned workspace with strides of 4 floats
  if (kind == FUSED &&
      (reinterpret_cast<uintptr_t>(dq) % 16 != 0 || (dq_sb | dq_sh | dq_sn) % 4 != 0))
    return cudaErrorInvalidValue;
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.di = static_cast<const float*>(di);
  p.dq = dq;
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.heads = heads;
  p.nq = nq;
  p.nkv = nkv;
  p.dh = dh;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_sn = q_sn;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_sn = k_sn;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_sn = v_sn;
  p.do_sb = do_sb; p.do_sh = do_sh; p.do_sn = do_sn;
  p.dq_sb = dq_sb; p.dq_sh = dq_sh; p.dq_sn = dq_sn;
  p.dk_sb = dk_sb; p.dk_sh = dk_sh; p.dk_sn = dk_sn;
  p.dv_sb = dv_sb; p.dv_sh = dv_sh; p.dv_sn = dv_sn;
  p.scale = scale;
  p.seed = seed;
  p.threshold = threshold;
  p.row0 = row0;
  p.col0 = col0;
  p.inv_keep = inv_keep;
  const void* in_ptrs[4] = {q, k, v, dout};
  const long long in_strides[12] = {q_sb, q_sh, q_sn, k_sb, k_sh, k_sn,
                                    v_sb, v_sh, v_sn, do_sb, do_sh, do_sn};
  p.copy_bytes = ucf::sm90::copy_bytes(in_ptrs, 4, in_strides, 12);
  const auto pairs = [dh](const void* t, long long sb, long long sh, long long sn) {
    return dh % 2 == 0 && (sb | sh | sn) % 2 == 0 && reinterpret_cast<uintptr_t>(t) % 4 == 0;
  };
  p.pair_store = kind == DQ ? pairs(dq, dq_sb, dq_sh, dq_sn)
                            : pairs(dk, dk_sb, dk_sh, dk_sn) && pairs(dv, dv_sb, dv_sh, dv_sn);
  const int bh = batch * heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dropout ? dispatch_dh<true>(kind, p, bh, s) : dispatch_dh<false>(kind, p, bh, s);
}
