// Flash-attention backward in f32 on Hopper's tensor cores (sm_90a), f32-accurate by the
// 3xTF32 split of tf32x3.cuh on mma.sync: dq, dk and dv in one sweep (fused), dk and dv
// alone (dkv), or dq alone (dq).
//
// Replaces the Pallas TPU kernels `_bwd_fused_kernel` (ucf_vit_tpu/ops/flash_attention.py
// :249, launched by `_flash_bwd_len` :651, call :676), `_bwd_dkv_kernel` (:162, call :719)
// and `_bwd_dq_kernel` (:362, call :758) for f32 inputs; flash_bwd_sm90.cu has the bf16
// ones. From (q, k, v, do, lse, di = rowsum(do * o)), for each (key tile, query tile):
//   s = (q . k^T) * scale, keys >= nkv masked (p = 0), p = exp(s - lse), p = 0 for
//   rows >= nq; p_v = keep ? p / (1 - rate) : 0; dp = keep ? (do . v^T) / (1 - rate) : 0;
//   ds = p * (dp - di) * scale;   dv += p_v^T . do,  dk += ds^T . q,  dq += ds . k
// all in f32. The keep mask is the counter hash of attn_dropout.cuh at global
// coordinates, so it is the forward's mask although the tiles differ; with rate 0 (a
// template flag) it compiles away.
//
// Bound on the H100 at the training shape [B*H = 192, N = 257, dh = 64]: the five products
// are 10 * 192 * 257^2 * 64 = 8.12 GFLOP; three TF32 passes each at 495 TFLOP/s take
// 0.0492 ms, the 89 MB of inputs and outputs 0.027 ms at 3.35 TB/s. Bound by operations.
// dkv does four of the products (0.0394 ms), dq three (0.0295 ms).
//
// Design of flash_bwd_tf32_kernel (fused, and dkv with WITH_DQ = false): one block of 4
// warps per (batch*head, 64-key tile); warp w owns keys 16w .. 16w + 15. The k and v tiles
// stay in shared memory for the whole sweep (f32, row stride DH + 4); the block loops over
// 64-row query tiles of q, do, lse and di. Per query tile and warp:
//   s^T (16 keys x 64 rows) = k . q^T and dp^T = v . do^T by the 3-pass product, k's and
//     v's A fragments split once per k-step and used for all eight 8-row tiles;
//   p^T = ex2(s^T * scale * log2(e) - lse * log2(e)) and ds^T = p^T * (dp_v^T - di) * scale
//     in registers, in the C fragment layout;
//   dv += p_v^T . do and dk += ds^T . q with the A fragment straight from those registers
//     (c_to_a) and do and q read through the permuted B index; each query tile's part is
//     summed apart and added by f32 adds (mma3_cb_add: the tensor cores' accumulation does
//     not round to nearest, and carried over N = 32768 rows it drifted by 3e-4); dk and dv
//     stay in f32 registers for the whole sweep and are written once;
//   fused only: ds^T goes to shared memory as ds [row][key], and after a barrier warp w
//     computes dq = ds . k for query rows 16w .. 16w + 15 over the block's 64 keys and adds
//     it into the zeroed f32 workspace [B*H, Nq, dh] with float2 atomics (sm_90). The order
//     of those sums changes from run to run. The workspace's rows are padded to a multiple
//     of 4 floats (ops/flash_attention.py: _dq_workspace), so every pair is whole. The next
//     query tile's copies by cp.async run during the dq product.
//   dkv: no ds tile, no dq product and no barrier in the middle of a query tile. q, do,
//     lse and di are double-buffered instead (the shared memory that ds took holds the
//     second stage: 105 KB a block at DH = 64, two blocks an SM as for the fused kernel),
//     and the next query tile's copies are issued right after the barrier that opens a
//     tile, so they run under all four products.
// Warps whose keys (or query rows, for dq) are all out of range, and 8-row or 8-key tiles
// all out of range, skip their products.
//
// Design of flash_bwd_dq_tf32_kernel (dq, no atomics): one block of 4 warps per
// (batch*head, 64-row query tile); warp w owns rows 16w .. 16w + 15. q and do stay in
// shared memory (f32, row stride DH + 4) and the block loops over 64-key tiles of k and v
// in a ring of two stages by cp.async: the next tile's copies are issued after the barrier
// that opens a tile and run under its products. Per key tile and warp:
//   s (16 rows x 64 keys) = q . k^T and dp = do . v^T by the 3-pass product, q's and do's
//     A fragments split once per k-step and used for all eight 8-key tiles;
//   p = ex2(s * scale * log2(e) - lse * log2(e)), 0 for keys >= nkv; dp dropped by the
//     hash; ds = p * (dp_v - di) * scale, in the C fragment layout, in place of dp;
//   dq += ds . k with ds's A fragment from those registers (c_to_a) and k read through the
//     permuted B index; each key tile's part summed from zero and added by f32 adds, as
//     above (over 32768 keys the tensor cores' accumulation would drift).
// dq stays in f32 registers and is written once: the same bits from run to run.
//
// The head dim is padded inside to DH (48, 64, 96 or 128): zeros past dh from cp.async's
// zero fill, stores past dh skipped. Inputs and outputs go through (batch, head, row)
// strides with the last dim contiguous.

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstdint>

#include "attn_dropout.cuh"
#include "tf32x3.cuh"

namespace {

using namespace ucf::tf32x3;

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 128;

enum Kernel { FUSED = 0, DKV = 1, DQ = 2 };

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  const float* lse;
  const float* di;
  float* dq;  // fused: the zeroed f32 workspace; dq: the output
  float* dk;
  float* dv;
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
  int copy_bytes;  // cp.async width for q, k, v and do: 16 or 4
};

template <int DH, bool WITH_DQ>
constexpr size_t smem_bytes() {
  // sK, sV, then per stage sQ and sdO (row stride DH + 4); sdS with row stride BK + 4
  // (fused only); per stage lse and di
  constexpr int stages = WITH_DQ ? 1 : 2;
  return sizeof(float) * ((size_t)(2 + 2 * stages) * 64 * (DH + 4) +
                          (WITH_DQ ? BQ * (BK + 4) : 0) + 2 * stages * BQ);
}

template <int DH>
constexpr size_t dq_smem_bytes() {
  // sQ and sdO, then two stages of sK and sV, row stride DH + 4
  return sizeof(float) * (size_t)6 * 64 * (DH + 4);
}

// The block counts an SM must hold (shared memory allows them at DH <= 64, with or
// without dq) cap the registers.
template <int DH, bool DROPOUT, bool WITH_DQ>
__global__ void __launch_bounds__(THREADS, DH <= 64 ? 2 : 1)
    flash_bwd_tf32_kernel(const Params p) {
  constexpr int S = DH + 4;   // shared row stride (floats)
  constexpr int DS = BK + 4;  // sdS's row stride
  constexpr int KD = DH / 8;  // k-steps of k . q^T and v . do^T; n-tiles of dk, dv and dq
  constexpr int NT = BQ / 8;  // 8-row tiles of s^T; k-steps of dv and dk
  constexpr int NK = BK / 8;  // k-steps of dq
  constexpr int STAGES = WITH_DQ ? 1 : 2;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = sK + BK * S;
  float* sQ0 = sV + BK * S;             // stage st at + st * BQ * S
  float* sdO0 = sQ0 + STAGES * BQ * S;  // likewise
  float* sdS = sdO0 + STAGES * BQ * S;  // ds [query row][key] (fused only)
  float* sLse0 = sdS + (WITH_DQ ? BQ * DS : 0);  // stage st at + st * BQ
  float* sDi0 = sLse0 + STAGES * BQ;             // likewise

  const int bh = blockIdx.x;
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  const int k0 = blockIdx.y * BK;
  const int w16 = (threadIdx.x >> 5) * 16;  // this warp's first key (and dq row) in the tile
  const int g = lane_g();
  const int t = lane_t();
  const int kvalid = min(BK, p.nkv - k0);
  const bool kactive = w16 < kvalid;
  const uint32_t slice_key = ucf::dropout_slice_key(p.seed, (uint32_t)bh);
  const float scale_log2 = p.scale * LOG2E;

  const float* qg = p.q + b * p.q_sb + h * p.q_sh;
  const float* kg = p.k + b * p.k_sb + h * p.k_sh;
  const float* vg = p.v + b * p.v_sb + h * p.v_sh;
  const float* dog = p.dout + b * p.do_sb + h * p.do_sh;
  const float* lseg = p.lse + (long long)bh * p.nq;
  const float* dig = p.di + (long long)bh * p.nq;

  // q, do, lse and di of the query tile at q0 into stage st, as one commit group
  const auto load_q_tile = [&](int st, int q0) {
    load_tile<DH>(sQ0 + st * BQ * S, qg, p.q_sn, q0, p.nq, p.dh, p.copy_bytes);
    load_tile<DH>(sdO0 + st * BQ * S, dog, p.do_sn, q0, p.nq, p.dh, p.copy_bytes);
    load_row_stats(sLse0 + st * BQ, lseg, q0, p.nq, 0);
    load_row_stats(sDi0 + st * BQ, dig, q0, p.nq, 64);
    cp_async_commit();
  };

  load_tile<DH>(sK, kg, p.k_sn, k0, p.nkv, p.dh, p.copy_bytes);
  load_tile<DH>(sV, vg, p.v_sn, k0, p.nkv, p.dh, p.copy_bytes);
  load_q_tile(0, 0);

  float dk[KD][4], dv[KD][4];
#pragma unroll
  for (int n = 0; n < KD; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[n][i] = dv[n][i] = 0.f;

  for (int q0 = 0; q0 < p.nq; q0 += BQ) {
    const int st = WITH_DQ ? 0 : (q0 / BQ) & 1;
    const float* sQ = sQ0 + st * BQ * S;
    const float* sdO = sdO0 + st * BQ * S;
    const float* sLse = sLse0 + st * BQ;
    const float* sDi = sDi0 + st * BQ;
    cp_async_wait_all();
    __syncthreads();  // this query tile landed; every warp is done with the previous one
    if constexpr (!WITH_DQ) {
      if (q0 + BQ < p.nq) load_q_tile(st ^ 1, q0 + BQ);  // under this tile's products
    }
    const int qvalid = min(BQ, p.nq - q0);

    if (kactive) {
      // s^T = k . q^T
      float pt[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) pt[nt][i] = 0.f;
      if (qvalid == BQ) {
        mma3_abt<DH, NT, true>(pt, sK + w16 * S, sQ, qvalid);
      } else {
        mma3_abt<DH, NT, false>(pt, sK + w16 * S, sQ, qvalid);
      }
      // p^T; 0 for keys past nkv and rows past nq
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = 8 * nt + c_col(i);
          const bool ok = w16 + c_row(i) < kvalid && row < qvalid;
          pt[nt][i] = ok ? exp2_approx(fmaf(pt[nt][i], scale_log2, -sLse[row] * LOG2E)) : 0.f;
        }

      // the keep mask of this thread's 32 elements, bit 4 nt + i: hashed once for dv and ds
      uint32_t keep_bits = 0xffffffffu;
      if constexpr (DROPOUT) {
        keep_bits = 0;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const bool keep = ucf::dropout_keep(slice_key, p.row0 + q0 + 8 * nt + c_col(i),
                                                p.col0 + k0 + w16 + c_row(i), p.threshold);
            keep_bits |= (uint32_t)keep << (4 * nt + i);
          }
      }
      const auto drop = [&](int nt, int i, float x) {
        if constexpr (DROPOUT) return (keep_bits >> (4 * nt + i)) & 1u ? x * p.inv_keep : 0.f;
        return x;
      };

      // dv += p_v^T . do
      mma3_cb_add<DH, NT>(dv, pt, sdO, qvalid, drop);

      // dp^T = v . do^T
      float dst[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) dst[nt][i] = 0.f;
      if (qvalid == BQ) {
        mma3_abt<DH, NT, true>(dst, sV + w16 * S, sdO, qvalid);
      } else {
        mma3_abt<DH, NT, false>(dst, sV + w16 * S, sdO, qvalid);
      }
      // ds^T = p^T * (dp_v^T - di) * scale, in place of dp^T
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = 8 * nt + c_col(i);
          dst[nt][i] = pt[nt][i] * (drop(nt, i, dst[nt][i]) - sDi[row]) * p.scale;
        }

      // dk += ds^T . q
      mma3_cb_add<DH, NT>(dk, dst, sQ, qvalid, [](int, int, float x) { return x; });

      if constexpr (WITH_DQ) {
        // ds [row][key] for the dq product
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) sdS[(8 * nt + c_col(i)) * DS + w16 + c_row(i)] = dst[nt][i];
      }
    }

    if constexpr (WITH_DQ) {
      __syncthreads();  // ds visible; every warp is done with sQ, sdO, sLse and sDi
      if (q0 + BQ < p.nq) load_q_tile(0, q0 + BQ);

      // dq (rows w16 .. w16 + 15 of the tile) += ds . k over the block's keys. A's k-slots
      // t and t + 4 take keys 2t and 2t + 1 (one 8-byte load), k's rows are read to match.
      if (w16 < qvalid) {
        float dq[KD][4];
#pragma unroll
        for (int n = 0; n < KD; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) dq[n][i] = 0.f;
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) {
          if (8 * kk < kvalid) {
            const float2 lo_row = *reinterpret_cast<const float2*>(
                sdS + (w16 + g) * DS + 8 * kk + 2 * t);
            const float2 hi_row = *reinterpret_cast<const float2*>(
                sdS + (w16 + g + 8) * DS + 8 * kk + 2 * t);
            const float af[4] = {lo_row.x, hi_row.x, lo_row.y, hi_row.y};
            const FragA a = split_a(af);
            const float* k0r = sK + (8 * kk + perm_k(0)) * S + g;
            const float* k1r = sK + (8 * kk + perm_k(1)) * S + g;
#pragma unroll
            for (int n = 0; n < KD; ++n) mma3(dq[n], a, split_b(k0r[8 * n], k1r[8 * n]));
          }
        }
        float* dqg = p.dq + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = q0 + w16 + g + 8 * r;
          if (row >= p.nq) continue;
#pragma unroll
          for (int n = 0; n < KD; ++n) {
            const int col = 8 * n + 2 * t;
            if (col < p.dh) {
              atomicAdd(reinterpret_cast<float2*>(dqg + (long long)row * p.dq_sn + col),
                        make_float2(dq[n][2 * r], dq[n][2 * r + 1]));
            }
          }
        }
      }
    }
  }

  if (!kactive) return;
  float* dkg = p.dk + b * p.dk_sb + h * p.dk_sh;
  float* dvg = p.dv + b * p.dv_sb + h * p.dv_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + w16 + g + 8 * r;
    if (row >= p.nkv) continue;
#pragma unroll
    for (int n = 0; n < KD; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = 8 * n + 2 * t + j;
        if (col < p.dh) {
          dkg[(long long)row * p.dk_sn + col] = dk[n][2 * r + j];
          dvg[(long long)row * p.dv_sn + col] = dv[n][2 * r + j];
        }
      }
  }
}

template <int DH, bool DROPOUT>
__global__ void __launch_bounds__(THREADS, DH <= 64 ? 2 : 1)
    flash_bwd_dq_tf32_kernel(const Params p) {
  constexpr int S = DH + 4;     // shared row stride (floats)
  constexpr int TILE = 64 * S;  // floats of one 64-row tile
  constexpr int KD = DH / 8;    // k-steps of q . k^T and do . v^T; n-tiles of dq
  constexpr int NT = BK / 8;    // 8-key tiles of s and dp; k-steps of dq
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sdO = sQ + TILE;
  float* sKV0 = sdO + TILE;  // stage st: k at + 2 st TILE, v one TILE after it

  const int bh = blockIdx.x;
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  const int q0 = blockIdx.y * BQ;
  const int w16 = (threadIdx.x >> 5) * 16;  // this warp's first row in the tile
  const int g = lane_g();
  const int t = lane_t();
  const bool active = q0 + w16 < p.nq;
  const uint32_t slice_key = ucf::dropout_slice_key(p.seed, (uint32_t)bh);
  const float scale_log2 = p.scale * LOG2E;

  const float* qg = p.q + b * p.q_sb + h * p.q_sh;
  const float* kg = p.k + b * p.k_sb + h * p.k_sh;
  const float* vg = p.v + b * p.v_sb + h * p.v_sh;
  const float* dog = p.dout + b * p.do_sb + h * p.do_sh;

  load_tile<DH>(sQ, qg, p.q_sn, q0, p.nq, p.dh, p.copy_bytes);
  load_tile<DH>(sdO, dog, p.do_sn, q0, p.nq, p.dh, p.copy_bytes);
  load_tile<DH>(sKV0, kg, p.k_sn, 0, p.nkv, p.dh, p.copy_bytes);
  load_tile<DH>(sKV0 + TILE, vg, p.v_sn, 0, p.nkv, p.dh, p.copy_bytes);
  cp_async_commit();

  // lse (times log2(e)) and di of this thread's rows g and g + 8; 0 past nq
  float lse2[2], di[2];
  bool row_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + w16 + g + 8 * r;
    row_ok[r] = row < p.nq;
    lse2[r] = row_ok[r] ? p.lse[(long long)bh * p.nq + row] * LOG2E : 0.f;
    di[r] = row_ok[r] ? p.di[(long long)bh * p.nq + row] : 0.f;
  }

  float dq[KD][4];
#pragma unroll
  for (int n = 0; n < KD; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dq[n][i] = 0.f;

  for (int k0 = 0; k0 < p.nkv; k0 += BK) {
    const int st = (k0 / BK) & 1;
    const float* sK = sKV0 + 2 * st * TILE;
    const float* sV = sK + TILE;
    cp_async_wait_all();
    __syncthreads();  // this key tile landed; every warp is done with the previous one
    if (k0 + BK < p.nkv) {  // the next key tile under this one's products
      float* nK = sKV0 + 2 * (st ^ 1) * TILE;
      load_tile<DH>(nK, kg, p.k_sn, k0 + BK, p.nkv, p.dh, p.copy_bytes);
      load_tile<DH>(nK + TILE, vg, p.v_sn, k0 + BK, p.nkv, p.dh, p.copy_bytes);
      cp_async_commit();
    }
    if (!active) continue;
    const int kvalid = min(BK, p.nkv - k0);

    // s = q . k^T and dp = do . v^T
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = dp[nt][i] = 0.f;
    if (kvalid == BK) {
      mma3_abt<DH, NT, true>(s, sQ + w16 * S, sK, kvalid);
      mma3_abt<DH, NT, true>(dp, sdO + w16 * S, sV, kvalid);
    } else {
      mma3_abt<DH, NT, false>(s, sQ + w16 * S, sK, kvalid);
      mma3_abt<DH, NT, false>(dp, sdO + w16 * S, sV, kvalid);
    }

    // ds = p * (dp_v - di) * scale, in place of dp; p = 0 for keys past nkv, rows past nq
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        const int key = 8 * nt + c_col(i);
        const float pr = (key < kvalid && row_ok[r])
                             ? exp2_approx(fmaf(s[nt][i], scale_log2, -lse2[r]))
                             : 0.f;
        float dpv = dp[nt][i];
        if constexpr (DROPOUT) {
          const bool keep = ucf::dropout_keep(slice_key, p.row0 + q0 + w16 + c_row(i),
                                              p.col0 + k0 + key, p.threshold);
          dpv = keep ? dpv * p.inv_keep : 0.f;
        }
        dp[nt][i] = pr * (dpv - di[r]) * p.scale;
      }

    // dq += ds . k, this tile's part summed apart
    mma3_cb_add<DH, NT>(dq, dp, sK, kvalid, [](int, int, float x) { return x; });
  }

  if (!active) return;
  float* dqg = p.dq + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!row_ok[r]) continue;
    float* dqrow = dqg + (long long)(q0 + w16 + g + 8 * r) * p.dq_sn;
#pragma unroll
    for (int n = 0; n < KD; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = 8 * n + 2 * t + j;
        if (col < p.dh) dqrow[col] = dq[n][2 * r + j];
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
    return run(flash_bwd_dq_tf32_kernel<DH, DROPOUT>, dq_smem_bytes<DH>(),
               dim3(bh, (p.nq + BQ - 1) / BQ), p, stream);
  }
  const dim3 grid(bh, (p.nkv + BK - 1) / BK);
  if (kind == DKV) {
    return run(flash_bwd_tf32_kernel<DH, DROPOUT, false>, smem_bytes<DH, false>(), grid, p,
               stream);
  }
  return run(flash_bwd_tf32_kernel<DH, DROPOUT, true>, smem_bytes<DH, true>(), grid, p, stream);
}

template <bool DROPOUT>
cudaError_t dispatch_dh(int kind, const Params& p, int bh, cudaStream_t stream) {
  if (p.dh <= 48) return launch<48, DROPOUT>(kind, p, bh, stream);
  if (p.dh <= 64) return launch<64, DROPOUT>(kind, p, bh, stream);
  if (p.dh <= 96) return launch<96, DROPOUT>(kind, p, bh, stream);
  if (p.dh <= 128) return launch<128, DROPOUT>(kind, p, bh, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// kind: 0 = fused (dq is an f32 workspace the caller zeroed, 8-byte aligned with even
// strides), 1 = dkv (dq unused), 2 = dq (dq written; dk and dv unused). f32 q, k, v, do,
// dq, dk, dv; lse and di f32 [B*H, Nq]. Strides are in elements. dropout: 0 or 1; with 1
// the seed, threshold, (row0, col0) offset and inv_keep describe the forward's mask.
// Returns a cudaError_t.
extern "C" int ucf_flash_bwd_tf32(int kind, const void* q, const void* k, const void* v,
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
  // the fused kernel adds dq as float2s: an 8-byte aligned workspace with even strides
  if (kind == FUSED &&
      (reinterpret_cast<uintptr_t>(dq) % 8 != 0 || (dq_sb | dq_sh | dq_sn) % 2 != 0))
    return cudaErrorInvalidValue;
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.dout = static_cast<const float*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.di = static_cast<const float*>(di);
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
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
  p.copy_bytes = copy_bytes(in_ptrs, 4, in_strides, 12);
  const int bh = batch * heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dropout ? dispatch_dh<true>(kind, p, bh, s) : dispatch_dh<false>(kind, p, bh, s);
}
