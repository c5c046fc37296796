// Flash-attention backward in f32 on Hopper's tensor cores (sm_90a), f32-accurate by the
// 3xTF32 split of tf32x3.cuh on mma.sync: dq, dk and dv in one sweep.
//
// Replaces the Pallas TPU kernel `_bwd_fused_kernel` (ucf_vit_tpu/ops/flash_attention.py
// :249, launched by `_flash_bwd_len` :651, call :676) for f32 inputs; csrc/flash_bwd.cu
// keeps the split route's dkv and dq kernels (f32 FMA), flash_bwd_sm90.cu the bf16 ones.
// From (q, k, v, do, lse, di = rowsum(do * o)), for each (key tile, query tile):
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
//
// Design: one block of 4 warps per (batch*head, 64-key tile); warp w owns keys
// 16w .. 16w + 15. The k and v tiles stay in shared memory for the whole sweep (f32, row
// stride DH + 4); the block loops over 64-row query tiles of q, do, lse and di, whose
// next copies by cp.async run during the dq product. Per query tile and warp:
//   s^T (16 keys x 64 rows) = k . q^T and dp^T = v . do^T by the 3-pass product, k's and
//     v's A fragments split once per k-step and used for all eight 8-row tiles;
//   p^T = ex2(s^T * scale * log2(e) - lse * log2(e)) and ds^T = p^T * (dp_v^T - di) * scale
//     in registers, in the C fragment layout;
//   dv += p_v^T . do and dk += ds^T . q with the A fragment straight from those registers
//     (c_to_a) and do and q read through the permuted B index; each query tile's part is
//     summed apart and added by f32 adds (mma3_cb_add: the tensor cores' accumulation does
//     not round to nearest, and carried over N = 32768 rows it drifted by 3e-4); dk and dv
//     stay in f32 registers for the whole sweep and are written once;
//   ds^T goes to shared memory as ds [row][key], and after a barrier warp w computes
//     dq = ds . k for query rows 16w .. 16w + 15 over the block's 64 keys and adds it into
//     the zeroed f32 workspace [B*H, Nq, dh] with float2 atomics (sm_90). The order of
//     those sums changes from run to run. The workspace's rows are padded to a multiple of
//     4 floats (ops/flash_attention.py: _dq_workspace), so every pair is whole.
// Warps whose keys (or query rows, for dq) are all out of range, and 8-row or 8-key tiles
// all out of range, skip their products. The head dim is padded inside to DH (48, 64, 96
// or 128): zeros past dh from cp.async's zero fill, stores past dh skipped. Inputs and
// outputs go through (batch, head, row) strides with the last dim contiguous.

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

enum Kernel { FUSED = 0 };

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  const float* lse;
  const float* di;
  float* dq;  // the zeroed f32 workspace
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

template <int DH>
constexpr size_t smem_bytes() {
  // sK, sV, sQ, sdO with row stride DH + 4; sdS with row stride BK + 4; lse and di
  return sizeof(float) * ((size_t)4 * 64 * (DH + 4) + BQ * (BK + 4) + 2 * BQ);
}

// The block counts an SM must hold (shared memory allows them at DH <= 64) cap the
// registers.
template <int DH, bool DROPOUT>
__global__ void __launch_bounds__(THREADS, DH <= 64 ? 2 : 1)
    flash_bwd_tf32_kernel(const Params p) {
  constexpr int S = DH + 4;   // shared row stride (floats)
  constexpr int DS = BK + 4;  // sdS's row stride
  constexpr int KD = DH / 8;  // k-steps of k . q^T and v . do^T; n-tiles of dk, dv and dq
  constexpr int NT = BQ / 8;  // 8-row tiles of s^T; k-steps of dv and dk
  constexpr int NK = BK / 8;  // k-steps of dq
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = sK + BK * S;
  float* sQ = sV + BK * S;
  float* sdO = sQ + BQ * S;
  float* sdS = sdO + BQ * S;  // ds [query row][key]
  float* sLse = sdS + BQ * DS;
  float* sDi = sLse + BQ;

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

  load_tile<DH>(sK, kg, p.k_sn, k0, p.nkv, p.dh, p.copy_bytes);
  load_tile<DH>(sV, vg, p.v_sn, k0, p.nkv, p.dh, p.copy_bytes);
  load_tile<DH>(sQ, qg, p.q_sn, 0, p.nq, p.dh, p.copy_bytes);
  load_tile<DH>(sdO, dog, p.do_sn, 0, p.nq, p.dh, p.copy_bytes);
  load_row_stats(sLse, lseg, 0, p.nq, 0);
  load_row_stats(sDi, dig, 0, p.nq, 64);
  cp_async_commit();

  float dk[KD][4], dv[KD][4];
#pragma unroll
  for (int n = 0; n < KD; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[n][i] = dv[n][i] = 0.f;

  for (int q0 = 0; q0 < p.nq; q0 += BQ) {
    cp_async_wait_all();
    __syncthreads();  // this query tile landed
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

      // ds [row][key] for the dq product
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) sdS[(8 * nt + c_col(i)) * DS + w16 + c_row(i)] = dst[nt][i];
    }
    __syncthreads();  // ds visible; every warp is done with sQ, sdO, sLse and sDi

    if (q0 + BQ < p.nq) {
      load_tile<DH>(sQ, qg, p.q_sn, q0 + BQ, p.nq, p.dh, p.copy_bytes);
      load_tile<DH>(sdO, dog, p.do_sn, q0 + BQ, p.nq, p.dh, p.copy_bytes);
      load_row_stats(sLse, lseg, q0 + BQ, p.nq, 0);
      load_row_stats(sDi, dig, q0 + BQ, p.nq, 64);
      cp_async_commit();
    }

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
cudaError_t launch(const Params& p, int bh, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_tf32_kernel<DH, DROPOUT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (p.nkv + BK - 1) / BK);
  flash_bwd_tf32_kernel<DH, DROPOUT><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool DROPOUT>
cudaError_t dispatch_dh(const Params& p, int bh, cudaStream_t stream) {
  if (p.dh <= 48) return launch<48, DROPOUT>(p, bh, stream);
  if (p.dh <= 64) return launch<64, DROPOUT>(p, bh, stream);
  if (p.dh <= 96) return launch<96, DROPOUT>(p, bh, stream);
  if (p.dh <= 128) return launch<128, DROPOUT>(p, bh, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// kind: 0 = fused, the only kind here (dq is an f32 workspace the caller zeroed, 8-byte
// aligned with even strides). f32 q, k, v, do, dk, dv; lse and di f32 [B*H, Nq]. Strides
// are in elements. dropout: 0 or 1; with 1 the seed, threshold, (row0, col0) offset and
// inv_keep describe the forward's mask. Returns a cudaError_t.
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
  if (kind != FUSED) return cudaErrorInvalidValue;
  if ((nkv + BK - 1) / BK > 65535) return cudaErrorInvalidValue;
  // dq is added as float2s: an 8-byte aligned workspace with even strides
  if (reinterpret_cast<uintptr_t>(dq) % 8 != 0 || (dq_sb | dq_sh | dq_sn) % 2 != 0)
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
  return dropout ? dispatch_dh<true>(p, bh, s) : dispatch_dh<false>(p, bh, s);
}
