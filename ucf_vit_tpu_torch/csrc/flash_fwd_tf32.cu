// Flash-attention forward in f32 on Hopper's tensor cores (sm_90a), f32-accurate by the
// 3xTF32 split of tf32x3.cuh on mma.sync.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` (ucf_vit_tpu/ops/flash_attention.py:68,
// launched by `_flash_fwd_len` :543, call :561) for f32 inputs; bf16 inputs go to the
// wgmma kernel of flash_fwd_sm90.cu. It computes the same function:
//   s = (q . k^T) * scale, keys >= nkv masked with -0.7 * FLT_MAX (not -inf),
//   online softmax with the running max m, normaliser l and output accumulator in f32,
//   o = acc / l (l == 0 guarded), lse = m + log(max(l, 1e-37)).
// lse is written as [B*H, Nq] f32, not the TPU's 128-lane layout. With dropout (a
// template flag, so the rate-0 kernel has none of it) the probabilities are dropped
// AFTER the l update, as `_fwd_kernel` does (:124-136): l and lse stay the pre-dropout
// values and o = dropout(softmax) . v. The keep mask is the counter hash of
// attn_dropout.cuh at global (bh, row0 + row, col0 + col).
//
// Bound on the H100 at the serving shape [B*H = 192, N = 257, dh = 64]: the two products
// are 3.25 GFLOP, and an f32-accurate product costs three TF32 ones, so 3 * 3.25 GFLOP at
// the dense TF32 rate (495 TFLOP/s) is 0.0197 ms; the 50.5 MB of inputs and outputs take
// 0.0151 ms at 3.35 TB/s. Bound by operations.
//
// Design: one block of 4 warps per (batch*head, 64-row query tile); warp w owns query rows
// 16w .. 16w + 15. The q tile and one 64-key tile each of k and v sit in shared memory
// (f32, row stride DH + 4), filled by cp.async: v's copy runs while s = q . k^T is
// computed, the next k tile's while o += p . v is. Per key tile and warp:
//   s (16 x 64) = q . k^T by the 3-pass product, q's A fragment split once per k-step and
//     used for all eight 8-key tiles;
//   the online softmax on the C fragment in the log2 domain (scale * log2(e) folded into
//     one multiply, ex2.approx), the row max and row sum by two shuffles among the four
//     lanes of a row;
//   o (16 x DH) = alpha * o + p . v with p's C fragment as the A fragment (c_to_a), split
//     in registers, and v read through the permuted B index; the tile's p . v is summed
//     apart and added by f32 multiply-adds (the tensor cores' accumulation does not round to
//     nearest, so a sum carried over many tiles in it drifts: tf32x3.cuh, mma3_cb_add).
// Warps whose rows are all past nq, and 8-key tiles all past nkv, skip their products.
// The head dim is padded inside to DH (48, 64, 96 or 128): zeros past dh from cp.async's
// zero fill, stores past dh skipped. Inputs are read through (batch, head, row) strides, so
// q, k and v may be views into one packed qkv projection; the last dim must be contiguous.

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
constexpr float MASK_VALUE = -0.7f * FLT_MAX;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* lse;
  int heads, nq, nkv, dh;
  long long q_sb, q_sh, q_sn;
  long long k_sb, k_sh, k_sn;
  long long v_sb, v_sh, v_sn;
  long long o_sb, o_sh, o_sn;
  float scale;
  // dropout: keep where hash >= threshold, survivors scaled by inv_keep = 1 / (1 - rate)
  uint32_t seed, threshold;
  int row0, col0;
  float inv_keep;
  int copy_bytes;  // cp.async width for q, k and v: 16 or 4
};

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(BQ + 2 * BK) * (DH + 4);
}

// The block counts an SM must hold (shared memory allows them at DH <= 64) cap the
// registers.
template <int DH, bool DROPOUT>
__global__ void __launch_bounds__(THREADS, DH <= 64 ? 4 : 2)
    flash_fwd_tf32_kernel(const Params p) {
  constexpr int S = DH + 4;  // shared row stride (floats)
  constexpr int KD = DH / 8;  // k-steps of q . k^T, n-tiles of p . v
  constexpr int NT = BK / 8;  // 8-key tiles of s
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * S;
  float* sV = sK + BK * S;

  const int bh = blockIdx.x;
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  const int q0 = blockIdx.y * BQ;
  const int r0 = (threadIdx.x >> 5) * 16;  // this warp's first row in the tile
  const int g = lane_g();
  const int t = lane_t();
  const bool active = q0 + r0 < p.nq;

  const float* qg = p.q + b * p.q_sb + h * p.q_sh;
  const float* kg = p.k + b * p.k_sb + h * p.k_sh;
  const float* vg = p.v + b * p.v_sb + h * p.v_sh;
  const uint32_t slice_key = ucf::dropout_slice_key(p.seed, (uint32_t)bh);
  const float scale_log2 = p.scale * LOG2E;

  load_tile<DH>(sQ, qg, p.q_sn, q0, p.nq, p.dh, p.copy_bytes);
  load_tile<DH>(sK, kg, p.k_sn, 0, p.nkv, p.dh, p.copy_bytes);
  cp_async_commit();

  float o[KD][4];
#pragma unroll
  for (int n = 0; n < KD; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, log2 domain
  float l_run[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < p.nkv; k0 += BK) {
    cp_async_wait_all();
    __syncthreads();  // k (and q) landed; every warp is done reading sV
    load_tile<DH>(sV, vg, p.v_sn, k0, p.nkv, p.dh, p.copy_bytes);
    cp_async_commit();
    const int kvalid = min(BK, p.nkv - k0);

    float s[NT][4];
    float alpha[2] = {1.f, 1.f};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
    if (active) {
      if (kvalid == BK) {
        mma3_abt<DH, NT, true>(s, sQ + r0 * S, sK, kvalid);
      } else {
        mma3_abt<DH, NT, false>(s, sQ + r0 * S, sK, kvalid);
      }

      // online softmax, log2 domain: x = s * scale * log2(e)
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x = (8 * nt + c_col(i) < kvalid) ? s[nt][i] * scale_log2 : MASK_VALUE;
          s[nt][i] = x;
          mx[i >> 1] = fmaxf(mx[i >> 1], x);
        }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = exp2_approx(m_run[r] - mx[r]);
        m_run[r] = mx[r];
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[nt][i] = exp2_approx(s[nt][i] - m_run[i >> 1]);
          rs[i >> 1] += s[nt][i];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
        l_run[r] = alpha[r] * l_run[r] + rs[r];
      }
      if constexpr (DROPOUT) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const bool keep = ucf::dropout_keep(slice_key, p.row0 + q0 + r0 + c_row(i),
                                                p.col0 + k0 + 8 * nt + c_col(i), p.threshold);
            s[nt][i] = keep ? s[nt][i] * p.inv_keep : 0.f;
          }
      }
    }

    cp_async_wait_all();
    __syncthreads();  // v landed; every warp is done reading sK
    if (k0 + BK < p.nkv) {
      load_tile<DH>(sK, kg, p.k_sn, k0 + BK, p.nkv, p.dh, p.copy_bytes);
      cp_async_commit();
    }
    if (active) {
      float part[KD][4];
#pragma unroll
      for (int n = 0; n < KD; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[n][i] = 0.f;
      mma3_cb<DH, NT>(part, s, sV, kvalid, [](int, int, float x) { return x; });  // p . v
#pragma unroll
      for (int n = 0; n < KD; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) o[n][i] = fmaf(o[n][i], alpha[i >> 1], part[n][i]);
    }
  }

  if (!active) return;
  float* og = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + g + 8 * r;
    if (row >= p.nq) continue;
    const float l_inv = (l_run[r] == 0.f) ? 1.f : 1.f / l_run[r];
#pragma unroll
    for (int n = 0; n < KD; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = 8 * n + 2 * t + j;
        if (col < p.dh) og[(long long)row * p.o_sn + col] = o[n][2 * r + j] * l_inv;
      }
    if (t == 0) {
      p.lse[(long long)bh * p.nq + row] = m_run[r] * LN2 + logf(fmaxf(l_run[r], 1e-37f));
    }
  }
}

template <int DH, bool DROPOUT>
cudaError_t launch(const Params& p, int bh, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_tf32_kernel<DH, DROPOUT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (p.nq + BQ - 1) / BQ);
  flash_fwd_tf32_kernel<DH, DROPOUT><<<grid, THREADS, smem, stream>>>(p);
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

// f32 q, k, v, o and lse [B*H, Nq]. Strides are in elements. dropout: 0 or 1; with 1 the
// seed, threshold, (row0, col0) offset and inv_keep describe the mask. Returns a cudaError_t.
extern "C" int ucf_flash_fwd_tf32(const void* q, const void* k, const void* v, void* o,
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
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
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
  p.copy_bytes = copy_bytes(in_ptrs, 3, in_strides, 9);
  const int bh = batch * heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dropout ? dispatch_dh<true>(p, bh, s) : dispatch_dh<false>(p, bh, s);
}
