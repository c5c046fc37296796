// Flash-attention forward for Hopper (sm_90a) in f32, on the CUDA cores.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` (ucf_vit_tpu/ops/flash_attention.py:68,
// launched by `_flash_fwd_len` :543) for f32 inputs; bf16 inputs go to the tensor-core
// kernel of flash_fwd_sm90.cu. It computes the same function:
//   s = (q . k^T) * scale, keys >= nkv masked with -0.7 * FLT_MAX (not -inf),
//   online softmax with the running max m, normaliser l and output accumulator in f32,
//   o = acc / l (l == 0 guarded), lse = m + log(max(l, 1e-37)).
// lse is written as [B*H, Nq] f32, not the TPU's 128-lane layout.
// With dropout (a template flag, so the rate-0 kernel has none of it) the probabilities
// are dropped AFTER the l update, as `_fwd_kernel` does (:124-136): l and lse stay the
// pre-dropout values and o = dropout(softmax) . v. The keep mask is the counter hash of
// attn_dropout.cuh at global (bh, row0 + row, col0 + col).
//
// Bound on the H100 at the serving shape [B*H = 192, N = 257, dh = 64]: 3.25 GFLOP.
// The inputs and output are 50.5 MB, so the work is bound by the f32 rate of the CUDA
// cores (67 TFLOP/s, about 48 us), not by memory. (The tensor cores' f32 path is TF32,
// which keeps about three decimal digits: not the f32 that the port holds to JAX.)
//
// Design: one block of 256 threads per (batch*head, 64-row query tile). The query
// tile stays in shared memory; 64-key tiles of K and V are staged in shared memory
// one after the other. Thread (ty, tx) of the 16 x 16 grid owns rows 4*ty .. 4*ty+3
// and, of the score tile, columns tx + 16*j; of the output, columns tx + 16*c. The 16
// threads of one row group sit in one half-warp, so the row max and row sum are
// shuffle reductions. The head dim is padded inside the kernel to DH (48, 64, 96 or
// 128): loads beyond dh read zero and stores beyond dh are skipped. Query rows past
// Nq and key rows past Nkv are handled by the same masking, so the caller pads
// nothing. Inputs are read through (batch, head, row) strides, so q, k and v may be
// views into one packed qkv projection; the last dim must be contiguous.

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstdint>

#include "attn_dropout.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int ROWS = 4;           // query rows per thread
constexpr int PS = BK + 4;        // row stride of the probability tile (no bank conflicts)
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
};

template <int DH>
constexpr size_t smem_bytes() {
  // Q and K tiles use an odd row stride (DH + 1) so that 16 threads reading 16
  // different rows at one column hit 16 different banks.
  return sizeof(float) * (size_t)(BQ * (DH + 1) + BK * (DH + 1) + BK * DH + BQ * PS);
}

// Copy rows [row0, row0 + rows) of one (batch, head) slice into a shared tile of
// row stride `stride`, with zeros past `nrows` and past `dh`.
template <int DH>
__device__ __forceinline__ void load_tile(float* dst, int stride, const float* src, long long sn,
                                          int row0, int nrows, int dh, int rows) {
  for (int idx = threadIdx.x; idx < rows * DH; idx += THREADS) {
    const int r = idx / DH;
    const int d = idx - r * DH;
    const int row = row0 + r;
    float val = 0.f;
    if (row < nrows && d < dh) val = src[(long long)row * sn + d];
    dst[r * stride + d] = val;
  }
}

template <int DH, bool DROPOUT>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(const Params p) {
  constexpr int QS = DH + 1;
  constexpr int NC = DH / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * QS;
  float* sV = sK + BK * QS;
  float* sP = sV + BK * DH;

  const int bh = blockIdx.x;
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  const int q0 = blockIdx.y * BQ;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;

  const float* qg = p.q + b * p.q_sb + h * p.q_sh;
  const float* kg = p.k + b * p.k_sb + h * p.k_sh;
  const float* vg = p.v + b * p.v_sb + h * p.v_sh;
  float* og = p.o + b * p.o_sb + h * p.o_sh;
  const uint32_t slice_key = ucf::dropout_slice_key(p.seed, (uint32_t)bh);

  load_tile<DH>(sQ, QS, qg, p.q_sn, q0, p.nq, p.dh, BQ);

  float m_run[ROWS], l_run[ROWS], acc[ROWS][NC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < p.nkv; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done with sK, sV and sP
    load_tile<DH>(sK, QS, kg, p.k_sn, k0, p.nkv, p.dh, BK);
    load_tile<DH>(sV, DH, vg, p.v_sn, k0, p.nkv, p.dh, BK);
    __syncthreads();

    float s[ROWS][4];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;

#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float a[ROWS], bk[4];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) a[i] = sQ[(ty * ROWS + i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = sK[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

    const int kvalid = p.nkv - k0;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = (tx + 16 * j < kvalid) ? s[i][j] * p.scale : MASK_VALUE;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off, 16));
      const float m_next = fmaxf(m_run[i], mx);
      const float alpha = expf(m_run[i] - m_next);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_next);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off, 16);
      l_run[i] = alpha * l_run[i] + rs;
      m_run[i] = m_next;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
      if constexpr (DROPOUT) {
        const int row = p.row0 + q0 + ty * ROWS + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool keep =
              ucf::dropout_keep(slice_key, row, p.col0 + k0 + tx + 16 * j, p.threshold);
          s[i][j] = keep ? s[i][j] * p.inv_keep : 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) sP[(ty * ROWS + i) * PS + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float pr[ROWS], vv[NC];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) pr[i] = sP[(ty * ROWS + i) * PS + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = sV[kk * DH + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pr[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int row = q0 + ty * ROWS + i;
    if (row >= p.nq) continue;
    const float l_inv = (l_run[i] == 0.f) ? 1.f : 1.f / l_run[i];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < p.dh) og[(long long)row * p.o_sn + col] = acc[i][c] * l_inv;
    }
    if (tx == 0) p.lse[(long long)bh * p.nq + row] = m_run[i] + logf(fmaxf(l_run[i], 1e-37f));
  }
}

template <int DH, bool DROPOUT>
cudaError_t launch(const Params& p, int bh, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<DH, DROPOUT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (p.nq + BQ - 1) / BQ);
  flash_fwd_kernel<DH, DROPOUT><<<grid, THREADS, smem, stream>>>(p);
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
extern "C" int ucf_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                             int batch, int heads, int nq, int nkv, int dh,
                             long long q_sb, long long q_sh, long long q_sn,
                             long long k_sb, long long k_sh, long long k_sn,
                             long long v_sb, long long v_sh, long long v_sn,
                             long long o_sb, long long o_sh, long long o_sn,
                             float scale, int dropout, unsigned int seed,
                             unsigned int threshold, int row0, int col0, float inv_keep,
                             void* stream) {
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
  const int bh = batch * heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dropout ? dispatch_dh<true>(p, bh, s) : dispatch_dh<false>(p, bh, s);
}
