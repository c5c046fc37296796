// Flash-attention backward for Hopper (sm_90a) on the CUDA cores, f32 math: the kernels of
// the split route.
//
// Two kernels, each computing what its Pallas TPU kernel computes
// (ucf_vit_tpu/ops/flash_attention.py, launched by `_flash_bwd_len` :651):
//   flash_bwd_dkv    <- `_bwd_dkv_kernel`   :162 (call :719): dk and dv;
//   flash_bwd_dq     <- `_bwd_dq_kernel`    :362 (call :758): dq.
// dkv takes f32 here; its bf16 instance is the tensor-core kernel of flash_bwd_sm90.cu.
// dq takes f32 and bf16 (the bf16 split route's second kernel). The fused route
// (`_bwd_fused_kernel` :249, call :676) runs on the tensor cores: flash_bwd_tf32.cu for
// f32, flash_bwd_sm90.cu for bf16.
// From (q, k, v, do, lse, di = rowsum(do * o)), for each (query tile, key tile):
//   s = (q . k^T) * scale, keys >= nkv masked with -0.7 * FLT_MAX,   p = exp(s - lse)
//   p_v = keep ? p / (1 - rate) : 0          (the forward's dropped probabilities)
//   dp  = keep ? (do . v^T) / (1 - rate) : 0
//   ds  = p * (dp - di) * scale
//   dv += p_v^T . do,   dk += ds^T . q,   dq += ds . k
// The keep mask is the counter hash of attn_dropout.cuh at global coordinates, so it is the
// forward's mask although the tiles differ; with rate 0 (a template flag) it compiles away.
//
// Bound on the H100 at the training shape [B*H = 192, N = 257, dh = 64]: the five products
// are 10 * 192 * 257^2 * 64 = 8.12 GFLOP. In f32 that is bound by the CUDA cores' f32 rate
// (about 0.121 ms at 67 TFLOP/s; the 89 MB of inputs and outputs take 0.027 ms). These
// kernels do every product in f32 FMA out of shared memory, so the bf16 dq kernel runs at
// the f32 compute rate too.
//
// Design. 256 threads as a 16 x 16 grid (ty, tx); 64-row query tiles and 64-key tiles,
// each staged in shared memory as f32 with an odd row stride (dh padded to DH + 1) so
// that 16 threads reading 16 rows at one column hit 16 banks. For a tile pair, thread
// (ty, tx) computes s and dp for query rows 4ty..4ty+3 and keys tx + 16j, turns them into
// p_v and ds in registers and writes both to shared memory; the three products that
// follow read them back transposed or not as each needs.
// - dkv: one block per (batch*head, key tile). The block loops over all query tiles,
//   keeping dk and dv for its 64 keys in registers (thread: keys 4ty..4ty+3, head
//   columns tx + 16c), and writes them once at the end.
// - dq: one block per (batch*head, query tile), looping over the key tiles with dq in
//   registers; no atomics. With dkv it recomputes s and dp once more than a fused kernel.
// dh is padded inside to DH (48, 64, 96 or 128): loads beyond dh read zero and stores
// beyond dh are skipped. Rows past Nq get p = 0 and keys past Nkv the mask value, so the
// caller pads nothing; a trailing partial key tile is handled like any other.
// Inputs and outputs are read and written through (batch, head, row) strides; the last
// dim must be contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <type_traits>

#include "attn_dropout.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int ROWS = 4;     // rows per thread
constexpr int PS = BK + 4;  // row stride of the p_v and ds tiles (16-byte aligned rows)
constexpr float MASK_VALUE = -0.7f * FLT_MAX;

enum Kernel { FUSED = 0, DKV = 1, DQ = 2 };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* di;
  void* dq;  // the dq kernel's output (type T)
  void* dk;
  void* dv;
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
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Copy rows [row0, row0 + BQ) of one (batch, head) slice into a shared tile of row stride
// DH + 1, as f32, with zeros past `nrows` and past `dh`.
template <typename T, int DH>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long sn, int row0,
                                          int nrows, int dh) {
  for (int idx = threadIdx.x; idx < BQ * DH; idx += THREADS) {
    const int r = idx / DH;
    const int d = idx - r * DH;
    const int row = row0 + r;
    float val = 0.f;
    if (row < nrows && d < dh) val = to_f32(src[(long long)row * sn + d]);
    dst[r * (DH + 1) + d] = val;
  }
}

// lse and di of this thread's four query rows of the tile at q0 (zeros past Nq).
__device__ __forceinline__ void load_row_stats(const Params& p, int bh, int q0, int ty,
                                               float lse[ROWS], float di[ROWS]) {
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int row = q0 + ty * ROWS + i;
    const bool ok = row < p.nq;
    lse[i] = ok ? p.lse[(long long)bh * p.nq + row] : 0.f;
    di[i] = ok ? p.di[(long long)bh * p.nq + row] : 0.f;
  }
}

// For the tile pair (q0, k0), with the query and key tiles staged in shared memory, compute
// this thread's p_v and ds (rows 4ty + i, keys tx + 16j) and store them into sPv and sdS
// (sPv may be null when the caller needs only ds).
template <int DH, bool DROPOUT>
__device__ __forceinline__ void tile_pv_ds(const Params& p, const float* sQ, const float* sdO,
                                           const float* sK, const float* sV, float* sPv,
                                           float* sdS, int q0, int k0, uint32_t slice_key,
                                           const float lse[ROWS], const float di[ROWS]) {
  constexpr int QS = DH + 1;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  float s[ROWS][4], dp[ROWS][4];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;

#pragma unroll 4
  for (int d = 0; d < DH; ++d) {
    float a[ROWS], g[ROWS], bk[4], bv[4];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      a[i] = sQ[(ty * ROWS + i) * QS + d];
      g[i] = sdO[(ty * ROWS + i) * QS + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bk[j] = sK[(tx + 16 * j) * QS + d];
      bv[j] = sV[(tx + 16 * j) * QS + d];
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i], bk[j], s[i][j]);
        dp[i][j] = fmaf(g[i], bv[j], dp[i][j]);
      }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = ty * ROWS + i;
    const bool row_ok = q0 + r < p.nq;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const float sv = (k0 + c < p.nkv) ? s[i][j] * p.scale : MASK_VALUE;
      const float pr = row_ok ? expf(sv - lse[i]) : 0.f;
      float pv = pr, dpv = dp[i][j];
      if constexpr (DROPOUT) {
        const bool keep =
            ucf::dropout_keep(slice_key, p.row0 + q0 + r, p.col0 + k0 + c, p.threshold);
        pv = keep ? pr * p.inv_keep : 0.f;
        dpv = keep ? dpv * p.inv_keep : 0.f;
      }
      if (sPv != nullptr) sPv[r * PS + c] = pv;
      sdS[r * PS + c] = pr * (dpv - di[i]) * p.scale;
    }
  }
}

template <int DH>
constexpr size_t smem_bytes(int kind) {
  // sQ, sdO, sK, sV with row stride DH + 1; sPv (not for dq) and sdS with row stride PS
  return sizeof(float) *
         (size_t)(4 * BQ * (DH + 1) + (kind == DQ ? 1 : 2) * BQ * PS);
}

// dkv: one block per (batch*head, 64-key tile).
template <typename T, int DH, bool DROPOUT>
__global__ void __launch_bounds__(THREADS) flash_bwd_kv_kernel(const Params p) {
  constexpr int QS = DH + 1;
  constexpr int NC = DH / 16;  // head columns per thread
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = sK + BK * QS;
  float* sQ = sV + BK * QS;
  float* sdO = sQ + BQ * QS;
  float* sPv = sdO + BQ * QS;
  float* sdS = sPv + BQ * PS;

  const int bh = blockIdx.x;
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  const int k0 = blockIdx.y * BK;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const uint32_t slice_key = ucf::dropout_slice_key(p.seed, (uint32_t)bh);

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dog = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;

  load_tile<T, DH>(sK, kg, p.k_sn, k0, p.nkv, p.dh);
  load_tile<T, DH>(sV, vg, p.v_sn, k0, p.nkv, p.dh);

  float dk[ROWS][NC], dv[ROWS][NC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int q0 = 0; q0 < p.nq; q0 += BQ) {
    __syncthreads();  // the previous tile's readers are done with sQ, sdO, sPv and sdS
    load_tile<T, DH>(sQ, qg, p.q_sn, q0, p.nq, p.dh);
    load_tile<T, DH>(sdO, dog, p.do_sn, q0, p.nq, p.dh);
    float lse[ROWS], di[ROWS];
    load_row_stats(p, bh, q0, ty, lse, di);
    __syncthreads();

    tile_pv_ds<DH, DROPOUT>(p, sQ, sdO, sK, sV, sPv, sdS, q0, k0, slice_key, lse, di);
    __syncthreads();

    // dv += p_v^T . do and dk += ds^T . q, for keys 4ty + i and head columns tx + 16c
#pragma unroll 4
    for (int r = 0; r < BQ; ++r) {
      const float4 pa = *reinterpret_cast<const float4*>(&sPv[r * PS + ty * ROWS]);
      const float4 da = *reinterpret_cast<const float4*>(&sdS[r * PS + ty * ROWS]);
      const float pv[ROWS] = {pa.x, pa.y, pa.z, pa.w};
      const float ds[ROWS] = {da.x, da.y, da.z, da.w};
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float go = sdO[r * QS + tx + 16 * c];
        const float qq = sQ[r * QS + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          dv[i][c] = fmaf(pv[i], go, dv[i][c]);
          dk[i][c] = fmaf(ds[i], qq, dk[i][c]);
        }
      }
    }
  }

  T* dkg = static_cast<T*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  T* dvg = static_cast<T*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int row = k0 + ty * ROWS + i;
    if (row >= p.nkv) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < p.dh) {
        dkg[(long long)row * p.dk_sn + col] = from_f32<T>(dk[i][c]);
        dvg[(long long)row * p.dv_sn + col] = from_f32<T>(dv[i][c]);
      }
    }
  }
}

// dq: one block per (batch*head, 64-row query tile).
template <typename T, int DH, bool DROPOUT>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(const Params p) {
  constexpr int QS = DH + 1;
  constexpr int NC = DH / 16;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sdO = sQ + BQ * QS;
  float* sK = sdO + BQ * QS;
  float* sV = sK + BK * QS;
  float* sdS = sV + BK * QS;

  const int bh = blockIdx.x;
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  const int q0 = blockIdx.y * BQ;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const uint32_t slice_key = ucf::dropout_slice_key(p.seed, (uint32_t)bh);

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dog = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;

  load_tile<T, DH>(sQ, qg, p.q_sn, q0, p.nq, p.dh);
  load_tile<T, DH>(sdO, dog, p.do_sn, q0, p.nq, p.dh);
  float lse[ROWS], di[ROWS];
  load_row_stats(p, bh, q0, ty, lse, di);

  float acc[ROWS][NC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 < p.nkv; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done with sK, sV and sdS
    load_tile<T, DH>(sK, kg, p.k_sn, k0, p.nkv, p.dh);
    load_tile<T, DH>(sV, vg, p.v_sn, k0, p.nkv, p.dh);
    __syncthreads();

    tile_pv_ds<DH, DROPOUT>(p, sQ, sdO, sK, sV, nullptr, sdS, q0, k0, slice_key, lse, di);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float a[ROWS], kv[NC];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) a[i] = sdS[(ty * ROWS + i) * PS + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) kv[c] = sK[kk * QS + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(a[i], kv[c], acc[i][c]);
    }
  }

  T* dqg = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int row = q0 + ty * ROWS + i;
    if (row >= p.nq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < p.dh) dqg[(long long)row * p.dq_sn + col] = from_f32<T>(acc[i][c]);
    }
  }
}

template <typename F>
cudaError_t launch_kernel(F kernel, size_t smem, dim3 grid, const Params& p,
                          cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int DH, bool DROPOUT>
cudaError_t launch(int kind, const Params& p, int bh, cudaStream_t stream) {
  const size_t smem = smem_bytes<DH>(kind);
  if (kind == FUSED) return cudaErrorInvalidValue;  // f32: flash_bwd_tf32.cu; bf16: sm90
  if (kind == DKV) {
    if constexpr (std::is_same<T, float>::value) {
      return launch_kernel(flash_bwd_kv_kernel<T, DH, DROPOUT>, smem,
                           dim3(bh, (p.nkv + BK - 1) / BK), p, stream);
    }
    return cudaErrorInvalidValue;  // bf16 dkv: flash_bwd_sm90.cu
  }
  return launch_kernel(flash_bwd_dq_kernel<T, DH, DROPOUT>, smem,
                       dim3(bh, (p.nq + BQ - 1) / BQ), p, stream);
}

template <typename T, bool DROPOUT>
cudaError_t dispatch_dh(int kind, const Params& p, int bh, cudaStream_t stream) {
  if (p.dh <= 48) return launch<T, 48, DROPOUT>(kind, p, bh, stream);
  if (p.dh <= 64) return launch<T, 64, DROPOUT>(kind, p, bh, stream);
  if (p.dh <= 96) return launch<T, 96, DROPOUT>(kind, p, bh, stream);
  if (p.dh <= 128) return launch<T, 128, DROPOUT>(kind, p, bh, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// kind: 1 = dkv (dq unused), 2 = dq (dk and dv unused); 0 (fused) is refused: it runs in
// flash_bwd_tf32.cu and flash_bwd_sm90.cu. dtype: 0 = float32, 1 = bfloat16 (dq only). lse and di are f32
// [B*H, Nq]. Strides are in elements. dropout: 0 or 1; with 1 the seed, threshold,
// (row0, col0) offset and inv_keep describe the forward's mask. Returns a cudaError_t.
extern "C" int ucf_flash_bwd(int kind, const void* q, const void* k, const void* v,
                             const void* dout, const void* lse, const void* di, void* dq,
                             void* dk, void* dv, int batch, int heads, int nq, int nkv, int dh,
                             long long q_sb, long long q_sh, long long q_sn,
                             long long k_sb, long long k_sh, long long k_sn,
                             long long v_sb, long long v_sh, long long v_sn,
                             long long do_sb, long long do_sh, long long do_sn,
                             long long dq_sb, long long dq_sh, long long dq_sn,
                             long long dk_sb, long long dk_sh, long long dk_sn,
                             long long dv_sb, long long dv_sh, long long dv_sn,
                             float scale, int dtype, int dropout, unsigned int seed,
                             unsigned int threshold, int row0, int col0, float inv_keep,
                             void* stream) {
  if (batch <= 0 || heads <= 0 || nq <= 0 || nkv <= 0 || dh <= 0) return cudaErrorInvalidValue;
  if (kind < FUSED || kind > DQ) return cudaErrorInvalidValue;
  const int tiles = kind == DQ ? (nq + BQ - 1) / BQ : (nkv + BK - 1) / BK;
  if (tiles > 65535) return cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.di = static_cast<const float*>(di);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
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
  const int bh = batch * heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dropout ? dispatch_dh<float, true>(kind, p, bh, s)
                   : dispatch_dh<float, false>(kind, p, bh, s);
  }
  if (dtype == 1) {
    return dropout ? dispatch_dh<__nv_bfloat16, true>(kind, p, bh, s)
                   : dispatch_dh<__nv_bfloat16, false>(kind, p, bh, s);
  }
  return cudaErrorInvalidValue;
}
