// W8A8 int8 GEMM with the activation quantized inside the kernel, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` (ucf_vit_tpu/ops/int8_gemm.py:61, launched by
// `int8_matmul` :81). It computes the same function, per row of x over the FULL K:
//   scale = max(max|x|, 1e-8) / 127           (f32, IEEE division; bf16 x lifted to f32)
//   xq    = clip(round_half_even(x / scale), -127, 127) as int8
//   acc   = xq . w_i8                          (int32, exact)
//   y     = (float)acc * scale * wscale[n]     (in that order), cast to the output type.
// The quantized activation never reaches device memory. Integer accumulation is exact and
// the float steps are the plain version's own, one rounding each, so the f32 output equals
// `int8_matmul_plain` bit for bit. This file must be built WITHOUT -use_fast_math: the
// quantization needs IEEE division and rintf.
//
// Bound on the H100 at [M = 4112, K = 768] x [768, 3072], bf16 in and out: 19.4 GOP over the
// int8 tensor-core rate (1,979 TOP/s) is 0.0098 ms; the bytes (6.3 MB of x, 2.4 MB of
// weights, 25.3 MB of y) over 3.35 TB/s are 0.0101 ms. This kernel multiplies with `__dp4a`
// on the CUDA cores, far below the tensor-core rate.
//
// Design: one block of 256 threads per (32-row tile of x, 128-column tile of w), as the
// TPU grid has one step per (M tile, N tile).
//   - Quantization: each warp takes 4 of the tile's rows; per row the lanes reduce max|x|
//     over all of K with shuffles, then quantize the row into shared memory as int8,
//     row-major, four k to a 32-bit word. Every N tile recomputes the quantization of its
//     rows from the full K, as the TPU kernel does, so all N tiles see the same xq.
//   - Product: K is walked in slices of 32. `w_i8 [K, N]` is row-major in N, and `__dp4a`
//     wants four consecutive k in one word: each thread loads 4 bytes (4 columns) from each
//     of 4 consecutive rows and transposes the 4 x 4 bytes in registers (`__byte_perm`)
//     into one word per column, stored to shared memory as [k/4][128 columns]. The next
//     slice is fetched into registers while the current one is multiplied.
//   - Thread (ty, tx) of the 8 x 32 grid owns rows 4*ty .. 4*ty+3 and columns 4*tx .. 4*tx+3:
//     per word of k, four broadcast loads of x words and one 16-byte load of w words feed
//     16 `__dp4a`.
//   - Ragged M and K are masked (zeros); N must be a multiple of 4 (the 4-byte weight
//     loads), and K is limited by the quantized tile in shared memory (32 x K bytes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int BM = 32;         // rows per block
constexpr int BN = 128;        // columns per block
constexpr int THREADS = 256;   // 8 row groups x 32 column groups
constexpr int KS = 32;         // k per slice of the weights (8 words)
constexpr int MAX_K = 6144;    // 32 x 6144 bytes of xq + one weight slice < 227 KB

struct Params {
  const void* x;        // [M, K] f32 or bf16
  const int8_t* w;      // [K, N] int8
  const float* wscale;  // [N]
  void* y;              // [M, N] f32 or bf16
  int m, k, n;
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

inline int k_words(int k) { return (k + KS - 1) / KS * (KS / 4); }  // words per row, padded

inline size_t smem_bytes(int k) {
  return sizeof(int) * ((size_t)BM * k_words(k) + (KS / 4) * BN) + sizeof(float) * BM;
}

template <typename TX, typename TO>
__global__ void __launch_bounds__(THREADS) int8_gemm_kernel(const Params p) {
  extern __shared__ int smem_i[];
  const int kw = (p.k + KS - 1) / KS * (KS / 4);
  int* sX = smem_i;                                        // [BM][kw] words of 4 int8
  int* sW = sX + BM * kw;                                  // [KS / 4][BN] words of 4 int8
  float* sScale = reinterpret_cast<float*>(sW + (KS / 4) * BN);  // [BM]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const TX* xg = static_cast<const TX*>(p.x);

  // ---- quantize the tile's rows over the full K
  for (int r = warp; r < BM; r += THREADS / 32) {
    const int row = m0 + r;
    int* dst = sX + r * kw;
    if (row >= p.m) {
      for (int w = lane; w < kw; w += 32) dst[w] = 0;
      if (lane == 0) sScale[r] = 0.f;
      continue;
    }
    const TX* xr = xg + (long long)row * p.k;
    float amax = 0.f;
    for (int k = lane; k < p.k; k += 32) amax = fmaxf(amax, fabsf(to_f32(xr[k])));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float scale = fmaxf(amax, 1e-8f) / 127.0f;
    if (lane == 0) sScale[r] = scale;
    for (int w = lane; w < kw; w += 32) {
      uint32_t word = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = 4 * w + i;
        int q = 0;
        if (k < p.k) {
          const float v = rintf(to_f32(xr[k]) / scale);
          q = (int)fminf(fmaxf(v, -127.f), 127.f);
        }
        word |= ((uint32_t)q & 0xffu) << (8 * i);
      }
      dst[w] = (int)word;
    }
  }

  // ---- the product, K in slices of 32
  const int ty = tid >> 5;  // rows 4*ty .. 4*ty+3
  const int tx = tid & 31;  // columns 4*tx .. 4*tx+3
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  // this thread's share of a weight slice: word row `ty` (k = k0 + 4*ty .. +3), columns
  // n0 + 4*tx .. +3, as four 4-byte loads, one per k
  uint32_t pre[4];
  const int col = n0 + 4 * tx;
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + 4 * ty + i;
      pre[i] = (k < p.k && col < p.n)
                   ? *reinterpret_cast<const uint32_t*>(p.w + (long long)k * p.n + col)
                   : 0u;
    }
  };
  fetch(0);
  for (int k0 = 0; k0 < p.k; k0 += KS) {
    __syncthreads();  // the previous slice's readers are done (and sX, sScale are written)
    {
      // bytes (row i, column j) -> one word per column j holding rows 0..3
      const uint32_t t0 = __byte_perm(pre[0], pre[1], 0x5140);
      const uint32_t t1 = __byte_perm(pre[0], pre[1], 0x7362);
      const uint32_t t2 = __byte_perm(pre[2], pre[3], 0x5140);
      const uint32_t t3 = __byte_perm(pre[2], pre[3], 0x7362);
      int4 cols;
      cols.x = (int)__byte_perm(t0, t2, 0x5410);
      cols.y = (int)__byte_perm(t0, t2, 0x7632);
      cols.z = (int)__byte_perm(t1, t3, 0x5410);
      cols.w = (int)__byte_perm(t1, t3, 0x7632);
      *reinterpret_cast<int4*>(&sW[ty * BN + 4 * tx]) = cols;
    }
    __syncthreads();
    if (k0 + KS < p.k) fetch(k0 + KS);
    const int w0 = k0 / 4;
#pragma unroll
    for (int kq = 0; kq < KS / 4; ++kq) {
      const int4 wv = *reinterpret_cast<const int4*>(&sW[kq * BN + 4 * tx]);
      const int b[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int a = sX[(4 * ty + i) * kw + w0 + kq];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a, b[j], acc[i][j]);
      }
    }
  }

  TO* yg = static_cast<TO*>(p.y);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = col + j;
    if (c >= p.n) continue;
    const float ws = p.wscale[c];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + 4 * ty + i;
      if (row < p.m)
        yg[(long long)row * p.n + c] = from_f32<TO>((float)acc[i][j] * sScale[4 * ty + i] * ws);
    }
  }
}

template <typename TX, typename TO>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.k);
  cudaError_t err = cudaFuncSetAttribute(int8_gemm_kernel<TX, TO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.m + BM - 1) / BM, (p.n + BN - 1) / BN);
  int8_gemm_kernel<TX, TO><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// x_dtype, out_dtype: 0 = float32, 1 = bfloat16. All arrays are contiguous row-major; w is
// 4-byte aligned and n a multiple of 4. Returns a cudaError_t.
extern "C" int ucf_int8_gemm(const void* x, const void* w, const void* wscale, void* y, int m,
                             int k, int n, int x_dtype, int out_dtype, void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || k > MAX_K || n % 4 != 0) return cudaErrorInvalidValue;
  if ((n + BN - 1) / BN > 65535) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(w) % 4 != 0) return cudaErrorInvalidValue;
  Params p;
  p.x = x;
  p.w = static_cast<const int8_t*>(w);
  p.wscale = static_cast<const float*>(wscale);
  p.y = y;
  p.m = m;
  p.k = k;
  p.n = n;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && out_dtype == 0) return launch<float, float>(p, s);
  if (x_dtype == 0 && out_dtype == 1) return launch<float, __nv_bfloat16>(p, s);
  if (x_dtype == 1 && out_dtype == 0) return launch<__nv_bfloat16, float>(p, s);
  if (x_dtype == 1 && out_dtype == 1) return launch<__nv_bfloat16, __nv_bfloat16>(p, s);
  return cudaErrorInvalidValue;
}
