// Fused transformer MLP for Hopper (sm_90a): y = gelu(x . W1 + b1) . W2 + b2 in one kernel,
// f32 in and out, f32 math on the CUDA cores. (bf16 takes csrc/fused_mlp_sm90.cu, on the
// tensor cores; the template below keeps its type parameter, instantiated for f32 only.)
//
// Replaces the Pallas TPU kernel `_fwd_kernel` (ucf_vit_tpu/ops/fused_mlp.py:55, launched by
// `_fwd_call` :63) for f32 inputs. It computes the same function: both products accumulate
// in f32, the bias add and the GELU (tanh form or erf form) run in f32, the hidden
// activation is rounded to the input type before the second product, and the result is
// cast to the input type. The hidden [M, H] never reaches device memory. There is no
// backward.
//
// Bound on the H100 at the ViT-B shape [M = 4112, D = 768, H = 3072]: 4 * M * D * H =
// 38.8 GFLOP against 22 MB (bf16) or 44 MB (f32) of inputs and output, so the work is bound
// by operations in both types: 0.58 ms at the CUDA cores' f32 rate (67 TFLOP/s), 0.235 ms
// as three TF32 products at the tensor cores' TF32 rate (495 TFLOP/s). This kernel runs
// at the f32 FMA rate.
//
// Design. The TPU kernel keeps W1 and W2 resident in VMEM and walks M tiles in order; an SM
// has 227 KB of shared memory, so here the weights are streamed and only the x tile stays:
//   - one block of 256 threads per 32-row tile of x; the tile sits in shared memory,
//     transposed ([D][32], f32), for the whole kernel;
//   - the block loops over H in chunks of 128 hidden units. Phase A: h = x_tile . W1[:, chunk]
//     with W1 streamed through shared memory in slices of 16 rows; + b1, GELU, round to the
//     input type, and the chunk is parked in shared memory, transposed ([128][32]).
//     Phase B: y += h_chunk . W2[chunk, :] with W2 streamed in slices of 4 rows; the
//     32 x D output tile lives in registers across all chunks (4 rows x D/32 columns per
//     thread: 128 accumulators at D = 1024, which is what limits D);
//   - the next weight slice is fetched into registers while the current one is multiplied
//     (the weights stay in the 50 MB L2: every block reads all of them);
//   - thread (ty, tx) of the 8 x 32 grid owns rows 4*ty .. 4*ty+3 and, per group of 128
//     columns, columns 4*tx .. 4*tx+3: both operands of the inner product are one 16-byte
//     shared load each (the 4 rows are a broadcast), for 16 FMAs;
//   - ragged M, D and H are masked in the loads (zeros) and the stores; nothing is padded
//     outside the kernel.
// Cost of the 32-row tile: M = 4112 gives 129 blocks, one wave of the 132 SMs, but a
// smaller M leaves SMs idle, and each block reads all of W1 and W2 from L2.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int BM = 32;        // rows of x per block
constexpr int THREADS = 256;  // 8 row groups x 32 column groups
constexpr int HC = 128;       // hidden units per chunk
constexpr int KS1 = 16;       // rows of W1 per slice
constexpr int KS2 = 4;        // rows of W2 per slice
constexpr int MAX_D = 1024;

struct Params {
  const void* x;    // [M, D]
  const void* w1;   // [D, H]
  const float* b1;  // [H]
  const void* w2;   // [H, D]
  const float* b2;  // [D]
  void* y;          // [M, D]
  int m, d, h;
  int approx;
};

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

__device__ __forceinline__ float gelu(float v, int approx) {
  if (approx) {
    const float u = 0.7978845608028654f * (v + 0.044715f * (v * v * v));
    return v * (0.5f * (1.f + tanhf(u)));
  }
  return 0.5f * v * (1.f + erff(v * 0.7071067811865476f));
}

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Shared memory, in floats: the x tile, one W1 slice, the hidden chunk, one W2 slice.
inline size_t smem_floats(int d, int nc) {
  return (size_t)round_up(d, KS1) * BM + KS1 * HC + HC * BM + KS2 * nc * 128;
}

// NC: groups of 128 output columns (D <= 128 * NC).
template <typename T, int NC>
__global__ void __launch_bounds__(THREADS) fused_mlp_kernel(const Params p) {
  constexpr int DP = NC * 128;              // padded output width
  constexpr int PRE1 = KS1 * HC / THREADS;  // W1 slice elements per thread (8)
  constexpr int PRE2 = KS2 * DP / THREADS;  // W2 slice elements per thread (2 * NC)
  extern __shared__ float smem[];
  const int dpad = round_up(p.d, KS1);
  float* sX = smem;               // [dpad][BM]
  float* sW1 = sX + dpad * BM;    // [KS1][HC]
  float* sH = sW1 + KS1 * HC;     // [HC][BM]
  float* sW2 = sH + HC * BM;      // [KS2][DP]

  const int tid = threadIdx.x;
  const int ty = tid >> 5;
  const int tx = tid & 31;
  const int m0 = blockIdx.x * BM;
  const T* xg = static_cast<const T*>(p.x);
  const T* w1g = static_cast<const T*>(p.w1);
  const T* w2g = static_cast<const T*>(p.w2);

  // the x tile, transposed, zeros past M and past D
  for (int idx = tid; idx < BM * dpad; idx += THREADS) {
    const int r = idx / dpad;
    const int dd = idx - r * dpad;
    const int row = m0 + r;
    float val = 0.f;
    if (row < p.m && dd < p.d) val = to_f32(xg[(long long)row * p.d + dd]);
    sX[dd * BM + r] = val;
  }

  float acc2[4][NC * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC * 4; ++c) acc2[i][c] = 0.f;

  for (int h0 = 0; h0 < p.h; h0 += HC) {
    // ---- phase A: the hidden chunk's pre-activation, 4 rows x 4 hidden units per thread
    float acc1[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc1[i][j] = 0.f;

    float pre1[PRE1];
    auto fetch1 = [&](int d0) {
#pragma unroll
      for (int i = 0; i < PRE1; ++i) {
        const int idx = tid + THREADS * i;
        const int gd = d0 + (idx >> 7);
        const int gh = h0 + (idx & (HC - 1));
        pre1[i] = (gd < p.d && gh < p.h) ? to_f32(w1g[(long long)gd * p.h + gh]) : 0.f;
      }
    };
    fetch1(0);
    for (int d0 = 0; d0 < dpad; d0 += KS1) {
      __syncthreads();  // the previous slice's readers are done (and sX is written)
#pragma unroll
      for (int i = 0; i < PRE1; ++i) sW1[tid + THREADS * i] = pre1[i];
      __syncthreads();
      if (d0 + KS1 < dpad) fetch1(d0 + KS1);
#pragma unroll
      for (int dd = 0; dd < KS1; ++dd) {
        const float4 xa = *reinterpret_cast<const float4*>(&sX[(d0 + dd) * BM + 4 * ty]);
        const float4 wb = *reinterpret_cast<const float4*>(&sW1[dd * HC + 4 * tx]);
        const float a[4] = {xa.x, xa.y, xa.z, xa.w};
        const float b[4] = {wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc1[i][j] = fmaf(a[i], b[j], acc1[i][j]);
      }
    }
    // + b1, GELU in f32, rounded to the input type; hidden units past H come out 0
    // (zero weights and bias), and the W2 rows they would meet are zero too. The last
    // readers of sH (the previous chunk's phase B) passed the barriers above.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = h0 + 4 * tx + j;
      const float bias = (col < p.h) ? p.b1[col] : 0.f;
      float4 g;
      g.x = to_f32(from_f32<T>(gelu(acc1[0][j] + bias, p.approx)));
      g.y = to_f32(from_f32<T>(gelu(acc1[1][j] + bias, p.approx)));
      g.z = to_f32(from_f32<T>(gelu(acc1[2][j] + bias, p.approx)));
      g.w = to_f32(from_f32<T>(gelu(acc1[3][j] + bias, p.approx)));
      *reinterpret_cast<float4*>(&sH[(4 * tx + j) * BM + 4 * ty]) = g;
    }

    // ---- phase B: y += h_chunk . W2[chunk, :]
    float pre2[PRE2];
    auto fetch2 = [&](int k0) {
#pragma unroll
      for (int i = 0; i < PRE2; ++i) {
        const int idx = tid + THREADS * i;
        const int kk = idx / DP;
        const int c = idx - kk * DP;
        const int gh = h0 + k0 + kk;
        pre2[i] = (gh < p.h && c < p.d) ? to_f32(w2g[(long long)gh * p.d + c]) : 0.f;
      }
    };
    fetch2(0);
    for (int k0 = 0; k0 < HC; k0 += KS2) {
      __syncthreads();  // the previous slice's readers are done (and sH is written)
#pragma unroll
      for (int i = 0; i < PRE2; ++i) sW2[tid + THREADS * i] = pre2[i];
      __syncthreads();
      if (k0 + KS2 < HC) fetch2(k0 + KS2);
#pragma unroll
      for (int kk = 0; kk < KS2; ++kk) {
        const float4 ha = *reinterpret_cast<const float4*>(&sH[(k0 + kk) * BM + 4 * ty]);
        const float a[4] = {ha.x, ha.y, ha.z, ha.w};
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 wb = *reinterpret_cast<const float4*>(&sW2[kk * DP + 128 * c + 4 * tx]);
          const float b[4] = {wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc2[i][4 * c + j] = fmaf(a[i], b[j], acc2[i][4 * c + j]);
        }
      }
    }
  }

  T* yg = static_cast<T*>(p.y);
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 128 * c + 4 * tx + j;
      if (col >= p.d) continue;
      const float bias = p.b2[col];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = m0 + 4 * ty + i;
        if (row < p.m) yg[(long long)row * p.d + col] = from_f32<T>(acc2[i][4 * c + j] + bias);
      }
    }
}

template <typename T, int NC>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(p.d, NC);
  cudaError_t err = cudaFuncSetAttribute(fused_mlp_kernel<T, NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (p.m + BM - 1) / BM;
  fused_mlp_kernel<T, NC><<<blocks, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const Params& p, cudaStream_t stream) {
  if (p.d <= 256) return launch<T, 2>(p, stream);
  if (p.d <= 512) return launch<T, 4>(p, stream);
  if (p.d <= 768) return launch<T, 6>(p, stream);
  if (p.d <= MAX_D) return launch<T, 8>(p, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32 (x, w1, w2, y, b1 and b2; 1, bfloat16, is refused: it goes to
// ucf_fused_mlp_sm90). All arrays are contiguous row-major. approx: 1 = tanh GELU, 0 = erf GELU. Returns a cudaError_t.
extern "C" int ucf_fused_mlp(const void* x, const void* w1, const void* b1, const void* w2,
                             const void* b2, void* y, int m, int d, int h, int dtype,
                             int approx, void* stream) {
  if (m <= 0 || d <= 0 || h <= 0 || d > MAX_D) return cudaErrorInvalidValue;
  Params p;
  p.x = x;
  p.w1 = w1;
  p.b1 = static_cast<const float*>(b1);
  p.w2 = w2;
  p.b2 = static_cast<const float*>(b2);
  p.y = y;
  p.m = m;
  p.d = d;
  p.h = h;
  p.approx = approx;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(p, s);
  return cudaErrorInvalidValue;
}
