// W8A8 int8 GEMM for Hopper (sm_90a): a pass that quantizes the rows of x and turns the
// weights K-major, then the int8 product on the tensor cores (wgmma m64n256k32.s32.s8.s8)
// fed by TMA.
//
// Replaces the Pallas TPU kernel `_kernel` (ucf_vit_tpu/ops/int8_gemm.py:61, launched by
// `int8_matmul` :81). It computes the same function, per row of x over the FULL K:
//   scale = max(max|x|, 1e-8) / 127           (f32, IEEE division; bf16 x lifted to f32)
//   xq    = clip(round_half_even(x / scale), -127, 127) as int8
//   acc   = xq . w_i8                          (int32, exact)
//   y     = (float)acc * scale * wscale[n]     (in that order), cast to the output type.
// Integer accumulation is exact and the float steps are the plain version's own, one
// rounding each, so the output equals `int8_matmul_plain` bit for bit. This file must be
// built WITHOUT -use_fast_math: the quantization needs IEEE division and rintf.
//
// Bound on the H100 at [M = 4112, K = 768] x [768, 3072], bf16 in and out: 19.4 GOP over the
// int8 tensor-core rate (1,979 TOP/s) is 0.0098 ms; the bytes (6.3 MB of x, 2.4 MB of
// weights, 25.3 MB of y) over 3.35 TB/s are 0.0101 ms.
//
// Design: two kernels on the caller's stream.
// - int8_prepare quantizes x and turns the weights K-major, in one launch.
//   * x: 1 to 8 warps a row, as many as read the row in one batch of 4 16-byte chunks a
//     thread (every K in bf16, K <= 4096 in f32), their maxima met in shared memory. The
//     row stays in registers as loaded (4 registers a chunk: 40 a thread, 6 blocks an
//     SM) and gives xq into an int8 workspace [M, Kp] (Kp = K rounded up to the 128-byte
//     K slice, zeros past K: TMA rows of a multiple of 16 bytes) and the row's scale into
//     an f32 [M]. x / scale is taken as x * (1 / scale), and by the IEEE division only
//     where that product lies within 2e-5 of a half-integer: elsewhere both round to the
//     same integer (see `quantize`). Quantizing inside the GEMM would repeat each row's
//     max and its K divisions once per 256-column tile (12 times at N = 3072), and a
//     128-row tile of xq at K = 3072 (384 KB) fits no shared memory.
//   * w_i8 [K, N]: wgmma takes 8-bit operands only K-major (A and B alike), and w_i8 is
//     N-major. A share of every block's threads each loads 4 k-rows x 16 columns (16-byte
//     loads where N % 16 == 0, else 4-byte), transposes the 4 x 4 byte blocks with
//     __byte_perm into one word (4 k) a column, and writes them into an int8 workspace
//     wt [N, Kp] (zeros past K), consecutive lanes on consecutive words of a row: 2.4 MB
//     read and 2.4 MB written at ViT-B's fc1. The first design of this kernel turned each
//     weight slice K-major inside the GEMM instead, in shared memory, by a producer
//     warpgroup: that put about 940 cycles of shuffling between a stage's arrival and its
//     products, and 0.0065 ms into the GEMM's 0.0310 at [4112, 768] x 3072 (an NVIDIA
//     H100 80GB HBM3 at 700 W, tools/int8_study.py on that design); the pass here adds
//     about 0.0012 ms to the quantization's 0.0054 (the same tool).
// - int8_gemm_kernel: a persistent grid (one block an SM) walks 128 x 256 output tiles,
//   M fastest, so that the blocks in flight share weight tiles in L2. Two consumer
//   warpgroups and one producer warp share a ring of NS stages, each 128 bytes of K:
//   16 KB of xq and 32 KB of wt, loaded by TMA from tensor maps with the 128-byte swizzle
//   (the panel layout of sm90.cuh, K-major for both operands) and counted on the stage's
//   full mbarrier; the consumers release a stage on its empty one.
//   * The producer warp's first thread issues the loads of stage g as soon as the
//     consumers have released stage g - NS.
//   * Each consumer warpgroup takes 64 rows of the tile: four m64n256k32 products a stage
//     into 128 int32 accumulator registers a thread, a stage released once its products
//     are done (wgmma_wait<1>). The tile's row scales and wscale are loaded before its
//     products; wscale goes through shared memory (one entry a consumer thread). At the
//     tile's end the warpgroup rescales into the output type and, where a row of y is a
//     multiple of 16 bytes, writes 64 rows x 128 bytes at a time into two swizzled staging
//     buffers of its own in turn, each copied out by a TMA store (rows past M and columns
//     past N are not written) while the warpgroup fills the other; else it stores from
//     registers.
//   * What bounds it (tools/int8_study.py's trace of one block at [4112, 768] x 3072): a
//     stage every ~1,090 cycles, near the int8 tensor cores' rate, and ~3,800 cycles of
//     epilogue a tile in which the tensor cores idle (both warpgroups rescale at once;
//     starting one a stage or two behind the other did not help). At K = 768 the
//     epilogue is a third of the time, at K = 3072 an eighth.
//   * Shared memory: 4 stages x 48 KB = 192 KB, 32 KB of staging, 1 KB of wscale.
//   * A wait on an mbarrier that has not completed after about 2^32 cycles (2-3 s) traps:
//     a deadlock surfaces as a failed launch, not a hung card.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "sm90.cuh"

namespace {

using namespace ucf::sm90;

constexpr int MAX_K = 6144;
constexpr int KS = 128;                  // bytes of K a stage: one swizzled 128-byte row
constexpr int BM = 128;                  // rows of a tile: two consumer warpgroups of 64
constexpr int BN = 256;                  // columns of a tile: one m64n256k32 product a k-step
constexpr int NS = 4;                    // ring stages
constexpr uint32_t A_STAGE = BM * KS;    // 16 KB of xq
constexpr uint32_t B_STAGE = BN * KS;    // 32 KB of wt
constexpr int THREADS = 288;             // two consumer warpgroups, then the producer warp
constexpr uint32_t OUT_CHUNK = 64 * 128;  // a consumer warpgroup's staged output: 64 rows x 128 B
constexpr int PREP_THREADS = 256;        // int8_prepare's block
constexpr int QU = 4;                    // 16-byte chunks a lane has in flight in a row
constexpr long long WAIT_LIMIT = 1ll << 32;  // cycles
constexpr size_t SMEM =
    NS * (A_STAGE + B_STAGE) + 4 * OUT_CHUNK + BN * 4 + 8 * 2 * NS + 1024;

// ------------------------------------------------------------------ the first kernel

template <typename TX>
__host__ __device__ constexpr int vec() {  // elements in 16 bytes
  return 16 / (int)sizeof(TX);
}

__device__ __forceinline__ void unpack(const uint4 u, float (&v)[4]) {  // 4 f32
  v[0] = __uint_as_float(u.x);
  v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z);
  v[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void unpack(const uint4 u, float (&v)[8]) {  // 8 bf16, exact
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t bits(float x) { return __float_as_uint(x); }
__device__ __forceinline__ uint32_t bits(__nv_bfloat16 x) { return __bfloat16_as_ushort(x); }

// Elements [V c, V c + V) of row `xr` as they are in memory (16 bytes), zeros past k.
// `vec_ok`: k % V == 0 and x is 16-byte aligned, so a chunk is one 16-byte load. Kept so,
// and unpacked where used, a chunk takes 4 registers instead of V.
template <typename TX>
__device__ __forceinline__ uint4 load_chunk(const TX* xr, int c, int k, bool vec_ok) {
  constexpr int V = vec<TX>();
  const int k0 = V * c;
  if (vec_ok && k0 < k) return __ldg(reinterpret_cast<const uint4*>(xr + k0));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < V; ++i)
    if (k0 + i < k) w[i / (V / 4)] |= bits(xr[k0 + i]) << (32 / (V / 4) * (i % (V / 4)));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// round_half_even(v / s), as the plain version takes it from an IEEE division, in the low
// byte of the returned bits (two's complement). t = v * inv (inv = 1 / s, rounded) differs
// from v / s by at most |v / s| 2^-23 < 1.6e-5, and the IEEE quotient from v / s by half an
// ulp, < 3.9e-6. So where t lies more than 2e-5 from every half-integer, t and the quotient
// round to the same integer; nearer, the division decides (about 4 in 100,000 elements).
// t + 1.5 * 2^23 rounds t to an integer, ties to even, as rintf does (|t| < 2^22), and
// leaves it in the low bits. No clip: |v| <= max|x| and s = max / 127 rounded give
// |v / s| <= 127 (1 + 2^-24) and |t| <= 127 (1 + 3 2^-24), which round to at most 127, so
// the plain version's clip to +-127 never acts either.
__device__ __forceinline__ uint32_t quantize(float v, float s, float inv) {
  constexpr float MAGIC = 12582912.0f;
  const float t = v * inv;
  float f = t + MAGIC;
  if (fabsf(t - (f - MAGIC)) > 0.5f - 2e-5f) f = rintf(v / s) + MAGIC;
  return __float_as_uint(f);
}

// Rows of x quantized into xq and their scales, `rw` warps a row (1, 2, 4 or 8; a block
// takes 8 / rw rows). Every thread of the block must call it: the row's warps meet at a
// __syncthreads for its max.
template <typename TX>
__device__ __forceinline__ void quantize_rows(const TX* x, int8_t* xq, float* scale, int m,
                                              int k, int kp, bool vec_ok, int rw, int qblock) {
  constexpr int V = vec<TX>();
  __shared__ float part[PREP_THREADS / 32];  // each warp's max
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = qblock * (PREP_THREADS / 32 / rw) + warp / rw;
  const int nt = 32 * rw;                     // threads of the row
  const int tid = 32 * (warp % rw) + lane;    // this one among them
  const bool live = row < m;
  const TX* xr = x + (long long)row * k;
  // QU chunks a thread at a time, all loaded before any is used: with enough warps a row
  // (rw), the row is read in one such batch and stays in `raw` for the quantization
  uint4 raw[QU];
  float v[V];
  float amax = 0.f;
  for (int c = tid; live && V * c < k; c += nt * QU) {
#pragma unroll
    for (int u = 0; u < QU; ++u) raw[u] = load_chunk(xr, c + nt * u, k, vec_ok);
#pragma unroll
    for (int u = 0; u < QU; ++u) {
      unpack(raw[u], v);
#pragma unroll
      for (int i = 0; i < V; ++i) amax = fmaxf(amax, fabsf(v[i]));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if (lane == 0) part[warp] = amax;
  __syncthreads();
  for (int w = warp - warp % rw; w < warp - warp % rw + rw; ++w) amax = fmaxf(amax, part[w]);
  if (!live) return;
  const float s = fmaxf(amax, 1e-8f) / 127.0f;
  const float inv = 1.0f / s;
  if (tid == 0) scale[row] = s;
  int8_t* qr = xq + (long long)row * kp;
  // a row read in one batch (kp <= nt QU V) is still in `raw`, where the first loop ran
  // for this thread
  const bool held = kp <= nt * QU * V && V * tid < k;
  for (int c = tid; V * c < kp; c += nt * QU) {  // past k: zeros, which quantize to 0
    if (!held) {
#pragma unroll
      for (int u = 0; u < QU; ++u) raw[u] = load_chunk(xr, c + nt * u, k, vec_ok);
    }
#pragma unroll
    for (int u = 0; u < QU; ++u) {
      const int k0 = V * (c + nt * u);
      if (k0 >= kp) break;
      unpack(raw[u], v);
      uint32_t word[V / 4];
#pragma unroll
      for (int i = 0; i < V; i += 4) {  // the low bytes of four quantized values, in order
        const uint32_t lo = __byte_perm(quantize(v[i], s, inv), quantize(v[i + 1], s, inv), 0x0040);
        const uint32_t hi = __byte_perm(quantize(v[i + 2], s, inv), quantize(v[i + 3], s, inv),
                                        0x0040);
        word[i / 4] = __byte_perm(lo, hi, 0x5410);
      }
      if constexpr (V == 8) {
        *reinterpret_cast<uint2*>(qr + k0) = make_uint2(word[0], word[1]);
      } else {
        *reinterpret_cast<uint32_t*>(qr + k0) = word[0];
      }
    }
  }
}

// w [k, n] (row-major) -> wt [n, kp]: transposing thread t takes k-quad t % (kp / 4) of the
// 16 columns 16 (t / (kp / 4)) ..; w16: n % 16 == 0 and w 16-byte aligned.
__device__ __forceinline__ void transpose_block(const int8_t* w, int8_t* wt, int k, int n,
                                                int kp, bool w16, long long t) {
  const int quads = kp / 4;
  const int j = (int)(t % quads);
  const long long col = t / quads * 16;
  if (col >= n) return;
  uint32_t rw[4][4];  // [k-row i][word e]: columns col + 4 e .. + 3
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = 4 * j + i;
    const int8_t* src = w + (long long)kr * n + col;
    if (kr < k && w16) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(src));
      rw[i][0] = u.x;
      rw[i][1] = u.y;
      rw[i][2] = u.z;
      rw[i][3] = u.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        rw[i][e] = kr < k && col + 4 * e < n ? __ldg(reinterpret_cast<const uint32_t*>(src + 4 * e))
                                             : 0u;
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    // the 4 x 4 bytes (k-row i, column c) -> one word per column holding rows 0..3
    const uint32_t t0 = __byte_perm(rw[0][e], rw[1][e], 0x5140);
    const uint32_t t1 = __byte_perm(rw[0][e], rw[1][e], 0x7362);
    const uint32_t t2 = __byte_perm(rw[2][e], rw[3][e], 0x5140);
    const uint32_t t3 = __byte_perm(rw[2][e], rw[3][e], 0x7362);
    const uint32_t cols[4] = {__byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
                              __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632)};
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (col + 4 * e + c < n)
        *reinterpret_cast<uint32_t*>(wt + (col + 4 * e + c) * kp + 4 * j) = cols[c];
  }
}

// Where w is given, the first `share` threads of every block turn their part of it
// K-major into wt (`transpose_block`); then blocks [0, qblocks) quantize rows of x, rw
// warps a row (`quantize_rows`). One kind of block, so that the launch is one wave where
// the quantization alone is.
template <typename TX>
__global__ void __launch_bounds__(PREP_THREADS)
    int8_prepare(const TX* x, int8_t* xq, float* scale, int m, int k, int kp, int vec_ok,
                 int rw, int qblocks, const int8_t* w, int8_t* wt, int n, int w16, int share) {
  if (w != nullptr && (int)threadIdx.x < share)
    transpose_block(w, wt, k, n, kp, w16, (long long)blockIdx.x * share + threadIdx.x);
  if ((int)blockIdx.x < qblocks)
    quantize_rows(x, xq, scale, m, k, kp, vec_ok, rw, (int)blockIdx.x);
}

// ------------------------------------------------------------------ the product

struct GemmParams {
  const float* wscale;  // [n]
  const float* scale;   // [m], from int8_prepare
  void* y;              // [m, n] f32 or bf16
  int m, n;
  int m_tiles, tiles, k_stages;  // ceil(m / BM), m_tiles * ceil(n / BN), kp / KS
};

template <typename T>
__device__ __forceinline__ void store_pair(T* p, float a, float b);
template <>
__device__ __forceinline__ void store_pair<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store_pair<__nv_bfloat16>(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The same pair into shared memory at `addr`.
__device__ __forceinline__ void st_shared_pair(uint32_t addr, float a, float b, float) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(a), "f"(b) : "memory");
}
__device__ __forceinline__ void st_shared_pair(uint32_t addr, float a, float b, __nv_bfloat16) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(pack_bf16(a, b)) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// mbar_wait that traps instead of spinning forever.
__device__ __forceinline__ void wait_bar(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > WAIT_LIMIT) __trap();
}

// TMA_Y: y leaves by TMA stores from shared memory (rows of y a multiple of 16 bytes).
template <typename TO, bool TMA_Y>
__global__ void __launch_bounds__(THREADS, 1)
    int8_gemm_kernel(const __grid_constant__ CUtensorMap tm_xq,
                     const __grid_constant__ CUtensorMap tm_wt,
                     const __grid_constant__ CUtensorMap tm_y, const GemmParams p) {
  extern __shared__ uint8_t smem[];
  const uint32_t base = aligned_smem_base(smem);
  const uint32_t sA = base;                   // NS x A_STAGE
  const uint32_t sB = sA + NS * A_STAGE;      // NS x B_STAGE
  const uint32_t sOut = sB + NS * B_STAGE;    // 2 x 2 x OUT_CHUNK: two a consumer warpgroup
  const uint32_t sWs = sOut + 4 * OUT_CHUNK;  // BN floats: the tile's wscale
  const uint32_t full = sWs + BN * 4;         // NS barriers: a stage's TMA bytes,
  const uint32_t empty = full + 8 * NS;       // and its release by the 8 consumer warps
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp == 8) {
    // ---------------------------------------------------------------- the producer
    if (lane != 0) return;
    const int my_tiles = (p.tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
    for (int g = 0; g < my_tiles * p.k_stages; ++g) {
      const int s = g % NS;
      if (g >= NS) wait_bar(empty + 8 * s, ((g / NS) - 1) & 1);
      const int tile = (int)blockIdx.x + (g / p.k_stages) * (int)gridDim.x;
      const int k0 = (g % p.k_stages) * KS;
      mbar_arrive_expect_tx(full + 8 * s, A_STAGE + B_STAGE);
      tma_load_4d(sA + s * A_STAGE, &tm_xq, full + 8 * s, k0, (tile % p.m_tiles) * BM, 0, 0);
      tma_load_4d(sB + s * B_STAGE, &tm_wt, full + 8 * s, k0, (tile / p.m_tiles) * BN, 0, 0);
    }
    return;
  }
  // ---------------------------------------------------------------- the consumers
  const int cw = warp >> 2;                     // rows 64 cw .. 64 cw + 63 of the tile
  const int r = 16 * (warp & 3) + (lane >> 2);  // this thread's rows: r, r + 8
  const int cq = 2 * (lane & 3);                // and columns 8 c + cq + {0, 1}
  const int ct = threadIdx.x;                   // 0 .. 255: this thread's wscale entry
  const int wtid = ct - 128 * cw;               // 0 .. 127 in the warpgroup
  const uint32_t out = sOut + cw * 2 * OUT_CHUNK;
  int acc[128];
  int g = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    // the tile's scales, loaded before its products so that their latency hides behind
    // them
    const int m0 = (tile % p.m_tiles) * BM + 64 * cw;
    const int row0 = m0 + r;
    const int col0 = (tile / p.m_tiles) * BN;
    const bool ok[2] = {row0 < p.m, row0 + 8 < p.m};
    const float sc[2] = {ok[0] ? p.scale[row0] : 0.f, ok[1] ? p.scale[row0 + 8] : 0.f};
    const float ws_mine = col0 + ct < p.n ? p.wscale[col0 + ct] : 0.f;
#pragma unroll
    for (int x = 0; x < 128; ++x) acc[x] = 0;
    for (int kq = 0; kq < p.k_stages; ++kq, ++g) {
      const int s = g % NS;
      wait_bar(full + 8 * s, (g / NS) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KS / 32; ++kk)
        wgmma_ss_wide_s8(acc, make_desc(sA + s * A_STAGE + cw * (A_STAGE / 2) + 32 * kk),
                         make_desc(sB + s * B_STAGE + 32 * kk));
      wgmma_commit();
      wgmma_wait<1>();  // stage g - 1's products are done
      if (kq > 0 && lane == 0) mbar_arrive(empty + 8 * ((g - 1) % NS));
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(empty + 8 * ((g - 1) % NS));

    // wscale through shared memory: each consumer thread stores one entry, once both
    // warpgroups have read the last tile's (and the last tile's stores have read the
    // staging buffers)
    const uint32_t wbuf = sWs;
    if (TMA_Y && wtid == 0) bulk_wait<0, true>();
    named_bar_sync(1, 256);
    asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(wbuf + 4 * ct), "f"(ws_mine) : "memory");
    named_bar_sync(1, 256);
    // (float)acc * scale * wscale, two roundings, as the plain version
    auto value = [&](int c, int i, int jj, float ws) {
      return __int2float_rn(acc[4 * c + 2 * i + jj]) * sc[i] * ws;
    };
    if constexpr (TMA_Y) {
      // CC columns (128 bytes) at a time through this warpgroup's two staging buffers in
      // turn: row rr at 128 rr, its 16-byte chunk at (chunk ^ (rr % 8)) * 16 (the map's
      // swizzle)
      constexpr int CC = 128 / (int)sizeof(TO);
#pragma unroll
      for (int hc = 0; hc < BN / CC; ++hc) {
        const uint32_t buf = out + (hc & 1) * OUT_CHUNK;
#pragma unroll
        for (int cc = 0; cc < CC / 8; ++cc) {
          const int c = hc * (CC / 8) + cc;
          float ws[2];
          asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
                       : "=f"(ws[0]), "=f"(ws[1])
                       : "r"(wbuf + 4 * (8 * c + cq))
                       : "memory");
          const int b = (8 * cc + cq) * (int)sizeof(TO);  // byte of the pair in its row
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int rr = r + 8 * i;
            st_shared_pair(buf + rr * 128 + ((((b >> 4) ^ (rr & 7)) << 4) | (b & 15)),
                           value(c, i, 0, ws[0]), value(c, i, 1, ws[1]), TO());
          }
        }
        fence_proxy_async();  // the TMA store reads what these threads wrote
        // chunk hc + 1 goes into the other buffer: the store of chunk hc - 1 has read it
        if (wtid == 0) bulk_wait<0, true>();
        named_bar_sync(2 + cw, 128);
        if (wtid == 0) {
          tma_store_4d(&tm_y, buf, col0 + hc * CC, m0, 0, 0);
          bulk_commit();
        }
      }
    } else {
      TO* y = static_cast<TO*>(p.y);
#pragma unroll
      for (int c = 0; c < BN / 8; ++c) {
        const int col = col0 + 8 * c + cq;  // col + 1 < n too (both even, n % 4 == 0)
        if (col >= p.n) continue;
        float ws[2];
        asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
                     : "=f"(ws[0]), "=f"(ws[1])
                     : "r"(wbuf + 4 * (8 * c + cq))
                     : "memory");
#pragma unroll
        for (int i = 0; i < 2; ++i)
          if (ok[i])
            store_pair<TO>(y + (long long)(row0 + 8 * i) * p.n + col, value(c, i, 0, ws[0]),
                           value(c, i, 1, ws[1]));
      }
    }
  }
  if constexpr (TMA_Y) {
    if (wtid == 0) bulk_wait<0, false>();  // the stores are done before the block leaves
  }
}

template <typename TX>
cudaError_t launch_prepare(const void* x, void* xq, void* scale, int m, int k, int kp,
                           const void* w, void* wt, int n, cudaStream_t stream) {
  const int vec_ok = k % vec<TX>() == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int w16 = n % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  // warps a row: as few as read it in one batch of QU chunks a thread, at most a block's
  int rw = 1;
  while (rw < PREP_THREADS / 32 && 32 * rw * QU * vec<TX>() < kp) rw *= 2;
  const int rows = PREP_THREADS / 32 / rw;  // a block's
  const long long qblocks = (m + rows - 1) / rows;
  // the transposition's threads (a 4 x 16 block each), spread over the blocks
  const long long units = w == nullptr ? 0 : (long long)(kp / 4) * ((n + 15) / 16);
  const long long tblocks = (units + PREP_THREADS - 1) / PREP_THREADS;
  const long long blocks = qblocks > tblocks ? qblocks : tblocks;
  if (blocks > 0x7FFFFFFF) return cudaErrorInvalidValue;
  const int share = (int)((units + blocks - 1) / blocks);
  int8_prepare<TX><<<(unsigned)blocks, PREP_THREADS, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<int8_t*>(xq), static_cast<float*>(scale), m, k, kp,
      vec_ok, rw, (int)qblocks, static_cast<const int8_t*>(w), static_cast<int8_t*>(wt), n, w16,
      share);
  return cudaGetLastError();
}

template <typename TO, bool TMA_Y>
cudaError_t launch_gemm(const CUtensorMap& txq, const CUtensorMap& twt, const CUtensorMap& ty,
                        const GemmParams& p, int grid, cudaStream_t stream) {
  static const cudaError_t setup = cudaFuncSetAttribute(
      int8_gemm_kernel<TO, TMA_Y>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (setup != cudaSuccess) return setup;
  int8_gemm_kernel<TO, TMA_Y><<<grid, THREADS, SMEM, stream>>>(txq, twt, ty, p);
  return cudaGetLastError();
}

inline int k_padded(int k) { return (k + KS - 1) / KS * KS; }

}  // namespace

// The first kernel: x [m, k] (x_dtype 0 = float32, 1 = bfloat16, contiguous) -> xq [m, kp]
// int8 (kp = k rounded up to 128, zeros past k; 16-byte aligned) and scale [m] f32; and,
// where w is given, w [k, n] int8 (row-major, 4-byte aligned, n % 4 == 0) -> wt [n, kp]
// int8, K-major, zeros past k. Returns a cudaError_t.
extern "C" int ucf_int8_prepare(const void* x, void* xq, void* scale, const void* w, void* wt,
                                int m, int k, int n, int kp, int x_dtype, void* stream) {
  if (m <= 0 || k <= 0 || k > MAX_K || kp != k_padded(k)) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(xq) % 16 != 0) return cudaErrorInvalidValue;
  if (w != nullptr && (n <= 0 || n % 4 != 0 || wt == nullptr ||
                       reinterpret_cast<uintptr_t>(w) % 4 != 0 ||
                       reinterpret_cast<uintptr_t>(wt) % 16 != 0))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) return launch_prepare<float>(x, xq, scale, m, k, kp, w, wt, n, s);
  if (x_dtype == 1) return launch_prepare<__nv_bfloat16>(x, xq, scale, m, k, kp, w, wt, n, s);
  return cudaErrorInvalidValue;
}

// y [m, n] = the product of xq [m, kp] and wt [n, kp] (both from ucf_int8_prepare),
// rescaled by scale [m] and wscale [n] f32 into out_dtype (0 = float32, 1 = bfloat16), y
// contiguous and row-major. route 1 stores y by TMA (a row of y a multiple of 16 bytes, y
// 16-byte aligned); route 0 from registers. grid (persistent blocks) is between 1 and
// the tiles' count. ops/int8_gemm.py (`int8_plan`) chooses kp, grid and the route.
// Returns a cudaError_t, or ENCODE_FAILED (+ CUresult) when a tensor map cannot be
// encoded.
extern "C" int ucf_int8_gemm(const void* xq, const void* wt, const void* wscale,
                             const void* scale, void* y, int m, int k, int n, int kp, int grid,
                             int route, int out_dtype, void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || k > MAX_K || n % 4 != 0 || kp != k_padded(k))
    return cudaErrorInvalidValue;
  if (out_dtype != 0 && out_dtype != 1) return cudaErrorInvalidValue;
  const long long es = out_dtype == 0 ? 4 : 2;
  if (reinterpret_cast<uintptr_t>(xq) % 16 != 0 || reinterpret_cast<uintptr_t>(wt) % 16 != 0)
    return cudaErrorInvalidValue;
  if (route != 0 && !(route == 1 && n * es % 16 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0))
    return cudaErrorInvalidValue;
  const long long m_tiles = (m + BM - 1) / BM, tiles = m_tiles * ((n + BN - 1) / BN);
  if (tiles > 0x7FFFFFFF || grid < 1 || grid > tiles) return cudaErrorInvalidValue;

  // xq in boxes of 128 rows x 128 bytes, wt in boxes of 256 rows x 128 bytes, and on route
  // 1 y in boxes of 64 rows x 128 bytes, all with the 128-byte swizzle
  CUtensorMap txq, twt, ty;
  int err = encode_2d_s8(&txq, xq, m, kp, kp, BM);
  if (err == 0) err = encode_2d_s8(&twt, wt, n, kp, kp, BN);
  if (err == 0 && route == 1) {
    const long long g[7] = {n, m, 1, 1, n * es, n * es * m, n * es * m};
    const CUtensorMapDataType type =
        out_dtype == 0 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    err = encode(&ty, y, g, 64, type, (int)(128 / es));
  }
  if (err != 0) return err;
  if (route == 0) ty = txq;  // not read on route 0
  GemmParams p;
  p.wscale = static_cast<const float*>(wscale);
  p.scale = static_cast<const float*>(scale);
  p.y = y;
  p.m = m;
  p.n = n;
  p.m_tiles = (int)m_tiles;
  p.tiles = (int)tiles;
  p.k_stages = kp / KS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0)
    return route == 1 ? launch_gemm<float, true>(txq, twt, ty, p, grid, s)
                      : launch_gemm<float, false>(txq, twt, ty, p, grid, s);
  return route == 1 ? launch_gemm<__nv_bfloat16, true>(txq, twt, ty, p, grid, s)
                    : launch_gemm<__nv_bfloat16, false>(txq, twt, ty, p, grid, s);
}
