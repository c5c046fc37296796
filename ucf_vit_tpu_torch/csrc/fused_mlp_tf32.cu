// Fused transformer MLP in f32 on Hopper's tensor cores (sm_90a): y = gelu(x . W1 + b1) . W2
// + b2, both products f32-accurate by the 3xTF32 split of tf32x3.cuh on mma.sync, a 64-row
// tile of x split by its columns over a cluster of blocks that sum their partial hidden
// through distributed shared memory.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` (ucf_vit_tpu/ops/fused_mlp.py:55, launched
// by `_fwd_call` :63) for f32 inputs; bf16 takes csrc/fused_mlp_sm90.cu. It computes the
// same function: both products accumulate in f32, the bias add and the GELU (tanh form or
// erf form, exact tanhf / erff) run in f32, the hidden never reaches device memory, and y
// comes out in f32. There is no backward.
//
// Bound on the H100 at ViT-B's MLP [M = 4112, D = 768, H = 3072]: 4 M D H = 38.8 GFLOP, and
// an f32-accurate product costs three TF32 ones: 116.4 GFLOP at the dense TF32 rate (495
// TFLOP/s) is 0.235 ms; the 44 MB of x, W1, W2 and y take 0.013 ms at 3.35 TB/s. Bound by
// operations. mma.sync is the only TF32 product that takes both operands as they lie: wgmma
// reads a TF32 B only K-major, and W1 [D, H] and W2 [H, D] are both MN-major.
//
// Design. G blocks of a cluster (G = ceil(D / 384): 1, 2 or 3) share a 64-row tile of x:
// block `rank` owns DK = ceil(D / G) rounded up to 128 of D's columns, [rank DK, rank DK +
// DK), both as its slice of x (the first product's K) and as its columns of y. So x [64,
// DK] stays resident in shared memory (100 KB at DK = 384), and each weight byte reaches
// a cluster once per row tile: 65 x 18.9 MB = 1.23 GB of L2 reads a call at ViT-B's shape
// (a 32-row tile of all of D would read 2.4 GB). 256 threads a block, one block an SM.
// For each 64-unit hidden chunk j:
// - GEMM1: the block's partial x[:, own columns] . W1[own rows, chunk j], 64 x 64 in f32.
//   Warp w takes rows 32 (w % 2) .. + 31 and hidden units 32 (w / 2 % 2) .. + 31 over the
//   16-column k-groups w / 4, w / 4 + 2, ... (32 x 32 warp tiles: two split operands a
//   product, where 16 x 32 tiles over all of K took three); the second k-group's warps
//   put their partials into shared memory (sO) and the first's add theirs;
// - the exchange: the first k-group's threads store the block's partial into this rank's
//   slot in every other block of the cluster (st.shared::cluster, 16 KB a peer) and all
//   arrive on the cluster barrier A; after its wait each block sums the G partials in rank
//   order (so every block gets the same bits), adds b1 and takes the GELU of all 64 x 64
//   (G times over the cluster; a reduce-scatter would save that at the price of a second
//   exchange a chunk), and writes h_j into shared memory;
// - GEMM2: block `rank` adds h_j . W2[chunk j, own columns] into its 64 x DK accumulator
//   (warp w owns rows 32 (w % 2) .. + 31 and DK / 4 columns: 96 registers a thread at
//   DK = 384), each 16-unit piece's product summed from zero and added by f32 adds
//   (product2_add; one add a k8-step instead took 3-4% longer).
// The loop runs GEMM2 of chunk j - 1 between the arrival and the wait of chunk j, so the
// cluster barrier's latency hides behind it. At G = 2 the receive slots are double-buffered
// by the parity of j: a block writes chunk j + 2 into a peer's slot only after passing A
// of chunk j + 1, which the peer reaches after reading chunk j. At G = 3 two slots a peer
// do not fit beside x, so each peer has one and a second barrier B (arrive after reading,
// wait before the next send, after GEMM1) guards it; at G = 2 it cost 3-4% (one_slot in
// tools/mlp_tf32_study.py).
// - Products: m16n8k8 TF32 mma.sync, each f32 operand split into hi (rounded) and lo
//   (truncated by the tensor cores) as it is loaded from shared memory, lo.hi + hi.lo +
//   hi.hi (tf32x3.cuh). The weights are not pre-split (that would double their bytes).
//   Two free permutations make every fragment load a 16-byte one, conflict-free:
//   * k: x and h are stored with column u of each 16-column group at 4 (u % 4) + u / 4, so
//     one ld.shared.v4 at 4t of a group gives lane t its A elements (t, t + 4) of both
//     k8-steps of the group; the weights keep their rows in order (B's k-slots t, t + 4);
//   * n: n-tile i of a 32-column group takes columns 4 g + i at its slot g, so one
//     ld.shared.v4 gives lane g its B elements of four n-tiles, and a lane's C elements of
//     those four n-tiles are the 8 consecutive columns 8t .. 8t + 7 (y stored as float4s).
//   Row strides: x and h 16 floats past a multiple of 32, weight pieces 8 past (the A and
//   B loads of a quarter warp hit 8 different 16-byte bank groups).
// - Weights stream through one ring of NS stages by cp.async (16-byte copies where H and
//   D are multiples of 4 and the bases aligned, else 4-byte ones; zero fill past D and H),
//   in the order the loop reads them: a chunk is 4 W1 pieces (DK / 4 rows x 64 hidden
//   units) and 4 W2 pieces (16 hidden rows x DK columns), the same number of floats. One
//   __syncthreads a piece; 8 pieces a chunk of half the size took 5-7% longer. x comes in
//   once by 4-byte cp.async (its columns permuted). cp.async rather than TMA: a padded row
//   stride gives conflict-free fragment loads without a swizzle, which TMA cannot write
//   for rows of 64 or DK floats.
// - Rows past M, columns past D and hidden units past H arrive as zeros: a zero hidden
//   unit has gelu(0 + 0) = 0 and meets zero rows of W2; y is masked in the stores.
// - Shared memory (bytes) by instance <NG, G> (NG = DK / 128): x 64 (DK + 16) 4; h
//   64 x 80 x 4 = 20,480; sO and the receive slots 16,384 each (1 + 2 at G = 2, 1 + 2 at
//   G = 3, 1 at G = 1); b1 512; NS stages of max(DK / 4 x 72, 16 (DK + 8)) x 4 (up to 8):
//   <3, 2> (D = 768): 102,400 + 20,480 + 49,152 + 512 + 2 x 27,648 = 227,840; <3, 3>
//   (D = 1024): the same, 2 stages; <3, 1>: 3 stages, 222,720; <2, 2>: 5 stages, 231,936;
//   <2, 1>: 6 stages, 217,600; <1, 1>: 8 stages, 147,968 (of 232,448). Two stages are
//   enough: 2 to 5 stages timed the same, and weights kept hot in L2 changed nothing.
// - The grid is row tiles x G x S blocks: H splits into S slices of whole chunks only where
//   the row tiles alone would leave SMs idle (S = 1 at ViT-B's and ViT-L's shapes); at S >
//   1 each block writes its f32 partial into a workspace [S, M, D] that
//   mlp_reduce_tf32_kernel sums in a fixed order with b2. ops/fused_mlp.py (`mlp_plan_f32`)
//   chooses G and S.
// - What bounds it (tools/mlp_tf32_study.py on an H100 at 700 W): the SM's issue. An
//   m16n8k8 TF32 mma.sync takes 6.15 cycles of an SMSP with two warps issuing them (308
//   TFLOP/s of TF32 at 1.755 GHz, 62% of the wgmma peak), and the instructions beside it
//   add to that rather than overlap (2, 4, 6 FFMAs a product: 8.1, 10.9, 14.4 cycles). So
//   the time is the products' 6.15 cycles each plus every split, f32 add, shared load and
//   barrier; fewer blocks doing the same work each (66, 34) take as long as 130.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "tf32x3.cuh"

namespace {

using namespace ucf::tf32x3;
using ucf::sm90::cluster_rank;
using ucf::sm90::cluster_sync;
using ucf::sm90::mapa;
using ucf::sm90::opaque_tid;

constexpr int BM = 64;         // rows of x a tile
constexpr int HC = 64;         // hidden units a chunk
constexpr int THREADS = 256;   // 8 warps
constexpr int MAX_D = 1024;
constexpr int SH = HC + 16;    // h row stride (floats)
constexpr int SLOT = BM * HC;  // floats a receive slot: one block's partial of a chunk
constexpr int SMEM_LIMIT = 232448;
constexpr int MAX_STAGES = 8;

__host__ __device__ constexpr int dk_of(int ng) { return 128 * ng; }       // columns a block
__host__ __device__ constexpr int sx_of(int ng) { return dk_of(ng) + 16; }  // x row stride
constexpr int S1 = HC + 8;                                                  // W1 piece stride
__host__ __device__ constexpr int s2_of(int ng) { return dk_of(ng) + 8; }   // W2 piece stride
// Receive slots of each peer: two (chunk j in j & 1) in clusters of two; one in clusters of
// three, whose x slices leave no room for two beside a ring of these pieces.
__host__ __device__ constexpr int parities(int g) { return g == 2 ? 2 : 1; }
// Pieces a chunk of each weight: a W1 piece is DK / 4 rows, a W2 piece 16 hidden rows, the
// same number of floats.
constexpr int PIECES = 4;
constexpr int KS2 = HC / PIECES;
__host__ __device__ constexpr int ks1_of(int ng) { return dk_of(ng) / PIECES; }
__host__ __device__ constexpr int stage_of(int ng) {  // floats a ring stage
  return ks1_of(ng) * S1 > KS2 * s2_of(ng) ? ks1_of(ng) * S1 : KS2 * s2_of(ng);
}
__host__ __device__ constexpr int fixed_bytes(int ng, int g) {
  return 4 * (BM * sx_of(ng) + BM * SH + (1 + parities(g) * (g - 1)) * SLOT + 2 * HC);
}
__host__ __device__ constexpr int stages(int ng, int g) {
  return (SMEM_LIMIT - fixed_bytes(ng, g)) / (4 * stage_of(ng)) < MAX_STAGES
             ? (SMEM_LIMIT - fixed_bytes(ng, g)) / (4 * stage_of(ng))
             : MAX_STAGES;
}
__host__ __device__ constexpr int smem_bytes(int ng, int g) {
  return fixed_bytes(ng, g) + 4 * stages(ng, g) * stage_of(ng);
}

struct Params {
  const float* x;   // [m, d]
  const float* w1;  // [d, h]
  const float* b1;  // [h]
  const float* w2;  // [h, d]
  const float* b2;  // [d]
  float* y;         // [m, d] (splits == 1)
  float* ws;        // [splits, m, d] (splits > 1)
  int m, d, h;
  int n_chunks;     // ceil(h / 64)
  int cps;          // chunks a split
  int row_tiles, splits;
  int approx;
  int vec_w1, vec_w2, vec_y;  // 16-byte copies of W1, W2 rows; float4 stores of y / ws
};

__device__ __forceinline__ float gelu(float v, int approx) {
  if (approx) {
    const float u = 0.7978845608028654f * (v + 0.044715f * (v * v * v));
    return v * (0.5f * (1.f + tanhf(u)));
  }
  return 0.5f * v * (1.f + erff(v * 0.7071067811865476f));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void st_cluster_v4(uint32_t addr, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "f"(v.x),
               "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The operand splits and the f32-accurate product of both GEMMs (tf32x3.cuh), in one place
// each so that tools/mlp_tf32_study.py can time variants of them.
__device__ __forceinline__ FragA frag_a(const float (&x)[4]) { return split_a(x); }
__device__ __forceinline__ FragB frag_b(float x0, float x1) { return split_b(x0, x1); }
__device__ __forceinline__ void product(float (&d)[4], const FragA& a, const FragB& b) {
  mma3(d, a, b);
}

// d += a0 . b0 + a1 . b1 (two k8-steps) with the products summed from zero apart and added
// by f32 adds: the tensor cores' f32 accumulation truncates, and carried over the 3 x 512
// steps of H = 4096 in one accumulator the sum drifts to 1e-4 of y (tf32x3.cuh,
// mma3_cb_add); a k16 group's own sum is six steps, and the adds round to nearest.
__device__ __forceinline__ void product2_add(float (&d)[4], const FragA& a0, const FragB& b0,
                                             const FragA& a1, const FragB& b1) {
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  product(s, a0, b0);
  product(s, a1, b1);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += s[i];
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// Where column u (of 64) of a row of x or h lies: u % 16 at 4 (u % 4) + (u % 16) / 4.
__device__ __forceinline__ int kperm(int u) { return (u & ~15) + 4 * (u & 3) + ((u >> 2) & 3); }

// R rows x C columns of a row-major f32 matrix (row stride ld), from (r0, c0), into a shared
// tile of row stride S by 4-byte copies (the weights' path where 16-byte ones do not fit);
// zeros past nrows and ncols. No commit.
template <int R, int C, int S>
__device__ __forceinline__ void load_block(float* dst, const float* src, long long ld, int r0,
                                           int c0, int nrows, int ncols) {
  static_assert((R * C) % THREADS == 0, "copies split evenly over the block");
  const uint32_t base = smem_u32(dst);
  const int tid = opaque_tid();
#pragma unroll
  for (int k = 0; k < R * C / THREADS; ++k) {
    const int i = tid + k * THREADS;
    const int r = i / C, c = i - r * C;
    const bool ok = r0 + r < nrows && c0 + c < ncols;
    const float* s = ok ? src + (long long)(r0 + r) * ld + c0 + c : src;
    cp_async<4>(base + 4u * (uint32_t)(r * S + c), s, ok ? 4 : 0);
  }
}

template <int NG, int G>
__global__ void __launch_bounds__(THREADS, 1) fused_mlp_tf32_kernel(const Params p) {
  constexpr int DK = dk_of(NG), SX = sx_of(NG), S2 = s2_of(NG);
  constexpr int KS1 = ks1_of(NG), STAGE = stage_of(NG), NS = stages(NG, G);
  static_assert(NS >= 2, "a ring of at least two stages");
  static_assert(KS1 % 32 == 0, "a piece of W1 splits evenly between the two k-groups");
  extern __shared__ __align__(16) float smem[];
  float* sX = smem;                     // [64][SX], columns permuted (kperm)
  float* sH = sX + BM * SX;             // [64][SH], the same permutation
  constexpr int PAR = parities(G);
  float* sO = sH + BM * SH;             // [SLOT]: this block's partial
  float* sR = sO + SLOT;                // [PAR][G - 1][SLOT]: the peers' partials
  float* sB = sR + PAR * (G - 1) * SLOT;  // [2][64]: b1 of chunk j at j & 1
  float* sW = sB + 2 * HC;              // NS stages of STAGE floats

  const int rank = G == 1 ? 0 : (int)cluster_rank();  // == blockIdx.x % G
  const int tile = blockIdx.x / G;
  const int rt = tile % p.row_tiles, split = tile / p.row_tiles;
  const int row0 = rt * BM;
  const int col0 = rank * DK;  // this block's columns: of x (the first K) and of y
  const int chunk0 = split * p.cps;
  const int nc = min(p.cps, p.n_chunks - chunk0);  // >= 1 (the host checks)
  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = lane_g(), t = lane_t();

  // The exchange of partials between the G blocks and its cluster barriers: A a chunk
  // (arrive after sending chunk j, wait before reading it); with one slot a peer also B
  // (arrive after reading, wait before sending chunk j + 1 into the same slot). With two
  // a block writes chunk j + 2 into a peer's slot only after passing A of chunk j + 1,
  // which the peer reaches after reading chunk j.
  constexpr bool EXCHANGE = G > 1;
  constexpr bool TWO_PHASE = EXCHANGE && PAR == 1;
  if constexpr (EXCHANGE) cluster_sync();  // every block runs before a remote store

  // The weight stream, in the order the loop reads it: W1(0); then for j = 1 .. nc - 1,
  // W1(j) and W2(j - 1); then W2(nc - 1), each as PIECES pieces. The loader's cursor is the
  // index of the next piece to load; each load is one commit group (an empty one past the
  // end). With 16-byte copies a thread's copies of a W1 piece are rows tid / 16 + 16 k
  // at columns 4 (tid % 16), and of a W2 piece rows tid / 32 + 8 k2 at columns 4 (tid %
  // 32) + 128 k (k < NG): a pointer a piece and constant steps.
  int ld_q = 0;
  auto load_next = [&]() {
    if (ld_q < 2 * PIECES * nc) {
      // this thread's places in a piece, from a tid the compiler cannot keep in a register
      // across the loop (kept, they cost the D = 768 instance a spill at 255 registers)
      const int ltid = opaque_tid();
      const int w1_r = ltid >> 4, w1_c = 4 * (ltid & 15);
      const int w2_r = ltid >> 5, w2_c = 4 * (ltid & 31);
      int ld_j = 0, ld_sub = ld_q;
      bool ld_w2 = false;
      if (ld_q >= PIECES) {  // past W1(0): blocks of W1(j), W2(j - 1); the last W2(nc - 1)
        const int r = ld_q - PIECES;
        ld_j = r / (2 * PIECES) + 1;
        ld_sub = r % (2 * PIECES);
        if (ld_j == nc) {
          ld_w2 = true;
          ld_j = nc - 1;
        } else if (ld_sub >= PIECES) {
          ld_w2 = true;
          ld_sub -= PIECES;
          ld_j -= 1;
        }
      }
      float* dst = sW + (ld_q % NS) * STAGE;
      const int hc0 = (chunk0 + ld_j) * HC;
      if (!ld_w2) {  // W1 rows col0 + sub KS1 .. + KS1 - 1, hidden units hc0 .. hc0 + 63
        if (ld_sub == 0 && ltid < HC) {  // and with the first, the chunk's b1
          const bool ok = hc0 + ltid < p.h;
          cp_async<4>(smem_u32(sB + (ld_j & 1) * HC + ltid), ok ? p.b1 + hc0 + ltid : p.b1,
                      ok ? 4 : 0);
        }
        const int r0 = col0 + ld_sub * KS1;
        if (p.vec_w1) {
          const int row = r0 + w1_r;
          const bool col_ok = hc0 + w1_c < p.h;
          const float* src = p.w1 + (long long)row * p.h + hc0 + w1_c;
          const uint32_t d0 = smem_u32(dst + w1_r * S1 + w1_c);
#pragma unroll
          for (int k = 0; k < KS1 / 16; ++k) {
            const bool ok = col_ok && row + 16 * k < p.d;
            cp_async<16>(d0 + 4u * 16 * S1 * k, ok ? src + 16ll * k * p.h : p.w1, ok ? 16 : 0);
          }
        } else {
          load_block<KS1, HC, S1>(dst, p.w1, p.h, r0, hc0, p.d, p.h);
        }
      } else {  // W2 rows hc0 + sub KS2 .. + KS2 - 1, columns col0 .. col0 + DK - 1
        const int r0 = hc0 + ld_sub * KS2;
        if (p.vec_w2) {
#pragma unroll
          for (int k2 = 0; k2 < KS2 / 8; ++k2) {
            const int row = r0 + w2_r + 8 * k2;
            const bool row_ok = row < p.h;
            const float* src = p.w2 + (long long)row * p.d + col0 + w2_c;
            const uint32_t d0 = smem_u32(dst + (w2_r + 8 * k2) * S2 + w2_c);
#pragma unroll
            for (int k = 0; k < NG; ++k) {
              const bool ok = row_ok && col0 + w2_c + 128 * k < p.d;
              cp_async<16>(d0 + 4u * 128 * k, ok ? src + 128 * k : p.w2, ok ? 16 : 0);
            }
          }
        } else {
          load_block<KS2, DK, S2>(dst, p.w2, p.d, r0, col0, p.h, p.d);
        }
      }
    }
    ++ld_q;
    cp_async_commit();
  };

  // the x tile, once, its columns permuted; it lands with the first piece
  {
    const uint32_t base = smem_u32(sX);
    for (int i = tid; i < BM * DK; i += THREADS) {
      const int r = i / DK, c = i - r * DK;
      const bool ok = row0 + r < p.m && col0 + c < p.d;
      const float* s = ok ? p.x + (long long)(row0 + r) * p.d + col0 + c : p.x;
      cp_async<4>(base + 4u * (uint32_t)(r * SX + kperm(c)), s, ok ? 4 : 0);
    }
  }
#pragma unroll 1
  for (int i = 0; i < NS - 1; ++i) load_next();

  // the next piece to read is ld_q - (NS - 1)
  auto next_piece = [&]() -> const float* {
    cp_async_wait<NS - 2>();
    __syncthreads();  // the piece landed for every thread; every warp is done with the last
    const float* w = sW + ((ld_q + 1) % NS) * STAGE;  // (ld_q - (NS - 1)) % NS
    load_next();      // into the stage of the last piece
    return w;
  };

  // GEMM1 warp tile: k-group kg = warp / 4 takes the k16 groups kg, kg + 2, ... of each
  // piece, for rows 32 gr .. + 31 of the tile and hidden units 32 gc .. + 31 of the chunk;
  // the two k-groups' partials are summed through sO
  const int kg = warp >> 2, gr = warp & 1, gc = (warp >> 1) & 1;
  const int tq = tid & 127;  // this thread's place in a k-group
  // GEMM2 warp tile: rows 32 wm .. + 31, columns 32 NG wn .. + 32 NG - 1 of the block's DK
  const int wm = warp & 1, wn = warp >> 1;

  float acc[2][4 * NG][4];  // GEMM2: [m-tile][n-tile 4 gi + i][C element]
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int n = 0; n < 4 * NG; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][n][c] = 0.f;

  for (int j = 0; j <= nc; ++j) {
    if (j < nc) {
      float part[2][4][4];  // GEMM1 of chunk j: [m-tile][n-tile i][C element]
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) part[mt][i][c] = 0.f;
      for (int piece = 0; piece < PIECES; ++piece) {
        const float* w = next_piece();
#pragma unroll
        for (int k2 = 0; k2 < KS1 / 32; ++k2) {
          const int kk = 2 * k2 + kg;            // this warp's k16 group of the piece
          const int xk = piece * KS1 + 16 * kk;  // its x column
          float4 r0[2], r8[2];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            r0[mt] = lds4(sX + (32 * gr + 16 * mt + g) * SX + xk + 4 * t);
            r8[mt] = lds4(sX + (32 * gr + 16 * mt + g + 8) * SX + xk + 4 * t);
          }
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            FragA a[2];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              const float af[4] = {s ? r0[mt].z : r0[mt].x, s ? r8[mt].z : r8[mt].x,
                                   s ? r0[mt].w : r0[mt].y, s ? r8[mt].w : r8[mt].y};
              a[mt] = frag_a(af);
            }
            const float* wb = w + (16 * kk + 8 * s + t) * S1 + 32 * gc + 4 * g;
            const float4 b0 = lds4(wb), b1 = lds4(wb + 4 * S1);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const FragB b = frag_b(at(b0, i), at(b1, i));
              product(part[0][i], a[0], b);
              product(part[1][i], a[1], b);
            }
          }
        }
      }
      // the block's partial: k-group 1 puts its partial into sO, k-group 0 adds its own
      // and puts the sum back; float4 e = 4 mt + c of a thread holds (row g | g + 8 of
      // m-tile mt, units 8t .. + 3 | + 4 .. + 7) at sO[e][tq]
      if (kg == 1) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int mt = e >> 2, c = e & 3;
          *reinterpret_cast<float4*>(sO + 4 * (e * 128 + tq)) =
              make_float4(part[mt][0][c], part[mt][1][c], part[mt][2][c], part[mt][3][c]);
        }
      }
      __syncthreads();
      if (kg == 0) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int mt = e >> 2, c = e & 3;
          const float4 u = lds4(sO + 4 * (e * 128 + tq));
#pragma unroll
          for (int i = 0; i < 4; ++i) part[mt][i][c] += at(u, i);
          *reinterpret_cast<float4*>(sO + 4 * (e * 128 + tq)) =
              make_float4(part[mt][0][c], part[mt][1][c], part[mt][2][c], part[mt][3][c]);
        }
      }
      // k-group 0 sends it into the slot of this rank among the other ranks of every peer
      // (of parity j & 1 with two slots), once every peer has read what that slot held (B)
      if constexpr (EXCHANGE) {
        if (TWO_PHASE && j > 0) cluster_wait();
        if (kg == 0) {
#pragma unroll
          for (int peer = 0; peer < G; ++peer) {
            if (peer == rank) continue;
            const int idx = rank < peer ? rank : rank - 1;
            const uint32_t slot = smem_u32(sR + ((j % PAR) * (G - 1) + idx) * SLOT);
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const int mt = e >> 2, c = e & 3;
              st_cluster_v4(mapa(slot + 16u * (uint32_t)(e * 128 + tq), peer),
                            make_float4(part[mt][0][c], part[mt][1][c], part[mt][2][c],
                                        part[mt][3][c]));
            }
          }
        }
        cluster_arrive();  // A
      }
    }
    if (j > 0) {  // GEMM2 of chunk j - 1: acc += h . W2[chunk, own columns]
      for (int sub = 0; sub < PIECES; ++sub) {
        const float* w = next_piece();
        // the piece is the k16 group 16 sub .. + 15 of h: one ld.shared.v4 a row gives both
        // k8-steps' A elements (kperm)
        FragA a[2][2];  // [k8-step][m-tile]
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int row = 32 * wm + 16 * mt + g;
          const float4 r0 = lds4(sH + row * SH + 16 * sub + 4 * t);
          const float4 r8 = lds4(sH + (row + 8) * SH + 16 * sub + 4 * t);
          const float a0[4] = {r0.x, r8.x, r0.y, r8.y};
          const float a1[4] = {r0.z, r8.z, r0.w, r8.w};
          a[0][mt] = frag_a(a0);
          a[1][mt] = frag_a(a1);
        }
#pragma unroll
        for (int gi = 0; gi < NG; ++gi) {
          const float* wb = w + t * S2 + 32 * NG * wn + 32 * gi + 4 * g;
          const float4 b00 = lds4(wb), b01 = lds4(wb + 4 * S2);  // k8-step 0: rows t, t + 4
          const float4 b10 = lds4(wb + 8 * S2), b11 = lds4(wb + 12 * S2);  // step 1
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const FragB b0 = frag_b(at(b00, i), at(b01, i));
            const FragB b1 = frag_b(at(b10, i), at(b11, i));
            product2_add(acc[0][4 * gi + i], a[0][0], b0, a[1][0], b1);
            product2_add(acc[1][4 * gi + i], a[0][1], b0, a[1][1], b1);
          }
        }
      }
    }
    if (j < nc) {
      if constexpr (EXCHANGE) cluster_wait();  // A: every partial of chunk j has landed
      __syncthreads();  // sO is written; every warp is done reading h (chunk j - 1)
      // h = gelu(the partials summed in rank order + b1), into sH (columns permuted): this
      // thread takes float4s e = 4 mt + c (c < 4) of place tq, mt = tid / 128, whose
      // k-group-0 warp tq / 32 had rows 32 (tq / 32 % 2) + 16 mt + g (+ 8 for c >= 2)
      // and units 32 (tq / 64) + 8t + 4 (c % 2) + i
      const int mt = tid >> 7, w0 = tq >> 5;
      const float* bias = sB + (j & 1) * HC + 32 * (w0 >> 1) + 8 * t;
      float sum[4][4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int e = 4 * mt + c;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int r = 0; r < G; ++r) {
          const int idx = r < rank ? r : r - 1;
          const float4 u = lds4((r == rank ? sO : sR + ((j % PAR) * (G - 1) + idx) * SLOT) +
                                4 * (e * 128 + tq));
          v.x += u.x;
          v.y += u.y;
          v.z += u.z;
          v.w += u.w;
        }
        sum[c][0] = v.x;
        sum[c][1] = v.y;
        sum[c][2] = v.z;
        sum[c][3] = v.w;
      }
      if constexpr (TWO_PHASE) cluster_arrive();  // B: this block is done with its slots
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = 32 * (w0 & 1) + 16 * mt + g + 8 * (c >> 1);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int u = 4 * (c & 1) + i;  // unit 8t + u of the warp's 32
          sH[row * SH + kperm(32 * (w0 >> 1) + 8 * t + u)] = gelu(sum[c][i] + bias[u], p.approx);
        }
      }
      // the next piece's __syncthreads orders these writes before GEMM2 reads them
    }
  }
  if constexpr (TWO_PHASE) cluster_wait();  // B of the last chunk

  // y (or this split's partial): rows 32 wm + 16 mt + g (+ 8), columns col0 + 32 NG wn +
  // 32 gi + 8t + (0..3 | 4..7)
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = row0 + 32 * wm + 16 * mt + g + 8 * hr;
      if (row >= p.m) continue;
      float* out = p.splits == 1 ? p.y + (long long)row * p.d
                                 : p.ws + ((long long)split * p.m + row) * p.d;
#pragma unroll
      for (int gi = 0; gi < NG; ++gi)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int col = col0 + 32 * NG * wn + 32 * gi + 8 * t + 4 * half;
          float v[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            v[i] = acc[mt][4 * gi + i][2 * hr + half];
            if (p.splits == 1) v[i] += col + i < p.d ? __ldg(p.b2 + col + i) : 0.f;
          }
          if (p.vec_y) {
            if (col < p.d)
              *reinterpret_cast<float4*>(out + col) = make_float4(v[0], v[1], v[2], v[3]);
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (col + i < p.d) out[col + i] = v[i];
          }
        }
    }
}

// y = sum over s of ws[s] + b2, the partials summed in the order s = 0, 1, ...
__global__ void __launch_bounds__(256)
    mlp_reduce_tf32_kernel(const float* ws, const float* b2, float* y, long long n, int d,
                           int splits) {
  for (long long e = blockIdx.x * 256ll + threadIdx.x; e < n; e += 256ll * gridDim.x) {
    float s = ws[e];
    for (int k = 1; k < splits; ++k) s += ws[k * n + e];
    y[e] = s + b2[e % d];
  }
}

template <int NG, int G>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int smem = smem_bytes(NG, G);
  static_assert(smem <= SMEM_LIMIT, "shared memory of an instance");
  static const cudaError_t setup = cudaFuncSetAttribute(
      fused_mlp_tf32_kernel<NG, G>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (setup != cudaSuccess) return setup;
  const long long grid = (long long)p.row_tiles * p.splits * G;
  if (grid > 0x7FFFFFFF) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, fused_mlp_tf32_kernel<NG, G>, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

// The plan's numbers for d (ops/fused_mlp.py `mlp_plan_f32` computes the same): blocks of a
// cluster, columns a block, and the shared memory a block takes.
extern "C" int ucf_fused_mlp_tf32_shape(int d, int* groups, int* group_cols, int* smem) {
  if (d <= 0 || d > MAX_D) return cudaErrorInvalidValue;
  const int g = (d + 383) / 384;
  const int ng = ((d + g - 1) / g + 127) / 128;
  *groups = g;
  *group_cols = dk_of(ng);
  *smem = smem_bytes(ng, g);
  return 0;
}

// f32 x [m, d], w1 [d, h], b1 [h], w2 [h, d], b2 [d], y [m, d], all contiguous; any
// alignment, any m, h, and d <= 1024. groups and splits come from ops/fused_mlp.py
// (`mlp_plan_f32`): groups = ceil(d / 384) blocks of a cluster share a row tile, each
// ceil(d / groups) rounded up to 128 columns wide; every split gets at least one of the
// ceil(h / 64) chunks. ws: f32 [splits, m, d] when splits > 1, else unused. approx: 1 =
// tanh GELU, 0 = erf. Returns a cudaError_t.
extern "C" int ucf_fused_mlp_tf32(const void* x, const void* w1, const void* b1, const void* w2,
                                  const void* b2, void* y, void* ws, int m, int d, int h,
                                  int groups, int splits, int approx, void* stream) {
  if (m <= 0 || d <= 0 || h <= 0 || d > MAX_D) return cudaErrorInvalidValue;
  int g, dk, smem;
  ucf_fused_mlp_tf32_shape(d, &g, &dk, &smem);
  if (groups != g || splits < 1) return cudaErrorInvalidValue;
  const int n_chunks = (h + HC - 1) / HC;
  const int cps = (n_chunks + splits - 1) / splits;
  if ((long long)(splits - 1) * cps >= n_chunks) return cudaErrorInvalidValue;  // an empty split
  if (splits > 1 && ws == nullptr) return cudaErrorInvalidValue;

  Params p;
  p.x = static_cast<const float*>(x);
  p.w1 = static_cast<const float*>(w1);
  p.b1 = static_cast<const float*>(b1);
  p.w2 = static_cast<const float*>(w2);
  p.b2 = static_cast<const float*>(b2);
  p.y = static_cast<float*>(y);
  p.ws = static_cast<float*>(ws);
  p.m = m;
  p.d = d;
  p.h = h;
  p.n_chunks = n_chunks;
  p.cps = cps;
  p.row_tiles = (m + BM - 1) / BM;
  p.splits = splits;
  p.approx = approx;
  p.vec_w1 = h % 4 == 0 && aligned16(w1);
  p.vec_w2 = d % 4 == 0 && aligned16(w2);
  p.vec_y = d % 4 == 0 && aligned16(splits == 1 ? y : ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (10 * (dk / 128) + g) {
    case 11: e = launch<1, 1>(p, s); break;
    case 21: e = launch<2, 1>(p, s); break;
    case 31: e = launch<3, 1>(p, s); break;
    case 22: e = launch<2, 2>(p, s); break;
    case 32: e = launch<3, 2>(p, s); break;
    case 33: e = launch<3, 3>(p, s); break;
    default: return cudaErrorInvalidValue;
  }
  if (e != cudaSuccess || splits == 1) return e;
  const long long n = (long long)m * d;
  const long long blocks = (n + 255) / 256;
  mlp_reduce_tf32_kernel<<<(unsigned)(blocks < 65536 ? blocks : 65536), 256, 0, s>>>(
      p.ws, p.b2, p.y, n, d, splits);
  return cudaGetLastError();
}
