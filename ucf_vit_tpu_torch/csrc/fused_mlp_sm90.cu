// Fused transformer MLP in bf16 on Hopper (sm_90a): y = gelu(x . W1 + b1) . W2 + b2, both
// products on the tensor cores (wgmma) fed by TMA, the hidden passed between warpgroups
// through shared memory, and between the two blocks of a cluster by bulk copies.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` (ucf_vit_tpu/ops/fused_mlp.py:55, launched
// by `_fwd_call` :63) for bf16 inputs; csrc/fused_mlp_tf32.cu takes f32. It computes the same
// function: both products accumulate in f32, the bias add and the GELU (tanh form or erf
// form, exact tanhf / erff) run in f32, the hidden is rounded to bf16 before the second
// product and never reaches device memory, and y comes out in bf16. There is no backward.
//
// Bound on the H100 at ViT-B's MLP [M = 4112, D = 768, H = 3072]: 4 M D H = 38.8 GFLOP,
// 39.2 us at 989 TFLOP/s, against 22.1 MB of x, W1, W2 and y (6.6 us at 3.35 TB/s): bound
// by operations. A row tile of 64 rows shares each weight tile among 64 rows only, so the
// weights stream from L2 once per row tile: 65 tiles x 9.4 MB = 613 MB a call, 4.7 MB
// into each block.
//
// Design. The work of a 64-row tile of x is split over a cluster of G blocks (G = 2 for
// D > 512, else 1): block `rank` owns the output columns [rank * GC, rank * GC + GC) (GC =
// ceil(D / G) rounded up to 64) and computes the hidden chunks (64 units each) at the
// positions j = rank, rank + G, ... of the chunk order; every chunk reaches both blocks.
// The grid is row tiles x G x S blocks: H splits into S slices of whole chunks only where
// the row tiles alone would leave SMs idle (S = 1 at M = 4112: 130 blocks for 132 SMs).
// A block's warpgroups:
// - NG1 hidden warpgroups (two at WN = 192, i.e. D = 768; one at WN = 256) take the
//   block's positions in turn: h_j = x . W1[:, j] by m64n64k16 wgmma (x as a K-major A,
//   W1 as an MN-major B), then + b1, GELU and bf16 in registers, written in the panel
//   layout of sm90.cuh into hidden slot j % (2 NG1). At G = 2 one thread then copies the
//   slot into the same slot of the other block (cp.async.bulk shared::cluster, counted in
//   bytes on that block's full barrier of the slot). So the hidden is computed once for
//   the whole width. With two hidden warpgroups one's GELU (exact tanhf, about 4,000
//   cycles a chunk) overlaps the other's products; with one it stalls the chunk stream
//   (0.234 against 0.145 ms at ViT-B's shape on the H100, tools/mlp_study.py). A chunk's
//   biases are loaded before its products: loaded in the GELU, behind its bounds
//   checks, they cost 10%.
// - NOUT = ceil(GC / 256) output warpgroups each own WN = 192 or 256 of the block's
//   columns and add h_j . W2[j, columns] into a 64 x WN f32 accumulator (WN / 2 registers
//   a thread) by m64nWNk16 wgmma, h_j as a K-major A from shared memory, a W2 stage as an
//   MN-major B of WN / 64 panels. Once a warp's products have read slot j % (2 NG1), it
//   arrives on that slot's empty barrier in the block that computed h_j (remotely at
//   G = 2); a slot is rewritten once every output warp of the cluster has arrived.
// - Loads go by TMA from tensor maps encoded on the host, each counted on a full mbarrier:
//   the x tile once (stays resident); W1 tiles (64 k-rows x 64 hidden, 8 KB) into a ring
//   of NS1 stages per hidden warpgroup; W2 stages (16 hidden rows x WN columns) into a
//   ring of NS2 stages per output warpgroup. There is no producer warp: the first thread
//   of each ring's consumer warpgroup refills a stage once the stage's empty mbarrier
//   shows that all four of the warpgroup's warps have finished the products that read it.
//   Rows past M and columns past D or H arrive as TMA's zero fill; a zero hidden unit has
//   gelu(0 + 0) = 0 and meets zero rows of W2.
// - Registers: the output tile 64 x 768 in f32 is 49,152 registers, 75% of the SM's
//   65,536, and ptxas needs at least 154 registers a thread around one m64n256k16 product
//   (it refused a 512-thread block of three 256-column output warpgroups and a hidden
//   warpgroup: setmaxnreg could have left the hidden warpgroup only 32). Split over the
//   two blocks of a cluster: at D = 768 two hidden and two 192-column output warpgroups,
//   512 threads at 122 registers (the cap is 128); at D = 1024 one hidden and two
//   256-column output warpgroups, 384 threads at 154 (cap 168). No setmaxnreg, no
//   spills, and D = 1024 computes its hidden once.
// - Shared memory (8 KB units): W1 rings NG1 x NS1, hidden slots 2 NG1, W2 rings NOUT x
//   NS2 x WN / 256, the x tile ceil(D / 64). D = 768: 2 x 3 + 4 + 2 x 4 x 0.75 + 12 = 28
//   (224 KB); D = 1024: 4 + 2 + 2 x 3 + 16 = 28 (224 KB) of the 227 KB a block may have.
// - What bounds it (a clock64 trace of one cluster at ViT-B's shape on the H100,
//   tools/mlp_study.py): the two weight streams of each block. A W1 tile takes about
//   1,900 cycles from issue to its full barrier, so a hidden warpgroup with 2 tiles in
//   flight finishes one every ~1,270 cycles (128 cycles of tensor work), and the output
//   warpgroups wait for the hidden. It is each block's latency times the bytes its rings
//   hold, not the card's L2 rate: 66 or 34 blocks take as long as 130. The rings are what
//   shared memory leaves beside the x tile; moving depth from W2 to W1 (4 and 2 stages)
//   changed nothing. Sharing weight tiles between row tiles (TMA multicast in clusters
//   of 4) would halve each block's bytes, but an H100 holds 30 such clusters at once and
//   M = 4112 needs 33.
// - At S > 1 each block writes its f32 partial into a workspace [S, M, D] and
//   mlp_reduce_kernel sums the S partials in a fixed order, adds b2 and rounds to bf16:
//   deterministic. At S = 1 the main kernel writes y itself. ops/fused_mlp.py
//   (`mlp_plan`) chooses G, the warpgroups and S, and pads D and H to multiples of 8
//   (TMA's 16-byte rows) where they are not.
// - A wait on an mbarrier that has not completed after about 2^32 cycles (2-3 s) traps:
//   a deadlock surfaces as a failed launch, not a hung card.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "sm90.cuh"

namespace {

using namespace ucf::sm90;

constexpr int BM = 64;       // rows of x a block
constexpr int HC = 64;       // hidden units a chunk
constexpr int W2_ROWS = 16;  // hidden rows a W2 stage (one k-step)
constexpr uint32_t W2_PANEL = W2_ROWS * ROW_BYTES;  // 16 rows x 64 columns: 2 KB
constexpr int MAX_D = 1024;
constexpr long long WAIT_LIMIT = 1ll << 32;  // cycles

// Ring depths: as deep as shared memory allows beside the x tile (D = 768 at WN = 192,
// D = 1024 at WN = 256), for the loads in flight that an L2 round trip needs.
template <int WN>
__host__ __device__ constexpr int ns1() {  // W1 ring stages of each hidden warpgroup
  return WN == 192 ? 3 : 4;
}

template <int WN>
__host__ __device__ constexpr int ns2() {  // W2 ring stages of each output warpgroup
  return WN == 192 ? 4 : 3;
}

template <int WN>
__host__ __device__ constexpr uint32_t w2_stage_bytes() {
  return (WN / 64) * W2_PANEL;
}

// Hidden warpgroups: two at D = 768 (the WN = 192 instances), taking alternate chunks so
// that one's GELU overlaps the other's products; one where the output warpgroups need
// more than the 128 registers a thread of a 512-thread block (WN = 256).
template <int NOUT, int WN>
__host__ __device__ constexpr int ng1() {
  return WN == 192 ? 2 : 1;
}

template <int NOUT, int WN>
__host__ __device__ constexpr int threads() {
  return 128 * (ng1<NOUT, WN>() + NOUT);
}

struct Params {
  const void* b1;    // [h], f32 or bf16 (bias_bf16)
  const void* b2;    // [d]
  __nv_bfloat16* y;  // [m, d] (splits == 1)
  float* ws;         // [splits, m, d] (splits > 1)
  int m, d, h;       // d and h multiples of 8
  int npx;           // panels of the x tile: ceil(d / 64)
  int n_chunks;      // ceil(h / 64)
  int cps;           // chunks a split
  int row_tiles, splits, groups, group_cols;
  int approx, bias_bf16;
};

template <int NOUT, int WN>
constexpr size_t smem_bytes(int npx) {
  constexpr int ng = ng1<NOUT, WN>();
  return (size_t)(ng * ns1<WN>() + 2 * ng + npx) * PANEL_BYTES +
         (size_t)NOUT * ns2<WN>() * w2_stage_bytes<WN>() +
         8 * (1 + 2 * ng * ns1<WN>() + 4 * ng + 2 * NOUT * ns2<WN>())  // the barriers
         + 1024;                                                        // alignment
}

// The most x panels (ceil(d / 64)) an instance takes in 227 KB: 16 (D = 1024) at WN = 256.
template <int NOUT, int WN>
constexpr int max_panels() {
  return smem_bytes<NOUT, WN>(MAX_D / 64) <= 232448 ? MAX_D / 64 : 12;
}

template <bool CLUSTER>
__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  if constexpr (CLUSTER) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
  return done != 0;
}

// mbar_wait that traps instead of spinning forever; CLUSTER: acquiring at cluster scope,
// for the hidden slots' barriers, on which the other block of the cluster arrives.
template <bool CLUSTER = false>
__device__ __forceinline__ void wait_bar(uint32_t bar, uint32_t parity) {
  if (mbar_try<CLUSTER>(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try<CLUSTER>(bar, parity))
    if (clock64() - t0 > WAIT_LIMIT) __trap();
}

__device__ __forceinline__ float gelu(float v, int approx) {
  if (approx) {
    const float u = 0.7978845608028654f * (v + 0.044715f * (v * v * v));
    return v * (0.5f * (1.f + tanhf(u)));
  }
  return 0.5f * v * (1.f + erff(v * 0.7071067811865476f));
}

__device__ __forceinline__ float bias_at(const void* b, int i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(b)[i])
              : static_cast<const float*>(b)[i];
}

// b[i], b[i + 1] for an even i, in one load.
__device__ __forceinline__ float2 bias_pair(const void* b, int i, int bf16) {
  if (bf16)
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
        static_cast<const __nv_bfloat16*>(b) + i));
  return *reinterpret_cast<const float2*>(static_cast<const float*>(b) + i);
}

template <int NOUT, int WN>
__global__ void __launch_bounds__(threads<NOUT, WN>(), 1)
    fused_mlp_sm90_kernel(const __grid_constant__ CUtensorMap tm_x,
                          const __grid_constant__ CUtensorMap tm_w1,
                          const __grid_constant__ CUtensorMap tm_w2, const Params p) {
  constexpr int NG1 = ng1<NOUT, WN>();
  constexpr int NSLOT = 2 * NG1;  // hidden slots: position k of the chunk order in k % NSLOT
  constexpr int NS1 = ns1<WN>();
  constexpr int NS2 = ns2<WN>();
  constexpr uint32_t W2_STAGE = w2_stage_bytes<WN>();
  extern __shared__ uint8_t smem[];
  const uint32_t base = aligned_smem_base(smem);
  const uint32_t sW1 = base;                          // NG1 x NS1 panels
  const uint32_t sH = sW1 + NG1 * NS1 * PANEL_BYTES;  // NSLOT panels
  const uint32_t sX = sH + NSLOT * PANEL_BYTES;       // npx panels
  const uint32_t sW2 = sX + p.npx * PANEL_BYTES;      // NOUT x NS2 stages
  const uint32_t bars = sW2 + NOUT * NS2 * W2_STAGE;
  const uint32_t x_full = bars;
  const uint32_t w1_full = bars + 8, w1_empty = w1_full + 8 * NG1 * NS1;  // + 8 * stage
  const uint32_t h_full = w1_empty + 8 * NG1 * NS1, h_empty = h_full + 8 * NSLOT;  // + 8 * slot
  const uint32_t w2_full = h_empty + 8 * NSLOT, w2_empty = w2_full + 8 * NOUT * NS2;

  const int G = p.groups;
  const int rank = G == 1 ? 0 : (int)cluster_rank();  // == blockIdx.x % G
  const int tile = blockIdx.x / G;
  const int rt = tile % p.row_tiles;
  const int split = tile / p.row_tiles;
  const int row0 = rt * BM;
  const int chunk0 = split * p.cps;
  const int nc = min(p.cps, p.n_chunks - chunk0);  // >= 1 (the host checks)

  if (threadIdx.x == 0) {
    mbar_init(x_full, 1);
    for (int s = 0; s < NG1 * NS1; ++s) {
      mbar_init(w1_full + 8 * s, 1);
      mbar_init(w1_empty + 8 * s, 4);
    }
    for (int b = 0; b < NSLOT; ++b) {
      mbar_init(h_full + 8 * b, 1);
      mbar_init(h_empty + 8 * b, 4 * NOUT * G);  // every output warp of the cluster
    }
    for (int s = 0; s < NOUT * NS2; ++s) {
      mbar_init(w2_full + 8 * s, 1);
      mbar_init(w2_empty + 8 * s, 4);
    }
    mbar_fence_init();
  }
  cluster_sync();  // the other block's barriers are ready before anything arrives on them

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = 16 * (warp & 3) + (lane >> 2);  // this thread's rows of the tile: r, r + 8
  const int cq = 2 * (lane & 3);                // and columns 8c + cq + {0, 1}

  if (warp < 4 * NG1) {
    // ---------------------------------------------------------------- the hidden
    // Hidden warpgroup g of block `rank` computes the positions start, start + step, ...
    const int g = warp >> 2;
    const int tid = threadIdx.x - 128 * g;
    const int start = rank + G * g, step = G * NG1;
    const int own = start < nc ? (nc - start + step - 1) / step : 0;
    const int npx = p.npx;
    const int total = own * npx;  // W1 tiles of this warpgroup, in the order they are read
    const uint32_t ring = sW1 + g * NS1 * PANEL_BYTES;
    const uint32_t full = w1_full + 8 * NS1 * g, empty = w1_empty + 8 * NS1 * g;
    const void* map_w1 = &tm_w1;
    // W1 tile q: position start + (q / npx) step, k-rows 64 (q % npx) .. + 63
    auto load_w1 = [&](int q) {
      const int st = q % NS1;
      const int i = q / npx;
      mbar_arrive_expect_tx(full + 8 * st, PANEL_BYTES);
      tma_load_4d(ring + st * PANEL_BYTES, map_w1, full + 8 * st,
                  (chunk0 + start + i * step) * HC, 64 * (q - i * npx), 0, 0);
    };
    if (tid == 0 && own > 0) {
      if (g == 0) {  // the x tile, for both hidden warpgroups (the first has work if any has)
        mbar_arrive_expect_tx(x_full, p.npx * PANEL_BYTES);
        for (int t = 0; t < p.npx; ++t)
          tma_load_4d(sX + t * PANEL_BYTES, &tm_x, x_full, 64 * t, row0, 0, 0);
      }
      for (int q = 0; q < NS1 && q < total; ++q) load_w1(q);
    }
    auto release_w1 = [&](int q) {
      const int st = q % NS1;
      if (lane == 0) mbar_arrive(empty + 8 * st);
      if (tid == 0 && q + NS1 < total) {
        wait_bar(empty + 8 * st, (q / NS1) & 1);
        load_w1(q + NS1);
      }
    };

    if (own > 0) wait_bar(x_full, 0);
    int q = 0;
    for (int j = start; j < nc; j += step) {
      // this chunk's biases, loaded before its products so that their latency hides behind
      // them (behind the GELU's bounds checks, one at a time, they held it up for
      // thousands of cycles); 0 past H (h and col even)
      const int hcol = (chunk0 + j) * HC;
      float2 bias[8];
#pragma unroll
      for (int c = 0; c < 8; ++c)
        bias[c] = hcol + 8 * c + cq < p.h ? bias_pair(p.b1, hcol + 8 * c + cq, p.bias_bf16)
                                          : make_float2(0.f, 0.f);
      float acc[32];
#pragma unroll
      for (int x = 0; x < 32; ++x) acc[x] = 0.f;
      for (int t = 0; t < p.npx; ++t, ++q) {
        const int st = q % NS1;
        wait_bar(full + 8 * st, (q / NS1) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<0, 1>(acc, make_desc(sX + t * PANEL_BYTES + 32 * kk),
                         make_desc(ring + st * PANEL_BYTES + kk * 16 * ROW_BYTES));
        wgmma_commit();
        wgmma_wait<1>();  // tile q - 1's products are done; tile q's may run
        if (t > 0) release_w1(q - 1);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      release_w1(q - 1);

      // + b1, GELU in f32, bf16, into slot j % NSLOT once every output warp of the cluster
      // has finished position j - NSLOT (a fresh barrier passes the wait of parity 1)
      const int hb = j % NSLOT;
      wait_bar<true>(h_empty + 8 * hb, ((j / NSLOT) & 1) ^ 1);
      const uint32_t dst = sH + hb * PANEL_BYTES;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = 8 * c + cq;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const uint32_t v = pack_bf16(gelu(acc[4 * c + 2 * i] + bias[c].x, p.approx),
                                       gelu(acc[4 * c + 2 * i + 1] + bias[c].y, p.approx));
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(dst + swizzle_offset(r + 8 * i, col)),
                       "r"(v)
                       : "memory");
        }
      }
      fence_proxy_async();  // the tensor cores and the bulk copy read what these wrote
      named_bar_sync(1 + g, 128);
      if (tid == 0) {
        mbar_arrive(h_full + 8 * hb);
        if (G == 2) {  // the same slot of the other block
          const uint32_t peer = rank ^ 1;
          const uint32_t bar = mapa(h_full + 8 * hb, peer);
          mbar_arrive_expect_tx_cluster(bar, PANEL_BYTES);
          bulk_copy_cluster(mapa(dst, peer), dst, PANEL_BYTES, bar);
        }
      }
    }
  } else {
    // ---------------------------------------------------------------- the output columns
    const int o = (warp >> 2) - NG1;  // this output warpgroup
    const int otid = threadIdx.x - 128 * (NG1 + o);
    const uint32_t ring = sW2 + o * NS2 * W2_STAGE;
    const uint32_t full = w2_full + 8 * NS2 * o, empty = w2_empty + 8 * NS2 * o;
    const int col0 = rank * p.group_cols + WN * o;  // this warpgroup's first column
    const int total = nc * (HC / W2_ROWS);           // W2 stages of this warpgroup
    const void* map_w2 = &tm_w2;
    // W2 stage q: hidden rows chunk0 * 64 + 16 q .. + 15, columns col0 .. col0 + WN - 1
    auto load_w2 = [&](int q) {
      const int st = q % NS2;
      const int hrow = chunk0 * HC + W2_ROWS * q;
      mbar_arrive_expect_tx(full + 8 * st, W2_STAGE);
#pragma unroll
      for (int n = 0; n < WN / 64; ++n)
        tma_load_4d(ring + st * W2_STAGE + n * W2_PANEL, map_w2, full + 8 * st,
                    col0 + 64 * n, hrow, 0, 0);
    };
    if (otid == 0)
      for (int q = 0; q < NS2 && q < total; ++q) load_w2(q);
    auto release_w2 = [&](int q) {
      const int st = q % NS2;
      if (lane == 0) mbar_arrive(empty + 8 * st);
      if (otid == 0 && q + NS2 < total) {
        wait_bar(empty + 8 * st, (q / NS2) & 1);
        load_w2(q + NS2);
      }
    };

    float acc[WN / 2];
#pragma unroll
    for (int x = 0; x < WN / 2; ++x) acc[x] = 0.f;
    int q = 0;
    for (int j = 0; j < nc; ++j) {
      const int hb = j % NSLOT;
      wait_bar<true>(h_full + 8 * hb, (j / NSLOT) & 1);
      const uint32_t a = sH + hb * PANEL_BYTES;
#pragma unroll
      for (int kk = 0; kk < HC / W2_ROWS; ++kk, ++q) {
        const int st = q % NS2;
        wait_bar(full + 8 * st, (q / NS2) & 1);
        wgmma_fence();
        wgmma_ss_wide<WN, 0, 1>(acc, make_desc(a + 32 * kk),
                                make_desc_mn(ring + st * W2_STAGE, W2_PANEL));
        wgmma_commit();
        wgmma_wait<1>();
        if (kk > 0) release_w2(q - 1);
      }
      wgmma_wait<0>();
      release_w2(q - 1);
      if (lane == 0) {  // this warp is done with h_j: tell the block that computed it
        const int maker = j % G;
        if (maker == rank) {
          mbar_arrive(h_empty + 8 * hb);
        } else {
          mbar_arrive_cluster(mapa(h_empty + 8 * hb, maker));
        }
      }
    }
    fence_regs(acc);

    const int col_end = min(p.d, rank * p.group_cols + p.group_cols);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + r + 8 * i;
      if (row >= p.m) continue;
      if (p.splits == 1) {
        __nv_bfloat16* yrow = p.y + (long long)row * p.d;
#pragma unroll
        for (int c = 0; c < WN / 8; ++c) {
          const int col = col0 + 8 * c + cq;  // col + 1 < col_end too (both even)
          if (col < col_end) {
            const float2 b = bias_pair(p.b2, col, p.bias_bf16);
            *reinterpret_cast<__nv_bfloat162*>(yrow + col) =
                __floats2bfloat162_rn(acc[4 * c + 2 * i] + b.x, acc[4 * c + 2 * i + 1] + b.y);
          }
        }
      } else {
        float* wrow = p.ws + ((long long)split * p.m + row) * p.d;
#pragma unroll
        for (int c = 0; c < WN / 8; ++c) {
          const int col = col0 + 8 * c + cq;
          if (col < col_end)
            *reinterpret_cast<float2*>(wrow + col) =
                make_float2(acc[4 * c + 2 * i], acc[4 * c + 2 * i + 1]);
        }
      }
    }
  }
  // no block leaves while the other may still arrive on its barriers or copy into it
  cluster_sync();
}

// y = bf16(sum over s of ws[s] + b2), the partials summed in the order s = 0, 1, ...;
// four elements a thread (d is a multiple of 8).
__global__ void __launch_bounds__(256)
    mlp_reduce_kernel(const float* ws, const void* b2, int bias_bf16, __nv_bfloat16* y,
                      long long n4, int d, int splits) {
  const long long plane = 4 * n4;
  for (long long e = blockIdx.x * 256ll + threadIdx.x; e < n4; e += 256ll * gridDim.x) {
    float4 s = reinterpret_cast<const float4*>(ws)[e];
    for (int k = 1; k < splits; ++k) {
      const float4 t = reinterpret_cast<const float4*>(ws + k * plane)[e];
      s.x += t.x;
      s.y += t.y;
      s.z += t.z;
      s.w += t.w;
    }
    const int col = (int)((4 * e) % d);
    const __nv_bfloat162 lo = __floats2bfloat162_rn(s.x + bias_at(b2, col, bias_bf16),
                                                    s.y + bias_at(b2, col + 1, bias_bf16));
    const __nv_bfloat162 hi = __floats2bfloat162_rn(s.z + bias_at(b2, col + 2, bias_bf16),
                                                    s.w + bias_at(b2, col + 3, bias_bf16));
    uint2 v;
    v.x = *reinterpret_cast<const uint32_t*>(&lo);
    v.y = *reinterpret_cast<const uint32_t*>(&hi);
    reinterpret_cast<uint2*>(y)[e] = v;
  }
}

template <int NOUT, int WN>
cudaError_t launch(const Params& p, const CUtensorMap& tx, const CUtensorMap& tw1,
                   const CUtensorMap& tw2, cudaStream_t stream) {
  static const cudaError_t setup = cudaFuncSetAttribute(
      fused_mlp_sm90_kernel<NOUT, WN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<NOUT, WN>(max_panels<NOUT, WN>()));
  if (setup != cudaSuccess) return setup;
  if (p.npx > max_panels<NOUT, WN>()) return cudaErrorInvalidValue;
  const long long grid = (long long)p.row_tiles * p.splits * p.groups;
  if (grid > 0x7FFFFFFF) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(threads<NOUT, WN>());
  cfg.dynamicSmemBytes = smem_bytes<NOUT, WN>(p.npx);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.groups;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, fused_mlp_sm90_kernel<NOUT, WN>, tx, tw1, tw2, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// bf16 x [m, d], w1 [d, h], w2 [h, d], y [m, d], all contiguous and 16-byte aligned, d and h
// multiples of 8 (ops/fused_mlp.py pads other shapes); b1 [h] and b2 [d] in f32, or both in
// bf16 (bias_bf16 = 1). ws: f32 [splits, m, d] when splits > 1, else unused. groups,
// warpgroups and splits come from ops/fused_mlp.py (`mlp_plan`): groups (1, or 2 for
// d > 512) blocks of a cluster share a row tile, each ceil(d / groups) rounded up to 64
// columns wide; warpgroups = ceil(that / 256); every split gets at least one of the
// ceil(h / 64) chunks. approx: 1 = tanh GELU, 0 = erf. Returns a cudaError_t, or
// ENCODE_FAILED (+ CUresult) when a tensor map cannot be encoded.
extern "C" int ucf_fused_mlp_sm90(const void* x, const void* w1, const void* b1, const void* w2,
                                  const void* b2, void* y, void* ws, int m, int d, int h,
                                  int warpgroups, int groups, int splits, int bias_bf16,
                                  int approx, void* stream) {
  if (m <= 0 || d <= 0 || h <= 0 || d > MAX_D || d % 8 || h % 8) return cudaErrorInvalidValue;
  if (groups != (d > 512 ? 2 : 1) || splits < 1) return cudaErrorInvalidValue;
  const int group_cols = ((d + groups - 1) / groups + 63) / 64 * 64;
  if (warpgroups != (group_cols + 255) / 256) return cudaErrorInvalidValue;
  const int n_chunks = (h + HC - 1) / HC;
  const int cps = (n_chunks + splits - 1) / splits;
  if ((long long)(splits - 1) * cps >= n_chunks) return cudaErrorInvalidValue;  // an empty split
  if (splits > 1 && ws == nullptr) return cudaErrorInvalidValue;

  CUtensorMap tx, tw1, tw2;
  int err = encode_2d(&tx, x, m, d, d, BM);
  if (err == 0) err = encode_2d(&tw1, w1, d, h, h, 64);
  if (err == 0) err = encode_2d(&tw2, w2, h, d, d, W2_ROWS);
  if (err != 0) return err;

  Params p;
  p.b1 = b1;
  p.b2 = b2;
  p.y = static_cast<__nv_bfloat16*>(y);
  p.ws = static_cast<float*>(ws);
  p.m = m;
  p.d = d;
  p.h = h;
  p.npx = (d + 63) / 64;
  p.n_chunks = n_chunks;
  p.cps = cps;
  p.row_tiles = (m + BM - 1) / BM;
  p.splits = splits;
  p.groups = groups;
  p.group_cols = group_cols;
  p.approx = approx;
  p.bias_bf16 = bias_bf16;
  // two output warpgroups 192 wide where they cover the block's columns (D = 768), else
  // 256 (D = 1024; and one warpgroup for D <= 256)
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (warpgroups == 1) {
    e = launch<1, 256>(p, tx, tw1, tw2, s);
  } else if (warpgroups == 2) {
    e = 2 * 192 >= group_cols ? launch<2, 192>(p, tx, tw1, tw2, s)
                              : launch<2, 256>(p, tx, tw1, tw2, s);
  } else {
    return cudaErrorInvalidValue;
  }
  if (e != cudaSuccess || splits == 1) return e;
  const long long n4 = (long long)m * d / 4;
  const long long blocks = (n4 + 255) / 256;
  mlp_reduce_kernel<<<(unsigned)(blocks < 65536 ? blocks : 65536), 256, 0, s>>>(
      static_cast<const float*>(ws), b2, bias_bf16, p.y, n4, d, splits);
  return cudaGetLastError();
}
