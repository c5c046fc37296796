"""Where the time of the f32 fused MLP goes on the card (`csrc/fused_mlp_tf32.cu`).

    python -m ucf_vit_tpu_torch.tools.mlp_tf32_study    # from the root of a checkout, one card

Four measurements, each printed:

1. The tensor cores' TF32 `mma.sync` alone: cycles an SMSP takes an m16n8k8
   product with 1, 2 or 4 warps an SMSP issuing independent ones, the latency
   of a dependent chain, and the cycles with 2-8 FFMAs, FADDs or LOP3s a
   product beside them (whether the SMSP issues other instructions while the
   products run: it does not, and that is what bounds the kernel).
2. Variants of the source, each a named set of edits to the committed file,
   built side by side (one nvcc each, started together, into
   `build/mlp_tf32_study/`) and timed in turns (variant order, then reversed)
   on the same inputs at ViT-B's and ViT-L's MLP shapes: device ms a call by
   CUDA events, and max |y - plain|. Most variants leave a part out on
   purpose (two of the three TF32 passes, the split, the weight loads, the
   exchange or a piece of it, the GELU, a product, the barrier a piece): what
   their time saves is what that part costs. The as-built source is also
   timed with fewer blocks doing the same work each (M = 2080 and 1040 at
   S = 1), which tells a bound of each block from a bound of the whole card.
3. A trace of one block: the as-built source with `clock64()` stamps in
   thread 0 of block 0 at each weight piece's wait and each chunk's
   exchange, summarised as medians.
4. How many clusters of 2 and of 3 blocks of the D = 768 and D = 1024
   instances' shared memory the card holds at once
   (`cudaOccupancyMaxActiveClusters`).

Nothing here is imported by the package or the tests; the CUDA code is built
when the script runs.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys

import numpy as np
import torch

from ucf_vit_tpu_torch.ops import build
from ucf_vit_tpu_torch.ops import fused_mlp as fm
from ucf_vit_tpu_torch.tools.variants import Study, device_line, event_ms

STUDY = Study("mlp_tf32_study", "fused_mlp_tf32.cu", "ucf_fused_mlp_tf32",
              [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p])

# ------------------------------------------------------------------ the variants

_PRODUCT = "  mma3(d, a, b);\n}"
_FRAG_A = "__device__ __forceinline__ FragA frag_a(const float (&x)[4]) { return split_a(x); }"
_FRAG_B = "__device__ __forceinline__ FragB frag_b(float x0, float x1) { return split_b(x0, x1); }"
_GELU_TANH = "    return v * (0.5f * (1.f + tanhf(u)));"
_ADD2 = ("  product(s, a0, b0);\n  product(s, a1, b1);\n#pragma unroll\n"
         "  for (int i = 0; i < 4; ++i) d[i] += s[i];")
VARIANTS = {
    "as_built": [],
    # one TF32 pass (hi . hi) a product instead of three: the tensor cores' share
    "one_pass": [(_PRODUCT, "  mma_tf32(d, a.hi, b.hi);\n}")],
    # the operands' bits passed as they are, unsplit: the split's ALU share
    "no_split": [
        (_FRAG_A, "__device__ __forceinline__ FragA frag_a(const float (&x)[4]) { FragA r; "
                  "for (int i = 0; i < 4; ++i) r.hi[i] = r.lo[i] = __float_as_uint(x[i]); "
                  "return r; }"),
        (_FRAG_B, "__device__ __forceinline__ FragB frag_b(float x0, float x1) { FragB r; "
                  "r.hi[0] = r.lo[0] = __float_as_uint(x0); r.hi[1] = r.lo[1] = "
                  "__float_as_uint(x1); return r; }")],
    # no weight copies (the products read whatever the ring holds): the loads' share
    "no_weight_loads": [("    if (ld_q < 2 * PIECES * nc) {", "    if (false) {")],
    # no exchange of the partials and no cluster barrier: the exchange's share
    "no_exchange": [("  constexpr bool EXCHANGE = G > 1;", "  constexpr bool EXCHANGE = false;")],
    # the exchange's cluster barrier A left out (a race: its time), or its stores
    "no_cluster_barrier": [("        cluster_arrive();  // A\n", ""),
                           ("      if constexpr (EXCHANGE) cluster_wait();  // A: every partial",
                            "      if constexpr (false) cluster_wait();  // A: every partial")],
    "no_remote_stores": [("              st_cluster_v4(mapa(slot + 16u * (uint32_t)(e * 128 + tq), peer),",
                          "              if (peer < 0) st_cluster_v4(mapa(slot + 16u * (uint32_t)(e * 128 + tq), peer),")],
    # the hidden passed on without its GELU
    "no_gelu": [(_GELU_TANH, "    return v;")],
    # hi by truncation (one AND) instead of rounding (an add and an AND)
    "split_truncated": [
        (_FRAG_A, "__device__ __forceinline__ FragA frag_a(const float (&x)[4]) { FragA r; "
                  "for (int i = 0; i < 4; ++i) { r.hi[i] = __float_as_uint(x[i]) & 0xffffe000u; "
                  "r.lo[i] = __float_as_uint(x[i] - __uint_as_float(r.hi[i])); } return r; }"),
        (_FRAG_B, "__device__ __forceinline__ FragB frag_b(float x0, float x1) { FragB r; "
                  "const float x[2] = {x0, x1}; for (int i = 0; i < 2; ++i) { r.hi[i] = "
                  "__float_as_uint(x[i]) & 0xffffe000u; r.lo[i] = __float_as_uint(x[i] - "
                  "__uint_as_float(r.hi[i])); } return r; }")],
    # either product alone (the other's pieces still stream in)
    "first_product_only": [("        for (int gi = 0; gi < NG; ++gi) {\n          const float* wb",
                            "        for (int gi = 0; gi < 0; ++gi) {\n          const float* wb")],
    "second_product_only": [("        for (int k2 = 0; k2 < KS1 / 32; ++k2) {",
                             "        for (int k2 = 0; k2 < 0; ++k2) {")],
    # no barrier a piece (a race: the time it takes)
    "no_piece_barrier": [("    __syncthreads();  // the piece landed for every thread; every warp is done "
                          "with the last\n", "")],
    # the second product added into y after each k8-step, not each k16 group
    "second_product_adds_each_k8": [(_ADD2, "  product(s, a0, b0);\n#pragma unroll\n"
                                            "  for (int i = 0; i < 4; ++i) {\n    d[i] += s[i];\n"
                                            "    s[i] = 0.f;\n  }\n  product(s, a1, b1);\n"
                                            "#pragma unroll\n  for (int i = 0; i < 4; ++i) d[i] += s[i];")],
    # one receive slot a peer at G = 2 too (two cluster barriers a chunk; 3 stages)
    "one_slot": [("{ return g == 2 ? 2 : 1; }", "{ return 1; }")],
    # every chunk reads the first chunk's weights: the same lines, always in L2
    "one_chunk_of_weights": [("      const int hc0 = (chunk0 + ld_j) * HC;\n      if (!ld_w2) {",
                              "      const int hc0 = chunk0 * HC;\n      if (!ld_w2) {")],
    # the second product accumulated in the tensor cores' accumulator (it drifts)
    "gemm2_in_accumulator": [("  float s[4] = {0.f, 0.f, 0.f, 0.f};\n" + _ADD2,
                              "  product(d, a0, b0);\n  product(d, a1, b1);")],
}
SHAPES = [(4112, 768, 3072), (2056, 1024, 4096)]
FEWER_BLOCKS = [(2080, 768, 3072), (1040, 768, 3072)]  # 66 and 34 blocks, S = 1 forced

# ------------------------------------------------------------------ the trace

# events of thread 0 of block 0: weight piece q's wait begun, and passed (its
# __syncthreads too); chunk j's partials sent (arrive) and received (after the wait)
EVENTS = ("piece_wait", "piece_ready", "sent", "received")
_TRACE_EDITS = [
    ("namespace {\n\nusing namespace ucf::tf32x3;\n", """namespace {

using namespace ucf::tf32x3;
__device__ long long g_trace[4][256];
#define REC(e, k) \\
  do { \\
    if (blockIdx.x == 0 && threadIdx.x == 0 && (k) >= 0 && (k) < 256) \\
      g_trace[e][k] = clock64() - t0; \\
  } while (0)
"""),
    ("  extern __shared__ __align__(16) float smem[];\n  float* sX = smem;",
     "  const long long t0 = clock64();\n  extern __shared__ __align__(16) float smem[];\n"
     "  float* sX = smem;"),
    ("  // the next piece to read is ld_q - (NS - 1)\n",
     "  // the next piece to read is ld_q - (NS - 1)\n  int traced = 0;\n"),
    ("    cp_async_wait<NS - 2>();\n", "    REC(0, traced);\n    cp_async_wait<NS - 2>();\n"),
    ("    load_next();      // into the stage of the last piece\n",
     "    REC(1, traced);\n    ++traced;\n    load_next();      // into the stage of the last piece\n"),
    ("        cluster_arrive();  // A\n", "        cluster_arrive();  // A\n        REC(2, j);\n"),
    ("      __syncthreads();  // sO is written; every warp is done reading h (chunk j - 1)\n",
     "      __syncthreads();  // sO is written; every warp is done reading h (chunk j - 1)\n"
     "      REC(3, j);\n"),
]
_TRACE_DUMP = """
extern "C" int dump_trace(void* host) {
  return (int)cudaMemcpyFromSymbol(host, g_trace, sizeof(g_trace));
}
"""

_OCCUPANCY = """#include <cuda_runtime.h>
#include <cstdio>
__global__ void __launch_bounds__(256, 1) k(int* p) {
  extern __shared__ int s[];
  if (p) p[0] = s[threadIdx.x];
}
int main() {
  const int cases[2][2] = {{2, SMEM_768}, {3, SMEM_1024}};  // (G, bytes): D = 768, 1024
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  for (const auto& c : cases) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(132 * c[0]);
    cfg.blockDim = dim3(256);
    cfg.dynamicSmemBytes = c[1];
    cudaLaunchAttribute a[1];
    a[0].id = cudaLaunchAttributeClusterDimension;
    a[0].val.clusterDim.x = c[0];
    a[0].val.clusterDim.y = 1;
    a[0].val.clusterDim.z = 1;
    cfg.attrs = a;
    cfg.numAttrs = 1;
    int n = -1;
    const cudaError_t e = cudaOccupancyMaxActiveClusters(&n, k, &cfg);
    printf("[occupancy] clusters of %d blocks of 256 threads and %d bytes: %d at once (%s)\\n",
           c[0], c[1], n, cudaGetErrorString(e));
  }
  return 0;
}
"""


# the tensor cores' TF32 mma.sync on their own: cycles an SMSP takes a product with W
# warps an SM issuing independent m16n8k8 products (8 accumulators a warp), the latency of
# a chain of dependent ones (one accumulator), and the same products with F independent
# FFMAs, FADDs or integer LOP3s a product beside them (whether the SMSP issues them while
# the products run)
_HMMA = r"""#include <cuda_runtime.h>
#include <cstdio>
template <int CHAINS, int FMAS, int OP = 0>
__global__ void k(float* out, long long* cycles, int iters) {
  float acc[CHAINS][4] = {};
  float f[8];
  unsigned a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1.f + threadIdx.x * 1e-3f + i);
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(0.5f + i);
  for (int i = 0; i < 8; ++i) f[i] = threadIdx.x + i;
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) {
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
                   "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                   : "+f"(acc[c][0]), "+f"(acc[c][1]), "+f"(acc[c][2]), "+f"(acc[c][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
#pragma unroll
      for (int i = 0; i < FMAS; ++i) {
        if (OP == 0)
          asm volatile("fma.rn.f32 %0, %0, 0f3F800054, 0f3F000000;" : "+f"(f[i % 8]));
        else if (OP == 1)
          asm volatile("add.f32 %0, %0, 0f3F000000;" : "+f"(f[i % 8]));
        else
          asm volatile("lop3.b32 %0, %0, 0x1000, 0xffffe000, 0x6a;" : "+r"(*reinterpret_cast<unsigned*>(&f[i % 8])));
      }
    }
  const long long t1 = clock64();
  float s = 0.f;
  for (int c = 0; c < CHAINS; ++c) s += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  for (int i = 0; i < 8; ++i) s += f[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}
int main() {
  float* out;
  long long* cyc;
  cudaMalloc(&out, 132 * 1024 * sizeof(float));
  cudaMalloc(&cyc, 132 * sizeof(long long));
  const int iters = 4096;
  for (int warps : {4, 8, 16}) {
    k<8, 0><<<132, 32 * warps>>>(out, cyc, iters);
    long long c;
    cudaMemcpy(&c, cyc, sizeof(c), cudaMemcpyDeviceToHost);
    printf("[hmma] %d warps an SM, 8 independent chains a warp: %.2f cycles an SMSP a product "
           "(%.1f TF32 TFLOP/s at 132 SMs and 1.755 GHz)\n", warps,
           (double)c / (iters * 8.0 * warps / 4), 132 * 4 * 2048.0 * 1.755e9 /
           ((double)c / (iters * 8.0 * warps / 4)) / 1e12);
  }
  k<1, 0><<<132, 32>>>(out, cyc, iters);
  long long c;
  cudaMemcpy(&c, cyc, sizeof(c), cudaMemcpyDeviceToHost);
  printf("[hmma] one warp, one chain of dependent products: %.2f cycles a product\n",
         (double)c / iters);
  auto beside = [&](auto kern, int n, const char* what) {
    kern<<<132, 256>>>(out, cyc, iters);
    cudaMemcpy(&c, cyc, sizeof(c), cudaMemcpyDeviceToHost);
    printf("[hmma] 8 warps an SM, 8 chains a warp, %d %s a product beside: %.2f cycles an "
           "SMSP a product\n", n, what, (double)c / (iters * 8.0 * 2));
  };
  beside(k<8, 2>, 2, "FFMAs");
  beside(k<8, 4>, 4, "FFMAs");
  beside(k<8, 8>, 8, "FFMAs");
  beside(k<8, 4, 1>, 4, "FADDs");
  beside(k<8, 4, 2>, 4, "LOP3s");
  beside(k<8, 8, 2>, 8, "LOP3s");
  return cudaDeviceSynchronize() != cudaSuccess;
}
"""


def hmma_rate() -> None:
    d = STUDY.dir / "hmma"
    d.mkdir(parents=True, exist_ok=True)
    (d / "hmma.cu").write_text(_HMMA)
    subprocess.run([build.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-o",
                    str(d / "hmma"), str(d / "hmma.cu")], check=True)
    print(subprocess.run([str(d / "hmma")], capture_output=True, text=True, check=True).stdout,
          end="", flush=True)


def _inputs(m, d, h, gen):
    def randn(*shape, std=1.0):
        return std * torch.randn(*shape, device="cuda", generator=gen)

    return (randn(m, d), randn(d, h, std=0.02), randn(h, std=0.01), randn(h, d, std=0.02),
            randn(d, std=0.01))


def _call(fn, args, one_split=False):
    """A call of a variant's C entry by `mlp_plan_f32` (or with S = 1)."""
    x, w1, b1, w2, b2 = args
    m, d = x.shape
    h = w1.shape[1]
    plan = fm.mlp_plan_f32(m, d, h, torch.cuda.get_device_properties(0).multi_processor_count)
    if one_split:
        plan = plan._replace(splits=1, blocks=plan.row_tiles * plan.groups)
    y = torch.empty(m, d, device="cuda")
    ws = torch.empty(plan.splits, m, d, device="cuda") if plan.splits > 1 else None
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                 y.data_ptr(), ws.data_ptr() if ws is not None else None, m, d, h,
                 plan.groups, plan.splits, 1, stream)
        if err:
            raise RuntimeError(f"the kernel returned {err}")
        return y

    return run, plan


def time_variants(built, shapes, one_split=False) -> None:
    gen = torch.Generator(device="cuda").manual_seed(0)
    for m, d, h in shapes:
        args = _inputs(m, d, h, gen)
        want = fm.fused_mlp_plain(*args)
        runs = {}
        for v in built:
            runs[v.name], plan = _call(v.fn, args, one_split)
            err = (runs[v.name]() - want).abs().max().item()
            print(f"[variant] [{m},{d}]->{h} ({plan.blocks} blocks, S = {plan.splits}) {v.name}: "
                  f"max|y-plain| {err:.3e}", flush=True)
        times = {name: [] for name in runs}
        for name in list(runs) + list(runs)[::-1]:
            times[name].append(event_ms(runs[name]))
        for name, t in times.items():
            print(f"[variant] [{m},{d}]->{h} {name}: {', '.join(f'{v:.4f}' for v in t)} ms a "
                  f"call (CUDA events)", flush=True)


def trace() -> None:
    traced = STUDY.build("trace", STUDY.edited(_TRACE_EDITS) + _TRACE_DUMP)
    gen = torch.Generator(device="cuda").manual_seed(0)
    run, _ = _call(traced.fn, _inputs(4112, 768, 3072, gen))
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    buf = np.zeros((4, 256), dtype=np.int64)
    traced.lib.dump_trace(ctypes.c_void_p(buf.ctypes.data))
    wait, ready, sent, received = buf
    waited = (ready - wait)[(ready > 0) & (wait > 0)]
    ready = ready[ready > 0]
    period = np.diff(ready)
    # the read order: W1 pieces of chunk 0, then P W1 and P W2 pieces a chunk
    n = fm.F32_PIECES
    w1 = [p for q, p in enumerate(period[n:], n) if (q - n) % (2 * n) < n]
    w2 = [p for q, p in enumerate(period[n:], n) if (q - n) % (2 * n) >= n]
    j = np.arange(256)
    both = (sent > 0) & (received > 0) & (j >= 1)
    print(f"[trace] ViT-B [4112,768]->3072, block 0, warp 0, in cycles (medians): a W1 piece "
          f"every {statistics.median(w1):.0f}, a W2 piece every {statistics.median(w2):.0f}, "
          f"of which the wait and barrier {statistics.median(waited[n:]):.0f} (mean "
          f"{np.mean(waited[n:]):.0f}); "
          f"a chunk's exchange from its arrival to past its wait {statistics.median((received - sent)[both]):.0f} "
          f"(the second product of the chunk before it runs between); a chunk every "
          f"{statistics.median(np.diff(received[received > 0])):.0f}; the first piece at "
          f"{ready[0]:.0f}", flush=True)


def occupancy() -> None:
    d = STUDY.dir / "occupancy"
    d.mkdir(parents=True, exist_ok=True)
    smem = {w: fm.mlp_plan_f32(4112, w, 4 * w, 132).smem for w in (768, 1024)}
    (d / "occ.cu").write_text(_OCCUPANCY.replace("SMEM_768", str(smem[768]))
                              .replace("SMEM_1024", str(smem[1024])))
    subprocess.run([build.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-o",
                    str(d / "occ"), str(d / "occ.cu")], check=True)
    print(subprocess.run([str(d / "occ")], capture_output=True, text=True, check=True).stdout,
          end="", flush=True)


def main() -> int:
    if not device_line("mlp_tf32_study"):
        return 1
    hmma_rate()
    torch.backends.cuda.matmul.allow_tf32 = False
    built = STUDY.build_all(VARIANTS)
    if len(sys.argv) > 1:  # the as-built SASS into this file
        tool = build.nvcc_path().replace("nvcc", "cuobjdump")
        sass = subprocess.run([tool, "-sass", str(STUDY.dir / "as_built" / "v.so")],
                              capture_output=True, text=True, check=True).stdout
        with open(sys.argv[1], "w") as f:
            f.write(sass)
    time_variants(built, SHAPES)
    time_variants([v for v in built if v.name == "as_built"], FEWER_BLOCKS, one_split=True)
    trace()
    occupancy()
    return 0


if __name__ == "__main__":
    sys.exit(main())
