"""Where the time of the bf16 fused MLP goes on the card (`csrc/fused_mlp_sm90.cu`).

    python -m ucf_vit_tpu_torch.tools.mlp_study     # from the root of a checkout, one card

Three measurements, each printed:

1. Variants of the source, each a named set of edits to the committed file,
   built side by side (one nvcc each, started together, into
   `build/mlp_study/`) and timed in turns (variant order, then reversed) on
   the same inputs: device ms a call by CUDA events, and max |y - plain|.
   The as-built source is also timed with fewer blocks doing the same work
   each (M = 2080 and 1040 at S = 1), which tells a bound of each block from
   a bound of the whole card.
2. A trace of one cluster: the as-built source with `clock64()` stamps at
   each step of its first two blocks (a W1 tile's load issued, waited for,
   multiplied; a W2 stage's; the hidden's hand-off), summarised as medians.
3. How many clusters of 2 and of 4 blocks of this shared-memory footprint
   the card holds at once (`cudaOccupancyMaxActiveClusters`).

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

STUDY = Study("mlp_study", "fused_mlp_sm90.cu", "ucf_fused_mlp_sm90",
              [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p])

# ------------------------------------------------------------------ the variants

_TANH = "    return v * (0.5f * (1.f + tanhf(u)));"
_BIAS_HOISTED = """      float2 bias[8];
#pragma unroll
      for (int c = 0; c < 8; ++c)
        bias[c] = hcol + 8 * c + cq < p.h ? bias_pair(p.b1, hcol + 8 * c + cq, p.bias_bf16)
                                          : make_float2(0.f, 0.f);
"""
_BIAS_USED = (
    "          const uint32_t v = pack_bf16(gelu(acc[4 * c + 2 * i] + bias[c].x, p.approx),\n"
    "                                       gelu(acc[4 * c + 2 * i + 1] + bias[c].y, p.approx));")
_NS1 = "  return WN == 192 ? 3 : 4;"
_NS2 = "  return WN == 192 ? 4 : 3;"
_W1_AT_ONCE = [("""        wgmma_commit();
        wgmma_wait<1>();  // tile q - 1's products are done; tile q's may run
        if (t > 0) release_w1(q - 1);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      release_w1(q - 1);
""", """        wgmma_commit();
        wgmma_wait<0>();
        release_w1(q);
      }
      fence_regs(acc);
""")]
_W2_AT_ONCE = [("""        wgmma_commit();
        wgmma_wait<1>();
        if (kk > 0) release_w2(q - 1);
      }
      wgmma_wait<0>();
      release_w2(q - 1);
""", """        wgmma_commit();
        wgmma_wait<0>();
        release_w2(q);
      }
""")]
VARIANTS = {
    "as_built": [],
    # one hidden warpgroup (and the deeper rings its freed shared memory allows)
    "one_hidden_warpgroup": [("  return WN == 192 ? 2 : 1;", "  return 1;"),
                             (_NS1, "  return WN == 192 ? 6 : 4;"),
                             (_NS2, "  return WN == 192 ? 5 : 3;")],
    # the biases loaded in the GELU, one at a time behind its bounds checks
    "bias_in_gelu": [(_BIAS_HOISTED, ""),
                     (_BIAS_USED, """          const int h0 = hcol + col;
          const float b0 = h0 < p.h ? bias_at(p.b1, h0, p.bias_bf16) : 0.f;
          const float b1 = h0 < p.h ? bias_at(p.b1, h0 + 1, p.bias_bf16) : 0.f;
          const uint32_t v = pack_bf16(gelu(acc[4 * c + 2 * i] + b0, p.approx),
                                       gelu(acc[4 * c + 2 * i + 1] + b1, p.approx));""")],
    # the tanh form's tanhf by the MUFU approximation (relative error about 2^-11)
    "tanh_approx": [(_TANH, """    float th;
    asm("tanh.approx.f32 %0, %1;" : "=f"(th) : "f"(u));
    return v * (0.5f * (1.f + th));""")],
    # the same function as v * sigmoid(2u), branch-free
    "sigmoid_fdividef": [(_TANH, "    return __fdividef(v, 1.f + __expf(-2.f * u));")],
    # ring depth moved from W2 to W1 at D = 768
    "w1_4_w2_2": [(_NS1, "  return WN == 192 ? 4 : 4;"), (_NS2, "  return WN == 192 ? 2 : 3;")],
    # each ring's stage released as soon as the products that read it are done
    # (wgmma_wait<0>), instead of one tile later (wgmma_wait<1>)
    "release_w1_at_once": _W1_AT_ONCE,
    "release_w2_at_once": _W2_AT_ONCE,
    "release_both_at_once": _W1_AT_ONCE + _W2_AT_ONCE,
    # two hidden slots shared by the two hidden warpgroups (and a W1 stage more each)
    "two_hidden_slots": [("  constexpr int NSLOT = 2 * NG1;", "  constexpr int NSLOT = 2;"),
                         ("(ng * ns1<WN>() + 2 * ng + npx)", "(ng * ns1<WN>() + 2 + npx)"),
                         ("4 * ng + 2 * NOUT", "4 + 2 * NOUT"),
                         (_NS1, "  return WN == 192 ? 4 : 4;")],
}
# (M, D, H, S or None for the plan's)
SHAPES = [(4112, 768, 3072, None), (2056, 1024, 4096, None)]
FEWER_BLOCKS = [(2080, 768, 3072, 1), (1040, 768, 3072, 1)]  # 66 and 34 blocks at S = 1

# ------------------------------------------------------------------ the trace

# events per block: W1 tile q issued, waited for, its products done (hidden warpgroup 0);
# W2 stage q issued, waited for (output warpgroup 0); the hidden's position j waited for
# by output warpgroup 0; position j's GELU started (slot free) and handed off (hidden
# warpgroup 0)
EVENTS = ("w1_issue", "w1_ready", "w1_done", "w2_issue", "w2_ready", "h_ready", "gelu_start",
          "gelu_end")
_TRACE_EDITS = [
    ("namespace {\n\nusing namespace ucf::sm90;\n", """namespace {

using namespace ucf::sm90;
__device__ long long g_trace[2][8][64];
#define REC(e, k) \\
  do { \\
    if (blockIdx.x < 2 && (k) >= 0 && (k) < 64) g_trace[blockIdx.x][e][k] = clock64() - t0; \\
  } while (0)
"""),
    ("  extern __shared__ uint8_t smem[];\n  const uint32_t base = aligned_smem_base(smem);",
     "  const long long t0 = clock64();\n  extern __shared__ uint8_t smem[];\n"
     "  const uint32_t base = aligned_smem_base(smem);"),
    ("      mbar_arrive_expect_tx(full + 8 * st, PANEL_BYTES);\n",
     "      if (g == 0) REC(0, q);\n      mbar_arrive_expect_tx(full + 8 * st, PANEL_BYTES);\n"),
    ("        wait_bar(full + 8 * st, (q / NS1) & 1);\n",
     "        wait_bar(full + 8 * st, (q / NS1) & 1);\n"
     "        if (g == 0 && tid == 0) REC(1, q);\n"),
    ("        if (t > 0) release_w1(q - 1);\n",
     "        if (g == 0 && tid == 0) REC(2, q - 1);\n        if (t > 0) release_w1(q - 1);\n"),
    ("      mbar_arrive_expect_tx(full + 8 * st, W2_STAGE);\n",
     "      if (o == 0) REC(3, q);\n      mbar_arrive_expect_tx(full + 8 * st, W2_STAGE);\n"),
    ("        wait_bar(full + 8 * st, (q / NS2) & 1);\n",
     "        wait_bar(full + 8 * st, (q / NS2) & 1);\n"
     "        if (o == 0 && otid == 0) REC(4, q);\n"),
    ("      wait_bar<true>(h_full + 8 * hb, (j / NSLOT) & 1);\n",
     "      wait_bar<true>(h_full + 8 * hb, (j / NSLOT) & 1);\n"
     "      if (o == 0 && otid == 0) REC(5, j);\n"),
    ("      wait_bar<true>(h_empty + 8 * hb, ((j / NSLOT) & 1) ^ 1);\n",
     "      wait_bar<true>(h_empty + 8 * hb, ((j / NSLOT) & 1) ^ 1);\n"
     "      if (g == 0 && tid == 0) REC(6, j);\n"),
    ("        mbar_arrive(h_full + 8 * hb);\n",
     "        if (g == 0) REC(7, j);\n        mbar_arrive(h_full + 8 * hb);\n"),
]
_TRACE_DUMP = """
extern "C" int dump_trace(void* host) {
  return (int)cudaMemcpyFromSymbol(host, g_trace, sizeof(g_trace));
}
"""

_OCCUPANCY = """#include <cuda_runtime.h>
#include <cstdio>
__global__ void __launch_bounds__(512, 1) k(int* p) {
  extern __shared__ int s[];
  if (p) p[0] = s[threadIdx.x];
}
int main() {
  const int smem = 224 * 1024;  // the D = 768 instance's footprint, rounded up
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  for (int cs : {2, 4}) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(132 * cs);
    cfg.blockDim = dim3(512);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute a[1];
    a[0].id = cudaLaunchAttributeClusterDimension;
    a[0].val.clusterDim.x = cs;
    a[0].val.clusterDim.y = 1;
    a[0].val.clusterDim.z = 1;
    cfg.attrs = a;
    cfg.numAttrs = 1;
    int n = -1;
    const cudaError_t e = cudaOccupancyMaxActiveClusters(&n, k, &cfg);
    printf("[occupancy] clusters of %d blocks of 512 threads and 224 KB: %d at once (%s)\\n", cs,
           n, cudaGetErrorString(e));
  }
  return 0;
}
"""


def _inputs(m, d, h, gen):
    def randn(*shape, std=1.0):
        return (std * torch.randn(*shape, device="cuda", generator=gen)).to(torch.bfloat16)

    return (randn(m, d), randn(d, h, std=0.02), randn(h, std=0.01), randn(h, d, std=0.02),
            randn(d, std=0.01))


def _call(fn, args, splits=None):
    """A call of a variant's C entry by `mlp_plan` (optionally at another S)."""
    x, w1, b1, w2, b2 = args
    m, d = x.shape
    h = w1.shape[1]
    plan = fm.mlp_plan(m, d, h, torch.cuda.get_device_properties(0).multi_processor_count)
    splits = splits or plan.splits
    y = torch.empty(m, d, dtype=torch.bfloat16, device="cuda")
    ws = torch.empty(splits, m, d, device="cuda") if splits > 1 else None
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                 y.data_ptr(), ws.data_ptr() if ws is not None else None, m, d, h,
                 plan.warpgroups, plan.groups, splits, 1, 1, stream)
        if err:
            raise RuntimeError(f"the kernel returned {err}")
        return y

    return run, plan.groups * plan.row_tiles * splits


def time_variants(built, shapes) -> None:
    gen = torch.Generator(device="cuda").manual_seed(0)
    for m, d, h, splits in shapes:
        args = _inputs(m, d, h, gen)
        want = fm.fused_mlp_plain(*args).float()
        runs = {}
        for v in built:
            name = v.name
            runs[name], blocks = _call(v.fn, args, splits)
            err = (runs[name]().float() - want).abs().max().item()
            print(f"[variant] [{m},{d}]->{h} ({blocks} blocks) {name}: max|y-plain| {err:.3e}",
                  flush=True)
        times = {name: [] for name in runs}
        for name in list(runs) + list(runs)[::-1]:
            times[name].append(event_ms(runs[name]))
        for name, t in times.items():
            print(f"[variant] [{m},{d}]->{h} ({blocks} blocks) {name}: "
                  f"{', '.join(f'{v:.4f}' for v in t)} ms a call (CUDA events)", flush=True)


def trace() -> None:
    traced = STUDY.build("trace", STUDY.edited(_TRACE_EDITS) + _TRACE_DUMP)
    gen = torch.Generator(device="cuda").manual_seed(0)
    run, _ = _call(traced.fn, _inputs(4112, 768, 3072, gen))
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    buf = np.zeros((2, 8, 64), dtype=np.int64)
    traced.lib.dump_trace(ctypes.c_void_p(buf.ctypes.data))
    ev = {name: buf[0, i] for i, name in enumerate(EVENTS)}
    npx, q = 12, np.arange(64)
    # W1 tiles past the first of each chunk's ring fill, where the consumer waits on the load
    steady = (q % npx >= 3) & (ev["w1_ready"] > 0) & (ev["w1_issue"] > 0)
    w1_latency = statistics.median((ev["w1_ready"] - ev["w1_issue"])[steady])
    done = ev["w1_done"]
    tile_period = statistics.median(np.diff(done)[(q[:-1] % npx != npx - 1) & (done[1:] > 0)])
    w2 = (ev["w2_ready"] > 0) & (ev["w2_issue"] > 0) & (q >= 8)
    w2_latency = statistics.median((ev["w2_ready"] - ev["w2_issue"])[w2])
    gelu = (ev["gelu_end"] > 0) & (ev["gelu_start"] > 0) & (q >= 4)
    gelu_cycles = statistics.median((ev["gelu_end"] - ev["gelu_start"])[gelu])
    ready = ev["h_ready"][ev["h_ready"] > 0]
    print(f"[trace] ViT-B [4112,768]->3072, block 0, in cycles (medians): a W1 tile issued to "
          f"waited for {w1_latency:.0f}, one W1 tile done every {tile_period:.0f} (tensor work "
          f"128) a hidden warpgroup; a W2 stage issued to waited for {w2_latency:.0f}; a GELU "
          f"and hand-off of a chunk {gelu_cycles:.0f}; the output warpgroups take a chunk every "
          f"{statistics.median(np.diff(ready[4:])):.0f}; the first chunk ready at "
          f"{ready[0]:.0f}", flush=True)


def occupancy() -> None:
    d = STUDY.dir / "occupancy"
    d.mkdir(parents=True, exist_ok=True)
    (d / "occ.cu").write_text(_OCCUPANCY)
    subprocess.run([build.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-o",
                    str(d / "occ"), str(d / "occ.cu")], check=True)
    print(subprocess.run([str(d / "occ")], capture_output=True, text=True, check=True).stdout,
          end="", flush=True)


def main() -> int:
    if not device_line("mlp_study"):
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    built = STUDY.build_all(VARIANTS)
    time_variants(built, SHAPES)
    time_variants([v for v in built if v.name == "as_built"], FEWER_BLOCKS)
    trace()
    occupancy()
    return 0


if __name__ == "__main__":
    sys.exit(main())
