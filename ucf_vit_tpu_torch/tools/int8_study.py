"""Where the time of the int8 GEMM goes on the card (`csrc/int8_gemm.cu`).

    python -m ucf_vit_tpu_torch.tools.int8_study     # from the root of a checkout, one card

Three measurements, each printed:

1. Variants of the source, each a named set of edits to the committed file,
   built side by side (one nvcc each, started together, into
   `build/int8_study/`) and timed in turns (variant order, then reversed) on
   the same inputs at ViT-B's three projection shapes: the profiler's device
   time of `int8_gemm_kernel` a call (`int8_prepare` runs once, before),
   and whether y still equals `int8_matmul_plain`. Most variants take a part
   of the work out (their results are wrong on purpose): what is left bounds
   the rest. The as-built source is timed on both routes of y (`int8_plan`):
   "tma" as the plan takes these shapes, and "direct" (stores from
   registers), which the plan takes where a row of y is no multiple of 16
   bytes.
2. The first kernel, `int8_prepare`, at the same shapes: as `int8_matmul`
   launches it (x quantized and w turned K-major) and without the weights.
3. A trace of block 0 at `[4112, 768] x 3072`: the as-built source with
   `clock64()` stamps at each stage of the producer (its issuing thread) and
   of the first consumer warpgroup (thread 0), summarised as medians.

Nothing here is imported by the package or the tests; the CUDA code is built
when the script runs.
"""

from __future__ import annotations

import ctypes
import statistics
import sys

import numpy as np
import torch

from ucf_vit_tpu_torch.ops import int8_gemm as ig
from ucf_vit_tpu_torch.tools.variants import Study, device_line, profiled_ms

STUDY = Study("int8_study", "int8_gemm.cu", "ucf_int8_gemm",
              [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p])

# ------------------------------------------------------------------ the variants

_TMA_STORE = "          tma_store_4d(&tm_y, buf, col0 + hc * CC, m0, 0, 0);\n"


def _skew(stage):
    return [("      mbar_init(empty + 8 * s, 8);\n    }\n",
             "      mbar_init(empty + 8 * s, 8);\n    }\n    mbar_init(empty + 8 * NS, 4);\n"),
            ("      if (kq > 0 && lane == 0) mbar_arrive(empty + 8 * ((g - 1) % NS));\n",
             "      if (kq > 0 && lane == 0) mbar_arrive(empty + 8 * ((g - 1) % NS));\n"
             f"      if (cw == 0 && g == {stage} && lane == 0) mbar_arrive(empty + 8 * NS);\n"),
            ("  int acc[128];\n  int g = 0;\n",
             "  int acc[128];\n  int g = 0;\n  if (cw == 1) wait_bar(empty + 8 * NS, 0);\n"),
            ("    NS * (A_STAGE + B_STAGE) + 4 * OUT_CHUNK + BN * 4 + 8 * 2 * NS + 1024;",
             "    NS * (A_STAGE + B_STAGE) + 4 * OUT_CHUNK + BN * 4 + 8 * 2 * NS + 8 + 1024;")]


VARIANTS = {
    "as_built": [],
    # the consumers stage the output but store none of it
    "no_output_stores": [(_TMA_STORE, "")],
    # a ring of 3 stages instead of 4
    "three_stages": [("constexpr int NS = 4;", "constexpr int NS = 3;")],
    # the second consumer warpgroup starts once the first has issued its stage 0 (1) or
    # 1 (2), so that their epilogues fall on each other's products
    "skew_1_stage": _skew(0),
    "skew_2_stages": _skew(1),
}
SHAPES = [(4112, 768, 3072), (4112, 768, 2304), (4112, 3072, 768)]

# ------------------------------------------------------------------ the trace

# per stage g of block 0: the producer past its wait for the stage's slot (its loads
# issued next); the first consumer warpgroup past its full wait, its previous stage's
# products done; per tile t, that warpgroup's epilogue started and done
EVENTS = ("p_issue", "c_ready", "c_done", "e_start", "e_end")
_TRACE_EDITS = [
    ("namespace {\n\nusing namespace ucf::sm90;\n", """namespace {

using namespace ucf::sm90;
__device__ long long g_trace[5][64];
#define REC(e, k) \\
  do { \\
    if (blockIdx.x == 0 && (k) < 64) g_trace[e][k] = clock64() - t0; \\
  } while (0)
"""),
    ("  extern __shared__ uint8_t smem[];\n  const uint32_t base = aligned_smem_base(smem);",
     "  const long long t0 = clock64();\n  extern __shared__ uint8_t smem[];\n"
     "  const uint32_t base = aligned_smem_base(smem);"),
    ("      if (g >= NS) wait_bar(empty + 8 * s, ((g / NS) - 1) & 1);\n",
     "      if (g >= NS) wait_bar(empty + 8 * s, ((g / NS) - 1) & 1);\n      REC(0, g);\n"),
    ("      wait_bar(full + 8 * s, (g / NS) & 1);\n",
     "      wait_bar(full + 8 * s, (g / NS) & 1);\n      if (threadIdx.x == 0) REC(1, g);\n"),
    ("      wgmma_wait<1>();  // stage g - 1's products are done\n",
     "      wgmma_wait<1>();  // stage g - 1's products are done\n"
     "      if (threadIdx.x == 0) REC(2, g);\n"),
    ("    const uint32_t wbuf = sWs;\n",
     "    if (threadIdx.x == 0) REC(3, (tile - (int)blockIdx.x) / (int)gridDim.x);\n"
     "    const uint32_t wbuf = sWs;\n"),
    ("  if constexpr (TMA_Y) {\n    if (wtid == 0) bulk_wait<0, false>();",
     "  if (threadIdx.x == 0) REC(4, 0);\n  if constexpr (TMA_Y) {\n"
     "    if (wtid == 0) bulk_wait<0, false>();"),
]
_TRACE_DUMP = """
extern "C" int dump_trace(void* host) {
  return (int)cudaMemcpyFromSymbol(host, g_trace, sizeof(g_trace));
}
"""


def _case(m, k, n, gen):
    """bf16 x, the package's first pass on it (xq, scale, wt), the weights, the plan."""
    x = torch.randn(m, k, device="cuda", generator=gen).to(torch.bfloat16)
    w_i8, ws = ig.quantize_weight(0.02 * torch.randn(k, n, device="cuda", generator=gen))
    plan = ig.int8_plan(m, k, n, torch.cuda.get_device_properties(0).multi_processor_count)
    xq, scale, wt = ig._prepare_cuda(x, plan.kp, w_i8)
    return x, w_i8, ws, xq, scale, wt, plan


def _gemm(fn, case, route=None):
    """A call of a variant's GEMM entry on the case's quantized x, on the plan's route
    or on `route`."""
    x, w_i8, ws, xq, scale, wt, plan = case
    m, k = x.shape
    n = w_i8.shape[1]
    y = torch.empty(m, n, dtype=torch.bfloat16, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = fn(xq.data_ptr(), wt.data_ptr(), ws.data_ptr(), scale.data_ptr(),
                                y.data_ptr(), m, k, n, plan.kp, plan.grid,
                                int((route or plan.route) == "tma"), 1, stream)
        if err:
            raise RuntimeError(f"the kernel returned {err}")
        return y

    return run


def time_prepare() -> None:
    """`int8_prepare` as `int8_matmul` launches it (x quantized, w turned K-major) and as
    `quantize_rows` does (x alone), by the profiler's device time."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    for m, k, n in SHAPES:
        x, w_i8, _, _, _, _, plan = _case(m, k, n, gen)
        both = profiled_ms(lambda: ig._prepare_cuda(x, plan.kp, w_i8), "int8_prepare")
        alone = profiled_ms(lambda: ig._prepare_cuda(x, plan.kp), "int8_prepare")
        print(f"[prepare] [{m},{k}]x{n}: int8_prepare {both:.4f} ms (device), of which the "
              f"quantization alone {alone:.4f}", flush=True)


def time_variants(built) -> None:
    gen = torch.Generator(device="cuda").manual_seed(0)
    for m, k, n in SHAPES:
        case = _case(m, k, n, gen)
        want = ig.int8_matmul_plain(case[0], case[1], case[2])
        runs = {v.name: _gemm(v.fn, case) for v in built}
        runs["as_built, route direct"] = _gemm(built[0].fn, case, "direct")
        equal = {name: torch.equal(run(), want) for name, run in runs.items()}
        times = {name: [] for name in runs}
        for name in list(runs) + list(runs)[::-1]:
            times[name].append(profiled_ms(runs[name], "int8_gemm_kernel"))
        for name, t in times.items():
            print(f"[variant] [{m},{k}]x{n} {name}: {', '.join(f'{v:.4f}' for v in t)} ms "
                  f"(int8_gemm_kernel, device); y equals plain: {equal[name]}", flush=True)


def trace() -> None:
    traced = STUDY.build("trace", STUDY.edited(_TRACE_EDITS) + _TRACE_DUMP)
    gen = torch.Generator(device="cuda").manual_seed(0)
    run = _gemm(traced.fn, _case(4112, 768, 3072, gen))
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    buf = np.zeros((5, 64), dtype=np.int64)
    traced.lib.dump_trace(ctypes.c_void_p(buf.ctypes.data))
    ev = {name: buf[i] for i, name in enumerate(EVENTS)}
    g = np.arange(64)
    stages = int((ev["c_done"] > 0).sum())
    g = np.arange(stages)
    steady = g >= 4  # past the ring's first fill
    med = lambda a: statistics.median(a[:stages][steady].tolist())  # noqa: E731
    k_stages = 768 // 128
    last = g[(g % k_stages) == k_stages - 1]  # each tile's last stage
    epilogue = [ev["c_ready"][q + 1] - ev["e_start"][q // k_stages] for q in last
                if q + 1 < stages]
    print(f"[trace] [4112,768]x3072, block 0, {stages} stages ({stages // k_stages} tiles), in "
          f"cycles (medians past the first 4 stages): the consumer past its full wait every "
          f"{statistics.median(np.diff(ev['c_ready'][:stages]).tolist()):.0f}, full wait to the "
          f"previous stage's products done {med(ev['c_done'] - ev['c_ready']):.0f}; the "
          f"producer's slot freed to the consumer's full wait done "
          f"{med(ev['c_ready'] - ev['p_issue']):.0f}; a tile's epilogue to the next tile's "
          f"first stage {statistics.median(epilogue) if epilogue else float('nan'):.0f}; the "
          f"block's consumer done at {ev['e_end'][0]:.0f}", flush=True)


def main() -> int:
    if not device_line("int8_study"):
        return 1
    built = STUDY.build_all(VARIANTS)
    time_prepare()
    time_variants(built)
    trace()
    return 0


if __name__ == "__main__":
    sys.exit(main())
