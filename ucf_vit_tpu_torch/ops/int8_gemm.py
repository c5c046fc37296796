"""W8A8 int8 GEMM on Hopper's int8 tensor cores, with the activation quantized
per row by a pass of its own, and its plain version (port of
`ucf_vit_tpu/ops/int8_gemm.py`).

`quantize_weight` quantizes the weights once, offline, per output channel
(plain torch, as it is plain XLA in the JAX package). `csrc/int8_gemm.cu`
replaces the Pallas TPU kernel `_kernel` (`ucf_vit_tpu/ops/int8_gemm.py:61`,
launched by `int8_matmul` `:81`) with two kernels on the caller's stream:
`int8_prepare` takes, per row of x over the full K, `scale = max(max|x|,
1e-8) / 127` and `xq = clip(round(x / scale), +-127)` into an int8 workspace
`[M, Kp]` (K rounded up to the GEMM's 128-byte K slice, zeros past K) and an
f32 `[M]`, and turns `w_i8 [K, N]` K-major into an int8 workspace `[N, Kp]`
(the int8 tensor cores take both operands K-major only); `int8_gemm_kernel`
multiplies the two on the tensor cores (wgmma s32.s8.s8, both by TMA) into
int32 and rescales `acc * scale * wscale` into the output type. `int8_plan`
decides Kp, the tiles, the persistent grid and the route of the output:
"tma" (TMA stores) where a row of y is a multiple of 16 bytes, else
"direct" (stores from registers). As in the JAX package it is an op of its
own, wired into no model or server.

The kernels' limits (their own, not the TPU kernel's tile and VMEM rules):
x f32 or bf16, output f32 or bf16, any M, `K <= 6144`, `N % 4 == 0` (the
weights are read four columns at a time at least). See the source for the
design and its bound on the card.

`int8_matmul` (and `quantize_rows`, the quantization alone) takes the plain
version for a tensor on the CPU and the kernels for a tensor on a CUDA
device; anything else raises. There is no fallback: a CUDA call that cannot
build, encode its tensor maps or launch raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

MAX_K = 6144
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# csrc/int8_gemm.cu: bytes of K a stage (xq's rows are padded to it), and a tile's rows
# and columns
INT8_K_SLICE, INT8_ROWS, INT8_COLS = 128, 128, 256
_ENCODE_FAILED = 10000  # csrc/sm90.cuh: ENCODE_FAILED (+ the driver's CUresult)


class Int8Plan(NamedTuple):
    """How `csrc/int8_gemm.cu` takes one call (`int8_plan`)."""
    kp: int       # K rounded up to INT8_K_SLICE: the row stride of the xq workspace
    m_tiles: int  # ceil(M / 128)
    n_tiles: int  # ceil(N / 256)
    tiles: int    # m_tiles * n_tiles output tiles
    grid: int     # persistent blocks, one an SM: min(tiles, SMs)
    route: str    # y's stores: "tma" where N * out_bytes % 16 == 0, else "direct"


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=256)
def int8_plan(m: int, k: int, n: int, sms: int, out_bytes: int = 2) -> Int8Plan:
    """The kernels' plan for x `[m, k]`, w_i8 `[k, n]` and a y of `out_bytes`
    an element on a card of `sms` SMs (pure Python, decided before the launch):
    TMA stores y in rows of whole 16-byte units only."""
    m_tiles, n_tiles = _ceil(m, INT8_ROWS), _ceil(n, INT8_COLS)
    tiles = m_tiles * n_tiles
    return Int8Plan(_ceil(k, INT8_K_SLICE) * INT8_K_SLICE, m_tiles, n_tiles, tiles,
                    min(tiles, sms), "tma" if n * out_bytes % 16 == 0 else "direct")


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """`max(amax, 1e-8) / 127` as an IEEE division. The divisor is a tensor
    on purpose: torch's CUDA division by a Python number multiplies by the
    reciprocal, which rounds differently from the kernel's division."""
    return amax.clamp_min(1e-8) / torch.full_like(amax, 127.0)


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 quantization (`:49`).

    Returns `(w_i8 [K, N] int8, wscale [N] float32)` with `w ~= w_i8 *
    wscale[None, :]`."""
    wf = w.float()
    scale = _scale(wf.abs().amax(dim=0))
    w_i8 = torch.round(wf / scale[None, :]).clamp_(-127, 127).to(torch.int8)
    return w_i8, scale


def quantize_rows_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row dynamic int8 quantization of x `[M, K]` over the full K, in
    plain PyTorch (the counterpart of `int8_prepare`'s quantization, and of the first
    steps of `int8_matmul_reference`, `:127-131`): returns `(xq [M, K] int8,
    scale [M] float32)` with `x ~= xq * scale[:, None]`. `torch.round` rounds
    half to even, as `jnp.round` and the kernel's `rintf` do."""
    xf = x.float()
    scale = _scale(xf.abs().amax(dim=1))
    xq = torch.round(xf / scale[:, None]).clamp_(-127, 127).to(torch.int8)
    return xq, scale


def int8_matmul_plain(x: torch.Tensor, w_i8: torch.Tensor, wscale: torch.Tensor,
                      out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The kernels' function in plain PyTorch (the counterpart of
    `int8_matmul_reference`, `:127`): quantize (`quantize_rows_plain`),
    integer product, rescale, as separate passes. The integer product runs in
    int32 on the CPU and, where the device has no integer matmul, in f64,
    which is exact for these sizes (|acc| <= 127 * 127 * K < 2^53)."""
    out_dtype = out_dtype or x.dtype
    xq, scale = quantize_rows_plain(x)
    if x.device.type == "cpu":
        acc = (xq.to(torch.int32) @ w_i8.to(torch.int32)).float()
    else:
        acc = (xq.double() @ w_i8.double()).float()
    y = acc * scale[:, None] * wscale.float()[None, :]
    return y.to(out_dtype)


def _check(x, w_i8, wscale, out_dtype) -> None:
    if x.dim() != 2 or w_i8.dim() != 2 or wscale.dim() != 1:
        raise ValueError("int8_matmul takes x [M, K], w_i8 [K, N], wscale [N]")
    m, k = x.shape
    if w_i8.shape[0] != k or wscale.shape[0] != w_i8.shape[1]:
        raise ValueError(f"incompatible shapes x {tuple(x.shape)}, w_i8 {tuple(w_i8.shape)}, "
                         f"wscale {tuple(wscale.shape)}")
    if w_i8.dtype != torch.int8:
        raise TypeError(f"w_i8 must be int8, got {w_i8.dtype}")
    # the kernel's limits, held on every device so that a shape the card would
    # refuse does not pass on the CPU
    if x.dtype not in _KERNEL_DTYPES or out_dtype not in _KERNEL_DTYPES:
        raise TypeError(f"int8_matmul takes and returns float32 or bfloat16, got {x.dtype} "
                        f"-> {out_dtype}")
    if m == 0:
        raise ValueError("int8_matmul needs at least one row")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"int8_matmul takes 1 <= K <= {MAX_K}, got {k}")
    if w_i8.shape[1] == 0 or w_i8.shape[1] % 4:
        raise ValueError(f"int8_matmul takes N a positive multiple of 4, got {w_i8.shape[1]}")
    if w_i8.device != x.device or wscale.device != x.device:
        raise ValueError("int8_matmul needs all of its inputs on one device")


def _library():
    from ucf_vit_tpu_torch.ops.build import load

    lib = load("int8_gemm")
    if lib.ucf_int8_gemm.argtypes is None:
        lib.ucf_int8_prepare.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        lib.ucf_int8_prepare.restype = ctypes.c_int
        lib.ucf_int8_gemm.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        lib.ucf_int8_gemm.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _raise_on(err: int, kernel: str) -> None:
    if err >= _ENCODE_FAILED:
        raise RuntimeError(f"{kernel}: cuTensorMapEncodeTiled failed (CUresult "
                           f"{err - _ENCODE_FAILED}; 0: the driver entry point was not found)")
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")


def _prepare_cuda(x: torch.Tensor, kp: int, w_i8: Optional[torch.Tensor] = None):
    """`int8_prepare` into fresh workspaces: xq `[M, kp]` and scale `[M]`, and
    where `w_i8` is given, its K-major copy wt `[N, kp]` (else None)."""
    m, k = x.shape
    xq = torch.empty((m, kp), dtype=torch.int8, device=x.device)
    scale = torch.empty((m,), dtype=torch.float32, device=x.device)
    n = 0 if w_i8 is None else w_i8.shape[1]
    wt = None if w_i8 is None else torch.empty((n, kp), dtype=torch.int8, device=x.device)
    err = _library().ucf_int8_prepare(
        x.data_ptr(), xq.data_ptr(), scale.data_ptr(),
        None if w_i8 is None else w_i8.data_ptr(), None if wt is None else wt.data_ptr(),
        m, k, n, kp, _KERNEL_DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, "int8_prepare")
    return xq, scale, wt


def _int8_matmul_cuda(x, w_i8, wscale, out_dtype) -> torch.Tensor:
    m, k = x.shape
    n = w_i8.shape[1]
    x, w_i8 = x.contiguous(), w_i8.contiguous()
    wscale = wscale.float().contiguous()
    y = torch.empty((m, n), dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        plan = int8_plan(m, k, n, _sm_count(x.device.index), y.element_size())
        xq, scale, wt = _prepare_cuda(x, plan.kp, w_i8)
        err = _library().ucf_int8_gemm(
            xq.data_ptr(), wt.data_ptr(), wscale.data_ptr(), scale.data_ptr(), y.data_ptr(),
            m, k, n, plan.kp, plan.grid, int(plan.route == "tma"), _KERNEL_DTYPES[out_dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, "int8_gemm")
    int8_matmul.launches += 1
    return y


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The quantization of `int8_matmul` alone: x `[M, K]` (f32 or bf16) ->
    `(xq [M, Kp] int8, scale [M] float32)`, Kp = K rounded up to 128, xq zero
    past K. A CPU tensor goes through `quantize_rows_plain` (padded); a CUDA
    tensor launches `int8_prepare` without weights (and adds one to
    `quantize_rows.launches`) or raises."""
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"quantize_rows takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 2 or x.shape[0] == 0 or not 1 <= x.shape[1] <= MAX_K:
        raise ValueError(f"quantize_rows takes x [M, K] with M >= 1 and 1 <= K <= {MAX_K}, "
                         f"got {tuple(x.shape)}")
    m, k = x.shape
    kp = _ceil(k, INT8_K_SLICE) * INT8_K_SLICE
    if x.device.type == "cpu":
        xq, scale = quantize_rows_plain(x)
        return torch.nn.functional.pad(xq, (0, kp - k)), scale
    if x.device.type != "cuda":
        raise RuntimeError(f"quantize_rows runs on cpu or cuda, not {x.device.type}")
    with torch.cuda.device(x.device):
        xq, scale, _ = _prepare_cuda(x.contiguous(), kp)
    quantize_rows.launches += 1
    return xq, scale


def int8_matmul(x: torch.Tensor, w_i8: torch.Tensor, wscale: torch.Tensor, *,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """`y [M, N] ~= x [M, K] @ (w_i8 * wscale[None, :])` in W8A8 int8 math.

    x is the raw (bf16 or f32) activation; its per-row quantization happens
    on the chip, in the first of the two kernels, which also turns w_i8
    K-major into a workspace of the call. `w_i8 [K, N]` and `wscale
    [N]` come from `quantize_weight`. Returns `out_dtype` (default: x's). A
    CPU tensor goes through the plain version; a CUDA tensor launches both
    kernels (and adds one to `int8_matmul.launches`) or raises."""
    out_dtype = out_dtype or x.dtype
    _check(x, w_i8, wscale, out_dtype)
    if x.device.type == "cpu":
        return int8_matmul_plain(x, w_i8, wscale, out_dtype)
    if x.device.type != "cuda":
        raise RuntimeError(f"int8_matmul runs on cpu or cuda, not {x.device.type}")
    return _int8_matmul_cuda(x, w_i8, wscale, out_dtype)


# Calls that launched the kernels since the count was last set to 0 (CPU calls do not
# count).
int8_matmul.launches = 0
quantize_rows.launches = 0
