"""W8A8 int8 GEMM with the activation quantized inside a Hopper CUDA kernel,
and its plain version (port of `ucf_vit_tpu/ops/int8_gemm.py`).

`quantize_weight` quantizes the weights once, offline, per output channel
(plain torch, as it is plain XLA in the JAX package). `csrc/int8_gemm.cu`
replaces the Pallas TPU kernel `_kernel` (`ucf_vit_tpu/ops/int8_gemm.py:61`,
launched by `int8_matmul` `:81`): per row of x over the full K it takes
`scale = max(max|x|, 1e-8) / 127`, quantizes `xq = clip(round(x / scale),
+-127)` to int8 on the chip (xq never reaches device memory), multiplies
int8 x int8 into int32 and rescales `acc * scale * wscale` into the output
type. As in the JAX package it is an op of its own, wired into no model or
server.

The kernel's limits (its own, not the TPU kernel's tile and VMEM rules):
x f32 or bf16, output f32 or bf16, any M, `K <= 6144` (the quantized 32 x K
tile stays in shared memory), `N % 4 == 0` (the weights are read four
columns at a time). See the source for the design and its bound on the card.

`int8_matmul` takes the plain version for a tensor on the CPU and the kernel
for a tensor on a CUDA device; anything else raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

MAX_K = 6144
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


def int8_matmul_plain(x: torch.Tensor, w_i8: torch.Tensor, wscale: torch.Tensor,
                      out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch (the counterpart of
    `int8_matmul_reference`, `:127`): quantize, integer product, rescale, as
    separate passes. `torch.round` rounds half to even, as `jnp.round` does.
    The integer product runs in int32 on the CPU and, where the device has
    no integer matmul, in f64, which is exact for these sizes (|acc| <= 127 *
    127 * K < 2^53)."""
    out_dtype = out_dtype or x.dtype
    xf = x.float()
    row_scale = _scale(xf.abs().amax(dim=1, keepdim=True))
    xq = torch.round(xf / row_scale).clamp_(-127, 127)
    if x.device.type == "cpu":
        acc = (xq.to(torch.int32) @ w_i8.to(torch.int32)).float()
    else:
        acc = (xq.double() @ w_i8.double()).float()
    y = acc * row_scale * wscale.float()[None, :]
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

    fn = load("int8_gemm").ucf_int8_gemm
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _int8_matmul_cuda(x, w_i8, wscale, out_dtype) -> torch.Tensor:
    m, k = x.shape
    n = w_i8.shape[1]
    x, w_i8 = x.contiguous(), w_i8.contiguous()
    wscale = wscale.float().contiguous()
    y = torch.empty((m, n), dtype=out_dtype, device=x.device)
    fn = _library()
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w_i8.data_ptr(), wscale.data_ptr(), y.data_ptr(), m, k, n,
                 _KERNEL_DTYPES[x.dtype], _KERNEL_DTYPES[out_dtype],
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8_gemm kernel launch failed: CUDA error {err}")
    int8_matmul.launches += 1
    return y


def int8_matmul(x: torch.Tensor, w_i8: torch.Tensor, wscale: torch.Tensor, *,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """`y [M, N] ~= x [M, K] @ (w_i8 * wscale[None, :])` in W8A8 int8 math.

    x is the raw (bf16 or f32) activation; its per-row quantization happens
    inside the kernel. `w_i8 [K, N]` and `wscale [N]` come from
    `quantize_weight`. Returns `out_dtype` (default: x's). A CPU tensor goes
    through the plain version; a CUDA tensor launches the kernel (and adds
    one to `int8_matmul.launches`) or raises."""
    out_dtype = out_dtype or x.dtype
    _check(x, w_i8, wscale, out_dtype)
    if x.device.type == "cpu":
        return int8_matmul_plain(x, w_i8, wscale, out_dtype)
    if x.device.type != "cuda":
        raise RuntimeError(f"int8_matmul runs on cpu or cuda, not {x.device.type}")
    return _int8_matmul_cuda(x, w_i8, wscale, out_dtype)


# Kernel launches since the count was last set to 0 (CPU calls do not count).
int8_matmul.launches = 0
