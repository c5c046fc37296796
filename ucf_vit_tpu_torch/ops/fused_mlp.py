"""Fused transformer MLP: fc1 -> GELU -> fc2 in one Hopper CUDA kernel, and
its plain version (port of `ucf_vit_tpu/ops/fused_mlp.py`).

`csrc/fused_mlp.cu` replaces the Pallas TPU kernel `_fwd_kernel`
(`ucf_vit_tpu/ops/fused_mlp.py:55`, launched by `_fwd_call` `:63`): per tile
of rows it computes `gelu(x @ w1 + b1) @ w2 + b2` with both products
accumulated in f32, the GELU in f32 (tanh form or erf form), and the hidden
rounded to `x.dtype` before the second product, so the hidden `[M, H]` never
reaches device memory. As in the JAX package it is an op of its own, wired
into no model, and it has no backward.

The kernel's limits (its own, not the TPU kernel's VMEM rules): f32 or bf16,
`D <= 1024` (the 32 x D output tile lives in the registers of one block),
any M and H (ragged edges are masked inside). See the source for the design
and its bound on the card.

`fused_mlp` takes the plain version for a tensor on the CPU and the kernel
for a tensor on a CUDA device; anything else raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

MAX_D = 1024
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def fused_mlp_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                    b2: torch.Tensor, *, approx: bool = True) -> torch.Tensor:
    """The kernel's function in plain PyTorch (the counterpart of
    `fused_mlp_reference`, `ucf_vit_tpu/ops/fused_mlp.py:86`): f32 products
    of the inputs as they are (a bf16 value is exact in f32), f32 bias add
    and GELU, the hidden rounded to `x.dtype`, the result cast to `x.dtype`."""
    h = x.float() @ w1.float() + b1.float()
    h = F.gelu(h, approximate="tanh" if approx else "none")
    y = h.to(x.dtype).float() @ w2.float() + b2.float()
    return y.to(x.dtype)


def _check(x, w1, b1, w2, b2) -> None:
    if x.dim() < 1 or w1.dim() != 2 or w2.dim() != 2 or b1.dim() != 1 or b2.dim() != 1:
        raise ValueError("fused_mlp takes x [..., D], w1 [D, H], b1 [H], w2 [H, D], b2 [D]")
    d, h = w1.shape
    if x.shape[-1] != d or w2.shape != (h, d) or b1.shape != (h,) or b2.shape != (d,):
        raise ValueError(
            f"incompatible shapes x {tuple(x.shape)}, w1 {tuple(w1.shape)}, b1 {tuple(b1.shape)}, "
            f"w2 {tuple(w2.shape)}, b2 {tuple(b2.shape)}")
    # the kernel's limits, held on every device so that a shape the card would
    # refuse does not pass on the CPU
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"fused_mlp takes float32 or bfloat16, got {x.dtype}")
    if w1.dtype != x.dtype or w2.dtype != x.dtype:
        raise ValueError(f"w1 ({w1.dtype}) and w2 ({w2.dtype}) must have x's dtype {x.dtype}")
    if d > MAX_D:
        raise ValueError(f"fused_mlp takes D <= {MAX_D}, got {d}")
    if x.numel() == 0:
        raise ValueError("fused_mlp needs at least one row")
    if any(t.device != x.device for t in (w1, b1, w2, b2)):
        raise ValueError("fused_mlp needs all of its inputs on one device")
    if any(t.requires_grad for t in (x, w1, b1, w2, b2)) and torch.is_grad_enabled():
        raise RuntimeError(
            "fused_mlp has no backward (neither has the kernel it ports): call it under "
            "torch.no_grad() or on tensors that do not require grad")


def _library():
    from ucf_vit_tpu_torch.ops.build import load

    fn = load("fused_mlp").ucf_fused_mlp
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _fused_mlp_cuda(x, w1, b1, w2, b2, approx: bool) -> torch.Tensor:
    d, h = w1.shape
    m = x.numel() // d
    x2 = x.reshape(m, d).contiguous()
    w1, w2 = w1.contiguous(), w2.contiguous()
    b1, b2 = b1.float().contiguous(), b2.float().contiguous()
    y = torch.empty_like(x2)
    fn = _library()
    with torch.cuda.device(x.device):
        err = fn(x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                 y.data_ptr(), m, d, h, _KERNEL_DTYPES[x.dtype], int(bool(approx)),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_mlp kernel launch failed: CUDA error {err}")
    fused_mlp.launches += 1
    return y.view(x.shape)


def fused_mlp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
              b2: torch.Tensor, *, approx: bool = True) -> torch.Tensor:
    """`gelu(x @ w1 + b1) @ w2 + b2`, the hidden never leaving the chip.

    x `[..., D]`; w1 `[D, H]`; w2 `[H, D]` (the JAX layouts: this is an op,
    not an `nn.Linear`); b1 `[H]`, b2 `[D]`. Returns `[..., D]` in x's dtype.
    A CPU tensor goes through the plain version; a CUDA tensor launches the
    kernel (and adds one to `fused_mlp.launches`) or raises. Tensors that
    require grad raise: there is no backward."""
    _check(x, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return fused_mlp_plain(x, w1, b1, w2, b2, approx=approx)
    if x.device.type != "cuda":
        raise RuntimeError(f"fused_mlp runs on cpu or cuda, not {x.device.type}")
    return _fused_mlp_cuda(x, w1, b1, w2, b2, approx)


# Kernel launches since the count was last set to 0 (CPU calls do not count).
fused_mlp.launches = 0
