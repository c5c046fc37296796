"""Fused transformer MLP: fc1 -> GELU -> fc2 in one Hopper CUDA kernel, and
its plain version (port of `ucf_vit_tpu/ops/fused_mlp.py`).

The kernels replace the Pallas TPU kernel `_fwd_kernel`
(`ucf_vit_tpu/ops/fused_mlp.py:55`, launched by `_fwd_call` `:63`): per tile
of rows they compute `gelu(x @ w1 + b1) @ w2 + b2` with both products
accumulated in f32, the GELU in f32 (tanh form or erf form), and the hidden
rounded to `x.dtype` before the second product, so the hidden `[M, H]` never
reaches device memory. As in the JAX package it is an op of its own, wired
into no model, and it has no backward.

The dtype picks the source (`fused_mlp.by_source` counts them):
- bf16: `csrc/fused_mlp_sm90.cu`, both products on the tensor cores by
  `wgmma`, fed by TMA. A cluster of one or two blocks owns 64 rows: each block
  a half of D's columns and every other 64-unit chunk of the hidden, which it
  copies to the other block's shared memory. `mlp_plan` decides the blocks of
  a cluster, their output warpgroups, how H is split across clusters (S), and
  the route (`fused_mlp.by_layout`): "tma" loads x, w1 and w2 as they are;
  "padded" first makes zero-padded copies with D and H rounded up to
  multiples of 8 (TMA's rows are multiples of 16 bytes) and a 16-byte aligned
  base, and slices y back. At S > 1 each block writes an f32 partial into a
  workspace `[S, M, D]` that a second kernel sums in a fixed order.
- f32: `csrc/fused_mlp_tf32.cu`, both products f32-accurate on the tensor
  cores by the 3xTF32 split on `mma.sync`. A cluster of G = ceil(D / 384)
  blocks owns 64 rows, each block a slice of D's columns (at most 384): its
  slice of x stays in shared memory, it multiplies it by its rows of W1 for
  each 64-unit chunk of the hidden, the G partial chunks are summed through
  distributed shared memory, and each block adds the chunk's product with
  its columns of W2 into its slice of y. Weights stream in by `cp.async`
  (4-byte copies where D or H is no multiple of 4 or a base is not 16-byte
  aligned), so every shape and alignment runs as it is: there is no padded
  copy and no route. `mlp_plan_f32` decides G, the columns a block and S
  (as in bf16, with a workspace and a fixed-order sum at S > 1).

Both are timed by `python3 chip_smoke.py` (the kernels phase: device ms of a
call beside its bound, the plain version and the unfused library calls) and
`python3 chip_smoke.py --compare CHECKOUT` (both types at ViT-B's shape, in
this tree and another).

The limits, held on every device so that a shape the card would refuse does
not pass on the CPU: f32 or bf16, `D <= 1024` (the output tile of a block
lives in its registers), any M and H. See the sources for the designs and
their bounds on the card.

`fused_mlp` takes the plain version for a tensor on the CPU and a kernel for
a tensor on a CUDA device; anything else raises. There is no fallback: a call
that cannot build, launch or (bf16) encode its tensor maps raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

MAX_D = 1024
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SOURCES = ("fused_mlp_sm90", "fused_mlp_tf32")  # bf16, f32
ROUTES = ("tma", "padded")
# csrc/fused_mlp_sm90.cu: rows a block, hidden units a chunk, the most output columns a
# warpgroup holds, and the widest D one block takes alone (two output warpgroups: the
# registers' limit); wider D splits over a cluster of two
MLP_ROWS, MLP_CHUNK, MLP_WG_COLS, MLP_BLOCK_COLS = 64, 64, 256, 512
_ENCODE_FAILED = 10000  # csrc/sm90.cuh: ENCODE_FAILED (+ the driver's CUresult)
# csrc/fused_mlp_tf32.cu: the widest slice of D a block takes, the columns of a slice
# come in multiples of 128, and the shared memory a block may have (232,448 bytes on an
# H100); the ring of weight pieces takes what x, h and the receive slots leave, up to 8
F32_BLOCK_COLS, F32_COL_STEP, SMEM_LIMIT, F32_MAX_STAGES = 384, 128, 232448, 8
F32_PIECES = 4  # pieces a 64-unit chunk of each weight streams in


class MlpPlan(NamedTuple):
    """How `csrc/fused_mlp_sm90.cu` takes one call (`mlp_plan`)."""
    route: str       # "tma": x, w1, w2 as they are; "padded": zero-padded copies first
    d_pad: int       # D' = ceil8(D), the width the kernel sees
    h_pad: int       # H' = ceil8(H)
    groups: int      # blocks of a cluster: each owns group_cols of D, the hidden is shared
    group_cols: int  # columns a block: ceil(D' / groups) rounded up to 64
    warpgroups: int  # output warpgroups a block, up to 256 columns each
    splits: int      # S: H split across clusters, each adding an f32 partial
    row_tiles: int   # ceil(M / 64)
    blocks: int      # row_tiles * groups * splits


class MlpPlanF32(NamedTuple):
    """How `csrc/fused_mlp_tf32.cu` takes one call (`mlp_plan_f32`)."""
    groups: int      # G: blocks of a cluster, each with group_cols of D's columns
    group_cols: int  # ceil(D / G) rounded up to 128: the block's slice of x and of y
    stages: int      # weight pieces in flight: the ring's stages
    smem: int        # bytes of shared memory a block
    splits: int      # S: H split across clusters, each adding an f32 partial
    row_tiles: int   # ceil(M / 64)
    blocks: int      # row_tiles * groups * splits


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _f32_smem(group_cols: int, groups: int):
    """(ring stages, bytes) of a block of csrc/fused_mlp_tf32.cu: x [64, DK + 16], h
    [64, 80], slots of 64 x 64 for its own partial and the peers' (two for the other
    block of a cluster of two, one for each other block of a cluster of three), b1 [2,
    64], and stages of max(W1 piece, W2 piece) (f32, rows padded 8 floats past the data;
    4 pieces of each a chunk)."""
    stage = 4 * max(group_cols // F32_PIECES * (MLP_CHUNK + 8),
                    MLP_CHUNK // F32_PIECES * (group_cols + 8))
    fixed = 4 * (MLP_ROWS * (group_cols + 16) + MLP_ROWS * (MLP_CHUNK + 16)
                 + (1 + (2 if groups == 2 else 1) * (groups - 1)) * MLP_ROWS * MLP_CHUNK
                 + 2 * MLP_CHUNK)
    stages = min(F32_MAX_STAGES, (SMEM_LIMIT - fixed) // stage)
    return stages, fixed + stages * stage


@functools.lru_cache(maxsize=256)
def mlp_plan(m: int, d: int, h: int, sms: int, aligned: bool = True) -> MlpPlan:
    """The bf16 kernel's plan for x `[m, d]`, w1 `[d, h]` on a card of `sms`
    SMs (pure Python, decided before the launch). `aligned`: x, w1 and w2 are
    contiguous with 16-byte aligned bases; where they are not, or where D or H
    is no multiple of 8, the route is "padded". One block takes up to 512
    columns; wider D takes a cluster of two blocks, each with half of the
    columns. H is split into S slices of whole 64-unit chunks, as many as fill
    the SMs with one block each (at least one chunk a slice)."""
    d_pad, h_pad = _ceil(d, 8) * 8, _ceil(h, 8) * 8
    route = "tma" if aligned and d_pad == d and h_pad == h else "padded"
    groups = 1 if d_pad <= MLP_BLOCK_COLS else 2
    group_cols = _ceil(_ceil(d_pad, groups), 64) * 64
    warpgroups = _ceil(group_cols, MLP_WG_COLS)
    row_tiles = _ceil(m, MLP_ROWS)
    chunks = _ceil(h_pad, MLP_CHUNK)
    splits = max(1, min(chunks, sms // (row_tiles * groups)))
    splits = _ceil(chunks, _ceil(chunks, splits))  # no empty slice
    return MlpPlan(route, d_pad, h_pad, groups, group_cols, warpgroups, splits, row_tiles,
                   row_tiles * splits * groups)


@functools.lru_cache(maxsize=256)
def mlp_plan_f32(m: int, d: int, h: int, sms: int) -> MlpPlanF32:
    """The f32 kernel's plan for x `[m, d]`, w1 `[d, h]` on a card of `sms`
    SMs (pure Python, decided before the launch; the C entry refuses another
    G, and its `ucf_fused_mlp_tf32_shape` gives the columns and the shared
    memory that `chip_smoke.py` holds these against). A block takes up to
    384 of D's columns, so D > 384 takes a cluster of two blocks and D > 768
    of three. H is split into S slices of whole 64-unit chunks, as many as
    fill the SMs with one block each."""
    groups = _ceil(d, F32_BLOCK_COLS)
    group_cols = _ceil(_ceil(d, groups), F32_COL_STEP) * F32_COL_STEP
    stages, smem = _f32_smem(group_cols, groups)
    row_tiles = _ceil(m, MLP_ROWS)
    chunks = _ceil(h, MLP_CHUNK)
    splits = max(1, min(chunks, sms // (row_tiles * groups)))
    splits = _ceil(chunks, _ceil(chunks, splits))  # no empty slice
    return MlpPlanF32(groups, group_cols, stages, smem, splits, row_tiles,
                      row_tiles * splits * groups)


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


_ARGTYPES = {
    "fused_mlp_tf32": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    "fused_mlp_sm90": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
}


def _library(source: str):
    from ucf_vit_tpu_torch.ops.build import load

    fn = getattr(load(source), f"ucf_{source}")
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[source]
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _padded_copy(t: torch.Tensor, shape) -> torch.Tensor:
    """A fresh contiguous zero tensor of `shape` with `t` in its leading corner:
    rows of a multiple of 16 bytes on a 16-byte aligned base."""
    out = t.new_zeros(shape)
    out[tuple(slice(0, n) for n in t.shape)] = t
    return out


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _fused_mlp_tf32(x2, w1, b1, w2, b2, approx: bool) -> torch.Tensor:
    """f32: csrc/fused_mlp_tf32.cu, by the plan of `mlp_plan_f32`."""
    m, d = x2.shape
    h = w1.shape[1]
    w1, w2 = w1.contiguous(), w2.contiguous()
    b1, b2 = b1.float().contiguous(), b2.float().contiguous()
    plan = mlp_plan_f32(m, d, h, _sm_count(x2.device.index))
    y = torch.empty_like(x2)
    ws = (torch.empty((plan.splits, m, d), dtype=torch.float32, device=x2.device)
          if plan.splits > 1 else None)
    err = _library("fused_mlp_tf32")(
        x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        y.data_ptr(), ws.data_ptr() if ws is not None else None, m, d, h, plan.groups,
        plan.splits, int(bool(approx)), _stream(x2))
    if err != 0:
        raise RuntimeError(f"fused_mlp_tf32 kernel launch failed: CUDA error {err}")
    return y


def _fused_mlp_sm90(x2, w1, b1, w2, b2, approx: bool) -> torch.Tensor:
    """bf16: csrc/fused_mlp_sm90.cu, by the plan of `mlp_plan`."""
    m, d = x2.shape
    h = w1.shape[1]
    w1, w2 = w1.contiguous(), w2.contiguous()
    aligned = all(t.data_ptr() % 16 == 0 for t in (x2, w1, w2))
    plan = mlp_plan(m, d, h, _sm_count(x2.device.index), aligned)
    dp, hp = plan.d_pad, plan.h_pad
    if plan.route == "padded":
        x2 = _padded_copy(x2, (m, dp))
        w1, w2 = _padded_copy(w1, (dp, hp)), _padded_copy(w2, (hp, dp))
    # the biases are read as they are when both are bf16 (or both f32), else in f32
    bias_bf16 = b1.dtype == b2.dtype == torch.bfloat16
    b1, b2 = (b1, b2) if bias_bf16 else (b1.float(), b2.float())
    b1 = b1.contiguous() if hp == h else _padded_copy(b1, (hp,))
    b2 = b2.contiguous() if dp == d else _padded_copy(b2, (dp,))
    y = torch.empty((m, dp), dtype=x2.dtype, device=x2.device)
    ws = (torch.empty((plan.splits, m, dp), dtype=torch.float32, device=x2.device)
          if plan.splits > 1 else None)
    err = _library("fused_mlp_sm90")(
        x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        y.data_ptr(), ws.data_ptr() if ws is not None else None, m, dp, hp,
        plan.warpgroups, plan.groups, plan.splits, int(bias_bf16), int(bool(approx)),
        _stream(x2))
    if err >= _ENCODE_FAILED:
        raise RuntimeError(f"fused_mlp_sm90: cuTensorMapEncodeTiled failed (CUresult "
                           f"{err - _ENCODE_FAILED}; 0: the driver entry point was not found)")
    if err != 0:
        raise RuntimeError(f"fused_mlp_sm90 kernel launch failed: CUDA error {err}")
    fused_mlp.by_layout[plan.route] += 1
    return y if dp == d else y[:, :d]


def _fused_mlp_cuda(x, w1, b1, w2, b2, approx: bool) -> torch.Tensor:
    d = w1.shape[0]
    m = x.numel() // d
    x2 = x.reshape(m, d)
    if not x2.is_contiguous():
        x2 = x2.contiguous()
    source = SOURCES[0] if x.dtype == torch.bfloat16 else SOURCES[1]
    with torch.cuda.device(x.device):
        if source == "fused_mlp_sm90":
            y = _fused_mlp_sm90(x2, w1, b1, w2, b2, approx)
        else:
            y = _fused_mlp_tf32(x2, w1, b1, w2, b2, approx)
    fused_mlp.launches += 1
    fused_mlp.by_source[source] += 1
    return y.reshape(x.shape)


def fused_mlp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
              b2: torch.Tensor, *, approx: bool = True) -> torch.Tensor:
    """`gelu(x @ w1 + b1) @ w2 + b2`, the hidden never leaving the chip.

    x `[..., D]`; w1 `[D, H]`; w2 `[H, D]` (the JAX layouts: this is an op,
    not an `nn.Linear`); b1 `[H]`, b2 `[D]`. Returns `[..., D]` in x's dtype.
    A CPU tensor goes through the plain version; a CUDA tensor launches the
    kernel of its dtype (and adds one to `fused_mlp.launches`, to
    `fused_mlp.by_source` and, in bf16, to `fused_mlp.by_layout`) or raises.
    Tensors that require grad raise: there is no backward."""
    _check(x, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return fused_mlp_plain(x, w1, b1, w2, b2, approx=approx)
    if x.device.type != "cuda":
        raise RuntimeError(f"fused_mlp runs on cpu or cuda, not {x.device.type}")
    return _fused_mlp_cuda(x, w1, b1, w2, b2, approx)


def reset_launch_counts() -> None:
    """Set `fused_mlp`'s launch counts to 0 (CPU calls never count)."""
    fused_mlp.launches = 0
    fused_mlp.by_source = {source: 0 for source in SOURCES}
    fused_mlp.by_layout = {route: 0 for route in ROUTES}


reset_launch_counts()
