"""Flash attention: Hopper CUDA kernels for the forward and the backward, their
plain versions, and the autograd Function that joins them.

Forward: replaces the Pallas TPU kernel `_fwd_kernel`
(`ucf_vit_tpu/ops/flash_attention.py:68`, launched by `_flash_fwd_len`
`:543`). Online-softmax attention with the running max, normaliser and
accumulator in f32; keys past the true length masked with -0.7 * f32 max;
`lse = m + log(max(l, 1e-37))` as f32 `[B*H, Nq]`. With a dropout rate the
probabilities are dropped after the normaliser update (the hash mask of
`ops/attn_dropout.py`), so `lse` stays the pre-dropout value.

Backward: replaces `_bwd_fused_kernel` (`:249`, the route "fused") and the
pair `_bwd_dkv_kernel` + `_bwd_dq_kernel` (`:162`, `:362`, the route
"split"), launched by `_flash_bwd_len` `:651`. `di = rowsum(do * o)` stays a
plain torch reduction, as it is XLA outside the kernel in JAX (`:662`). The
fused kernels add dq with f32 atomics into a zeroed f32 workspace, so dq's
order of sums changes from run to run; the split route has no atomics, and
gives the same bits from run to run.

The dtype picks the source, the kind (fused, dkv, dq) its kernel. bf16 runs on
the tensor cores by `wgmma`: `csrc/flash_fwd_sm90.cu` (forward: TMA loads
into an mbarrier ring fed by a producer warp, a persistent grid) and
`csrc/flash_bwd_sm90.cu` (fused, dkv and dq). The bf16 forward's tensor maps
come from `fwd_layout`, decided from the strides and pointers before each
launch: q, k, v load as they are, or a tensor TMA cannot address is first
copied (the route "padded", counted in `flash_attention.by_layout`). f32 runs
on the tensor cores too, f32-accurate by the 3xTF32 split on `mma.sync`
(`csrc/tf32x3.cuh`: each operand split into two TF32 parts, three TF32
products summed in f32): `csrc/flash_fwd_tf32.cu` and `csrc/flash_bwd_tf32.cu`
(fused, dkv and dq).
Bounds on an H100 at the training shape `[B*H = 192, N = 257, dh = 64]`:
forward 3.25 GFLOP, backward 8.12 GFLOP (five products; dkv four, dq three).
In f32 an f32-accurate product costs three TF32 ones, so all are bound by
operations at 3 x FLOP over the TF32 rate (0.0197 and 0.0492 ms at 495
TFLOP/s); in bf16 by bytes (25 and 45 MB: 0.0076 and 0.0133 ms).

`flash_attention` takes the plain version for a tensor on the CPU and the
kernel for a tensor on a CUDA device; anything else raises. On a tensor that
needs grad it goes through `FlashAttentionFn`, whose backward is the
backward kernel (or its plain version, on the CPU).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ucf_vit_tpu_torch.ops.attn_dropout import dense_keep_mask, keep_mask, keep_threshold

DEFAULT_MASK_VALUE = -0.7 * torch.finfo(torch.float32).max
MAX_HEAD_DIM = 128
_BWD_KINDS = {"fused": 0, "dkv": 1, "dq": 2}
# The source (csrc/<name>.cu) of each kernel, by dtype; a backward source holds every kind
_FWD_SOURCES = {torch.float32: "flash_fwd_tf32", torch.bfloat16: "flash_fwd_sm90"}
_BWD_SOURCES = {torch.float32: "flash_bwd_tf32", torch.bfloat16: "flash_bwd_sm90"}
# The backward's routes: the fused kernel, or the split route's dkv + dq pair
BWD_ROUTES = ("fused", "split")
# `bwd_route` takes the split route from this many queries on, by dtype. From the card's
# device times of both routes, timed in turns (chip_smoke.py's [route] lines; NVIDIA H100
# 80GB HBM3 at 700 W; PERF.md §6, "Routes"), in ms a call:
# - f32: split faster at 8448 queries x 640 keys (1.92 against 2.28) and at 32768^2 (193.6
#   against 208.4), level at 4096^2 (3.35 against 3.32), fused faster at 257 and fewer
#   (ViT-B/16's [192, 257, 64]: 0.382 against 0.479).
# - bf16: split faster at mae_long's decoder, [2, 6, 32768^2, 96] (66.6 against 76.0);
#   fused faster at its encoder, [2, 12, 8192^2, 64] (4.02 against 4.81), at 16384^2 (13.8
#   against 16.7) and at 257 (ViT-L/16's [128, 257, 64]: 0.095 against 0.107). Off the model
#   paths the threshold misses two shapes: 8448 x 640, where split is faster (0.45 against
#   0.57), and 32768^2 at one batch entry of 6 heads, where fused is (27.9 against 33.0):
#   the fused kernel's time per head grows from 6 heads to 12 at that length, the split
#   route's does not.
SPLIT_MIN_QUERIES = {torch.float32: 8192, torch.bfloat16: 32768}
# The bf16 forward's routes into its kernel (`fwd_layout`)
FWD_LAYOUTS = ("tma", "padded")
# The head-dim instances (template DH) each source compiles; its C entry launches the
# smallest that holds the call's dh (`dispatch_dh` in csrc/)
_INSTANCES = {"flash_fwd_tf32": (48, 64, 96, 128), "flash_bwd_tf32": (48, 64, 96, 128),
              "flash_fwd_sm90": (64, 128), "flash_bwd_sm90": (64, 128)}


def kernel_instance(source: str, dh: int) -> str:
    """The instance of `source` that a call at head dim `dh` launches, as
    `"<source><DH>"` (the key of the `by_instance` counts)."""
    for d in _INSTANCES[source]:
        if dh <= d:
            return f"{source}<{d}>"
    raise ValueError(f"{source} takes head dims up to {_INSTANCES[source][-1]}, got {dh}")


def _instance_counts(sources) -> dict:
    return {f"{s}<{d}>": 0 for s in sources for d in _INSTANCES[s]}


# ---------------------------------------------------------------- plain versions


def _keep(q: torch.Tensor, n_kv: int, rate: float, seed: int, row0: int, col0: int):
    b, h, n_q, _ = q.shape
    return dense_keep_mask(seed, b * h, n_q, n_kv, rate, row0=row0, col0=col0,
                           device=q.device).view(b, h, n_q, n_kv)


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float,
    dropout_rate: float = 0.0, seed: int = 0, row0: int = 0, col0: int = 0,
    f32_o: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's function in plain PyTorch: `(o, lse)` for q
    `[B, H, Nq, dh]` and k, v `[B, H, Nkv, dh]`, computed in f32. o has q's
    dtype (f32 with `f32_o`), lse is f32 `[B*H, Nq]` (pre-dropout).

    It stays apart from `ops.attention.einsum_attention` on purpose: that one
    is the port of the JAX package's EINSUM impl and keeps its dtype rules
    (q * scale and the q.k product in the input dtype, p rounded to v's dtype
    before p.v), so bf16 EINSUM matches JAX; this one is the kernel's oracle,
    f32 throughout, the way the kernel computes, and also returns lse."""
    b, h, n_q, _ = q.shape
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    if dropout_rate > 0.0:
        keep = _keep(q, k.shape[2], dropout_rate, seed, row0, col0)
        p = torch.where(keep, p * (1.0 / (1.0 - dropout_rate)), 0.0)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return (o if f32_o else o.to(q.dtype)), lse.reshape(b * h, n_q)


def _plain_p_dp(q, k, v, o, lse, do, sm_scale, rate, seed, row0, col0):
    """What every backward kernel forms first, in f32: `p = exp(s - lse)`
    (pre-dropout), `dp_v - di` with `dp_v = keep ? (do v^T) / (1 - r) : 0` and
    `di = rowsum(do * o)`, the keep mask (None at rate 0) and do in f32."""
    b, h, n_q, _ = q.shape
    dof = do.float()
    di = (o.float() * dof).sum(-1, keepdim=True)
    p = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()).mul_(sm_scale)
    p.sub_(lse.view(b, h, n_q, 1)).exp_()
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, v.float())
    keep = None
    if rate > 0.0:
        keep = _keep(q, k.shape[2], rate, seed, row0, col0)
        dp = torch.where(keep, dp * (1.0 / (1.0 - rate)), 0.0)
    return p, dp.sub_(di), keep, dof


def _plain_dv(p, keep, dof, rate):
    """`dv = p_v^T do`, with `p_v = keep ? p / (1 - r) : 0`."""
    p_v = p if keep is None else torch.where(keep, p * (1.0 / (1.0 - rate)), 0.0)
    return torch.einsum("bhqk,bhqd->bhkd", p_v, dof)


def flash_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    do: torch.Tensor, sm_scale: float, dropout_rate: float = 0.0, seed: int = 0,
    row0: int = 0, col0: int = 0, f32_dq: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' function in plain PyTorch, by their formula, in
    f32: `di = rowsum(do * o)`, `p = exp(s - lse)`, `p_v = keep ? p / (1 - r)
    : 0`, `dv = p_v^T do`, `dp = keep ? (do v^T) / (1 - r) : 0`, `ds = p (dp -
    di) scale`, `dk = ds^T q`, `dq = ds k`. Returns `(dq, dk, dv)` in the
    inputs' dtype (dq in f32 with `f32_dq`): the fused kernel's outputs, and
    the split route's."""
    p, dp_di, keep, dof = _plain_p_dp(q, k, v, o, lse, do, sm_scale, dropout_rate, seed,
                                      row0, col0)
    dv = _plain_dv(p, keep, dof, dropout_rate)
    del keep
    ds = p.mul_(dp_di).mul_(sm_scale)
    del dp_di
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float())
    return dq if f32_dq else dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_dkv_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    do: torch.Tensor, sm_scale: float, dropout_rate: float = 0.0, seed: int = 0,
    row0: int = 0, col0: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dkv kernel's function in plain PyTorch (four products):
    `(dk, dv)` of `flash_attention_bwd_plain`, in the inputs' dtype."""
    p, dp_di, keep, dof = _plain_p_dp(q, k, v, o, lse, do, sm_scale, dropout_rate, seed,
                                      row0, col0)
    dv = _plain_dv(p, keep, dof, dropout_rate)
    dk = torch.einsum("bhqk,bhqd->bhkd", p.mul_(dp_di).mul_(sm_scale), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_dq_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    do: torch.Tensor, sm_scale: float, dropout_rate: float = 0.0, seed: int = 0,
    row0: int = 0, col0: int = 0,
) -> torch.Tensor:
    """The dq kernel's function in plain PyTorch (three products): dq of
    `flash_attention_bwd_plain`, in q's dtype."""
    p, dp_di, _, _ = _plain_p_dp(q, k, v, o, lse, do, sm_scale, dropout_rate, seed, row0, col0)
    return torch.einsum("bhqk,bhkd->bhqd", p.mul_(dp_di).mul_(sm_scale), k.float()).to(q.dtype)


# ---------------------------------------------------------------- kernels


_LONG3 = [ctypes.c_longlong] * 3
# dropout, seed, threshold, row0, col0, inv_keep, stream
_DROPOUT_ARGS = [ctypes.c_int, ctypes.c_uint, ctypes.c_uint, ctypes.c_int, ctypes.c_int,
                 ctypes.c_float, ctypes.c_void_p]
_FWD_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + _LONG3 * 4 + [ctypes.c_float]
# per tensor map: dims d0..d3, byte strides s1..s3, the head's column step
_MAP_ARGS = [ctypes.c_longlong] * 7 + [ctypes.c_int]
_FWD_TMA_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + _MAP_ARGS * 3 + [ctypes.c_int] * 2
                 + _LONG3 + [ctypes.c_int, ctypes.c_float])
_BWD_ARGS = [ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + _LONG3 * 7 + [
    ctypes.c_float]
_ARGTYPES = {  # each source's C entry `ucf_<name>`
    "flash_fwd_tf32": _FWD_ARGS + _DROPOUT_ARGS,
    "flash_fwd_sm90": _FWD_TMA_ARGS + _DROPOUT_ARGS,
    "flash_bwd_sm90": _BWD_ARGS + _DROPOUT_ARGS,
    "flash_bwd_tf32": _BWD_ARGS + _DROPOUT_ARGS,
}


_FNS: dict = {}  # source -> its bound C entry, once loaded


def _library(name: str):
    fn = _FNS.get(name)
    if fn is not None:
        return fn
    from ucf_vit_tpu_torch.ops.build import load

    fn = getattr(load(name), f"ucf_{name}")
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    _FNS[name] = fn
    return fn


def _check_shapes(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes [B, H, N, dh] tensors")
    if k.shape != v.shape or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise ValueError(f"incompatible shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")


def _check_kernel_inputs(q, *others) -> None:
    if q.dtype not in _FWD_SOURCES:
        raise TypeError(f"flash kernel takes float32 or bfloat16, got {q.dtype}")
    for t in others:
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("q, k, v (and do) must share one dtype and device")
    for t in (q,) + others:
        if t.stride(-1) != 1:
            raise ValueError("flash kernel needs the last dim of its inputs contiguous")
    dh = q.shape[-1]
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"flash kernel takes head dims 1..{MAX_HEAD_DIM}, got {dh}")
    if q.shape[2] == 0 or others[0].shape[2] == 0:
        raise ValueError("flash kernel needs at least one query and one key")


def _dropout_args(rate: float, seed: int, row0: int, col0: int):
    if rate <= 0.0:
        return (0, 0, 0, 0, 0, 1.0)
    return (1, int(seed) & 0xFFFFFFFF, keep_threshold(rate), int(row0), int(col0),
            1.0 / (1.0 - rate))


def _stream(t: torch.Tensor) -> int:
    """The current stream of t's card, as the raw handle the C entries take."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _tokens_major(b, n, h, dh, dtype, device) -> torch.Tensor:
    """A `[B, H, N, dh]` tensor laid out `[B, N, H, dh]` in memory, so that the
    caller's transpose back to tokens-major and the merge of the heads (or the
    stack into the qkv gradient) read it in order."""
    return torch.empty((b, n, h, dh), dtype=dtype, device=device).transpose(1, 2)


# The bf16 forward's tile as a TMA box: 64 columns (128 bytes, the swizzle's span) by
# 64 rows, one head, one batch entry.
TMA_BOX = (64, 64, 1, 1)
_ENCODE_FAILED = 10000  # csrc/flash_fwd_sm90.cu: ENCODE_FAILED (+ the driver's CUresult)


def _tensor_map(t: torch.Tensor):
    """The TMA tensor map of a bf16 `[B, H, N, dh]` view with its last dim
    contiguous, as the flat tuple `(d0, d1, d2, d3, s1, s2, s3, hcol)`: dims
    innermost first (d0 columns, d1 rows, d2 heads, d3 batch) and the byte
    strides of d1..d3. TMA needs a 16-byte aligned base and strides that are
    multiples of 16 bytes; a dim of extent 1 is never stepped, so its stride is
    free (16 is given). Heads whose stride is no such multiple (dh 36 in a
    packed qkv) merge into dim 0 instead: d2 = 1, and head i's columns start at
    `i * hcol`. A box must start on a 16-byte boundary, so the kernel starts
    head i's box at the multiple of 8 at or below that column, and the head
    then sits up to `8 - gcd(hcol, 8)` columns into the box's 64: the layout
    serves a dh that fits beside that offset. None where TMA cannot address
    the view."""
    b, h, n, dh = t.shape
    return _map_of(b, h, n, dh, t.stride(), t.data_ptr() & 15)


def _map_of(b: int, h: int, n: int, dh: int, stride, misaligned: int):
    """`_tensor_map` of a `[b, h, n, dh]` view with these strides (in
    elements) whose base is `misaligned` bytes past a 16-byte boundary."""
    sb, sh, sn, _ = stride  # elements: a multiple of 8 is 16 bytes
    if misaligned:
        return None
    if sn & 7:
        if n > 1:
            return None
        sn = 8
    if sb & 7:
        if b > 1:
            return None
        sb = 8
    if not sh & 7:
        return (dh, n, h, b, 2 * sn, 2 * sh, 2 * sb, 0)
    if h == 1:
        return (dh, n, 1, b, 2 * sn, 16, 2 * sb, 0)
    if dh + 8 - (sh & -sh) <= 64:
        return ((h - 1) * sh + dh, n, 1, b, 2 * sn, 16, 2 * sb, sh)
    return None


def fwd_layout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor):
    """Which route takes bf16 `q, k, v` into the forward kernel (and writes
    `o`), decided from their strides and pointers before the launch:
    `("tma", maps)` when TMA can load all three as they are, else
    `("padded", maps)`, where a map of None marks a tensor that the wrapper
    first copies to a contiguous `[B, H, N, ceil8(dh)]` (zeros past dh), which
    TMA can load. `maps` holds the tensor maps (`_tensor_map`) of q, k and v,
    each read with the box `TMA_BOX`. q and k must place each head at the same
    column of their boxes (their `hcol` equal modulo 8), or the merged one of
    them is copied. o is written by the kernel's own stores and needs only its
    last dim contiguous."""
    if o.stride(-1) != 1:
        raise ValueError("the flash forward writes o with its last dim contiguous")
    b, h, n_q, dh = q.shape
    return _layout_of(b, h, n_q, k.shape[2], dh, q.stride(), k.stride(), v.stride(),
                      q.data_ptr() & 15, k.data_ptr() & 15, v.data_ptr() & 15)


# A training step hands the forward a few layouts over and over (ViT-L: one, 192 times
# a step): each is worked out once.
@functools.lru_cache(maxsize=256)
def _layout_of(b, h, n_q, n_kv, dh, q_stride, k_stride, v_stride, q_mis, k_mis, v_mis):
    """`fwd_layout` of `[b, h, n, dh]` views (n_q rows for q, n_kv for k and v)
    with these strides, their bases that many bytes past a 16-byte boundary."""
    qm = _map_of(b, h, n_q, dh, q_stride, q_mis)
    km = _map_of(b, h, n_kv, dh, k_stride, k_mis)
    vm = _map_of(b, h, n_kv, dh, v_stride, v_mis)
    # a copy (None) is laid out [B, H, N, ceil8(dh)]: hcol 0
    if ((qm[7] if qm else 0) - (km[7] if km else 0)) % 8:
        qm = qm if qm is None or qm[7] % 8 == 0 else None
        km = km if km is None or km[7] % 8 == 0 else None
    maps = (qm, km, vm)
    return ("padded" if None in maps else "tma"), maps


def _padded(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of `t` with its last dim padded by zeros to a multiple
    of 8 (16 bytes): a layout that TMA can load."""
    dh = t.shape[-1]
    return torch.nn.functional.pad(t, (0, -dh % 8))


def _flash_fwd_cuda(q, k, v, sm_scale: float, rate: float, seed: int, row0: int, col0: int,
                    f32_o: bool = False):
    _check_kernel_inputs(q, k, v)
    b, h, n_q, dh = q.shape
    n_kv = k.shape[2]
    o = _tokens_major(b, n_q, h, dh, torch.float32 if f32_o else q.dtype, q.device)
    lse = torch.empty((b * h, n_q), dtype=torch.float32, device=q.device)
    source = _FWD_SOURCES[q.dtype]
    fn = _library(source)
    drop = _dropout_args(rate, seed, row0, col0)
    layout = None
    with torch.cuda.device(q.device):
        if q.dtype == torch.bfloat16:
            ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr()]
            layout, maps = _layout_of(b, h, n_q, n_kv, dh, q.stride(), k.stride(), v.stride(),
                                      ptrs[0] & 15, ptrs[1] & 15, ptrs[2] & 15)
            if layout == "padded":
                qkv = [t if m is not None else _padded(t) for t, m in zip((q, k, v), maps)]
                maps = tuple(m if m is not None else _tensor_map(t) for t, m in zip(qkv, maps))
                ptrs = [t.data_ptr() for t in qkv]
            err = fn(
                *ptrs, o.data_ptr(), lse.data_ptr(),
                b, h, n_q, n_kv, dh, *maps[0], *maps[1], *maps[2],
                TMA_BOX[0], TMA_BOX[1], *o.stride()[:3], int(f32_o), float(sm_scale), *drop,
                _stream(q),
            )
        else:
            err = fn(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                b, h, n_q, n_kv, dh,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
                float(sm_scale), *drop, _stream(q),
            )
    if err >= _ENCODE_FAILED:
        raise RuntimeError(f"{source}: cuTensorMapEncodeTiled failed (CUresult "
                           f"{err - _ENCODE_FAILED}; 0: the driver entry point was not found)")
    if err != 0:
        raise RuntimeError(f"{source} kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    flash_attention.by_source[source] += 1
    flash_attention.by_instance[kernel_instance(source, dh)] += 1
    if layout is not None:
        flash_attention.by_layout[layout] += 1
    if rate > 0.0:
        keep_mask.launches += 1
    return o, lse


def _bwd_launch(kind: str, q, k, v, do, lse, di, dq, dk, dv, sm_scale, drop_args) -> None:
    b, h, n_q, dh = q.shape
    source = _BWD_SOURCES[q.dtype]
    fn = _library(source)
    with torch.cuda.device(q.device):
        err = fn(
            _BWD_KINDS[kind], q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), di.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, h, n_q, k.shape[2], dh,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
            *dq.stride()[:3], *dk.stride()[:3], *dv.stride()[:3],
            float(sm_scale), *drop_args, _stream(q),
        )
    if err != 0:
        raise RuntimeError(f"{source} {kind} kernel launch failed: CUDA error {err}")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.by_kernel[kind] += 1
    flash_attention_bwd.by_source[source] += 1
    flash_attention_bwd.by_instance[kernel_instance(source, dh)] += 1
    if drop_args[0]:
        keep_mask.launches += 1


def _dq_workspace(b, n_q, h, dh, device) -> torch.Tensor:
    """The fused kernels' dq: partial sums cross key tiles, so f32 atomics
    add into a zeroed f32 `[B, H, Nq, dh]` view, tokens-major, its rows padded
    to a multiple of 4 floats (the bf16 kernel adds whole float4s)."""
    dh4 = -(-dh // 4) * 4
    ws = torch.zeros((b, n_q, h, dh4), dtype=torch.float32, device=device)
    return ws.transpose(1, 2)[..., :dh]


def _flash_bwd_cuda(q, k, v, o, lse, do, sm_scale, rate, seed, row0, col0, route,
                    f32_dq=False):
    if do.stride(-1) != 1:
        do = do.contiguous()
    _check_kernel_inputs(q, k, v, do)
    b, h, n_q, dh = q.shape
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must have q's shape")
    if lse.shape != (b * h, n_q) or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"lse must be f32 [B*H, Nq] = [{b * h}, {n_q}] on q's device")
    n_kv = k.shape[2]
    di = (o.float() * do.float()).sum(-1).reshape(b * h, n_q)
    lse = lse.contiguous()
    dk = _tokens_major(b, n_kv, h, dh, k.dtype, k.device)
    dv = _tokens_major(b, n_kv, h, dh, v.dtype, v.device)
    drop = _dropout_args(rate, seed, row0, col0)
    if route == "fused":
        dq = _dq_workspace(b, n_q, h, dh, q.device)
        _bwd_launch("fused", q, k, v, do, lse, di, dq, dk, dv, sm_scale, drop)
        if not f32_dq:
            dq = dq.to(q.dtype)
    else:
        dq = _tokens_major(b, n_q, h, dh, q.dtype, q.device)
        _bwd_launch("dkv", q, k, v, do, lse, di, dq, dk, dv, sm_scale, drop)
        _bwd_launch("dq", q, k, v, do, lse, di, dq, dk, dv, sm_scale, drop)
    return dq, dk, dv


def bwd_route(dtype: torch.dtype, n_q: int, n_kv: int, dh: int) -> str:
    """The backward's route ("fused" or "split") for a call of this dtype,
    these query and key counts and this head dim: split from
    `SPLIT_MIN_QUERIES[dtype]` queries on. On the H100 the threshold depends
    on neither the key count nor the head dim."""
    return "split" if n_q >= SPLIT_MIN_QUERIES[dtype] else "fused"


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    do: torch.Tensor, sm_scale: float, dropout_rate: float = 0.0, seed: int = 0,
    row0: int = 0, col0: int = 0, route: Optional[str] = None, f32_dq: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`(dq, dk, dv)` of flash attention from the forward's `(o, lse)` and the
    output gradient `do`, all `[B, H, N, dh]` (lse f32 `[B*H, Nq]`). A CPU
    tensor takes the plain version; a CUDA tensor launches the backward
    kernel(s) of `route` ("fused", or "split" for the dkv + dq pair; None
    takes `bwd_route`'s) or raises. With `f32_dq` the fused route returns
    its f32 dq workspace as it is (a caller that sums partial dq's keeps
    them in f32); the split route's dq kernel writes q's dtype either way."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, sm_scale, dropout_rate, seed,
                                         row0, col0, f32_dq)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention_bwd runs on cpu or cuda, not {q.device.type}")
    _check_shapes(q, k, v)
    if route is None:
        route = bwd_route(q.dtype, q.shape[2], k.shape[2], q.shape[3])
    if route not in BWD_ROUTES:
        raise ValueError(f"route must be one of {BWD_ROUTES}, got {route!r}")
    return _flash_bwd_cuda(q, k, v, o, lse, do, sm_scale, dropout_rate, seed, row0, col0,
                           route, f32_dq)


# Backward kernel launches since the counts were last reset (CPU calls do not
# count): the total, the split by kernel, by source and by head-dim instance.
flash_attention_bwd.launches = 0
flash_attention_bwd.by_kernel = {kind: 0 for kind in _BWD_KINDS}
flash_attention_bwd.by_source = {source: 0 for source in _BWD_SOURCES.values()}
flash_attention_bwd.by_instance = _instance_counts(_BWD_SOURCES.values())


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    flash_attention.launches = 0
    flash_attention.by_source = {source: 0 for source in _FWD_SOURCES.values()}
    flash_attention.by_layout = {layout: 0 for layout in FWD_LAYOUTS}
    flash_attention.by_instance = _instance_counts(_FWD_SOURCES.values())
    flash_attention_bwd.launches = 0
    flash_attention_bwd.by_kernel = {kind: 0 for kind in _BWD_KINDS}
    flash_attention_bwd.by_source = {source: 0 for source in _BWD_SOURCES.values()}
    flash_attention_bwd.by_instance = _instance_counts(_BWD_SOURCES.values())
    keep_mask.launches = 0


# ---------------------------------------------------------------- autograd + entry


def _forward(q, k, v, sm_scale, rate, seed, row0, col0, f32_o=False):
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, sm_scale, rate, seed, row0, col0, f32_o)
    if q.device.type == "cuda":
        return _flash_fwd_cuda(q, k, v, sm_scale, rate, seed, row0, col0, f32_o)
    raise RuntimeError(f"flash_attention runs on cpu or cuda, not {q.device.type}")


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with the backward kernels as its gradient, on the route
    `bwd_route` gives the shapes. Saves `(q, k, v, o, lse)` and the dropout
    meta; the backward regenerates the forward's dropout mask from the same
    seed and offsets."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale, rate, seed, row0, col0):
        o, lse = _forward(q, k, v, sm_scale, rate, seed, row0, col0)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.meta = (sm_scale, rate, seed, row0, col0)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, *ctx.meta)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
    dropout_offset: Tuple[int, int] = (0, 0),
    return_lse: bool = False,
    f32_o: bool = False,
):
    """Flash attention over q `[B, H, Nq, dh]`, k and v `[B, H, Nkv, dh]`.

    Returns o `[B, H, Nq, dh]` in q's dtype (with `f32_o` in f32, as the
    kernel holds it before rounding; not differentiable), and with
    `return_lse` also the f32 log-sum-exp `[B*H, Nq]` that the backward
    needs. `dropout_rate` drops
    attention probabilities inside the kernel by the hash mask of
    `dropout_seed` (an int32) at global coordinates offset by
    `dropout_offset` = (row0, col0). A CPU tensor goes through the plain
    version; a CUDA tensor launches the kernel (and adds one to
    `flash_attention.launches`) or raises."""
    _check_shapes(q, k, v)
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    rate = float(dropout_rate)
    if rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 needs dropout_seed")
    keep_threshold(rate)  # validates the rate
    seed = int(dropout_seed) if rate > 0.0 else 0
    row0, col0 = (int(x) for x in dropout_offset)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        if f32_o:
            raise ValueError("f32_o has no backward: call it without grad")
        o, lse = FlashAttentionFn.apply(q, k, v, float(sm_scale), rate, seed, row0, col0)
    else:
        o, lse = _forward(q, k, v, sm_scale, rate, seed, row0, col0, f32_o)
    return (o, lse) if return_lse else o


# Forward kernel launches since the count was last set to 0 (CPU calls do not
# count): the total, the split by source and by head-dim instance
# (`kernel_instance`), and the bf16 launches split by route (`fwd_layout`): "tma"
# loaded q, k and v as they were, "padded" first copied one of them to a layout
# that TMA can load.
flash_attention.launches = 0
flash_attention.by_source = {source: 0 for source in _FWD_SOURCES.values()}
flash_attention.by_layout = {layout: 0 for layout in FWD_LAYOUTS}
flash_attention.by_instance = _instance_counts(_FWD_SOURCES.values())
