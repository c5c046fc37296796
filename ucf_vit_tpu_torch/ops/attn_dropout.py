"""Counter-hash attention-dropout masks (port of `ucf_vit_tpu/ops/attn_dropout.py`).

    keep(bh, row, col) = lowbias32(row * 0x9E3779B1 ^ col * 0x85EBCA77
                                   ^ seed * 0xC2B2AE3D ^ (bh + 1) * 0x27D4EB2F)
                         >= round(rate * 2^32)

in uint32 arithmetic at GLOBAL coordinates, bh = b * H + h. Nothing is
stored: the flash backward regenerates the forward's mask from the same
coordinates although it tiles differently. The CUDA kernels carry the same
hash as a device function (`csrc/attn_dropout.cuh`); here it is the plain
version, bit-identical to the JAX package's `dense_keep_mask`. torch has no
uint32 arithmetic, so the hash runs in int64 holding uint32 values: every
product is split into 16-bit halves so that it never leaves int64, and the
shifts are logical because the values are never negative.

`seed_from_key` becomes `draw_seed`: an int32 seed drawn on the host from a
CPU `torch.Generator`, which costs no device synchronisation.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

_M32 = 0xFFFFFFFF
_ROW_MUL = 0x9E3779B1
_COL_MUL = 0x85EBCA77
_SEED_MUL = 0xC2B2AE3D
_BH_MUL = 0x27D4EB2F
_INT32_MAX = 2**31 - 1

Device = Union[str, torch.device, None]


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a uint32 constant c,
    without int64 overflow."""
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _lowbias32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _u32(v: int) -> int:
    return int(v) & _M32


def keep_threshold(rate: float) -> int:
    """uint32 threshold t with P(hash < t) == rate; drop where hash < t."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} outside [0, 1)")
    return min(int(round(rate * 4294967296.0)), 4294967295)


def _mask(seed: int, bh: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
          rate: float) -> torch.Tensor:
    """Broadcast the three coordinate terms (int64 tensors) into a keep mask."""
    slice_key = _mul32(bh + 1, _BH_MUL) ^ (_u32(seed) * _SEED_MUL & _M32)
    x = _mul32(rows & _M32, _ROW_MUL) ^ _mul32(cols & _M32, _COL_MUL) ^ slice_key
    return _lowbias32(x) >= keep_threshold(rate)


def keep_mask(seed: int, bh: int, row0: int, col0: int, shape: Tuple[int, int], rate: float,
              device: Device = None) -> torch.Tensor:
    """Boolean keep mask [shape] for the tile whose top-left element is global
    (row0, col0) of batch-head `bh`. True = keep."""
    n_r, n_c = shape
    rows = torch.arange(n_r, dtype=torch.int64, device=device)[:, None] + int(row0)
    cols = torch.arange(n_c, dtype=torch.int64, device=device)[None, :] + int(col0)
    bh_t = torch.tensor(_u32(bh), dtype=torch.int64, device=device)
    return _mask(seed, bh_t, rows, cols, rate)


# Launches of a CUDA flash kernel (forward or backward) with this hash compiled
# in, since the count was last set to 0; the plain versions do not count.
keep_mask.launches = 0


def dense_keep_mask(seed: int, n_bh: int, n_q: int, n_kv: int, rate: float, *,
                    row0: int = 0, col0: int = 0, device: Device = None) -> torch.Tensor:
    """[n_bh, n_q, n_kv] mask: exactly what the flash kernels regenerate tile
    by tile. Materialises O(N^2); for the plain versions and the tests."""
    rows = torch.arange(n_q, dtype=torch.int64, device=device)[None, :, None] + int(row0)
    cols = torch.arange(n_kv, dtype=torch.int64, device=device)[None, None, :] + int(col0)
    bh = torch.arange(n_bh, dtype=torch.int64, device=device)[:, None, None]
    return _mask(seed, bh, rows, cols, rate)


def fold_seed(seed: int, *indices: int) -> int:
    """Mix shard indices into a dropout seed, in int32 wrap-around arithmetic
    (`s * 1000003 + idx + 1` per index), as the JAX package does."""
    s = int(seed)
    for idx in indices:
        s = s * 1000003 + int(idx) + 1
    s &= _M32
    return s - 2**32 if s > _INT32_MAX else s


def draw_seed(generator: Optional[torch.Generator]) -> int:
    """An int32 dropout seed in [0, 2^31 - 1) from a CPU generator (the role of
    `seed_from_key`). Raises without a generator: the port never draws from
    torch's global generator."""
    if generator is None:
        raise RuntimeError(
            "attention dropout needs an explicit torch.Generator: call "
            "model.set_generator(...) (the train step does) before training"
        )
    if generator.device.type != "cpu":
        raise ValueError("dropout seeds are drawn from a CPU generator (no device sync)")
    return int(torch.randint(0, _INT32_MAX, (1,), generator=generator).item())
