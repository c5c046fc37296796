"""Sin-cos positional embedding tables (numpy, used only at init time).

The port's own copy of the 1D/2D/3D tables of `ucf_vit_tpu/ops/pos_embed.py`
(`:16-72`): same layouts (sin block then cos block; 2D splits the dims over
(h, w), 3D over (h, w, d); token order h-major), same float64 math; and of the
DDPM time-step table (`:73`), whose layout interleaves sin and cos; and the
1-D resample of a table to another length (`:152`), for the MAE-encoder
transfer.
"""

from __future__ import annotations

import math

import numpy as np


def get_1d_sincos_pos_embed_from_grid(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    """[M] positions -> [M, embed_dim] embedding, sin block then cos block."""
    if embed_dim % 2:
        raise ValueError(f"embed_dim {embed_dim} must be even")
    omega = np.arange(embed_dim // 2, dtype=np.float64)
    omega /= embed_dim / 2.0
    omega = 1.0 / 10000**omega
    pos = np.asarray(pos, dtype=np.float64).reshape(-1)
    out = np.einsum("m,d->md", pos, omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_2d_sincos_pos_embed(
    embed_dim: int, grid_size_h: int, grid_size_w: int, cls_token: bool = False
) -> np.ndarray:
    """[gh*gw(+1), embed_dim]; first half of dims encode h, second half w."""
    if embed_dim % 2:
        raise ValueError(f"embed_dim {embed_dim} must be even")
    grid_h = np.arange(grid_size_h, dtype=np.float32)
    grid_w = np.arange(grid_size_w, dtype=np.float32)
    ww, hh = np.meshgrid(grid_w, grid_h)  # row-major over (h, w)
    emb_h = get_1d_sincos_pos_embed_from_grid(embed_dim // 2, hh)
    emb_w = get_1d_sincos_pos_embed_from_grid(embed_dim // 2, ww)
    pos_embed = np.concatenate([emb_h, emb_w], axis=1)
    if cls_token:
        pos_embed = np.concatenate([np.zeros([1, embed_dim]), pos_embed], axis=0)
    return pos_embed


def get_3d_sincos_pos_embed(
    embed_dim: int,
    grid_size_h: int,
    grid_size_w: int,
    grid_size_d: int,
    cls_token: bool = False,
) -> np.ndarray:
    """[gh*gw*gd(+1), embed_dim]; dims split in thirds over (h, w, d), token
    order h-major, then w, then d."""
    if embed_dim % 3:
        raise ValueError(f"embed_dim {embed_dim} must divide by 3")
    d_pos = get_1d_sincos_pos_embed_from_grid(embed_dim // 3, np.arange(grid_size_d))
    w_pos = get_1d_sincos_pos_embed_from_grid(embed_dim // 3, np.arange(grid_size_w))
    h_pos = get_1d_sincos_pos_embed_from_grid(embed_dim // 3, np.arange(grid_size_h))

    d_pos = np.tile(d_pos, (grid_size_h * grid_size_w, 1))
    w_pos = np.tile(np.repeat(w_pos, grid_size_d, axis=0), (grid_size_h, 1))
    h_pos = np.repeat(h_pos, grid_size_w * grid_size_d, axis=0)

    emb = np.concatenate((h_pos, w_pos, d_pos), axis=1)
    if cls_token:
        emb = np.concatenate([np.zeros([1, embed_dim]), emb], axis=0)
    return emb


def sinusoidal_time_embedding_table(time_steps: int, embed_dim: int) -> np.ndarray:
    """[time_steps, embed_dim] float64 table for DDPM time steps, interleaved:
    even dims sin, odd dims cos (not the block layout of the tables above)."""
    position = np.arange(time_steps, dtype=np.float64)[:, None]
    div = np.exp(
        np.arange(0, embed_dim, 2, dtype=np.float64) * -(math.log(10000.0) / embed_dim)
    )
    table = np.zeros((time_steps, embed_dim), dtype=np.float64)
    table[:, 0::2] = np.sin(position * div)
    table[:, 1::2] = np.cos(position * div)
    return table


def interpolate_pos_embed_1d(pos_embed: np.ndarray, new_len: int) -> np.ndarray:
    """A `[1, L, D]` (or `[L, D]`) table resampled linearly to `new_len` rows
    (`ucf_vit_tpu/ops/pos_embed.py:152`; torch's `F.interpolate(mode="linear",
    align_corners=False)` grid: row centres mapped affinely, clamped at the
    ends), in the table's dtype."""
    squeeze = pos_embed.ndim == 2
    if squeeze:
        pos_embed = pos_embed[None]
    old_len = pos_embed.shape[1]
    if old_len == new_len:
        return pos_embed[0] if squeeze else pos_embed
    coords = (np.arange(new_len, dtype=np.float64) + 0.5) * (old_len / new_len) - 0.5
    coords = np.clip(coords, 0, old_len - 1)
    lo = np.floor(coords).astype(np.int64)
    hi = np.minimum(lo + 1, old_len - 1)
    frac = (coords - lo)[None, :, None]
    out = (pos_embed[:, lo] * (1 - frac) + pos_embed[:, hi] * frac).astype(pos_embed.dtype)
    return out[0] if squeeze else out
