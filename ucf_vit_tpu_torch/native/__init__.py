"""The adaptive-patching host code in C++ (`native/patchtree.cpp`, a copy of
`ucf_vit_tpu/native/patchtree.cpp`), bound with ctypes.

`quadtree_boxes(edges, fixed_length)` is the greedy fixed-length quadtree
over an edge map, box for box and value for value the numpy build in
`data/quadtree.py` (its plain version); `octree_boxes` the same over a
cubic edge volume (`data/octree.py`'s numpy build), `resize3d` and
`octree_serialize` the leaves' resample to `m^3` patches (`octree.resize_3d`
the plain version) and `gaussian3d` scipy's `gaussian_filter` with sigma
`(s, s, s, 0)` in reflect mode, from the weights of scipy's 1-D Gaussian
(`gaussian_weights`, the port's copy of its formula). The library is built with g++ at
first use into `build/ucf_vit_tpu_torch/patchtree-<hash>.so` at the root of
the checkout (the hash covers the source and the flags). Each build writes a
name of its own and then renames it into place, so processes that build at
once (pytest-xdist workers, a spawn pool's children) never load a
half-written library. A failed build or load raises: nothing falls back to
the numpy build on its own.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().with_name("patchtree.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ucf_vit_tpu_torch"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"patchtree-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the source unless an up-to-date library exists; its path.
    Raises RuntimeError with g++'s output on failure."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed: {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SOURCE.name}:\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: another process sees no file or a whole one
    return out


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed; once per process."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            lib.quadtree_build.restype = ctypes.c_int
            lib.quadtree_build.argtypes = [u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                           i32p, i64p]
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
            lib.octree_build.restype = ctypes.c_int
            lib.octree_build.argtypes = [u8p, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                                         i32p, i64p]
            lib.resize3d.restype = None
            lib.resize3d.argtypes = [f32p, ctypes.c_int, ctypes.c_int, f32p, ctypes.c_int,
                                     ctypes.c_int]
            lib.octree_serialize.restype = None
            lib.octree_serialize.argtypes = [f32p, ctypes.c_int, ctypes.c_int, i32p,
                                             ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                             ctypes.c_int, f32p, i64p, f64p]
            lib.gaussian3d.restype = None
            lib.gaussian3d.argtypes = [f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, f64p, ctypes.c_int, f32p]
            _LIB = lib
        return _LIB


def quadtree_boxes(edges: np.ndarray, fixed_length: int) -> Tuple[np.ndarray, np.ndarray]:
    """`(boxes [n, 4] int32 (x1, x2, y1, y2), values [n] int64)` of the leaves
    in their serialization order. The edge map is read as uint8, as the numpy
    build reads it as integers. A split adds 3 leaves while fewer than
    `fixed_length` exist, so `n` may pass `fixed_length` by up to 2."""
    edges8 = np.ascontiguousarray(edges, dtype=np.uint8)
    out = np.empty((fixed_length + 2, 4), np.int32)
    vals = np.empty((fixed_length + 2,), np.int64)
    n = get_lib().quadtree_build(edges8, edges8.shape[0], edges8.shape[1], int(fixed_length),
                                 out, vals)
    return out[:n], vals[:n]


def octree_boxes(edges: np.ndarray, fixed_length: int, norm_factor: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """`(boxes [n, 6] int32 (x1, x2, y1, y2, z1, z2), values [n] int64)` of the
    octree's leaves over a cubic edge volume, in serialization order. A leaf's
    value is its edge mass over `norm_factor`, truncated. A split adds 7
    leaves while fewer than `fixed_length` exist, so `n` may pass
    `fixed_length` by up to 6."""
    if not edges.shape[0] == edges.shape[1] == edges.shape[2]:
        raise ValueError(f"the octree takes a cubic volume, got {edges.shape}")
    edges8 = np.ascontiguousarray(edges, dtype=np.uint8)
    out = np.empty((fixed_length + 6, 6), np.int32)
    vals = np.empty((fixed_length + 6,), np.int64)
    n = get_lib().octree_build(edges8, edges8.shape[0], int(norm_factor), int(fixed_length),
                               out, vals)
    return out[:n], vals[:n]


def resize3d(vol: np.ndarray, out_side: int, nearest: bool = False) -> np.ndarray:
    """A cubic `[n, n, n, c]` volume resampled to `[m, m, m, c]` f32 (linear,
    or nearest), on the JAX package's grid: source samples at
    `linspace(0, n, n)`, queries at `linspace(0, n, m)`."""
    if not vol.shape[0] == vol.shape[1] == vol.shape[2]:
        raise ValueError(f"resize3d takes a cubic volume, got {vol.shape}")
    v = np.ascontiguousarray(vol, dtype=np.float32)
    out = np.empty((out_side,) * 3 + (v.shape[3],), np.float32)
    get_lib().resize3d(v, v.shape[0], v.shape[3], out, int(out_side), int(nearest))
    return out


def octree_serialize(img: np.ndarray, boxes: np.ndarray, fixed_length: int, out_side: int,
                     nearest: bool = False) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Every leaf of `boxes` cut from `img` `[n, n, n, c]` (as
    `img[z1:z2, y1:y2, x1:x2]`) and resampled as `resize3d` does, in one call:
    `(patches [fixed_length, m, m, m, c] f32, sizes [fixed_length] int64,
    centres [fixed_length, 3] f64 (x, y, z))`, padded with zero patches,
    size 0 and centre (-1, -1, -1)."""
    if not img.shape[0] == img.shape[1] == img.shape[2]:
        raise ValueError(f"octree_serialize takes a cubic volume, got {img.shape}")
    v = np.ascontiguousarray(img, dtype=np.float32)
    b = np.ascontiguousarray(boxes, dtype=np.int32)
    if b.shape[0] > fixed_length:
        raise ValueError(f"{b.shape[0]} leaves for a fixed length of {fixed_length}")
    m = int(out_side)
    dst = np.empty((fixed_length, m, m, m, v.shape[3]), np.float32)
    sizes = np.empty((fixed_length,), np.int64)
    pos = np.empty((fixed_length, 3), np.float64)
    get_lib().octree_serialize(v, v.shape[0], v.shape[3], b, b.shape[0], int(fixed_length), m,
                               int(nearest), dst, sizes, pos)
    return dst, sizes, pos


def gaussian_weights(sigma: float, radius: int) -> np.ndarray:
    """The normalised 1-D Gaussian `[2 * radius + 1]` f64, by the formula of
    scipy's `gaussian_filter` (order 0)."""
    x = np.arange(-radius, radius + 1)
    phi = np.exp(-0.5 / (sigma * sigma) * x ** 2)
    return phi / phi.sum()


def gaussian3d(img: np.ndarray, sigma: float) -> np.ndarray:
    """`scipy.ndimage.gaussian_filter(img, sigma=(s, s, s, 0), mode="reflect")`
    of a `[n0, n1, n2, c]` f32 volume, truncated at 4 sigma as scipy's."""
    if img.dtype != np.float32 or img.ndim != 4:
        raise ValueError(f"gaussian3d takes a [n0, n1, n2, c] float32 volume, got "
                         f"{img.dtype} {img.shape}")
    radius = int(4.0 * sigma + 0.5)
    w = np.ascontiguousarray(gaussian_weights(float(sigma), radius)[::-1])
    v = np.ascontiguousarray(img)
    out = np.empty_like(v)
    n0, n1, n2, c = v.shape
    get_lib().gaussian3d(v, n0, n1, n2, c, w, radius, out)
    return out
