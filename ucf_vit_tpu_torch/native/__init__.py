"""The quadtree build in C++ (host code, `native/patchtree.cpp`, a copy of
`ucf_vit_tpu/native/patchtree.cpp`), bound with ctypes.

`quadtree_boxes(edges, fixed_length)` is the greedy fixed-length quadtree
over an edge map, box for box and value for value the numpy build in
`data/quadtree.py` (its plain version). The library is built with g++ at
first use into `build/ucf_vit_tpu_torch/patchtree-<hash>.so` at the root of
the checkout (the hash covers the source and the flags). Each build writes a
name of its own and then renames it into place, so processes that build at
once (pytest-xdist workers, a spawn pool's children) never load a
half-written library. A failed build or load raises: nothing falls back to
the numpy build on its own. The octree, resize and Gaussian entries of the
source are not bound yet (ROADMAP.md, modules to port, item 6).
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
