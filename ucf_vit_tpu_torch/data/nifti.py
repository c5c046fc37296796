"""First-party NIfTI-1 reader and writer (pure numpy): the port's own copy
of `ucf_vit_tpu/data/nifti.py` (`load` `:56`, `save` `:111`).

The subset of NIfTI-1 that CT volumes use (single-file `.nii`(.gz), a
scalar voxel array, optional scl_slope/scl_inter scaling) is a 348-byte
fixed header and raw Fortran-order voxels. The port reads NIfTI only
through this module: nibabel is not a dependency.

Header fields used (NIfTI-1 spec, nifti1.h):
  offset   0  int32   sizeof_hdr   == 348 (also the endianness probe)
  offset  40  int16[8] dim         dim[0]=ndim, dim[1..ndim]=extents
  offset  70  int16   datatype     code -> numpy dtype (_DTYPES)
  offset  72  int16   bitpix       bits per voxel (consistency check)
  offset 108  float32 vox_offset   data start in the file (.nii: >= 352)
  offset 112  float32 scl_slope    voxel scaling: v*slope + inter
  offset 116  float32 scl_inter    (applied when slope not in {0, 1} or
                                    inter != 0, as nibabel's dataobj does)
  offset 344  char[4] magic        b"n+1\\0" single-file / b"ni1\\0" pair
"""

from __future__ import annotations

import gzip
import struct

import numpy as np

HDR_SIZE = 348

# NIfTI-1 datatype code -> numpy dtype
_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def _open(path: str, mode: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def load(path: str) -> np.ndarray:
    """Read a single-file NIfTI-1 volume -> numpy array (x-fastest memory
    order transposed to the conventional [dim1, dim2, ...] index order, the
    same array nibabel's `np.array(img.dataobj)` yields)."""
    with _open(path, "rb") as f:
        raw = f.read()
    hdr = raw[:HDR_SIZE]
    if len(hdr) < HDR_SIZE:
        raise ValueError(f"{path}: truncated NIfTI header ({len(hdr)} bytes)")
    (sizeof_hdr,) = struct.unpack("<i", hdr[0:4])
    bo = "<"
    if sizeof_hdr != HDR_SIZE:
        (sizeof_hdr,) = struct.unpack(">i", hdr[0:4])
        if sizeof_hdr != HDR_SIZE:
            raise ValueError(f"{path}: not a NIfTI-1 file (sizeof_hdr)")
        bo = ">"
    magic = hdr[344:348]
    if magic not in (b"n+1\x00", b"ni1\x00"):
        raise ValueError(f"{path}: bad NIfTI magic {magic!r}")
    if magic == b"ni1\x00":
        raise NotImplementedError(
            f"{path}: two-file NIfTI (.hdr/.img) is not supported; use "
            "single-file .nii"
        )
    dim = struct.unpack(bo + "8h", hdr[40:56])
    ndim = dim[0]
    if not 1 <= ndim <= 7:
        raise ValueError(f"{path}: bad ndim {ndim}")
    shape = tuple(int(d) for d in dim[1 : 1 + ndim])
    (datatype, bitpix) = struct.unpack(bo + "2h", hdr[70:74])
    if datatype not in _DTYPES:
        raise NotImplementedError(
            f"{path}: NIfTI datatype code {datatype} not supported "
            f"(supported: {sorted(_DTYPES)})"
        )
    dtype = np.dtype(_DTYPES[datatype]).newbyteorder(bo)
    if bitpix != dtype.itemsize * 8:
        raise ValueError(
            f"{path}: bitpix {bitpix} inconsistent with datatype "
            f"{datatype} ({dtype.itemsize * 8} bits)"
        )
    (vox_offset,) = struct.unpack(bo + "f", hdr[108:112])
    (slope,) = struct.unpack(bo + "f", hdr[112:116])
    (inter,) = struct.unpack(bo + "f", hdr[116:120])
    off = int(vox_offset) if vox_offset else 352
    n = int(np.prod(shape))
    data = np.frombuffer(raw, dtype=dtype, count=n, offset=off)
    # NIfTI voxels are Fortran order (x fastest): shape reversed, then T
    arr = data.reshape(shape[::-1]).transpose(range(ndim - 1, -1, -1))
    if (slope not in (0.0, 1.0)) or inter != 0.0:
        s = slope if slope != 0.0 else 1.0
        arr = arr.astype(np.float32) * s + inter
    return np.ascontiguousarray(arr)


def save(path: str, arr: np.ndarray) -> None:
    """Write a single-file little-endian NIfTI-1 volume (no scaling)."""
    arr = np.asarray(arr)
    if arr.dtype not in _CODES:
        raise TypeError(f"unsupported dtype {arr.dtype} for NIfTI save")
    ndim = arr.ndim
    if not 1 <= ndim <= 7:
        raise ValueError(f"unsupported ndim {ndim}")
    hdr = bytearray(HDR_SIZE)
    struct.pack_into("<i", hdr, 0, HDR_SIZE)
    dim = [ndim] + list(arr.shape) + [1] * (7 - ndim)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<2h", hdr, 70, _CODES[arr.dtype], arr.dtype.itemsize * 8)
    # pixdim: qfac 1.0 + unit voxel sizes (readers expect sane values)
    struct.pack_into("<8f", hdr, 76, 1.0, *([1.0] * 7))
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)  # scl_inter
    hdr[344:348] = b"n+1\x00"
    with _open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(b"\x00" * 4)  # extension flag: none
        # Fortran voxel order
        f.write(np.asfortranarray(arr).tobytes(order="F"))
