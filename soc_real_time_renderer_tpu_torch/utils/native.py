"""ctypes bridge to the native asset-pipeline library
(``native/assetpipe.cpp``, shared with the JAX package).

Built on first use with the same compiler flags the JAX package uses,
into ``build/`` of the checkout, so both packages pack identical atlas
bytes.  Every entry point has the same numpy fallback for machines
without a C++ toolchain.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "native", "assetpipe.cpp")
_LIB = os.path.join(_ROOT, "build", "libassetpipe.so")

_lib = None
_tried = False


def load() -> ctypes.CDLL | None:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        if (not os.path.exists(_LIB)
                or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
            os.makedirs(os.path.dirname(_LIB), exist_ok=True)
            tmp = f"{_LIB}.{os.getpid()}.tmp"
            subprocess.run(
                ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                 "-o", tmp, _SRC], check=True, capture_output=True)
            os.replace(tmp, _LIB)
        lib = ctypes.CDLL(_LIB)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.resize_bilinear_u8.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                           u8p, ctypes.c_int, ctypes.c_int]
        lib.build_mip_chain_u8.argtypes = [u8p, ctypes.c_int, u8p]
        lib.exr_unpredict.argtypes = [u8p, ctypes.c_int64]
        for fn in (lib.resize_bilinear_u8, lib.build_mip_chain_u8,
                   lib.exr_unpredict):
            fn.restype = None
        _lib = lib
    except (OSError, subprocess.CalledProcessError):
        _lib = None
    return _lib


def _ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def resize_bilinear_u8(src: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """(H, W, 4) u8 -> (OH, OW, 4) u8."""
    lib = load()
    if lib is None:
        from ..models.texture import resize_bilinear
        f = resize_bilinear(src.astype(np.float32) / 255.0, oh, ow)
        return (np.clip(f, 0, 1) * 255.0 + 0.5).astype(np.uint8)
    src = np.ascontiguousarray(src)
    dst = np.empty((oh, ow, 4), np.uint8)
    lib.resize_bilinear_u8(_ptr(src), src.shape[0], src.shape[1],
                           _ptr(dst), oh, ow)
    return dst


def build_mip_chain_u8(img: np.ndarray) -> np.ndarray:
    """(S, S, 4) u8 -> flat (layer_stride, 4) u8 mip-packed."""
    lib = load()
    size = img.shape[0]
    stride = sum((size >> k) * (size >> k)
                 for k in range(int(np.log2(size)) + 1))
    if lib is None:
        from ..models.texture import build_mips
        levels = build_mips(img.astype(np.float32) / 255.0)
        flat = np.concatenate([lv.reshape(-1, 4) for lv in levels])
        return (np.clip(flat, 0, 1) * 255.0 + 0.5).astype(np.uint8)
    img = np.ascontiguousarray(img)
    dst = np.empty((stride, 4), np.uint8)
    lib.build_mip_chain_u8(_ptr(img), size, _ptr(dst))
    return dst


def exr_unpredict(data: bytes) -> bytes | None:
    """OpenEXR's zip reconstruction (delta decode, then de-interleave) by
    the native library; None without it (utils/exr.py then takes its
    numpy version)."""
    lib = load()
    if lib is None:
        return None
    arr = np.frombuffer(data, np.uint8).copy()
    lib.exr_unpredict(_ptr(arr), len(arr))
    return arr.tobytes()
