"""PNG decoding and encoding without PIL (stdlib ``zlib`` + ``struct``).

The JAX package decodes images with PIL (its ``models/texture.py``:
``Image.open(...).convert("RGBA")``); the port cannot count on PIL, so
:func:`decode_png` gives that same RGBA uint8 array by hand, PIL's
conversion rules included:

* grey 1/2/4/8 bit -> L scaled to 0..255 (1-bit as 0/255), 16-bit grey ->
  ``I;16`` -> RGBA by clipping to 255 (not scaling);
* 16-bit RGB, RGBA and grey-alpha keep each sample's high byte;
* ``tRNS``: palette alphas per entry; grey and RGB as a colour key,
  compared as PIL compares it: the raw 16-bit key against the converted
  8-bit sample (scaled, high byte or clipped), so a 16-bit key above 255
  never matches.

Adam7-interlaced files raise ``ValueError``.  The row unfilter is the
hot part (Average and Paeth depend on the reconstructed left byte):
``csrc/png_unfilter.cpp``, built with g++ at first use into ``build/`` of
the checkout; :func:`unfilter_numpy` is the same reconstruction in
numpy, taken only where no C++ toolchain is found.

:func:`encode_png` writes grey, grey-alpha, RGB or RGBA uint8 images
with one filter type for every row.
"""
from __future__ import annotations

import ctypes
import os
import struct
import subprocess
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                    "png_unfilter.cpp")
_LIB = os.path.join(_ROOT, "build", "libpng_unfilter.so")

_lib = None
_tried = False


def load() -> ctypes.CDLL | None:
    """The C++ unfilter, built on first use; None without a toolchain."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        if (not os.path.exists(_LIB)
                or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
            os.makedirs(os.path.dirname(_LIB), exist_ok=True)
            tmp = f"{_LIB}.{os.getpid()}.tmp"
            subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp,
                            _SRC], check=True, capture_output=True)
            os.replace(tmp, _LIB)
        lib = ctypes.CDLL(_LIB)
        lib.png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_int64]
        lib.png_unfilter.restype = ctypes.c_int64
        _lib = lib
    except (OSError, subprocess.CalledProcessError):
        _lib = None
    return _lib


def _bad_filter(row: int, ft: int):
    return ValueError(f"PNG row {row}: unknown filter type {ft}")


def unfilter_native(data: bytes, height: int, rowbytes: int, bpp: int,
                    lib: ctypes.CDLL) -> np.ndarray:
    """`height` filtered rows (filter byte + `rowbytes`) -> (height,
    rowbytes) uint8, by the C++ reconstruction."""
    src = np.frombuffer(data, np.uint8)
    out = np.empty((height, rowbytes), np.uint8)
    bad = lib.png_unfilter(src.ctypes.data, out.ctypes.data, height,
                           rowbytes, bpp)
    if bad:
        raise _bad_filter(bad - 1, int(src[(bad - 1) * (rowbytes + 1)]))
    return out


def unfilter_numpy(data: bytes, height: int, rowbytes: int,
                   bpp: int) -> np.ndarray:
    """The same reconstruction as ``csrc/png_unfilter.cpp`` in numpy:
    None and Up whole rows, Sub a cumulative sum per byte lane, Average
    and Paeth one pixel at a time."""
    rows = np.frombuffer(data, np.uint8).reshape(height, rowbytes + 1)
    out = np.empty((height, rowbytes), np.uint8)
    prev = np.zeros(rowbytes, np.int64)
    for y in range(height):
        ft = int(rows[y, 0])
        f = rows[y, 1:].astype(np.int64)
        if ft == 0:
            cur = f
        elif ft == 1:
            cur = np.cumsum(f.reshape(-1, bpp), axis=0).ravel() & 255
        elif ft == 2:
            cur = (f + prev) & 255
        elif ft in (3, 4):
            cur = np.empty(rowbytes, np.int64)
            left = np.zeros(bpp, np.int64)
            up_left = np.zeros(bpp, np.int64)
            for x in range(0, rowbytes, bpp):
                up = prev[x:x + bpp]
                if ft == 3:
                    pred = (left + up) >> 1
                else:
                    p = left + up - up_left
                    pa, pb, pc = (np.abs(p - left), np.abs(p - up),
                                  np.abs(p - up_left))
                    pred = np.where((pa <= pb) & (pa <= pc), left,
                                    np.where(pb <= pc, up, up_left))
                left = (f[x:x + bpp] + pred) & 255
                cur[x:x + bpp] = left
                up_left = up
        else:
            raise _bad_filter(y, ft)
        out[y] = cur
        prev = cur
    return out


def _chunks(data: bytes):
    """(type, payload) of each chunk, CRCs checked."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    off = 8
    while off + 12 <= len(data):
        length, ctype = struct.unpack_from(">I4s", data, off)
        payload = data[off + 8:off + 8 + length]
        crc, = struct.unpack_from(">I", data, off + 8 + length)
        if zlib.crc32(ctype + payload) != crc:
            raise ValueError(f"PNG chunk {ctype!r}: CRC mismatch")
        yield ctype, payload
        if ctype == b"IEND":
            return
        off += 12 + length
    raise ValueError("PNG ends without IEND")


def _samples(raw: np.ndarray, width: int, depth: int,
             channels: int) -> np.ndarray:
    """(H, rowbytes) reconstructed bytes -> (H, W, channels) samples:
    uint16 at depth 16, else uint8 values 0..2^depth - 1."""
    h = raw.shape[0]
    if depth == 16:
        s = raw.view(">u2").astype(np.uint16)
    elif depth == 8:
        s = raw
    else:
        bits = np.unpackbits(raw, axis=1).reshape(h, -1, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        s = (bits * weights).sum(axis=2, dtype=np.uint8)
    return s[:, :width * channels].reshape(h, width, channels)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 4) uint8, equal to PIL's
    ``Image.open(...).convert("RGBA")``."""
    header = palette = trns = None
    idat = []
    for ctype, payload in _chunks(data):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif ctype == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif ctype == b"tRNS":
            trns = payload
        elif ctype == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError("PNG without IHDR")
    width, height, depth, ctype, comp, filt, interlace = header
    if ctype not in _CHANNELS or depth not in _DEPTHS[ctype]:
        raise ValueError(f"PNG colour type {ctype} at bit depth {depth} "
                         f"is not valid")
    if comp != 0 or filt != 0:
        raise ValueError(f"PNG compression {comp} / filter method {filt} "
                         f"is not valid")
    if interlace:
        raise ValueError("Adam7-interlaced PNG is not supported; write "
                         "the image without interlacing")
    channels = _CHANNELS[ctype]
    bits = channels * depth
    rowbytes = (width * bits + 7) // 8
    bpp = max(1, bits // 8)
    stream = zlib.decompress(b"".join(idat))
    if len(stream) < height * (rowbytes + 1):
        raise ValueError(f"PNG image data is {len(stream)} bytes, "
                         f"{height * (rowbytes + 1)} expected")
    stream = stream[:height * (rowbytes + 1)]
    lib = load()
    raw = (unfilter_native(stream, height, rowbytes, bpp, lib)
           if lib is not None
           else unfilter_numpy(stream, height, rowbytes, bpp))
    s = _samples(raw, width, depth, channels)

    out = np.empty((height, width, 4), np.uint8)
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        table = np.zeros((256, 4), np.uint8)
        table[:, 3] = 255
        table[:len(palette), :3] = palette
        if trns is not None:
            alpha = np.frombuffer(trns, np.uint8)[:256]
            table[:len(alpha), 3] = alpha
        return table[s[..., 0]]
    if ctype in (0, 4):
        grey = s[..., 0]
        if depth == 16 and ctype == 0:
            grey = np.minimum(grey, 255).astype(np.uint8)   # I;16 clips
        elif depth == 16:
            grey = (grey >> 8).astype(np.uint8)
        elif depth < 8:
            grey = grey * np.uint8(255 // ((1 << depth) - 1))
        out[..., 0] = out[..., 1] = out[..., 2] = grey
        if ctype == 4:
            a = s[..., 1]
            out[..., 3] = (a >> 8) if depth == 16 else a
            return out
        out[..., 3] = 255
        if trns is not None:
            key, = struct.unpack(">H", trns[:2])
            if depth == 1:
                key = 255 if key else 0
            out[..., 3][grey == key] = 0
        return out
    rgb = s[..., :3]
    if depth == 16:
        rgb = (rgb >> 8).astype(np.uint8)
    out[..., :3] = rgb
    if ctype == 6:
        a = s[..., 3]
        out[..., 3] = (a >> 8) if depth == 16 else a
        return out
    out[..., 3] = 255
    if trns is not None:
        key = np.array(struct.unpack(">3H", trns[:6]), np.uint16)
        out[..., 3][(rgb.astype(np.uint16) == key).all(-1)] = 0
    return out


def _chunk(ctype: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + ctype + payload
            + struct.pack(">I", zlib.crc32(ctype + payload)))


def _filter_rows(img: np.ndarray, filter_type: int) -> np.ndarray:
    """(H, W, C) uint8 -> (H, 1 + W*C) uint8 rows, each filtered with
    `filter_type` (0 None .. 4 Paeth) against the unfiltered bytes."""
    h = img.shape[0]
    bpp = img.shape[2]
    x = img.reshape(h, -1).astype(np.int16)      # a + b - c fits int16
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    if filter_type == 0:
        pred = 0
    elif filter_type == 1:
        pred = a
    elif filter_type == 2:
        pred = b
    elif filter_type == 3:
        pred = (a + b) >> 1
    elif filter_type == 4:
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    else:
        raise ValueError(f"unknown PNG filter type {filter_type}")
    rows = np.empty((h, x.shape[1] + 1), np.uint8)
    rows[:, 0] = filter_type
    rows[:, 1:] = (x - pred) & 255
    return rows


def encode_png(img: np.ndarray, filter_type: int = 0,
               level: int = 6) -> bytes:
    """(H, W) grey, or (H, W, C) with C = 1 grey, 2 grey-alpha, 3 RGB, 4
    RGBA, uint8 -> 8-bit PNG bytes, every row filtered with
    `filter_type` (default 0, None)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in (1, 2, 3, 4):
        raise ValueError(f"encode_png takes (H, W[, 1-4]), got {img.shape}")
    h, w, c = img.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    rows = _filter_rows(np.ascontiguousarray(img), filter_type)
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0,
                                          0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))
