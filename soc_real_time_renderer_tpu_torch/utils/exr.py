"""Minimal OpenEXR scanline codec (pure Python + zlib).

The port's copy of the JAX package's ``utils/exr.py`` (numpy, zlib and
struct only, but reachable there only through a package that imports
jax).  The reference renderer links OpenEXR to load terrain heightmaps
and albedo and introspects channels into an RGBA layout
(``src/graphics/texture.cpp:295-486`` there); this is the subset the
renderer needs:

* read: single-part scanline images, NO/ZIPS/ZIP compression,
  half/float/uint channels, arbitrary channel names reordered into RGBA
  like the reference's format LUT (``texture.cpp:330-420``);
* write: float32 scanline images, ZIP or uncompressed.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

MAGIC = 20000630
_PIX_DTYPES = {0: np.uint32, 1: np.float16, 2: np.float32}
_PIX_CODES = {np.dtype(np.uint32): 0, np.dtype(np.float16): 1,
              np.dtype(np.float32): 2}


def _read_cstr(buf, off):
    end = buf.index(b"\x00", off)
    return buf[off:end].decode("latin1"), end + 1


def _unpredict(data: bytes) -> bytes:
    """OpenEXR zip post-inflate reconstruction: delta-decode then
    de-interleave (first half -> even bytes, second half -> odd)."""
    from . import native
    fast = native.exr_unpredict(data)
    if fast is not None:
        return fast
    d = np.frombuffer(data, np.uint8).astype(np.int64)
    # spec: d[i] = d[i-1] + d[i] - 128, d[0] unchanged
    d = (np.cumsum(d) - 128 * np.arange(len(d))) % 256
    d = d.astype(np.uint8)
    out = np.empty_like(d)
    half = (len(d) + 1) // 2
    out[0::2] = d[:half]
    out[1::2] = d[half:half + len(d) - half]
    return out.tobytes()


def _predict(data: bytes) -> bytes:
    """Inverse of _unpredict for writing."""
    d = np.frombuffer(data, np.uint8)
    half = (len(d) + 1) // 2
    inter = np.empty_like(d)
    inter[:half] = d[0::2]
    inter[half:] = d[1::2]
    x = inter.astype(np.int64)
    delta = np.empty_like(x)
    delta[0] = x[0]                      # enc[0] = x[0]
    delta[1:] = (x[1:] - x[:-1]) + 128   # enc[i] = x[i]-x[i-1]+128
    return (delta % 256).astype(np.uint8).tobytes()


def read_exr(path: str) -> tuple[np.ndarray, list[str]]:
    """Returns ((C, H, W) float32, channel names in file order)."""
    buf = open(path, "rb").read()
    magic, version = struct.unpack_from("<iI", buf, 0)
    if magic != MAGIC:
        raise ValueError("not an EXR file")
    off = 8
    attrs = {}
    while True:
        if buf[off] == 0:
            off += 1
            break
        name, off = _read_cstr(buf, off)
        atype, off = _read_cstr(buf, off)
        size, = struct.unpack_from("<i", buf, off)
        off += 4
        attrs[name] = (atype, buf[off:off + size])
        off += size

    # channels
    chl, names, types = attrs["channels"][1], [], []
    coff = 0
    while chl[coff] != 0:
        nm, coff = _read_cstr(chl, coff)
        t, = struct.unpack_from("<i", chl, coff)
        coff += 16  # type + pLinear+reserved + samplings
        names.append(nm)
        types.append(t)
    comp = attrs["compression"][1][0]
    x0, y0, x1, y1 = struct.unpack("<4i", attrs["dataWindow"][1])
    W, H = x1 - x0 + 1, y1 - y0 + 1

    # only NONE/ZIPS/ZIP are decodable below — listing RLE(1)/PIZ(4)
    # here would feed their compressed blocks straight to np.frombuffer
    # as raw scanlines (garbage pixels) instead of erroring cleanly
    lines_per_block = {0: 1, 2: 1, 3: 16}.get(comp)
    if lines_per_block is None:
        raise ValueError(f"unsupported EXR compression {comp} "
                         f"(NONE/ZIPS/ZIP supported)")
    n_blocks = -(-H // lines_per_block)
    offsets = struct.unpack_from(f"<{n_blocks}Q", buf, off)

    out = np.zeros((len(names), H, W), np.float32)
    bytes_per_px = [np.dtype(_PIX_DTYPES[t]).itemsize for t in types]
    for bi, boff in enumerate(offsets):
        y, size = struct.unpack_from("<ii", buf, boff)
        data = buf[boff + 8:boff + 8 + size]
        ny = min(lines_per_block, H - (y - y0))
        raw_size = sum(bp * W for bp in bytes_per_px) * ny
        if comp in (2, 3):  # ZIPS / ZIP
            if size < raw_size:
                data = _unpredict(zlib.decompress(data))
            # else: stored raw (writer chose uncompressed for this block)
        roff = 0
        for ly in range(ny):
            for ci, t in enumerate(types):
                n = W * bytes_per_px[ci]
                row = np.frombuffer(data, _PIX_DTYPES[t], W, roff)
                out[ci, y - y0 + ly] = row.astype(np.float32)
                roff += n
    return out, names


def read_exr_rgba(path: str) -> np.ndarray:
    """(H, W, 4) float32 with channels mapped R,G,B,A (missing -> R
    replicated / alpha=1), like texture.cpp:330-420's LUT."""
    img, names = read_exr(path)
    H, W = img.shape[1:]
    def find(n):
        return names.index(n) if n in names else -1
    r, g, b, a = find("R"), find("G"), find("B"), find("A")
    if r < 0:
        # no R channel: replicate the first color-ish channel (Y /
        # luminance / single-plane heightmaps) — NEVER img[-1], which
        # would silently substitute the last channel (e.g. alpha)
        r = 0
    out = np.zeros((H, W, 4), np.float32)
    out[..., 0] = img[r]
    out[..., 1] = img[g] if g >= 0 else img[r]
    out[..., 2] = img[b] if b >= 0 else img[r]
    out[..., 3] = img[a] if a >= 0 else 1.0
    return out


def write_exr(path: str, img: np.ndarray, compress: bool = True) -> None:
    """img: (C, H, W) float32, C in 1..4 -> channels [Y] / RGB(A)."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[None]
    C, H, W = img.shape
    names = {1: ["Y"], 2: ["G", "R"], 3: ["B", "G", "R"],
             4: ["A", "B", "G", "R"]}[C]
    # file channel order is alphabetical; map to input channel indices
    src = {1: [0], 2: [1, 0], 3: [2, 1, 0], 4: [3, 2, 1, 0]}[C]

    def attr(name, atype, payload):
        return (name.encode() + b"\x00" + atype.encode() + b"\x00"
                + struct.pack("<i", len(payload)) + payload)

    chl = b""
    for nm in names:
        chl += nm.encode() + b"\x00" + struct.pack("<iBBBBii", 2, 0, 0, 0, 0,
                                                   1, 1)
    chl += b"\x00"
    comp_code = 3 if compress else 0
    lines_per_block = 16 if compress else 1
    header = b""
    header += attr("channels", "chlist", chl)
    header += attr("compression", "compression", bytes([comp_code]))
    header += attr("dataWindow", "box2i", struct.pack("<4i", 0, 0, W - 1, H - 1))
    header += attr("displayWindow", "box2i", struct.pack("<4i", 0, 0, W - 1, H - 1))
    header += attr("lineOrder", "lineOrder", b"\x00")
    header += attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0))
    header += attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\x00"

    n_blocks = -(-H // lines_per_block)
    blocks = []
    for b0 in range(0, H, lines_per_block):
        ny = min(lines_per_block, H - b0)
        rows = b""
        for ly in range(ny):
            for si in src:
                rows += img[si, b0 + ly].tobytes()
        if compress:
            z = zlib.compress(_predict(rows))
            data = z if len(z) < len(rows) else rows
        else:
            data = rows
        blocks.append((b0, data))

    base = 8 + len(header) + 8 * n_blocks
    offsets, cur = [], base
    for (_, data) in blocks:
        offsets.append(cur)
        cur += 8 + len(data)

    with open(path, "wb") as f:
        f.write(struct.pack("<iI", MAGIC, 2))
        f.write(header)
        f.write(struct.pack(f"<{n_blocks}Q", *offsets))
        for (y, data) in blocks:
            f.write(struct.pack("<ii", y, len(data)))
            f.write(data)
