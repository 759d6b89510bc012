"""The port's image path without PIL: ``utils/png.py`` against PIL's RGBA
conversion (the JAX package's ``texture.decode_image``), the C++ row
unfilter against its numpy version, ``texture.decode_image`` with PIL
blocked, ``encode_png`` read back by PIL, and ``utils/image_io`` /
``utils/exr`` against the JAX package's files.

Every PNG here is written by this file's own encoder (any colour type,
bit depth, palette, ``tRNS`` and a filter type per row, filtered byte by
byte in Python), so the decoder is never checked against its own
writer.  Images are small and odd-sized (37x23).
"""
import io
import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from soc_real_time_renderer_tpu.models import texture as jtexture
from soc_real_time_renderer_tpu.utils import exr as jexr
from soc_real_time_renderer_tpu.utils import image_io as jimage_io
from soc_real_time_renderer_tpu_torch.models import texture as ptexture
from soc_real_time_renderer_tpu_torch.utils import exr as pexr
from soc_real_time_renderer_tpu_torch.utils import image_io as pimage_io
from soc_real_time_renderer_tpu_torch.utils import native as pnative
from soc_real_time_renderer_tpu_torch.utils import png

W, H = 37, 23
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(ctype, payload):
    return (struct.pack(">I", len(payload)) + ctype + payload
            + struct.pack(">I", zlib.crc32(ctype + payload)))


def _row_bytes(row, depth):
    """One row of samples (W*C,) -> packed big-endian bytes."""
    if depth == 16:
        return row.astype(">u2").tobytes()
    if depth == 8:
        return row.astype(np.uint8).tobytes()
    bits = ((row[:, None].astype(np.int64) >> np.arange(depth - 1, -1, -1))
            & 1).ravel()
    return np.packbits(bits.astype(np.uint8)).tobytes()


def _filter(ft, cur, prev, bpp):
    """PNG forward filter of one row, byte by byte."""
    out = bytearray(len(cur))
    for i, x in enumerate(cur):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i] if prev is not None else 0
        c = prev[i - bpp] if prev is not None and i >= bpp else 0
        if ft == 0:
            pred = 0
        elif ft == 1:
            pred = a
        elif ft == 2:
            pred = b
        elif ft == 3:
            pred = (a + b) // 2
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (x - pred) & 255
    return bytes(out)


def write_png(samples, ctype, depth, filters=(0, 1, 2, 3, 4), palette=None,
              trns=None, interlace=0):
    """(H, W, C) integer samples -> PNG bytes; row y takes filter
    filters[y % len(filters)]."""
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    stream, prev = b"", None
    for y in range(h):
        cur = _row_bytes(samples[y].reshape(-1), depth)
        ft = filters[y % len(filters)]
        stream += bytes([ft]) + _filter(ft, cur, prev, bpp)
        prev = cur
    out = b"\x89PNG\r\n\x1a\n" + _chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    # two IDAT chunks: the decoder must join them
    z = zlib.compress(stream)
    return (out + _chunk(b"IDAT", z[:len(z) // 2])
            + _chunk(b"IDAT", z[len(z) // 2:]) + _chunk(b"IEND", b""))


def pil_rgba(data):
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGBA"), dtype=np.uint8)


def _samples(rng, ctype, depth, n_palette=None):
    top = n_palette if ctype == 3 else (1 << depth)
    return rng.integers(0, top, (H, W, CHANNELS[ctype]))


CASES = [(ct, d) for ct, ds in {0: (1, 2, 4, 8, 16), 2: (8, 16),
                                3: (1, 2, 4, 8), 4: (8, 16),
                                6: (8, 16)}.items() for d in ds]


@pytest.mark.parametrize("ctype,depth", CASES)
def test_decode_equals_pil(ctype, depth):
    """Every colour type at every bit depth, rows cycling the five
    filters, equal to PIL's RGBA."""
    rng = np.random.default_rng(ctype * 100 + depth)
    palette = None
    n_pal = min(1 << depth, 200)
    if ctype == 3:
        palette = rng.integers(0, 256, (n_pal, 3))
    s = _samples(rng, ctype, depth, n_pal)
    data = write_png(s, ctype, depth, palette=palette)
    got = png.decode_png(data)
    assert got.shape == (H, W, 4) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, pil_rgba(data))


def _trns_cases():
    rng = np.random.default_rng(7)
    cases = {}
    for depth in (1, 2, 4, 8, 16):
        s = _samples(rng, 0, depth)
        key = int(s[3, 5, 0])
        cases[f"grey{depth}"] = (s, 0, depth, None, struct.pack(">H", key))
    s = _samples(rng, 0, 16)
    s[:4] = 200                                  # a key <= 255 on I;16
    cases["grey16_small_key"] = (s, 0, 16, None, struct.pack(">H", 200))
    s = _samples(rng, 2, 8)
    cases["rgb8"] = (s, 2, 8, None, struct.pack(">3H", *s[2, 2]))
    # 16-bit samples whose high bytes equal a small key: PIL compares the
    # raw 16-bit key against the 8-bit (high byte) pixel
    s = _samples(rng, 2, 16)
    s[:5] = (17 * 256 + 5, 3 * 256, 250 * 256 + 255)
    cases["rgb16_small_key"] = (s, 2, 16, None, struct.pack(">3H", 17, 3,
                                                            250))
    s = _samples(rng, 2, 16)
    cases["rgb16"] = (s, 2, 16, None, struct.pack(">3H", *s[1, 1]))
    pal = rng.integers(0, 256, (16, 3))
    s = _samples(rng, 3, 4, 16)
    cases["palette_alphas"] = (s, 3, 4, pal, bytes(rng.integers(
        0, 256, 9).astype(np.uint8)))
    cases["palette_one_clear"] = (s, 3, 4, pal, b"\xff\xff\x00\xff")
    s = _samples(rng, 3, 8, 40)
    cases["palette8_alphas"] = (s, 3, 8, rng.integers(0, 256, (40, 3)),
                                bytes(range(0, 250, 10)))
    return cases


TRNS = _trns_cases()


@pytest.mark.parametrize("name", sorted(TRNS))
def test_trns_equals_pil(name):
    """tRNS: per-entry palette alphas and the grey / RGB colour keys, as
    PIL converts them (16-bit RGB keys compare against the high bytes)."""
    s, ctype, depth, pal, trns = TRNS[name]
    data = write_png(s, ctype, depth, palette=pal, trns=trns)
    got = png.decode_png(data)
    want = pil_rgba(data)
    np.testing.assert_array_equal(got, want)
    if name in ("grey8", "rgb8", "palette_one_clear", "grey16_small_key",
                "rgb16_small_key"):
        assert (want[..., 3] == 0).any()


@pytest.mark.parametrize("ft", range(5))
def test_each_filter_alone(ft):
    """RGBA rows all written with one filter; and RGB 16-bit, whose
    bytes-per-pixel is 6."""
    rng = np.random.default_rng(ft)
    for ctype, depth in ((6, 8), (2, 16)):
        s = _samples(rng, ctype, depth)
        data = write_png(s, ctype, depth, filters=(ft,))
        np.testing.assert_array_equal(png.decode_png(data), pil_rgba(data))


def _filtered_stream(rng, h, rowbytes):
    rows = rng.integers(0, 256, (h, rowbytes + 1)).astype(np.uint8)
    rows[:, 0] = np.arange(h) % 5
    return rows.tobytes()


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_native_unfilter_equals_numpy(bpp):
    """The C++ unfilter against the numpy one, byte for byte, on random
    filtered rows of every filter type (built here with g++)."""
    lib = png.load()
    assert lib is not None, "g++ builds csrc/png_unfilter.cpp"
    rng = np.random.default_rng(bpp)
    h, rowbytes = 29, bpp * 41
    data = _filtered_stream(rng, h, rowbytes)
    a = png.unfilter_native(data, h, rowbytes, bpp, lib)
    b = png.unfilter_numpy(data, h, rowbytes, bpp)
    assert a.tobytes() == b.tobytes()
    bad = bytearray(data)
    bad[3 * (rowbytes + 1)] = 9
    for fn in (lambda d: png.unfilter_native(d, h, rowbytes, bpp, lib),
               lambda d: png.unfilter_numpy(d, h, rowbytes, bpp)):
        with pytest.raises(ValueError, match="row 3: unknown filter type 9"):
            fn(bytes(bad))


def test_numpy_path_decodes_like_pil(monkeypatch):
    """decode_png through the numpy unfilter, where no toolchain is."""
    monkeypatch.setattr(png, "load", lambda: None)
    rng = np.random.default_rng(3)
    for ctype, depth in ((6, 8), (0, 4), (4, 16)):
        data = write_png(_samples(rng, ctype, depth), ctype, depth)
        np.testing.assert_array_equal(png.decode_png(data), pil_rgba(data))


def test_interlaced_and_broken_files_raise():
    s = np.zeros((H, W, 3), np.int64)
    with pytest.raises(ValueError, match="Adam7"):
        png.decode_png(write_png(s, 2, 8, interlace=1))
    good = write_png(s, 2, 8)
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode_png(b"\xff\xd8" + good[2:])
    broken = bytearray(good)
    broken[20] ^= 1                          # inside IHDR: CRC mismatch
    with pytest.raises(ValueError, match="CRC"):
        png.decode_png(bytes(broken))


def test_decode_image_without_pil(monkeypatch):
    """texture.decode_image with PIL blocked: PNG by hand (equal to PIL's
    RGBA), JPEG raises naming PIL; with PIL both go through PIL."""
    rng = np.random.default_rng(4)
    data = write_png(_samples(rng, 2, 8), 2, 8)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (16, 16, 3)).astype(np.uint8)
                    ).save(buf, format="JPEG")
    jpeg = buf.getvalue()
    want = pil_rgba(data)
    np.testing.assert_array_equal(ptexture.decode_image(jpeg),
                                  jtexture.decode_image(jpeg))
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    np.testing.assert_array_equal(ptexture.decode_image(data), want)
    with pytest.raises(ValueError, match="PIL"):
        ptexture.decode_image(jpeg)
    got = ptexture.decode_images_parallel([data, data], workers=2)
    assert len(got) == 2 and all(np.array_equal(g, got[0]) for g in got)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("ft", range(5))
def test_encode_png_read_back_by_pil(channels, ft):
    rng = np.random.default_rng(channels * 10 + ft)
    img = rng.integers(0, 256, (H, W, channels)).astype(np.uint8)
    data = png.encode_png(img, filter_type=ft)
    with Image.open(io.BytesIO(data)) as im:
        back = np.asarray(im)
    np.testing.assert_array_equal(back.reshape(img.shape), img)
    np.testing.assert_array_equal(png.decode_png(data), pil_rgba(data))


def test_to_srgb_u8_and_save_png_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    color = rng.uniform(-0.1, 1.1, (3, 19, 33)).astype(np.float32)
    color[:, 0, :4] = [[0.0, 0.0031308, 0.5, 1.0]] * 3
    a, b = jimage_io.to_srgb_u8(color), pimage_io.to_srgb_u8(color)
    assert a.dtype == b.dtype == np.uint8 and a.tobytes() == b.tobytes()
    x = rng.uniform(-0.5, 1.5, 1000).astype(np.float32)
    assert ptexture.linear_to_srgb(x).tobytes() \
        == jtexture.linear_to_srgb(x).tobytes()
    pimage_io.save_png(str(tmp_path / "p.png"), color)
    jimage_io.save_png(str(tmp_path / "j.png"), color)
    for name in ("p.png", "j.png"):
        with Image.open(tmp_path / name) as im:
            assert np.asarray(im).tobytes() == a.tobytes()
    pimage_io.save_png(str(tmp_path / "u8.png"), a, already_u8=True)
    assert png.decode_png((tmp_path / "u8.png").read_bytes())[..., :3] \
        .tobytes() == a.tobytes()


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("compress", [True, False])
def test_exr_round_trip_both_ways(tmp_path, monkeypatch, channels, compress):
    """An EXR written by either package's exr.py is the same bytes and
    reads back to the image through both; the port's unpredict, native
    and numpy, equals the JAX file's."""
    rng = np.random.default_rng(channels)
    img = rng.uniform(0, 1, (channels, 37, 21)).astype(np.float32)
    want = np.ones((37, 21, 4), np.float32)
    want[..., :3] = img[0][..., None] if channels == 1 \
        else img[:3].transpose(1, 2, 0)
    if channels == 4:
        want[..., 3] = img[3]
    pj, pp = str(tmp_path / "j.exr"), str(tmp_path / "p.exr")
    jexr.write_exr(pj, img, compress=compress)
    pexr.write_exr(pp, img, compress=compress)
    assert open(pj, "rb").read() == open(pp, "rb").read()
    for path in (pj, pp):
        for mod in (jexr, pexr):
            got = mod.read_exr_rgba(path)
            assert got.dtype == np.float32 and got.tobytes() == want.tobytes()
    pimage_io.save_exr(str(tmp_path / "s.exr"), img)
    assert jexr.read_exr_rgba(str(tmp_path / "s.exr")).tobytes() \
        == want.tobytes()
    data = rng.integers(0, 256, 1001).astype(np.uint8).tobytes()
    ref = jexr._unpredict(data)
    assert pexr._unpredict(data) == ref
    monkeypatch.setattr(pnative, "exr_unpredict", lambda d: None)
    assert pexr._unpredict(data) == ref
