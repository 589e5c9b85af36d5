"""The port's PNG reader (rtf_tpu_torch/utils/png.py::read_png) against
rtf_tpu/utils/png.py::read_png on PNGs this file encodes with zlib: every
colour type (grey, grey+alpha, RGB, RGBA, palette with and without tRNS)
at 8 and 16 bits where PNG allows them, each image's rows cycling through
the five filter types (None, Sub, Up, Average, Paeth), its IDAT split
into several chunks, the port's scanlines unfiltered by its host library
or by unfilter_plain (use_native True and False).  The decoded arrays must
be equal (dtype, shape, values), and equal to the pixels encoded; an
interlaced file raises NotImplementedError in both."""
import struct
import zlib

import numpy as np
import pytest

pytest.importorskip("jax")

# (colour type, bit depth, channels, a tRNS chunk)
CASES = [(0, 8, 1, False), (0, 16, 1, False), (4, 8, 2, False),
         (4, 16, 2, False), (2, 8, 3, False), (2, 16, 3, False),
         (6, 8, 4, False), (6, 16, 4, False), (3, 8, 1, False),
         (3, 8, 1, True)]


def _chunk(tag, payload):
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)


def _filter_row(ftype, row, prev, bpp):
    """Encode one scanline (ints) with PNG filter ftype."""
    out = []
    for x, v in enumerate(row):
        a = row[x - bpp] if x >= bpp else 0
        b = prev[x]
        c = prev[x - bpp] if x >= bpp else 0
        pred = (0, a, b, (a + b) >> 1, _paeth(a, b, c))[ftype]
        out.append((v - pred) & 0xFF)
    return bytes([ftype] + out)


def encode_png(path, samples, ctype, depth, palette=None, trns=None,
               interlace=0, n_idat=3):
    """Write samples ([H, W, C] uint8 or uint16 big-endian values) as a
    PNG, row y with filter y % 5, the zlib stream in n_idat chunks."""
    h, w, c = samples.shape
    raw = samples.astype(">u2" if depth == 16 else np.uint8).tobytes()
    stride = len(raw) // h
    bpp = c * depth // 8
    prev = [0] * stride
    lines = b""
    for y in range(h):
        row = list(raw[y * stride:(y + 1) * stride])
        lines += _filter_row(y % 5, row, prev, bpp)
        prev = row
    z = zlib.compress(lines, 9)
    cut = [len(z) * i // n_idat for i in range(n_idat + 1)]
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if palette is not None:
        out += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns.astype(np.uint8).tobytes())
    for i in range(n_idat):
        out += _chunk(b"IDAT", z[cut[i]:cut[i + 1]])
    path.write_bytes(out + _chunk(b"IEND", b""))


@pytest.mark.parametrize("use_native", [False, True])
@pytest.mark.parametrize("ctype,depth,nchan,with_trns", CASES)
def test_read_png_matches_jax(tmp_path, ctype, depth, nchan, with_trns,
                              use_native):
    from rtf_tpu.utils.png import read_png as jread
    from rtf_tpu_torch.utils.png import read_png
    rng = np.random.RandomState(ctype * 100 + depth)
    h, w = 13, 11
    hi = 2 ** depth
    palette = trns = None
    if ctype == 3:
        palette = rng.randint(0, 256, (20, 3))
        samples = rng.randint(0, 20, (h, w, 1))
        if with_trns:
            trns = rng.randint(0, 256, 12)     # shorter than the palette
    else:
        samples = rng.randint(0, hi, (h, w, nchan))
    path = tmp_path / "t.png"
    encode_png(path, samples, ctype, depth, palette, trns)
    got, want = read_png(str(path), use_native), jread(str(path))
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    if ctype == 3:
        expect = palette[samples[..., 0]]
        if with_trns:
            lut = np.full(256, 255)
            lut[:len(trns)] = trns
            expect = np.concatenate([expect, lut[samples]], axis=-1)
    else:
        expect = samples >> 8 if depth == 16 else samples
    np.testing.assert_array_equal(got, expect)


def test_interlaced_png_raises(tmp_path):
    from rtf_tpu.utils.png import read_png as jread
    from rtf_tpu_torch.utils.png import read_png
    path = tmp_path / "i.png"
    encode_png(path, np.zeros((4, 4, 3), np.uint8), 2, 8, interlace=1)
    for fn in (read_png, jread):
        with pytest.raises(NotImplementedError, match="interlaced"):
            fn(str(path))


def test_write_then_read_roundtrip(tmp_path):
    from rtf_tpu_torch.utils.png import read_png, write_png
    img = np.random.RandomState(1).randint(0, 256, (7, 9, 3)).astype(
        np.uint8)
    write_png(str(tmp_path / "w.png"), img)
    np.testing.assert_array_equal(read_png(str(tmp_path / "w.png")), img)
