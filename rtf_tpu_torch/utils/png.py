"""Minimal PNG codec (zlib + struct, the scanline unfilter in the port's
host library), a copy of rtf_tpu/utils/png.py: encodes a rendered frame and
decodes texture files (8/16-bit grey, grey+alpha, RGB, RGBA, palette with
tRNS) without an image library."""
from __future__ import annotations

import struct
import zlib

import numpy as np

from rtf_tpu_torch.native.binding import native_png_unfilter

_SIG = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def write_png(path: str, img: np.ndarray) -> None:
    """Write uint8 image of shape [H,W] (grey), [H,W,3] (RGB) or [H,W,4]."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(np.rint(np.asarray(img, np.float32)), 0, 255).astype(np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    color_type = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    # filter byte 0 per scanline
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)
    idat = zlib.compress(raw.tobytes(), 6)
    with open(path, "wb") as f:
        f.write(_SIG + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", idat) + _chunk(b"IEND", b""))


def read_png(path: str, use_native: bool = True) -> np.ndarray:
    """Decode an 8/16-bit PNG into a uint8 array [H,W,C] (palette expanded;
    16-bit samples keep their high byte), as rtf_tpu/utils/png.py::read_png
    does.  The scanlines are unfiltered by the port's host library
    (native/binding.py::native_png_unfilter), whose build or load failure
    raises RuntimeError; use_native=False takes `unfilter_plain`."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIG:
        raise ValueError(f"{path}: not a PNG")
    pos = 8
    idat = b""
    palette = None
    trns = None
    w = h = depth = ctype = interlace = None
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos: pos + 4])
        tag = data[pos + 4: pos + 8]
        payload = data[pos + 8: pos + 8 + ln]
        pos += 12 + ln
        if tag == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(
                ">IIBBBBB", payload)
        elif tag == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            trns = np.frombuffer(payload, np.uint8)
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    if interlace != 0:
        raise NotImplementedError("interlaced PNG not supported")
    if depth not in (8, 16):
        raise NotImplementedError(f"bit depth {depth} not supported")
    nchan = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    bpp = nchan * (depth // 8)
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    raw = raw.reshape(h, stride + 1)
    out = (native_png_unfilter(raw, h, stride, bpp) if use_native
           else unfilter_plain(raw, h, stride, bpp))
    return _expand(out, h, w, nchan, depth, ctype, palette, trns)


def unfilter_plain(raw: np.ndarray, h: int, stride: int,
                   bpp: int) -> np.ndarray:
    """Undo the scanline filters of `raw` [h, stride + 1] (a filter byte,
    then the row) row by row in Python: [h, stride] uint8.  The plain
    version of native_png_unfilter, which read_png takes."""
    filters = raw[:, 0]
    lines = raw[:, 1:]
    out = np.zeros((h, stride), np.uint8)
    zero = np.zeros(stride, np.uint8)
    for y in range(h):
        f = filters[y]
        cur = lines[y].copy()
        up = out[y - 1] if y > 0 else zero
        if f == 0:
            out[y] = cur
        elif f == 2:  # Up
            out[y] = cur + up
        elif f == 1:  # Sub: per-phase prefix sum mod 256
            row = cur.reshape(-1, bpp)
            out[y] = np.cumsum(row.astype(np.int64), axis=0).astype(
                np.uint8).reshape(-1)
        elif f in (3, 4):  # Average / Paeth need a left-to-right scan
            row = out[y]
            row[:] = cur
            for x in range(stride):
                a = int(row[x - bpp]) if x >= bpp else 0
                b = int(up[x])
                if f == 3:
                    pred = (a + b) >> 1
                else:
                    c = int(up[x - bpp]) if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (
                        b if pb <= pc else c)
                row[x] = (int(cur[x]) + pred) & 0xFF
        else:
            raise ValueError(f"bad filter {f}")
    return out


def _expand(out, h, w, nchan, depth, ctype, palette, trns):
    if depth == 16:
        out = out.reshape(h, w, nchan, 2)[..., 0]  # keep high byte
    else:
        out = out.reshape(h, w, nchan)
    if ctype == 3:
        idx = out[:, :, 0]
        rgb = palette[idx]
        if trns is not None:
            lim = min(len(trns), 256)
            lut = np.full(256, 255, np.uint8)
            lut[:lim] = trns[:lim]
            a = lut[idx]
            return np.concatenate([rgb, a[:, :, None]], axis=-1)
        return rgb
    return out
