"""A stdlib PNG reader for dial templates (zlib + numpy, no Pillow).

Reads 8-bit, non-interlaced PNGs of colour type L (0), RGB (2),
palette (3), LA (4) and RGBA (6), and returns the grayscale image Pillow's
``Image.convert("L")`` would: ITU-R 601-2 luma in Pillow's integer form,
L = (19595 R + 38470 G + 7471 B + 0x8000) >> 16, with alpha dropped.
Anything else raises ``PngError``.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


class PngError(ValueError):
    pass


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    stride = w * bpp
    if len(raw) < h * (stride + 1):
        raise PngError("truncated image data")
    rows = np.frombuffer(raw, np.uint8, h * (stride + 1)).reshape(
        h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype, line = int(rows[y, 0]), rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:                                   # Sub
            cur = np.cumsum(line.reshape(w, bpp), axis=0).reshape(-1) & 255
        elif ftype == 2:                                   # Up
            cur = (line + prev) & 255
        elif ftype in (3, 4):                              # Average, Paeth
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = int(cur[x - bpp]) if x >= bpp else 0
                b = int(prev[x])
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = int(prev[x - bpp]) if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                cur[x] = (int(line[x]) + pred) & 255
        else:
            raise PngError(f"bad filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def _luma(rgb: np.ndarray) -> np.ndarray:
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(
        np.uint8)


def write_png_gray(path: str, img: np.ndarray) -> None:
    """Write [H, W] uint8 as an 8-bit grayscale PNG (no filtering)."""
    h, w = img.shape
    rows = np.zeros((h, w + 1), np.uint8)
    rows[:, 1:] = img

    def chunk(kind: bytes, body: bytes) -> bytes:
        crc = zlib.crc32(kind + body) & 0xFFFFFFFF
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", crc)

    with open(path, "wb") as fp:
        fp.write(_SIGNATURE
                 + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0,
                                              0, 0))
                 + chunk(b"IDAT", zlib.compress(rows.tobytes(), 9))
                 + chunk(b"IEND", b""))


def read_png_gray(path: str) -> np.ndarray:
    """Decode a PNG file to [H, W] uint8 grayscale (Pillow's "L")."""
    with open(path, "rb") as fp:
        data = fp.read()
    if not data.startswith(_SIGNATURE):
        raise PngError(f"not a PNG file: {path}")
    pos, hdr, palette, idat = len(_SIGNATURE), None, None, []
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise PngError(f"truncated {kind!r} chunk")
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None or not idat:
        raise PngError(f"missing IHDR or IDAT: {path}")
    w, h, depth, ctype, _comp, _filt, interlace = hdr
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise PngError(f"unsupported PNG (bit depth {depth}, colour type "
                       f"{ctype}, interlace {interlace}): {path}")
    ch = _CHANNELS[ctype]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise PngError(f"corrupt image data: {path}") from e
    px = _unfilter(raw, h, w, ch).reshape(h, w, ch)
    if ctype in (0, 4):
        return px[..., 0].copy()
    if ctype == 3:
        if palette is None or px.max() >= len(palette):
            raise PngError(f"palette missing or too short: {path}")
        return _luma(palette[px[..., 0]])
    return _luma(px[..., :3])
