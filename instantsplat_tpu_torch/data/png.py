"""Minimal PNG codec on the standard library (zlib + struct) and numpy.

Reads 8-bit, non-interlaced greyscale, grey+alpha, RGB and RGBA images
and 16-bit non-interlaced greyscale ones (all five row filters); writes
8-bit RGB or RGBA and 16-bit greyscale (the depth-map layout of the Co3D,
WildRGBD, ScanNet++ and ARKitScenes loaders). It lets the port load and
save PNG scenes and 16-bit depth maps without Pillow.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples per pixel


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int):
    """Undo the per-row PNG filters. raw: [H, 1 + stride] uint8."""
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(height):
        ftype, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: running sum per sample position mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif ftype == 2:  # Up
            cur = (line + prev) & 0xFF
        elif ftype in (3, 4):  # Average, Paeth: depend on the left pixel
            cur = np.zeros(stride, np.int32)
            for x in range(0, stride, bpp):
                b = prev[x:x + bpp]
                if x == 0:
                    a = c = np.zeros(bpp, np.int32)
                else:
                    a = cur[x - bpp:x]
                    c = prev[x - bpp:x]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    p = a + b - c
                    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
                    pred = np.where((pa <= pb) & (pa <= pc), a,
                                    np.where(pb <= pc, b, c))
                cur[x:x + bpp] = (line[x:x + bpp] + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def _read(path, depths):
    """-> (unfiltered rows [H, W * C * depth/8] uint8, colour type, width,
    height), for the (bit depth, colour type) pairs in `depths`."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, ctype, _, _, interlace = header
    if (depth, ctype) not in depths or interlace != 0:
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, colour type "
            f"{ctype}, interlace {interlace}); read without Pillow are "
            "8-bit grey/grey+alpha/RGB/RGBA and 16-bit grey, non-interlaced")
    bpp = _CHANNELS[ctype] * depth // 8  # bytes per pixel
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    return _unfilter(raw.reshape(height, 1 + stride), height, stride,
                     bpp), ctype, width, height


def read_png(path) -> np.ndarray:
    """-> uint8 [H, W, C] with C in (1, 2, 3, 4)."""
    pixels, ctype, width, height = _read(
        path, {(8, c) for c in _CHANNELS})
    return pixels.reshape(height, width, _CHANNELS[ctype])


def read_png16(path) -> np.ndarray:
    """16-bit greyscale PNG -> uint16 [H, W]."""
    pixels, _, width, height = _read(path, {(16, 0)})
    return pixels.view(">u2").reshape(height, width).astype(np.uint16)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _write(path, rows: np.ndarray, width: int, depth: int, ctype: int):
    """rows: [H, W * C * depth/8] uint8 samples, written with filter 0."""
    h = rows.shape[0]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", width, h, depth, ctype, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + _chunk(b"IEND", b""))


def write_png(path, img: np.ndarray):
    """Write uint8 [H, W, 3] (RGB) or [H, W, 4] (RGBA), filter 0 rows."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"expected [H, W, 3|4] uint8, got {img.shape}")
    h, w, ch = img.shape
    _write(path, img.reshape(h, -1), w, 8, 2 if ch == 3 else 6)


def write_png16(path, img: np.ndarray):
    """Write uint16 [H, W] as a 16-bit greyscale PNG, filter 0 rows."""
    img = np.asarray(img)
    if img.ndim != 2 or img.dtype != np.uint16:
        raise ValueError(f"expected [H, W] uint16, got {img.dtype} "
                         f"{img.shape}")
    h, w = img.shape
    rows = np.ascontiguousarray(img.astype(">u2")).view(np.uint8)
    _write(path, rows.reshape(h, -1), w, 16, 0)
