"""Minimal OpenEXR scanline I/O (port of instantsplat_tpu/data/exr.py).

The subset the dataset depth maps use: single-part scanline EXR v2,
HALF/FLOAT/UINT channels, NONE / ZIP / ZIPS compression (zlib + the EXR
byte predictor). Format reference: the public OpenEXR file layout
specification (openexr.com/en/latest/OpenEXRFileLayout.html).

`read_exr` decodes the scanline blocks with the host C++ codec
csrc/exr_native.cpp, built with the system g++ on first use into
build/instantsplat_tpu_torch/exr_native-<hash>/ (keyed by a hash of the
source and the flags) and loaded with ctypes. A failed build raises; the
pure-numpy decoder (`_read_blocks_py`) runs only when the caller asks for
it with `native=False`. `write_exr` is pure Python and writes the same
bytes as the JAX package's.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import threading
import zlib
from pathlib import Path

import numpy as np

from instantsplat_tpu_torch.ops.cuda_build import BUILD_ROOT, CSRC

_MAGIC = 20000630  # 0x762f3101 little-endian int32
_PT_UINT, _PT_HALF, _PT_FLOAT = 0, 1, 2
_DTYPE = {_PT_UINT: np.uint32, _PT_HALF: np.float16, _PT_FLOAT: np.float32}
_COMP_NONE, _COMP_RLE, _COMP_ZIPS, _COMP_ZIP = 0, 1, 2, 3
_LINES_PER_BLOCK = {_COMP_NONE: 1, _COMP_ZIPS: 1, _COMP_ZIP: 16}


def _read_cstr(buf, off):
    end = buf.index(b"\x00", off)
    return buf[off:end].decode("latin-1"), end + 1


def _predictor_decode(data: bytes) -> bytes:
    """Inverse of the EXR zip predictor: un-delta then re-interleave."""
    arr = np.frombuffer(data, np.uint8).astype(np.int64)
    arr[1:] -= 128  # d[i] = raw[i] - raw[i-1] + 128 (mod 256)
    arr = np.cumsum(arr) & 0xFF
    arr = arr.astype(np.uint8)
    half = (len(arr) + 1) // 2
    out = np.empty(len(arr), np.uint8)
    out[0::2] = arr[:half]
    out[1::2] = arr[half:]
    return out.tobytes()


def _predictor_encode(data: bytes) -> bytes:
    arr = np.frombuffer(data, np.uint8)
    half = (len(arr) + 1) // 2
    re = np.empty(len(arr), np.uint8)
    re[:half] = arr[0::2]
    re[half:] = arr[1::2]
    d = re.astype(np.int64)
    d[1:] = d[1:] - d[:-1] + 128
    return (d & 0xFF).astype(np.uint8).tobytes()


def _read_blocks_py(buf, off, n_blocks, lpb, compression, w, y0, y1,
                    channels, planes, pix_sz):
    """Pure-numpy scanline-block decode: the plain version of the native
    codec."""
    row_bytes = sum(w * s for s in pix_sz.values())
    for _ in range(n_blocks):
        y, size = struct.unpack_from("<ii", buf, off)
        off += 8
        raw = buf[off:off + size]
        off += size
        if y < y0 or y > y1:
            # untrusted file bytes: a y outside the data window would write
            # rows at wrong (or negative) plane indices
            raise ValueError(f"EXR block scanline y={y} outside data window")
        rows = min(lpb, y1 - y + 1)
        if compression in (_COMP_ZIP, _COMP_ZIPS):
            if size < rows * row_bytes:  # zlib only wins sometimes; EXR
                raw = _predictor_decode(zlib.decompress(raw))  # stores raw
        p = 0
        for r in range(rows):
            for cname, ptype in channels:  # alphabetical in-file order
                nb = w * pix_sz[cname]
                planes[cname][y - y0 + r] = np.frombuffer(
                    raw, _DTYPE[ptype], count=w, offset=p)
                p += nb


# -- the host C++ codec ------------------------------------------------------

_SRC = CSRC / "exr_native.cpp"
_ABI = 1
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_LIBS = ("-lz", "-lpthread")
_lock = threading.Lock()
_lib = None


def _compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found (and $CXX unset): the EXR codec "
                           f"{_SRC.name} cannot be built")
    return cxx


def native_library_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS + _LIBS).encode())
    return BUILD_ROOT / f"exr_native-{h.hexdigest()[:16]}" / \
        "libexr_native.so"


def build_native() -> Path:
    """Compile csrc/exr_native.cpp unless the cached library exists;
    returns its path. Raises when the compiler fails."""
    out = native_library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_compiler(), *CXX_FLAGS, str(_SRC), "-o", str(tmp), *_LIBS]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"building the EXR codec failed ({proc.returncode}): "
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}\nit needs a C++17 "
            "compiler and zlib's header (zlib.h) and library")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def native_lib() -> ctypes.CDLL:
    """Build (if needed) and load the codec, once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_native()))
            if lib.exr_native_abi() != _ABI:
                raise RuntimeError(f"{_SRC.name}: ABI mismatch")
            lib.exr_decode_blocks.restype = ctypes.c_int
            lib.exr_decode_blocks.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_void_p), ctypes.c_int32]
            _lib = lib
    return _lib


def _read_blocks_native(buf, off, n_blocks, lpb, compressed, w, h, y0,
                        pix_sz, planes, n_threads=0):
    """Decode the scanline blocks into the preallocated C-contiguous
    [h, w] planes (itemsize pix_sz[c]) with the C++ codec."""
    sz = (ctypes.c_int32 * len(pix_sz))(*pix_sz)
    ptrs = (ctypes.c_void_p * len(planes))(
        *[p.ctypes.data_as(ctypes.c_void_p).value for p in planes])
    rc = native_lib().exr_decode_blocks(
        buf, len(buf), off, n_blocks, lpb, int(compressed), w, h, y0,
        len(planes), sz, ptrs, n_threads)
    if rc != 0:
        msgs = {1: "bad block framing", 2: "zlib error", 3: "short block"}
        raise RuntimeError(f"EXR decode failed: {msgs.get(rc, rc)}")


def read_exr(path, native: bool = True):
    """Read a single-part scanline EXR.

    Returns [H, W] float32/uint32 for one channel, [H, W, C] with channels
    in file (alphabetical) order otherwise. `native=False` decodes with the
    pure-numpy plain version instead of the C++ codec.
    """
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    if version & 0x200 or version & 0x1000:
        raise ValueError(f"{path}: tiled/multipart EXR not supported")
    off = 8

    channels = []  # (name, pixel_type)
    compression = _COMP_NONE
    data_window = None
    while True:
        name, off = _read_cstr(buf, off)
        if not name:
            break
        atype, off = _read_cstr(buf, off)
        (size,) = struct.unpack_from("<i", buf, off)
        off += 4
        payload = buf[off:off + size]
        off += size
        if name == "channels":
            p = 0
            while payload[p] != 0:
                cname, p = _read_cstr(payload, p)
                (ptype,) = struct.unpack_from("<i", payload, p)
                p += 16  # type + pLinear/reserved + xSampling + ySampling
                channels.append((cname, ptype))
        elif name == "compression":
            compression = payload[0]
        elif name == "dataWindow":
            data_window = struct.unpack("<4i", payload)

    if compression not in _LINES_PER_BLOCK:
        raise ValueError(f"{path}: unsupported EXR compression {compression}")
    x0, y0, x1, y1 = data_window
    w, h = x1 - x0 + 1, y1 - y0 + 1
    lpb = _LINES_PER_BLOCK[compression]
    n_blocks = (h + lpb - 1) // lpb
    off += 8 * n_blocks  # skip the scanline offset table (blocks are inline)

    planes = {c: np.empty((h, w), _DTYPE[t]) for c, t in channels}
    pix_sz = {c: np.dtype(_DTYPE[t]).itemsize for c, t in channels}

    if native:
        _read_blocks_native(
            buf, off, n_blocks, lpb, compression in (_COMP_ZIP, _COMP_ZIPS),
            w, h, y0, [pix_sz[c] for c, _ in channels],
            [planes[c] for c, _ in channels])
    else:
        _read_blocks_py(buf, off, n_blocks, lpb, compression, w, y0, y1,
                        channels, planes, pix_sz)
    if len(channels) == 1:
        out = planes[channels[0][0]]
        return out.astype(np.float32) if out.dtype == np.float16 else out
    return np.stack([planes[c].astype(np.float32) for c, _ in channels], -1)


def write_exr(path, img, channel="Y", half=False, compression="zip"):
    """Write [H, W] (or [H, W, C] with C<=4 → RGBA-style names) scanline
    EXR. compression: 'none' | 'zips' | 'zip'."""
    img = np.asarray(img)
    if img.ndim == 2:
        names = [channel]
        planes = [img]
    else:
        names = list("RGBA"[: img.shape[2]])
        planes = [img[..., i] for i in range(img.shape[2])]
    order = np.argsort(names)  # EXR stores channels alphabetically
    names = [names[i] for i in order]
    planes = [planes[i] for i in order]
    dt = np.float16 if half else np.float32
    ptype = _PT_HALF if half else _PT_FLOAT
    planes = [np.ascontiguousarray(p, dt) for p in planes]
    h, w = planes[0].shape
    comp = {"none": _COMP_NONE, "zips": _COMP_ZIPS, "zip": _COMP_ZIP}[
        compression]
    lpb = _LINES_PER_BLOCK[comp]

    def attr(name, atype, payload):
        return (name.encode() + b"\x00" + atype.encode() + b"\x00"
                + struct.pack("<i", len(payload)) + payload)

    chlist = b"".join(
        n.encode() + b"\x00" + struct.pack("<iBBBBii", ptype, 0, 0, 0, 0,
                                           1, 1)
        for n in names) + b"\x00"
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header = (
        attr("channels", "chlist", chlist)
        + attr("compression", "compression", bytes([comp]))
        + attr("dataWindow", "box2i", box)
        + attr("displayWindow", "box2i", box)
        + attr("lineOrder", "lineOrder", b"\x00")
        + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
        + attr("screenWindowCenter", "v2f", struct.pack("<2f", 0.0, 0.0))
        + attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
        + b"\x00"
    )

    blocks = []
    for y in range(0, h, lpb):
        rows = min(lpb, h - y)
        raw = b"".join(planes[c][y + r].tobytes()
                       for r in range(rows) for c in range(len(planes)))
        if comp != _COMP_NONE:
            z = zlib.compress(_predictor_encode(raw))
            data = z if len(z) < len(raw) else raw
        else:
            data = raw
        blocks.append(struct.pack("<ii", y, len(data)) + data)

    with open(path, "wb") as f:
        f.write(struct.pack("<ii", _MAGIC, 2))
        f.write(header)
        base = 8 + len(header) + 8 * len(blocks)
        offsets = []
        for b in blocks:
            offsets.append(base)
            base += len(b)
        f.write(struct.pack(f"<{len(offsets)}Q", *offsets))
        for b in blocks:
            f.write(b)
    return path
