"""Minimal OpenEXR 2.0 scanline reader and writer in pure numpy (own copy
of instant_ngp_tpu/data/exr.py; a file written by either package reads in
the other).

Single-part scanline images with HALF, FLOAT or UINT channels and NONE,
ZIPS or ZIP compression are read; uncompressed HALF or FLOAT is written.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Tuple

import numpy as np

_MAGIC = 0x01312F76

_PIXEL_DTYPES = {0: np.uint32, 1: np.float16, 2: np.float32}
_PIXEL_TYPE_OF = {np.dtype(np.uint32): 0, np.dtype(np.float16): 1, np.dtype(np.float32): 2}

# compression id -> scanlines per chunk
_LINES_PER_CHUNK = {0: 1, 1: 1, 2: 1, 3: 16}


def _read_null_str(buf: bytes, pos: int) -> Tuple[str, int]:
    end = buf.index(b"\x00", pos)
    return buf[pos:end].decode("latin-1"), end + 1


def _unpredict_and_interleave(raw: bytes) -> bytes:
    """Undo EXR's delta predictor + two-half byte split (ZIP/ZIPS post-inflate)."""
    d = np.frombuffer(raw, np.uint8).astype(np.int16)
    # reconstruct: d[i] += d[i-1] - 128 (mod 256)
    # cumulative form: out[i] = (cumsum(d) - 128*i) mod 256
    idx = np.arange(d.size, dtype=np.int64)
    rec = (np.cumsum(d.astype(np.int64)) - 128 * idx) % 256
    rec = rec.astype(np.uint8)
    # deinterleave: first half -> even positions, second half -> odd
    n = rec.size
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[0::2] = rec[:half]
    out[1::2] = rec[half:]
    return out.tobytes()


def _interleave_and_predict(raw: bytes) -> bytes:
    d = np.frombuffer(raw, np.uint8)
    n = d.size
    half = (n + 1) // 2
    split = np.empty(n, np.uint8)
    split[:half] = d[0::2]
    split[half:] = d[1::2]
    s = split.astype(np.int16)
    delta = np.empty(n, np.int16)
    delta[0] = s[0]
    delta[1:] = (s[1:] - s[:-1] + 128) % 256
    return delta.astype(np.uint8).tobytes()


def read_exr(path: str) -> Tuple[np.ndarray, List[str]]:
    """Read an EXR file. Returns (H, W, C) float32 array and channel names.

    Channels are reordered to RGBA order when the file contains the usual
    R/G/B[/A] channels (EXR stores them alphabetically: A,B,G,R).
    """
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<iI", buf, 0)
    if magic != _MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    if version & 0x200:
        raise ValueError(f"{path}: tiled EXR not supported")
    pos = 8

    channels: List[Tuple[str, int]] = []  # (name, pixel_type)
    compression = 0
    data_window = (0, 0, 0, 0)

    while True:
        name, pos = _read_null_str(buf, pos)
        if name == "":
            break
        atype, pos = _read_null_str(buf, pos)
        (size,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        payload = buf[pos:pos + size]
        pos += size
        if name == "channels" and atype == "chlist":
            cpos = 0
            while payload[cpos] != 0:
                cname, cpos = _read_null_str(payload, cpos)
                ptype, = struct.unpack_from("<i", payload, cpos)
                cpos += 16  # pixel type + pLinear/reserved + xSampling + ySampling
                channels.append((cname, ptype))
        elif name == "compression":
            compression = payload[0]
        elif name == "dataWindow":
            data_window = struct.unpack("<4i", payload)

    if compression not in _LINES_PER_CHUNK:
        raise ValueError(f"{path}: unsupported EXR compression {compression} "
                         "(supported: NONE, RLE-free ZIPS, ZIP)")
    if compression == 1:
        raise ValueError(f"{path}: RLE compression not supported")

    xmin, ymin, xmax, ymax = data_window
    width, height = xmax - xmin + 1, ymax - ymin + 1
    lines_per_chunk = _LINES_PER_CHUNK[compression]
    n_chunks = (height + lines_per_chunk - 1) // lines_per_chunk

    # offset table
    offsets = struct.unpack_from(f"<{n_chunks}Q", buf, pos)
    pos += 8 * n_chunks

    ch_dtypes = [np.dtype(_PIXEL_DTYPES[pt]) for _, pt in channels]
    bytes_per_line = sum(width * dt.itemsize for dt in ch_dtypes)

    out = {name: np.empty((height, width), np.float32) for name, _ in channels}

    for off in offsets:
        y, size = struct.unpack_from("<ii", buf, off)
        chunk = buf[off + 8: off + 8 + size]
        n_lines = min(lines_per_chunk, ymax + 1 - y)
        expected = bytes_per_line * n_lines
        if compression in (2, 3) and size < expected:
            chunk = _unpredict_and_interleave(zlib.decompress(chunk))
        lpos = 0
        for line in range(n_lines):
            yy = y - ymin + line
            for (cname, _), dt in zip(channels, ch_dtypes):
                nbytes = width * dt.itemsize
                row = np.frombuffer(chunk[lpos:lpos + nbytes], dt)
                out[cname][yy] = row.astype(np.float32)
                lpos += nbytes

    names = [n for n, _ in channels]
    order = [c for c in ("R", "G", "B", "A") if c in names]
    if order:
        names = order + [n for n in names if n not in order]
    img = np.stack([out[n] for n in names], axis=-1)
    return img, names


def write_exr(path: str, img: np.ndarray, half: bool = True) -> None:
    """Write (H, W, C) array as an uncompressed scanline EXR (C in 1..4)."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    names = {1: ["Y"], 2: ["G", "R"], 3: ["B", "G", "R"], 4: ["A", "B", "G", "R"]}[c]
    # map channel name -> source index in RGBA order
    src_order = {1: [0], 2: [1, 0], 3: [2, 1, 0], 4: [3, 2, 1, 0]}[c]
    dt = np.dtype(np.float16 if half else np.float32)
    ptype = _PIXEL_TYPE_OF[dt]

    def attr(name: str, atype: str, payload: bytes) -> bytes:
        return name.encode() + b"\x00" + atype.encode() + b"\x00" + \
            struct.pack("<i", len(payload)) + payload

    chlist = b""
    for n in names:
        chlist += n.encode() + b"\x00" + struct.pack("<i", ptype) + \
            b"\x00\x00\x00\x00" + struct.pack("<ii", 1, 1)
    chlist += b"\x00"

    header = b""
    header += attr("channels", "chlist", chlist)
    header += attr("compression", "compression", b"\x00")
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header += attr("dataWindow", "box2i", box)
    header += attr("displayWindow", "box2i", box)
    header += attr("lineOrder", "lineOrder", b"\x00")
    header += attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
    header += attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\x00"

    preamble = struct.pack("<iI", _MAGIC, 2) + header
    line_size = w * dt.itemsize * c
    table_start = len(preamble)
    data_start = table_start + 8 * h

    chunks = []
    for y in range(h):
        row = b"".join(img[y, :, si].astype(dt).tobytes() for si in src_order)
        chunks.append(struct.pack("<ii", y, line_size) + row)

    offsets = []
    off = data_start
    for ch in chunks:
        offsets.append(off)
        off += len(ch)

    with open(path, "wb") as f:
        f.write(preamble)
        f.write(struct.pack(f"<{h}Q", *offsets))
        for ch in chunks:
            f.write(ch)
