"""The subset of MessagePack that snapshots use, in plain Python: maps
(string or integer keys), arrays, str, bin, int, float (64-bit), bool and
nil.

`packb(obj)` gives the bytes of `msgpack.packb(obj, use_bin_type=True)`:
the shortest encoding of every int, a 64-bit float for every float, str8
for strings of 32-255 bytes, bin for bytes, maps in the dict's order.
`unpackb(data)` reads what `msgpack.unpackb(data, raw=False,
strict_map_key=False)` reads of that subset, and float32 too. So a snapshot
written by the JAX package (through msgpack) loads here, and one written
here loads there, on a machine without the msgpack package.
"""

from __future__ import annotations

import struct
from typing import Any, List

_BE = {1: ">B", 2: ">H", 4: ">I", 8: ">Q"}


def _pack(obj: Any, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        n = len(data)
        if n <= 31:
            out.append(bytes([0xa0 | n]))
        elif n <= 0xff:
            out.append(b"\xd9" + struct.pack(">B", n))
        elif n <= 0xffff:
            out.append(b"\xda" + struct.pack(">H", n))
        else:
            out.append(b"\xdb" + struct.pack(">I", n))
        out.append(data)
    elif isinstance(obj, bytes):
        data = obj
        n = len(data)
        if n <= 0xff:
            out.append(b"\xc4" + struct.pack(">B", n))
        elif n <= 0xffff:
            out.append(b"\xc5" + struct.pack(">H", n))
        else:
            out.append(b"\xc6" + struct.pack(">I", n))
        out.append(data)
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        if n <= 15:
            out.append(bytes([0x90 | n]))
        elif n <= 0xffff:
            out.append(b"\xdc" + struct.pack(">H", n))
        else:
            out.append(b"\xdd" + struct.pack(">I", n))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        n = len(obj)
        if n <= 15:
            out.append(bytes([0x80 | n]))
        elif n <= 0xffff:
            out.append(b"\xde" + struct.pack(">H", n))
        else:
            out.append(b"\xdf" + struct.pack(">I", n))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot serialize {type(obj)} as msgpack")


def _pack_int(v: int, out: List[bytes]) -> None:
    if 0 <= v < 0x80:
        out.append(bytes([v]))
    elif -32 <= v < 0:
        out.append(struct.pack(">b", v))
    elif 0 <= v <= 0xff:
        out.append(b"\xcc" + struct.pack(">B", v))
    elif -0x80 <= v < 0:
        out.append(b"\xd0" + struct.pack(">b", v))
    elif 0 <= v <= 0xffff:
        out.append(b"\xcd" + struct.pack(">H", v))
    elif -0x8000 <= v < 0:
        out.append(b"\xd1" + struct.pack(">h", v))
    elif 0 <= v <= 0xffffffff:
        out.append(b"\xce" + struct.pack(">I", v))
    elif -0x80000000 <= v < 0:
        out.append(b"\xd2" + struct.pack(">i", v))
    elif 0 <= v <= 0xffffffffffffffff:
        out.append(b"\xcf" + struct.pack(">Q", v))
    elif -0x8000000000000000 <= v < 0:
        out.append(b"\xd3" + struct.pack(">q", v))
    else:
        raise OverflowError(f"integer {v} does not fit in 64 bits")


def packb(obj: Any) -> bytes:
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.at = 0

    def take(self, n: int) -> memoryview:
        if self.at + n > len(self.data):
            raise ValueError("msgpack data ends early")
        chunk = self.data[self.at:self.at + n]
        self.at += n
        return chunk

    def uint(self, n: int) -> int:
        return struct.unpack(_BE[n], self.take(n))[0]

    def read(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.read() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return str(self.take(b & 0x1f), "utf-8")
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in (0xc4, 0xc5, 0xc6):
            return bytes(self.take(self.uint(1 << (b - 0xc4))))
        if b == 0xca:
            return struct.unpack(">f", self.take(4))[0]
        if b == 0xcb:
            return struct.unpack(">d", self.take(8))[0]
        if 0xcc <= b <= 0xcf:
            return self.uint(1 << (b - 0xcc))
        if 0xd0 <= b <= 0xd3:
            n = 1 << (b - 0xd0)
            return struct.unpack(_BE[n].lower(), self.take(n))[0]
        if b in (0xd9, 0xda, 0xdb):
            return str(self.take(self.uint(1 << (b - 0xd9))), "utf-8")
        if b in (0xdc, 0xdd):
            n = self.uint(2 if b == 0xdc else 4)
            return [self.read() for _ in range(n)]
        if b in (0xde, 0xdf):
            return self.map(self.uint(2 if b == 0xde else 4))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not in the "
                         f"subset snapshots use")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def unpackb(data: bytes) -> Any:
    reader = _Reader(data)
    obj = reader.read()
    if reader.at != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.at} bytes of msgpack "
                         f"data left over")
    return obj

