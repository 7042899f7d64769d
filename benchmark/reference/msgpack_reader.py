# Frozen copy of acousticswarms_speech_tpu_torch/models/msgpack_reader.py at commit 300ffdc,
# part of the benchmark's plain reference: it imports nothing of the port.
"""A small msgpack decoder for flax checkpoints, in pure Python.

The release weights are `flax.serialization.to_bytes` of a nested dict of
arrays: msgpack maps of strings, with each array stored as ext type 1 whose
payload is itself msgpack `[shape, dtype name, raw bytes]`.  This reader
handles exactly the msgpack types such a file uses (maps, arrays, strings,
binaries, integers, floats, nil, booleans, ext type 1) so the port needs
neither `msgpack` nor `flax`.  Array payloads become numpy arrays through
`np.frombuffer` over the file's bytes, without a per-element loop.
"""
from __future__ import annotations

import struct

import numpy as np

_EXT_NDARRAY = 1  # flax's _MsgpackExtType.ndarray


class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf)
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        start = self.pos
        self.pos += n
        if self.pos > len(self.buf):
            raise ValueError("msgpack data ends early")
        return self.buf[start:self.pos]

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def _array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def _ext(self, n: int):
        code = self._unpack(">b")
        data = self._take(n)
        if code != _EXT_NDARRAY:
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, dtype, raw = _Reader(data).read()
        return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)

    def read(self):
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b <= 0x8F:
            return self._map(b & 0x0F)
        if b <= 0x9F:
            return self._array(b & 0x0F)
        if b <= 0xBF:
            return str(self._take(b & 0x1F), "utf-8")
        if b >= 0xE0:
            return b - 0x100
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        sized = {  # type byte -> (length format, what follows)
            0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
            0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
            0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
            0xDC: (">H", "array"), 0xDD: (">I", "array"),
            0xDE: (">H", "map"), 0xDF: (">I", "map"),
        }
        if b in sized:
            fmt, kind = sized[b]
            n = self._unpack(fmt)
            if kind == "bin":
                return self._take(n)
            if kind == "str":
                return str(self._take(n), "utf-8")
            if kind == "ext":
                return self._ext(n)
            return self._array(n) if kind == "array" else self._map(n)
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            return self._ext(1 << (b - 0xD4))
        scalar = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                  0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in scalar:
            return self._unpack(scalar[b])
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")


def unpackb(data: bytes):
    """Decode one msgpack object.  Arrays are read-only views of `data`."""
    reader = _Reader(data)
    out = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError("trailing bytes after the msgpack object")
    return out


def read_msgpack(path: str):
    with open(path, "rb") as f:
        return unpackb(f.read())
