"""A small msgpack encoder for flax-layout checkpoints, in pure Python.

The counterpart of `msgpack_reader.py`: it writes what
`flax.serialization.to_bytes` writes for a nested dict of arrays, so that a
param file written by the port loads with the JAX package's `load_params`.
Maps have string keys; each numpy array is ext type 1 whose payload is
msgpack `[shape, dtype name, raw C-order bytes]`; Python scalars, strings,
bytes, lists and None use the smallest msgpack encoding, as msgpack-python
chooses it.
"""
from __future__ import annotations

import os
import struct

import numpy as np

_EXT_NDARRAY = 1  # flax's _MsgpackExtType.ndarray


def _sized(out: list, n: int, small: int | None, small_max: int,
           codes: tuple[int, int, int]) -> None:
    """Header of a str/bin/array/map of length `n`: the fix form when
    `small` is given and n <= small_max, else 8/16/32-bit lengths."""
    if small is not None and n <= small_max:
        out.append(bytes([small | n]))
    elif codes[0] and n <= 0xFF:
        out.append(struct.pack(">BB", codes[0], n))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BH", codes[1], n))
    else:
        out.append(struct.pack(">BI", codes[2], n))


def _int(out: list, v: int) -> None:
    if 0 <= v <= 0x7F or -32 <= v < 0:
        out.append(struct.pack(">b" if v < 0 else ">B", v))
        return
    for lo, hi, fmt in ((0, 0xFF, ">BB"), (0, 0xFFFF, ">BH"),
                        (0, 0xFFFFFFFF, ">BI"), (0, 2 ** 64 - 1, ">BQ"),
                        (-2 ** 7, 2 ** 7 - 1, ">Bb"), (-2 ** 15, 2 ** 15 - 1, ">Bh"),
                        (-2 ** 31, 2 ** 31 - 1, ">Bi"), (-2 ** 63, 2 ** 63 - 1, ">Bq")):
        if lo <= v <= hi:
            code = {">BB": 0xCC, ">BH": 0xCD, ">BI": 0xCE, ">BQ": 0xCF,
                    ">Bb": 0xD0, ">Bh": 0xD1, ">Bi": 0xD2, ">Bq": 0xD3}[fmt]
            out.append(struct.pack(fmt, code, v))
            return
    raise OverflowError(f"integer {v} does not fit in 64 bits")


def _ext(out: list, code: int, data: bytes) -> None:
    n = len(data)
    fix = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fix:
        out.append(struct.pack(">Bb", fix[n], code))
    else:
        _sized(out, n, None, 0, (0xC7, 0xC8, 0xC9))
        out.append(struct.pack(">b", code))
    out.append(data)


def _pack(out: list, obj) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, (int, np.integer)) and not isinstance(obj, bool):
        _int(out, int(obj))
    elif isinstance(obj, (float, np.floating)) and not isinstance(obj, np.ndarray):
        out.append(struct.pack(">Bd", 0xCB, float(obj)))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _sized(out, len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _sized(out, len(data), None, 0, (0xC4, 0xC5, 0xC6))
        out.append(data)
    elif isinstance(obj, np.ndarray):
        arr = np.ascontiguousarray(obj)
        _ext(out, _EXT_NDARRAY,
             packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")]))
    elif isinstance(obj, dict):
        _sized(out, len(obj), 0x80, 15, (0, 0xDE, 0xDF))
        for key, val in obj.items():
            _pack(out, key)
            _pack(out, val)
    elif isinstance(obj, (list, tuple)):
        _sized(out, len(obj), 0x90, 15, (0, 0xDC, 0xDD))
        for val in obj:
            _pack(out, val)
    else:
        raise TypeError(f"cannot msgpack-encode {type(obj).__name__}")


def packb(obj) -> bytes:
    """Encode one object (see the module docstring for the types)."""
    out: list = []
    _pack(out, obj)
    return b"".join(out)


def write_msgpack(path: str, obj) -> None:
    """Encode `obj` to `path`, written under a temporary name and renamed,
    so that an interrupted save never leaves a truncated file."""
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(packb(obj))
    os.replace(tmp, path)
