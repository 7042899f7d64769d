"""ctypes bindings for the native WAV loader (csrc/wavloader.cpp; JAX
package: runtime/native.py).

The source is compiled by runtime/build.py at first use, never at import,
with `g++` or the compiler `CXX` names.  A failed build or load raises:
unlike the JAX package, there is no fallback to the Python reader.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

from . import build as libbuild

NAME = "wavloader.cpp"


def _declare(lib) -> None:
    lib.swarm_load_wav.restype = ctypes.c_int64
    lib.swarm_load_wav.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int),
    ]
    lib.swarm_load_wavs.restype = ctypes.c_int
    lib.swarm_load_wavs.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
    ]


_library = libbuild.Library(NAME, _declare)
SOURCE = _library.source


def library_path() -> str:
    return libbuild.library_path(NAME)


def build() -> str:
    """Compile the loader if this source has no library yet; returns the
    library's path."""
    return libbuild.build(NAME)


def load_wav(path: str, max_frames: int | None = None) -> np.ndarray:
    """Decode one WAV's first channel to float32."""
    lib = _library.get()
    if max_frames is None:
        max_frames = (os.path.getsize(path) // 2) + 64
    out = np.zeros(max_frames, dtype=np.float32)
    sr = ctypes.c_int(0)
    n = lib.swarm_load_wav(
        os.fsencode(path), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_frames, ctypes.byref(sr),
    )
    if n < 0:
        raise IOError(f"swarm_load_wav({path}) failed: {n}")
    return out[:n]


def load_wavs(paths: list[str], max_frames: int,
              n_threads: int = 4) -> np.ndarray:
    """Decode a batch of WAVs' first channels in parallel -> (len(paths),
    max_frames) float32, zero-padded."""
    lib = _library.get()
    out = np.zeros((len(paths), max_frames), dtype=np.float32)
    frames = np.zeros(len(paths), dtype=np.int64)
    encoded = [os.fsencode(p) for p in paths]  # alive during the call
    arr = (ctypes.c_char_p * len(paths))(*encoded)
    rc = lib.swarm_load_wavs(
        arr, len(paths),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max_frames,
        frames.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n_threads,
    )
    if rc != 0 or (frames < 0).any():
        bad = [paths[i] for i in np.flatnonzero(frames < 0)]
        raise IOError(f"swarm_load_wavs failed for {bad}")
    return out
