"""ctypes bindings for the native WAV loader (csrc/wavloader.cpp; JAX
package: runtime/native.py).

The source is compiled with `g++ -O3 -fPIC -shared -pthread` (or the
compiler `CXX` names) at first use, never at import, into `kernel_build/`,
in a directory keyed by a hash of the source, the compiler and the flags.
The library is written under a temporary name and renamed, so parallel
builds never load a half-written library.  A failed build or load raises:
unlike the JAX package, there is no fallback to the Python reader.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(PKG_DIR, "csrc", "wavloader.cpp")
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-shared", "-pthread"]
BUILD_TIMEOUT_S = 300
BUILD_ROOT = os.path.join(os.path.dirname(PKG_DIR), "kernel_build")  # gitignored

_lock = threading.Lock()
_lib = None


def _compiler() -> str:
    return os.environ.get("CXX", "g++")


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(
            [_compiler(), *CXX_FLAGS]).encode())
    return os.path.join(BUILD_ROOT, f"wavloader_{key.hexdigest()[:16]}",
                        "libswarmruntime.so")


def build() -> str:
    """Compile the loader if this source has no library yet; returns the
    library's path."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}.{threading.get_ident()}"
    cmd = [_compiler(), *CXX_FLAGS, SOURCE, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S,
                              stdin=subprocess.DEVNULL)
    except FileNotFoundError as e:
        raise RuntimeError(f"compiler not found ({cmd[0]}): {e}") from e
    if proc.returncode != 0 or not os.path.exists(tmp):
        raise RuntimeError(f"building the WAV loader failed "
                           f"({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
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
            _lib = lib
    return _lib


def load_wav(path: str, max_frames: int | None = None) -> np.ndarray:
    """Decode one WAV's first channel to float32."""
    lib = _load()
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
    lib = _load()
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
