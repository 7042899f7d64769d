"""Build, load and launch the port's hand-written CUDA kernels.

Each source under csrc/ is compiled with `nvcc` for sm_90a into a shared
library with a plain C interface and loaded with ctypes.  A build runs at
the kernel's first CUDA call, never at import.  Its directory is keyed by
a hash of the source and the flags; the library is written under a
temporary name and renamed, so concurrent builds and interrupted builds
leave no half-written library.  A failed build raises with nvcc's output;
there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
NVCC_TIMEOUT_S = 300
BUILD_ROOT = os.path.join(os.path.dirname(PKG_DIR), "kernel_build")  # gitignored


def nvcc() -> str:
    return shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def source_path(name: str) -> str:
    """csrc/<name> of the package."""
    return os.path.join(PKG_DIR, "csrc", name)


def library_path(source: str, stem: str) -> str:
    """kernel_build/<stem>_<hash of source and flags>/lib<stem>.so"""
    with open(source, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_ROOT, f"{stem}_{key.hexdigest()[:16]}",
                        f"lib{stem}.so")


def build(source: str, stem: str) -> str:
    """Compile `source` if it has no library yet; returns the library's
    path.  nvcc's output (with the -Xptxas -v register and spill report)
    is kept in `build.log` beside it."""
    path = library_path(source, stem)
    if os.path.exists(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, source]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=NVCC_TIMEOUT_S, stdin=subprocess.DEVNULL)
    except FileNotFoundError as e:
        raise RuntimeError(f"nvcc not found ({cmd[0]}): {e}") from e
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
    with open(os.path.join(os.path.dirname(path), "build.log"), "w") as f:
        f.write(log)
    os.replace(tmp, path)
    return path


def build_log(source: str, stem: str) -> str:
    """nvcc's output from the build of the current source ('' if none)."""
    log = os.path.join(os.path.dirname(library_path(source, stem)), "build.log")
    if not os.path.exists(log):
        return ""
    with open(log) as f:
        return f.read()


class Library:
    """The library of one source, built and loaded at the first `get()`;
    `declare(lib)` sets the argument and result types of its functions."""

    def __init__(self, source: str, stem: str, declare):
        self.source, self.stem, self._declare = source, stem, declare
        self._lock = threading.Lock()
        self._lib = None

    def build(self) -> str:
        return build(self.source, self.stem)

    def build_log(self) -> str:
        return build_log(self.source, self.stem)

    def get(self):
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(self.build())
                self._declare(lib)
                self._lib = lib
        return self._lib


def launch(device: torch.device, fn, *args) -> int:
    """`fn(*args, stream)` with the raw handle of `device`'s current
    stream, on `device`; returns the launcher's error code.

    torch.cuda.current_stream() builds a Stream object per call, which
    costs the host more than a small launch costs the card, so the raw
    handle is read instead.  A kernel goes to the calling thread's current
    device, so a device context is entered only for another device."""
    index = torch.cuda.current_device() if device.index is None else device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == torch.cuda.current_device():
        return fn(*args, stream)
    with torch.cuda.device(index):
        return fn(*args, stream)
