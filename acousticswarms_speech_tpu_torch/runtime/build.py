"""Build, load and launch the port's compiled code (csrc/).

Each source is compiled at first use, never at import, into a shared
library with a plain C interface, loaded with ctypes: a `.cu` kernel by
`nvcc` for sm_90a, the `.cpp` WAV loader by the compiler `CXX` names
(default `g++`).  Its directory under kernel_build/ is keyed by a hash of
the source and the flags, and for C++ of the compiler's name too; the
library is written under a temporary name and renamed, so concurrent and
interrupted builds leave no half-written library.  A failed build raises
with the compiler's output; there is no fallback.
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
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-shared", "-pthread"]
BUILD_TIMEOUT_S = 300
BUILD_ROOT = os.path.join(os.path.dirname(PKG_DIR), "kernel_build")  # gitignored

_count_lock = threading.Lock()  # pipeline lanes launch from several threads


def nvcc() -> str:
    return shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def _compiler(source: str) -> tuple[list[str], list[str]]:
    """The command line that compiles `source` (without its output and
    input), and the part of it that keys the library."""
    if source.endswith(".cu"):
        return [nvcc(), *NVCC_FLAGS], NVCC_FLAGS
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS]
    return cmd, cmd


def source_path(name: str) -> str:
    """csrc/<name> of the package."""
    return os.path.join(PKG_DIR, "csrc", name)


def library_path(name: str) -> str:
    """kernel_build/<stem>_<hash>/lib<stem>.so of csrc/<name> (<stem>.cu or
    <stem>.cpp)."""
    with open(source_path(name), "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(_compiler(name)[1]).encode())
    stem = os.path.splitext(name)[0]
    return os.path.join(BUILD_ROOT, f"{stem}_{key.hexdigest()[:16]}",
                        f"lib{stem}.so")


def compile_library(source: str, path: str) -> str:
    """Compile the file `source` into the library `path`; returns the
    compiler's output (nvcc's holds the -Xptxas -v register and spill
    report), which is also kept in `build.log` beside the library."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}.{threading.get_ident()}"
    cmd = [*_compiler(source)[0], "-o", tmp, source]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S, stdin=subprocess.DEVNULL)
    except FileNotFoundError as e:
        raise RuntimeError(f"compiler not found ({cmd[0]}): {e}") from e
    log = proc.stdout + proc.stderr
    if proc.returncode != 0 or not os.path.exists(tmp):
        raise RuntimeError(f"building {source} failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{log}")
    with open(os.path.join(os.path.dirname(path), "build.log"), "w") as f:
        f.write(log)
    os.replace(tmp, path)
    return log


def build(name: str) -> str:
    """Compile csrc/<name> if this source has no library yet; returns the
    library's path."""
    path = library_path(name)
    if not os.path.exists(path):
        compile_library(source_path(name), path)
    return path


def build_log(name: str) -> str:
    """The compiler's output from the build of csrc/<name>'s current source
    ('' if none)."""
    log = os.path.join(os.path.dirname(library_path(name)), "build.log")
    if not os.path.exists(log):
        return ""
    with open(log) as f:
        return f.read()


class Library:
    """The library of csrc/<name>, built and loaded at the first `get()`;
    `declare(lib)` sets the argument and result types of its functions.
    `init`, if given, names a function of no arguments that returns a
    cudaError and runs once on each device before the first launch there
    (a kernel's attributes, say)."""

    def __init__(self, name: str, declare, init: str | None = None):
        self.name, self._declare, self._init = name, declare, init
        self.source = source_path(name)
        self._lock = threading.Lock()
        self._lib = None
        self._ready: set[int] = set()  # devices where `init` has run

    def get(self):
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(build(self.name))
                self._declare(lib)
                self._lib = lib
        return self._lib

    def _check(self, fn: str, err: int) -> None:
        if err != 0:
            raise RuntimeError(f"{self.name} {fn} failed: cudaError {err}")

    def launch(self, fn: str, wrapper, device: torch.device, *args) -> None:
        """`fn(*args, stream)` on `device`, with the raw handle of its
        current stream; raises on a non-zero cudaError, else adds 1 to
        `wrapper.launches`.

        torch.cuda.current_stream() builds a Stream object per call, which
        costs the host more than a small launch costs the card, so the raw
        handle is read instead.  A kernel goes to the calling thread's
        current device, so a device context is entered only for another
        device."""
        lib = self.get()
        index = torch.cuda.current_device() if device.index is None \
            else device.index
        if self._init is not None and index not in self._ready:
            with self._lock:
                if index not in self._ready:
                    with torch.cuda.device(index):
                        self._check(self._init, getattr(lib, self._init)())
                    self._ready.add(index)
        stream = torch._C._cuda_getCurrentRawStream(index)
        if index == torch.cuda.current_device():
            err = getattr(lib, fn)(*args, stream)
        else:
            with torch.cuda.device(index):
                err = getattr(lib, fn)(*args, stream)
        self._check(fn, err)
        with _count_lock:
            wrapper.launches += 1
