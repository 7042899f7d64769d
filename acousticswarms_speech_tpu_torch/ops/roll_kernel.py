"""Build, load and launch the CUDA roll kernel (csrc/roll.cu).

The source is compiled with `nvcc` for sm_90a into a shared library with a
plain C interface and loaded with ctypes.  The build runs at the first CUDA
call, never at import.  Its directory is keyed by a hash of the source and
the flags; the library is written under a temporary name and renamed, so
concurrent builds and interrupted builds leave no half-written library.
A failed build raises with nvcc's output; there is no fallback.
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
SOURCE = os.path.join(PKG_DIR, "csrc", "roll.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
NVCC_TIMEOUT_S = 300
BUILD_ROOT = os.path.join(os.path.dirname(PKG_DIR), "kernel_build")  # gitignored

_lock = threading.Lock()
_count_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    return shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_ROOT, f"roll_{key.hexdigest()[:16]}",
                        "libroll.so")


def build() -> str:
    """Compile the kernel if this source has no library yet; returns the
    library's path.  nvcc's output (with the -Xptxas -v register and spill
    report) is kept in `build.log` beside it."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE]
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


def build_log() -> str:
    """nvcc's output from the build of the current source ('' if none)."""
    log = os.path.join(os.path.dirname(library_path()), "build.log")
    if not os.path.exists(log):
        return ""
    with open(log) as f:
        return f.read()


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            fn = lib.roll_channels_batch_launch
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def _launch(device: torch.device, launch, *args) -> int:
    """`launch(*args, stream)` with the raw handle of `device`'s current
    stream, on `device`; returns the launcher's error code.

    torch.cuda.current_stream() builds a Stream object per call, which
    costs the host more than a small launch costs the card, so the raw
    handle is read instead.  A kernel goes to the calling thread's current
    device, so a device context is entered only for another device."""
    index = torch.cuda.current_device() if device.index is None else device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == torch.cuda.current_device():
        return launch(*args, stream)
    with torch.cuda.device(index):
        return launch(*args, stream)


def roll_channels_batch_cuda(mix: torch.Tensor,
                             shifts: torch.Tensor) -> torch.Tensor:
    """mix (M, T) float32, shifts (B, M) int32, both contiguous on one CUDA
    device -> (B, M, T), for any B * M.  Launches on the current stream."""
    if not (mix.is_cuda and shifts.is_cuda and mix.device == shifts.device):
        raise ValueError("roll kernel: mix and shifts must be on one CUDA device")
    if mix.dtype != torch.float32 or shifts.dtype != torch.int32:
        raise TypeError(f"roll kernel takes float32 mix and int32 shifts, got "
                        f"{mix.dtype} and {shifts.dtype}")
    if mix.dim() != 2 or shifts.dim() != 2 or shifts.shape[1] != mix.shape[0]:
        raise ValueError(f"roll kernel shapes: mix {tuple(mix.shape)}, "
                         f"shifts {tuple(shifts.shape)}")
    if not (mix.is_contiguous() and shifts.is_contiguous()):
        raise ValueError("roll kernel takes contiguous tensors")
    M, T = mix.shape
    B = shifts.shape[0]
    out = torch.empty((B, M, T), dtype=mix.dtype, device=mix.device)
    if B == 0 or T == 0:
        return out
    lib = _load()
    err = _launch(mix.device, lib.roll_channels_batch_launch, mix.data_ptr(),
                  shifts.data_ptr(), out.data_ptr(), B, M, T)
    if err != 0:
        raise RuntimeError(f"roll kernel launch failed: cudaError {err}")
    with _count_lock:  # pipeline lanes launch from several threads
        roll_channels_batch_cuda.launches += 1
    return out


# calls that launched the kernel since the last reset (a call of more than
# 65535 rows launches it once per 65535, csrc/roll.cu)
roll_channels_batch_cuda.launches = 0

