"""Host-side audio IO without librosa/soundfile.

Host NumPy, copied from the JAX package's `utils/audio.py` for the PyTorch port
(the port imports nothing of that package).

Replaces the reference's librosa/torchaudio/soundfile loaders
(reference sep/helpers/utils.py:79-96) with a stdlib-`wave` + numpy
implementation.  All project audio is mono-per-file PCM WAV at 48 kHz; we
support 16/24/32-bit integer and 32/64-bit float WAVs.
"""
from __future__ import annotations

import os
import struct
import wave

import numpy as np


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a WAV file -> (data (channels, samples) float32 in [-1, 1], sr)."""
    # `wave` cannot parse float WAVs; sniff the format chunk first.
    with open(path, "rb") as f:
        header = f.read(12)
        if header[:4] != b"RIFF" or header[8:12] != b"WAVE":
            raise ValueError(f"{path} is not a RIFF/WAVE file")
        fmt = None
        data = None
        while True:
            chunk_hdr = f.read(8)
            if len(chunk_hdr) < 8:
                break
            cid, size = chunk_hdr[:4], struct.unpack("<I", chunk_hdr[4:])[0]
            if cid == b"fmt ":
                fmt = f.read(size)
            elif cid == b"data":
                data = f.read(size)
            else:
                f.seek(size + (size & 1), os.SEEK_CUR)
                continue
            if size & 1:
                f.seek(1, os.SEEK_CUR)
            if fmt is not None and data is not None:
                break
    if fmt is None or data is None:
        raise ValueError(f"malformed WAV file: {path}")

    audio_format, n_channels, sr, _, _, bits = struct.unpack("<HHIIHH", fmt[:16])
    if audio_format == 0xFFFE and len(fmt) >= 40:  # WAVE_FORMAT_EXTENSIBLE
        audio_format = struct.unpack("<H", fmt[24:26])[0]

    if audio_format == 3:  # IEEE float
        dtype = np.float32 if bits == 32 else np.float64
        x = np.frombuffer(data, dtype=dtype).astype(np.float32)
    elif audio_format == 1:  # PCM
        if bits == 16:
            x = np.frombuffer(data, dtype=np.int16).astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(data, dtype=np.int32).astype(np.float32) / 2147483648.0
        elif bits == 24:
            raw = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
            val = (
                raw[:, 0].astype(np.int32)
                | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16)
            )
            val = (val << 8) >> 8  # sign-extend
            x = val.astype(np.float32) / 8388608.0
        elif bits == 8:
            x = (np.frombuffer(data, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        else:
            raise ValueError(f"unsupported PCM bit depth {bits} in {path}")
    else:
        raise ValueError(f"unsupported WAV format {audio_format} in {path}")

    x = x.reshape(-1, n_channels).T
    return np.ascontiguousarray(x), sr


def read_audio_file(path: str, sr: int | None = None) -> np.ndarray:
    """Read audio -> (channels, samples) float32.  `sr`, when given, is asserted
    (no resampling path exists in the pipeline: everything is 48 kHz)."""
    x, file_sr = read_wav(path)
    if sr is not None and file_sr != sr:
        raise ValueError(f"{path}: expected sr={sr}, file has {file_sr}")
    return x


def write_wav(path: str, data: np.ndarray, sr: int) -> None:
    """Write float audio (channels, samples) or (samples,) as 16-bit PCM WAV."""
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[None, :]
    pcm = np.clip(np.round(data * 32767.0), -32768, 32767).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(pcm.shape[0])
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.T.tobytes())


# Alias matching the reference helper name (sep/helpers/utils.py:89).
write_audio_file = write_wav
