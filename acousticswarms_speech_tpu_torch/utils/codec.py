"""Opus codec round-trip via a direct ctypes binding to libopus
(JAX: utils/codec.py).

Native replacement for the reference's `opuslib` wrapper
(reference sep/helpers/codec.py): same robot-side parameters — 32 kbps,
complexity 0, no FEC/DTX, LSB depth 16, 20 ms frames, RESTRICTED_LOWDELAY
application — applied per channel as a training augmentation and by the
degraded evaluation.

Unlike the JAX package, which turns the codec into an identity transform
when libopus is missing, constructing an `OpusCodec` without libopus raises:
a run that asked for the codec never goes on without it.
"""
from __future__ import annotations

import ctypes
import ctypes.util

import numpy as np

OPUS_APPLICATION_RESTRICTED_LOWDELAY = 2051
OPUS_SET_BITRATE = 4002
OPUS_SET_COMPLEXITY = 4010
OPUS_SET_INBAND_FEC = 4012
OPUS_SET_PACKET_LOSS_PERC = 4014
OPUS_SET_DTX = 4016
OPUS_SET_LSB_DEPTH = 4036
OPUS_RESET_STATE = 4028

_MAX_PACKET = 4000


def _load_libopus():
    for name in ("opus", "libopus.so.0", "libopus.so"):
        path = ctypes.util.find_library(name) if "/" not in name and "." not in name else name
        try:
            return ctypes.CDLL(path or name)
        except OSError:
            continue
    return None


_lib = _load_libopus()
if _lib is not None:
    _lib.opus_encoder_create.restype = ctypes.c_void_p
    _lib.opus_decoder_create.restype = ctypes.c_void_p
    _lib.opus_encode.restype = ctypes.c_int
    _lib.opus_encode.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int16), ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int,
    ]
    _lib.opus_decode.restype = ctypes.c_int
    _lib.opus_decode.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int16), ctypes.c_int, ctypes.c_int,
    ]


class OpusCodec:
    """Encode/decode round-trip matching the robots' on-air compression."""

    def __init__(self, channels: int, sr: int, frame_width: float = 0.02) -> None:
        self.channels = channels
        self.sr = sr
        self.frame_size = int(round(sr * frame_width))
        if _lib is None:
            raise RuntimeError(
                "libopus cannot be loaded (tried libopus.so.0, libopus.so); "
                "the Opus codec augmentation and degraded evaluation need it")

        err = ctypes.c_int(0)
        self.encoder = _lib.opus_encoder_create(
            sr, channels, OPUS_APPLICATION_RESTRICTED_LOWDELAY, ctypes.byref(err)
        )
        assert err.value == 0, f"opus_encoder_create failed: {err.value}"
        self.decoder = _lib.opus_decoder_create(sr, channels, ctypes.byref(err))
        assert err.value == 0, f"opus_decoder_create failed: {err.value}"

        for ctl, val in (
            (OPUS_SET_BITRATE, 32000),
            (OPUS_SET_COMPLEXITY, 0),
            (OPUS_SET_INBAND_FEC, 0),
            (OPUS_SET_PACKET_LOSS_PERC, 0),
            (OPUS_SET_DTX, 0),
            (OPUS_SET_LSB_DEPTH, 16),
        ):
            _lib.opus_encoder_ctl(ctypes.c_void_p(self.encoder), ctl, val)

    def apply(self, audio: np.ndarray) -> np.ndarray:
        """Round-trip a float waveform (samples,) through the codec."""
        x = np.asarray(audio, dtype=np.float32)
        _lib.opus_encoder_ctl(ctypes.c_void_p(self.encoder), OPUS_RESET_STATE)
        _lib.opus_decoder_ctl(ctypes.c_void_p(self.decoder), OPUS_RESET_STATE)

        pcm = np.clip(np.round(x * (2 ** 15 - 1)), -32768, 32767).astype(np.int16)
        fs = self.frame_size
        out_chunks = []
        buf = ctypes.create_string_buffer(_MAX_PACKET)
        dec = np.zeros(fs * 4, dtype=np.int16)
        dec_ptr = dec.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))
        for i in range(0, len(pcm), fs):
            frame = pcm[i : i + fs]
            if len(frame) < fs:
                frame = np.pad(frame, (0, fs - len(frame)))
            nbytes = _lib.opus_encode(
                ctypes.c_void_p(self.encoder),
                frame.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                fs, buf, _MAX_PACKET,
            )
            assert nbytes > 0, f"opus_encode failed: {nbytes}"
            nsamp = _lib.opus_decode(
                ctypes.c_void_p(self.decoder), buf.raw[:nbytes], nbytes,
                dec_ptr, len(dec), 0,
            )
            assert nsamp > 0, f"opus_decode failed: {nsamp}"
            out_chunks.append(dec[:nsamp].copy())
        out = np.concatenate(out_chunks).astype(np.float32) / (2 ** 15 - 1)
        return out[: len(x)]
