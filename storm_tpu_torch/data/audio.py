"""WAV I/O with scipy (counterpart of storm_tpu/data/audio.py)."""
from __future__ import annotations

import struct
from typing import Tuple

import numpy as np
from scipy.io import wavfile

_INT_SCALES = {
    np.dtype(np.int16): 1 << 15,
    np.dtype(np.int32): 1 << 31,
    np.dtype(np.uint8): 1 << 7,
}


def load_wav(path) -> Tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 (C, T) in [-1, 1], sample rate)."""
    sr, data = wavfile.read(path)
    if data.dtype in _INT_SCALES:
        scale = _INT_SCALES[data.dtype]
        if data.dtype == np.dtype(np.uint8):
            data = data.astype(np.float32) - 128.0
        data = np.asarray(data, np.float32) / scale
    else:
        data = np.asarray(data, np.float32)
    data = data[None, :] if data.ndim == 1 else data.T  # scipy gives (T, C)
    return np.ascontiguousarray(data), int(sr)


def save_wav(path, data, sr: int = 16000) -> None:
    """Write float32 (T,) or (C, T) audio in [-1, 1] as 16-bit PCM."""
    data = np.asarray(data, np.float32)
    if data.ndim == 2:
        data = data.T
    data = np.clip(data, -1.0, 1.0)
    wavfile.write(path, sr, (data * 32767.0).astype(np.int16))


def wav_info(path) -> Tuple[int, int, int]:
    """(sample rate, channels, frames) of a WAV file, from its header: the
    samples are not read."""
    with open(path, "rb") as f:
        riff = f.read(12)
        if len(riff) < 12 or riff[:4] != b"RIFF" or riff[8:] != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        fmt = None
        while True:
            head = f.read(8)
            if len(head) < 8:
                raise ValueError(f"{path}: no fmt and data chunks")
            chunk, size = head[:4], struct.unpack("<I", head[4:])[0]
            if chunk == b"fmt ":
                body = f.read(size)
                if len(body) < 14:
                    raise ValueError(f"{path}: short fmt chunk")
                _, channels, sr, _, block_align = struct.unpack("<HHIIH", body[:14])
                fmt = (sr, channels, block_align)
                f.seek(size & 1, 1)  # chunks are padded to an even size
            elif chunk == b"data":
                if fmt is None or fmt[2] == 0:
                    raise ValueError(f"{path}: data chunk before a valid fmt chunk")
                return fmt[0], fmt[1], size // fmt[2]
            else:
                f.seek(size + (size & 1), 1)
