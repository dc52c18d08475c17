"""STFT / iSTFT as DFT matmuls (counterpart of storm_tpu/signal/stft.py).

The forward transform frames the (reflect-padded) signal and multiplies by
windowed cos/sin matrices; the inverse multiplies by the windowed inverse
DFT matrices, overlap-adds with `fold`, and divides by the squared-window
envelope. Both match `torch.stft` / `torch.istft` (center=True) and the
reference package, with spectrograms packed-real (..., F, n_frames, 2).

Matmuls run in float32; on the card the caller keeps TF32 off
(`torch.backends.cuda.matmul.allow_tf32 = False`). The DFT matrices and the
overlap-add envelope are uploaded once per device and dtype
(`utils/tensors.host_constant`), so a captured graph finds them made.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.tensors import host_constant


def _window_np(window_type: str, n: int) -> np.ndarray:
    k = np.arange(n, dtype=np.float64)
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * k / n))  # periodic hann
    if window_type == "hann":
        return w
    if window_type == "sqrthann":
        return np.sqrt(w)
    raise NotImplementedError(f"Window type {window_type} not implemented!")


@dataclasses.dataclass(frozen=True)
class STFTConfig:
    """n_fft=510 -> 256 frequency bins, hop 128, periodic Hann. Frames are
    always centred (reflect pad of n_fft // 2), as in the reference."""

    n_fft: int = 510
    hop_length: int = 128
    window: str = "hann"


@lru_cache(maxsize=8)
def _dft_matrices(n_fft: int, window: str):
    """(n_fft, F) float32 cos and -sin matrices with the analysis window."""
    F_ = n_fft // 2 + 1
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(F_, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    w = _window_np(window, n_fft)[:, None]
    return ((np.cos(ang) * w).astype(np.float32),
            (-np.sin(ang) * w).astype(np.float32))


@lru_cache(maxsize=8)
def _idft_matrices(n_fft: int, window: str):
    """(F, n_fft) one-sided inverse DFT matrices with the synthesis window."""
    F_ = n_fft // 2 + 1
    k = np.arange(F_, dtype=np.float64)[:, None]
    n = np.arange(n_fft, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * k * n / n_fft
    c = np.full((F_, 1), 2.0)
    c[0, 0] = 1.0
    if n_fft % 2 == 0:
        c[-1, 0] = 1.0
    w = _window_np(window, n_fft)[None, :]
    return ((np.cos(ang) * c / n_fft * w).astype(np.float32),
            (-np.sin(ang) * c / n_fft * w).astype(np.float32))


@lru_cache(maxsize=32)
def _ola_envelope(n_frames: int, n_fft: int, hop: int, window: str) -> np.ndarray:
    """Reciprocal of the overlap-added squared window; 1 where it is ~0."""
    w2 = _window_np(window, n_fft) ** 2
    total = n_fft + hop * (n_frames - 1)
    env = np.zeros(total, dtype=np.float64)
    for t in range(n_frames):
        env[t * hop: t * hop + n_fft] += w2
    inv = np.where(env > 1e-11, 1.0 / np.maximum(env, 1e-30), 1.0)
    return inv.astype(np.float32)


def _dft_matrix(n_fft: int, window: str, part: int) -> np.ndarray:
    return _dft_matrices(n_fft, window)[part]


def _idft_matrix(n_fft: int, window: str, part: int) -> np.ndarray:
    return _idft_matrices(n_fft, window)[part]


def _const(make, args: tuple, like: torch.Tensor) -> torch.Tensor:
    return host_constant(make, args, like.device, like.dtype)


def stft_real(x: torch.Tensor, config: STFTConfig = STFTConfig()) -> torch.Tensor:
    """(..., T) real -> (..., F, n_frames, 2) packed-real STFT."""
    n_fft, hop = config.n_fft, config.hop_length
    batch_shape = x.shape[:-1]
    x = x.reshape(-1, 1, x.shape[-1])
    pad = n_fft // 2
    x = F.pad(x, (pad, pad), mode="reflect")
    frames = x[:, 0].unfold(-1, n_fft, hop)  # (N, n_frames, n_fft)
    re = frames @ _const(_dft_matrix, (n_fft, config.window, 0), frames)
    im = frames @ _const(_dft_matrix, (n_fft, config.window, 1), frames)
    spec = torch.stack([re, im], dim=-1).transpose(-2, -3)  # (N, F, n_frames, 2)
    return spec.reshape(batch_shape + spec.shape[1:])


def istft_real(spec: torch.Tensor, config: STFTConfig = STFTConfig(),
               length: Optional[int] = None) -> torch.Tensor:
    """(..., F, n_frames, 2) packed-real -> (..., T), matching torch.istft."""
    n_fft, hop = config.n_fft, config.hop_length
    batch_shape = spec.shape[:-3]
    spec = spec.reshape((-1,) + spec.shape[-3:]).transpose(-2, -3)  # (N, n_frames, F, 2)
    frames = (spec[..., 0] @ _const(_idft_matrix, (n_fft, config.window, 0), spec)
              + spec[..., 1] @ _const(_idft_matrix, (n_fft, config.window, 1), spec))
    n_frames = frames.shape[-2]
    total = n_fft + hop * (n_frames - 1)
    y = F.fold(frames.transpose(1, 2), output_size=(1, total),
               kernel_size=(1, n_fft), stride=(1, hop))[:, 0, 0]  # (N, total)
    y = y * _const(_ola_envelope, (n_frames, n_fft, hop, config.window), y)

    pad = n_fft // 2
    if length is not None:
        # like torch.istft: slice [pad, pad+length) of the full overlap-add
        # (this may reach into the centre end pad), zero-fill past its end
        y = y[:, pad:min(pad + length, total)]
        if y.shape[-1] < length:
            y = F.pad(y, (0, length - y.shape[-1]))
    else:
        y = y[:, pad: total - pad]
    return y.reshape(batch_shape + y.shape[-1:])
