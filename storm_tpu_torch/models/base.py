"""wav <-> compressed-spec plumbing (counterpart of storm_tpu/models/base.py)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..signal.stft import STFTConfig, istft_real, stft_real
from ..signal.transforms import SpecTransform, pad_spec


def wav_to_spec(y: torch.Tensor, stft_config: STFTConfig,
                transform: SpecTransform) -> torch.Tensor:
    """(B, T) waveform -> compressed packed-real spec (B, F, Tf, 2)."""
    return transform.forward_packed(stft_real(y, stft_config))


def spec_to_wav(spec: torch.Tensor, stft_config: STFTConfig, transform: SpecTransform,
                length: Optional[int] = None) -> torch.Tensor:
    """Compressed packed-real spec (B, F, Tf, 2) -> (B, T) waveform."""
    return istft_real(transform.backward_packed(spec), stft_config, length=length)


def normalize_wav(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-utterance max-abs normalisation over all but the batch axis.

    Returns (y / norm, norm) with norm broadcastable against y.
    """
    B = y.shape[0]
    norm = y.abs().reshape(B, -1).amax(dim=-1).clamp_min(1e-10)
    norm = norm.reshape((B,) + (1,) * (y.ndim - 1))
    return y / norm, norm


def lift_spec(Y: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    """(B, F, T, 2) -> ((B, 1, F, T, 2), True); (B, D, F, T, 2) -> (Y, False)."""
    if Y.ndim == 4:
        return Y[:, None], True
    if Y.ndim == 5:
        return Y, False
    raise ValueError(f"expected (B,F,T,2) or (B,D,F,T,2) spec, got {tuple(Y.shape)}")


def prepare_spec(y: torch.Tensor, stft_config: STFTConfig, transform: SpecTransform,
                 multiple: int = 64) -> Tuple[torch.Tensor, int]:
    """wav (B, T) -> (compressed spec padded to a multiple of 64 frames, frames before padding)."""
    Y = wav_to_spec(y, stft_config, transform)
    return pad_spec(Y, multiple=multiple, axis=-2), Y.shape[-2]
