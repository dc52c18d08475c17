"""Noise-file sampling for dataset creation (counterpart of
storm_tpu/preprocessing/utils.py). Host code in both packages."""
from __future__ import annotations

import glob
import os
from math import gcd
from typing import Optional, Tuple

import numpy as np
from scipy.signal import resample_poly

from ..data.audio import load_wav


def _resample(x: np.ndarray, sr_from: int, sr_to: int) -> np.ndarray:
    if sr_from == sr_to:
        return x
    g = gcd(sr_from, sr_to)
    return resample_poly(x, sr_to // g, sr_from // g, axis=-1)


def obtain_noise_file(
    noise_dir: str,
    i_sample: int,
    channels: int,
    dataset: str,
    sample_rate: int,
    len_speech: int,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, int]:
    """A noise excerpt (C, T) at `sample_rate`, by the dataset's convention.

    wham: the i-th file round-robin, its first channel for `channels` 1.
    chime: a random CAF / PED / STR / BUS recording, channels CH1..CHn,
    each resampled before a random crop of `len_speech` samples; a
    directory without such files (a toy one) gives a random crop of any
    WAV in it. qut raises NotImplementedError, as in the reference."""
    rng = rng if rng is not None else np.random.default_rng(i_sample)
    files = sorted(os.listdir(noise_dir))
    if not files:
        raise FileNotFoundError(f"no noise files in {noise_dir}")

    if dataset == "wham":
        noise, noise_sr = load_wav(os.path.join(noise_dir, files[i_sample % len(files)]))
        noise = _resample(noise, noise_sr, sample_rate)
        if channels == 1:
            noise = noise[:1]
        return noise, sample_rate

    if dataset == "chime":
        noise_types = ["CAF", "PED", "STR", "BUS"]
        noise_type = noise_types[rng.integers(len(noise_types))]
        candidates = glob.glob(os.path.join(noise_dir, f"*_{noise_type}.CH1.wav"))
        if not candidates:  # any WAV of a toy directory
            candidates = glob.glob(os.path.join(noise_dir, "*.wav"))
            base = candidates[rng.integers(len(candidates))]
            noise, noise_sr = load_wav(base)
            noise = _resample(noise, noise_sr, sample_rate)
            if noise.shape[-1] > len_speech:
                start = rng.integers(noise.shape[-1] - len_speech)
                noise = noise[..., start: start + len_speech]
            return noise[:channels], sample_rate
        base = candidates[rng.integers(len(candidates))][: -len(".CH1.wav")]
        # each channel at the target rate before the crop, so the crop is
        # in the target rate's samples
        chans = []
        for i_ch in range(channels):
            sig, noise_sr = load_wav(base + f".CH{i_ch + 1}.wav")
            chans.append(_resample(sig[0], noise_sr, sample_rate))
        noise = np.stack(chans)
        start = (rng.integers(noise.shape[-1] - len_speech)
                 if noise.shape[-1] > len_speech else 0)
        return noise[:, start: start + len_speech], sample_rate

    if dataset == "qut":
        raise NotImplementedError("qut noise sampling (as in the reference)")
    raise ValueError(f"unknown noise dataset {dataset!r}")
