"""Sidechain compressor and clipper for the nonlinear wind-noise mixtures
(counterpart of storm_tpu/preprocessing/compressor.py).

Host code in both packages (numpy, float64): the reference shells out to
ffmpeg's `sidechaincompress` + `amix` graph; the same chain is written here
with ffmpeg's parameter meanings (threshold, ratio, attack, release,
level_sc): a one-pole peak detector with separate attack and release
ballistics, then a hard-knee gain computer.
"""
from __future__ import annotations

import numpy as np


def sidechain_compress(
    speech: np.ndarray,
    sidechain: np.ndarray,
    sr: int = 16000,
    threshold: float = 0.125,
    ratio: float = 2.0,
    attack: float = 20.0,
    release: float = 250.0,
    sc_gain: float = 1.0,
    makeup: float = 1.0,
) -> np.ndarray:
    """Compress `speech` by the level of `sidechain`; both are cut to the
    shorter length.

    `threshold`: the linear level above which compression starts (ffmpeg's
    default 0.125); `ratio`: the compression ratio (1: none);
    `attack` / `release`: the detector's time constants in ms; `sc_gain`:
    the gain on the sidechain before detection (level_sc)."""
    n = min(len(speech), len(sidechain))
    speech = np.asarray(speech, np.float64)[:n]
    sc = np.abs(np.asarray(sidechain, np.float64)[:n]) * sc_gain

    atk = np.exp(-1.0 / (max(attack, 0.01) * 1e-3 * sr))
    rel = np.exp(-1.0 / (max(release, 0.01) * 1e-3 * sr))

    # the detector is sequential: one sample at a time, in blocks
    env = np.empty(n)
    level = 0.0
    blocks = 4096
    for start in range(0, n, blocks):
        seg = sc[start: start + blocks]
        out = np.empty(len(seg))
        for i, v in enumerate(seg):
            coeff = atk if v > level else rel
            level = coeff * level + (1.0 - coeff) * v
            out[i] = level
        env[start: start + len(seg)] = out

    # gain computer: above the threshold, reduce by the ratio (log domain)
    with np.errstate(divide="ignore"):
        over = np.maximum(env / threshold, 1.0)
    gain = over ** (1.0 / ratio - 1.0)
    return speech * gain * makeup


def hard_clip(x: np.ndarray, clip_threshold: float) -> np.ndarray:
    """Clip `x` at `clip_threshold` times its minimum and maximum."""
    x = np.asarray(x)
    lo = clip_threshold * np.min(x)
    hi = clip_threshold * np.max(x)
    return np.minimum(np.maximum(x, lo), hi)


def nonlinear_mix(
    speech: np.ndarray,
    noise: np.ndarray,
    sr: int = 16000,
    threshold: float = 0.125,
    ratio: float = 2.0,
    attack: float = 20.0,
    release: float = 250.0,
    sc_gain: float = 1.0,
) -> np.ndarray:
    """Speech ducked by the noise as sidechain, then averaged with the
    noise, as ffmpeg's `amix` averages its inputs."""
    n = min(len(speech), len(noise))
    compressed = sidechain_compress(
        speech[:n], noise[:n], sr=sr, threshold=threshold, ratio=ratio,
        attack=attack, release=release, sc_gain=sc_gain,
    )
    return 0.5 * (compressed + np.asarray(noise, np.float64)[:n])
