"""Wind-noise synthesis (counterpart of storm_tpu/preprocessing/wind.py).

Host code in both packages (numpy and scipy, float64). The reference drives
the undistributed generator of Mirabilii et al. (IWAENC 2022); this one has
the same controls (sample rate, duration, gustiness, wind-speed profile):
low-frequency turbulence noise whose level and spectral tilt follow a
slowly varying wind-speed profile, with gust modulation.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
from scipy.signal import lfilter

from ..data.audio import save_wav


def make_wind_profile(
    rng: np.random.Generator,
    gustiness: float,
    magnitude_range=(200.0, 500.0),
    transition_threshold: float = 100.0,
) -> List[float]:
    """A random wind-speed profile of max(1, int(1.5 gustiness)) points,
    consecutive points less than `transition_threshold` apart."""
    n_points = max(1, int(1.5 * gustiness))
    profile = [float(rng.uniform(*magnitude_range))]
    while len(profile) < n_points:
        while True:
            p = float(rng.uniform(*magnitude_range))
            if abs(p - profile[-1]) < transition_threshold:
                break
        profile.append(p)
    return profile


def generate_wind_noise(
    duration: float = 8.0,
    fs: int = 16000,
    gustiness: float = 5.0,
    wind_profile=None,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """(signal, wind speed per sample), the signal at 0.95 peak.

    White noise through two one-pole low-passes at 40 Hz (turbulence) plus
    a gentler broadband hiss, scaled by the interpolated wind speed (cubed
    for the turbulence, to the fifth for the hiss) and by a 0.5-2 Hz gust
    modulation whose depth grows with `gustiness`."""
    rng = np.random.default_rng(seed)
    n = int(duration * fs)
    if wind_profile is None:
        wind_profile = make_wind_profile(rng, gustiness)
    profile = np.asarray(wind_profile, np.float64)
    # piecewise-linear interpolation of the profile over time
    knots = np.linspace(0, n - 1, max(len(profile), 2))
    vals = profile if len(profile) >= 2 else np.repeat(profile, 2)
    speed = np.interp(np.arange(n), knots, vals)
    speed_n = speed / (np.max(speed) + 1e-12)

    white = rng.standard_normal(n)
    fc = 40.0  # Hz
    a = np.exp(-2.0 * np.pi * fc / fs)
    turb = lfilter([1.0 - a], [1.0, -a], white)
    turb = lfilter([1.0 - a], [1.0, -a], turb)
    hiss = lfilter([1.0 - 0.7], [1.0, -0.7], rng.standard_normal(n))

    g_rate = 0.5 + 1.5 * rng.random()
    g_phase = 2 * np.pi * rng.random()
    t = np.arange(n) / fs
    gust = 1.0 + 0.3 * np.tanh(gustiness / 5.0) * np.sin(
        2 * np.pi * g_rate * t + g_phase
    )

    sig = speed_n**3 * gust * turb + 0.05 * speed_n**5 * hiss
    peak = np.max(np.abs(sig)) + 1e-12
    return 0.95 * sig / peak, speed


class WindNoiseGenerator:
    """The interface of the Mirabilii et al. generator that the reference's
    wind-noise script drives."""

    def __init__(self, fs: int, duration: float, generate: bool = True,
                 wind_profile=None, gustiness: float = 5.0,
                 start_seed: int = 0):
        self.fs = fs
        self.duration = duration
        self.wind_profile = wind_profile
        self.gustiness = gustiness
        self.seed = start_seed

    def generate_wind_noise(self) -> Tuple[np.ndarray, np.ndarray]:
        return generate_wind_noise(
            duration=self.duration, fs=self.fs, gustiness=self.gustiness,
            wind_profile=self.wind_profile, seed=self.seed,
        )

    def save_signal(self, signal, filename: str, num_ch: int = 1,
                    fs: Optional[int] = None) -> None:
        del num_ch
        save_wav(filename, np.asarray(signal), fs or self.fs)
