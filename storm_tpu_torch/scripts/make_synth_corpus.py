"""Generate a synthetic speech-like enhancement corpus in the wsj0 layout
(counterpart of scripts/make_synth_corpus.py).

Utterances are "syllable bursts": harmonic pulse trains with per-syllable
formant filters and pitch contours, amplitude-modulated into syllables, with
enough spectro-temporal structure for ESTOI and SI-SDR to behave as on
speech. The noisy mixtures add white + pink noise at an SNR drawn from
[--snr_lo, --snr_hi] over the utterance's power.

    python -m storm_tpu_torch.scripts.make_synth_corpus --root corpus/ [--n_train 512]

Layout: <root>/{tr,cv,tt}/{clean,noisy}/u****.wav, 16-bit PCM at 16 kHz.
The draws are made in the reference script's order from one
`np.random.default_rng(--seed)`, so one seed writes the same bytes with
either script.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
from scipy.signal import lfilter

from ..data.audio import save_wav

SR = 16000


def _formant_filter(x: np.ndarray, rng: np.random.Generator, sr: int = SR) -> np.ndarray:
    """2-3 random resonators in the speech formant range."""
    out = np.zeros_like(x)
    for _ in range(int(rng.integers(2, 4))):
        f0 = rng.uniform(300, 3200)
        bw = rng.uniform(80, 300)
        r = np.exp(-np.pi * bw / sr)
        theta = 2 * np.pi * f0 / sr
        out += lfilter([1 - r], [1.0, -2 * r * np.cos(theta), r * r], x)
    return out


def make_utterance(rng: np.random.Generator, dur_s: float) -> np.ndarray:
    """Syllable bursts: voiced pulse trains through formant filters with a
    pitch contour, and some unvoiced (noise) syllables; peak 0.3."""
    n = int(dur_s * SR)
    x = np.zeros(n, np.float64)
    t = 0
    while t < n:
        syl = int(rng.uniform(0.08, 0.25) * SR)
        gap = int(rng.uniform(0.02, 0.12) * SR)
        seg = np.zeros(syl)
        if rng.uniform() < 0.8:  # voiced: an impulse train at the pitch marks
            f0 = rng.uniform(80, 260)
            drift = rng.uniform(-0.3, 0.3)
            phase = np.cumsum(f0 * (1 + drift * np.linspace(0, 1, syl)) / SR)
            seg[np.diff(np.floor(phase), prepend=0.0) > 0] = 1.0
        else:  # unvoiced
            seg = rng.standard_normal(syl) * 0.3
        seg = _formant_filter(seg, rng)
        seg *= np.hanning(2 * syl)[:syl] ** 0.5  # attack and decay
        end = min(t + syl, n)
        x[t:end] += seg[: end - t]
        t += syl + gap
    peak = np.abs(x).max()
    return (0.3 * x / peak if peak > 0 else x).astype(np.float32)


def make_noise(rng: np.random.Generator, n: int) -> np.ndarray:
    """White + pink (a leaky integrator of white noise) mixture, unit std."""
    w = rng.standard_normal(n)
    p = lfilter([1.0], [1.0, -0.98], rng.standard_normal(n))
    p /= np.abs(p).std() + 1e-9
    mix = rng.uniform(0.3, 0.7)
    noise = mix * w + (1 - mix) * p
    return (noise / (noise.std() + 1e-9)).astype(np.float32)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--n_train", type=int, default=512)
    ap.add_argument("--n_valid", type=int, default=32)
    ap.add_argument("--n_test", type=int, default=32)
    ap.add_argument("--snr_lo", type=float, default=0.0)
    ap.add_argument("--snr_hi", type=float, default=8.0)
    ap.add_argument("--dur_lo", type=float, default=2.2)
    ap.add_argument("--dur_hi", type=float, default=4.0)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    rng = np.random.default_rng(args.seed)
    for subset, count in (("tr", args.n_train), ("cv", args.n_valid), ("tt", args.n_test)):
        for kind in ("clean", "noisy"):
            os.makedirs(os.path.join(args.root, subset, kind), exist_ok=True)
        for i in range(count):
            x = make_utterance(rng, rng.uniform(args.dur_lo, args.dur_hi))
            noise = make_noise(rng, len(x))
            snr = rng.uniform(args.snr_lo, args.snr_hi)
            # the noise scaled to the target SNR over the utterance's power
            noise *= np.sqrt(np.mean(x**2) / (np.mean(noise**2) * 10 ** (snr / 10)))
            y = x + noise
            peak = max(np.abs(y).max(), 1.0)  # no clipping
            save_wav(os.path.join(args.root, subset, "clean", f"u{i:04d}.wav"), x / peak)
            save_wav(os.path.join(args.root, subset, "noisy", f"u{i:04d}.wav"), y / peak)
        print(f"{subset}: {count} pairs")


if __name__ == "__main__":
    main()
