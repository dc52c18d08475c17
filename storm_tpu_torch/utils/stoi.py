"""STOI / ESTOI speech-intelligibility metrics in numpy and scipy (the port's
own copy of storm_tpu/utils/stoi.py, which the port may not import).

The reference evaluates ESTOI through the `pystoi` package
(sgmse/util/inference.py:7, 49); the metric is implemented here from the
definitions in:

- C. Taal et al., "An Algorithm for Intelligibility Prediction of
  Time-Frequency Weighted Noisy Speech", IEEE TASLP 2011 (STOI), and
- J. Jensen, C. Taal, "An Algorithm for Predicting the Intelligibility of
  Speech Masked by Modulated Noise Maskers", IEEE TASLP 2016 (ESTOI),

with the standard implementation constants (10 kHz analysis rate,
256-sample frames, 50% overlap, 512-pt FFT, 15 third-octave bands from
150 Hz, 30-frame analysis segments, 40 dB silent-frame threshold). A signal
with fewer than 30 non-silent frames at 10 kHz (about 0.4 s) raises
ValueError, as the reference's does.
"""
from __future__ import annotations

import numpy as np
from scipy.signal import resample_poly

FS = 10000
N_FRAME = 256
HOP = 128
NFFT = 512
NUMBAND = 15
MINFREQ = 150
N_SEG = 30
BETA = -15.0
DYN_RANGE = 40.0
EPS = np.finfo(np.float64).eps


def _hann_inner(n: int) -> np.ndarray:
    """Hann window without the zero endpoints (matlab hanning(n))."""
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(1, n + 1) / (n + 1)))


def _thirdoct(fs: int, nfft: int, num_bands: int, min_freq: float):
    """One-third octave band matrix (num_bands, nfft//2+1)."""
    f = np.linspace(0, fs, nfft + 1)[: nfft // 2 + 1]
    k = np.arange(num_bands, dtype=np.float64)
    cf = 2.0 ** (k / 3.0) * min_freq
    freq_low = cf * 2.0 ** (-1.0 / 6.0)
    freq_high = cf * 2.0 ** (1.0 / 6.0)
    obm = np.zeros((num_bands, len(f)))
    for i in range(num_bands):
        fl_ii = np.argmin((f - freq_low[i]) ** 2)
        fh_ii = np.argmin((f - freq_high[i]) ** 2)
        obm[i, fl_ii:fh_ii] = 1.0
    return obm


def _frame(x: np.ndarray, framelen: int, hop: int) -> np.ndarray:
    n = 1 + max(0, (len(x) - framelen)) // hop
    idx = hop * np.arange(n)[:, None] + np.arange(framelen)[None, :]
    return x[idx]


def _overlap_add(frames: np.ndarray, hop: int) -> np.ndarray:
    n, flen = frames.shape
    out = np.zeros(flen + hop * (n - 1))
    for i in range(n):
        out[i * hop : i * hop + flen] += frames[i]
    return out


def _remove_silent_frames(x, y, dyn_range, framelen, hop):
    w = _hann_inner(framelen)
    x_frames = _frame(x, framelen, hop) * w
    y_frames = _frame(y, framelen, hop) * w
    energies = 20.0 * np.log10(np.linalg.norm(x_frames, axis=1) + EPS)
    mask = energies > np.max(energies) - dyn_range
    return _overlap_add(x_frames[mask], hop), _overlap_add(y_frames[mask], hop)


def _band_spectrogram(x, obm):
    w = _hann_inner(N_FRAME)
    frames = _frame(x, N_FRAME, HOP) * w
    spec = np.abs(np.fft.rfft(frames, NFFT, axis=1)) ** 2  # (T, F)
    return np.sqrt(obm @ spec.T)  # (J, T)


def stoi(x: np.ndarray, y: np.ndarray, fs_sig: int, extended: bool = False) -> float:
    """Short-time objective intelligibility of degraded `y` vs clean `x`.

    Same call signature as `pystoi.stoi` (used at sgmse/util/inference.py:49).
    """
    x = np.asarray(x, np.float64).reshape(-1)
    y = np.asarray(y, np.float64).reshape(-1)
    if len(x) != len(y):
        m = min(len(x), len(y))
        x, y = x[:m], y[:m]
    if fs_sig != FS:
        x = resample_poly(x, FS, fs_sig)
        y = resample_poly(y, FS, fs_sig)

    x, y = _remove_silent_frames(x, y, DYN_RANGE, N_FRAME, HOP)
    if len(x) < N_FRAME:
        raise ValueError("Not enough non-silent frames for STOI")

    obm = _thirdoct(FS, NFFT, NUMBAND, MINFREQ)
    X = _band_spectrogram(x, obm)  # (J, M)
    Y = _band_spectrogram(y, obm)
    M = X.shape[1]
    if M < N_SEG:
        raise ValueError("Not enough frames for a 30-frame STOI segment")

    if extended:
        d_sum = 0.0
        n_segs = M - N_SEG + 1
        for m in range(n_segs):
            xs = X[:, m : m + N_SEG]
            ys = Y[:, m : m + N_SEG]
            # row (time) normalization
            xs = xs - xs.mean(axis=1, keepdims=True)
            xs = xs / (np.linalg.norm(xs, axis=1, keepdims=True) + EPS)
            ys = ys - ys.mean(axis=1, keepdims=True)
            ys = ys / (np.linalg.norm(ys, axis=1, keepdims=True) + EPS)
            # column (band) normalization
            xs = xs - xs.mean(axis=0, keepdims=True)
            xs = xs / (np.linalg.norm(xs, axis=0, keepdims=True) + EPS)
            ys = ys - ys.mean(axis=0, keepdims=True)
            ys = ys / (np.linalg.norm(ys, axis=0, keepdims=True) + EPS)
            d_sum += np.sum(xs * ys) / N_SEG
        return float(d_sum / n_segs)

    # classic STOI with clipping
    d_sum = 0.0
    n_segs = M - N_SEG + 1
    c = 10.0 ** (-BETA / 20.0)
    for m in range(n_segs):
        xs = X[:, m : m + N_SEG]
        ys = Y[:, m : m + N_SEG]
        alpha = np.linalg.norm(xs, axis=1, keepdims=True) / (
            np.linalg.norm(ys, axis=1, keepdims=True) + EPS
        )
        ys_c = np.minimum(alpha * ys, xs * (1.0 + c))
        xm = xs - xs.mean(axis=1, keepdims=True)
        ym = ys_c - ys_c.mean(axis=1, keepdims=True)
        corr = np.sum(
            (xm / (np.linalg.norm(xm, axis=1, keepdims=True) + EPS))
            * (ym / (np.linalg.norm(ym, axis=1, keepdims=True) + EPS))
        )
        d_sum += corr / NUMBAND
    return float(d_sum / n_segs)
