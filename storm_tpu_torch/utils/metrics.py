"""Evaluation metrics and numeric helpers on host numpy arrays (counterpart
of storm_tpu/utils/metrics.py): SI-SDR and its components, wide-band PESQ,
LSD, SNR helpers, alignment, WER, confidence intervals and the `Method`
accumulator of the evaluation CLI, and, re-exported from the port's copy of
stoi.py, STOI and ESTOI (`stoi(x, x_hat, sr, extended=True)`).

PESQ needs the optional `pesq` package, as in the reference; without it
`pesq_wb` returns NaN and warns once. `pydub_read` needs `pydub`.
"""
from __future__ import annotations

import warnings
from typing import Sequence

import numpy as np
import scipy.signal as ss
import scipy.stats
import torch

from ..signal.stft import STFTConfig, stft_real
from .stoi import stoi  # noqa: F401  (re-export; ESTOI is extended=True)

_PESQ_WARNED = False


def pesq_wb(sr: int, ref: np.ndarray, deg: np.ndarray) -> float:
    """Wide-band PESQ (ITU-T P.862.2) of `deg` against `ref` through the
    optional `pesq` package, as the reference calls it (`pesq(16000, x,
    x_hat, 'wb')`); NaN when the package is missing. A module named `pesq`
    without a file (a stub put in `sys.modules`) counts as missing, as in
    the reference."""
    global _PESQ_WARNED
    try:
        import pesq as _pesq_mod
        from pesq import pesq as _pesq
        if getattr(_pesq_mod, "__file__", None) is None:
            raise ImportError("pesq module is a stub")
    except ImportError:
        if not _PESQ_WARNED:
            warnings.warn("`pesq` package not installed: PESQ is reported as NaN")
            _PESQ_WARNED = True
        return float("nan")
    return float(_pesq(sr, np.asarray(ref), np.asarray(deg), "wb"))


def si_sdr(s: np.ndarray, s_hat: np.ndarray) -> float:
    """Scale-invariant SDR in dB of the estimate `s_hat` against the clean
    `s`, in float64 (sgmse/util/other.py:82-87)."""
    s = np.asarray(s, np.float64).reshape(-1)
    s_hat = np.asarray(s_hat, np.float64).reshape(-1)
    alpha = np.dot(s_hat, s) / np.linalg.norm(s) ** 2
    return float(10.0 * np.log10(np.linalg.norm(alpha * s) ** 2
                                 / np.linalg.norm(alpha * s - s_hat) ** 2))


def si_sdr_components(s_hat, s, n, eps: float = 1e-10):
    """(target, noise, artifact) parts of `s_hat` against the clean `s` and
    the noise `n` (sgmse/util/other.py:21-32)."""
    s_hat = np.asarray(s_hat, np.float64)
    s = np.asarray(s, np.float64)
    n = np.asarray(n, np.float64)
    s_target = np.dot(s_hat, s) / (eps + np.linalg.norm(s) ** 2) * s
    e_noise = np.dot(s_hat, n) / (eps + np.linalg.norm(n) ** 2) * n
    return s_target, e_noise, s_hat - s_target - e_noise


def energy_ratios(s_hat, s, n, eps: float = 1e-10):
    """(SI-SDR, SI-SIR, SI-SAR) in dB (other.py:35-44)."""
    s_target, e_noise, e_art = si_sdr_components(s_hat, s, n)
    t2 = np.linalg.norm(s_target) ** 2
    sdr = 10 * np.log10(eps + t2 / (eps + np.linalg.norm(e_noise + e_art) ** 2))
    sir = 10 * np.log10(eps + t2 / (eps + np.linalg.norm(e_noise) ** 2))
    sar = 10 * np.log10(eps + t2 / (eps + np.linalg.norm(e_art) ** 2))
    return float(sdr), float(sir), float(sar)


def lsd(s_hat: np.ndarray, s: np.ndarray, eps: float = 1e-10) -> float:
    """Log-spectral distance through the default STFT (other.py:16-19)."""
    cfg = STFTConfig()

    def log_power(w):
        S = stft_real(torch.from_numpy(np.asarray(w, np.float32)), cfg).numpy()
        return 2 * np.log(eps + np.sqrt(S[..., 0] ** 2 + S[..., 1] ** 2))

    return float(np.mean(np.sqrt(np.mean(np.abs(log_power(s_hat) - log_power(s))))))


def snr_dB(s: np.ndarray, n: np.ndarray) -> float:
    """SNR in dB of `s` against `n` (other.py:96-100)."""
    s_power = np.sum(np.asarray(s) ** 2) / len(s)
    n_power = np.sum(np.asarray(n) ** 2) / len(n)
    return float(10 * np.log10(s_power / n_power))


def snr_scale_factor(speech, noise, snr: float) -> float:
    """The noise's scale for a mixture at `snr` dB (other.py:136-142)."""
    return float(np.sqrt(np.var(speech) / (np.var(noise) * 10.0 ** (snr / 10.0))))


def hp_filter(signal, cut_off: float = 80, order: int = 10, sr: int = 16000):
    """Butterworth high-pass (other.py:76-80)."""
    sos = ss.butter(order, cut_off / sr * 2, "hp", output="sos")
    return ss.sosfilt(sos, signal)


def align(y: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """`y` rolled by the lag that maximises its cross-correlation with `ref`
    (other.py:153-157)."""
    y = np.asarray(y)
    ref = np.asarray(ref)
    lag = np.argmax(ss.fftconvolve(ref.squeeze(), np.flip(y.squeeze()))) - (ref.shape[-1] - 1)
    return np.roll(y, lag, axis=-1) if lag else y


def wer(r: Sequence[str], h: Sequence[str]) -> float:
    """Word error rate of the hypothesis `h` against the reference `r`, by
    Levenshtein distance over words (other.py:159-183)."""
    d = np.zeros((len(r) + 1, len(h) + 1), dtype=np.int32)
    d[:, 0] = np.arange(len(r) + 1)
    d[0, :] = np.arange(len(h) + 1)
    for i in range(1, len(r) + 1):
        for j in range(1, len(h) + 1):
            sub = d[i - 1, j - 1] + (r[i - 1] != h[j - 1])
            d[i, j] = min(sub, d[i, j - 1] + 1, d[i - 1, j] + 1)
    return float(d[len(r), len(h)]) / len(r)


def pydub_read(path, sr: int = 16000) -> np.ndarray:
    """Any audio format through pydub and ffmpeg (other.py:144-151), as
    float32 (T, channels). Needs the optional `pydub` package; for WAV files
    use storm_tpu_torch.data.audio.load_wav."""
    try:
        from pydub import AudioSegment
    except ImportError as e:
        raise ImportError("pydub is not installed; for WAV files use "
                          "storm_tpu_torch.data.audio.load_wav") from e
    y = AudioSegment.from_file(path).set_frame_rate(sr)
    samples = [c.get_array_of_samples() for c in y.split_to_mono()]
    fp = np.array(samples).T.astype(np.float32)
    fp /= np.iinfo(samples[0].typecode).max
    return fp


def mean_conf_int(data, confidence: float = 0.95):
    """(mean, half-width of the Student-t confidence interval) (other.py:46-51)."""
    a = 1.0 * np.array(data)
    m, se = np.mean(a), scipy.stats.sem(a)
    return m, se * scipy.stats.t.ppf((1 + confidence) / 2.0, len(a) - 1)


def mean_std(data):
    """(mean, std) over the values that are not NaN."""
    data = np.asarray(data)
    data = data[~np.isnan(data)]
    return np.mean(data), np.std(data)


class Method:
    """Per-metric value lists of one method for result tables (other.py:59-74)."""

    def __init__(self, name: str, base_dir: str, metrics: Sequence[str]):
        self.name = name
        self.base_dir = base_dir
        self.metrics = {metric: [] for metric in metrics}

    def append(self, metric: str, value: float) -> None:
        self.metrics[metric].append(value)

    def get_mean_ci(self, metric: str):
        return mean_conf_int(np.array(self.metrics[metric]))
