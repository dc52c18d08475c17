"""The evaluation's metrics on host numpy arrays (counterpart of the part of
storm_tpu/utils/metrics.py that the in-training evaluation uses): SI-SDR,
wide-band PESQ and, re-exported from the port's copy of stoi.py, STOI and
ESTOI (`stoi(x, x_hat, sr, extended=True)`).

PESQ needs the optional `pesq` package, as in the reference; without it
`pesq_wb` returns NaN and warns once. The rest of the reference module
(energy ratios, LSD, alignment, WER) comes with the evaluation CLI.
"""
from __future__ import annotations

import warnings

import numpy as np

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
