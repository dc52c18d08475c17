"""Shoebox room acoustics: image-source RIRs and RT60 measurement
(counterpart of storm_tpu/preprocessing/room.py).

This is host code in both packages: numpy and scipy in float64, run once per
corpus file while a dataset is written, never on an accelerator. It is not a
fallback for a device path. The image-source sum below keeps the JAX
package's loop order and draws from the caller's `np.random.Generator` in
the same order, so one seed writes the same WAV bytes with either package.

The reference's dereverberation data builds rooms with pyroomacoustics
(`pra.inverse_sabine`, `pra.ShoeBox(max_order=min(3, max_order),
ray_tracing=True)`, `measure_rt60`); the subset it needs is written here:

- `inverse_sabine`: Sabine's formula for the absorption coefficient and an
  estimate of the reflection order.
- `shoebox_rir` / `simulate_shoebox`: image-source early reflections (Allen
  & Berkley) up to `max_order`, plus an exponentially decaying stochastic
  tail at the target T60 in place of ray-traced late reverberation.
- `simulate_dry`: the direct path alone (the dry target room).
- `measure_rt60`: Schroeder backward integration with a -5..-25 dB fit.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy.signal import fftconvolve

C_SOUND = 343.0


def inverse_sabine(rt60: float, room_dim) -> Tuple[float, int]:
    """(energy absorption coefficient, image-source order) for a target
    RT60 in a room of `room_dim` metres; ValueError when the room is too
    large for the RT60 (absorption >= 1)."""
    room_dim = np.asarray(room_dim, np.float64)
    V = float(np.prod(room_dim))
    S = 2.0 * (
        room_dim[0] * room_dim[1]
        + room_dim[1] * room_dim[2]
        + room_dim[0] * room_dim[2]
    )
    a = 24.0 * np.log(10.0) * V / (C_SOUND * S * rt60)
    if a >= 1.0:
        raise ValueError(
            "evaluation of parameters failed. room may be too large for "
            f"required RT60 (absorption {a:.3f} >= 1)"
        )
    # reflections needed for the decay to cover rt60 across the smallest dim
    max_order = int(np.ceil(C_SOUND * rt60 / float(np.min(room_dim)) / 2.0))
    return float(a), max_order


def shoebox_rir(
    room_dim,
    source,
    mic,
    e_absorption: float,
    max_order: int,
    fs: int = 16000,
    t60_tail: Optional[float] = None,
    rng: Optional[np.random.Generator] = None,
    frac_taps: int = 81,
) -> np.ndarray:
    """Image-source RIR of a shoebox room, float64 (L,) at `fs`.

    `room_dim`, `source`, `mic`: 3-vectors in metres; `e_absorption`: the
    energy absorption coefficient; `max_order`: the reflection order of the
    early part. With `t60_tail`, an exponentially decaying noise tail of
    that T60 (drawn from `rng`, default seed 0) continues the image-source
    part."""
    room_dim = np.asarray(room_dim, np.float64)
    source = np.asarray(source, np.float64)
    mic = np.asarray(mic, np.float64)
    beta = np.sqrt(max(1.0 - e_absorption, 0.0))  # pressure reflection coefficient

    # Allen & Berkley image families per axis: for (n, q), q in {0, 1},
    # position 2 n L + (1 - 2q) x_s after |n| + |n - q| wall hits
    per_axis = []
    n_max = (max_order + 1) // 2 + 1
    for d in range(3):
        axis = []
        for n in range(-n_max, n_max + 1):
            for q in (0, 1):
                pos = 2.0 * n * room_dim[d] + (1 - 2 * q) * source[d]
                cnt = abs(n) + abs(n - q)
                if cnt <= max_order:
                    axis.append((pos, cnt))
        per_axis.append(axis)

    half = frac_taps // 2
    win = np.hanning(frac_taps)
    entries = []
    for px, cx in per_axis[0]:
        for py, cy in per_axis[1]:
            if cx + cy > max_order:
                continue
            for pz, cz in per_axis[2]:
                n_refl = cx + cy + cz
                if n_refl > max_order:
                    continue
                p = np.array([px, py, pz])
                dist = np.linalg.norm(p - mic)
                amp = beta**n_refl / (4.0 * np.pi * max(dist, 1e-2))
                delay = dist / C_SOUND * fs
                entries.append((delay, amp))

    if not entries:
        raise ValueError("no image sources")
    max_delay = max(d for d, _ in entries)
    ism_len = int(np.ceil(max_delay)) + frac_taps
    rir = np.zeros(ism_len)
    t_ax = np.arange(frac_taps) - half
    for delay, amp in entries:  # in the sum's order: it decides the bytes
        i0 = int(np.floor(delay))
        frac = delay - i0
        kernel = np.sinc(t_ax - frac) * win  # windowed-sinc fractional delay
        start = i0 - half
        lo, hi = max(start, 0), min(start + frac_taps, ism_len)
        rir[lo:hi] += amp * kernel[lo - start: hi - start]

    if t60_tail is not None and t60_tail > 0:
        rng = rng if rng is not None else np.random.default_rng(0)
        tail_len = int(t60_tail * fs)
        total_len = int(max_delay) + tail_len
        out = np.zeros(total_len)
        out[:ism_len] = rir
        t = np.arange(tail_len) / fs
        env = 10.0 ** (-3.0 * t / t60_tail)  # -60 dB at t60
        # the tail continues the image-source part's energy envelope
        ref = np.sqrt(np.mean(rir[-frac_taps * 4:] ** 2) + 1e-18)
        tail = rng.standard_normal(tail_len) * env * ref
        start = ism_len - frac_taps
        out[start: start + tail_len] += tail[: total_len - start]
        rir = out
    return rir


def simulate_shoebox(
    signal,
    room_dim,
    source,
    mic,
    t60: float,
    fs: int = 16000,
    max_order: Optional[int] = None,
    ray_tracing: bool = True,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Reverberate `signal` in a shoebox room of the target `t60`, the
    image-source order capped at 3 as the reference's ShoeBox is; returns
    (wet signal, rir)."""
    e_absorption, est_order = inverse_sabine(t60, room_dim)
    if max_order is None:
        max_order = min(3, est_order)
    rir = shoebox_rir(
        room_dim, source, mic, e_absorption, max_order, fs=fs,
        t60_tail=t60 if ray_tracing else None, rng=rng,
    )
    return fftconvolve(signal, rir)[: len(signal) + len(rir) - 1], rir


def simulate_dry(signal, room_dim, source, mic, fs: int = 16000) -> Tuple[np.ndarray, np.ndarray]:
    """The direct path alone (absorption 0.99, order 0): the dry target
    room of the dereverberation task; returns (signal through it, rir)."""
    rir = shoebox_rir(room_dim, source, mic, 0.99, 0, fs=fs)
    return fftconvolve(signal, rir)[: len(signal) + len(rir) - 1], rir


def measure_rt60(rir, fs: int = 16000, decay_db: float = 20.0) -> float:
    """RT60 by Schroeder backward integration, a -5..-(5 + decay_db) dB
    fit extrapolated to -60 dB; 0.0 when the decay does not reach it."""
    rir = np.asarray(rir, np.float64)
    energy = rir**2
    sch = np.cumsum(energy[::-1])[::-1]
    sch = sch / (sch[0] + 1e-30)
    sch_db = 10.0 * np.log10(sch + 1e-30)
    i5 = int(np.argmax(sch_db <= -5.0))
    i25 = int(np.argmax(sch_db <= -(5.0 + decay_db)))
    if i25 <= i5:
        return 0.0
    t5, t25 = i5 / fs, i25 / fs
    slope = -decay_db / (t25 - t5)  # dB per second
    return float(-60.0 / slope)
