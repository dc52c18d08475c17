"""Fixed-memory streaming enhancement for long recordings (counterpart of
storm_tpu/utils/streaming.py).

`stream_enhance` cuts a long waveform into overlapping chunks of one length
(rounded up to the enhancer's bucket), enhances them `max_batch` at a time
through a `BucketedEnhancer`, and overlap-adds the results with a linear
sum-to-one crossfade. Device memory grows with the chunk length and the
batch, not with the recording; every call has the same shape. Each chunk is
normalised on its own (the whole-utterance path normalises per utterance). A (D, T) recording of a
D-channel model is cut along its time axis, its channels together.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..sampling.samplers import NoiseSource


def crossfade_ramp(n: int) -> np.ndarray:
    """Linear fade-in of n samples whose reverse sums with it to one."""
    return ((np.arange(n) + 0.5) / n).astype(np.float32)


def stream_enhance(enhancer, y: np.ndarray, generator: Optional[torch.Generator] = None,
                   chunk_samples: int = 65536, overlap_samples: int = 8192,
                   max_batch: int = 16,
                   noise: Optional[NoiseSource] = None) -> Tuple[np.ndarray, int]:
    """Enhance a (T,) waveform, or (D, T) for a model of D > 1 channels, in
    crossfaded fixed-length chunks.

    `chunk_samples` is rounded up to the enhancer's bucket; consecutive
    chunks overlap by `overlap_samples`. Chunks are enhanced `max_batch` per
    call, in order, with noise from `generator` (or `noise`). Returns
    (x_hat of y's shape, nfe summed over the calls)."""
    y = np.asarray(y, np.float32)
    T = y.shape[-1]
    chunk_samples = enhancer.padded_len(int(chunk_samples))
    overlap_samples = int(overlap_samples)
    if not 0 <= overlap_samples < chunk_samples:
        raise ValueError("need 0 <= overlap_samples < chunk_samples")
    if T <= chunk_samples:
        return enhancer(y, generator, noise)

    hop = chunk_samples - overlap_samples
    starts = list(range(0, T - overlap_samples, hop))
    chunks = [np.pad(y[..., s: s + chunk_samples],
                     [(0, 0)] * (y.ndim - 1) + [(0, max(0, s + chunk_samples - T))])
              for s in starts]
    outs, nfe_total = [], 0
    for i in range(0, len(chunks), max_batch):
        xb, nfe = enhancer(np.stack(chunks[i: i + max_batch]), generator, noise)
        outs.append(xb)
        nfe_total += int(nfe)
    outs = np.concatenate(outs, axis=0)

    x_hat = np.zeros_like(y)
    ramp = crossfade_ramp(overlap_samples) if overlap_samples else None
    for j, s in enumerate(starts):
        seg = outs[j][..., : min(chunk_samples, T - s)]
        n = seg.shape[-1]
        w = np.ones(n, np.float32)
        if overlap_samples:
            if j > 0:  # fade in against the previous chunk's tail
                m = min(overlap_samples, n)
                w[:m] = ramp[:m]
            if j + 1 < len(starts):  # fade out under the next chunk's head
                w[n - overlap_samples:] = ramp[::-1]
        x_hat[..., s: s + n] += seg * w
    return x_hat, nfe_total
