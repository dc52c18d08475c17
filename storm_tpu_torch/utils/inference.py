"""Length-bucketed enhancement (counterpart of `BucketedEnhancer` in
storm_tpu/utils/inference.py).

Every waveform is zero-padded at its tail to a multiple of `bucket_frames`
hops before it reaches the model, exactly as the reference pads it for its
compile cache; the model then pads the spectrogram's frame axis to a
multiple of 64 as well. So a file of T samples meets NCSN++ at the width the
reference computes (a 4 s file at hop 128: 65536 samples, 576 frames), and
its output, cut back to T samples, is the reference's. There is no compile
cache here: the bucket fixes the shapes, and with them the cuDNN plans and
allocator blocks that later calls of the same bucket reuse.

The model computes in its own dtype (`model.enhance` casts); the waveforms,
the pinned upload buffers and the outputs stay float32.

Noise for every call comes from one `torch.Generator` owned by the caller
(or an injected noise source), drawn in order: chunk after chunk, each chunk
as `pc_sample` draws it. The reference splits a PRNG key per chunk; the
noise of a batch depends on its row count in both.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..sampling.samplers import NoiseSource


class BucketedEnhancer:
    """Enhances (B, T) float32 waveforms of any length through
    `model.enhance`, padded to their bucket.

    `minibatch`: enhance B rows in sequential chunks of this many rows, the
    last one row-padded with zeros to `minibatch`, so every call of a bucket
    has one shape (the reference's sgmse/model.py:210-222 chunking).
    `enhance_kwargs` go to `model.enhance` (N, predictor, corrector,
    corrector_steps, snr, quant).
    """

    def __init__(self, model, bucket_frames: int = 64, minibatch: Optional[int] = None,
                 data_parallel: bool = False, seq_parallel: int = 0, **enhance_kwargs):
        if data_parallel or (seq_parallel and seq_parallel > 1):
            raise NotImplementedError(
                "data_parallel / seq_parallel serving over several GPUs is not ported yet "
                "(ROADMAP R7)")
        self.model = model
        self.device = next(model.parameters()).device
        self.enhance_kwargs = enhance_kwargs
        self.bucket_samples = bucket_frames * model.stft_config.hop_length
        self.minibatch = minibatch

    def padded_len(self, T: int) -> int:
        """The bucketed input length of a T-sample waveform."""
        return -(-T // self.bucket_samples) * self.bucket_samples

    @property
    def supports_async(self) -> bool:
        """True when `enhance_async` is available (no minibatch chunking)."""
        return self.minibatch is None

    def _upload(self, y: np.ndarray) -> torch.Tensor:
        """(B, T) numpy -> tensor on the model's device, tail-padded to its
        bucket. To a card the copy goes from pinned memory without a host
        sync, so it queues behind the work already on the stream."""
        if y.ndim == 3:
            raise NotImplementedError("multichannel (B, D, T) input is not ported yet "
                                      "(ROADMAP R7)")
        if y.ndim != 2:
            raise ValueError(f"expected (B, T) waveforms, got shape {y.shape}")
        T = y.shape[-1]
        y = np.pad(np.asarray(y, np.float32), [(0, 0), (0, self.padded_len(T) - T)])
        t = torch.from_numpy(y)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _enhance(self, y: torch.Tensor, generator, noise) -> Tuple[torch.Tensor, int]:
        return self.model.enhance(y, generator=generator, noise=noise, **self.enhance_kwargs)

    def enhance_async(self, y: np.ndarray, generator: Optional[torch.Generator] = None,
                      noise: Optional[NoiseSource] = None) -> Tuple[torch.Tensor, int]:
        """Enqueue one batched enhancement and return without waiting for it.

        `y`: float32 (B, T), its row count already what the caller wants
        computed. Returns (x_hat, nfe): x_hat (B, padded T) on the model's
        device, still being computed on its current stream; the caller
        finalizes on that stream (an event recorded after it, or a copy to
        the host) and keeps x_hat alive until then. The host returns once
        it has enqueued every forward of the sampler."""
        if not self.supports_async:
            raise NotImplementedError("enhance_async requires minibatch=None")
        return self._enhance(self._upload(y), generator, noise)

    def __call__(self, y: np.ndarray, generator: Optional[torch.Generator] = None,
                 noise: Optional[NoiseSource] = None) -> Tuple[np.ndarray, int]:
        """Enhance (T,) or (B, T) float32 waveforms; the output has the
        input's shape and length. Returns (x_hat, nfe), nfe summed over the
        minibatch chunks."""
        y = np.asarray(y, np.float32)
        squeeze = y.ndim == 1
        y = np.atleast_2d(y)
        T = y.shape[-1]
        y_dev = self._upload(y)
        if self.minibatch is None:
            x_hat, nfe = self._enhance(y_dev, generator, noise)
        else:
            chunks, nfe = [], 0
            for i in range(0, y_dev.shape[0], self.minibatch):
                chunk = y_dev[i: i + self.minibatch]
                rows = chunk.shape[0]
                if rows < self.minibatch:  # one shape per bucket, ragged tails too
                    chunk = torch.cat([chunk, chunk.new_zeros(self.minibatch - rows,
                                                              chunk.shape[-1])])
                xc, n = self._enhance(chunk, generator, noise)
                chunks.append(xc[:rows])
                nfe += n
            x_hat = torch.cat(chunks)
        x_hat = x_hat[..., :T].cpu().numpy()
        return (x_hat[0] if squeeze else x_hat), int(nfe)
