"""Length-bucketed enhancement and the in-training evaluation (counterpart
of `BucketedEnhancer` and `evaluate_model` in storm_tpu/utils/inference.py).

Every waveform is zero-padded at its tail to a multiple of `bucket_frames`
hops before it reaches the model, exactly as the reference pads it for its
compile cache; the model then pads the spectrogram's frame axis to a
multiple of 64 as well. So a file of T samples meets NCSN++ at the width the
reference computes (a 4 s file at hop 128: 65536 samples, 576 frames), and
its output, cut back to T samples, is the reference's.

The reference compiles one program per bucket and row count; here, on a
CUDA device, each call is the replay of one captured CUDA graph per bucket,
row count and configuration (`utils/graphs.graphed_enhance`), bit for bit
the eager call's. A shape's first call runs the eager loop, its second
warms up and captures, later calls replay (`warm_up` captures at once);
`graphs=False` runs the eager loop, to compare.

The model computes in its own dtype (`model.enhance` casts); the waveforms,
the pinned upload buffers and the outputs stay float32.

Noise for every call comes from one `torch.Generator` owned by the caller
(or an injected noise source), drawn in order: chunk after chunk, each chunk
as its sampler draws it. The reference splits a PRNG key per chunk; the
noise of a batch depends on its row count in both.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..sampling.samplers import NoiseSource
from ..signal.stft import stft_real
from .graphs import eager_reason, graphed_enhance, programs_of
from .metrics import pesq_wb, si_sdr
from .stoi import stoi


class BucketedEnhancer:
    """Enhances (B, T) float32 waveforms of any length through
    `model.enhance`, padded to their bucket.

    `minibatch`: enhance B rows in sequential chunks of this many rows, the
    last one row-padded with zeros to `minibatch`, so every call of a bucket
    has one shape (the reference's sgmse/model.py:210-222 chunking).
    `enhance_kwargs` go to `model.enhance` (N, sampler_type, predictor,
    corrector, corrector_steps, snr, method, rtol, atol, sweeps, quant,
    deepcache, deepcache_depth).
    `graphs`: every call replays its shape's captured program (on a CPU
    device: runs its body on the program's static buffers), except rk45,
    which runs eagerly; False calls `model.enhance` directly, the eager
    loop the programs are compared with.
    """

    def __init__(self, model, bucket_frames: int = 64, minibatch: Optional[int] = None,
                 data_parallel: bool = False, seq_parallel: int = 0, graphs: bool = True,
                 **enhance_kwargs):
        if data_parallel or (seq_parallel and seq_parallel > 1):
            raise NotImplementedError(
                "data_parallel / seq_parallel serving over several GPUs is not ported yet "
                "(ROADMAP R7)")
        self.model = model
        self.device = next(model.parameters()).device
        self.enhance_kwargs = enhance_kwargs
        self.bucket_samples = bucket_frames * model.stft_config.hop_length
        self.minibatch = minibatch
        self.graphs = graphs

    @property
    def execution(self) -> str:
        """How calls run: "graph" (CPU: the programs' bodies, eagerly),
        "eager: rk45" where a graph cannot serve, or "eager"."""
        if not self.graphs:
            return "eager"
        reason = eager_reason(self.enhance_kwargs)
        return f"eager: {reason}" if reason else "graph"

    @property
    def graph_stats(self) -> dict:
        """The model's captured programs' counters (`utils/graphs.Programs.stats`)."""
        return dict(programs_of(self.model).stats)

    def padded_len(self, T: int) -> int:
        """The bucketed input length of a T-sample waveform."""
        return -(-T // self.bucket_samples) * self.bucket_samples

    @property
    def supports_async(self) -> bool:
        """True when `enhance_async` is available: no minibatch chunking, and
        a sampler that enqueues without a sync (all but the ODE's rk45)."""
        kw = self.enhance_kwargs
        rk45 = kw.get("sampler_type", "pc") == "ode" and kw.get("method") == "rk45"
        return self.minibatch is None and not rk45

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

    def _enhance(self, y: torch.Tensor, generator, noise,
                 warm_up: bool = False) -> Tuple[torch.Tensor, int]:
        if self.graphs:
            return graphed_enhance(self.model, y, generator, noise, warm_up=warm_up,
                                   **self.enhance_kwargs)
        return self.model.enhance(y, generator=generator, noise=noise, **self.enhance_kwargs)

    def warm_up(self, y: np.ndarray, generator: Optional[torch.Generator] = None) -> None:
        """One call on (T,) or (B, T) float32 waveforms that also makes their
        shape's program (on a card: the eager loop, then the capture), so
        that the shape's next call replays; a server warms its row ladder so
        before traffic. B: the rows of one call (with `minibatch`, B =
        minibatch)."""
        y = np.atleast_2d(np.asarray(y, np.float32))
        x_hat, _ = self._enhance(self._upload(y), generator, None, warm_up=True)
        if x_hat.is_cuda:
            torch.cuda.current_stream(x_hat.device).synchronize()

    def enhance_async(self, y: np.ndarray, generator: Optional[torch.Generator] = None,
                      noise: Optional[NoiseSource] = None) -> Tuple[torch.Tensor, int]:
        """Enqueue one batched enhancement and return without waiting for it.

        `y`: float32 (B, T), its row count already what the caller wants
        computed. Returns (x_hat, nfe): x_hat (B, padded T) on the model's
        device, still being computed on its current stream; the caller
        finalizes on that stream (an event recorded after it, or a copy to
        the host) and keeps x_hat alive until then. x_hat is the caller's
        own: a later call of the same shape does not overwrite it. The host
        returns once it has enqueued one graph replay (the eager loop:
        every forward of the sampler)."""
        if not self.supports_async:
            raise NotImplementedError(
                "enhance_async requires minibatch=None and a sampler that enqueues without "
                "a sync: not the ODE's rk45, whose step controller reads the device after "
                "every step")
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


MAX_VIS_SAMPLES = 10


def evaluate_model(model, valid_set, num_eval_files: int, noise: Optional[NoiseSource] = None,
                   spec: bool = False, audio: bool = False, sr: int = 16000,
                   minibatch: Optional[int] = 8, **enhance_kwargs):
    """Enhance the first `num_eval_files` raw validation pairs
    (`valid_set.__getitem__(i, raw=True)`) with the weights `model` holds
    and return their mean wide-band PESQ, SI-SDR and ESTOI
    (sgmse/util/inference.py:20-71), as (pesq, si_sdr, estoi, spec lists,
    audio lists).

    As in the reference, the files are grouped by their bucket's length
    (shortest bucket first) and each group goes through one
    `BucketedEnhancer` call in chunks of `minibatch` rows; the metrics take
    the first channel. `enhance_kwargs` go to `model.enhance` (its defaults
    are the reference's: N=30, reverse diffusion, no corrector). Noise comes
    from `noise` if given (tests replay the reference's), else from a
    generator seeded with 0 on every call, as the reference takes
    PRNGKey(0) per call: two calls on the same weights enhance with the same
    noise. The model's captured programs outlive the call: the trainer's
    next evaluation replays them with the weights swapped in then.

    With `spec`, the spectrogram lists for the logger: ([noisy], [enhanced],
    [clean]) packed-real STFTs (F, frames, 2) as numpy arrays, of the first
    MAX_VIS_SAMPLES files; with `audio`, their waveforms in the same order;
    None otherwise. PESQ is NaN without the `pesq` package (`pesq_wb`)."""
    generator = torch.Generator(device=next(model.parameters()).device).manual_seed(0)
    enhancer = BucketedEnhancer(model, minibatch=minibatch, **enhance_kwargs)
    n = min(num_eval_files, len(valid_set))
    items = [valid_set.__getitem__(i, raw=True) for i in range(n)]
    xs = [x[0] for x, _ in items]  # the metrics take the first channel
    ys = [y[0] for _, y in items]
    groups: Dict[int, List[int]] = {}
    for i, y in enumerate(ys):
        groups.setdefault(enhancer.padded_len(y.shape[-1]), []).append(i)
    x_hats: List[Optional[np.ndarray]] = [None] * n
    for L, idxs in sorted(groups.items()):
        batch = np.stack([np.pad(ys[i], (0, L - ys[i].shape[-1])) for i in idxs])
        x_hat, _ = enhancer(batch.astype(np.float32), generator=generator, noise=noise)
        for row, i in enumerate(idxs):
            x_hats[i] = x_hat[row, : ys[i].shape[-1]]
    pesq_sum = si_sdr_sum = estoi_sum = 0.0
    spec_lists = ([], [], []) if spec else None
    audio_lists = ([], [], []) if audio else None
    for i, (x, y, x_hat) in enumerate(zip(xs, ys, x_hats)):
        si_sdr_sum += si_sdr(x, x_hat)
        pesq_sum += pesq_wb(sr, x, x_hat)
        estoi_sum += stoi(x, x_hat, sr, extended=True)
        if spec and i < MAX_VIS_SAMPLES:
            for out, w in zip(spec_lists, (y, x_hat, x)):
                out.append(stft_real(torch.from_numpy(np.asarray(w, np.float32)),
                                     model.stft_config).numpy())
        if audio and i < MAX_VIS_SAMPLES:
            for out, w in zip(audio_lists, (y, x_hat, x)):
                out.append(w)
    return (pesq_sum / n, si_sdr_sum / n, estoi_sum / n,
            list(spec_lists) if spec else None, list(audio_lists) if audio else None)
