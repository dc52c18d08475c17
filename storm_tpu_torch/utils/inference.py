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
the pinned upload buffers and the outputs stay float32. A model of D > 1
spatial channels (`--spatial_channels`) takes (D, T) utterances and (B, D,
T) batches, as the reference's does; the D axis is part of a program's
shape.

Noise for every call comes from one `torch.Generator` owned by the caller
(or an injected noise source), drawn in order: chunk after chunk, each chunk
as its sampler draws it. The reference splits a PRNG key per chunk; the
noise of a batch depends on its row count in both.

Several devices (`data_parallel`, `seq_parallel`; `utils/devices.py`): the
device set is laid out as the reference lays out its mesh
(storm_tpu/utils/inference.py:36-87), one replica of the model per row of
the grid, on the row's first device, each chunk's rows split evenly over
the replicas (`minibatch` rounded up to a multiple of their count); a row
of k > 1 devices runs its replica's NCSN++ nets sharded along the frame
axis over them (`models.base.nets_sharded`). A chunk's noise is drawn once
from the one generator at the chunk's row count, in the sampler's order,
and each replica is handed its rows of every draw (`RowSplit`): every row
sees the draws of unsharded serving. The replicas on other devices are
copies of the model made when the enhancer is built. Each replica's calls
are its own captured programs on its own card; a group that spans cards
runs eagerly (`execution` says so: `utils/graphs.eager_reason`).
"""
from __future__ import annotations

import concurrent.futures
import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.base import spatial_channels
from ..nn.seqpar import replica
from ..sampling.samplers import NoiseSource, generator_noise
from ..signal.stft import stft_real
from .devices import serving_devices, serving_grid
from .graphs import eager_reason, graphed_enhance, programs_of, replay_noise_shapes
from .metrics import pesq_wb, si_sdr
from .stoi import stoi


class BucketedEnhancer:
    """Enhances (B, T) float32 waveforms of any length through
    `model.enhance`, padded to their bucket; (B, D, T) for a model of D > 1
    spatial channels.

    `minibatch`: enhance B rows in sequential chunks of this many rows, the
    last one row-padded with zeros to `minibatch`, so every call of a bucket
    has one shape (the reference's sgmse/model.py:210-222 chunking).
    `enhance_kwargs` go to `model.enhance` (N, sampler_type, predictor,
    corrector, corrector_steps, snr, method, rtol, atol, sweeps, quant,
    deepcache, deepcache_depth, batch_stats).
    `graphs`: every call replays its shape's captured program (on a CPU
    device: runs its body on the program's static buffers), except rk45,
    which runs eagerly; False calls `model.enhance` directly, the eager
    loop the programs are compared with.
    `data_parallel`: one replica per device, each chunk's rows split over
    them; `seq_parallel=k > 1`: k devices per replica, its NCSN++ nets
    sharded along the frame axis over them (with `data_parallel`, on
    devices // k replicas; else one); k must divide the device count, and
    may exceed a level's frames (its parts are then empty there:
    nn/seqpar.py).
    `devices`: the device set (`utils/devices.serving_devices`; by default
    every visible card, or the model's device on the CPU), e.g. ["cpu"] * 8.
    """

    def __init__(self, model, bucket_frames: int = 64, minibatch: Optional[int] = None,
                 data_parallel: bool = False, seq_parallel: int = 0, graphs: bool = True,
                 devices: Optional[Sequence] = None, **enhance_kwargs):
        self.model = model
        self.spatial_channels = spatial_channels(model)
        self.device = next(model.parameters()).device
        self.enhance_kwargs = enhance_kwargs
        self.bucket_samples = bucket_frames * model.stft_config.hop_length
        self.minibatch = minibatch
        self.graphs = graphs
        self.groups = serving_grid(serving_devices(self.device, devices), data_parallel,
                                   seq_parallel)
        self.replicas: List[Tuple[torch.nn.Module, Dict]] = []
        if self.groups is not None:
            n = len(self.groups)
            if self.minibatch is None:
                self.minibatch = n
            elif self.minibatch % n:  # the rows of a chunk split evenly over the replicas
                self.minibatch = -(-self.minibatch // n) * n
            copies = {self.device: model}
            for group in self.groups:
                home = torch.device(group[0])
                if home not in copies:
                    copies[home] = replica(model, home)
                kw = dict(enhance_kwargs)
                if kw.get("batch_stats") is not None:
                    kw["batch_stats"] = _moved(kw["batch_stats"], home)
                if len(group) > 1:
                    kw["shards"] = group
                self.replicas.append((copies[home], kw))

    @property
    def execution(self) -> str:
        """How calls run: "graph" (CPU: the programs' bodies, eagerly),
        "eager: <reason>" where a graph cannot serve (rk45, a sequence-parallel
        group across cards), or "eager"."""
        if not self.graphs:
            return "eager"
        reason = eager_reason(self.replicas[0][1] if self.replicas else self.enhance_kwargs)
        return f"eager: {reason}" if reason else "graph"

    @property
    def devices(self) -> List[str]:
        """The devices served on: every group's, in order (the model's alone
        without a grid)."""
        if self.groups is None:
            return [str(self.device)]
        return [d for group in self.groups for d in group]

    @property
    def graph_stats(self) -> dict:
        """The captured programs' counters (`utils/graphs.Programs.stats`),
        summed over the replicas' models."""
        models = {id(m): m for m, _ in self.replicas} or {id(self.model): self.model}
        stats: Dict = {}
        for m in models.values():
            for k, v in programs_of(m).stats.items():
                stats[k] = stats.get(k, 0) + v
        return stats

    def padded_len(self, T: int) -> int:
        """The bucketed input length of a T-sample waveform."""
        return -(-T // self.bucket_samples) * self.bucket_samples

    @property
    def supports_async(self) -> bool:
        """True when `enhance_async` is available: no minibatch chunking, and
        a sampler that enqueues without a sync (all but the ODE's rk45)."""
        kw = self.enhance_kwargs
        rk45 = kw.get("sampler_type", "pc") == "ode" and kw.get("method") == "rk45"
        return self.minibatch is None and not rk45 and self.groups is None

    def batched(self, y: np.ndarray) -> Tuple[np.ndarray, bool]:
        """(the waveforms as a batch (B, T) or (B, D, T), whether `y` was one
        utterance: (T,) or, for D > 1, (D, T)). A D > 1 batch with another
        channel count raises ValueError (the reference's)."""
        y = np.asarray(y, np.float32)
        D = self.spatial_channels
        single = y.ndim == (1 if D == 1 else 2)
        y = y[None] if single else y
        if y.ndim != (2 if D == 1 else 3) or (D > 1 and y.shape[1] != D):
            raise ValueError(f"expected {D} spatial channels, got shape {y.shape}")
        return y, single

    def _upload(self, y: np.ndarray) -> torch.Tensor:
        """(B, T) or (B, D, T) numpy -> tensor on the model's device,
        tail-padded to its bucket. To a card the copy goes from pinned memory
        without a host sync, so it queues behind the work already on the
        stream."""
        y = self.batched(y)[0]
        T = y.shape[-1]
        y = np.pad(y, [(0, 0)] * (y.ndim - 1) + [(0, self.padded_len(T) - T)])
        t = torch.from_numpy(y)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _enhance(self, y: torch.Tensor, generator, noise,
                 warm_up: bool = False) -> Tuple[torch.Tensor, int]:
        if self.groups is not None:
            return self._enhance_replicas(y, generator, noise, warm_up)
        if self.graphs:
            return graphed_enhance(self.model, y, generator, noise, warm_up=warm_up,
                                   **self.enhance_kwargs)
        return self.model.enhance(y, generator=generator, noise=noise, **self.enhance_kwargs)

    def _enhance_replicas(self, y: torch.Tensor, generator, noise,
                          warm_up: bool) -> Tuple[torch.Tensor, int]:
        """One chunk (`minibatch` rows) over the replicas, each given its
        rows and its rows of the chunk's noise; the output joined on the
        model's device. A copy between cards waits for the work queued
        before it on both (PyTorch's two-way barrier), so every row, and
        where the calls replay every draw, is copied before any replica's
        work is queued. Replicas of models of their own (one per card)
        then replay from threads of their own: a program of ~100k kernels
        fills the card's launch queue, and its launch returns only as the
        card drains it, so one thread would run the cards one after
        another. Other calls (a shape's first and second, eager ones) run
        the replicas in turn."""
        rows = y.shape[0] // len(self.replicas)
        homes = [next(model.parameters()).device for model, _ in self.replicas]
        parts = [(r * rows, (r + 1) * rows, home) for r, home in enumerate(homes)]
        split = RowSplit(noise if noise is not None else generator_noise(generator, self.device),
                         parts)
        ys = [y[lo:hi].to(home) for lo, hi, home in parts]

        def run(r: int):
            model, kw = self.replicas[r]
            with _on(homes[r]):
                if self.graphs:
                    return graphed_enhance(model, ys[r], None, split.part(r), warm_up=warm_up,
                                           **kw)
                return model.enhance(ys[r], noise=split.part(r), **kw)

        shapes = [replay_noise_shapes(m, y_r, kw) for (m, kw), y_r in zip(self.replicas, ys)]
        own_models = len({id(m) for m, _ in self.replicas}) == len(self.replicas)
        if own_models and len(self.replicas) > 1 and all(s is not None for s in shapes):
            split.predraw(shapes[0])
            with concurrent.futures.ThreadPoolExecutor(len(self.replicas)) as pool:
                results = [f.result() for f in [pool.submit(run, r)
                                                for r in range(len(self.replicas))]]
        else:
            results = [run(r) for r in range(len(self.replicas))]
        return torch.cat([out.to(self.device) for out, _ in results]), results[-1][1]

    def warm_up(self, y: np.ndarray, generator: Optional[torch.Generator] = None) -> None:
        """One call on (T,) or (B, T) float32 waveforms ((D, T) or (B, D, T)
        for D > 1) that also makes their
        shape's program (on a card: the eager loop, then the capture), so
        that the shape's next call replays; a server warms its row ladder so
        before traffic. B: the rows of one call (with `minibatch`, B =
        minibatch)."""
        x_hat, _ = self._enhance(self._upload(y), generator, None, warm_up=True)
        if x_hat.is_cuda:
            torch.cuda.current_stream(x_hat.device).synchronize()

    def enhance_async(self, y: np.ndarray, generator: Optional[torch.Generator] = None,
                      noise: Optional[NoiseSource] = None) -> Tuple[torch.Tensor, int]:
        """Enqueue one batched enhancement and return without waiting for it.

        `y`: float32 (B, T) or (B, D, T), its row count already what the
        caller wants computed. Returns (x_hat, nfe): x_hat (B, [D,] padded T) on the model's
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
        """Enhance (T,) or (B, T) float32 waveforms ((D, T) or (B, D, T) for
        D > 1); the output has the input's shape and length. Returns (x_hat,
        nfe), nfe summed over the minibatch chunks."""
        y, squeeze = self.batched(y)
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
                    chunk = torch.cat([chunk, chunk.new_zeros(
                        (self.minibatch - rows,) + tuple(chunk.shape[1:]))])
                xc, n = self._enhance(chunk, generator, noise)
                chunks.append(xc[:rows])
                nfe += n
            x_hat = torch.cat(chunks)
        x_hat = x_hat[..., :T].cpu().numpy()
        return (x_hat[0] if squeeze else x_hat), int(nfe)


class RowSplit:
    """A chunk's noise drawn once from `source` at the chunk's row count,
    each draw in the order the replicas' samplers ask for it, and replica
    r given its rows of it (`part(r)`). `parts`: each replica's (first row,
    end row, device). A draw's rows are copied to every replica's device
    when it is made (the first replica's program fills its noise before it
    runs: the copies then wait for no replica's work), and, while the
    replicas ask in turn, dropped once every replica has taken them."""

    def __init__(self, source: NoiseSource, parts: Sequence[Tuple[int, int, torch.device]]):
        self.source, self.parts = source, list(parts)
        self.draws: List[Optional[List[torch.Tensor]]] = []
        self.taken: List[int] = []
        self.frozen = False

    def _draw(self, shape) -> None:
        z = self.source((self.parts[-1][1],) + tuple(shape[1:]))
        self.draws.append([z[a:b].to(dev) for a, b, dev in self.parts])
        self.taken.append(0)

    def predraw(self, shapes) -> None:
        """Make every draw of the call now, in order (`shapes`: one
        replica's), and no more later: the replicas may then ask from
        threads of their own."""
        for shape in shapes:
            self._draw(shape)
        self.frozen = True

    def part(self, r: int) -> NoiseSource:
        lo, hi, _ = self.parts[r]
        used = [0]

        def draw(shape) -> torch.Tensor:
            j = used[0]
            used[0] += 1
            if j == len(self.draws) and not self.frozen:
                self._draw(shape)
            rows = self.draws[j][r] if j < len(self.draws) and self.draws[j] is not None else None
            if rows is None or tuple(rows.shape[:-1]) != tuple(shape):
                raise RuntimeError(f"replica rows {lo}:{hi} asked for draw {j} of shape "
                                   f"{tuple(shape)}, not the chunk's")
            if not self.frozen:  # the replicas ask in turn: drop what all have taken
                self.taken[j] += 1
                if self.taken[j] == len(self.parts):
                    self.draws[j] = None
            return rows

        return draw


def _moved(value, device: torch.device):
    """`value` (None, a tensor, or dicts of them: GaGNet's running
    statistics) with its tensors on `device`."""
    if isinstance(value, torch.Tensor):
        return value.to(device)
    if isinstance(value, dict):
        return {k: _moved(v, device) for k, v in value.items()}
    return value


def _on(device: torch.device):
    """The device's context for a card (graph capture and replay run on the
    current card), nothing for the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


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
    the first channel (a D > 1 model enhances each file's D channels).
    `enhance_kwargs` go to `model.enhance` (its defaults
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
    D = enhancer.spatial_channels
    xs = [x[0] for x, _ in items]  # the metrics take the first channel
    ys = [y if D > 1 else y[0] for _, y in items]
    groups: Dict[int, List[int]] = {}
    for i, y in enumerate(ys):
        groups.setdefault(enhancer.padded_len(y.shape[-1]), []).append(i)
    x_hats: List[Optional[np.ndarray]] = [None] * n
    for L, idxs in sorted(groups.items()):
        batch = np.stack([np.pad(ys[i], [(0, 0)] * (ys[i].ndim - 1)
                                 + [(0, L - ys[i].shape[-1])]) for i in idxs])
        x_hat, _ = enhancer(batch.astype(np.float32), generator=generator, noise=noise)
        for row, i in enumerate(idxs):
            out = x_hat[row, ..., : ys[i].shape[-1]]
            x_hats[i] = out[0] if D > 1 else out
    pesq_sum = si_sdr_sum = estoi_sum = 0.0
    spec_lists = ([], [], []) if spec else None
    audio_lists = ([], [], []) if audio else None
    for i, (x, y, x_hat) in enumerate(zip(xs, (y if y.ndim == 1 else y[0] for y in ys), x_hats)):
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
