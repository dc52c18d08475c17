"""Dynamic batching over the bucketed enhancer, and the HTTP payload codec
(counterpart of storm_tpu/utils/server.py).

Concurrent enhance requests wait in one age-ordered queue. A dispatch takes
the oldest request and fills the batch around it: requests of its own length
bucket first, shorter ones next (they pad up), longer ones last (they raise
the batch's padded length). A partial batch is row-padded to the smallest
allowed row count that holds it (1, 2, 4, ..., max_batch by default), so a
lone request runs one row, not max_batch. A batch leaves when max_batch
requests are pending or the oldest has waited `max_wait_ms`.

One dispatcher thread owns the device and the noise generator: callers block
on an event and touch no torch state, so the noise served for a given seed
depends only on the sequence of batches. When the enhancer supports
`enhance_async`, the dispatcher enqueues a batch's work and the copy of its
output to pinned host memory, records an event after them, and goes on to
form the next batch; a finalizer thread waits on each event in order and
delivers the responses. On a card `enhance_async` returns once it has
enqueued one replay of the batch's captured graph, so up to
`pipeline_depth` whole batches are queued on the device while the next
forms; each batch's output is a tensor of its own (the enhancer copies the
graph's static output, which the next replay of that shape overwrites). In
the eager loop the host returns only after enqueueing every forward of the
sampler, so that overlaps each batch's tail and its delivery with the next.
"""
from __future__ import annotations

import io
import queue
import threading
import time
from typing import List, Optional

import numpy as np
import torch


class _Request:
    __slots__ = ("y", "event", "result", "error", "t_enqueue")

    def __init__(self, y: np.ndarray):
        self.y = y
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.t_enqueue = time.monotonic()


def _default_row_sizes(max_batch: int) -> List[int]:
    sizes, r = [], 1
    while r < max_batch:
        sizes.append(r)
        r *= 2
    sizes.append(max_batch)
    return sizes


def _start_host_copy(x):
    """Queue the copy of a batch's device output to pinned host memory on the
    current stream, with an event after it; returns (host tensor, event).
    Anything else (a host array, or a stand-in whose conversion waits)
    passes through as (x, None)."""
    if isinstance(x, torch.Tensor) and x.is_cuda:
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done
    return x, None


class DynamicBatcher:
    """Coalesce concurrent enhance calls into dynamic batches.

    `enhancer` has `padded_len(T)` and `__call__(ys, generator) -> (x_hats,
    nfe)`, and for the pipelined path `supports_async` and
    `enhance_async(ys, generator) -> (x_hats, nfe)`. `row_sizes` are the
    allowed batch row counts (default 1, 2, 4, ..., max_batch);
    `pipeline_depth` bounds the batches in flight on the pipelined path.
    `build_server` always takes the pipelined path; the synchronous one stays
    for enhancers without `enhance_async` (a `minibatch` enhancer, the
    reference's synchronous batcher cases) and for `pipeline_depth` 1.
    """

    def __init__(self, enhancer, generator: Optional[torch.Generator] = None,
                 max_batch: int = 8, max_wait_ms: float = 100.0,
                 row_sizes: Optional[List[int]] = None, pipeline_depth: int = 2):
        self.enhancer = enhancer
        self.max_batch = max(1, int(max_batch))
        self.max_wait_s = max_wait_ms / 1e3
        self.row_sizes = sorted(set(
            int(r) for r in (row_sizes or _default_row_sizes(self.max_batch))
            if 1 <= int(r) <= self.max_batch)) or [self.max_batch]
        self._generator = generator
        self._device = getattr(enhancer, "device", None)
        self._pending: List[_Request] = []
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._closed = False
        self.stats = {
            "requests": 0, "batches": 0, "batched_requests": 0,
            "row_slots": 0, "audio_samples": 0, "device_s": 0.0,
            "errors": 0,
        }
        self._async = pipeline_depth > 1 and getattr(enhancer, "supports_async", False)
        if self._async:
            self._inflight = threading.Semaphore(pipeline_depth)
            self._completions: "queue.Queue" = queue.Queue()
            self._finalizer = threading.Thread(target=self._finalize_loop, daemon=True,
                                               name="storm-finalizer")
            self._finalizer.start()
        self._worker = threading.Thread(target=self._run, daemon=True, name="storm-batcher")
        self._worker.start()

    # -- caller side ------------------------------------------------------

    def submit(self, y: np.ndarray, timeout: Optional[float] = None):
        """Enhance one (T,) float32 waveform; blocks until its batch is
        served. Returns (x_hat, nfe), x_hat of the input's length."""
        y = np.asarray(y, np.float32)
        req = _Request(y)
        with self._lock:
            if self._closed:
                raise RuntimeError("batcher is closed")
            self.stats["requests"] += 1
            self._pending.append(req)
            self._wake.notify()
        if not req.event.wait(timeout):
            raise TimeoutError("enhance request timed out")
        if req.error is not None:
            raise req.error
        return req.result

    def close(self):
        """Serve what is queued, then stop the threads."""
        with self._lock:
            self._closed = True
            self._wake.notify()
        self._worker.join(timeout=60)
        if self._async:
            self._completions.put(None)  # after every dispatch is queued
            self._finalizer.join(timeout=60)

    # -- dispatcher side --------------------------------------------------

    def _pick_locked(self) -> Optional[List[_Request]]:
        """Pop the batch to serve now, or None if nothing is due yet."""
        if not self._pending:
            return None
        age = time.monotonic() - self._pending[0].t_enqueue
        if len(self._pending) < self.max_batch and age < self.max_wait_s and not self._closed:
            return None  # linger for a fuller batch
        head = self._pending[0]
        head_bucket = self.enhancer.padded_len(head.y.shape[-1])

        def fill_rank(r: _Request):
            b = self.enhancer.padded_len(r.y.shape[-1])
            return (0 if b == head_bucket else (1 if b < head_bucket else 2), r.t_enqueue)

        rest = sorted(self._pending[1:], key=fill_rank)
        take = [head] + rest[: self.max_batch - 1]
        taken = set(map(id, take))
        self._pending = [r for r in self._pending if id(r) not in taken]
        return take

    def _next_deadline_locked(self) -> Optional[float]:
        if not self._pending:
            return None
        return max(0.0, self._pending[0].t_enqueue + self.max_wait_s - time.monotonic())

    def _run(self):
        if self._device is not None and self._device.type == "cuda":
            torch.cuda.set_device(self._device)  # a new thread starts on device 0
        while True:
            with self._lock:
                batch = self._pick_locked()
                while batch is None:
                    if self._closed and not self._pending:
                        return
                    self._wake.wait(timeout=self._next_deadline_locked())
                    batch = self._pick_locked()
            try:
                padded = self.enhancer.padded_len(max(r.y.shape[-1] for r in batch))
                rows = next(r for r in self.row_sizes if r >= len(batch))
                ys = np.zeros((rows, padded), np.float32)  # pad rows and tails with zeros
                for i, r in enumerate(batch):
                    ys[i, : r.y.shape[-1]] = r.y
                t0 = time.monotonic()
                if self._async:
                    self._inflight.acquire()  # bound the queued device work
                    try:
                        x_dev, nfe = self.enhancer.enhance_async(ys, self._generator)
                        host, done = _start_host_copy(x_dev)
                        # x_dev stays referenced until the finalizer has waited
                        self._completions.put((batch, rows, x_dev, host, done, nfe, t0))
                    except BaseException:
                        self._inflight.release()
                        raise
                    continue
                x_hats, nfe = self.enhancer(ys, self._generator)
                self._deliver(batch, rows, np.asarray(x_hats), int(nfe), t0)
            except Exception as e:  # every waiter of the batch hears of it
                self._fail(batch, e)

    def _deliver(self, batch, rows, x_hats, nfe, t0):
        dt = time.monotonic() - t0
        with self._lock:
            self.stats["batches"] += 1
            self.stats["batched_requests"] += len(batch)
            self.stats["row_slots"] += rows
            self.stats["device_s"] += dt
            self.stats["audio_samples"] += sum(r.y.shape[-1] for r in batch)
        for r, x_hat in zip(batch, x_hats[: len(batch)]):
            r.result = (x_hat[..., : r.y.shape[-1]], nfe)
            r.event.set()

    def _fail(self, batch, e: BaseException):
        with self._lock:
            self.stats["errors"] += len(batch)
        for r in batch:
            r.error = e
            r.event.set()

    def _finalize_loop(self):
        """Wait for each in-flight batch in order and deliver its responses
        while the dispatcher keeps the device fed."""
        while True:
            item = self._completions.get()
            if item is None:
                return
            batch, rows, _x_dev, host, done, nfe, t0 = item
            try:
                if done is not None:
                    done.synchronize()
                self._deliver(batch, rows, np.asarray(host), int(nfe), t0)
            except Exception as e:
                self._fail(batch, e)
            finally:
                self._inflight.release()


# -- WAV bytes codec (HTTP payloads) --------------------------------------

_INT_SCALES = {
    np.dtype(np.int16): 1 << 15,
    np.dtype(np.int32): 1 << 31,
    np.dtype(np.uint8): 1 << 7,
}


def decode_wav_bytes(body: bytes) -> tuple[np.ndarray, int]:
    """WAV bytes -> (float32 (C, T) in [-1, 1], sample rate)."""
    from scipy.io import wavfile

    sr, data = wavfile.read(io.BytesIO(body))
    if data.dtype in _INT_SCALES:
        scale = _INT_SCALES[data.dtype]
        if data.dtype == np.dtype(np.uint8):
            data = data.astype(np.float32) - 128.0
        data = np.asarray(data, np.float32) / scale
    else:
        data = np.asarray(data, np.float32)
    data = data[None, :] if data.ndim == 1 else data.T
    return np.ascontiguousarray(data), int(sr)


def encode_wav_bytes(data: np.ndarray, sr: int = 16000) -> bytes:
    """float32 (T,) or (C, T) in [-1, 1] -> 16-bit PCM WAV bytes."""
    from scipy.io import wavfile

    data = np.asarray(data, np.float32)
    if data.ndim == 2:
        data = data.T
    buf = io.BytesIO()
    wavfile.write(buf, sr, (np.clip(data, -1.0, 1.0) * 32767.0).astype(np.int16))
    return buf.getvalue()
