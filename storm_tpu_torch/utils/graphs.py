"""Each serving call as one captured CUDA graph per shape and configuration
(the counterpart of the reference's jitted `make_enhance`,
storm_tpu/models/storm.py:393-449, and of `BucketedEnhancer`'s per-bucket
program cache, storm_tpu/utils/inference.py:133).

A model's `enhance` with an injected noise source is the program's body: the
per-utterance normalisation, the STFT, the nets' casts and int8 weight
quantization, the denoiser, every sampler step (the step schedule, the
deep-feature cache's refreshes and the Picard sweeps are fixed on the host
by N and the step index) and the iSTFT, with no read of a device value and
no upload. `graphed_enhance` keeps one `Program` per key: the input's shape
and dtype, the nets' dtypes, and every keyword that changes the program (N,
sampler and method, corrector and its steps, snr, deepcache and its depth,
sweeps, the int8 scales by value).

A shape's first call runs the eager loop on the caller's stream and keeps
nothing but its key: a shape met once (a one-off file length) costs what
the eager loop costs. Its second call is the program's warm-up: the body
runs eagerly on a side stream on the program's static input (a copy of the
call's waveform) with the call's own noise, each draw kept as a static
buffer; its output is this call's answer. The warm-up builds the kernels,
sets their launch attributes and makes the host constants
(`utils/tensors.host_constant`) and the library handles on the side stream;
then the body is captured on the same stream with `torch.cuda.graph`,
reading those buffers. A later call copies its waveform into the static
input, draws its noise from its generator (or injected source) into the
buffers in the body's order (the prior, then per step the corrector's and
the predictor's draws), replays the graph on the current stream and returns
a copy of the static output, which the next replay of the same program
overwrites. Replay and eager run the same kernels on the same numbers, so
from the same generator state they give the same bits.

The capture raises, naming the op that broke it, if the body reads the
device or uploads from pageable memory: no call falls back to eager. The
one exception is the ODE's rk45, whose step controller reads the error norm
after every attempted step; `graphed_enhance` runs it eagerly and counts it
under "eager".

The kernels' wrappers count their launches in Python, and a replay runs no
Python: each program records the launches its capture made (the capture
itself launches nothing, so the counters are set back), and every replay
adds them. All the programs of a model share one graph memory pool (which
holds their static outputs), since they replay one at a time on one stream;
each program keeps its static input and noise buffers outside the pool
(`stats`: "pool_bytes" and "static_bytes"). The nets' casts and int8 weight
codes are recomputed by every replay from the live parameters, so weights
swapped in place (`models/base.swapped_in`, `load_state_dict`) are served at
the next call. Parameters that moved to new storage drop every program of
the model: the next call captures anew.

On a CPU device there are no graphs: a program's later calls run the body
eagerly on the same static buffers.
"""
from __future__ import annotations

import gc
import itertools
import time
import weakref
from typing import Callable, Dict, List, Optional, Set, Tuple

import torch

from ..kernels import LAUNCH_COUNTERS
from ..sampling import samplers
from ..sampling.samplers import NoiseSource


def eager_reason(kw: Dict) -> Optional[str]:
    """Why a call with these `enhance` keywords cannot be captured, or None."""
    if kw.get("sampler_type") == "ode" and kw.get("method") == "rk45":
        return "rk45"
    return None


def _freeze(v):
    """A hashable, order-free copy of a keyword value (dicts of scales)."""
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    return v


def program_key(model, y: torch.Tensor, kw: Dict) -> Tuple:
    """Everything that changes the captured program of `model.enhance(y, **kw)`:
    also the backend flags that choose its kernels (cuDNN's determinism,
    TF32), which a replay cannot change."""
    dtypes = tuple(str(getattr(getattr(model, n), "dtype", None)) for n in model.NETS)
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    return (tuple(y.shape), str(y.dtype), str(y.device), dtypes, model.training, flags,
            _freeze(kw))


def _launch_counts() -> List[int]:
    return [f.launches for f in LAUNCH_COUNTERS]


class _Recorder:
    """The first run's noise source: each draw of the call's source, kept
    (as a copy the source does not own) as the program's static buffer."""

    def __init__(self, source: NoiseSource):
        self.source, self.buffers = source, []

    def __call__(self, shape) -> torch.Tensor:
        z = self.source(tuple(shape)).clone(memory_format=torch.contiguous_format)
        self.buffers.append(z)
        return z


class _Replay:
    """The captured body's noise source: the static buffers in order."""

    def __init__(self, buffers: List[torch.Tensor]):
        self.buffers, self.used = buffers, 0

    def __call__(self, shape) -> torch.Tensor:
        if (self.used >= len(self.buffers)
                or tuple(self.buffers[self.used].shape[:-1]) != tuple(shape)):
            raise RuntimeError("enhance drew other noise than in its program's first run")
        self.used += 1
        return self.buffers[self.used - 1]


class Program:
    """One captured enhancement: static input and noise buffers, the graph
    (None on a CPU device), its static output, NFE and launches per replay."""

    def __init__(self, key: Tuple, y: torch.Tensor):
        self.key = key
        self.y = y.clone()  # the static input, outside the graph's pool
        self.noise: List[torch.Tensor] = []
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Optional[torch.Tensor] = None
        self.nfe = 0
        self.launches: Tuple[int, ...] = ()

    def fill(self, y: torch.Tensor, source: NoiseSource) -> None:
        """The call's waveform and noise into the static buffers, in the body's order."""
        self.y.copy_(y)
        for buf in self.noise:
            buf.copy_(source(tuple(buf.shape[:-1])))

    def body(self, model, kw: Dict) -> Tuple[torch.Tensor, int]:
        return model.enhance(self.y, noise=_Replay(self.noise), **kw)

    def static_bytes(self) -> int:
        """The bytes of the static input and noise buffers (outside the pool)."""
        return sum(t.numel() * t.element_size() for t in [self.y] + self.noise)

    def replay(self) -> torch.Tensor:
        """Run the captured graph on the current stream; a copy of its output."""
        self.graph.replay()
        for f, n in zip(LAUNCH_COUNTERS, self.launches):
            f.launches += n
        return self.out.clone()


class Programs:
    """A model's captured programs, the keys called once, their shared graph
    pool and side stream, and counters: first calls (eager), captures,
    replays, eager calls (rk45), capture seconds, the pool's bytes, the
    static buffers' bytes, invalidations."""

    def __init__(self):
        self.programs: Dict[Tuple, Program] = {}
        self.seen: Set[Tuple] = set()
        self.pool = None
        self.stream: Optional[torch.cuda.Stream] = None
        self.param_ptrs: Optional[Tuple[int, ...]] = None
        self.failed: List[torch.cuda.CUDAGraph] = []
        self.stats = {"first_calls": 0, "captures": 0, "replays": 0, "eager": 0,
                      "capture_s": 0.0, "pool_bytes": 0, "static_bytes": 0, "invalidated": 0}

    def check_storage(self, model) -> None:
        """Drop every program when a parameter or buffer has moved."""
        ptrs = tuple(t.data_ptr() for t in itertools.chain(model.parameters(), model.buffers()))
        if ptrs != self.param_ptrs:
            if self.programs:
                self.stats["invalidated"] += 1
                # the dropped graphs release their pool, which the allocators
                # then refuse to capture into: the next capture takes a new one
                self.pool = None
            self.programs.clear()
            self.param_ptrs = ptrs

    def make(self, model, key: Tuple, y: torch.Tensor, source: NoiseSource,
             kw: Dict) -> Tuple[Program, torch.Tensor]:
        """A shape's second call (or a warm-up call): the warm-up (this
        call's answer, eager, its noise kept) and, on a CUDA device, the
        capture."""
        prog = Program(key, y)
        rec = _Recorder(source)
        if y.is_cuda:
            home = torch.cuda.current_stream(y.device)
            if self.stream is None:
                self.stream = torch.cuda.Stream(y.device)
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            self.stream.wait_stream(home)
            with torch.cuda.stream(self.stream):
                out, prog.nfe = model.enhance(prog.y, noise=rec, **kw)
            home.wait_stream(self.stream)
            for t in [out] + rec.buffers:  # made on the side stream, used on the caller's
                t.record_stream(home)
            prog.noise = rec.buffers
            self.capture(model, prog, kw)
        else:
            out, prog.nfe = model.enhance(prog.y, noise=rec, **kw)
            prog.noise = rec.buffers
        self.stats["static_bytes"] += prog.static_bytes()
        return prog, out

    def capture(self, model, prog: Program, kw: Dict) -> None:
        """Capture the body on the side stream into the shared pool (the
        pool's growth is read from the reserved bytes)."""
        device = prog.y.device
        torch.cuda.synchronize(device)
        # the capture can allocate new device memory but cannot free the
        # allocator's cached blocks: free them first (with the pools of
        # programs whose models are gone, which go with the model's last
        # reference)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        before = _launch_counts()
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        failure: Optional[BaseException] = None
        collecting = gc.isenabled()
        gc.disable()  # the body's tensors go by reference count; a collection only stalls it
        try:
            with torch.cuda.stream(self.stream):
                graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
                try:
                    prog.out, _ = prog.body(model, kw)
                except BaseException as e:
                    failure = e
                finally:
                    try:
                        graph.capture_end()
                    except BaseException as e:
                        failure = failure or e
        finally:
            if collecting:
                gc.enable()
            after = _launch_counts()
            for f, n in zip(LAUNCH_COUNTERS, before):  # the capture launched nothing
                f.launches = n
        if failure is not None:
            # the failed graph is kept, never released: if its capture did not
            # end, the allocators may still count it as recording into its
            # pool; if it ended, releasing it could leave the pool released by
            # all its graphs, which the allocators refuse to capture into.
            # The next capture takes a new pool either way.
            self.failed.append(graph)
            self.pool = None
            raise RuntimeError(
                f"CUDA graph capture of enhance{describe(prog.key)} failed, with no eager "
                f"fallback: {type(failure).__name__}: {failure}") from failure
        prog.launches = tuple(a - b for a, b in zip(after, before))
        prog.graph = graph
        self.stats["captures"] += 1
        self.stats["capture_s"] += time.perf_counter() - t0
        self.stats["pool_bytes"] += torch.cuda.memory_reserved(device) - reserved


def describe(key: Tuple) -> str:
    """A program's key, readable: (rows, width) and its keywords."""
    shape, dtype, device, dtypes, _, _, kw = key
    return f"(y {shape} {dtype} on {device}, nets {', '.join(dtypes)}, {dict(kw)})"


_PROGRAMS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def programs_of(model) -> Programs:
    """`model`'s programs (made at first use, dropped with the model)."""
    progs = _PROGRAMS.get(model)
    if progs is None:
        progs = _PROGRAMS[model] = Programs()
    return progs


@torch.inference_mode()
def graphed_enhance(model, y: torch.Tensor, generator: Optional[torch.Generator] = None,
                    noise: Optional[NoiseSource] = None, warm_up: bool = False,
                    **kw) -> Tuple[torch.Tensor, int]:
    """`model.enhance(y, generator=generator, noise=noise, **kw)` as the
    replay of its captured program (module docstring); the same bits as
    the eager call from the same generator state. `warm_up`: make the
    program at this call even if it is the shape's first (a caller that
    knows the shape recurs, as a server's warm-up or a bench). Returns
    (x_hat, nfe), x_hat a tensor of the caller's, queued on the current
    stream."""
    progs = programs_of(model)
    if eager_reason(kw):
        progs.stats["eager"] += 1
        return model.enhance(y, generator=generator, noise=noise, **kw)
    progs.check_storage(model)
    key = program_key(model, y, kw)
    prog = progs.programs.get(key)
    first = key not in progs.seen
    progs.seen.add(key)  # a program dropped with moved parameters is made at the next call
    if prog is None and first and not warm_up:  # a shape met once costs the eager loop
        progs.stats["first_calls"] += 1
        return model.enhance(y, generator=generator, noise=noise, **kw)
    source: Callable = (noise if noise is not None
                        else samplers.generator_noise(generator, y.device))
    if prog is None:
        prog, out = progs.make(model, key, y, source, kw)
        progs.programs[key] = prog
        return out, prog.nfe
    prog.fill(y, source)
    progs.stats["replays"] += 1
    if prog.graph is None:  # a CPU device: the body, eagerly, on the static buffers
        return prog.body(model, kw)[0], prog.nfe
    return prog.replay(), prog.nfe
