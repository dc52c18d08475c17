"""The trainer's programs as captured CUDA graphs: one training step, and one
masked validation batch (the counterparts of train.py's jitted `prepare`,
`train_step` and `valid_masked_fn`, train.py:428-464, with the step of
storm_tpu/models/storm.py:364-389).

A step's body: the STFT of the wav batch (`models/base.wav_to_spec`; with
`return_time` the waveforms themselves, for a time-domain net), the
loss on the step's random inputs, its gradients, Adam's step and the EMA
(`EnhancementModel.step_on_device`), with no read of a device value and no
upload. A validation batch's: the STFT, each example's loss with the nets'
parameters (the EMA weights, which the trainer swaps in) cast once
(`cast_nets`), and their sum over the rows its mask keeps, on the device.
`TrainPrograms` keeps one program per key: the kind, the model's class and
plain settings (mode, losses, distillation's N, method and weight: every
scalar attribute of the model and of its SDE), whether it is in training
mode, the nets' dtypes, the batch's shapes and dtypes, the optimizer's
learning rates and the backend flags that choose the kernels (cuDNN's
determinism, TF32), which a replay cannot change.

A key's first call runs the eager step (or batch) and keeps nothing but
the key. Its second is the program's warm-up: one real step on a side
stream, on static inputs (a copy of the call's batch), with the call's own
random inputs drawn into static buffers; it builds what the first call left
lazy on that stream. Then the body is captured on the same stream, reading
those buffers; the capture executes nothing, so the call counts one step.
A later call copies its batch into the static inputs through pinned
staging buffers (refilled once their previous copy has left them), draws
its random inputs from its generator into the buffers in the body's order
(`draw_step`), replays the graph on the current stream and returns the
static outputs, which the program's next call overwrites: a caller that
keeps one clones it. Replay and eager run the same kernels on the same
numbers, so from the same generator state they give the same bits. A
step's host count advances by one per call.

The launch counters get each graph's recorded launches per replay. The
programs share one graph memory pool of their own (not the serving
programs' of utils/graphs.py): a step's activations stay in it for the run.
Every tensor a program reads in place (the parameters and buffers, the
EMA, Adam's state, the device step count, a distillation teacher's
weights) must keep its storage; `swapped_in` and `load_state_dict` copy in
place, and storage that moved drops every program: the next call makes
them anew. The capture is thread-local (`graphs.capture`): a checkpoint's
copy thread (`ckpt.AsyncCheckpointManager`), which may still run when the
second epoch captures the validation program, and the loader's threads
cannot break it. A capture that reads the device or uploads raises,
naming the op: nothing falls back to eager. `debug_nans` runs every step
eagerly under autograd's anomaly mode, which reads the device inside
backward, and `graphs=False` runs the eager step; `execution` says which.
On a CPU device there are no graphs: a program's later calls run its body
eagerly on the same static buffers.

Data-parallel training (a `world` of several processes, utils/distributed.py)
splits the step in two programs, each captured as above: "grads" (the STFT,
the loss on this process's rows of the global batch, its gradients, and
their copy with the detached losses into one flat float32 buffer outside
the pool) and "update" (the gradients set to views of that buffer, Adam and
the EMA). Between their replays the buffer is summed across the processes
in place (`distributed.all_reduce_`): a Gloo collective cannot be captured,
and the one design serves both backends. The random inputs of the whole
global batch are drawn from the step's generator on every process, which
keeps its own rows (`draw`), so that n processes at global batch B draw and
compute what one process does at B. Every process holds as many rows,
so the summed buffer of a "sum" loss (StoRM's) is the global one, and
that of a "mean" loss, divided by the process count, is the global
mean's. `stats` counts the all-reduces and their host seconds (on a card:
from the end of the "grads" program's work, Gloo's copies through the
host included).

A model with GaGNet's BN norms (`--norm_type BN`) takes their moments over
the global batch across processes, in its step's forward and backward and
in its validation batches (`backbones/gagnet.moments_across`, entered only
by those bodies: the evaluation, on process 0 alone, never calls a
collective). The validation batches are the loader's padded global rows,
as the reference's BN normalizes over them under its mesh; the mask only
zeroes their losses. Those collectives sit inside the programs' bodies,
where a Gloo collective cannot be captured, and NCCL's is not captured
either (its step would be one program: ROADMAP Queue 1 item 7), so such a
run's steps and validation batches run eagerly, and `execution` says why
("eager: BN moments across processes (gloo)"). The moments' backward sums
d/dmean and d/dvar over the processes, so each process's gradients are the
derivative of the sum of every process's loss on its rows, and the flat
buffer's sum (and, for a "mean" loss, its division by the process count)
counts each process's share of the moments' gradient once.

The training CLI and the bench run with PyTorch's expandable segments
(`use_expandable_segments`). With the allocator's default segments, a small
live block left in a large cached segment (cuBLAS's workspace, allocated
at its first call on a stream; a state made from a warm cache) holds the
whole segment, which a program's pool cannot reuse: on an H100, a
full-width float32 step (a pool of 41.8 GiB) reserved up to 78 GiB.
"""
from __future__ import annotations

import itertools
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..backbones.gagnet import batch_norms, moments_across
from ..kernels import LAUNCH_COUNTERS
from ..models.base import TrainState, wav_to_spec
from .distributed import World, all_reduce_
from .graphs import capture

Arrays = Sequence[np.ndarray]
Body = Callable[[List[torch.Tensor], Callable], Tuple[Dict[str, torch.Tensor], Tuple]]
ALLOC_CONF = "expandable_segments:True"


def use_expandable_segments() -> None:
    """Ask for PyTorch's expandable segments (module docstring) unless the
    caller set PYTORCH_CUDA_ALLOC_CONF; read when the process first
    allocates on the card, so an entry point calls this before it."""
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", ALLOC_CONF)


def settings(obj) -> Tuple:
    """The public scalar attributes of `obj` (a model, its SDE), sorted."""
    return tuple(sorted((k, v) for k, v in vars(obj).items()
                        if not k.startswith("_") and isinstance(v, (bool, int, float, str))))


class Program:
    """One training step or validation batch: static inputs (on a card with
    their pinned staging buffers), static random inputs, the graph (None on
    a CPU device), the static outputs, the spec batch whose shapes the
    draws follow, and the launches per replay."""

    def __init__(self, key: Tuple, arrays: Arrays, device: torch.device):
        self.key = key
        self.inputs = [torch.from_numpy(np.array(a)).to(device) for a in arrays]
        self.staging = ([torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                         for t in self.inputs] if device.type == "cuda" else [])
        self.copied: Optional[torch.cuda.Event] = None
        self.draws: List[torch.Tensor] = []
        self.spec: Tuple[torch.Tensor, ...] = ()
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Dict[str, torch.Tensor] = {}
        self.launches: Tuple[int, ...] = ()

    def fill(self, arrays: Arrays, draw: Callable,
             generator: Optional[torch.Generator]) -> None:
        """The call's batch into the static inputs, then its random inputs
        `draw(spec batch, generator)` into the static buffers, in the body's
        order."""
        if self.staging:
            if self.copied is not None:
                self.copied.synchronize()  # the previous copy has left the staging buffers
            for s, a in zip(self.staging, arrays):
                s.copy_(torch.from_numpy(np.asarray(a)))
            for t, s in zip(self.inputs, self.staging):
                t.copy_(s, non_blocking=True)
            self.copied = torch.cuda.Event()
            self.copied.record()
        else:
            for t, a in zip(self.inputs, arrays):
                t.copy_(torch.from_numpy(np.asarray(a)))
        if self.draws:
            for buf, z in zip(self.draws, draw(self.spec, generator)):
                buf.copy_(z)

    def static_bytes(self) -> int:
        """The device bytes of the static inputs and random inputs (outside the pool)."""
        return sum(t.numel() * t.element_size() for t in self.inputs + self.draws)


class TrainPrograms:
    """A training run's programs (module docstring): `step` and `validate`,
    each key's first call eager, its second the warm-up and the capture,
    later ones replays. `stats` counts first calls, captures, replays,
    eager calls, capture seconds, the pool's and the static buffers' bytes
    and invalidations, and holds the device's reserved bytes after the cache
    was emptied before the last warm-up and before the last capture (what
    the allocator could not give back)."""

    def __init__(self, state: TrainState, graphs: bool = True, debug_nans: bool = False,
                 return_time: bool = False, world: World = World()):
        self.state, self.model = state, state.model
        self.world = world
        self.params = [p for p in self.model.parameters() if p.requires_grad]
        # data parallel: the gradients and the losses, summed across processes
        self.flat: Optional[torch.Tensor] = None
        self.grad_views: List[torch.Tensor] = []
        self.losses: Dict[str, torch.Tensor] = {}
        self.return_time = return_time
        self.device = next(self.model.parameters()).device
        self.debug_nans = debug_nans
        # BN norms whose moments span every process's rows (module docstring)
        self.synced = batch_norms(self.model) if world.size > 1 else []
        self.eager_reason = ("debug_nans" if debug_nans else
                             f"BN moments across processes ({world.backend})"
                             if graphs and self.synced else None)
        self.graphs = graphs and self.eager_reason is None
        self.programs: Dict[Tuple, Program] = {}
        self.seen: Set[Tuple] = set()
        self.pool = None
        self.stream: Optional[torch.cuda.Stream] = None
        self.storage: Optional[Tuple[int, ...]] = None
        self.failed: List[torch.cuda.CUDAGraph] = []
        self.stats = {"first_calls": 0, "captures": 0, "replays": 0, "eager": 0,
                      "capture_s": 0.0, "pool_bytes": 0, "static_bytes": 0, "invalidated": 0,
                      "reserved_before_warm_up": 0, "reserved_before_capture": 0,
                      "allreduces": 0, "allreduce_s": 0.0}

    @property
    def execution(self) -> str:
        """How steps run: "graph" (on the CPU: the programs' bodies, eagerly),
        "eager: <reason>" where a program cannot serve (debug_nans, BN
        moments across processes), or "eager" (graphs=False)."""
        if self.graphs:
            return "graph"
        return f"eager: {self.eager_reason}" if self.eager_reason else "eager"

    def step(self, arrays: Arrays,
             generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        """One optimizer step on the wav batch `arrays` (clean, noisy: (B, T)
        numpy) with its random inputs from `generator`; the host's step count
        advances by one. Returns the detached losses: from the key's third
        call on, the program's static tensors (across processes: the global
        batch's losses, views of the summed buffer)."""
        if self.world.size > 1:
            out = self._step_across(arrays, generator)
        elif self.graphs:
            out = self._call("step", arrays, generator, self._step_body)
        else:
            self.stats["eager"] += 1
            with torch.autograd.set_detect_anomaly(self.debug_nans):
                out = self._step_body(self._upload(arrays), self._drawer(generator))[0]
        self.state.step += 1
        return out

    @torch.no_grad()
    def validate(self, arrays: Arrays, generator: Optional[torch.Generator]) -> torch.Tensor:
        """The sum of each example's loss over the rows of the wav batch
        `arrays` (clean, noisy: (B, T) numpy; then a (B,) bool mask of the
        rows that count), its random inputs from `generator`: a 0-d tensor
        on the device, from the key's third call on the program's static
        output. Across processes, this process's rows' sum; the caller sums
        over the processes."""
        if self.graphs:
            return self._call("valid", arrays, generator, self._valid_body)["sum"]
        self.stats["eager"] += 1
        return self._valid_body(self._upload(arrays), self._drawer(generator))[0]["sum"]

    # --- the bodies: (inputs, draw) -> (outputs, spec batch) -------------------

    def _specs(self, wavs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        if self.return_time:  # (B, T) waveforms, as train.py's return_time `prepare`
            return tuple(w.reshape(w.shape[0], -1) for w in wavs)
        with torch.no_grad():
            return tuple(wav_to_spec(w, self.model.stft_config, self.model.transform)
                         for w in wavs)

    def _step_body(self, inputs: List[torch.Tensor], draw: Callable):
        batch = self._specs(inputs[:2])
        return self.model.step_on_device(self.state, batch, *draw(batch)), batch

    def _valid_body(self, inputs: List[torch.Tensor], draw: Callable):
        batch = self._specs(inputs[:2])
        with self.model.cast_nets(), moments_across(self.synced, self.world):
            per_example = self.model.per_example_given(batch, *draw(batch))
        return {"sum": torch.where(inputs[2], per_example, 0.0).sum()}, batch

    def _grads_body(self, inputs: List[torch.Tensor], draw: Callable):
        batch = self._specs(inputs[:2])
        with moments_across(self.synced, self.world):
            aux = self.model.compute_gradients(batch, *draw(batch))
        if self.flat is None:  # made at the first (eager) call, outside any pool
            self._make_flat(aux)
        torch._foreach_copy_(self.grad_views + list(self.losses.values()),
                             [p.grad for p in self.params] + [aux[k] for k in self.losses])
        return {}, batch

    def _update_body(self, inputs: List[torch.Tensor], draw: Callable):
        for p, g in zip(self.params, self.grad_views):
            p.grad = g
        self.model.update(self.state)
        return {}, ()

    def _make_flat(self, aux: Dict[str, torch.Tensor]) -> None:
        sizes = [p.numel() for p in self.params] + [1] * len(aux)
        self.flat = torch.zeros(sum(sizes), dtype=torch.float32, device=self.device)
        views = [v.view(p.shape) for v, p in zip(self.flat.split(sizes), self.params)]
        self.grad_views = views
        tail = self.flat[sum(sizes[:len(self.params)]):]
        self.losses = {k: tail[i] for i, k in enumerate(aux)}

    def _step_across(self, arrays: Arrays,
                     generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        """The data-parallel step (module docstring): "grads", the sum of the
        buffer across the processes, "update"."""
        if self.graphs:
            self._call("grads", arrays, generator, self._grads_body)
        else:
            self.stats["eager"] += 1
            with torch.autograd.set_detect_anomaly(self.debug_nans):
                self._grads_body(self._upload(arrays), self._drawer(generator))
        if self.flat.is_cuda:  # so that allreduce_s times the sum alone
            torch.cuda.current_stream(self.device).synchronize()
        t0 = time.perf_counter()
        all_reduce_(self.flat, self.world)
        self.stats["allreduce_s"] += time.perf_counter() - t0
        self.stats["allreduces"] += 1
        if self.model.batch_reduction == "mean":
            self.flat.div_(self.world.size)
        if self.graphs:
            self._call("update", (), None, self._update_body)
        else:
            self._update_body([], None)
        return self.losses

    def draw(self, batch, generator: Optional[torch.Generator]) -> Tuple:
        """The model's random inputs for this process's rows of the batch:
        across processes, those of the global batch (this batch's rows x the
        process count) drawn whole and sliced to this process's rows."""
        n = self.world.size
        if n == 1:
            return self.model.draw_step(batch, generator)
        rows = batch[0].shape[0]
        whole = tuple(b.new_zeros(()).expand((rows * n,) + tuple(b.shape[1:])) for b in batch)
        lo = self.world.rank * rows
        return tuple(z[lo: lo + rows] for z in self.model.draw_step(whole, generator))

    def _drawer(self, generator: Optional[torch.Generator]) -> Callable:
        return lambda batch: self.draw(batch, generator)

    def _upload(self, arrays: Arrays) -> List[torch.Tensor]:
        return [torch.from_numpy(np.asarray(a)).to(self.device) for a in arrays]

    # --- programs --------------------------------------------------------------

    def _key(self, kind: str, arrays: Arrays) -> Tuple:
        m = self.model
        sde = getattr(m, "sde", None)
        return (kind, type(m).__name__, m.training,
                tuple(str(getattr(m, n).dtype) for n in m.NETS),
                tuple((np.shape(a), str(np.asarray(a).dtype)) for a in arrays),
                tuple(g["lr"] for g in self.state.optimizer.param_groups),
                (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32),
                settings(m), settings(sde) if sde is not None else (), self.return_time)

    def _check_storage(self) -> None:
        """Drop every program when a tensor the programs read in place has moved."""
        state, model = self.state, self.model
        teacher = getattr(model, "teacher_net", None)
        tensors = itertools.chain(
            model.parameters(), model.buffers(), state.ema.values(), (state.device_step,),
            (t for s in state.optimizer.state.values() for t in s.values() if torch.is_tensor(t)),
            teacher.parameters() if teacher is not None else ())
        ptrs = tuple(t.data_ptr() for t in tensors)
        if ptrs != self.storage:
            if self.programs:
                self.stats["invalidated"] += 1
                self.pool = None  # the dropped graphs release their pool: the next takes a new one
            self.programs.clear()
            self.storage = ptrs

    def _call(self, kind: str, arrays: Arrays, generator: Optional[torch.Generator],
              body: Body) -> Dict[str, torch.Tensor]:
        self._check_storage()
        key = self._key(kind, arrays)
        prog = self.programs.get(key)
        if prog is None and key not in self.seen:  # the first call: eager
            self.seen.add(key)
            self.stats["first_calls"] += 1
            return body(self._upload(arrays), self._drawer(generator))[0]
        if prog is None:
            prog, out = self._make(key, arrays, generator, body)
            self.programs[key] = prog
            return out
        prog.fill(arrays, self.draw, generator)
        self.stats["replays"] += 1
        if prog.graph is None:  # a CPU device: the body, eagerly, on the static buffers
            out, _ = body(prog.inputs, lambda batch: prog.draws)
            for k, v in out.items():
                prog.out[k].copy_(v)
        else:
            prog.graph.replay()
            for f, n in zip(LAUNCH_COUNTERS, prog.launches):
                f.launches += n
        return prog.out

    def _make(self, key: Tuple, arrays: Arrays, generator: Optional[torch.Generator],
              body: Body) -> Tuple[Program, Dict[str, torch.Tensor]]:
        """A key's second call: the warm-up (this call's step, eager, its
        random inputs kept as static buffers) and, on a card, the capture."""
        prog = Program(key, arrays, self.device)

        def recorded(batch):
            prog.spec = batch
            prog.draws = [z.clone(memory_format=torch.contiguous_format)
                          for z in self.draw(batch, generator)]
            return prog.draws

        if self.device.type != "cuda":
            out, _ = body(prog.inputs, recorded)
            prog.out = {k: v.clone() for k, v in out.items()}
        else:
            # the first call's blocks were cached for the caller's stream,
            # which the side stream's warm-up cannot reuse: give them back
            # (after the gradients that hold them) before it runs
            self._drop_gradients(key)
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            self.stats["reserved_before_warm_up"] = torch.cuda.memory_reserved(self.device)
            home = torch.cuda.current_stream(self.device)
            if self.stream is None:
                self.stream = torch.cuda.Stream(self.device)
            self.stream.wait_stream(home)
            with torch.cuda.stream(self.stream):
                out, _ = body(prog.inputs, recorded)
            home.wait_stream(self.stream)
            for t in [*out.values(), *prog.draws]:  # made on the side stream, used on the caller's
                t.record_stream(home)
            self._capture(prog, body)
        self.stats["static_bytes"] += prog.static_bytes()
        return prog, out

    def _drop_gradients(self, key: Tuple) -> None:
        """Before a step's warm-up or capture: the last step's gradients go,
        so that the allocator's cache they hold can be given back (a step
        sets new ones; a validation program leaves them)."""
        if key[0] in ("step", "grads"):
            self.model.zero_grad(set_to_none=True)

    def _capture(self, prog: Program, body: Body) -> None:
        self._drop_gradients(prog.key)
        # the capture can allocate new device memory but cannot free the
        # allocator's cached blocks (a step's pool holds tens of GiB): free
        # them first, with the pools of programs whose owners are gone
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        kind, model, _, dtypes, shapes = prog.key[:5]
        try:
            cap = capture(lambda: body(prog.inputs, lambda batch: prog.draws), self.stream,
                          self.pool, f"the {kind} program of {model} (nets {', '.join(dtypes)}, "
                                     f"batch {shapes})", self.failed)
        except RuntimeError:
            self.pool = None  # the next capture takes a new pool
            raise
        (prog.out, prog.spec), prog.graph, prog.launches = cap.result, cap.graph, cap.launches
        self.stats["captures"] += 1
        self.stats["capture_s"] += cap.seconds
        self.stats["pool_bytes"] += torch.cuda.memory_reserved(self.device) - cap.reserved
        self.stats["reserved_before_capture"] = cap.reserved
