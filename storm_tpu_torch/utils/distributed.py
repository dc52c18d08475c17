"""Data-parallel training across processes (counterpart of the root
train.py:220-245: `jax.distributed` from the STORM_TPU_* variables, and
`mh_barrier`).

Every process of a run is started with the same command and

    STORM_TPU_COORDINATOR=host:port  STORM_TPU_NUM_PROCESSES=n  STORM_TPU_PROCESS_ID=p

and `init_from_env` joins them in one `torch.distributed` process group
(`init_method="tcp://host:port"`; process 0 listens there). Without the
variables the run is one process and nothing here starts. `place` picks
each process's card and the backend from its index among the processes
of its host: LOCAL_RANK and LOCAL_WORLD_SIZE (torchrun's names) where
set, else the run's rank and size (one host). NCCL where each process of
the host has a card of its own (local index i on `cuda:i`), Gloo where
they share the host's cards (local index i on `cuda:i % cards`: NCCL
refuses two processes on one device) or run on the CPU.

`BatchMoments` is the collective of a BN's moments over the global batch
(GaGNet's `NormSwitch` while a training world is attached to it, as the
reference's BN under the trainer's data `Mesh` takes them).

The group's timeout is `TIMEOUT` (two hours, as `mh_barrier`'s): a process
that waits at a barrier or a collective while process 0 evaluates and
writes checkpoints does not give up. Gloo takes a card's tensors itself
(through pinned host memory, waiting for the current stream's work).
"""
from __future__ import annotations

import dataclasses
import os
from datetime import timedelta
from typing import Any, Iterable, Optional, Tuple

import torch
import torch.distributed as dist

ENV = ("STORM_TPU_COORDINATOR", "STORM_TPU_NUM_PROCESSES", "STORM_TPU_PROCESS_ID")
TIMEOUT = timedelta(hours=2)


@dataclasses.dataclass(frozen=True)
class World:
    """This process's place in the run: `rank` of `size`, the group's
    `backend` (None for one process) and the device it trains on."""

    rank: int = 0
    size: int = 1
    backend: Optional[str] = None
    device: Optional[torch.device] = None

    @property
    def is_main(self) -> bool:
        """Process 0: the one that logs, evaluates and writes checkpoints."""
        return self.rank == 0

    @property
    def shard(self) -> Tuple[int, int]:
        """(index, count) for the loader's `shard`."""
        return self.rank, self.size

    def barrier(self) -> None:
        """Wait for every process (no-op for one)."""
        if self.size > 1:
            if self.backend == "nccl":
                dist.barrier(device_ids=[self.device.index])
            else:
                dist.barrier()

    def agree(self, obj: Any) -> Any:
        """Process 0's `obj` on every process, after a barrier: what process 0
        alone decides or computes (a resumed run's loop state, the epoch's
        evaluation) becomes every process's."""
        if self.size == 1:
            return obj
        self.barrier()
        box = [obj]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def close(self, barrier: bool = True) -> None:
        """Leave the group, after a last barrier (so that no process exits
        while another still waits on it) unless this process failed."""
        if self.size > 1:
            if barrier:
                self.barrier()
            dist.destroy_process_group()


def place(device: torch.device, rank: int, size: int, cards: int,
          local: Optional[Tuple[int, int]] = None) -> Tuple[str, torch.device]:
    """(backend, device) of process `rank` of `size` (module docstring):
    `device` is the trainer's `--device`, `cards` the host's card count and
    `local` this process's (index, count) among the processes of its host
    (default: (rank, size)). A device that names its card, the CPU and a
    host without cards take Gloo on `device` as given."""
    if device.type != "cuda" or device.index is not None or cards == 0:
        return "gloo", device
    index, count = local if local is not None else (rank, size)
    if count <= cards:
        return "nccl", torch.device("cuda", index)
    return "gloo", torch.device("cuda", index % cards)


def init_from_env(device: str) -> World:
    """Join the process group the STORM_TPU_* variables describe (module
    docstring) and return this process's World; one process without them.
    `device` is the trainer's `--device`."""
    coordinator = os.environ.get(ENV[0])
    dev = torch.device(device)
    if not coordinator:
        return World(device=dev)
    size, rank = int(os.environ[ENV[1]]), int(os.environ[ENV[2]])
    if not 0 <= rank < size:
        raise SystemExit(f"{ENV[2]}={rank} outside 0..{size - 1}")
    local = None
    if "LOCAL_RANK" in os.environ:
        local = (int(os.environ["LOCAL_RANK"]),
                 int(os.environ.get("LOCAL_WORLD_SIZE", size)))
    cards = torch.cuda.device_count() if dev.type == "cuda" and torch.cuda.is_available() else 0
    backend, dev = place(dev, rank, size, cards, local)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}", world_size=size,
                            rank=rank, timeout=TIMEOUT)
    return World(rank, size, backend, dev)


def all_reduce_(t: torch.Tensor, world: World) -> torch.Tensor:
    """Sum `t` over the processes, in place (one collective)."""
    if world.size > 1:
        dist.all_reduce(t)
    return t


class BatchMoments(torch.autograd.Function):
    """(mean, var) of x over `axes` (the batch and spatial axes of a BN) and
    over every process's x, in float32, keeping x's dims: the two-pass form
    of one process's moments on the global batch. Forward: the count and
    the sum all-reduced (one collective), then the sum of squares about
    their mean (another). Backward, the synchronized-BN rule: the two
    per-channel gradients, d/dmean and d/dvar, are summed over the
    processes (one collective), so that each process's input gradient,
    (g_mean + 2 g_var (x - mean)) / count, is the derivative of the sum of
    every process's loss. The count travels as a float32, exact below 2^24
    elements a channel."""

    @staticmethod
    def forward(ctx, x, axes: Tuple[int, ...], world: World):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        total = xf.sum(dim=axes, keepdim=True)
        local = xf.numel() // total.numel()
        if local * world.size >= 2 ** 24:
            raise ValueError(f"BN over {local * world.size} elements a channel: the float32 "
                             "count would round")
        summed = all_reduce_(torch.cat([total.flatten(), total.new_full((1,), float(local))]),
                             world)
        count = summed[-1]
        mean = (summed[:-1] / count).reshape(total.shape)
        var = all_reduce_(torch.square(xf - mean).sum(dim=axes, keepdim=True), world) / count
        ctx.save_for_backward(x, mean, count)
        ctx.world = world
        return mean, var

    @staticmethod
    def backward(ctx, g_mean, g_var):
        x, mean, count = ctx.saved_tensors
        grads = [torch.zeros_like(mean) if g is None else g for g in (g_mean, g_var)]
        summed = all_reduce_(torch.cat([g.flatten() for g in grads]), ctx.world)
        g_mean, g_var = (g.reshape(mean.shape) for g in summed.split(mean.numel()))
        xf = x.to(mean.dtype)
        return ((g_mean + 2.0 * g_var * (xf - mean)) / count).to(x.dtype), None, None


def broadcast_(tensors: Iterable[torch.Tensor], world: World) -> None:
    """Process 0's values of `tensors` on every process, in place."""
    if world.size > 1:
        for t in tensors:
            dist.broadcast(t, src=0)
