"""The devices a server enhances on, and how they split into replicas and
sequence-parallel groups (counterpart of the meshes `BucketedEnhancer`
builds in storm_tpu/utils/inference.py:36-87).

`serving_devices` is the device set: by default every visible card
(`torch.cuda.device_count()`, which follows CUDA_VISIBLE_DEVICES) for a
model on a card, the model's own device otherwise; an explicit list
(`devices=["cpu"] * 8`, `["cuda:0"] * 4`) stands for it, the counterpart
of the reference tests' 8-device CPU mesh. A device may repeat: its
replicas and shards then share it.

`serving_grid` lays the set out as JAX lays out its mesh: with
`seq_parallel=k > 1`, `n_data = devices // k` rows of k devices when
`data_parallel` is set, else one row (k must divide the device count);
with `data_parallel` alone, one row per device. Each row is one replica of
the model, on the row's first device; a row of k > 1 devices shards that
replica's NCSN++ nets along the frame axis over its k devices.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

Group = Tuple[str, ...]  # one replica's devices, as strings: hashable, part of a program's key


def serving_devices(model_device: torch.device,
                    devices: Optional[Sequence] = None) -> List[torch.device]:
    """The device set (module docstring) of a model on `model_device`."""
    if devices is not None:
        out = [_indexed(torch.device(d)) for d in devices]
        if not out:
            raise ValueError("devices: an empty list")
        return out
    if model_device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [model_device]


def _indexed(d: torch.device) -> torch.device:
    """A card named with its index ("cuda" is the current card)."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def serving_grid(devices: Sequence[torch.device], data_parallel: bool,
                 seq_parallel: int) -> Optional[List[Group]]:
    """The replicas' device groups (module docstring), None for one device
    and neither mode. Raises ValueError when seq_parallel does not divide
    the device count (the reference's message)."""
    names = [str(torch.device(d)) for d in devices]
    if seq_parallel and seq_parallel > 1:
        if len(names) % seq_parallel:
            raise ValueError(f"seq_parallel={seq_parallel} must divide the device count "
                             f"({len(names)})")
        n_data = len(names) // seq_parallel if data_parallel else 1
        return [tuple(names[r * seq_parallel:(r + 1) * seq_parallel]) for r in range(n_data)]
    if data_parallel:
        return [(n,) for n in names]
    return None


def spans_cards(group: Optional[Sequence[str]]) -> bool:
    """True when a group holds more than one card: its work crosses devices."""
    return group is not None and len({d for d in group if d.startswith("cuda")}) > 1
