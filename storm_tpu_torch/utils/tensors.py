"""Broadcasting helpers (counterpart of storm_tpu/utils/tensors.py)."""
from __future__ import annotations

import torch


def batch_broadcast(a, x: torch.Tensor) -> torch.Tensor:
    """Reshape a scalar or per-batch vector `a` to (B, 1, ..., 1) for `x`."""
    a = torch.as_tensor(a, device=x.device)
    if a.ndim == 0:
        a = a.reshape(1)
    if a.ndim != 1:
        raise ValueError(f"Don't know how to batch-broadcast tensor with ndim {a.ndim}!")
    return a.reshape((a.shape[0],) + (1,) * (x.ndim - 1))


def right_pad_dims(a, x: torch.Tensor) -> torch.Tensor:
    """Append singleton dims to `a` until it has the rank of `x`."""
    a = torch.as_tensor(a, device=x.device)
    if a.ndim > x.ndim:
        raise ValueError(f"rank of a ({a.ndim}) exceeds rank of x ({x.ndim})")
    return a.reshape(a.shape + (1,) * (x.ndim - a.ndim))
