"""Broadcasting helpers (counterpart of storm_tpu/utils/tensors.py) and
the device constants a captured program reads."""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

_CONSTANTS: Dict[Tuple, torch.Tensor] = {}


def host_constant(make: Callable[..., np.ndarray], args: Tuple, device,
                  dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """`make(*args)`, a numpy array, as a tensor on `device` in `dtype`:
    uploaded once per (make, args, device, dtype) and kept. An upload from
    pageable memory while a CUDA stream captures a graph is illegal, so a
    captured program reads the constants its eager warm-up made. `make` is
    a pure function of its hashable `args`; the tensor is read-only and
    records no inference-mode state."""
    key = (make, args, torch.device(device), dtype)
    t = _CONSTANTS.get(key)
    if t is None:
        with torch.inference_mode(False):
            t = torch.from_numpy(np.ascontiguousarray(make(*args))).to(device=device,
                                                                         dtype=dtype)
        _CONSTANTS[key] = t
    return t


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
