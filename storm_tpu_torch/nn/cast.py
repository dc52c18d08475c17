"""The compute dtype of a layer: its parameters in that dtype, and Python
scalars rounded to it (counterpart of flax's `dtype=` / `param_dtype=`).

Parameters stay float32, as the reference's `param_dtype=jnp.float32`. A
layer whose reference casts them to the compute dtype (flax's Conv and
Dense with `dtype=`, NIN's `W.astype(x.dtype)`) names them in its
`CAST_PARAMS` and reads them through `param`, in the dtype of its input.
`cast_params(net, dtype)` makes those copies once, for the length of a
`with` block, as XLA hoists the reference's casts out of its jitted sampler;
outside one, `param` casts on every call (calibration, tests). GroupNorm's
scale and bias are not cast: flax normalizes in float32.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Iterator, Optional

import torch
from torch import nn


@functools.lru_cache(maxsize=None)
def scalar(value: float, dtype: torch.dtype) -> float:
    """`value` rounded to `dtype`, as a Python float. JAX casts a Python
    scalar to the array's type before the op (weak typing), so x / sqrt(2)
    divides a bfloat16 x by bfloat16(sqrt(2)); PyTorch would keep the scalar
    in float32."""
    return torch.tensor(value, dtype=dtype).item()


def param(module: nn.Module, name: str, dtype: torch.dtype) -> Optional[torch.Tensor]:
    """`module`'s parameter `name` in `dtype`: itself, the copy made by an
    active `cast_params`, or a cast made now."""
    p = getattr(module, name)
    if p is None or p.dtype == dtype:
        return p
    cached = module.__dict__.get("_cast", {}).get(name)
    if cached is not None and cached.dtype == dtype:
        return cached
    return p.to(dtype)


@contextlib.contextmanager
def cast_params(net: nn.Module, dtype: torch.dtype) -> Iterator[nn.Module]:
    """While active, every module of `net` with `CAST_PARAMS` holds copies of
    those parameters in `dtype` (none for float32), detached: for inference."""
    modules = [m for m in net.modules() if getattr(m, "CAST_PARAMS", ())]
    try:
        if dtype != torch.float32:
            for m in modules:
                m._cast = {n: getattr(m, n).detach().to(dtype) for n in m.CAST_PARAMS
                           if getattr(m, n) is not None}
        yield net
    finally:
        for m in modules:
            m.__dict__.pop("_cast", None)
