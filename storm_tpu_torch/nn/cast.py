"""The compute dtype of a layer: its parameters in that dtype, and Python
scalars rounded to it (counterpart of flax's `dtype=` / `param_dtype=`).

Parameters stay float32, as the reference's `param_dtype=jnp.float32`. A
layer whose reference casts them to the compute dtype (flax's Conv and
Dense with `dtype=`, NIN's `W.astype(x.dtype)`) names them in its
`CAST_PARAMS` and reads them through `param`, in the dtype of its input.
`cast_params(net, dtype)` makes those copies once, for the length of a
`with` block, as XLA hoists the reference's casts out of its jitted sampler;
the copies are detached, so it is for inference only. A captured
enhancement (`utils/graphs.py`) makes them inside its graph, so every replay
recasts the parameters as they are then. Outside one, `param`
casts on every call with `.to(dtype)`, which autograd differentiates: a
training forward in bfloat16 sends its gradients through the cast to the
float32 parameters, as flax's cast does. A forward that records gradients
for a parameter while a `cast_params` copy of it is active raises
RuntimeError instead of training nothing. GroupNorm's scale and bias are not
cast: flax normalizes in float32.
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
    active `cast_params` (raises RuntimeError if autograd would need the
    parameter's gradient), or a cast made now, differentiable."""
    p = getattr(module, name)
    if p is None or p.dtype == dtype:
        return p
    cached = module.__dict__.get("_cast", {}).get(name)
    if cached is not None and cached.dtype == dtype:
        if p.requires_grad and torch.is_grad_enabled():
            raise RuntimeError(
                f"{type(module).__name__}.{name}: a forward with gradients inside cast_params, "
                "whose copies are detached; train outside it, or run under torch.no_grad()")
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
