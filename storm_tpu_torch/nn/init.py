"""Weight initialisers with explicit generators (counterpart of storm_tpu/nn/init.py)."""
from __future__ import annotations

import math
from typing import Optional

import torch


def ddpm_init_(w: torch.Tensor, fan_in: int, fan_out: int, scale: float = 1.0,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """DDPM init: fan_avg uniform variance scaling; scale 0 is clamped to 1e-10."""
    scale = 1e-10 if scale == 0 else scale
    limit = math.sqrt(3.0 * scale / ((fan_in + fan_out) / 2.0))
    with torch.no_grad():
        return w.uniform_(-limit, limit, generator=generator)


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Truncated normal (+-2 std) with variance 1/fan_in, flax's Conv default."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return torch.nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                           generator=generator)


def reset_parameters(module: torch.nn.Module,
                     generator: Optional[torch.Generator] = None) -> torch.nn.Module:
    """Re-draw every parameter of `module` from `generator`, module by module."""
    for m in module.modules():
        if hasattr(m, "init_from"):
            m.init_from(generator)
        elif isinstance(m, torch.nn.GroupNorm):
            torch.nn.init.ones_(m.weight)
            torch.nn.init.zeros_(m.bias)
    return module
