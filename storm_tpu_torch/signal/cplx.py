"""Packed-real complex arithmetic (counterpart of storm_tpu/signal/cplx.py).

Spectrograms are real tensors with a trailing (real, imag) axis of size 2,
the layout the reference package uses on its device path, so both packages
can be compared element for element.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


def abs2(p: torch.Tensor) -> torch.Tensor:
    """|z|^2, shape (...)."""
    return p[..., 0] ** 2 + p[..., 1] ** 2


def cabs(p: torch.Tensor) -> torch.Tensor:
    """|z|, shape (...)."""
    return torch.sqrt(abs2(p))


def complex_normal(shape: Sequence[int], generator: Optional[torch.Generator] = None,
                   device=None, dtype=torch.float32) -> torch.Tensor:
    """Standard complex normal as packed (..., 2): Re/Im each N(0, 1/2)."""
    z = torch.randn(tuple(shape) + (2,), generator=generator, device=device,
                    dtype=dtype)
    return z / math.sqrt(2.0)
