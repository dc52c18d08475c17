"""Amplitude compression and time padding (counterpart of storm_tpu/signal/transforms.py)."""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from . import cplx


@dataclasses.dataclass(frozen=True)
class SpecTransform:
    """`s -> |s|^e * exp(j*angle(s)) * factor` and its inverse, packed-real."""

    factor: float = 0.15
    abs_exponent: float = 0.5

    @staticmethod
    def _rescale(p: torch.Tensor, power: float) -> torch.Tensor:
        # |s|^(2*power) as a magnitude gain, with a safe zero (0 stays 0)
        mag2 = cplx.abs2(p)
        gain = torch.where(mag2 > 0, mag2.pow(power), torch.zeros_like(mag2))
        return p * gain[..., None]

    def forward_packed(self, p: torch.Tensor) -> torch.Tensor:
        e = self.abs_exponent
        if e != 1:
            p = self._rescale(p, (e - 1.0) / 2.0)
        return p * self.factor

    def backward_packed(self, p: torch.Tensor) -> torch.Tensor:
        p = p / self.factor
        e = self.abs_exponent
        if e != 1:
            p = self._rescale(p, (1.0 / e - 1.0) / 2.0)
        return p


def pad_spec_amount(t: int, multiple: int = 64) -> int:
    return 0 if t % multiple == 0 else multiple - t % multiple


def pad_spec(Y: torch.Tensor, multiple: int = 64, axis: int = -1) -> torch.Tensor:
    """Zero-pad `axis` to a multiple of `multiple` (axis=-2 for packed specs)."""
    axis = axis % Y.ndim
    num_pad = pad_spec_amount(Y.shape[axis], multiple)
    if num_pad == 0:
        return Y
    # F.pad lists (left, right) pairs from the last axis backwards
    pads = [0, 0] * (Y.ndim - 1 - axis) + [0, num_pad]
    return F.pad(Y, pads)
