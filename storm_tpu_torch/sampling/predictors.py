"""Predictor steps (counterpart of storm_tpu/sampling/predictors.py).

Each predictor is `step(rsde, x, t, y, noise) -> (x, x_mean)`, where
`noise(shape)` returns standard complex normal noise packed as shape + (2,).
"""
from __future__ import annotations

import math

import torch

from ..utils.tensors import right_pad_dims


def euler_maruyama(rsde, x, t, y, noise):
    """x <- x + f dt + g sqrt(-dt) z."""
    dt = -1.0 / rsde.N
    z = noise(x.shape[:-1])
    f, g = rsde.sde(x, t, y)
    x_mean = x + f * dt
    g = right_pad_dims(g * torch.ones(x.shape[0], dtype=x.dtype, device=x.device), x)
    return x_mean + g * math.sqrt(-dt) * z, x_mean


def reverse_diffusion(rsde, x, t, y, noise):
    """x <- x - f_rev + G z from the discretized reverse SDE."""
    f, G = rsde.discretize(x, t, y)
    z = noise(x.shape[:-1])
    x_mean = x - f
    return x_mean + G * z, x_mean


def none(rsde, x, t, y, noise):
    """No-op predictor (draws no noise)."""
    return x, x


PREDICTORS = {
    "euler_maruyama": euler_maruyama,
    "reverse_diffusion": reverse_diffusion,
    "none": none,
}
