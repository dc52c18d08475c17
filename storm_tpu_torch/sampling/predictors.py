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


def etd(rsde, x, t, y, noise):
    """Exponential-integrator reverse-SDE step: the OUVE reverse drift
    splits as theta (y - x) - g^2 score; the linear part is integrated
    exactly over the step (exponential Euler), the score term held constant,
    and diffusion noise added with the Euler-Maruyama magnitude. Needs an
    SDE with a constant linear drift coefficient (`theta`)."""
    fwd = rsde.forward
    if not hasattr(fwd, "theta"):
        raise ValueError("etd predictor requires an OUVE-style SDE")
    theta = fwd.theta
    dt = -1.0 / rsde.N
    a = -theta
    ea = math.exp(a * dt)
    phi1 = (ea - 1.0) / a

    _, g = fwd.sde(x, t, y)
    g2 = right_pad_dims(g ** 2, x)
    n_term = theta * y - g2 * rsde.score_fn(x, t, y)  # the reverse drift's part constant in x
    x_mean = ea * x + phi1 * n_term
    z = noise(x.shape[:-1])
    gp = right_pad_dims(g * torch.ones(x.shape[0], dtype=x.dtype, device=x.device), x)
    return x_mean + gp * math.sqrt(-dt) * z, x_mean


def none(rsde, x, t, y, noise):
    """No-op predictor (draws no noise)."""
    return x, x


PREDICTORS = {
    "euler_maruyama": euler_maruyama,
    "reverse_diffusion": reverse_diffusion,
    "etd": etd,
    "none": none,
}
