"""Corrector steps (counterpart of storm_tpu/sampling/correctors.py).

Each corrector is `step(sde, score_fn, x, t, y, noise, snr, n_steps) ->
(x, x_mean)` and draws one noise sample per corrector step.
"""
from __future__ import annotations

import torch

from ..utils.tensors import right_pad_dims


def langevin(sde, score_fn, x, t, y, noise, snr, n_steps):
    """Langevin MCMC with the step size from the grad/noise norm ratio."""
    x_mean = x
    B = x.shape[0]
    for _ in range(n_steps):
        grad = score_fn(x, t, y)
        z = noise(x.shape[:-1])
        grad_norm = torch.linalg.norm(grad.reshape(B, -1), dim=-1).mean()
        noise_norm = torch.linalg.norm(z.reshape(B, -1), dim=-1).mean()
        step_size = (snr * noise_norm / grad_norm) ** 2 * 2
        x_mean = x + step_size * grad
        x = x_mean + z * torch.sqrt(step_size * 2)
    return x, x_mean


def ald(sde, score_fn, x, t, y, noise, snr, n_steps):
    """Annealed Langevin dynamics: step size (snr * std(t))^2 * 2."""
    x_mean = x
    std = right_pad_dims(sde._std(t), x)
    for _ in range(n_steps):
        grad = score_fn(x, t, y)
        z = noise(x.shape[:-1])
        step_size = (snr * std) ** 2 * 2
        x_mean = x + step_size * grad
        x = x_mean + z * torch.sqrt(step_size * 2)
    return x, x_mean


def none(sde, score_fn, x, t, y, noise, snr, n_steps):
    """No-op corrector (draws no noise)."""
    return x, x


CORRECTORS = {"langevin": langevin, "ald": ald, "none": none}
