"""Predictor-corrector sampling (counterpart of `pc_sample` in storm_tpu/sampling/samplers.py).

The reference runs the loop as one `lax.scan` on the device; here it is a
Python loop over eager PyTorch calls. Noise comes from an injectable source
`noise(shape) -> tensor of shape + (2,)`, drawn in the reference's order:
the prior first, then for each step the corrector's draws and then the
predictor's.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..signal import cplx
from .correctors import CORRECTORS
from .predictors import PREDICTORS

NoiseSource = Callable[[tuple], torch.Tensor]


def generator_noise(generator: Optional[torch.Generator], device, dtype=torch.float32) -> NoiseSource:
    """The default noise source: standard complex normal from `generator`."""
    def draw(shape):
        return cplx.complex_normal(shape, generator=generator, device=device, dtype=dtype)
    return draw


def pc_sample(
    sde,
    score_fn: Callable,
    y: torch.Tensor,
    predictor: str = "reverse_diffusion",
    corrector: str = "ald",
    N: Optional[int] = None,
    snr: float = 0.5,
    corrector_steps: int = 1,
    probability_flow: bool = False,
    denoise: bool = True,
    eps: float = 3e-2,
    noise: Optional[NoiseSource] = None,
    generator: Optional[torch.Generator] = None,
):
    """Predictor-corrector sampling of the reverse SDE started at p_T(.|y).

    Args:
        score_fn: `(x, t, y) -> score`, packed-real; other conditioning is
            closed over.
        y: SDE steady-state input, packed-real (B, ..., 2).
        N: reverse steps (replaces sde.N).
        denoise: return the noise-free mean of the last predictor step.
        noise: noise source; by default drawn from `generator`.

    Returns:
        (x, nfe), nfe = N * (corrector_steps * (corrector != "none") + 1).
    """
    if N is not None and N != sde.N:
        sde = sde.copy(N=N)
    n = sde.N
    predictor_fn = PREDICTORS[predictor]
    corrector_fn = CORRECTORS[corrector]
    if noise is None:
        noise = generator_noise(generator, y.device, y.dtype)

    x = sde.prior_sampling(y, noise(y.shape[:-1]))
    x_mean = x
    rsde = sde.reverse(score_fn, probability_flow=probability_flow)
    timesteps = torch.linspace(sde.T, eps, n, dtype=torch.float32)
    batch = y.shape[0]
    for t in timesteps.tolist():
        vec_t = torch.full((batch,), t, dtype=torch.float32, device=y.device)
        x, x_mean = corrector_fn(sde, score_fn, x, vec_t, y, noise, snr, corrector_steps)
        x, x_mean = predictor_fn(rsde, x, vec_t, y, noise)
    nfe = n * (corrector_steps * (corrector != "none") + 1)
    return (x_mean if denoise else x), nfe
