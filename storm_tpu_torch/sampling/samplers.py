"""Predictor-corrector sampling (counterpart of `pc_sample` in storm_tpu/sampling/samplers.py).

The reference runs the loop as one `lax.scan` on the device; here it is a
Python loop over eager PyTorch calls. Noise comes from an injectable source
`noise(shape) -> tensor of shape + (2,)`, drawn in the reference's order:
the prior first, then for each step the corrector's draws and then the
predictor's.

With a `DeepCache` of interval K the score net's deep features are cached
(DeepCache-style serving, arXiv:2312.00858): made before the loop at the
prior, refreshed at the top of every K-th step, and every score evaluation
of the step recomputes only the top levels from the cache. Whether a step
refreshes is decided on the host from the step's index, so the loop reads
no device value: `BucketedEnhancer.enhance_async` and the server's
pipelined finalizer rely on the sampler enqueueing without a sync.
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


class DeepCache:
    """Deep-feature caching for one `pc_sample` call: the refresh interval,
    `deep_fn(x, t) -> cache` and `cached_score_fn(x, t, cache) -> score`
    (other conditioning closed over), and the cache the step's score
    evaluations read, which `refresh` replaces."""

    def __init__(self, interval: int, deep_fn: Callable, cached_score_fn: Callable):
        self.interval, self.deep_fn, self.cached_score_fn = interval, deep_fn, cached_score_fn
        self.cache = None

    def refresh(self, x: torch.Tensor, t: torch.Tensor) -> None:
        self.cache = self.deep_fn(x, t)

    def score_fn(self, x: torch.Tensor, t: torch.Tensor, y_sde: torch.Tensor) -> torch.Tensor:
        return self.cached_score_fn(x, t, self.cache)


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
    intermediate: bool = False,
    deepcache: Optional[DeepCache] = None,
):
    """Predictor-corrector sampling of the reverse SDE started at p_T(.|y).

    Args:
        score_fn: `(x, t, y) -> score`, packed-real; other conditioning is
            closed over.
        y: SDE steady-state input, packed-real (B, ..., 2).
        N: reverse steps (replaces sde.N).
        denoise: return the noise-free mean of the last predictor step.
        noise: noise source; by default drawn from `generator`.
        intermediate: also return the (N, ...) trajectory of the predictor's
            means, one per step.
        deepcache: if given, its cache is made at the prior and refreshed
            at the top of every `deepcache.interval`-th step, and every
            score evaluation reads it (`score_fn` is not called). With
            interval 1 and no corrector the trajectory is exact (the cache
            is made at the very (x, t) the predictor evaluates). Refreshes
            are not counted in nfe, as in the reference.

    Returns:
        (x, nfe), nfe = N * (corrector_steps * (corrector != "none") + 1);
        (x, trajectory, nfe) with `intermediate`.
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
    timesteps = torch.linspace(sde.T, eps, n, dtype=torch.float32).tolist()
    batch = y.shape[0]

    def vector(t: float) -> torch.Tensor:
        return torch.full((batch,), t, dtype=torch.float32, device=y.device)

    if deepcache is not None:
        deepcache.refresh(x, vector(timesteps[0]))
        score_fn = deepcache.score_fn
    rsde = sde.reverse(score_fn, probability_flow=probability_flow)
    trajectory = []
    # one step body for both modes: the draws' order cannot part between them
    for i, t in enumerate(timesteps):
        vec_t = vector(t)
        if deepcache is not None and i % deepcache.interval == 0 and i > 0:
            deepcache.refresh(x, vec_t)
        x, x_mean = corrector_fn(sde, score_fn, x, vec_t, y, noise, snr, corrector_steps)
        x, x_mean = predictor_fn(rsde, x, vec_t, y, noise)
        if intermediate:
            trajectory.append(x_mean)
    nfe = n * (corrector_steps * (corrector != "none") + 1)
    if intermediate:
        return (x_mean if denoise else x), torch.stack(trajectory), nfe
    return (x_mean if denoise else x), nfe
