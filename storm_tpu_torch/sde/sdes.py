"""The OUVE and OUVP SDEs and their reverse (counterpart of
storm_tpu/sde/sdes.py). `SDES` maps the config's `sde` name to its class.

x, y are packed-real tensors (B, ..., 2); t is a per-batch time vector (B,).
Per-batch scalars (std, diffusion) come back with shape (B,).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Union

import torch

from ..utils.tensors import right_pad_dims


@dataclasses.dataclass(frozen=True)
class OUVESDE:
    """Ornstein-Uhlenbeck variance-exploding SDE.

        dx = theta (y - x) dt + sigma(t) dw,
        sigma(t) = sigma_min (sigma_max/sigma_min)^t sqrt(2 log(sigma_max/sigma_min))
    """

    theta: float = 1.5
    sigma_min: float = 0.05
    sigma_max: float = 0.5
    N: int = 1000

    @property
    def T(self) -> float:
        return 1.0

    @property
    def logsig(self) -> float:
        return math.log(self.sigma_max / self.sigma_min)

    def copy(self, **updates) -> "OUVESDE":
        return dataclasses.replace(self, **updates)

    def sde(self, x, t, y):
        drift = self.theta * (y - x)
        sigma = self.sigma_min * (self.sigma_max / self.sigma_min) ** t
        return drift, sigma * math.sqrt(2 * self.logsig)

    def _mean(self, x0, t, y):
        e = right_pad_dims(torch.exp(-self.theta * t), x0)
        return e * x0 + (1.0 - e) * y

    def _std(self, t):
        s, th, ls = self.sigma_min, self.theta, self.logsig
        return torch.sqrt(
            (s**2 * torch.exp(-2 * th * t) * (torch.exp(2 * (th + ls) * t) - 1) * ls)
            / (th + ls)
        )

    def marginal_prob(self, x0, t, y):
        return self._mean(x0, t, y), self._std(t)

    def prior_sampling(self, y, z):
        """x_T = y + std(T) z for standard complex normal noise z (y-shaped)."""
        std = self._std(torch.full((y.shape[0],), self.T, dtype=y.dtype,
                                   device=y.device))
        return y + z * right_pad_dims(std, y)

    def discretize(self, x, t, y):
        """Euler-Maruyama increments (f dt, G sqrt(dt))."""
        dt = 1.0 / self.N
        drift, diffusion = self.sde(x, t, y)
        return drift * dt, diffusion * math.sqrt(dt)

    def reverse(self, score_fn: Callable, probability_flow: bool = False) -> "ReverseSDE":
        return ReverseSDE(self, score_fn, probability_flow)


@dataclasses.dataclass(frozen=True)
class OUVPSDE:
    """Ornstein-Uhlenbeck variance-preserving SDE.

        dx = 1/2 beta(t) stiffness (y - x) dt + sqrt(beta(t)) dw,
        beta(t) = beta_min + t (beta_max - beta_min)

    `beta_min` and `beta_max` have no defaults, as in the reference (its
    training CLI gives them 0.1 and 1.0). `_std` is the reference's closed
    form as it stands: (1 - exp(-s t (t (b1 - b0) + 2 b0) / 2)) / s, with no
    square root; the ald corrector reads it.
    """

    beta_min: float
    beta_max: float
    stiffness: float = 1.0
    N: int = 1000

    @property
    def T(self) -> float:
        return 1.0

    def copy(self, **updates) -> "OUVPSDE":
        return dataclasses.replace(self, **updates)

    def _beta(self, t):
        return self.beta_min + t * (self.beta_max - self.beta_min)

    def sde(self, x, t, y):
        drift = 0.5 * self.stiffness * right_pad_dims(self._beta(t), y) * (y - x)
        return drift, torch.sqrt(self._beta(t))

    def _mean(self, x0, t, y):
        b0, b1, s = self.beta_min, self.beta_max, self.stiffness
        fac = right_pad_dims(torch.exp(-0.25 * s * t * (t * (b1 - b0) + 2 * b0)), x0)
        return y + fac * (x0 - y)

    def _std(self, t):
        b0, b1, s = self.beta_min, self.beta_max, self.stiffness
        return (1.0 - torch.exp(-0.5 * s * t * (t * (b1 - b0) + 2 * b0))) / s

    marginal_prob = OUVESDE.marginal_prob
    prior_sampling = OUVESDE.prior_sampling
    discretize = OUVESDE.discretize
    reverse = OUVESDE.reverse


SDE = Union[OUVESDE, OUVPSDE]
SDES = {"ouve": OUVESDE, "ouvp": OUVPSDE}  # the config's `sde` -> its class


@dataclasses.dataclass(frozen=True)
class ReverseSDE:
    """Reverse-time SDE (or probability-flow ODE) of `forward` with a score."""

    forward: SDE
    score_fn: Callable
    probability_flow: bool = False

    @property
    def N(self) -> int:
        return self.forward.N

    @property
    def T(self) -> float:
        return self.forward.T

    def _scale(self) -> float:
        return 0.5 if self.probability_flow else 1.0

    def sde(self, x, t, y):
        sde_drift, sde_diffusion = self.forward.sde(x, t, y)
        score = self.score_fn(x, t, y)
        g2 = right_pad_dims(sde_diffusion ** 2, x)
        drift = sde_drift - g2 * score * self._scale()
        diffusion = (torch.zeros_like(sde_diffusion) if self.probability_flow
                     else sde_diffusion)
        return drift, diffusion

    def discretize(self, x, t, y):
        f, G = self.forward.discretize(x, t, y)
        Gp = right_pad_dims(G * torch.ones(x.shape[0], dtype=x.dtype,
                                           device=x.device), x)
        score = self.score_fn(x, t, y)
        rev_f = f - Gp ** 2 * score * self._scale()
        rev_G = torch.zeros_like(Gp) if self.probability_flow else Gp
        return rev_f, rev_G
