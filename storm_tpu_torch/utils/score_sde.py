"""The legacy score-sde model helpers (counterpart of
storm_tpu/utils/score_sde.py; upstream sgmse/backbones/ncsnpp_utils/utils.py).

Dead code upstream, kept for the surface: no training or serving path calls
it. A model registry (`register_model`, `get_model`, `create_model`), the
SMLD and DDPM noise tables (`get_sigmas`, `get_ddpm_params`), adapters from a
network to a time-dependent score (`get_model_fn`, `get_score_fn`, with the
OUVE and OUVP label conventions, continuous and discrete) and
`to_flattened_numpy` / `from_flattened_numpy`.

`apply_fn(x, labels, deterministic)` is the network: `deterministic` is the
JAX package's flag for the reference's eval mode (a wrapper around an
`nn.Module` sets `.train(not deterministic)` itself). The registry is a dict
with the JAX `Registry`'s refusals, as `backbones/__init__.py` holds the
backbones.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..sde.sdes import OUVESDE, OUVPSDE
from .tensors import right_pad_dims

MANAGED = "legacy-score-sde-model"
MODELS: Dict[str, Any] = {}


def register_model(cls=None, *, name: Optional[str] = None):
    """Register a model class under `name` (default: its class name), as a
    decorator with or without arguments; a name registered twice raises
    ValueError."""

    def _register(c):
        key = name or c.__name__
        if key in MODELS:
            raise ValueError(f"{MANAGED} {key} already registered!")
        MODELS[key] = c
        return c

    return _register if cls is None else _register(cls)


def get_model(name: str):
    if name in MODELS:
        return MODELS[name]
    raise ValueError(f"{MANAGED} with name '{name}' unknown! Available: {sorted(MODELS)}")


def create_model(name: str, **kwargs):
    """Build the model registered as `name` with `kwargs`. The reference
    also moves it to its device and wraps it in `DataParallel`; here the
    caller places it."""
    return get_model(name)(**kwargs)


def get_sigmas(sigma_min: float, sigma_max: float, num_scales: int) -> np.ndarray:
    """Geometric SMLD noise levels, descending."""
    return np.exp(np.linspace(np.log(sigma_max), np.log(sigma_min), num_scales))


def get_ddpm_params(beta_min: float, beta_max: float, num_scales: int) -> Dict[str, Any]:
    """The DDPM beta and alpha tables in float64, with the reference's fixed
    1000 diffusion steps and its beta / num_scales endpoints."""
    num_diffusion_timesteps = 1000
    beta_start = beta_min / num_scales
    beta_end = beta_max / num_scales
    betas = np.linspace(beta_start, beta_end, num_diffusion_timesteps, dtype=np.float64)

    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    sqrt_alphas_cumprod = np.sqrt(alphas_cumprod)
    sqrt_1m_alphas_cumprod = np.sqrt(1.0 - alphas_cumprod)

    return {
        "betas": betas,
        "alphas": alphas,
        "alphas_cumprod": alphas_cumprod,
        "sqrt_alphas_cumprod": sqrt_alphas_cumprod,
        "sqrt_1m_alphas_cumprod": sqrt_1m_alphas_cumprod,
        "beta_min": beta_start * (num_diffusion_timesteps - 1),
        "beta_max": beta_end * (num_diffusion_timesteps - 1),
        "num_diffusion_timesteps": num_diffusion_timesteps,
    }


def get_model_fn(apply_fn: Callable, train: bool = False) -> Callable:
    """`model_fn(x, labels)`: `apply_fn` with `deterministic = not train`."""

    def model_fn(x, labels):
        return apply_fn(x, labels, deterministic=not train)

    return model_fn


def get_score_fn(sde, apply_fn: Callable, train: bool = False,
                 continuous: bool = False) -> Callable:
    """`score_fn(x, t)` from a raw network, by the SDE's label convention.

    OUVP: continuous labels t * 999 and the output divided by -std(t), the
    marginal's (the SDE's `_std`); discrete labels int(t (N - 1)) index the
    DDPM `sqrt_1m_alphas_cumprod` table of the SDE's own beta endpoints,
    whose entry divides -output. OUVE: continuous labels are the marginal
    std at t, discrete ones round((T - t)(N - 1)); the output is the score
    as it is."""
    model_fn = get_model_fn(apply_fn, train=train)

    if isinstance(sde, OUVPSDE):
        table = None if continuous else torch.from_numpy(get_ddpm_params(
            sde.beta_min, sde.beta_max, sde.N)["sqrt_1m_alphas_cumprod"].astype(np.float32))

        def score_fn(x, t):
            if continuous:
                labels = t * 999
                std = sde.marginal_prob(torch.zeros_like(x), t, torch.zeros_like(x))[1]
            else:
                labels = (t * (sde.N - 1)).to(torch.int32)
                std = table.to(t.device)[labels.long()]
            score = model_fn(x, labels)
            return -score / right_pad_dims(std, score)

    elif isinstance(sde, OUVESDE):

        def score_fn(x, t):
            if continuous:
                labels = sde.marginal_prob(torch.zeros_like(x), t, torch.zeros_like(x))[1]
            else:
                labels = torch.round((sde.T - t) * (sde.N - 1)).to(torch.int32)
            return model_fn(x, labels)

    else:
        raise NotImplementedError(f"SDE class {sde.__class__.__name__} not yet supported.")

    return score_fn


def to_flattened_numpy(x) -> np.ndarray:
    """A tensor (or array) as a flat numpy array, on the host."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x).reshape((-1,))


def from_flattened_numpy(x: np.ndarray, shape, device=None) -> torch.Tensor:
    """A flat numpy array back as a tensor of `shape` (on `device`)."""
    return torch.as_tensor(np.asarray(x), device=device).reshape(shape)
