"""Train state, EMA, optimizer, wav <-> compressed-spec plumbing, and what
the three models share: their nets' inference cast, one optimizer step and
the sampler dispatch (counterpart of storm_tpu/models/base.py).

The EMA follows torch-ema with warmup, as the reference does: after every
optimizer step n (counted from 1), shadow = d*shadow + (1-d)*param with
d = min(decay, (1+n)/(10+n)). Evaluation uses the shadow weights.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch
from torch import nn

from ..nn.cast import cast_params
from ..sampling.samplers import (DeepCache, check_deepcache_method, ode_sample, pc_sample,
                                 picard_sample)
from ..signal import cplx
from ..signal.stft import STFTConfig, istft_real, stft_real
from ..signal.transforms import SpecTransform, pad_spec


def wav_to_spec(y: torch.Tensor, stft_config: STFTConfig,
                transform: SpecTransform) -> torch.Tensor:
    """(B, T) waveform -> compressed packed-real spec (B, F, Tf, 2)."""
    return transform.forward_packed(stft_real(y, stft_config))


def spec_to_wav(spec: torch.Tensor, stft_config: STFTConfig, transform: SpecTransform,
                length: Optional[int] = None) -> torch.Tensor:
    """Compressed packed-real spec (B, F, Tf, 2) -> (B, T) waveform."""
    return istft_real(transform.backward_packed(spec), stft_config, length=length)


def normalize_wav(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-utterance max-abs normalisation over all but the batch axis.

    Returns (y / norm, norm) with norm broadcastable against y.
    """
    B = y.shape[0]
    norm = y.abs().reshape(B, -1).amax(dim=-1).clamp_min(1e-10)
    norm = norm.reshape((B,) + (1,) * (y.ndim - 1))
    return y / norm, norm


def lift_spec(Y: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    """(B, F, T, 2) -> ((B, 1, F, T, 2), True); (B, D, F, T, 2) -> (Y, False)."""
    if Y.ndim == 4:
        return Y[:, None], True
    if Y.ndim == 5:
        return Y, False
    raise ValueError(f"expected (B,F,T,2) or (B,D,F,T,2) spec, got {tuple(Y.shape)}")


def prepare_spec(y: torch.Tensor, stft_config: STFTConfig, transform: SpecTransform,
                 multiple: int = 64) -> Tuple[torch.Tensor, int]:
    """wav (B, T) -> (compressed spec padded to a multiple of 64 frames, frames before padding)."""
    Y = wav_to_spec(y, stft_config, transform)
    return pad_spec(Y, multiple=multiple, axis=-2), Y.shape[-2]


def make_deepcache_fns(net: nn.Module, pack_input: Callable, cache_depth: int):
    """The (deep_fn, cached_score_fn) pair of a sampler's `DeepCache`:
    the one place that holds the cached score evaluation's contract (the
    score input's packing, the `-out` sign, the squeeze), so that the
    cached trajectory cannot drift from the exact one.

    Args:
        net: an NCSN++ (exposes deep_features / forward_shallow and sets
            SUPPORTS_DEEPCACHE), with the weights it serves.
        pack_input: x -> (score-net input, squeezed): x with the model's
            conditioning concatenated, as `forward_score` packs it.
    """

    def deep_fn(x: torch.Tensor, t: torch.Tensor):
        return net.deep_features(pack_input(x)[0], t, cache_depth=cache_depth)

    def cached_score_fn(x: torch.Tensor, t: torch.Tensor, cache) -> torch.Tensor:
        dnn_input, squeezed = pack_input(x)
        out = net.forward_shallow(dnn_input, t, cache, cache_depth=cache_depth)
        return -(out[:, 0] if squeezed else out)

    return deep_fn, cached_score_fn


def check_deepcache_config(net: Optional[nn.Module], deepcache: int, sampler_type: str,
                           cache_depth: Optional[int] = None,
                           method: Optional[str] = None) -> None:
    """Refuse a deepcache request the model cannot serve, with the
    reference's messages; with `cache_depth`, also one the net has no such
    level for, and with `method`, an ODE method the cache cannot serve."""
    if deepcache < 0:
        raise ValueError(f"deepcache must be >= 0, got {deepcache}")
    if sampler_type not in ("pc", "ode"):
        raise ValueError(
            "deepcache requires the pc or ode sampler (picard folds time "
            "into the batch axis — an N-point per-step cache would defeat "
            f"the memory saving); got {sampler_type!r}"
        )
    if net is not None and not getattr(net, "SUPPORTS_DEEPCACHE", False):
        raise ValueError(
            "deepcache requires an NCSN++-family (2-D U-Net) backbone; "
            f"{type(net).__name__} does not support the cache split"
        )
    if sampler_type == "ode" and method is not None:
        check_deepcache_method(method)
    if net is not None and cache_depth is not None:
        net.check_cache_depth(cache_depth)


SAMPLER_TYPES = ("pc", "ode", "picard")


def check_sampler(net: nn.Module, sampler_type: str, deepcache: int, deepcache_depth: int,
                  method: str) -> None:
    """Refuse an unknown sampler, and a deepcache request `net` cannot serve."""
    if sampler_type not in SAMPLER_TYPES:
        raise ValueError(f"{sampler_type} is not a valid sampler type!")
    if deepcache:
        check_deepcache_config(net, deepcache, sampler_type, deepcache_depth, method)


def run_sampler(sde, score_fn: Callable, y: torch.Tensor, sampler_type: str, *, N: int,
                eps: float, noise, generator, predictor: str, corrector: str,
                corrector_steps: int, snr: float, probability_flow: bool, method: str,
                rtol: float, atol: float, max_steps: int, sweeps: int,
                cache: Optional[DeepCache] = None,
                wide_score_fn: Optional[Callable] = None) -> Tuple[torch.Tensor, int]:
    """One call of the sampler `sampler_type` from p_T(.|y), ending with the
    denoising step: "pc" (the predictor-corrector options and `cache`),
    "ode" (`method`, `cache`, and `rtol`, `atol`, `max_steps` for rk45) or
    "picard" (`sweeps` sweeps, each a `wide_score_fn` call on N x B rows);
    the other samplers' options are ignored. Returns (x, nfe)."""
    common = dict(N=N, denoise=True, eps=eps, noise=noise, generator=generator)
    if sampler_type == "pc":
        return pc_sample(sde, score_fn, y, predictor=predictor, corrector=corrector, snr=snr,
                         corrector_steps=corrector_steps, probability_flow=probability_flow,
                         deepcache=cache, **common)
    if sampler_type == "ode":
        return ode_sample(sde, score_fn, y, method=method, deepcache=cache, rtol=rtol,
                          atol=atol, max_steps=max_steps, **common)
    return picard_sample(sde, score_fn, y, sweeps=sweeps, wide_score_fn=wide_score_fn, **common)


def draw_tz(sde, t_eps: float, x: torch.Tensor,
            generator: Optional[torch.Generator]) -> Tuple[torch.Tensor, torch.Tensor]:
    """t ~ U(t_eps, T) per example and standard complex normal z like x."""
    t = torch.rand(x.shape[0], generator=generator, device=x.device)
    t = t * (sde.T - t_eps) + t_eps
    return t, cplx.complex_normal(x.shape[:-1], generator=generator, device=x.device)


def per_example_sum(v: torch.Tensor) -> torch.Tensor:
    """0.5 * the sum of each example's elements, (B,)."""
    return 0.5 * v.reshape(v.shape[0], -1).sum(dim=-1)


@dataclasses.dataclass
class TrainState:
    """What a training step changes: the step count, the model's parameters,
    the EMA shadow (a state_dict of `model`) and the optimizer's moments."""

    step: int
    model: nn.Module
    ema: Dict[str, torch.Tensor]
    optimizer: torch.optim.Optimizer


def make_optimizer(model: nn.Module, lr: float) -> torch.optim.Adam:
    """Adam over the trainable parameters with the defaults of `optax.adam`:
    b1 0.9, b2 0.999, eps 1e-8 added outside the square root. Frozen
    parameters (the Fourier features' W) are left out; the reference stops
    their gradient, so Adam leaves them unchanged there too."""
    return torch.optim.Adam([p for p in model.parameters() if p.requires_grad],
                            lr=lr, betas=(0.9, 0.999), eps=1e-8)


def init_train_state(model: nn.Module, lr: float) -> TrainState:
    return TrainState(step=0, model=model,
                      ema={k: v.detach().clone() for k, v in model.state_dict().items()},
                      optimizer=make_optimizer(model, lr))


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor],
               decay: float, step: int) -> None:
    """In place: ema = d*ema + (1-d)*params, d = min(decay, (1+step)/(10+step)),
    `step` being the count of optimizer steps taken, this one included."""
    d = min(decay, (1.0 + step) / (10.0 + step))
    for k, e in ema.items():
        e.mul_(d).add_(params[k], alpha=1.0 - d)


@contextlib.contextmanager
def swapped_in(model: nn.Module, weights: Dict[str, torch.Tensor]) -> Iterator[nn.Module]:
    """Run `model` with `weights` (the EMA shadow, say), then put its own back."""
    own = {k: v.detach().clone() for k, v in model.state_dict().items()}
    model.load_state_dict(weights, strict=True)
    try:
        yield model
    finally:
        model.load_state_dict(own, strict=True)


class EnhancementModel(nn.Module):
    """What the three models share: the nets named in `NETS`, cast to their
    dtype for inference, and one optimizer step on `step_loss`.

    A subclass defines `step_loss(batch, *drawn) -> (loss, aux)` and, where
    a step draws random inputs (the diffusion time and noise), `draw_step`.
    `batch_reduction` says how the loss combines the examples of a batch,
    "mean" or "sum"; the trainer's masked validation follows it."""

    NETS: Tuple[str, ...] = ()
    batch_reduction = "mean"

    @contextlib.contextmanager
    def cast_nets(self):
        """The nets with their parameters cast to their dtype once for the
        block (nn/cast.py `cast_params`): for inference and validation, under
        torch.no_grad() or inference_mode; a forward with gradients raises."""
        with contextlib.ExitStack() as stack:
            for name in self.NETS:
                net = getattr(self, name)
                stack.enter_context(cast_params(net, net.dtype))
            yield self

    def draw_step(self, batch, generator: Optional[torch.Generator]) -> Tuple:
        """The random inputs of one step's loss (none by default)."""
        return ()

    def step_loss(self, batch, *drawn) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        raise NotImplementedError

    def compute_gradients(self, batch, *drawn) -> Dict[str, torch.Tensor]:
        """Set every parameter's .grad to d step_loss / d param (zeros where
        the loss does not reach, as the reference's gradient tree has them) and
        return the detached losses."""
        self.zero_grad(set_to_none=True)
        loss, aux = self.step_loss(batch, *drawn)
        loss.backward()
        for p in self.parameters():
            if p.requires_grad and p.grad is None:
                p.grad = torch.zeros_like(p)
        return {k: v.detach() for k, v in aux.items()}

    def apply_update(self, state: TrainState) -> None:
        """Adam step on the gradients in .grad, then the EMA update."""
        state.optimizer.step()
        state.step += 1
        ema_update(state.ema, self.state_dict(), self.ema_decay, state.step)

    def train_step(self, state: TrainState, batch,
                   generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """One optimizer step on `batch` with its random inputs from `generator`."""
        if state.model is not self:
            raise ValueError("train_step: the state belongs to another model")
        aux = self.compute_gradients(batch, *self.draw_step(batch, generator))
        self.apply_update(state)
        return aux
