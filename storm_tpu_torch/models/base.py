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
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

import torch
from torch import nn

from ..backbones.ncsnpp import ShardedNCSNpp
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


def is_time_domain(net: nn.Module) -> bool:
    """A `FORCE_STFT_OUT` backbone (ConvTasNet, ae-ncsnpp): it maps waveforms
    to waveforms."""
    return bool(getattr(net, "FORCE_STFT_OUT", False))


def time_domain_denoise(net: nn.Module, Y: torch.Tensor, stft_config: STFTConfig,
                        transform: SpecTransform) -> torch.Tensor:
    """A time-domain net on a compressed spec (B, F, T, 2): spec -> wav of
    (T - 1) * hop samples -> net -> wav -> spec, keeping Y's T frames (the
    reference's `time_domain_denoise`, storm_tpu/models/base.py:198-214)."""
    t_frames = Y.shape[-2]
    y_time = spec_to_wav(Y, stft_config, transform, length=(t_frames - 1) * stft_config.hop_length)
    return wav_to_spec(net(y_time), stft_config, transform)[..., :t_frames, :]


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


@contextlib.contextmanager
def nets_sharded(owner: nn.Module, shards: Optional[Sequence[str]]) -> Iterator[nn.Module]:
    """For one call, each NCSN++ spectrogram net of `owner` (its `NETS`)
    swapped for its `ShardedNCSNpp` over the devices `shards`, which has the
    same call signatures (the counterpart of the reference's
    `spec_sharding_constraint`, storm_tpu/models/base.py:156-183). Every net
    call then cuts its input along the frame axis and gathers its output on
    the group's first device, so the sampler, the SDE, the front end and the
    iSTFT run whole there, unchanged. Time-domain nets and GaGNet run whole
    on the first device. Enter it inside the nets' casts and int8 scales:
    the replicas take theirs. `shards` None or of one device: no change."""
    if not shards or len(shards) < 2:
        yield owner
        return
    with contextlib.ExitStack() as stack:
        for name in owner.NETS:
            net = getattr(owner, name)
            if getattr(net, "SEQ_PARALLEL", False):
                setattr(owner, name, stack.enter_context(ShardedNCSNpp.serving(net, shards)))
                stack.callback(setattr, owner, name, net)
        yield owner


def spatial_channels(model) -> int:
    """D, the waveform channels `model` takes: its first net's
    `spatial_channels` (NCSN++), 1 for a net without the field (the
    time-domain nets, GaGNet) and for a model without nets. The serving
    layer expects (B, D, T) for D > 1 and (B, T) for D = 1, as the
    reference's `BucketedEnhancer` does."""
    nets = getattr(model, "NETS", ())
    return int(getattr(getattr(model, nets[0]), "spatial_channels", 1)) if nets else 1


def per_example_sum(v: torch.Tensor) -> torch.Tensor:
    """0.5 * the sum of each example's elements, (B,)."""
    return 0.5 * v.reshape(v.shape[0], -1).sum(dim=-1)


@dataclasses.dataclass
class TrainState:
    """What a training step changes: the step count, the model's parameters,
    the EMA shadow (a state_dict of `model`) and the optimizer's moments.
    `step` is the host's count, which the loop, the logs and the checkpoints
    read; `device_step` is its copy on the model's device, which the EMA's
    decay reads, so that a step reads no host value (utils/train_graphs.py)."""

    step: int
    model: nn.Module
    ema: Dict[str, torch.Tensor]
    optimizer: torch.optim.Optimizer
    device_step: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.device_step is None:
            device = next(self.model.parameters()).device
            self.device_step = torch.full((), self.step, dtype=torch.int32, device=device)

    def set_step(self, step: int) -> None:
        """Both counts to `step` (a resumed run's)."""
        self.step = step
        self.device_step.fill_(step)


def make_optimizer(model: nn.Module, lr: float) -> torch.optim.Adam:
    """Adam over the trainable parameters with the defaults of `optax.adam`:
    b1 0.9, b2 0.999, eps 1e-8 added outside the square root. Frozen
    parameters (the Fourier features' W) are left out; the reference stops
    their gradient, so Adam leaves them unchanged there too. On a card Adam
    is capturable: its bias correction runs on the device from its device
    step counts, in the eager step as in a captured one, so both run the
    same arithmetic (PyTorch refuses a capturable Adam on the CPU)."""
    params = [p for p in model.parameters() if p.requires_grad]
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            capturable=params[0].is_cuda)


def init_train_state(model: nn.Module, lr: float) -> TrainState:
    """Step 0: the EMA at the parameters, Adam's state made now (`adam_state_now`)."""
    optimizer = make_optimizer(model, lr)
    adam_state_now(optimizer)
    return TrainState(step=0, model=model,
                      ema={k: v.detach().clone() for k, v in model.state_dict().items()},
                      optimizer=optimizer)


def adam_state_now(optimizer: torch.optim.Adam) -> None:
    """Make Adam's state as its first step would (moments and step counts at
    zero; the counts on the device when capturable), so that the state is
    allocated before a step's activations: made lazily after the first
    backward, its tensors would be carved out of the allocator's freed
    activation blocks and hold those segments, which a captured step's pool
    could then not reuse (utils/train_graphs.py)."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            state = optimizer.state[p]
            if not state:
                state["step"] = (torch.zeros((), dtype=torch.float32, device=p.device)
                                 if group["capturable"] else torch.tensor(0.0))
                state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor],
               decay: float, step: torch.Tensor) -> None:
    """In place: ema = d*ema + (1-d)*params, d = min(decay, (1+n)/(10+n)), n
    the count of optimizer steps taken, this one included, a tensor on the
    device; in float32 as the reference's `ema_update` (storm_tpu/models/
    base.py:37-43), which XLA compiles into one fused multiply-add per
    element: fma(d, ema, (1-d)*params). On a card `addcmul` is that fused
    multiply-add. On the CPU, whose `addcmul` fuses only its vectorized
    part, the exact product is summed in float64 and rounded to float32:
    the fused result except where the float64 sum falls on a float32
    midpoint (terms whose exponents differ by more than 5, about 2^-29 of
    those elements)."""
    num = step.to(torch.float32)
    d = torch.clamp((1.0 + num) / (10.0 + num), max=decay)
    for e, q in zip(ema.values(), torch._foreach_mul([params[k] for k in ema], 1.0 - d)):
        if e.is_cuda:
            torch.addcmul(q, e, d, out=e)
        else:
            e.copy_(torch.addcmul(q.double(), e.double(), d.double()))


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

    def per_example_given(self, batch, *drawn) -> torch.Tensor:
        """Each example's loss (B,) for the random inputs `drawn`."""
        raise NotImplementedError

    def loss_per_example(self, batch, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Each example's loss (B,), its random inputs drawn from `generator`
        (validation over ragged batches)."""
        return self.per_example_given(batch, *self.draw_step(batch, generator))

    def compute_gradients(self, batch, *drawn) -> Dict[str, torch.Tensor]:
        """Set every parameter's .grad to d step_loss / d param and return the
        detached losses. A parameter the loss does not reach gets zeros, as
        the reference's gradient tree has them: a view of one zero buffer per
        dtype and device, made once and only read (Adam does not write its
        gradients), which a captured step reads as a static tensor."""
        self.zero_grad(set_to_none=True)
        loss, aux = self.step_loss(batch, *drawn)
        loss.backward()
        zeros = self.__dict__.setdefault("_zero_grads", {})
        for p in self.parameters():
            if p.requires_grad and p.grad is None:
                z = zeros.get((p.dtype, p.device))
                if z is None:  # as long as the largest parameter
                    z = zeros[(p.dtype, p.device)] = torch.zeros(
                        max(q.numel() for q in self.parameters()), dtype=p.dtype,
                        device=p.device)
                p.grad = z[:p.numel()].view_as(p)
        return {k: v.detach() for k, v in aux.items()}

    def update(self, state: TrainState) -> None:
        """Adam's step on the gradients in .grad, the device step count, then
        the EMA: device work only."""
        state.optimizer.step()
        state.device_step.add_(1)
        ema_update(state.ema, self.state_dict(), self.ema_decay, state.device_step)

    def apply_update(self, state: TrainState) -> None:
        """`update`, and the host's step count."""
        self.update(state)
        state.step += 1

    def step_on_device(self, state: TrainState, batch, *drawn) -> Dict[str, torch.Tensor]:
        """One optimizer step on `batch` with the random inputs `drawn`: the
        gradients, Adam and the EMA, with no read of a device value (the body
        of a captured step); the host's count is the caller's. Returns the
        detached losses."""
        if state.model is not self:
            raise ValueError("train_step: the state belongs to another model")
        aux = self.compute_gradients(batch, *drawn)
        self.update(state)
        return aux

    def train_step(self, state: TrainState, batch,
                   generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """One optimizer step on `batch` with its random inputs from `generator`."""
        aux = self.step_on_device(state, batch, *self.draw_step(batch, generator))
        state.step += 1
        return aux
