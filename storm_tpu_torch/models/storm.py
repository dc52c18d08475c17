"""StoRM: predictive denoiser + score-based regeneration (counterpart of
storm_tpu/models/storm.py).

A denoiser D(Y) gives a first estimate; the reverse SDE (OUVE or OUVP) then
regenerates clean speech starting from D(Y), with the score net conditioned
on [Y, D(Y)].
Training minimises a*L_denoiser + (1-a)*L_score, with the SDE diffusing the
clean target towards D(Y); `regen-freeze-denoiser` detaches D(Y), so only the
score net learns.

The nets compute in their `dtype` (float32 or bfloat16) with float32
parameters, in training too: their outputs are float32, so the SDE,
`sigmas * z`, the losses, the gradients of the parameters, Adam and the EMA
stay float32, as in the reference (storm_tpu/models/storm.py:299-391).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..nn.qconv import scales_attached, stats_collected
from ..sampling.samplers import DeepCache, NoiseSource, time_major
from ..sde.sdes import SDE
from ..signal import cplx
from ..signal.stft import STFTConfig
from ..signal.transforms import SpecTransform
from ..utils.tensors import right_pad_dims
from .base import (EnhancementModel, check_sampler, draw_tz, lift_spec, make_deepcache_fns,
                   normalize_wav, per_example_sum, prepare_spec, run_sampler, spec_to_wav)

CONDITION_CHANNELS = {"noisy": 1, "post_denoiser": 1, "both": 2}
STORM_MODES = ("regen-joint-training", "regen-freeze-denoiser")
LOSS_TYPES = ("mse", "mae")

Batch = Tuple[torch.Tensor, torch.Tensor]  # (clean X, noisy Y) specs (B, F, T, 2)


def _stats_if(net: nn.Module, collect_stats: bool):
    return stats_collected(net) if collect_stats else contextlib.nullcontext()


class StochasticRegenerationModel(EnhancementModel):
    """Holds `denoiser_net` and `score_net` (NCSN++) with the SDE and the
    spectrogram front end; `enhance` is the whole inference path, `train_step`
    one optimizer step of joint training."""

    NETS = ("denoiser_net", "score_net")
    batch_reduction = "sum"  # the losses sum over the batch (storm_tpu/models/storm.py:299)

    def __init__(self, denoiser_net: nn.Module, score_net: nn.Module, sde: SDE,
                 stft_config: STFTConfig = STFTConfig(),
                 transform: SpecTransform = SpecTransform(),
                 t_eps: float = 0.03, condition: str = "both",
                 lr: float = 1e-4, ema_decay: float = 0.999,
                 loss_type_denoiser: str = "mse", loss_type_score: str = "mse",
                 weighting_denoiser_to_score: float = 0.5,
                 mode: str = "regen-joint-training"):
        super().__init__()
        if condition not in CONDITION_CHANNELS:
            raise NotImplementedError(
                f"Don't know the conditioning you have wished for: {condition}")
        if mode not in STORM_MODES:
            raise NotImplementedError(f"mode {mode!r} is not ported yet")
        if loss_type_score not in LOSS_TYPES:
            raise NotImplementedError(f"loss_type_score {loss_type_score!r}")
        if loss_type_denoiser not in LOSS_TYPES + ("none",):
            raise NotImplementedError(f"loss_type_denoiser {loss_type_denoiser!r}")
        self.denoiser_net = denoiser_net
        self.score_net = score_net
        self.sde = sde
        self.stft_config = stft_config
        self.transform = transform
        self.t_eps = t_eps
        self.condition = condition
        self.lr = lr
        self.ema_decay = ema_decay
        self.loss_type_denoiser = loss_type_denoiser
        self.loss_type_score = loss_type_score
        self.weighting_denoiser_to_score = weighting_denoiser_to_score
        self.mode = mode

    def forward_denoiser(self, Y: torch.Tensor, collect_stats: bool = False):
        """D(Y) for Y (B, F, T, 2) or (B, D, F, T, 2); keeps Y's shape.

        `collect_stats=True` returns (D(Y), {conv module name: max|input|, a
        0-d tensor}), the calibration statistics of models/quant.py."""
        Y5, squeezed = lift_spec(Y)
        t = torch.ones(Y5.shape[0], dtype=torch.float32, device=Y5.device)
        with _stats_if(self.denoiser_net, collect_stats) as stats:
            out = self.denoiser_net(Y5, t)
        out = out[:, 0] if squeezed else out
        return (out, stats) if collect_stats else out

    def _conditioning(self, Y: torch.Tensor, Y_denoised: torch.Tensor) -> List[torch.Tensor]:
        return {"noisy": [Y], "post_denoiser": [Y_denoised],
                "both": [Y, Y_denoised]}[self.condition]

    @staticmethod
    def _score_input(x: torch.Tensor,
                     score_conditioning: List[torch.Tensor]) -> Tuple[torch.Tensor, bool]:
        """(cat[x, *cond] in the (B, D, F, T, 2) layout, whether x was lifted)."""
        x5, squeezed = lift_spec(x)
        cond5 = [lift_spec(c)[0] for c in score_conditioning]
        return torch.cat([x5] + cond5, dim=1), squeezed

    def forward_score(self, x: torch.Tensor, t: torch.Tensor,
                      score_conditioning: List[torch.Tensor], collect_stats: bool = False,
                      net: Optional[nn.Module] = None):
        """score = -score_net(cat[x, *cond], t); keeps x's shape.
        `collect_stats` as in `forward_denoiser`, for the score net. `net`
        replaces `score_net` (a distillation's frozen teacher)."""
        net = self.score_net if net is None else net
        dnn_input, squeezed = self._score_input(x, score_conditioning)
        with _stats_if(net, collect_stats) as stats:
            out = net(dnn_input, t)
        out = -(out[:, 0] if squeezed else out)
        return (out, stats) if collect_stats else out

    # --- loss / training (storm_tpu/models/storm.py:246-389) ------------------

    @staticmethod
    def _reduce(v: torch.Tensor) -> torch.Tensor:
        """0.5 * sum over all elements, the batch included (the reference's)."""
        return 0.5 * v.sum()

    def _losses(self, batch: Batch, t: torch.Tensor, z: torch.Tensor, reduce):
        """(loss, loss_score, loss_denoiser or None) under `reduce`."""
        x, y = batch
        y_denoised = self.forward_denoiser(y)
        if self.mode == "regen-freeze-denoiser":
            y_denoised = y_denoised.detach()
        # the SDE diffuses towards the denoised estimate
        mean, std = self.sde.marginal_prob(x, t, y_denoised)
        sigmas = right_pad_dims(std, x)
        perturbed = mean + sigmas * z
        score = self.forward_score(perturbed, t, self._conditioning(y, y_denoised))
        err = score * sigmas + z
        per_elem = {"mse": torch.square, "mae": cplx.cabs}
        loss_score = reduce(per_elem[self.loss_type_score](err))
        if self.loss_type_denoiser == "none":
            return loss_score, loss_score, None
        loss_denoiser = reduce(per_elem[self.loss_type_denoiser](y_denoised - x))
        a = self.weighting_denoiser_to_score
        return a * loss_denoiser + (1 - a) * loss_score, loss_score, loss_denoiser

    def loss_given_tz(self, batch: Batch, t: torch.Tensor,
                      z: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Joint loss with given diffusion times t (B,) and noise z (x-shaped,
        packed-real): (loss, {"loss", "loss_score"[, "loss_denoiser"]})."""
        loss, loss_score, loss_denoiser = self._losses(batch, t, z, self._reduce)
        aux = {"loss": loss, "loss_score": loss_score}
        if loss_denoiser is not None:
            aux["loss_denoiser"] = loss_denoiser
        return loss, aux

    step_loss = loss_given_tz

    def draw_tz(self, x: torch.Tensor,
                generator: Optional[torch.Generator]) -> Tuple[torch.Tensor, torch.Tensor]:
        """t ~ U(t_eps, T) per example and standard complex normal z like x."""
        return draw_tz(self.sde, self.t_eps, x, generator)

    def draw_step(self, batch: Batch, generator: Optional[torch.Generator]):
        return self.draw_tz(batch[0], generator)

    def loss_fn(self, batch: Batch, generator: Optional[torch.Generator] = None):
        """`loss_given_tz` with t and z drawn from `generator`."""
        return self.loss_given_tz(batch, *self.draw_tz(batch[0], generator))

    def loss_per_example(self, batch: Batch,
                         generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Joint loss of each example (B,), for validation over ragged batches."""
        t, z = self.draw_tz(batch[0], generator)
        return self._losses(batch, t, z, per_example_sum)[0]

    @torch.inference_mode()
    def enhance(
        self,
        y: torch.Tensor,
        N: int = 30,
        sampler_type: str = "pc",
        predictor: str = "reverse_diffusion",
        corrector: str = "none",
        corrector_steps: int = 1,
        snr: float = 0.5,
        probability_flow: bool = False,
        generator: Optional[torch.Generator] = None,
        noise: Optional[NoiseSource] = None,
        quant: Optional[Dict[str, Optional[Dict[str, float]]]] = None,
        deepcache: int = 0,
        deepcache_depth: int = 1,
        method: str = "heun",
        rtol: float = 1e-5,
        atol: float = 1e-5,
        max_steps: int = 1000,
        sweeps: int = 8,
    ) -> Tuple[torch.Tensor, int]:
        """Enhance waveforms y (B, T) -> (x_hat (B, T), nfe).

        Defaults are the reference model's: N=30, reverse diffusion, no
        corrector. `sampler_type`: "pc" (predictor-corrector: `predictor`,
        `corrector`, `corrector_steps`, `snr`, `probability_flow`), "ode"
        (the probability-flow ODE: `method`, and `rtol`, `atol`, `max_steps`
        for "rk45") or "picard" (`sweeps` Picard sweeps of the ODE, each one
        score-net call on N x B rows); the options of the other samplers are
        ignored, as in the reference. Noise comes from `noise` if given,
        else from `generator`; the ODE samplers draw the prior only.
        `quant`: {"denoiser": scales or None, "score": scales or None}, int8
        activation scales by conv module name from
        `models.quant.calibrate_storm`; the convs they name run on the int8
        path for the whole call (scales attached, and weights quantized
        from the float32 weights, once per call). The nets compute in their
        dtype with their parameters cast to it once per call; the
        spectrograms, the SDE and the output stay float32.
        `deepcache`: if > 0, refresh the score net's deep-feature cache every
        `deepcache`-th sampler step and recompute only its top
        `deepcache_depth` levels per score evaluation (DeepCache-style
        serving, arXiv:2312.00858; pc and ode only); nfe counts the score
        evaluations, not the refreshes, as the reference does.
        """
        check_sampler(self.score_net, sampler_type, deepcache, deepcache_depth, method)
        T_orig = y.shape[-1]
        y_n, norm = normalize_wav(y)
        Y, _ = prepare_spec(y_n, self.stft_config, self.transform)
        quant = quant or {}
        with self.cast_nets(), \
                scales_attached(self.denoiser_net, quant.get("denoiser") or {}), \
                scales_attached(self.score_net, quant.get("score") or {}):
            Y_denoised = self.forward_denoiser(Y)
            cond = self._conditioning(Y, Y_denoised)

            def score_fn(x, t, y_sde):
                return self.forward_score(x, t, cond)

            wide = [time_major(c, N) for c in cond] if sampler_type == "picard" else None

            def wide_score_fn(x, t, y_sde):
                return self.forward_score(x, t, wide)

            cache = None
            if deepcache:
                cache = DeepCache(deepcache, *make_deepcache_fns(
                    self.score_net, lambda x: self._score_input(x, cond), deepcache_depth))
            # the SDE's steady state, and the prior's centre, is D(Y)
            sample, n = run_sampler(
                self.sde, score_fn, Y_denoised, sampler_type, N=N, eps=self.t_eps, noise=noise,
                generator=generator, predictor=predictor, corrector=corrector,
                corrector_steps=corrector_steps, snr=snr, probability_flow=probability_flow,
                method=method, rtol=rtol, atol=atol, max_steps=max_steps, sweeps=sweeps,
                cache=cache, wide_score_fn=wide_score_fn)
        # the whole padded spec goes through the iSTFT, cut to T_orig samples
        x_hat = spec_to_wav(sample, self.stft_config, self.transform, length=T_orig)
        return x_hat * norm, 1 + n
