"""StoRM: predictive denoiser + score-based regeneration (counterpart of
storm_tpu/models/storm.py).

A denoiser D(Y) gives a first estimate; the reverse OUVE SDE then regenerates
clean speech starting from D(Y), with the score net conditioned on [Y, D(Y)].
Training minimises a*L_denoiser + (1-a)*L_score, with the SDE diffusing the
clean target towards D(Y); `regen-freeze-denoiser` detaches D(Y), so only the
score net learns.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..nn.cast import cast_params
from ..nn.qconv import scales_attached, stats_collected
from ..sampling.samplers import NoiseSource, pc_sample
from ..sde.sdes import OUVESDE
from ..signal import cplx
from ..signal.stft import STFTConfig
from ..signal.transforms import SpecTransform
from ..utils.tensors import right_pad_dims
from .base import TrainState, ema_update, lift_spec, normalize_wav, prepare_spec, spec_to_wav

CONDITION_CHANNELS = {"noisy": 1, "post_denoiser": 1, "both": 2}
STORM_MODES = ("regen-joint-training", "regen-freeze-denoiser")
LOSS_TYPES = ("mse", "mae")

Batch = Tuple[torch.Tensor, torch.Tensor]  # (clean X, noisy Y) specs (B, F, T, 2)


def _stats_if(net: nn.Module, collect_stats: bool):
    return stats_collected(net) if collect_stats else contextlib.nullcontext()


class StochasticRegenerationModel(nn.Module):
    """Holds `denoiser_net` and `score_net` (NCSN++) with the SDE and the
    spectrogram front end; `enhance` is the whole inference path, `train_step`
    one optimizer step of joint training."""

    def __init__(self, denoiser_net: nn.Module, score_net: nn.Module, sde: OUVESDE,
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

    def forward_score(self, x: torch.Tensor, t: torch.Tensor,
                      score_conditioning: List[torch.Tensor], collect_stats: bool = False):
        """score = -score_net(cat[x, *cond], t); keeps x's shape.
        `collect_stats` as in `forward_denoiser`, for the score net."""
        x5, squeezed = lift_spec(x)
        cond5 = [lift_spec(c)[0] for c in score_conditioning]
        with _stats_if(self.score_net, collect_stats) as stats:
            out = self.score_net(torch.cat([x5] + cond5, dim=1), t)
        out = -(out[:, 0] if squeezed else out)
        return (out, stats) if collect_stats else out

    # --- loss / training (storm_tpu/models/storm.py:246-389) ------------------

    @staticmethod
    def _reduce(v: torch.Tensor) -> torch.Tensor:
        """0.5 * sum over all elements, the batch included (the reference's)."""
        return 0.5 * v.sum()

    @staticmethod
    def _reduce_per_example(v: torch.Tensor) -> torch.Tensor:
        return 0.5 * v.reshape(v.shape[0], -1).sum(dim=-1)

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

    def draw_tz(self, x: torch.Tensor,
                generator: Optional[torch.Generator]) -> Tuple[torch.Tensor, torch.Tensor]:
        """t ~ U(t_eps, T) per example and standard complex normal z like x."""
        t = torch.rand(x.shape[0], generator=generator, device=x.device)
        t = t * (self.sde.T - self.t_eps) + self.t_eps
        return t, cplx.complex_normal(x.shape[:-1], generator=generator, device=x.device)

    def loss_fn(self, batch: Batch, generator: Optional[torch.Generator] = None):
        """`loss_given_tz` with t and z drawn from `generator`."""
        return self.loss_given_tz(batch, *self.draw_tz(batch[0], generator))

    def loss_per_example(self, batch: Batch,
                         generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Joint loss of each example (B,), for validation over ragged batches."""
        t, z = self.draw_tz(batch[0], generator)
        return self._losses(batch, t, z, self._reduce_per_example)[0]

    def compute_gradients(self, batch: Batch, t: torch.Tensor,
                          z: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Set every parameter's .grad to d loss_given_tz / d param (zeros where
        the loss does not reach, as the reference's gradient tree has them) and
        return the detached losses."""
        self.zero_grad(set_to_none=True)
        loss, aux = self.loss_given_tz(batch, t, z)
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

    def train_step(self, state: TrainState, batch: Batch,
                   generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """One optimizer step on `batch` with t and z from `generator`."""
        if state.model is not self:
            raise ValueError("train_step: the state belongs to another model")
        aux = self.compute_gradients(batch, *self.draw_tz(batch[0], generator))
        self.apply_update(state)
        return aux

    @torch.inference_mode()
    def enhance(
        self,
        y: torch.Tensor,
        N: int = 30,
        predictor: str = "reverse_diffusion",
        corrector: str = "none",
        corrector_steps: int = 1,
        snr: float = 0.5,
        probability_flow: bool = False,
        generator: Optional[torch.Generator] = None,
        noise: Optional[NoiseSource] = None,
        quant: Optional[Dict[str, Optional[Dict[str, float]]]] = None,
    ) -> Tuple[torch.Tensor, int]:
        """Enhance waveforms y (B, T) -> (x_hat (B, T), nfe).

        Defaults are the reference model's: N=30, reverse diffusion, no
        corrector. Noise comes from `noise` if given, else from `generator`.
        `quant`: {"denoiser": scales or None, "score": scales or None}, int8
        activation scales by conv module name from
        `models.quant.calibrate_storm`; the convs they name run on the int8
        path for the whole call (scales attached, and weights quantized
        from the float32 weights, once per call). The nets compute in their
        dtype with their parameters cast to it once per call; the
        spectrograms, the SDE and the output stay float32.
        """
        T_orig = y.shape[-1]
        y_n, norm = normalize_wav(y)
        Y, _ = prepare_spec(y_n, self.stft_config, self.transform)
        quant = quant or {}
        with cast_params(self.denoiser_net, self.denoiser_net.dtype), \
                cast_params(self.score_net, self.score_net.dtype), \
                scales_attached(self.denoiser_net, quant.get("denoiser") or {}), \
                scales_attached(self.score_net, quant.get("score") or {}):
            Y_denoised = self.forward_denoiser(Y)
            cond = self._conditioning(Y, Y_denoised)

            def score_fn(x, t, y_sde):
                return self.forward_score(x, t, cond)

            sample, n = pc_sample(
                self.sde, score_fn, Y_denoised, predictor=predictor, corrector=corrector,
                N=N, snr=snr, corrector_steps=corrector_steps,
                probability_flow=probability_flow, denoise=True, eps=self.t_eps,
                noise=noise, generator=generator,
            )
        # the whole padded spec goes through the iSTFT, cut to T_orig samples
        x_hat = spec_to_wav(sample, self.stft_config, self.transform, length=T_orig)
        return x_hat * norm, 1 + n
