"""Score-only training and enhancement, SGMSE+ (counterpart of
storm_tpu/models/score.py).

One NCSN++ with 4 input channels scores x_t conditioned on the noisy spec Y:
score = -dnn(cat[x, Y], t). It is trained by denoising score matching
against an OU SDE (OUVE or OUVP) whose steady state is Y, and it samples
from the prior around Y, where StoRM's prior is centred on D(Y).

The net computes in its `dtype` with float32 parameters; its output is
float32, so the SDE, the loss, Adam and the EMA stay float32.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..backbones.gagnet import stats_attached
from ..nn.qconv import scales_attached, stats_collected
from ..sampling.samplers import DeepCache, NoiseSource
from ..sde.sdes import SDE
from ..signal import cplx
from ..signal.stft import STFTConfig
from ..signal.transforms import SpecTransform
from ..utils.tensors import right_pad_dims
from .base import (EnhancementModel, check_sampler, draw_tz, lift_spec, make_deepcache_fns,
                   nets_sharded, normalize_wav, per_example_sum, prepare_spec, run_sampler,
                   spec_to_wav)

LOSS_TYPES = ("mse", "mae")

Batch = Tuple[torch.Tensor, torch.Tensor]  # (clean X, noisy Y) specs (B, F, T, 2)


class ScoreModel(EnhancementModel):
    """Holds `dnn` (NCSN++, 4 input channels) with the SDE and the
    spectrogram front end; `enhance` is the whole inference path,
    `train_step` one optimizer step of denoising score matching."""

    NETS = ("dnn",)
    batch_reduction = "mean"  # the loss is the batch's mean (storm_tpu/models/score.py:133)

    def __init__(self, dnn: nn.Module, sde: SDE, stft_config: STFTConfig = STFTConfig(),
                 transform: SpecTransform = SpecTransform(), lr: float = 1e-4,
                 ema_decay: float = 0.999, t_eps: float = 0.03, loss_type: str = "mse"):
        super().__init__()
        if loss_type not in LOSS_TYPES:
            raise NotImplementedError(f"score-only loss_type {loss_type!r}: mse or mae")
        self.dnn = dnn
        self.sde = sde
        self.stft_config = stft_config
        self.transform = transform
        self.lr = lr
        self.ema_decay = ema_decay
        self.t_eps = t_eps
        self.loss_type = loss_type

    @staticmethod
    def _score_input(x: torch.Tensor, y: torch.Tensor) -> Tuple[torch.Tensor, bool]:
        """(cat[x, y] in the (B, D, F, T, 2) layout, whether x was lifted)."""
        x5, squeezed = lift_spec(x)
        return torch.cat([x5, lift_spec(y)[0]], dim=1), squeezed

    def score_apply(self, x: torch.Tensor, t: torch.Tensor, y: torch.Tensor,
                    collect_stats: bool = False):
        """score = -dnn(cat[x, y], t) for x, y (B, F, T, 2) or (B, D, F, T, 2);
        keeps x's shape. `collect_stats=True` returns (score, {conv module
        name: max|input|}), the calibration statistics of models/quant.py."""
        dnn_input, squeezed = self._score_input(x, y)
        with stats_collected(self.dnn) if collect_stats else contextlib.nullcontext() as stats:
            out = self.dnn(dnn_input, t)
        out = -(out[:, 0] if squeezed else out)
        return (out, stats) if collect_stats else out

    # --- loss / training (storm_tpu/models/score.py:129-188) ------------------

    def _per_example(self, batch: Batch, t: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """Each example's 0.5 * sum |err|^2 (or |err| for mae), (B,)."""
        x, y = batch
        mean, std = self.sde.marginal_prob(x, t, y)
        sigmas = right_pad_dims(std, x)
        err = self.score_apply(mean + sigmas * z, t, y) * sigmas + z
        return per_example_sum(torch.square(err) if self.loss_type == "mse" else cplx.cabs(err))

    per_example_given = _per_example

    def loss_given_tz(self, batch: Batch, t: torch.Tensor,
                      z: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """DSM loss with given diffusion times t (B,) and noise z (x-shaped,
        packed-real), the mean over the batch: (loss, {"loss"})."""
        loss = self._per_example(batch, t, z).mean()
        return loss, {"loss": loss}

    step_loss = loss_given_tz

    def draw_step(self, batch: Batch, generator: Optional[torch.Generator]):
        """t ~ U(t_eps, T) per example and standard complex normal z."""
        return draw_tz(self.sde, self.t_eps, batch[0], generator)

    def loss_fn(self, batch: Batch, generator: Optional[torch.Generator] = None):
        """`loss_given_tz` with t and z drawn from `generator`."""
        return self.loss_given_tz(batch, *self.draw_step(batch, generator))

    # --- enhancement (storm_tpu/models/score.py:190-343) ----------------------

    @torch.inference_mode()
    def enhance(
        self,
        y: torch.Tensor,
        N: int = 50,
        sampler_type: str = "pc",
        predictor: str = "reverse_diffusion",
        corrector: str = "ald",
        corrector_steps: int = 1,
        snr: float = 0.5,
        probability_flow: bool = False,
        generator: Optional[torch.Generator] = None,
        noise: Optional[NoiseSource] = None,
        quant: Optional[Dict[str, float]] = None,
        deepcache: int = 0,
        deepcache_depth: int = 1,
        method: str = "heun",
        rtol: float = 1e-5,
        atol: float = 1e-5,
        max_steps: int = 1000,
        sweeps: int = 8,
        batch_stats: Optional[Dict] = None,
        shards: Optional[Tuple[str, ...]] = None,
    ) -> Tuple[torch.Tensor, int]:
        """Enhance waveforms y (B, T) -> (x_hat (B, T), nfe).

        Defaults are the reference model's: N=50, reverse diffusion, ald.
        The samplers and their options are StoRM's (`StochasticRegeneration
        Model.enhance`), with the SDE's steady state and the prior's centre
        at Y, the noisy spec, and the score conditioned on Y. `quant`: int8
        activation scales of `dnn` by conv module name, from
        `models.quant.calibrate_score_model`. nfe counts score evaluations.
        `batch_stats`: the running statistics of a GaGNet-BN `dnn`, as in
        `StochasticRegenerationModel.enhance`.
        `shards`: the devices of a sequence-parallel group (the
        reference's `mesh=`): the NCSN++ nets run sharded along the frame
        axis over them (`base.nets_sharded`); None runs them whole.
        """
        check_sampler(self.dnn, sampler_type, deepcache, deepcache_depth, method)
        T_orig = y.shape[-1]
        y_n, norm = normalize_wav(y)
        Y, _ = prepare_spec(y_n, self.stft_config, self.transform)
        with self.cast_nets(), scales_attached(self.dnn, quant or {}), \
                stats_attached(self.dnn, batch_stats), nets_sharded(self, shards):
            def score_fn(x, t, y_sde):  # Picard's sweeps pass y_sde tiled to their rows
                return self.score_apply(x, t, y_sde)

            cache = None
            if deepcache:
                cache = DeepCache(deepcache, *make_deepcache_fns(
                    self.dnn, lambda x: self._score_input(x, Y), deepcache_depth))
            sample, nfe = run_sampler(
                self.sde, score_fn, Y, sampler_type, N=N, eps=self.t_eps, noise=noise,
                generator=generator, predictor=predictor, corrector=corrector,
                corrector_steps=corrector_steps, snr=snr, probability_flow=probability_flow,
                method=method, rtol=rtol, atol=atol, max_steps=max_steps, sweeps=sweeps,
                cache=cache)
        # the whole padded spec goes through the iSTFT, cut to T_orig samples
        x_hat = spec_to_wav(sample, self.stft_config, self.transform, length=T_orig)
        return x_hat * norm, nfe
