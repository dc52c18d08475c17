"""Predictive (denoiser-only) training and enhancement (counterpart of
storm_tpu/models/discriminative.py).

One discriminative NCSN++ maps the noisy spec to the clean one in a single
forward, x_hat = dnn(Y, t=1), trained with mse, mae or negative SI-SDR.
Its trained weights are the first stage that StoRM's `--pretrained_denoiser`
grafts. A time-domain backbone (ConvTasNet, ae-ncsnpp: `FORCE_STFT_OUT`)
takes and returns waveforms: a spec batch is turned into waveforms first and
its target compared in the time domain, a `return_time` batch (B, T) goes in
as it is, and `enhance` feeds it the normalized waveform
(storm_tpu/models/discriminative.py:78-220).

The net computes in its `dtype` with float32 parameters; its output, the
losses, Adam and the EMA are float32.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..backbones.gagnet import stats_attached
from ..nn.qconv import scales_attached, stats_collected
from ..signal import cplx
from ..signal.stft import STFTConfig
from ..signal.transforms import SpecTransform
from .base import (EnhancementModel, is_time_domain, lift_spec, nets_sharded, normalize_wav,
                   per_example_sum, prepare_spec, spec_to_wav)

LOSS_TYPES = ("mse", "mae", "sisdr")

Batch = Tuple[torch.Tensor, torch.Tensor]  # (clean X, noisy Y): specs (B, F, T, 2) or wavs (B, T)


def si_sdr(s: torch.Tensor, s_hat: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Scale-invariant SDR of each row of (B, n) signals in float32, (B,),
    as the reference's `si_sdr_jax` computes it per example."""
    s, s_hat = s.float(), s_hat.float()
    alpha = (s_hat * s).sum(-1) / ((s * s).sum(-1) + eps)
    e_target = alpha[:, None] * s
    e_res = s_hat - e_target
    return 10.0 * torch.log10(((e_target ** 2).sum(-1) + eps) / ((e_res ** 2).sum(-1) + eps))


class DiscriminativeModel(EnhancementModel):
    """Holds `dnn` (a discriminative NCSN++) with the spectrogram front end;
    `enhance` runs one forward, `train_step` one optimizer step."""

    NETS = ("dnn",)
    batch_reduction = "mean"  # storm_tpu/models/discriminative.py:175

    def __init__(self, dnn: nn.Module, stft_config: STFTConfig = STFTConfig(),
                 transform: SpecTransform = SpecTransform(), lr: float = 1e-4,
                 ema_decay: float = 0.999, loss_type: str = "mse"):
        super().__init__()
        if loss_type not in LOSS_TYPES:
            raise NotImplementedError(f"denoiser-only loss_type {loss_type!r}: mse, mae or sisdr")
        self.dnn = dnn
        self.stft_config = stft_config
        self.transform = transform
        self.lr = lr
        self.ema_decay = ema_decay
        self.loss_type = loss_type

    @property
    def force_stft_out(self) -> bool:
        return is_time_domain(self.dnn)

    def _spec_to_time(self, X: torch.Tensor) -> torch.Tensor:
        """A spec batch's waveforms of (frames - 1) * hop samples."""
        length = (X.shape[-2] - 1) * self.stft_config.hop_length
        return spec_to_wav(X, self.stft_config, self.transform, length=length)

    def forward(self, Y: torch.Tensor, collect_stats: bool = False):
        """x_hat = dnn(Y, t=1) for Y (B, F, T, 2) or (B, D, F, T, 2); keeps Y's
        shape (the reference's `apply`). A time-domain dnn gets Y's waveforms
        (a (B, T) Y is one already) and returns the time-domain estimate.
        `collect_stats=True` returns (x_hat, {conv module name: max|input|}),
        the calibration statistics of models/quant.py (none for a
        time-domain dnn)."""
        if self.force_stft_out:
            y_time = Y if Y.dim() == 2 else self._spec_to_time(Y)
            out = self.dnn(y_time, torch.ones(Y.shape[0], dtype=torch.float32, device=Y.device))
            return (out, {}) if collect_stats else out
        Y5, squeezed = lift_spec(Y)
        t = torch.ones(Y5.shape[0], dtype=torch.float32, device=Y5.device)
        with stats_collected(self.dnn) if collect_stats else contextlib.nullcontext() as stats:
            out = self.dnn(Y5, t)
        out = out[:, 0] if squeezed else out
        return (out, stats) if collect_stats else out

    # --- loss / training (storm_tpu/models/discriminative.py:149-191) ---------

    def per_example_given(self, batch: Batch) -> torch.Tensor:
        """Each example's loss (B,): 0.5 * sum |x - x_hat|^2 (mse), 0.5 * sum
        |x - x_hat| (mae), or -SI-SDR of the flattened packed-real specs
        (sisdr). A step draws nothing, so `loss_per_example` ignores its
        generator."""
        x, y = batch
        x_hat = self(y)
        if self.force_stft_out and x.dim() > 2:
            x = self._spec_to_time(x)  # a spec batch: compared in the time domain
        if self.loss_type == "sisdr":
            B = x.shape[0]
            return -si_sdr(x.reshape(B, -1), x_hat.reshape(B, -1))
        diff = x - x_hat
        if self.loss_type == "mse":
            return per_example_sum(torch.square(diff))
        return per_example_sum(torch.abs(diff) if self.force_stft_out else cplx.cabs(diff))

    def loss_fn(self, batch: Batch,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The mean of `loss_per_example` over the batch: (loss, {"loss"})."""
        loss = self.loss_per_example(batch).mean()
        return loss, {"loss": loss}

    step_loss = loss_fn

    # --- enhancement (storm_tpu/models/discriminative.py:193-231) -------------

    @torch.inference_mode()
    def enhance(self, y: torch.Tensor, quant: Optional[Dict[str, float]] = None,
                generator: Optional[torch.Generator] = None, noise=None,
                batch_stats: Optional[Dict] = None, shards: Optional[Tuple[str, ...]] = None,
                **ignored) -> Tuple[torch.Tensor, int]:
        """Enhance waveforms y (B, T) -> (x_hat (B, T), 1) in one forward.

        `quant`: int8 activation scales of `dnn` by conv module name, from
        `models.quant.calibrate_discriminative`. `batch_stats`: the running
        statistics of a GaGNet-BN `dnn` ({norm module name: {"mean", "var"}}),
        used by its BN norms in place of the batch's. Draws no noise: `generator`
        and `noise` are accepted and unused, and the samplers' options are
        ignored, as the reference's `**ignored_kwargs` are.
        `shards`: the devices of a sequence-parallel group (the
        reference's `mesh=`): the NCSN++ nets run sharded along the frame
        axis over them (`base.nets_sharded`); None runs them whole.
        A time-domain dnn runs whole."""
        T_orig = y.shape[-1]
        y_n, norm = normalize_wav(y)
        if self.force_stft_out:  # the waveform straight in
            with self.cast_nets():
                x_hat = self(y_n)
            return x_hat[..., :T_orig] * norm, 1
        Y, _ = prepare_spec(y_n, self.stft_config, self.transform)
        with self.cast_nets(), scales_attached(self.dnn, quant or {}), \
                stats_attached(self.dnn, batch_stats), nets_sharded(self, shards):
            X_hat = self(Y)
        x_hat = spec_to_wav(X_hat, self.stft_config, self.transform, length=T_orig)
        return x_hat * norm, 1
