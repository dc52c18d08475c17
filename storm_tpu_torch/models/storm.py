"""StoRM: predictive denoiser + score-based regeneration (counterpart of
storm_tpu/models/storm.py, inference only).

A denoiser D(Y) gives a first estimate; the reverse OUVE SDE then regenerates
clean speech starting from D(Y), with the score net conditioned on [Y, D(Y)].
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from ..sampling.samplers import NoiseSource, pc_sample
from ..sde.sdes import OUVESDE
from ..signal.stft import STFTConfig
from ..signal.transforms import SpecTransform
from .base import lift_spec, normalize_wav, prepare_spec, spec_to_wav

CONDITION_CHANNELS = {"noisy": 1, "post_denoiser": 1, "both": 2}


class StochasticRegenerationModel(nn.Module):
    """Holds `denoiser_net` and `score_net` (NCSN++) with the SDE and the
    spectrogram front end; `enhance` is the whole inference path."""

    def __init__(self, denoiser_net: nn.Module, score_net: nn.Module, sde: OUVESDE,
                 stft_config: STFTConfig = STFTConfig(),
                 transform: SpecTransform = SpecTransform(),
                 t_eps: float = 0.03, condition: str = "both"):
        super().__init__()
        if condition not in CONDITION_CHANNELS:
            raise NotImplementedError(
                f"Don't know the conditioning you have wished for: {condition}")
        self.denoiser_net = denoiser_net
        self.score_net = score_net
        self.sde = sde
        self.stft_config = stft_config
        self.transform = transform
        self.t_eps = t_eps
        self.condition = condition

    def forward_denoiser(self, Y: torch.Tensor) -> torch.Tensor:
        """D(Y) for Y (B, F, T, 2) or (B, D, F, T, 2); keeps Y's shape."""
        Y5, squeezed = lift_spec(Y)
        t = torch.ones(Y5.shape[0], dtype=torch.float32, device=Y5.device)
        out = self.denoiser_net(Y5, t)
        return out[:, 0] if squeezed else out

    def _conditioning(self, Y: torch.Tensor, Y_denoised: torch.Tensor) -> List[torch.Tensor]:
        return {"noisy": [Y], "post_denoiser": [Y_denoised],
                "both": [Y, Y_denoised]}[self.condition]

    def forward_score(self, x: torch.Tensor, t: torch.Tensor,
                      score_conditioning: List[torch.Tensor]) -> torch.Tensor:
        """score = -score_net(cat[x, *cond], t); keeps x's shape."""
        x5, squeezed = lift_spec(x)
        cond5 = [lift_spec(c)[0] for c in score_conditioning]
        out = self.score_net(torch.cat([x5] + cond5, dim=1), t)
        return -(out[:, 0] if squeezed else out)

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
    ) -> Tuple[torch.Tensor, int]:
        """Enhance waveforms y (B, T) -> (x_hat (B, T), nfe).

        Defaults are the reference model's: N=30, reverse diffusion, no
        corrector. Noise comes from `noise` if given, else from `generator`.
        """
        T_orig = y.shape[-1]
        y_n, norm = normalize_wav(y)
        Y, _ = prepare_spec(y_n, self.stft_config, self.transform)
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
