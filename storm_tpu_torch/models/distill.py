"""One-step distillation of StoRM's probability-flow ODE map (counterpart of
storm_tpu/models/distill.py).

The teacher's probability-flow ODE is a deterministic map x_T -> x_0 given
the conditioning [Y, D(Y)]. A student with the teacher's score-net
architecture, initialised from it, learns that map in one evaluation:

    x_T    = D(Y) + sigma(T) z                          (StoRM's prior)
    target = ODE_teacher(x_T; distill_N steps)          (no gradient)
    x0_hat = D(Y) + (x_T + sigma(T)^2 s(x_T, T) - D(Y)) / fac(T)
    loss   = 0.5 sum |x0_hat - target|^2  (+ distill_gt_weight 0.5 sum |x0_hat - x|^2)

summed over the batch, as StoRM's loss is. `fac(T)` is the SDE's marginal
mean factor, m(t) = y + fac(t)(x0 - y), so at initialisation the student's
output is the one-step posterior-mean (Tweedie) estimate. Serving costs the
denoiser and one student forward: NFE 2.

The nets are StoRM's, `denoiser_net` and `score_net`, with StoRM's
state_dict keys, so a teacher's weights load as they are and a distilled
checkpoint serves through the factory without its teacher. The denoiser
runs under `no_grad`: Adam's step on its zero gradient leaves it
bit-identical to the teacher's. The frozen teacher score net is not a
registered submodule: it is in neither the state_dict nor the optimizer.
Every forward of the teacher and the denoiser runs without a graph; in
bfloat16 the teacher holds bf16 copies of its cast parameters, made once,
and the loss, the targets, the ODE's arithmetic, Adam and the EMA stay
float32.
"""
from __future__ import annotations

import copy
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..nn.qconv import scales_attached
from ..sampling.samplers import NoiseSource, generator_noise, ode_sample
from ..sde.sdes import OUVESDE, OUVPSDE
from ..signal import cplx
from ..utils.tensors import right_pad_dims
from .base import EnhancementModel, normalize_wav, per_example_sum, prepare_spec, spec_to_wav
from .storm import StochasticRegenerationModel

DISTILL_METHODS = ("euler", "heun", "rk4", "etd1", "etd2")
DEEPCACHE_REFUSAL = ("distilled serving does not support --deepcache (there is no trajectory "
                     "whose steps could share cached features; NFE is already 2)")

Batch = Tuple[torch.Tensor, torch.Tensor]  # (clean X, noisy Y) specs (B, F, T, 2)


def _mean_factor(sde, t: float) -> float:
    """fac(t) of the marginal mean m(t) = y + fac(t)(x0 - y), in float32:
    exp(-theta t) for OUVE, exp(-s t (t (b1 - b0) + 2 b0) / 4) for OUVP."""
    if isinstance(sde, OUVESDE):
        arg = -sde.theta * t
    elif isinstance(sde, OUVPSDE):
        b0, b1, s = sde.beta_min, sde.beta_max, sde.stiffness
        arg = -0.25 * s * t * (t * (b1 - b0) + 2 * b0)
    else:
        raise NotImplementedError(type(sde).__name__)
    return float(np.exp(np.float32(arg)))


def refuse_deepcache(deepcache: int) -> None:
    """The reference's refusal of a deep-feature cache for the one-step student."""
    if deepcache:
        raise ValueError(DEEPCACHE_REFUSAL)


class DistilledModel(EnhancementModel):
    """A one-step student around a StoRM model: `storm` gives the nets, the
    SDE and the spectrogram front end (built from the teacher's config);
    `with_teacher` sets the frozen teacher score weights the loss needs."""

    NETS = ("denoiser_net", "score_net")
    batch_reduction = "sum"  # StoRM's reduction (storm_tpu/models/distill.py:103)

    def __init__(self, storm: StochasticRegenerationModel, distill_N: int = 8,
                 distill_method: str = "etd2", distill_gt_weight: float = 0.0,
                 lr: float = 1e-4, ema_decay: float = 0.999):
        super().__init__()
        if distill_method not in DISTILL_METHODS:
            raise ValueError(f"distill_method {distill_method!r}: one of {DISTILL_METHODS}")
        self.denoiser_net = storm.denoiser_net
        self.score_net = storm.score_net
        # StoRM's forwards and conditioning on the same nets; not a submodule,
        # so the nets are registered once, under StoRM's names
        object.__setattr__(self, "storm", storm)
        object.__setattr__(self, "teacher_net", None)
        self.distill_N = distill_N
        self.distill_method = distill_method
        self.distill_gt_weight = distill_gt_weight
        self.lr = lr
        self.ema_decay = ema_decay

    @property
    def sde(self):
        return self.storm.sde

    @property
    def stft_config(self):
        return self.storm.stft_config

    @property
    def transform(self):
        return self.storm.transform

    def with_teacher(self, teacher_score: Dict[str, torch.Tensor]) -> "DistilledModel":
        """Set the frozen teacher from its score net's state_dict (the keys of
        `score_net`, no prefix): a copy of `score_net` on its device, without
        gradients, whose cast parameters are in the compute dtype once for
        the run. Returns self."""
        teacher = copy.deepcopy(self.score_net)
        teacher.load_state_dict(teacher_score, strict=True)
        teacher.requires_grad_(False).eval()
        for m in teacher.modules():
            for name in getattr(m, "CAST_PARAMS", ()):
                p = getattr(m, name)
                if p is not None:
                    p.data = p.data.to(teacher.dtype)
        object.__setattr__(self, "teacher_net", teacher)
        return self

    def _require_teacher(self) -> None:
        if self.teacher_net is None:
            raise ValueError(
                "distillation loss needs teacher_score_params — build the model with "
                ".with_teacher(...) (train.py --mode distill does this from --teacher_ckpt)")

    # --- the one-step map and the loss (storm_tpu/models/distill.py:137-193) --

    def _student_x0(self, x_T: torch.Tensor, cond, std_T: torch.Tensor,
                    y_denoised: torch.Tensor, collect_stats: bool = False):
        """x0 from one student forward at t = T: m_hat = x_T + sigma_T^2 s
        (Tweedie's estimate of the marginal mean), inverted through
        m(T) = D(Y) + fac(T)(x0 - D(Y)). `collect_stats` also returns the
        score net's calibration statistics."""
        t = torch.full((x_T.shape[0],), self.sde.T, dtype=torch.float32, device=x_T.device)
        out = self.storm.forward_score(x_T, t, cond, collect_stats=collect_stats)
        s, stats = out if collect_stats else (out, None)
        m_hat = x_T + right_pad_dims(std_T, x_T) ** 2 * s
        x0 = y_denoised + (m_hat - y_denoised) / _mean_factor(self.sde, self.sde.T)
        return (x0, stats) if collect_stats else x0

    def prior(self, Y: torch.Tensor, Y_denoised: torch.Tensor,
              z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(x_T = D(Y) + sigma(T) z, sigma(T) per example)."""
        t_T = torch.full((Y.shape[0],), self.sde.T, dtype=torch.float32, device=Y.device)
        std_T = self.sde.marginal_prob(Y, t_T, Y_denoised)[1]
        return Y_denoised + right_pad_dims(std_T, Y) * z, std_T

    def draw_step(self, batch: Batch, generator: Optional[torch.Generator]):
        """The prior's standard complex normal z, x-shaped."""
        x = batch[0]
        return (cplx.complex_normal(x.shape[:-1], generator=generator, device=x.device),)

    def per_example_given_z(self, batch: Batch, z: torch.Tensor) -> torch.Tensor:
        """Each example's distillation loss (B,) for the prior draw z."""
        self._require_teacher()
        x, y = batch
        with torch.no_grad():
            y_denoised = self.storm.forward_denoiser(y)
            x_T, std_T = self.prior(x, y_denoised, z)
            cond = self.storm._conditioning(y, y_denoised)

            def teacher_score_fn(xt, t, y_sde):
                return self.storm.forward_score(xt, t, cond, net=self.teacher_net)

            # the teacher's endpoint of the same trajectory; x_init draws no noise
            target, _ = ode_sample(self.sde, teacher_score_fn, y_denoised, N=self.distill_N,
                                   method=self.distill_method, eps=self.storm.t_eps,
                                   x_init=x_T)
        x0_hat = self._student_x0(x_T, cond, std_T, y_denoised)
        per_ex = per_example_sum(torch.square(x0_hat - target))
        if self.distill_gt_weight > 0:
            B = x.shape[0]
            per_ex = per_ex + self.distill_gt_weight * 0.5 * torch.square(
                x0_hat - x).reshape(B, -1).sum(dim=-1)
        return per_ex

    def step_loss(self, batch: Batch, z: torch.Tensor):
        """The batch's summed loss for the prior draw z: (loss, {"loss"})."""
        loss = self.per_example_given_z(batch, z).sum()
        return loss, {"loss": loss}

    def loss_fn(self, batch: Batch, generator: Optional[torch.Generator] = None):
        """`step_loss` with z drawn from `generator`."""
        return self.step_loss(batch, *self.draw_step(batch, generator))

    def loss_per_example(self, batch: Batch,
                         generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Each example's loss (B,), for validation over ragged batches."""
        return self.per_example_given_z(batch, *self.draw_step(batch, generator))

    # --- serving (storm_tpu/models/distill.py:237-283) --------------------------

    @torch.inference_mode()
    def enhance(self, y: torch.Tensor, generator: Optional[torch.Generator] = None,
                noise: Optional[NoiseSource] = None,
                quant: Optional[Dict[str, Optional[Dict[str, float]]]] = None,
                deepcache: int = 0, **ignored_sampler_kwargs) -> Tuple[torch.Tensor, int]:
        """Enhance waveforms y (B, T) -> (x_hat (B, T), 2): the denoiser, one
        prior draw z (from `noise` if given, else `generator`), then the
        student's one-step map. The samplers' options are accepted and
        ignored, so the serving stack drives a distilled model unchanged.
        `quant`: {"denoiser": scales or None, "score": scales or None} from
        `models.quant.calibrate_distill`. `deepcache` is refused."""
        refuse_deepcache(deepcache)
        T_orig = y.shape[-1]
        y_n, norm = normalize_wav(y)
        Y, _ = prepare_spec(y_n, self.stft_config, self.transform)
        if noise is None:
            noise = generator_noise(generator, Y.device, Y.dtype)
        quant = quant or {}
        with self.cast_nets(), \
                scales_attached(self.denoiser_net, quant.get("denoiser") or {}), \
                scales_attached(self.score_net, quant.get("score") or {}):
            Y_denoised = self.storm.forward_denoiser(Y)
            x_T, std_T = self.prior(Y, Y_denoised, noise(Y.shape[:-1]))
            x0 = self._student_x0(x_T, self.storm._conditioning(Y, Y_denoised), std_T,
                                  Y_denoised)
        x_hat = spec_to_wav(x0, self.stft_config, self.transform, length=T_orig)
        return x_hat * norm, 2

