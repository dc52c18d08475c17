"""Model construction from a flat config dict (counterpart of storm_tpu/models/factory.py).

Takes the same config dicts as the reference (the JSON a checkpoint carries),
training keys included (lr, ema_decay, loss types, weighting, mode). This
builds every mode: the two StoRM modes, `score-only` (SGMSE+),
`denoiser-only` and `distill` (the one-step student on StoRM's nets, its
architecture the teacher's, with the `distill_*` keys), with the backbones
of the registry (backbones/__init__.py; the time-domain ones as denoisers)
and the OUVE or OUVP SDE,
computing in the config's `dtype`, "float32" (the default) or "bfloat16",
with float32 parameters. Another dtype, a conditioning the reference does
not know and a time-domain net of several spatial channels raise
NotImplementedError; an unknown mode or backbone raises ValueError.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
from torch import nn

from ..backbones import get_by_name
from ..nn.init import reset_parameters
from ..sde.sdes import SDES
from ..signal.stft import STFTConfig
from ..signal.transforms import SpecTransform
from .base import EnhancementModel, is_time_domain
from .discriminative import DiscriminativeModel
from .distill import DistilledModel
from .score import ScoreModel
from .storm import CONDITION_CHANNELS, STORM_MODES, StochasticRegenerationModel

# training keys of the config by mode; their defaults are the model's
TRAINING_KEYS = ("lr", "ema_decay", "loss_type_denoiser", "loss_type_score",
                 "weighting_denoiser_to_score")
SINGLE_NET_TRAINING_KEYS = ("lr", "ema_decay", "loss_type")
DISTILL_KEYS = ("distill_N", "distill_method", "distill_gt_weight")  # the student's own
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}  # the config's `dtype`
# --mode of the serving entry points -> the checkpoint modes it serves (enhancement.py:143-152)
MODES = {"score-only": ("score-only",), "denoiser-only": ("denoiser-only",),
         "storm": STORM_MODES, "distill": ("distill",)}
SERVING_MODES = tuple(MODES)


def check_checkpoint_mode(mode: str, config: Dict[str, Any]) -> None:
    """Exit with the reference's message unless the checkpoint's training
    mode is one that serving `--mode` runs."""
    ckpt_mode = config.get("mode", "regen-joint-training")
    if ckpt_mode not in MODES[mode]:
        raise SystemExit(f"--mode {mode} incompatible with checkpoint mode {ckpt_mode}")


def resolve_device(device) -> torch.device:
    """torch.device for `device`; a CUDA device must exist, and gets TF32 off
    so float32 matmuls and convolutions stay float32, and bfloat16 matmuls
    reduce in float32 (as XLA's do) instead of cuBLAS's reduced precision."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return device


def _backbone(name: str, time_domain_what: str = "", **kwargs) -> nn.Module:
    """The registered backbone `name` built from the config's keys that are
    its fields. A time-domain (`FORCE_STFT_OUT`) net takes one channel:
    other `spatial_channels` raise with the reference's message, which names
    `time_domain_what`."""
    net = get_by_name(name).from_kwargs(**kwargs)
    if is_time_domain(net) and int(kwargs.get("spatial_channels", 1)) != 1:
        raise NotImplementedError(f"time-domain {time_domain_what} support spatial_channels=1 only")
    return net


def _sde(name: str, cfg: Dict[str, Any]):
    """The SDE `name` from the config's keys that are its fields."""
    cls = SDES[name]
    return cls(**{f.name: cfg[f.name] for f in dataclasses.fields(cls) if f.name in cfg})


def backbones_of(config: Dict[str, Any]) -> Dict[str, str]:
    """The backbone of each net of the config's model, under its config key,
    as `build_model` resolves it (a one-net model falls back on the older
    `backbone` key)."""
    mode = config.get("mode", "regen-joint-training")
    one = {"denoiser-only": "backbone_denoiser", "score-only": "backbone_score"}.get(mode)
    if one is not None:
        return {one: config.get(one, config.get("backbone", "ncsnpp"))}
    return {k: config.get(k, "ncsnpp") for k in ("backbone_denoiser", "backbone_score")}


def build_model(config: Dict[str, Any], device="cuda", seed: int = 0) -> EnhancementModel:
    """Build the model of `config` on `device`, in eval mode (the trainer
    calls .train(); NCSN++'s dropout is 0, so both compute the same), with
    weights drawn from a generator seeded with `seed`: a
    StochasticRegenerationModel for the StoRM modes, a ScoreModel for
    `score-only`, a DiscriminativeModel for `denoiser-only`, a DistilledModel
    for `distill`."""
    device = resolve_device(device)
    cfg = dict(config)
    mode = cfg.pop("mode", "regen-joint-training")
    if mode not in STORM_MODES + ("score-only", "denoiser-only", "distill"):
        raise ValueError(f"Unknown mode {mode!r}")
    dtype = cfg.pop("dtype", "float32")
    if dtype not in DTYPES:
        raise NotImplementedError(f"dtype {dtype!r}: float32 and bfloat16 are ported")

    stft_config = STFTConfig(
        n_fft=cfg.pop("n_fft", 510),
        hop_length=cfg.pop("hop_length", 128),
        window=cfg.pop("window", "hann"),
    )
    transform = SpecTransform(
        factor=cfg.pop("spec_factor", 0.15),
        abs_exponent=cfg.pop("spec_abs_exponent", 0.5),
    )
    for k in ("ch_mult", "attn_resolutions", "fir_kernel"):
        if k in cfg:
            cfg[k] = tuple(cfg[k])
    if "sde_n" in cfg:
        cfg["N"] = cfg.pop("sde_n")
    front = dict(stft_config=stft_config, transform=transform)
    net_kwargs = dict(cfg, dtype=DTYPES[dtype])

    if mode == "denoiser-only":
        cfg.pop("backbone_score", None)
        backbone = cfg.pop("backbone_denoiser", cfg.pop("backbone", "ncsnpp"))
        training = {k: cfg.pop(k) for k in SINGLE_NET_TRAINING_KEYS if k in cfg}
        dnn = _backbone(backbone, "backbones", **{**net_kwargs, "discriminative": True})
        model = DiscriminativeModel(dnn, **front, **training)
    elif mode == "score-only":
        cfg.pop("backbone_denoiser", None)
        backbone = cfg.pop("backbone_score", cfg.pop("backbone", "ncsnpp"))
        training = {k: cfg.pop(k) for k in SINGLE_NET_TRAINING_KEYS if k in cfg}
        dnn = _backbone(backbone, **{**net_kwargs, "input_channels": 4,
                                     "discriminative": False})
        model = ScoreModel(dnn, _sde(cfg.pop("sde", "ouve"), cfg), **front,
                           t_eps=cfg.pop("t_eps", 0.03), **training)
    else:  # StoRM, and the distilled student on StoRM's nets (storm_tpu/models/factory.py:49-64)
        distill = {k: cfg.pop(k) for k in DISTILL_KEYS if k in cfg}
        condition = cfg.pop("condition", "both")
        if condition not in CONDITION_CHANNELS:
            raise NotImplementedError(
                f"Don't know the conditioning you have wished for: {condition}")
        training = {k: cfg.pop(k) for k in TRAINING_KEYS if k in cfg}
        denoiser = _backbone(cfg.pop("backbone_denoiser", "ncsnpp"), "denoisers",
                             **{**net_kwargs, "input_channels": 2, "discriminative": True})
        score = _backbone(cfg.pop("backbone_score", "ncsnpp"), **{
            **net_kwargs, "input_channels": 2 * (1 + CONDITION_CHANNELS[condition]),
            "discriminative": False})
        model = StochasticRegenerationModel(
            denoiser, score, _sde(cfg.pop("sde", "ouve"), cfg), **front,
            t_eps=cfg.pop("t_eps", 0.03), condition=condition,
            mode="regen-joint-training" if mode == "distill" else mode, **training)
        if mode == "distill":
            model = DistilledModel(model, lr=model.lr, ema_decay=model.ema_decay, **distill)
    reset_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()
