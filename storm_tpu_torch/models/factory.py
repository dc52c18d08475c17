"""Model construction from a flat config dict (counterpart of storm_tpu/models/factory.py).

Takes the same config dicts as the reference (the JSON a checkpoint carries),
training keys included (lr, ema_decay, loss types, weighting, mode). This
slice builds the two StoRM modes with NCSN++ backbones and the OUVE SDE,
computing in the config's `dtype`, "float32" (the default) or "bfloat16",
with float32 parameters; other choices raise NotImplementedError.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..backbones.ncsnpp import NCSNpp
from ..nn.init import reset_parameters
from ..sde.sdes import OUVESDE
from ..signal.stft import STFTConfig
from ..signal.transforms import SpecTransform
from .storm import CONDITION_CHANNELS, STORM_MODES, StochasticRegenerationModel

# training keys of the config; their defaults are StochasticRegenerationModel's
TRAINING_KEYS = ("lr", "ema_decay", "loss_type_denoiser", "loss_type_score",
                 "weighting_denoiser_to_score")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}  # the config's `dtype`
# --mode of the serving entry points, as the reference offers it
SERVING_MODES = ("score-only", "denoiser-only", "storm", "distill")


def refuse_unported_mode(mode: str) -> None:
    """Only `--mode storm` is served; the others raise, naming their item."""
    if mode != "storm":
        raise NotImplementedError(f"--mode {mode} is not ported yet (ROADMAP R3)")


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


def build_model(config: Dict[str, Any], device="cuda", seed: int = 0) -> StochasticRegenerationModel:
    """Build the StoRM model of `config` on `device`, in eval mode (the trainer
    calls .train(); NCSN++'s dropout is 0, so both compute the same), with
    weights drawn from a generator seeded with `seed`."""
    device = resolve_device(device)
    cfg = dict(config)
    mode = cfg.pop("mode", "regen-joint-training")
    if mode not in STORM_MODES:
        raise NotImplementedError(f"mode {mode!r} is not ported yet")
    for key in ("backbone_denoiser", "backbone_score"):
        if cfg.pop(key, "ncsnpp") != "ncsnpp":
            raise NotImplementedError(f"{key}: only ncsnpp is ported yet")
    if cfg.pop("sde", "ouve") != "ouve":
        raise NotImplementedError("sde: only ouve is ported yet")
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
    condition = cfg.pop("condition", "both")
    t_eps = cfg.pop("t_eps", 0.03)
    training = {k: cfg.pop(k) for k in TRAINING_KEYS if k in cfg}

    denoiser = NCSNpp.from_kwargs(**{**cfg, "input_channels": 2, "discriminative": True,
                                     "dtype": DTYPES[dtype]})
    score = NCSNpp.from_kwargs(**{
        **cfg, "input_channels": 2 * (1 + CONDITION_CHANNELS[condition]),
        "discriminative": False, "dtype": DTYPES[dtype],
    })
    sde = OUVESDE(**{k: cfg[k] for k in ("theta", "sigma_min", "sigma_max", "N") if k in cfg})
    model = StochasticRegenerationModel(
        denoiser, score, sde, stft_config=stft_config, transform=transform,
        t_eps=t_eps, condition=condition, mode=mode, **training,
    )
    reset_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()
