"""Post-training int8 calibration for NCSN++ serving (counterpart of
storm_tpu/models/quant.py).

1. Collect each conv's max|input| (`QuantizableConv`'s calibration mode,
   nn/qconv.py) by running the model on real inputs. A score net's inputs
   depend on the diffusion time, so its statistics are gathered along a real
   sampling trajectory (the prior at t = T through the last step at t_eps).
2. Turn them into per-conv activation scales, a_scale = amax / 127, keeping
   only the convs whose input AND output channel counts are >= `min_channels`;
   the small ones (input, output and pyramid projections) stay float32.

Inside the port a net's statistics are {module name: 0-d tensor} and its
scales {module name: float32 value as a Python float}, the names of
`net.named_modules()`. A scale file keeps the reference's format, keys
"<net>/<flax module path>/a_scale" ("denoiser/m5/Conv_0/a_scale"), so a file
written by either package loads in the other; `save_scales` and
`load_scales_with_meta` are the only places that convert.

    quant = calibrate_storm(model, y_batch, N=10, generator=gen)
    x_hat, nfe = model.enhance(y, quant=quant)

`calibrate_score_model`, `calibrate_distill` and `calibrate_discriminative`
wait for the port of their models.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..convert import flax_path, module_name
from ..sampling.samplers import NoiseSource, generator_noise, pc_sample
from .base import normalize_wav, prepare_spec

Scales = Dict[str, float]  # {module name: a_scale} of one net
Stats = Dict[str, torch.Tensor]  # {module name: max|input|} of one net
NETS = ("denoiser", "score")


def save_scales(path: str, quant: Optional[Dict[str, Optional[Scales]]],
                meta: Optional[Dict] = None) -> None:
    """Write {net: scales or None} in the reference's format, {"_meta":
    meta, "scales": {"denoiser/m5/Conv_0/a_scale": float}}, atomically (a
    temporary file, then os.replace)."""
    flat = {"/".join((net,) + flax_path(name) + ("a_scale",)): float(np.float32(v))
            for net, scales in (quant or {}).items() for name, v in (scales or {}).items()}
    payload = {"_meta": dict(meta or {}), "scales": flat}
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def load_scales_with_meta(path: str):
    """({net: scales} or None, meta or None) from a scale file. The scales
    are None when the file holds none; meta is None for the older format,
    whose whole file is the flat key -> scale map."""
    with open(path) as f:
        payload = json.load(f)
    if "_meta" in payload:
        meta, flat = payload.get("_meta", {}), payload.get("scales", {})
    else:
        meta, flat = None, payload
    quant: Dict[str, Scales] = {}
    for key, v in flat.items():
        net, *mods, leaf = key.split("/")
        if net not in NETS or leaf != "a_scale" or not mods:
            raise ValueError(f"{path}: scale key {key!r} is not <net>/<module path>/a_scale "
                             f"with net one of {NETS}")
        quant.setdefault(net, {})[module_name(mods)] = float(np.float32(v))
    return quant or None, meta


def load_scales(path: str) -> Optional[Dict[str, Scales]]:
    """Inverse of save_scales; None if the file holds no scales."""
    return load_scales_with_meta(path)[0]


def merge_stats(a: Optional[Stats], b: Optional[Stats]) -> Optional[Stats]:
    """Elementwise max of two calibration maps over the same convs."""
    if a is None:
        return b
    if b is None:
        return a
    return {k: torch.maximum(v, b[k]) for k, v in a.items()}


def scales_from_stats(stats: Optional[Stats], net: nn.Module,
                      min_channels: int = 128) -> Optional[Scales]:
    """Calibration map -> scales: a_scale = max(amax, 1e-12) / 127 in
    float32, for each conv of `net` whose weight (O, I, kh, kw) has I >=
    min_channels and O >= min_channels. None if none qualifies."""
    if not stats:
        return None
    weights = dict(net.named_parameters())
    amax = torch.stack([v.reshape(()) for v in stats.values()]).float().cpu().numpy()
    scales = {}
    for name, a in zip(stats, amax):
        w = weights[name + ".weight"]
        if w.shape[1] >= min_channels and w.shape[0] >= min_channels:
            scales[name] = float(np.maximum(a, np.float32(1e-12)) / np.float32(127.0))
    return scales or None


def num_quantized_convs(scales: Optional[Scales]) -> int:
    """Count of convs that take the int8 path under one net's scales."""
    return len(scales or {})


def _score_trajectory_stats(model, Y_denoised: torch.Tensor, cond, N: int, num_probe: int,
                            noise: NoiseSource) -> Optional[Stats]:
    """Score-net calibration map along a sampling trajectory: the prior at
    t = T, then `num_probe` states of the reverse-diffusion trajectory (no
    corrector) spread over [T, t_eps]. `noise` gives the prior's draw first,
    then the trajectory's."""
    B = Y_denoised.shape[0]
    device = Y_denoised.device
    xT = model.sde.prior_sampling(Y_denoised, noise(Y_denoised.shape[:-1]))

    def score_fn(x, t, y_sde):
        return model.forward_score(x, t, cond)

    _, traj, _ = pc_sample(model.sde, score_fn, Y_denoised, predictor="reverse_diffusion",
                           corrector="none", N=N, denoise=True, eps=model.t_eps,
                           noise=noise, intermediate=True)
    timesteps = np.linspace(model.sde.T, model.t_eps, N, dtype=np.float32)
    probes = [(xT, np.float32(model.sde.T))]
    probes += [(traj[i], timesteps[i])
               for i in np.unique(np.linspace(0, N - 1, num_probe).astype(int))]
    stats = None
    for x_i, t_i in probes:
        vec_t = torch.full((B,), float(t_i), dtype=torch.float32, device=device)
        stats = merge_stats(stats, model.forward_score(x_i, vec_t, cond, collect_stats=True)[1])
    return stats


@torch.inference_mode()
def calibrate_storm(model, y: torch.Tensor, N: int = 30, num_probe: int = 8,
                    min_channels: int = 128,
                    generator: Optional[torch.Generator] = None,
                    noise: Optional[NoiseSource] = None) -> Dict[str, Optional[Scales]]:
    """Int8 activation scales for a StochasticRegenerationModel from a
    waveform batch y (B, T) on the model's device: the denoiser's from one
    forward, the score net's along a trajectory of N steps. Noise comes from
    `noise` if given, else from `generator`.

    Returns {"denoiser": scales or None, "score": scales or None} for
    `enhance(quant=...)`."""
    y_n, _ = normalize_wav(y.to(torch.float32))
    Y, _ = prepare_spec(y_n, model.stft_config, model.transform)
    Y_denoised, stats_d = model.forward_denoiser(Y, collect_stats=True)
    cond = model._conditioning(Y, Y_denoised)
    if noise is None:
        noise = generator_noise(generator, Y.device, Y.dtype)
    stats_s = _score_trajectory_stats(model, Y_denoised, cond, N, num_probe, noise)
    return {
        "denoiser": scales_from_stats(stats_d, model.denoiser_net, min_channels),
        "score": scales_from_stats(stats_s, model.score_net, min_channels),
    }
