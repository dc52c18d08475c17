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
`net.named_modules()`; StoRM's quant is {"denoiser": scales or None,
"score": scales or None}, and so is the distilled student's; the score-only
and denoiser-only models' quant is one net's scales or None. A scale file
keeps the reference's format, keys "<net>/<flax module path>/a_scale"
("denoiser/m5/Conv_0/a_scale") for StoRM and the student and "<flax module
path>/a_scale" for one net, so a file written by either package loads in the
other; `save_scales` and `load_scales_with_meta` are the only places that
convert.

    quant = calibrate_storm(model, y_batch, N=10, generator=gen)
    x_hat, nfe = model.enhance(y, quant=quant)
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


def per_net(quant) -> bool:
    """True for StoRM's {net: scales or None}, False for one net's scales."""
    return bool(quant) and set(quant) <= set(NETS)


def save_scales(path: str, quant, meta: Optional[Dict] = None) -> None:
    """Write StoRM's {net: scales or None}, or one net's scales, in the
    reference's format, {"_meta": meta, "scales": {"denoiser/m5/Conv_0/a_scale":
    float}} (one net: "m5/Conv_0/a_scale"), atomically (a temporary file,
    then os.replace)."""
    nets = quant.items() if per_net(quant) else [(None, quant)]
    flat = {"/".join(((net,) if net else ()) + flax_path(name) + ("a_scale",)):
            float(np.float32(v))
            for net, scales in nets for name, v in (scales or {}).items()}
    payload = {"_meta": dict(meta or {}), "scales": flat}
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def load_scales_with_meta(path: str, single_net: bool = False):
    """(scales or None, meta or None) from a scale file: StoRM's {net:
    scales}, or with `single_net` one net's scales. The scales are None when
    the file holds none; meta is None for the older format, whose whole file
    is the flat key -> scale map. A key of the other layout raises
    ValueError."""
    with open(path) as f:
        payload = json.load(f)
    if "_meta" in payload:
        meta, flat = payload.get("_meta", {}), payload.get("scales", {})
    else:
        meta, flat = None, payload
    quant: Dict = {}
    for key, v in flat.items():
        *mods, leaf = key.split("/")
        if single_net:
            if leaf != "a_scale" or not mods or mods[0] in NETS:
                raise ValueError(f"{path}: scale key {key!r} is not <module path>/a_scale "
                                 "of one net")
            quant[module_name(mods)] = float(np.float32(v))
            continue
        net, *mods = mods or [""]
        if net not in NETS or leaf != "a_scale" or not mods:
            raise ValueError(f"{path}: scale key {key!r} is not <net>/<module path>/a_scale "
                             f"with net one of {NETS}")
        quant.setdefault(net, {})[module_name(mods)] = float(np.float32(v))
    return quant or None, meta


def load_scales(path: str, single_net: bool = False):
    """Inverse of save_scales; None if the file holds no scales."""
    return load_scales_with_meta(path, single_net)[0]


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


def _score_trajectory_stats(model, y_sde: torch.Tensor, score_fn, N: int, num_probe: int,
                            noise: NoiseSource) -> Optional[Stats]:
    """Score-net calibration map along a sampling trajectory around the
    SDE's steady state `y_sde` (StoRM's D(Y), the score model's Y): the
    prior at t = T, then `num_probe` states of the reverse-diffusion
    trajectory (no corrector) spread over [T, t_eps]. `score_fn(x, t,
    collect_stats=False)` is the model's score, which with `collect_stats`
    returns (score, statistics). `noise` gives the prior's draw first, then
    the trajectory's."""
    B = y_sde.shape[0]
    device = y_sde.device
    xT = model.sde.prior_sampling(y_sde, noise(y_sde.shape[:-1]))
    _, traj, _ = pc_sample(model.sde, lambda x, t, y_: score_fn(x, t), y_sde,
                           predictor="reverse_diffusion", corrector="none", N=N, denoise=True,
                           eps=model.t_eps, noise=noise, intermediate=True)
    timesteps = np.linspace(model.sde.T, model.t_eps, N, dtype=np.float32)
    probes = [(xT, np.float32(model.sde.T))]
    probes += [(traj[i], timesteps[i])
               for i in np.unique(np.linspace(0, N - 1, num_probe).astype(int))]
    stats = None
    for x_i, t_i in probes:
        vec_t = torch.full((B,), float(t_i), dtype=torch.float32, device=device)
        stats = merge_stats(stats, score_fn(x_i, vec_t, collect_stats=True)[1])
    return stats


def _spec_of(model, y: torch.Tensor) -> torch.Tensor:
    """The compressed padded spec the model serves for waveforms y (B, T)."""
    y_n, _ = normalize_wav(y.to(torch.float32))
    return prepare_spec(y_n, model.stft_config, model.transform)[0]


def _noise(noise: Optional[NoiseSource], generator, Y: torch.Tensor) -> NoiseSource:
    return noise if noise is not None else generator_noise(generator, Y.device, Y.dtype)


@torch.inference_mode()
def calibrate_storm(model, y: torch.Tensor, N: int = 30, num_probe: int = 8,
                    min_channels: int = 128,
                    generator: Optional[torch.Generator] = None,
                    noise: Optional[NoiseSource] = None) -> Dict[str, Optional[Scales]]:
    """Int8 activation scales for a StochasticRegenerationModel from a
    waveform batch y (B, T) on the model's device: the denoiser's from one
    forward, the score net's along a trajectory of N steps around D(Y).
    Noise comes from `noise` if given, else from `generator`.

    Returns {"denoiser": scales or None, "score": scales or None} for
    `enhance(quant=...)`."""
    Y = _spec_of(model, y)
    Y_denoised, stats_d = model.forward_denoiser(Y, collect_stats=True)
    cond = model._conditioning(Y, Y_denoised)

    def score_fn(x, t, collect_stats=False):
        return model.forward_score(x, t, cond, collect_stats=collect_stats)

    stats_s = _score_trajectory_stats(model, Y_denoised, score_fn, N, num_probe,
                                      _noise(noise, generator, Y))
    return {
        "denoiser": scales_from_stats(stats_d, model.denoiser_net, min_channels),
        "score": scales_from_stats(stats_s, model.score_net, min_channels),
    }


@torch.inference_mode()
def calibrate_score_model(model, y: torch.Tensor, N: int = 50, num_probe: int = 8,
                          min_channels: int = 128,
                          generator: Optional[torch.Generator] = None,
                          noise: Optional[NoiseSource] = None) -> Optional[Scales]:
    """Int8 activation scales for a ScoreModel (SGMSE+) from a waveform batch
    y (B, T): its net's along a trajectory of N steps around Y, the noisy
    spec (storm_tpu/models/quant.py:247-267). Noise as in `calibrate_storm`.
    Returns the scales or None, for `enhance(quant=...)`."""
    Y = _spec_of(model, y)

    def score_fn(x, t, collect_stats=False):
        return model.score_apply(x, t, Y, collect_stats=collect_stats)

    stats = _score_trajectory_stats(model, Y, score_fn, N, num_probe,
                                    _noise(noise, generator, Y))
    return scales_from_stats(stats, model.dnn, min_channels)


@torch.inference_mode()
def calibrate_discriminative(model, y: torch.Tensor,
                             min_channels: int = 128) -> Optional[Scales]:
    """Int8 activation scales for a DiscriminativeModel from one forward on
    a waveform batch y (B, T) (storm_tpu/models/quant.py:321-332)."""
    _, stats = model(_spec_of(model, y), collect_stats=True)
    return scales_from_stats(stats, model.dnn, min_channels)


@torch.inference_mode()
def calibrate_distill(model, y: torch.Tensor, num_probe: int = 4, min_channels: int = 128,
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[NoiseSource] = None) -> Dict[str, Optional[Scales]]:
    """Int8 activation scales for a DistilledModel from a waveform batch y
    (B, T) (storm_tpu/models/quant.py:270-314). The student sees one
    diffusion state per request, the prior x_T = D(Y) + sigma(T) z at t = T,
    so the denoiser's statistics come from one forward and the student's
    from `num_probe` prior draws, each a fresh z from `noise` if given, else
    `generator`. Returns {"denoiser": scales or None, "score": scales or
    None} for `enhance(quant=...)`."""
    Y = _spec_of(model, y)
    Y_denoised, stats_d = model.storm.forward_denoiser(Y, collect_stats=True)
    cond = model.storm._conditioning(Y, Y_denoised)
    noise = _noise(noise, generator, Y)
    t_T = torch.full((Y.shape[0],), model.sde.T, dtype=torch.float32, device=Y.device)
    stats_s = None
    for _ in range(max(1, num_probe)):
        x_T, _ = model.prior(Y, Y_denoised, noise(Y.shape[:-1]))
        stats_s = merge_stats(stats_s, model.storm.forward_score(x_T, t_T, cond,
                                                                 collect_stats=True)[1])
    return {
        "denoiser": scales_from_stats(stats_d, model.denoiser_net, min_channels),
        "score": scales_from_stats(stats_s, model.score_net, min_channels),
    }
