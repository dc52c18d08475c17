"""int8 scale management and GaGNet's running statistics for the serving
CLIs (counterpart of storm_tpu/utils/serving.py).

Calibrate once on representative files, keep the scales beside the
checkpoint with the calibration configuration, and reuse them on later runs
with the same configuration; a mismatch recalibrates instead of serving
stale scales. The port's checkpoint is one `.pt` file, so the cache is
`<ckpt>.quant_int8_scales.json`, in the reference's file format. That file
outlives a checkpoint written anew at the same path (training rewrites
`last.pt` and `best_loss.pt` in place), so the configuration also holds a
digest of the weights served: new weights recalibrate. As in the reference,
the configuration holds no compute dtype: scales calibrated in float32
serve bfloat16 and back.

A GaGNet-BN checkpoint converted from the reference carries its BatchNorm
running statistics in a side file beside the `.pt`,
`<ckpt>.gagnet_batch_stats.json` (compat/convert.py writes it, in the JAX
package's format and flax paths); `load_gagnet_batch_stats` validates it
against the model and hands it to `enhance(batch_stats=...)`.
"""
from __future__ import annotations

import hashlib
import os
from typing import Callable, List, Optional

import numpy as np
import torch

from ..models import quant as quant_mod


def n_quantized(quant) -> int:
    """Quantized-conv count over StoRM's {net: scales or None}, or one net's
    scales, or None."""
    if quant_mod.per_net(quant):
        return sum(quant_mod.num_quantized_convs(v) for v in quant.values())
    return quant_mod.num_quantized_convs(quant)


def params_digest(model: torch.nn.Module) -> str:
    """sha256 over the model's state (names, shapes, dtypes and bytes)."""
    h = hashlib.sha256()
    for name, t in model.state_dict().items():
        h.update(f"{name}:{tuple(t.shape)}:{t.dtype};".encode())
        h.update(t.detach().reshape(-1).contiguous().cpu().view(torch.uint8).numpy())
    return h.hexdigest()


def scale_cache_path(ckpt: str) -> str:
    return f"{ckpt}.quant_int8_scales.json"


def batch_stats_path(ckpt: str) -> str:
    return f"{ckpt}.gagnet_batch_stats.json"


def load_gagnet_batch_stats(ckpt: str, model: torch.nn.Module):
    """The running statistics of the side file beside `ckpt`, validated
    against `model`'s norms (compat/torch_ckpt.validate_batch_stats: a
    corrupt or mis-pathed file raises ValueError) and on its device, in the
    form `model.enhance(batch_stats=...)` takes; None without a side file."""
    from ..compat.torch_ckpt import load_batch_stats, model_batch_stats, validate_batch_stats

    path = batch_stats_path(ckpt)
    if not os.path.exists(path):
        return None
    stats = load_batch_stats(path)
    validate_batch_stats(stats, model)
    print(f"BatchNorm running stats loaded from {path}")
    return model_batch_stats(stats, model, device=next(model.parameters()).device)


def calibrate_or_load_scales(
    model,
    mode: str,
    ckpt: str,
    calib_loader: Callable[[], List[np.ndarray]],
    generator: Optional[torch.Generator],
    *,
    N: int,
    min_channels: int,
    stream_chunk_s: float = 0.0,
    params_source: str = "ema",
    model_sr: int = 16000,
):
    """The int8 activation scales for serving `model` in `mode`: StoRM's or
    the distilled student's {net: scales or None}, or the score-only or
    denoiser-only net's scales.

    The first run calibrates on the waveforms `calib_loader()` returns
    ((T,) float32 arrays), padded to one length that is a multiple of 64
    hops, with noise from `generator`, and writes the cache with the
    calibration configuration; a later run whose configuration matches
    (parameters used and their digest, channel threshold, mode, streaming
    chunk length, calibration trajectory length) loads it. With
    `stream_chunk_s` > 0 the files are cut to one chunk's length first, so
    calibration runs at the streaming path's width, not the whole file's.
    StoRM and the score model calibrate along a trajectory of min(N, 10)
    steps, the denoiser on one forward and the distilled student on the
    denoiser's forward and 4 prior draws (calib_N 0 for both)."""
    if mode not in ("storm", "score-only", "denoiser-only", "distill"):
        raise ValueError(f"int8 calibration: unknown mode {mode!r}")
    single_net = mode not in ("storm", "distill")
    calib_meta = {
        "params": params_source,
        "min_channels": min_channels,
        "mode": mode,
        "stream_chunk_s": stream_chunk_s,
        # trajectory length the scales were integrated over: scales from an
        # --N 2 run must not be reused by an --N 50 run
        "calib_N": min(N, 10) if mode in ("storm", "score-only") else 0,
        # the weights themselves: a checkpoint rewritten at the same path
        # must not meet the scales of its predecessor
        "params_sha256": params_digest(model),
    }
    cache = scale_cache_path(ckpt)
    if os.path.exists(cache):
        try:
            quant, meta = quant_mod.load_scales_with_meta(cache, single_net)
        except ValueError:  # the other layout: scales of another mode's model
            quant, meta = None, None
        if meta is not None and all(meta.get(k) == v for k, v in calib_meta.items()):
            print(f"int8 scales loaded from {cache} ({n_quantized(quant)} convs quantized; 0 "
                  f"means every conv is below the {min_channels}-channel threshold and "
                  "serves in the model's compute dtype)")
            return quant
        print("int8 scale cache config mismatch — recalibrating")

    calib = calib_loader()
    hop = model.stft_config.hop_length
    L = max(y.shape[-1] for y in calib)
    if stream_chunk_s > 0:
        L = min(L, int(stream_chunk_s * model_sr))
        calib = [y[..., :L] for y in calib]
    L = -(-L // (64 * hop)) * (64 * hop)
    y_cal = np.stack([np.pad(y, [(0, 0)] * (y.ndim - 1) + [(0, L - y.shape[-1])])
                      for y in calib]).astype(np.float32)
    device = next(model.parameters()).device
    y_cal = torch.from_numpy(y_cal).to(device)
    if mode == "storm":
        quant = quant_mod.calibrate_storm(model, y_cal, N=min(N, 10), min_channels=min_channels,
                                          generator=generator)
    elif mode == "score-only":
        quant = quant_mod.calibrate_score_model(model, y_cal, N=min(N, 10),
                                                min_channels=min_channels, generator=generator)
    elif mode == "distill":  # the one state the student serves: the prior at t = T
        quant = quant_mod.calibrate_distill(model, y_cal, min_channels=min_channels,
                                            generator=generator)
    else:
        quant = quant_mod.calibrate_discriminative(model, y_cal, min_channels=min_channels)
    calib_meta = dict(calib_meta, calib_len=int(L), calib_files=len(calib))
    try:
        quant_mod.save_scales(cache, quant, meta=calib_meta)
        print(f"int8 calibration done ({n_quantized(quant)} convs quantized; scales saved "
              f"to {cache})")
    except OSError as e:  # a read-only checkpoint directory: still serve
        print(f"int8 calibration done (scales not saved: {e})")
    return quant
