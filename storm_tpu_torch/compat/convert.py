"""Convert a reference Lightning `.ckpt` into the port's `.pt` (counterpart
of storm_tpu/compat/convert.py).

    python -m storm_tpu_torch.compat.convert --ckpt storm_wsj0.ckpt \\
        --out storm_wsj0.pt --mode storm|score-only|denoiser-only [--set KEY=VALUE]

The model config is the checkpoint's hyperparameters where they name a
config key of the port (the JAX package's list, plus the chosen backbones'
own fields: GaGNet's `norm_type`, `c`, ...), then `--set` overrides
(values parsed as JSON, else kept as strings). The converted weights are
checked against the model `models/factory.build_model` builds from that
config on the CPU: a missing or misshapen parameter is an error; converted
parameters the model lacks (modules the reference builds and never runs)
are pruned with a notice. The `.pt` holds the raw and the EMA weights
(storm_tpu_torch/ckpt.py). A GaGNet-BN checkpoint's running statistics go
to the side file `<out>.gagnet_batch_stats.json` (the JAX package's format
and paths), which the enhancement and evaluation CLIs and the server load.
The `.ckpt` is unpickled in full: convert only checkpoints you trust.
"""
from __future__ import annotations

import argparse
import inspect
import json
from typing import Optional, Sequence

import torch

from ..backbones import get_by_name
from ..ckpt import save_checkpoint
from ..models.factory import backbones_of, build_model
from ..utils.serving import batch_stats_path
from .torch_ckpt import (NET_PREFIXES, convert_gagnet_batch_stats, load_reference_checkpoint,
                         save_batch_stats)

HPARAM_KEYS = [
    "backbone", "backbone_denoiser", "backbone_score", "sde", "lr",
    "ema_decay", "t_eps", "loss_type", "loss_type_denoiser",
    "loss_type_score", "weighting_denoiser_to_score", "condition",
    "spatial_channels", "n_fft", "hop_length", "window", "spec_factor",
    "spec_abs_exponent", "theta", "sigma_min", "sigma_max", "beta_min",
    "beta_max", "stiffness",
]


def _plain(v) -> bool:
    """A config value: a scalar, or a list of ints (`ch_mult`, `dilas`)."""
    if isinstance(v, (int, float, str, bool)):
        return True
    return isinstance(v, (list, tuple)) and all(isinstance(x, int) for x in v)


def reference_config(mode: str, hparams: dict, overrides: Sequence[str]) -> dict:
    """The port's model config of a reference checkpoint (module docstring)."""
    config = {"mode": {"storm": "regen-joint-training"}.get(mode, mode)}
    if mode == "storm" and hparams.get("mode"):
        config["mode"] = hparams["mode"]
    for k in HPARAM_KEYS:
        if k in hparams and _plain(hparams[k]):
            config[k] = hparams[k]
    for kv in overrides:
        if "=" not in kv:
            raise SystemExit(f"--set expects KEY=VALUE, got {kv!r}")
        k, v = kv.split("=", 1)
        try:
            config[k] = json.loads(v)
        except json.JSONDecodeError:
            config[k] = v
    fields = set()
    for name in backbones_of(config).values():
        try:
            fields |= set(inspect.signature(get_by_name(name).__init__).parameters)
        except ValueError:
            continue  # an unknown backbone: the factory reports it
    for k in sorted(fields - {"self", "dtype"} - set(config)):
        if k in hparams and _plain(hparams[k]):
            config[k] = list(hparams[k]) if isinstance(hparams[k], tuple) else hparams[k]
    return config


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", required=True, help="reference .ckpt file")
    ap.add_argument("--out", required=True, help="the port's .pt file to write")
    ap.add_argument("--mode", default="storm", choices=["storm", "score-only", "denoiser-only"])
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="config overrides")
    args = ap.parse_args(argv)

    raw = torch.load(args.ckpt, map_location="cpu", weights_only=False)
    params, ema, hparams = load_reference_checkpoint(args.ckpt, mode=args.mode, ckpt=raw)
    if not params:
        raise SystemExit(
            f"no parameters found under the expected prefixes for mode {args.mode!r} — is this "
            f"really a {args.mode} checkpoint? (storm checkpoints use denoiser_net./score_net., "
            "score-only and denoiser-only use dnn.)")
    config = reference_config(args.mode, hparams, args.set)

    expected = {k: tuple(v.shape) for k, v in build_model(config, device="cpu").state_dict().items()}
    got = {k: tuple(v.shape) for k, v in params.items()}
    missing = sorted(set(expected) - set(got))
    mismatched = sorted(k for k in set(expected) & set(got) if expected[k] != got[k])
    if missing or mismatched:
        detail = "".join([f"\n  missing: {k} {expected[k]}" for k in missing[:10]]
                         + [f"\n  shape: {k} expected {expected[k]} got {got[k]}"
                            for k in mismatched[:10]])
        raise SystemExit("converted parameters do not match the model built from the config "
                         "— architecture hparams (nf/ch_mult/image_size/...) likely differ; "
                         "pass them with --set key=value" + detail)
    extra = sorted(set(got) - set(expected))
    if extra:
        print(f"pruning {len(extra)} converted leaves with no counterpart in this model "
              f"(unused-by-forward reference modules), e.g. {extra[0]}")
        params = {k: v for k, v in params.items() if k in expected}
        ema = {k: v for k, v in ema.items() if k in expected}
    save_checkpoint(args.out, config, params, ema)

    # GaGNet-BN running statistics: one net's tree for dnn., {"denoiser",
    # "score"} for StoRM, as the JAX package's side file holds them
    sd = raw.get("state_dict", raw)
    stats = {}
    nets = {"dnn.": None} if args.mode != "storm" else {v: k for k, v in NET_PREFIXES.items()}
    for prefix, net in nets.items():
        bn = convert_gagnet_batch_stats(sd, prefix=prefix)
        if bn is None:
            continue
        if net is None:
            stats = bn
        else:
            stats[net] = bn
    if stats:
        path = batch_stats_path(args.out)
        save_batch_stats(path, stats)
        print(f"BatchNorm running stats saved to {path}")
    n = sum(v.numel() for v in params.values())
    print(f"converted {args.ckpt} -> {args.out} ({n / 1e6:.2f}M params, mode={config['mode']}); "
          f"model config: {json.dumps({k: v for k, v in config.items() if k != 'mode'})[:200]}")


if __name__ == "__main__":
    main()
