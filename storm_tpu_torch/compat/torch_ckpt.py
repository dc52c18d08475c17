"""Reference (Lightning) checkpoints -> the port's state_dicts (counterpart
of storm_tpu/compat/torch_ckpt.py, which maps them onto flax trees).

The reference's state_dict keys are resolved by role into the flax tree
that the JAX package builds from them (`_ncsnpp_tree`, `_convtasnet_tree`,
`_gagnet_tree`: the same rules as the JAX package's converters), then
mapped onto the port's names and layouts by `convert.module_params_from_jax`,
so both packages read one checkpoint into the same weights:

    torch                         the port
    ------------------------------------------------------------------
    all_modules.N.<param>         all_modules.N.<param>        (NCSN++)
    all_modules.N.Conv_0.weight   all_modules.N.Conv_0.weight
    all_modules.N.Conv2d_0.weight all_modules.N.Conv2d_0_weight (FIR convs)
    encoder/decoder.weight        encoder_w / decoder_w        (ae-ncsnpp)
    TCN.TCN.{i}.conv1d.weight     TCN.TCN_{i}.conv1d_w         (ConvTasNet)
    en.*, gags.*                  unchanged                    (GaGNet)

GaGNet's BatchNorm buffers (`running_mean`, `running_var`,
`num_batches_tracked`) are not parameters: `convert_gagnet_batch_stats`
extracts the running statistics as a flax-path tree, which
`save_batch_stats` writes as the JSON side file the JAX package writes and
reads too, and which `convert.batch_stats_from_jax` hands to the net.

EMA shadow parameters (torch-ema `shadow_params` under the checkpoint's
'ema', sgmse/model.py:86-95) are positional over the trainable parameters in
state_dict order; `convert_lightning_checkpoint` replays that order.
"""
from __future__ import annotations

import json
from typing import Any, Callable, Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch

from ..convert import batch_stats_from_jax, module_params_from_jax, norm_name

BN_BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def _to_np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _set(tree: Dict, path: Tuple[str, ...], value) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def _strip(sd: Mapping[str, Any], prefix: str) -> Iterable[Tuple[str, Any]]:
    """The items of `sd` under `prefix`, the prefix cut off."""
    for key, value in sd.items():
        if not prefix:
            yield key, value
        elif key.startswith(prefix):
            yield key[len(prefix):], value


def _conv1d(v):  # (O, I, W) -> (W, I, O)
    return np.transpose(v, (2, 1, 0))


def _conv2d(v):  # (O, I, H, W) -> (H, W, I, O)
    return np.transpose(v, (2, 3, 1, 0))


def _flipped_decoder(v):  # ConvTranspose1d (I, O, W) -> flipped (W, I, O)
    return np.ascontiguousarray(np.transpose(v, (2, 0, 1))[::-1])


def _convert_leaf(tail: str, v: np.ndarray):
    """One NCSN++ torch parameter -> (flax name, array)."""
    if tail == "weight":
        if v.ndim == 4:
            return "kernel", _conv2d(v)
        if v.ndim == 3:
            return "kernel", _conv1d(v)
        if v.ndim == 2:
            return "kernel", v.T
        if v.ndim == 1:
            return "scale", v
    if tail == "bias":
        return "bias", v
    return tail, v  # NIN W/b, the Fourier features' W


def _ncsnpp_tree(sd: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """A reference NCSN++ / ae-ncsnpp state_dict -> the JAX package's tree."""
    out: Dict[str, Any] = {}
    for key, value in _strip(sd, prefix):
        parts = key.split(".")
        v = _to_np(value)
        if parts == ["encoder", "weight"]:
            _set(out, ("encoder_w",), _conv1d(v))
            continue
        if parts == ["decoder", "weight"]:
            _set(out, ("decoder_w",), _flipped_decoder(v))
            continue
        if parts[0] == "all_modules":
            rest, path = parts[2:], [f"m{int(parts[1])}"]
        else:
            rest, path = parts[1:], [parts[0]]
        if len(rest) == 2 and rest[0] == "Conv2d_0":  # the FIR resamplers' flat conv
            if rest[1] == "weight":
                _set(out, tuple(path + ["Conv2d_0_weight"]), _conv2d(v))
            else:
                _set(out, tuple(path + ["Conv2d_0_bias"]), v)
            continue
        name, conv = _convert_leaf(rest[-1], v)
        _set(out, tuple(path + rest[:-1] + [name]), conv)
    return out


def _convtasnet_tree(sd: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """A reference ConvTasNet state_dict -> the JAX package's tree."""
    out: Dict[str, Any] = {}
    for key, value in _strip(sd, prefix):
        v = _to_np(value)
        if key == "encoder.weight":
            _set(out, ("encoder_w",), _conv1d(v))
            continue
        if key == "decoder.weight":
            _set(out, ("decoder_w",), _flipped_decoder(v))
            continue
        parts = key.split(".")
        if parts[0] != "TCN":
            raise ValueError(f"unexpected ConvTasNet key {key}")
        wb = "w" if parts[-1] == "weight" else "b"
        if parts[1] == "LN":
            _set(out, ("TCN", "LN", {"weight": "gain", "bias": "bias"}[parts[2]]), v)
        elif parts[1] == "BN":
            _set(out, ("TCN", f"BN_{wb}"), _conv1d(v) if wb == "w" else v)
        elif parts[1] == "output":  # Sequential(PReLU, Conv1d)
            if parts[2] == "0":
                _set(out, ("TCN", "output_prelu", "alpha"), v)
            else:
                _set(out, ("TCN", f"output_{wb}"), _conv1d(v) if wb == "w" else v)
        elif parts[1] == "TCN":
            blk = ("TCN", f"TCN_{int(parts[2])}")
            sub, leaf = parts[3], parts[4]
            if sub in ("conv1d", "dconv1d", "res_out", "skip_out"):
                _set(out, blk + (f"{sub}_{wb}",), _conv1d(v) if wb == "w" else v)
            elif sub in ("reg1", "reg2"):
                _set(out, blk + (sub, {"weight": "gain", "bias": "bias"}[leaf]), v)
            elif sub in ("nonlinearity1", "nonlinearity2"):
                _set(out, blk + (sub, "alpha"), v)
            else:
                raise ValueError(f"unexpected ConvTasNet key {key}")
        else:
            raise ValueError(f"unexpected ConvTasNet key {key}")
    return out


def _gagnet_unit(out: Dict, p, v, gate: Tuple[str, ...], norm: Tuple[str, ...],
                 prelu: Tuple[str, ...], index: str) -> None:
    """A reference Sequential(conv, NormSwitch, PReLU) entry at `index`."""
    if index == "0":
        _set(out, gate + ("w" if p[-1] == "weight" else "b",),
             _conv2d(v) if v.ndim == 4 else v)
    elif index == "1":
        _set(out, norm + ("scale" if p[-1] == "weight" else "bias",), v)
    else:
        _set(out, prelu + ("alpha",), v)


def _gagnet_tree(sd: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """A reference GaGNet state_dict -> the JAX package's tree, Sequential
    indices resolved by role; the BN buffers are skipped."""
    out: Dict[str, Any] = {}
    for key, value in _strip(sd, prefix):
        if key.split(".")[-1] in BN_BUFFERS:
            continue
        v = _to_np(value)
        p = key.split(".")
        wb = "w" if p[-1] == "weight" else "b"
        if p[0] == "en" and p[1] == "last_conv":
            _gagnet_unit(out, p, v, ("en", "last_gate"), ("en", "last_norm"),
                         ("en", "last_prelu"), p[2])
        elif p[0] == "en" and p[1] == "unet_list":
            u = f"unet_{int(p[2])}"
            _gagnet_unit(out, p, v, ("en", f"{u}_gate"), ("en", f"{u}_norm"),
                         ("en", f"{u}_prelu"), p[3])
        elif p[0] == "en" and p[1] == "meta_unet_list":
            mu = ("en", f"meta_unet_{int(p[2])}")
            if p[3] == "in_conv":
                _gagnet_unit(out, p, v, mu + ("in_conv_gate",), mu + ("in_conv_norm",),
                             mu + ("in_conv_prelu",), p[4])
            elif p[3] == "enco" and p[5] == "conv":
                blk = mu + (f"enco_{int(p[4])}",)
                _gagnet_unit(out, p, v, blk, blk + ("norm",), blk + ("prelu",), p[6])
            elif p[3] == "deco" and p[5] == "deconv":
                blk = mu + (f"deco_{int(p[4])}",)
                if p[6] == "0" and p[-1] == "weight":
                    # ConvTranspose2d (I, O, H, W) -> flax's (H, W, I, O), taps flipped
                    _set(out, blk + ("deconv", "kernel"), np.ascontiguousarray(
                        np.transpose(v, (2, 3, 0, 1))[::-1, ::-1]))
                elif p[6] == "0":
                    _set(out, blk + ("deconv", "bias"), v)
                else:
                    _gagnet_unit(out, p, v, blk, blk + ("norm",), blk + ("prelu",), p[6])
            else:
                raise ValueError(f"unexpected GaGNet key {key}")
        elif p[0] == "gags":
            blk = (f"gag_{int(p[1])}", p[2])  # glance_block / gaze_block
            sub = p[3]
            if sub in ("in_conv_main", "in_conv_gate"):
                name = "main" if sub == "in_conv_main" else "gate"
                _set(out, blk + ("in_gated", f"{name}_{wb}"), _conv1d(v) if v.ndim == 3 else v)
            elif sub in ("linear_g", "linear_r", "linear_i"):
                _set(out, blk + (f"{sub}_{wb}",), _conv1d(v) if v.ndim == 3 else v)
            elif sub in ("tcn_g", "tcm_r", "tcm_i", "tcm_ri"):
                # {sub}.{i}.tcns.{j}.<SqueezedTCM parameter>
                grp = blk + (f"{sub}_{int(p[4])}", f"tcm_{int(p[6])}")
                tail = p[7:]
                if tail[0] == "in_conv":
                    _set(out, grp + ("in_conv_w",), _conv1d(v))
                elif tail[0] in ("d_conv", "out_conv"):
                    stem = tail[0].split("_")[0]
                    if tail[1] == "0":
                        _set(out, grp + (f"{stem}_prelu", "alpha"), v)
                    elif tail[1] == "1":
                        _set(out, grp + (f"{stem}_norm",
                                         "scale" if tail[-1] == "weight" else "bias"), v)
                    else:  # the conv (after the pad in d_conv)
                        _set(out, grp + (f"{tail[0]}_w",), _conv1d(v))
                else:
                    raise ValueError(f"unexpected GaGNet key {key}")
            else:
                raise ValueError(f"unexpected GaGNet key {key}")
        else:
            raise ValueError(f"unexpected GaGNet key {key}")
    return out


def convert_backbone_state_dict(sd: Mapping[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """A reference NCSN++ (or ae-ncsnpp) state_dict, optionally under
    `prefix` ('dnn.', 'score_net.'), -> the port's net state_dict."""
    return module_params_from_jax(_ncsnpp_tree(sd, prefix))


def convert_convtasnet_state_dict(sd: Mapping[str, Any],
                                  prefix: str = "") -> Dict[str, torch.Tensor]:
    """A reference ConvTasNet state_dict -> the port's net state_dict."""
    return module_params_from_jax(_convtasnet_tree(sd, prefix))


def convert_gagnet_state_dict(sd: Mapping[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """A reference GaGNet state_dict -> the port's net state_dict (the same
    names; the running statistics left out)."""
    return module_params_from_jax(_gagnet_tree(sd, prefix))


def convert_gagnet_batch_stats(sd: Mapping[str, Any],
                               prefix: str = "") -> Optional[Dict[str, Any]]:
    """The BatchNorm running statistics of a GaGNet (norm_type "BN")
    state_dict as a flax-path tree {norm path: {"mean", "var"}} (numpy), or
    None when it has none (norm_type "IN"). Each `...running_mean` shares its
    module prefix with the norm's `...weight`, so the key is routed through
    the parameter mapping with a `weight` tail."""
    stats: Dict[str, Any] = {}
    for key, value in _strip(sd, prefix):
        tail = key.split(".")[-1]
        if tail not in ("running_mean", "running_var"):
            continue
        proxy = _gagnet_tree({key[: -len(tail)] + "weight": value})
        path, node = [], proxy
        while isinstance(node, dict):
            (k, node), = node.items()
            path.append(k)
        if path[-1] != "scale":
            raise ValueError(f"unexpected norm mapping for {key}")
        _set(stats, tuple(path[:-1]) + ("mean" if tail == "running_mean" else "var",),
             _to_np(value))
    return stats or None


def flatten_tree(tree: Mapping[str, Any], sep: str = "/") -> Dict[str, Any]:
    """{'a/b/c': leaf} of a nested string-keyed dict (the side files' paths)."""
    flat = {}

    def rec(node, prefix):
        for k, v in node.items():
            p = f"{prefix}{sep}{k}" if prefix else k
            if isinstance(v, Mapping):
                rec(v, p)
            elif v is not None:
                flat[p] = v

    rec(tree or {}, "")
    return flat


def unflatten_tree(flat: Mapping[str, Any], sep: str = "/") -> Dict[str, Any]:
    """Inverse of `flatten_tree`."""
    tree: Dict[str, Any] = {}
    for key, val in flat.items():
        _set(tree, tuple(key.split(sep)), val)
    return tree


def save_batch_stats(path: str, stats: Mapping[str, Any]) -> None:
    """Write a batch_stats tree as JSON, {'a/b/mean': [...]}, the JAX
    package's side file."""
    flat = {k: np.asarray(_to_np(v)).tolist() for k, v in flatten_tree(stats).items()}
    with open(path, "w") as f:
        json.dump(flat, f)


def load_batch_stats(path: str) -> Dict[str, Any]:
    """Inverse of `save_batch_stats`: a tree of float32 numpy arrays."""
    with open(path) as f:
        flat = json.load(f)
    return unflatten_tree({k: np.asarray(v, np.float32) for k, v in flat.items()})


NET_PREFIXES = {"denoiser": "denoiser_net.", "score": "score_net."}


def validate_batch_stats(stats: Mapping[str, Any], model: torch.nn.Module) -> None:
    """Fail fast on a corrupt or mis-pathed running-stats tree: every node
    with a mean or var holds both, of one shape, and its path ({"denoiser",
    "score"} first for StoRM's nets, else the net `dnn`'s) names a norm of
    `model` whose weight has that shape. ValueError names the path."""
    sd = model.state_dict()

    def walk(node, path):
        if not isinstance(node, Mapping):
            raise ValueError(f"batch_stats: unexpected leaf at {'/'.join(path)}")
        if "mean" in node or "var" in node:
            where = "/".join(path)
            if "mean" not in node or "var" not in node:
                raise ValueError(f"batch_stats at {where}: needs both mean and var, "
                                 f"found {sorted(node)}")
            m, v = np.shape(node["mean"]), np.shape(node["var"])
            if m != v:
                raise ValueError(f"batch_stats at {where}: mean shape {m} != var shape {v}")
            prefix, mods = ("dnn.", path) if not path or path[0] not in NET_PREFIXES else (
                NET_PREFIXES[path[0]], path[1:])
            try:
                weight = sd.get(f"{prefix}{norm_name(mods)}.weight")
            except KeyError:
                weight = None
            if weight is None or tuple(weight.shape) != tuple(m):
                raise ValueError(f"batch_stats path {where} does not resolve to a norm with "
                                 "a matching weight in the model: the stats tree is "
                                 "mis-pathed for this model")
            return
        for k, v in node.items():
            walk(v, path + (k,))

    walk(dict(stats), ())


def _iter_trainable_keys(sd: Mapping[str, Any]) -> Iterable[str]:
    """state_dict keys in order, without what torch-ema does not shadow: the
    frozen Fourier features' W (requires_grad False in the reference) and
    the BatchNorm buffers."""
    for key in sd:
        tail = key.split(".")[-1]
        if tail == "W" and "NIN" not in key:
            continue
        if tail in BN_BUFFERS:
            continue
        yield key


_TREES: Dict[str, Callable] = {"ncsnpp": _ncsnpp_tree, "gagnet": _gagnet_tree,
                               "convtasnet": _convtasnet_tree}


def _backbone_tree(backbone: str) -> Callable:
    for stem, fn in _TREES.items():
        if backbone.replace("-", "").startswith(stem) or (stem == "ncsnpp"
                                                          and "ncsnpp" in backbone):
            return fn
    raise ValueError(f"no converter for backbone {backbone!r}")


def convert_lightning_checkpoint(ckpt: Mapping[str, Any], prefix: str = "dnn.",
                                 backbone: str = "ncsnpp"
                                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """A loaded Lightning checkpoint ('state_dict' and optionally torch-ema's
    'ema' with its positional 'shadow_params') -> (params, ema_params), the
    port's state_dicts of the net under `prefix` ('dnn.' for the one-net
    models, 'denoiser_net.' / 'score_net.' for StoRM's); `backbone` routes
    to the converter (ncsnpp*, ae-ncsnpp, gagnet, convtasnet)."""
    tree = _backbone_tree(backbone)
    sd = ckpt["state_dict"] if "state_dict" in ckpt else ckpt
    params = module_params_from_jax(tree(sd, prefix))
    ema = ckpt.get("ema")
    if not ema or "shadow_params" not in ema:
        return params, params
    shadow = list(ema["shadow_params"])
    # torch-ema shadows every trainable parameter of the Lightning module in
    # parameters() order, which is state_dict order
    trainable = list(_iter_trainable_keys(sd))
    if len(shadow) != len(trainable):
        raise ValueError(f"EMA shadow length {len(shadow)} != trainable params {len(trainable)}")
    ema_sd = dict(sd)
    ema_sd.update(zip(trainable, shadow))
    return params, module_params_from_jax(tree(ema_sd, prefix))


def load_reference_checkpoint(path: str, mode: str = "storm", ckpt=None):
    """A reference Lightning .ckpt -> (params, ema_params, hparams): the
    port model's state_dicts (`denoiser_net.*` and `score_net.*` for
    'storm', `dnn.*` for 'score-only' and 'denoiser-only') and the
    checkpoint's hyper_parameters. `ckpt`: the checkpoint already loaded.
    The file is unpickled in full (`weights_only=False`: a Lightning file
    pickles its hyperparameters), so load only checkpoints you trust."""
    if ckpt is None:
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    hparams = dict(ckpt.get("hyper_parameters", {}))
    if mode == "storm":
        params, ema = {}, {}
        for net, prefix in NET_PREFIXES.items():
            p, e = convert_lightning_checkpoint(
                ckpt, prefix=prefix, backbone=hparams.get(f"backbone_{net}", "ncsnpp"))
            params.update({prefix + k: v for k, v in p.items()})
            ema.update({prefix + k: v for k, v in e.items()})
    else:
        p, e = convert_lightning_checkpoint(ckpt, prefix="dnn.",
                                            backbone=hparams.get("backbone", "ncsnpp"))
        params = {"dnn." + k: v for k, v in p.items()}
        ema = {"dnn." + k: v for k, v in e.items()}
    return params, ema, hparams


def model_batch_stats(stats: Optional[Mapping[str, Any]], model: torch.nn.Module, device=None):
    """A validated batch_stats tree -> what the model's `enhance` takes:
    {"denoiser": ..., "score": ...} for StoRM, one net's {norm module name:
    {"mean", "var"}} otherwise (`convert.batch_stats_from_jax`); None for
    None."""
    if stats is None:
        return None
    if any(k in NET_PREFIXES for k in stats):
        return {net: batch_stats_from_jax(stats[net], device) if stats.get(net) else None
                for net in NET_PREFIXES}
    return batch_stats_from_jax(stats, device)
