"""Reference (flax) parameters -> the port's state_dict.

`params_from_jax` takes the reference model's parameter tree as nested dicts
of numpy arrays, `{"denoiser": ..., "score": ...}` for StoRM or one net's
tree for the score-only and denoiser-only models, and returns the state_dict
of `StochasticRegenerationModel` (nets `denoiser_net`, `score_net`) or of
`ScoreModel` / `DiscriminativeModel` (net `dnn`). Flax module `m{i}` is
`all_modules.{i}`; layouts change as follows:

    conv kernel  (H, W, I, O)  -> weight (O, I, H, W)
    Dense kernel (I, O)        -> weight (O, I)
    GroupNorm scale / bias     -> weight / bias
    NIN W / b, Fourier W       -> unchanged
    Conv2d_0_weight (H, W, I, O) -> Conv2d_0_weight (O, I, H, W)  (FIR resamplers' convs)
    1-D conv kernels `*_w` (K, I, O) -> conv1d weight (O, I, K)   (ConvTasNet, encoder_w)
    decoder_w    (K, I, O)     -> conv_transpose1d weight (I, O, K), taps flipped
    `*_b`, Conv2d_0_bias, PReLU alpha, layer-norm gain -> unchanged

The decoders (ConvTasNet's, ae-ncsnpp's) are lhs-dilated correlations in
the reference and transposed convolutions here, hence the flip.

A GaGNet tree (top-level `en` and `gag_{i}`) maps by `GAGNET_RULES` onto the
reference's torch names, which the port's GaGNet carries: the gate convs'
`w`/`b` (H, W, I, O) -> `...conv[.1].weight` (O, I, H, W) (`.1` after the
causal pad when the kernel spans more than one frame), flax ConvTranspose
`kernel` (H, W, I, O) -> ConvTranspose2d weight (I, O, H, W) with the taps
flipped (flax correlates the dilated input, PyTorch convolves it), PReLU
`alpha` -> `weight`, norm `scale`/`bias` -> `...norm.weight`/`bias`, 1-D
kernels (K, I, O) -> (O, I, K). `batch_stats_from_jax` maps a flax
`batch_stats` tree ({norm path: {mean, var}}) onto the port's norm names.

`legacy_params_from_jax` carries a block of storm_tpu/nn/legacy.py (the
RefineNet blocks and norms that no model uses) onto nn/legacy.py's port.

Conversion is strict: a leaf it cannot map raises, and with `target` (a
module or state_dict) a missing, leftover or misshapen key raises too.

`module_name` and `flax_path` map a flax module path (`m5/Conv_0`) to the
port's module name (`all_modules.5.Conv_0`) and back, by the rule `_leaf`
uses for parameters; the int8 scale files (models/quant.py) key their
scales by flax path.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence, Tuple

import re

import numpy as np
import torch

_PREFIXES = {"denoiser": "denoiser_net", "score": "score_net"}


def module_name(path: Sequence[str]) -> str:
    """Flax module path -> the port's module name: ("m5", "Conv_0") ->
    "all_modules.5.Conv_0"."""
    mods = list(path)
    if mods and mods[0].startswith("m") and mods[0][1:].isdigit():
        mods = ["all_modules", mods[0][1:]] + mods[1:]
    return ".".join(mods)


def flax_path(name: str) -> Tuple[str, ...]:
    """Inverse of `module_name`: "all_modules.5.Conv_0" -> ("m5", "Conv_0")."""
    mods = name.split(".") if name else []
    if len(mods) >= 2 and mods[0] == "all_modules" and mods[1].isdigit():
        mods = [f"m{mods[1]}"] + mods[2:]
    return tuple(mods)


def _leaf(path, v: np.ndarray):
    """(flax path tuple, array) -> (torch dotted name, array)."""
    *mods, name = path
    mods = module_name(mods).split(".") if mods else []
    if name == "kernel" and v.ndim == 4:
        name, v = "weight", np.transpose(v, (3, 2, 0, 1))
    elif name == "kernel" and v.ndim == 2:
        name, v = "weight", v.T
    elif name == "scale" and v.ndim == 1:
        name = "weight"
    elif name == "Conv2d_0_weight" and v.ndim == 4:
        v = np.transpose(v, (3, 2, 0, 1))
    elif name == "decoder_w" and v.ndim == 3:
        v = np.transpose(v, (1, 2, 0))[:, :, ::-1]
    elif name.endswith("_w") and v.ndim == 3:
        v = np.transpose(v, (2, 1, 0))
    elif not (name in ("bias", "W", "b", "Conv2d_0_bias", "alpha", "gain")
              or (name.endswith("_b") and v.ndim == 1)):
        raise KeyError(f"params_from_jax: no mapping for {'/'.join(path)} {v.shape}")
    return ".".join(mods + [name]), v


_NORM = {"scale": "weight", "bias": "bias"}
_WB = {"w": "weight", "b": "bias"}
_TCM = {"in_conv_w": "in_conv.weight", "d_conv_w": "d_conv.3.weight",
        "out_conv_w": "out_conv.2.weight"}
_UNIT = r"(?:prelu/alpha|norm/(?:scale|bias))"

# (flax path regex, port name for the match): GaGNet's modules, the
# reference's torch names (storm_tpu/compat/torch_ckpt.py
# convert_gagnet_state_dict); `{gate}` is the gate conv's "conv" or "conv.1"
GAGNET_RULES = [(re.compile(rx), fn) for rx, fn in [
    (r"^(en)/(?:meta_unet_(\d+)/in_conv_|last_|unet_(\d+)_)gate/(w|b)$",
     lambda m: f"{_en_unit(m)}.0.{{gate}}.{_WB[m[4]]}"),
    (r"^(en)/(?:meta_unet_(\d+)/in_conv_|last_|unet_(\d+)_)(norm|prelu)/(scale|bias|alpha)$",
     lambda m: f"{_en_unit(m)}." + ("2.weight" if m[4] == "prelu" else f"1.norm.{_NORM[m[5]]}")),
    (r"^en/meta_unet_(\d+)/enco_(\d+)/(w|b)$",
     lambda m: f"en.meta_unet_list.{m[1]}.enco.{m[2]}.conv.0.{_WB[m[3]]}"),
    (r"^en/meta_unet_(\d+)/deco_(\d+)/deconv/(kernel|bias)$",
     lambda m: f"en.meta_unet_list.{m[1]}.deco.{m[2]}.deconv.0."
               + ("weight" if m[3] == "kernel" else "bias")),
    (rf"^en/meta_unet_(\d+)/(enco|deco)_(\d+)/{_UNIT}$",
     lambda m: f"en.meta_unet_list.{m[1]}.{m[2]}.{m[3]}."
               + ("conv" if m[2] == "enco" else "deconv") + "." + _norm_or_prelu(m[0])),
    (r"^gag_(\d+)/(glance_block|gaze_block)/in_gated/(main|gate)_(w|b)$",
     lambda m: f"gags.{m[1]}.{m[2]}.in_conv_{m[3]}" + (".0." if m[3] == "gate" else ".")
               + _WB[m[4]]),
    (r"^gag_(\d+)/(glance_block|gaze_block)/linear_(g|r|i)_(w|b)$",
     lambda m: f"gags.{m[1]}.{m[2]}.linear_{m[3]}" + (".0." if m[3] == "g" else ".")
               + _WB[m[4]]),
    (r"^gag_(\d+)/(glance_block|gaze_block)/(tcn_g|tcm_r|tcm_i|tcm_ri)_(\d+)/tcm_(\d+)/"
     r"(in_conv_w|d_conv_w|out_conv_w)$",
     lambda m: f"gags.{m[1]}.{m[2]}.{m[3]}.{m[4]}.tcns.{m[5]}.{_TCM[m[6]]}"),
    (r"^gag_(\d+)/(glance_block|gaze_block)/(tcn_g|tcm_r|tcm_i|tcm_ri)_(\d+)/tcm_(\d+)/"
     r"(d|out)_(prelu/alpha|norm/scale|norm/bias)$",
     lambda m: f"gags.{m[1]}.{m[2]}.{m[3]}.{m[4]}.tcns.{m[5]}.{m[6]}_conv."
               + _norm_or_prelu(m[7], 0)),
]]


def _en_unit(m) -> str:
    """The encoder's Sequential(gate conv, norm, PReLU) a rule matched."""
    if m[2] is not None:
        return f"en.meta_unet_list.{m[2]}.in_conv"
    return "en.last_conv" if m[3] is None else f"en.unet_list.{m[3]}"


def _norm_or_prelu(tail: str, prelu_index: int = 2) -> str:
    """"prelu/alpha" -> "{i}.weight", "norm/scale" -> "1.norm.weight"."""
    if tail.endswith("alpha"):
        return f"{prelu_index}.weight"
    return f"1.norm.{_NORM[tail.rsplit('/', 1)[1]]}"


def is_gagnet_tree(tree: Mapping[str, Any]) -> bool:
    """True for a flax GaGNet parameter (or batch_stats) tree."""
    return "en" in tree and any(k.startswith("gag_") for k in tree)


def gagnet_name(path: Sequence[str], gate_frames: int = 2) -> str:
    """A GaGNet flax parameter path -> the port's (the reference's torch)
    name; `gate_frames`: the kernel's frames of a gate conv's `w`/`b` (the
    causal pad shifts its conv to index 1 when > 1). KeyError if unknown."""
    key = "/".join(path)
    for rx, fn in GAGNET_RULES:
        m = rx.match(key)
        if m:
            return fn(m).replace("{gate}", "conv.1" if gate_frames > 1 else "conv")
    raise KeyError(f"params_from_jax: no GaGNet mapping for {key}")


def _gagnet_leaf(path, v: np.ndarray, gate_frames: int):
    """(flax path, array) -> (port name, array) in the port's layout."""
    name = gagnet_name(path, gate_frames)
    if path[-1] == "kernel":  # ConvTranspose (H, W, I, O) -> (I, O, H, W), taps flipped
        v = np.transpose(v[::-1, ::-1], (2, 3, 0, 1))
    elif v.ndim == 4:
        v = np.transpose(v, (3, 2, 0, 1))
    elif v.ndim == 3:
        v = np.transpose(v, (2, 1, 0))
    return name, v


def _flat(tree: Mapping[str, Any], path=()) -> Dict[Tuple[str, ...], Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flat(v, path + (k,)))
        else:
            out[path + (k,)] = v
    return out


def module_params_from_jax(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """Convert one flax module's parameter tree (no top-level split)."""
    out: Dict[str, torch.Tensor] = {}
    flat = _flat(tree)
    gagnet = is_gagnet_tree(tree)
    for path, v in flat.items():
        v = np.asarray(v, dtype=np.float32)
        if gagnet:
            w = flat.get(path[:-1] + ("w",))
            name, arr = _gagnet_leaf(path, v, 1 if w is None else np.shape(w)[0])
        else:
            name, arr = _leaf(path, v)
        out[prefix + name] = torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))
    return out


# a legacy block's flax module names -> the reference's torch names (nn/legacy.py)
_LEGACY_MODULES = [(re.compile(r"^conv_(\d+)$"), r"convs.\1"),
                   (re.compile(r"^adapt_(\d+)$"), r"adapt_convs.\1"),
                   (re.compile(r"^output$"), "output_convs")]


def legacy_params_from_jax(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """The parameters of a block of storm_tpu/nn/legacy.py -> the state_dict
    of its port in nn/legacy.py: modules `conv_{i}` -> `convs.{i}`,
    `adapt_{i}` -> `adapt_convs.{i}`, `output` -> `output_convs`; conv
    kernels (3, 3, I, O) -> weight (O, I, 3, 3); the class embedding `embed`
    -> `embed.weight`; bias, alpha, gamma, beta unchanged."""
    out: Dict[str, torch.Tensor] = {}
    for path, v in _flat(tree).items():
        mods = []
        for m in path[:-1]:
            for rx, repl in _LEGACY_MODULES:
                m = rx.sub(repl, m)
            mods.append(m)
        name, v = path[-1], np.asarray(v, dtype=np.float32)
        if name == "kernel" and v.ndim == 4:
            name, v = "weight", np.transpose(v, (3, 2, 0, 1))
        elif name == "embed":
            name = "embed.weight"
        elif name not in ("bias", "alpha", "gamma", "beta"):
            raise KeyError(f"legacy_params_from_jax: no mapping for {'/'.join(path)} {v.shape}")
        out[prefix + ".".join(mods + [name])] = torch.from_numpy(np.ascontiguousarray(v))
    return out


def norm_name(path: Sequence[str]) -> str:
    """A GaGNet flax norm module path (`en/last_norm`) -> the port's norm
    module name (`en.last_conv.1.norm`), whose running statistics it holds."""
    return gagnet_name(tuple(path) + ("scale",))[: -len(".weight")]


def batch_stats_from_jax(tree: Mapping[str, Any], device=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """One net's flax `batch_stats` tree ({norm path: {"mean", "var"}}) ->
    {port norm module name: {"mean", "var"}} float32 tensors on `device`,
    for `backbones.gagnet.stats_attached`."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for path, v in _flat(tree).items():
        if path[-1] not in ("mean", "var"):
            raise KeyError(f"batch_stats: leaf {'/'.join(path)} is neither mean nor var")
        out.setdefault(norm_name(path[:-1]), {})[path[-1]] = torch.as_tensor(
            np.asarray(v, np.float32), device=device)
    return out


def params_from_jax(tree: Mapping[str, Any], target=None) -> Dict[str, torch.Tensor]:
    """{"denoiser": flax tree, "score": flax tree} -> StoRM state_dict; a
    single net's flax tree (no such top-level keys) -> the state_dict of a
    model holding it as `dnn`."""
    if not set(tree) & set(_PREFIXES):
        sd = module_params_from_jax(tree, "dnn.")
    else:
        leftover = set(tree) - set(_PREFIXES)
        if leftover:
            raise KeyError(f"params_from_jax: unexpected top-level keys {sorted(leftover)}")
        sd = {}
        for key, prefix in _PREFIXES.items():
            if key in tree:
                sd.update(module_params_from_jax(tree[key], prefix + "."))
    if target is not None:
        check_state_dict(sd, target)
    return sd


def check_state_dict(sd: Mapping[str, torch.Tensor], target) -> None:
    """Raise unless `sd` has exactly the keys and shapes of `target`."""
    want = target.state_dict() if isinstance(target, torch.nn.Module) else target
    missing = sorted(set(want) - set(sd))
    extra = sorted(set(sd) - set(want))
    if missing or extra:
        raise KeyError(f"state_dict mismatch: missing {missing[:8]}, leftover {extra[:8]}")
    bad = [k for k in want if tuple(want[k].shape) != tuple(sd[k].shape)]
    if bad:
        raise ValueError("state_dict shape mismatch: " + ", ".join(
            f"{k} {tuple(sd[k].shape)} != {tuple(want[k].shape)}" for k in bad[:8]))
