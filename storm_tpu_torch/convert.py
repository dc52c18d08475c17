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

Conversion is strict: a leaf it cannot map raises, and with `target` (a
module or state_dict) a missing, leftover or misshapen key raises too.

`module_name` and `flax_path` map a flax module path (`m5/Conv_0`) to the
port's module name (`all_modules.5.Conv_0`) and back, by the rule `_leaf`
uses for parameters; the int8 scale files (models/quant.py) key their
scales by flax path.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence, Tuple

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


def module_params_from_jax(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """Convert one flax module's parameter tree (no top-level split)."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, path + (k,))
            else:
                name, arr = _leaf(path + (k,), np.asarray(v, dtype=np.float32))
                out[prefix + name] = torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))

    walk(tree, ())
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
