"""Reference (flax) parameters -> the port's state_dict.

`params_from_jax` takes the reference model's parameter tree as nested dicts
of numpy arrays, `{"denoiser": ..., "score": ...}`, and returns the state_dict
of `StochasticRegenerationModel`. Flax module `m{i}` is `all_modules.{i}`;
layouts change as follows:

    conv kernel  (H, W, I, O)  -> weight (O, I, H, W)
    Dense kernel (I, O)        -> weight (O, I)
    GroupNorm scale / bias     -> weight / bias
    NIN W / b, Fourier W       -> unchanged

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
    elif name not in ("bias", "W", "b"):
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
    """{"denoiser": flax tree, "score": flax tree} -> StoRM state_dict."""
    leftover = set(tree) - set(_PREFIXES)
    if leftover:
        raise KeyError(f"params_from_jax: unexpected top-level keys {sorted(leftover)}")
    sd: Dict[str, torch.Tensor] = {}
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
