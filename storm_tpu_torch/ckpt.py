"""Checkpoints as one `.pt` file: {config, params, ema_params}.

`config` is the flat model config (stored as JSON text), `params` and
`ema_params` are state_dicts of `StochasticRegenerationModel`. Loading uses
`torch.load(weights_only=True)`, which unpickles tensors and plain containers
only.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional, Tuple

import torch


def save_checkpoint(path: str, config: Mapping[str, Any],
                    params: Mapping[str, torch.Tensor],
                    ema_params: Optional[Mapping[str, torch.Tensor]] = None) -> None:
    """Write the checkpoint; without `ema_params` the EMA weights are `params`."""
    def host(sd):
        return {k: v.detach().cpu() for k, v in sd.items()}

    payload = {
        "config": json.dumps(dict(config)),
        "params": host(params),
        "ema_params": host(ema_params if ema_params is not None else params),
    }
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor],
                                        Dict[str, torch.Tensor]]:
    """(config, params, ema_params) from a checkpoint file."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    return json.loads(payload["config"]), payload["params"], payload["ema_params"]
