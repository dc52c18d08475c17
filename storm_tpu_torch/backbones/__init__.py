"""Score / denoiser backbones and their registry (counterpart of
storm_tpu/backbones/__init__.py and storm_tpu/utils/registry.py).

`get_by_name` resolves the reference's names for the model factory, the
trainer's `--backbone_denoiser` / `--backbone_score` and the bench's
`--backbone`: `ncsnpp`, `ncsnpplarge`, `ncsnpp12M`, `ncsnpp6M`,
`ae-ncsnpp`, `convtasnet`, `gagnet`.
"""
from __future__ import annotations

from typing import Dict, List

from .convtasnet import ConvTasNet
from .gagnet import GaGNet
from .ncsnpp import AutoEncodeNCSNpp, NCSNpp, NCSNpp6M, NCSNpp12M, NCSNppLarge


BACKBONES: Dict[str, type] = {
    "ncsnpp": NCSNpp,
    "ncsnpplarge": NCSNppLarge,
    "ncsnpp12M": NCSNpp12M,
    "ncsnpp6M": NCSNpp6M,
    "ae-ncsnpp": AutoEncodeNCSNpp,
    "convtasnet": ConvTasNet,
    "gagnet": GaGNet,
}


def get_by_name(name: str) -> type:
    """The backbone class registered as `name`; ValueError (with the names)
    for an unknown one."""
    if name in BACKBONES:
        return BACKBONES[name]
    raise ValueError(f"Backbone with name '{name}' unknown! Available: {sorted(BACKBONES)}")


def get_all_names() -> List[str]:
    return list(BACKBONES)
