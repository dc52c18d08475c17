"""Checkpoints as one `.pt` file: {config, params, ema_params} and, from the
trainer, {optimizer, step, meta}.

`config` is the flat model config (stored as JSON text), `params` and
`ema_params` are state_dicts of `StochasticRegenerationModel`, `optimizer`
the Adam state_dict, `step` the optimizer step count and `meta` (JSON text)
the training loop's state: epoch, best_valid, bad_epochs, best_loss,
best_quality and quality_metric. Loading
uses `torch.load(weights_only=True)`, which unpickles tensors and plain
containers only. `python -m storm_tpu_torch.enhancement` reads the first
three keys, so a trainer's checkpoint enhances as it is.

`CheckpointManager` keeps `last.pt`, `best_loss.pt` (lowest validation
loss) and `best_pesq.pt` (best in-training evaluation) in one directory, as
the reference's manager keeps `last`, `best_loss` and `best_pesq`.
"""
from __future__ import annotations

import json
import math
import os
import shutil
from typing import Any, Dict, Mapping, Optional, Tuple

import torch


def _to_host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def save_checkpoint(path: str, config: Mapping[str, Any],
                    params: Mapping[str, torch.Tensor],
                    ema_params: Optional[Mapping[str, torch.Tensor]] = None,
                    optimizer: Optional[Mapping[str, Any]] = None,
                    step: Optional[int] = None,
                    meta: Optional[Mapping[str, Any]] = None) -> None:
    """Write the checkpoint atomically; without `ema_params` the EMA weights
    are `params`. `optimizer` is an optimizer's state_dict."""
    payload = {
        "config": json.dumps(dict(config)),
        "params": _to_host(dict(params)),
        "ema_params": _to_host(dict(ema_params if ema_params is not None else params)),
    }
    if optimizer is not None:
        payload["optimizer"] = _to_host(optimizer)
    if step is not None:
        payload["step"] = int(step)
    if meta is not None:
        payload["meta"] = json.dumps(dict(meta))
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor],
                                        Dict[str, torch.Tensor]]:
    """(config, params, ema_params) from a checkpoint file."""
    ckpt = load_training_checkpoint(path)
    return ckpt["config"], ckpt["params"], ckpt["ema_params"]


def load_training_checkpoint(path: str) -> Dict[str, Any]:
    """Every key of a checkpoint, config and meta decoded; `optimizer`,
    `step` and `meta` are None where the checkpoint has none."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    return {
        "config": json.loads(payload["config"]),
        "params": payload["params"],
        "ema_params": payload["ema_params"],
        "optimizer": payload.get("optimizer"),
        "step": payload.get("step"),
        "meta": json.loads(payload["meta"]) if "meta" in payload else None,
    }


def _finite_or_none(v: Optional[float]) -> Optional[float]:
    return v if v is not None and math.isfinite(v) else None


class CheckpointManager:
    """Writes `last.pt` every epoch and copies it to `best_loss.pt` when the
    validation loss improves and to `best_pesq.pt` when the evaluation's
    quality improves (storm_tpu/ckpt.py:175-260).

    Quality is the mean PESQ where it is finite, else the mean ESTOI (PESQ
    is NaN without the `pesq` package); the first finite one names the
    run's metric, which the meta records as `quality_metric`, and a run
    whose metric changes midway raises ValueError, as the reference does.
    The tag stays `best_pesq` whichever metric drives it."""

    def __init__(self, ckpt_dir: str, config: Mapping[str, Any]):
        self.ckpt_dir = ckpt_dir
        self.config = dict(config)
        self.best_loss = math.inf
        self.best_quality = -math.inf
        self.quality_metric: Optional[str] = None  # "pesq" or "estoi", set by the first finite one
        os.makedirs(ckpt_dir, exist_ok=True)

    def path(self, tag: str) -> str:
        return os.path.join(self.ckpt_dir, f"{tag}.pt")

    def restore_from_meta(self, meta: Mapping[str, Any]) -> None:
        """Keep a resumed run's best loss and quality and its quality metric,
        so that a worse epoch never overwrites a better checkpoint."""
        if meta.get("best_loss") is not None:
            self.best_loss = float(meta["best_loss"])
        if meta.get("best_quality") is not None:
            self.best_quality = float(meta["best_quality"])
        self.quality_metric = meta.get("quality_metric")

    def step(self, state, valid_loss: float, epoch: int, bad_epochs: int,
             best_valid: float, pesq: Optional[float] = None,
             estoi: Optional[float] = None) -> None:
        """Save `state` (a models.base.TrainState) after `epoch`, with the
        epoch's evaluation (NaN or None where it did not run)."""
        if pesq is not None and math.isfinite(pesq):
            quality, metric = float(pesq), "pesq"
        elif estoi is not None and math.isfinite(estoi):
            quality, metric = float(estoi), "estoi"
        else:
            quality, metric = None, self.quality_metric
        if self.quality_metric is None:
            self.quality_metric = metric
        elif metric is not None and metric != self.quality_metric:
            raise ValueError(f"checkpoint quality metric changed mid-run: "
                             f"{self.quality_metric} -> {metric}")
        loss_improved = math.isfinite(valid_loss) and valid_loss < self.best_loss
        if loss_improved:
            self.best_loss = float(valid_loss)
        quality_improved = quality is not None and quality > self.best_quality
        if quality_improved:
            self.best_quality = quality
        meta = {"epoch": epoch, "bad_epochs": bad_epochs,
                "best_valid": _finite_or_none(best_valid),
                "best_loss": _finite_or_none(self.best_loss),
                "best_quality": _finite_or_none(self.best_quality),
                "quality_metric": self.quality_metric}
        last = self.path("last")
        save_checkpoint(last, self.config, state.model.state_dict(), state.ema,
                        optimizer=state.optimizer.state_dict(), step=state.step, meta=meta)
        for tag, improved in (("best_loss", loss_improved), ("best_pesq", quality_improved)):
            if improved:
                tmp = self.path(tag) + ".tmp"
                shutil.copyfile(last, tmp)
                os.replace(tmp, self.path(tag))
