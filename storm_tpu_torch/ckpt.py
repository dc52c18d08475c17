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
the reference's manager keeps `last`, `best_loss` and `best_pesq`;
`AsyncCheckpointManager` writes the same files from a thread.

In data-parallel training only process 0 writes checkpoints (the trainer
makes its manager, and the manager's thread, there alone), and
`resume_training_state` reads one on process 0 and broadcasts it.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import threading
import traceback
import warnings
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch

from .utils.distributed import World, broadcast_


def _map_tensors(tree, fn: Callable[[torch.Tensor], Any]):
    """`tree` (dicts, lists and tuples) with `fn` applied to every tensor."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    return tree


def _to_host(tree):
    return _map_tensors(tree, lambda t: t.detach().cpu())


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


SIGNAL_KEYS = ("n_fft", "hop_length", "window", "spec_factor", "spec_abs_exponent")


def check_config(path: str, config: Mapping[str, Any]) -> None:
    """Warn when the config lacks a signal-processing field: the model would
    be rebuilt with the constructor's default for it (spec_factor 0.15
    where the trainer's default is 0.33) and serve wrong output without an
    error (storm_tpu/ckpt.py:125-145). The trainer writes them all; a
    hand-written or converted config may not."""
    missing = [k for k in SIGNAL_KEYS if k not in config]
    if missing:
        warnings.warn(
            f"checkpoint config {path} lacks {missing}; the model will be rebuilt with "
            "constructor defaults for these — if training used different values (train.py "
            "defaults differ: e.g. spec_factor 0.33 vs ctor 0.15), enhancement output will be "
            "silently wrong", stacklevel=3)


def load_training_checkpoint(path: str) -> Dict[str, Any]:
    """Every key of a checkpoint, config and meta decoded; `optimizer`,
    `step` and `meta` are None where the checkpoint has none. Warns
    (`check_config`) when the config lacks a signal-processing field."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    config = json.loads(payload["config"])
    check_config(path, config)
    return {
        "config": config,
        "params": payload["params"],
        "ema_params": payload["ema_params"],
        "optimizer": payload.get("optimizer"),
        "step": payload.get("step"),
        "meta": json.loads(payload["meta"]) if "meta" in payload else None,
    }


def resume_training_state(path: str, state, world: World = World()) -> Dict[str, Any]:
    """Resume `state` (a TrainState) from the trainer's checkpoint `path`, in
    place (the programs read the EMA and Adam's state where they are):
    parameters, EMA, Adam's state and the step count. Process 0 reads the
    file; every other process gets its tensors by broadcast and its meta
    (the loop's state) from process 0. Returns the meta ({} if the
    checkpoint has none). A checkpoint without optimizer state exits, on
    every process."""
    error, meta, step = None, None, None
    if world.is_main:
        ckpt = load_training_checkpoint(path)
        if ckpt["optimizer"] is None or ckpt["step"] is None:
            error = f"{path}: no optimizer state to resume from"
        else:
            state.model.load_state_dict(ckpt["params"], strict=True)
            for k, v in ckpt["ema_params"].items():
                state.ema[k].copy_(v)
            state.optimizer.load_state_dict(ckpt["optimizer"])
            meta, step = ckpt["meta"] or {}, ckpt["step"]
    error, meta, step = world.agree((error, meta, step))
    if error:
        raise SystemExit(error)
    opt = state.optimizer
    broadcast_([*state.model.state_dict().values(), *state.ema.values(),
                *(t for group in opt.param_groups for p in group["params"]
                  for _, t in sorted(opt.state[p].items()) if torch.is_tensor(t))], world)
    state.set_step(step)
    return meta


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
        self.write(training_payload(state), valid_loss=valid_loss, epoch=epoch,
                   bad_epochs=bad_epochs, best_valid=best_valid, pesq=pesq, estoi=estoi)

    def write(self, payload: Mapping[str, Any], valid_loss: float, epoch: int,
              bad_epochs: int, best_valid: float, pesq: Optional[float] = None,
              estoi: Optional[float] = None) -> None:
        """`step` for a `training_payload`: the policy, then the files."""
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
        save_checkpoint(last, self.config, payload["params"], payload["ema"],
                        optimizer=payload["optimizer"], step=payload["step"], meta=meta)
        for tag, improved in (("best_loss", loss_improved), ("best_pesq", quality_improved)):
            if improved:
                tmp = self.path(tag) + ".tmp"
                shutil.copyfile(last, tmp)
                os.replace(tmp, self.path(tag))


def training_payload(state) -> Dict[str, Any]:
    """What a checkpoint holds of a TrainState, by reference: params, EMA,
    optimizer state_dict, the host's step count."""
    return {"params": state.model.state_dict(), "ema": state.ema,
            "optimizer": state.optimizer.state_dict(), "step": state.step}


class AsyncCheckpointManager:
    """`CheckpointManager`'s saves, written while training goes on (the
    counterpart of storm_tpu/ckpt.py:271-326).

    `step` snapshots the state on the device, on the training stream
    (params, EMA, optimizer state and both step counts: a device-to-device
    copy, queued before the next step can change them), then returns; a
    thread copies the snapshot to pinned host memory on a side stream that
    waits on the snapshot's event, checks that the two step counts agree,
    and writes the files a synchronous save writes (`CheckpointManager.write`:
    the policy, `last.pt` and the tag copies). At most one save is in
    flight: `step` first waits for the previous one. A save's exception is
    re-raised by the next `step` or `wait`. Call `wait()` before reading the
    files or exiting; `close()` joins a save without raising (after an
    error elsewhere, which its exception must not mask)."""

    def __init__(self, mgr: CheckpointManager):
        self.mgr = mgr
        self._thread: Optional[threading.Thread] = None
        self._err: Optional[BaseException] = None
        self._stream = None

    @property
    def best_loss(self) -> float:
        return self.mgr.best_loss

    @property
    def quality_metric(self) -> Optional[str]:
        return self.mgr.quality_metric

    def path(self, tag: str) -> str:
        return self.mgr.path(tag)

    def restore_from_meta(self, meta: Mapping[str, Any]) -> None:
        self.mgr.restore_from_meta(meta)

    def step(self, state, **kwargs) -> None:
        """Snapshot `state` and save it from a thread, with `CheckpointManager.step`'s
        keywords."""
        self.wait()
        snapshot = dict(_map_tensors(training_payload(state), lambda t: t.detach().clone()),
                        device_step=state.device_step.clone())
        event = None
        if state.device_step.is_cuda:
            event = torch.cuda.Event()
            event.record()
            if self._stream is None:
                self._stream = torch.cuda.Stream(state.device_step.device)

        def run():
            try:
                host = snapshot
                if event is not None:
                    with torch.cuda.stream(self._stream):
                        self._stream.wait_event(event)
                        host = _map_tensors(snapshot, _pinned_copy)
                        self._stream.synchronize()  # after which the snapshot may go
                counted = int(host.pop("device_step"))
                if counted != host["step"]:
                    raise RuntimeError(f"the device counted {counted} steps, the host "
                                       f"{host['step']}")
                self.mgr.write(host, **kwargs)
            except BaseException as e:  # re-raised by the next step or wait
                self._err = e

        self._thread = threading.Thread(target=run, name="checkpoint-save")
        self._thread.start()

    def wait(self) -> None:
        """Join the save in flight; raise its exception, if it had one."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def close(self) -> None:
        """Join the save in flight; print its exception instead of raising it."""
        try:
            self.wait()
        except Exception:  # a failure elsewhere is already propagating
            traceback.print_exc()


def _pinned_copy(t: torch.Tensor) -> torch.Tensor:
    """A copy of the device tensor `t` into new pinned host memory, queued on
    the current stream."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host
