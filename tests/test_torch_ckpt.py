"""Checkpoints on the CPU: `AsyncCheckpointManager` (storm_tpu_torch/ckpt.py,
the counterpart of storm_tpu/ckpt.py:271-326) writes the files a
synchronous `CheckpointManager` writes, re-raises a save's exception, and a
run resumed from its `last.pt` equals one resumed from a synchronous one;
`--pretrained_denoiser` / `--pretrained_score` (train.py:396-419) graft a
net's parameters (not its EMA) from a StoRM or a one-net checkpoint into
both the parameters and the EMA of a StoRM model, leave the other net as it
was, and raise for any other model. Tiny nets (nf 8 or 16, n_fft 62)."""
import math
import os
import threading

import pytest
import torch

from storm_tpu_torch import train
from storm_tpu_torch.ckpt import (AsyncCheckpointManager, CheckpointManager,
                                  load_training_checkpoint, save_checkpoint)
from storm_tpu_torch.models.base import init_train_state
from storm_tpu_torch.models.factory import build_model
from storm_tpu_torch.utils.train_graphs import TrainPrograms

from test_torch_train import TRAIN_ARGS, _run, _write_corpus
from test_torch_train_graphs import TINY, gen, tiny, wav_batch

EPOCH = dict(valid_loss=3.0, epoch=0, bad_epochs=0, best_valid=3.0, pesq=math.nan, estoi=0.4)


def trained_state(steps=2):
    """A tiny StoRM's train state after `steps` steps (Adam's moments set)."""
    model = tiny("storm")
    state = init_train_state(model, model.lr)
    programs = TrainPrograms(state)
    for i in range(steps):
        programs.step(wav_batch(i), gen(i))
    return state


def assert_same_checkpoint(a: str, b: str):
    got, want = load_training_checkpoint(a), load_training_checkpoint(b)
    assert got.keys() == want.keys()
    assert (got["config"], got["step"], got["meta"]) == (want["config"], want["step"],
                                                           want["meta"])
    for key in ("params", "ema_params"):
        assert got[key].keys() == want[key].keys()
        for name, w in want[key].items():
            assert torch.equal(got[key][name], w), (key, name)
    go, wo = got["optimizer"], want["optimizer"]
    assert go["param_groups"] == wo["param_groups"] and go["state"].keys() == wo["state"].keys()
    for i, s in wo["state"].items():
        assert all(torch.equal(go["state"][i][k], v) for k, v in s.items()), i


def test_async_save_writes_what_a_synchronous_save_writes(tmp_path):
    state = trained_state()
    sync = CheckpointManager(str(tmp_path / "sync"), {"nf": 16})
    asyn = AsyncCheckpointManager(CheckpointManager(str(tmp_path / "async"), {"nf": 16}))
    for epoch, loss in enumerate((3.0, 2.0)):
        kw = dict(EPOCH, epoch=epoch, valid_loss=loss, best_valid=loss)
        sync.step(state, **kw)
        asyn.step(state, **kw)
        asyn.wait()
    assert sorted(os.listdir(tmp_path / "async")) == sorted(os.listdir(tmp_path / "sync")) == [
        "best_loss.pt", "best_pesq.pt", "last.pt"]
    for tag in ("last", "best_loss", "best_pesq"):
        assert_same_checkpoint(asyn.path(tag), sync.path(tag))
    assert (asyn.best_loss, asyn.quality_metric) == (sync.best_loss, sync.quality_metric)


def test_async_save_snapshots_before_training_goes_on(tmp_path):
    """The snapshot is taken at `step`: a later change of the parameters
    (here while the save's thread is held) is not in the file."""
    state = trained_state(1)
    mgr = AsyncCheckpointManager(CheckpointManager(str(tmp_path), {"nf": 16}))
    want = {k: v.clone() for k, v in state.model.state_dict().items()}
    gate = threading.Event()
    real = CheckpointManager.write

    def held(self, *a, **k):
        assert gate.wait(60)
        return real(self, *a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(CheckpointManager, "write", held)
        mgr.step(state, **EPOCH)
        with torch.no_grad():
            for p in state.model.parameters():
                p.add_(1.0)
        gate.set()
        mgr.wait()
    params = load_training_checkpoint(mgr.path("last"))["params"]
    assert all(torch.equal(params[k], v) for k, v in want.items())


@pytest.mark.parametrize("then", ["wait", "step"])
def test_a_failed_save_is_raised_by_the_next_call(tmp_path, then):
    state = trained_state(1)
    mgr = AsyncCheckpointManager(CheckpointManager(str(tmp_path), {"nf": 16}))

    def broken(self, *a, **k):
        raise OSError("disk full")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(CheckpointManager, "write", broken)
        mgr.step(state, **EPOCH)
        with pytest.raises(OSError, match="disk full"):
            if then == "wait":
                mgr.wait()
            else:
                mgr.step(state, **EPOCH)
    mgr.wait()  # raised once: nothing pending
    mgr.step(state, **EPOCH)  # the policy's own error, raised from the thread
    mgr.wait()
    with pytest.raises(ValueError, match="metric changed"):
        mgr.step(state, **dict(EPOCH, pesq=3.0))
        mgr.wait()


def test_resume_from_an_async_last_pt_equals_one_from_a_synchronous_one(tmp_path):
    """One epoch through the CLI (its `last.pt` written by the async
    manager), the same state written again synchronously, then a second
    epoch resumed from each: the same checkpoint, bit for bit."""
    root = _write_corpus(tmp_path / "corpus", n_train=4, n_valid=2)
    base = TRAIN_ARGS + ["--base_dir", root, "--device", "cpu"]
    first = tmp_path / "first"
    train.main(base + ["--max_epochs", "1", "--log_dir", str(first)])
    ckpt = load_training_checkpoint(str(_run(first) / "checkpoints" / "last.pt"))
    sync_dir = tmp_path / "sync"
    sync_dir.mkdir()
    save_checkpoint(str(sync_dir / "last.pt"), ckpt["config"], ckpt["params"],
                    ckpt["ema_params"], optimizer=ckpt["optimizer"], step=ckpt["step"],
                    meta=ckpt["meta"])
    ends = []
    for name, src in (("from_async", _run(first) / "checkpoints" / "last.pt"),
                      ("from_sync", sync_dir / "last.pt")):
        logs = tmp_path / name
        train.main(base + ["--max_epochs", "2", "--log_dir", str(logs),
                           "--resume_from_checkpoint", str(src)])
        ends.append(str(_run(logs) / "checkpoints" / "last.pt"))
    assert load_training_checkpoint(ends[0])["step"] == 4
    assert_same_checkpoint(*ends)


def _source(tmp_path, name, config, seed):
    """A checkpoint of `config` with seeded weights, and an EMA that differs
    from them (the graft takes the parameters)."""
    model = build_model(dict(config), device="cpu", seed=seed)
    params = model.state_dict()
    ema = {k: v + 1.0 for k, v in params.items()}
    path = str(tmp_path / f"{name}.pt")
    save_checkpoint(path, dict(config), params, ema)
    return path, params


@pytest.mark.parametrize("net", ["denoiser_net", "score_net"])
@pytest.mark.parametrize("source", ["storm", "one-net"])
def test_graft_sets_the_net_and_its_ema(tmp_path, net, source):
    """From a StoRM checkpoint the net of the same name; from a one-net
    checkpoint its `dnn` (denoiser-only for the denoiser, score-only for the
    score net of a StoRM conditioned on the noisy spec, which takes the
    same 4 input channels)."""
    storm = dict(TINY, mode="regen-joint-training", condition="noisy")
    one_net = dict(TINY, mode="denoiser-only" if net == "denoiser_net" else "score-only")
    path, src = _source(tmp_path, source, storm if source == "storm" else one_net, seed=5)
    prefix = f"{net}." if source == "storm" else "dnn."
    model = build_model(storm, device="cpu", seed=0).train()
    state = init_train_state(model, model.lr)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    train.graft_pretrained(state, path, net)
    for k, v in model.state_dict().items():
        if k.startswith(f"{net}."):
            want = src[prefix + k[len(net) + 1:]]
            assert torch.equal(v, want) and torch.equal(state.ema[k], want), k
        else:
            assert torch.equal(v, before[k]) and torch.equal(state.ema[k], before[k]), k


@pytest.mark.parametrize("mode", ["score-only", "denoiser-only-sisdr", "distill"])
def test_graft_into_a_model_that_is_not_storm_raises(tmp_path, mode):
    path, _ = _source(tmp_path, "storm", dict(TINY), seed=5)
    state = init_train_state(tiny(mode), 1e-4)
    with pytest.raises(ValueError, match="StoRM"):
        train.graft_pretrained(state, path, "score_net")


def test_cli_grafts_and_refuses(tmp_path, capsys):
    """The CLI grafts both nets (the run's first checkpoint starts from
    them: its EMA after one step is near the sources'), and refuses a
    graft into score-only."""
    root = _write_corpus(tmp_path / "corpus", n_train=2, n_valid=1)
    cfg = {"nf": 8, "ch_mult": [1, 2], "n_fft": 62, "hop_length": 16}
    path, src = _source(tmp_path, "storm", dict(cfg, mode="regen-joint-training"), seed=7)
    base = TRAIN_ARGS + ["--base_dir", root, "--device", "cpu", "--max_steps", "1"]
    train.main(base + ["--log_dir", str(tmp_path / "a"), "--pretrained_denoiser", path,
                       "--pretrained_score", path])
    out = capsys.readouterr().out
    assert f"grafted pretrained denoiser from {path}" in out
    assert f"grafted pretrained score model from {path}" in out
    ema = load_training_checkpoint(str(_run(tmp_path / "a") / "checkpoints" / "last.pt"))[
        "ema_params"]
    # one EMA step from the grafted weights: d = 2/11 of them stays, and
    # Adam moves a weight by at most lr
    for k, v in src.items():
        assert float((ema[k] - v).abs().max()) <= 1e-3, k
    with pytest.raises(ValueError, match="StoRM"):
        train.main(base + ["--mode", "score-only", "--nolog", "--pretrained_score", path])
