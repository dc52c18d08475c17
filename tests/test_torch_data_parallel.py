"""Data-parallel training on the CPU: the loader's shards against the
single-process batch stream and the reference loader's `shard`, the split
step's draws and loss shares, GaGNet's BN norm with its moments across two
Gloo processes against one norm over their rows, and two Gloo processes of
`python -m storm_tpu_torch.train` against one process at the same global
batch, GaGNet-BN among them (the port's counterpart of
tests/test_multihost_train.py).

Tolerances: batches bit for bit; the draws of a process's rows bit for bit;
the split step's losses and summed gradients against one process's step on
the whole batch 1e-5 relative (by the norm over every gradient: float32
sums in another order, ~1e-7 on the CPU; a gradient left unsummed or a mean
not divided by the process count is off by ~1); the two-process run's epoch
losses as the reference's test holds its own, `train_loss_epoch` at rtol
5e-3 and `valid_loss` at 1e-3 (the gradients' sum across processes
reassociates the batch's float32 sum, and Adam carries that into later
steps), and its first step's gradients at 1e-5 as above; the BN norm's
outputs and gradients at 1e-6 of their scale. Tiny nets (nf 8, two levels,
n_fft 62, 32 frames; GaGNet at n_fft 126, its smallest encoder). Every
subprocess has a timeout; the process group's port comes from a socket
bound to port 0.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from storm_tpu.data.datamodule import SpecsDataModule as JDataModule
from storm_tpu_torch.backbones.gagnet import NormSwitch
from storm_tpu_torch.data.audio import save_wav
from storm_tpu_torch.data.datamodule import SpecsDataModule as PDataModule
from storm_tpu_torch.models.base import init_train_state
from storm_tpu_torch.models.factory import build_model
from storm_tpu_torch.utils import train_graphs
from storm_tpu_torch.utils.distributed import World, place
from storm_tpu_torch.utils.train_graphs import TrainPrograms

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 300
TINY = {"nf": 8, "ch_mult": [1, 2], "n_fft": 62, "hop_length": 16, "init_scale": 1.0}


def _write_corpus(root, n_train, n_valid, seed=0):
    """wsj0 layout, 0.03-0.09 s files (on both sides of the 496-sample crop)."""
    rng = np.random.default_rng(seed)
    for subset, n_files in (("tr", n_train), ("cv", n_valid)):
        for kind in ("clean", "noisy"):
            os.makedirs(os.path.join(root, subset, kind))
        for i in range(n_files):
            n = int(rng.integers(400, 1500))
            x = 0.3 * np.sin(2 * np.pi * 300 * np.arange(n) / 16000)
            save_wav(os.path.join(root, subset, "clean", f"u{i}.wav"), x)
            save_wav(os.path.join(root, subset, "noisy", f"u{i}.wav"),
                     x + 0.05 * rng.standard_normal(n))
    return str(root)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return _write_corpus(tmp_path_factory.mktemp("corpus_dp"), n_train=4, n_valid=3)


@pytest.fixture(scope="module")
def even_corpus(tmp_path_factory):
    """No ragged validation tail: a BN net's moments over a padded tail
    depend on the padding, zeros for one process and the repeated last
    file across processes, in the reference as here."""
    return _write_corpus(tmp_path_factory.mktemp("corpus_dp_even"), n_train=4, n_valid=2)


# --- the loader's shard


@pytest.mark.parametrize("count", [2, 4])
def test_shards_make_up_the_single_process_stream_and_match_the_reference(count, tmp_path):
    """Global batch 4 over `count` processes: each process's rows of every
    training batch (two epochs) and validation batch (a ragged tail of 1,
    padded by repeating its last index) equal the single-process batch's
    rows and the reference loader's shard."""
    root = _write_corpus(tmp_path / "c", n_train=9, n_valid=5)
    kw = dict(base_dir=root, batch_size=4, hop_length=16, num_frames=32, num_workers=2, seed=3)
    whole = PDataModule(**kw)
    whole.setup("fit")
    shards = []
    for p in range(count):
        pdm, jdm = PDataModule(**kw, shard=(p, count)), JDataModule(**kw, shard=(p, count))
        pdm.setup("fit")
        jdm.setup("fit")
        shards.append((pdm, jdm))
    rows = 4 // count
    for epoch in (0, 1):
        loaders = [whole.train_dataloader()] + [l for pdm, jdm in shards
                                               for l in (pdm.train_dataloader(),
                                                         jdm.train_dataloader())]
        for loader in loaders:
            loader.set_epoch(epoch)
        batches = [list(loader) for loader in loaders]
        assert all(len(b) == 2 for b in batches)
        for i, (x, y) in enumerate(batches[0]):
            for p in range(count):
                px, py = batches[1 + 2 * p][i]
                jx, jy = batches[2 + 2 * p][i]
                assert px.shape == (rows, 31 * 16)
                mine = slice(p * rows, (p + 1) * rows)
                for got, want in ((px, x[mine]), (py, y[mine]), (px, jx), (py, jy)):
                    np.testing.assert_array_equal(got, want)
    valid = list(whole.val_dataloader())
    assert [b[0].shape[0] for b in valid] == [4, 1]
    for p, (pdm, jdm) in enumerate(shards):
        pv, jv = list(pdm.val_dataloader()), list(jdm.val_dataloader())
        assert [b[0].shape[0] for b in pv] == [rows, rows]
        for (px, py), (jx, jy), (x, y) in zip(pv, jv, valid):
            np.testing.assert_array_equal(px, jx)
            np.testing.assert_array_equal(py, jy)
            lo = p * rows
            idx = np.minimum(np.arange(lo, lo + rows), x.shape[0] - 1)  # the tail's padding
            np.testing.assert_array_equal(px, x[idx])
            np.testing.assert_array_equal(py, y[idx])


def test_loader_refuses_a_batch_the_processes_do_not_divide(corpus):
    dm = PDataModule(base_dir=corpus, batch_size=3, hop_length=16, num_frames=32,
                     shard=(0, 2))
    dm.setup("fit")
    with pytest.raises(ValueError, match="not divisible by 2 processes"):
        dm.train_dataloader()


# --- the split step, in one process


@pytest.mark.parametrize("mode", ["regen-joint-training", "distill", "score-only"])
def test_each_process_draws_its_rows_of_the_global_batch(mode):
    """A process's random inputs are its rows of those one process draws for
    the global batch, from the same generator state."""
    model = build_model(dict(TINY, mode="regen-joint-training" if mode == "distill" else mode),
                        device="cpu")
    if mode == "distill":
        from storm_tpu_torch.models.distill import DistilledModel
        model = DistilledModel(model)
    state = init_train_state(model, 1e-4)
    batch = tuple(torch.zeros(4, 32, 33, 2) for _ in range(2))
    want = TrainPrograms(state).draw(batch, torch.Generator().manual_seed(5))
    assert len(want) == (1 if mode == "distill" else 2)
    for rank in (0, 1):
        got = TrainPrograms(state, world=World(rank, 2)).draw(
            tuple(b[:2] for b in batch), torch.Generator().manual_seed(5))
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w[2 * rank: 2 * rank + 2], rtol=0, atol=0)


def _relative(got, want) -> float:
    """|got - want| / |want| over every tensor of the two lists."""
    return float(torch.cat([(g - w).flatten() for g, w in zip(got, want)]).norm()
                 / torch.cat([w.flatten() for w in want]).norm())


@pytest.mark.parametrize("mode", ["score-only", "denoiser-only", "regen-joint-training"])
def test_mean_loss_shares_sum_to_the_global_mean(mode, monkeypatch):
    """The split step as process 0 of 2, its all-reduce the sum with process
    1's buffer: the losses and the gradients Adam reads are those of one
    process's step on the whole batch (a "mean" loss's sum divided by the
    process count, a "sum" loss's as it is)."""
    rng = np.random.default_rng(0)
    arrays = [(0.3 * rng.standard_normal((4, 496))).astype(np.float32) for _ in range(2)]

    def programs(world):
        model = build_model(dict(TINY, mode=mode), device="cpu", seed=0).train()
        return TrainPrograms(init_train_state(model, 1e-4), graphs=False, world=world)

    one = programs(World())
    want = {k: v.clone() for k, v in one.step(arrays, torch.Generator().manual_seed(3)).items()}
    other = programs(World(1, 2))
    other._grads_body(other._upload([a[2:] for a in arrays]),
                      other._drawer(torch.Generator().manual_seed(3)))
    monkeypatch.setattr(train_graphs, "all_reduce_", lambda t, world: t.add_(other.flat))
    first = programs(World(0, 2))
    got = first.step([a[:2] for a in arrays], torch.Generator().manual_seed(3))
    assert got.keys() == want.keys() and first.stats["allreduces"] == 1
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=0)
    assert _relative([p.grad for p in first.params], [p.grad for p in one.params]) <= 1e-5


@pytest.mark.parametrize("device,rank,size,cards,local,want", [
    ("cuda", 1, 2, 2, None, ("nccl", "cuda:1")),  # a card each
    ("cuda", 1, 2, 1, None, ("gloo", "cuda:0")),  # two on one card
    ("cuda", 2, 3, 2, None, ("gloo", "cuda:0")),  # three on two cards
    ("cuda", 1, 3, 2, None, ("gloo", "cuda:1")),
    ("cuda", 5, 8, 4, (1, 4), ("nccl", "cuda:1")),  # two hosts of four cards
    ("cuda", 5, 8, 4, None, ("gloo", "cuda:1")),  # the same without the local index
    ("cuda:0", 1, 2, 2, None, ("gloo", "cuda:0")),  # a device that names its card
    ("cpu", 1, 2, 0, None, ("gloo", "cpu")),
])
def test_each_process_takes_its_card_and_the_backend(device, rank, size, cards, local, want):
    """`place`: NCCL where the processes of a host have a card each (by
    their local index), else Gloo with the host's cards shared in turn."""
    backend, dev = place(torch.device(device), rank, size, cards, local)
    assert (backend, str(dev)) == want


# --- two processes of the CLI


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# the trainer without TensorBoard: its import (TensorFlow's, where that is
# installed) costs ~10 s a process, and the trainer runs without a writer
# where it does not import. With STEP1_GRADS set, process 0 writes the
# gradients Adam read at the first step there.
RUN = """
import os, sys
sys.modules['torch.utils.tensorboard'] = None
import torch
from storm_tpu_torch.train import main
from storm_tpu_torch.utils.train_graphs import TrainPrograms
out, step = os.environ.get('STEP1_GRADS'), TrainPrograms.step
def first(programs, arrays, generator):
    aux = step(programs, arrays, generator)
    if programs.state.step == 1 and programs.world.is_main:
        torch.save([p.grad.clone() for p in programs.params], out)
    return aux
if out:
    TrainPrograms.step = first
main(sys.argv[1:])
"""


def _cmd(corpus, log_dir, mode, extra=()):
    return [sys.executable, "-c", RUN, "--mode", mode, "--base_dir", corpus,
            "--batch_size", "2", "--num_frames", "32", "--n_fft", "62", "--hop_length", "16",
            "--nf", "8", "--ch_mult", "1,2", "--num_workers", "1", "--num_eval_files", "0",
            "--log_every_n_steps", "1", "--log_dir", str(log_dir), "--device", "cpu",
            *extra]


def _env(**extra):
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", **extra)


def _one(cmd, **env):
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=TIMEOUT_S, env=_env(**env),
                       cwd=REPO)
    assert r.returncode == 0, r.stderr[-4000:]


def _two(cmd, **env):
    """Run `cmd` as processes 0 and 1 of a Gloo group; their stdout."""
    port = _free_port()
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              cwd=REPO, env=_env(STORM_TPU_COORDINATOR=f"127.0.0.1:{port}",
                                                 STORM_TPU_NUM_PROCESSES="2",
                                                 STORM_TPU_PROCESS_ID=str(rank), **env))
             for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S))
    finally:
        for p in procs:
            p.kill()
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se[-4000:] + so[-2000:]
    return [so for so, _ in outs]


def _rows(log_dir):
    (run,) = os.listdir(log_dir)
    with open(os.path.join(log_dir, run, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return run, rows


# GaGNet with BN at the width of the reference CLI's smallest encoder (n_fft 126)
# and one TCN dilation: fewer BN layers, each of which amplifies the float32
# rounding that parts the two runs' gradients (tools/gagnet_bn_precision.py:
# at the reference CLI's full width float32 runs part by ~3e-3, each as far
# from the float64 gradient)
GAGNET_BN = ("--backbone_denoiser", "gagnet", "--norm_type", "BN", "--n_fft", "126",
             "--hop_length", "32", "--fft_num", "128", "--d_feat", "64", "--c", "8", "--cd1",
             "8", "--p", "1", "--q", "1", "--dilas", "1")


@pytest.mark.parametrize("mode,net", [("regen-joint-training", ()), ("denoiser-only", ()),
                                      ("denoiser-only", GAGNET_BN)],
                         ids=["regen-joint-training", "denoiser-only", "denoiser-only-gagnet-bn"])
def test_two_processes_train_as_one_at_the_same_global_batch(mode, net, corpus, even_corpus,
                                                             tmp_path):
    """StoRM (a loss summed over the batch), the denoiser (the batch's
    mean) and the GaGNet-BN denoiser (its moments over the global batch, in
    the steps and the validation): two Gloo processes, one row each of
    every global batch of 2, log the single process's losses at every step
    and epoch; only process 0 logs and checkpoints; a resumed two-process
    run (StoRM) continues as a resumed single-process run does. The first
    step's gradients, summed across the processes, are the single
    process's. The BN run says why its steps run eagerly."""
    resume = mode == "regen-joint-training"
    epochs = ["--max_epochs", "1"] if resume else ["--max_epochs", "2"]
    corpus = even_corpus if net else corpus
    one, two = tmp_path / "one", tmp_path / "two"
    grads = {name: str(tmp_path / f"grads_{name}.pt") for name in ("one", "two")}
    _one(_cmd(corpus, one, mode, epochs + list(net)), STEP1_GRADS=grads["one"])
    outs = _two(_cmd(corpus, two, mode, epochs + list(net)), STEP1_GRADS=grads["two"])
    execution = "eager: BN moments across processes (gloo)" if net else "graph"
    assert f"training steps and validation: {execution}" in outs[0]
    g1, g2 = (torch.load(grads[name]) for name in ("one", "two"))
    assert len(g1) == len(g2) and _relative(g2, g1) <= 1e-5
    assert "process 0 of 2: backend gloo on cpu" in outs[0]
    assert "process 1 of 2: backend gloo on cpu" in outs[1]
    assert "epoch 0:" in outs[0] and "epoch 0:" not in outs[1]
    if resume:
        for root, run in ((one, _one), (two, _two)):
            (name,) = os.listdir(root)
            run(_cmd(corpus, root, mode, ["--max_epochs", "2", "--resume_from_checkpoint",
                                          str(root / name / "checkpoints" / "last.pt")]))
    (run1, rows1), (run2, rows2) = _rows(one), _rows(two)
    assert run1 == run2 and len(rows1) == len(rows2)
    steps = [r for r in rows1 if "train_loss" in r]
    assert [r["step"] for r in steps] == [1, 2, 3, 4]
    for a, b in zip(rows1, rows2):
        assert a.keys() == b.keys() and a["step"] == b["step"]
        for k in a:
            if k.startswith("train_loss"):
                np.testing.assert_allclose(b[k], a[k], rtol=5e-3, err_msg=k)
        if "valid_loss" in a:
            np.testing.assert_allclose(b["valid_loss"], a["valid_loss"], rtol=1e-3)
    assert sorted(os.listdir(two / run2 / "checkpoints")) == sorted(
        os.listdir(one / run1 / "checkpoints"))


# --- GaGNet's BN moments across processes, in process


SYNCED_NORM = """
import sys
import torch
import torch.distributed as dist
from storm_tpu_torch.backbones.gagnet import NormSwitch, moments_across
from storm_tpu_torch.utils.distributed import World
rank, port, inputs, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank)
x, weight, bias, up = torch.load(inputs)
norm = NormSwitch("BN", x.shape[1])
with torch.no_grad():
    norm.norm.weight.copy_(weight)
    norm.norm.bias.copy_(bias)
rows = slice(rank * x.shape[0] // 2, (rank + 1) * x.shape[0] // 2)
xi = x[rows].clone().requires_grad_(True)
with moments_across([norm], World(rank, 2, "gloo", torch.device("cpu"))):
    y = norm(xi)
    (y * up[rows]).sum().backward()
torch.save({"y": y.detach(), "dx": xi.grad, "dw": norm.norm.weight.grad,
            "db": norm.norm.bias.grad}, out)
dist.destroy_process_group()
"""


def test_synchronized_norm_switch_is_one_norm_over_the_concatenated_rows(tmp_path):
    """Two Gloo processes, two rows each, through one BN `NormSwitch` under
    `moments_across`: their outputs and input gradients put together, and
    their affine gradients summed, are one NormSwitch's on the four rows
    (the loss the sum of both processes' losses), 1e-6 of scale (float32
    sums in another order)."""
    g = torch.Generator().manual_seed(0)
    x = 2.0 + 3.0 * torch.randn(4, 6, 5, 9, generator=g)
    weight, bias = 1.0 + torch.randn(6, generator=g), torch.randn(6, generator=g)
    up = torch.randn(4, 6, 5, 9, generator=g)
    inputs = str(tmp_path / "inputs.pt")
    torch.save((x, weight, bias, up), inputs)
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", SYNCED_NORM, str(rank), str(port), inputs,
                               str(tmp_path / f"out{rank}.pt")], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, cwd=REPO, env=_env())
             for rank in range(2)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, err[-4000:]
    finally:
        for p in procs:
            p.kill()
    outs = [torch.load(tmp_path / f"out{rank}.pt") for rank in range(2)]
    norm = NormSwitch("BN", 6)
    with torch.no_grad():
        norm.norm.weight.copy_(weight)
        norm.norm.bias.copy_(bias)
    xw = x.clone().requires_grad_(True)
    y = norm(xw)
    (y * up).sum().backward()
    for got, want, what in ((torch.cat([o["y"] for o in outs]), y.detach(), "outputs"),
                            (torch.cat([o["dx"] for o in outs]), xw.grad, "input gradients"),
                            (outs[0]["dw"] + outs[1]["dw"], norm.norm.weight.grad, "d weight"),
                            (outs[0]["db"] + outs[1]["db"], norm.norm.bias.grad, "d bias")):
        assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max()), what
