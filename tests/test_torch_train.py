"""The training slice against the reference on the CPU: the joint loss and its
gradients, one Adam + EMA step, the data pipeline's batches, and the port's
training CLI (two steps, a resume, a checkpoint that enhances).

Tiny nets (nf 16, three levels, 32 x 32 specs). Tolerances: losses 1e-5
relative (one float32 sum over the batch); gradients per parameter tensor
max|port - ref| <= 1e-4 * max|ref| + 1e-5 * (the largest gradient element of
the model), the floor for tensors whose exact gradient is 0 (the attention
key bias: softmax ignores a constant added to every logit), where both sides
hold rounding noise; Adam and the EMA 1e-6 absolute, 1e-5 relative (a few
float32 operations per element).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_parity import random_params, to_numpy_tree, tt

from storm_tpu.data.datamodule import SpecsDataModule as JDataModule
from storm_tpu.models.base import ema_update as jema_update
from storm_tpu.models.factory import build_model as jbuild
from storm_tpu_torch import enhancement, train
from storm_tpu_torch.ckpt import load_training_checkpoint
from storm_tpu_torch.convert import params_from_jax
from storm_tpu_torch.data.audio import load_wav, save_wav
from storm_tpu_torch.data.datamodule import SpecsDataModule as PDataModule
from storm_tpu_torch.models.base import init_train_state
from storm_tpu_torch.models.factory import build_model as pbuild

CONFIG = {"mode": "regen-joint-training", "nf": 16, "ch_mult": [1, 2, 2],
          "init_scale": 1.0, "n_fft": 62, "hop_length": 16, "sde": "ouve"}
B, F, T = 2, 32, 32


def _random_params(jmodel, seed=0):
    """Random weights (torch_parity.random_params) for the reference model's
    parameter tree at (B, F, T)."""
    return random_params(
        jax.eval_shape(lambda: jmodel.init_params(jax.random.PRNGKey(0), (B, F, T))), seed)


def _models(cfg, seed=0):
    """The reference model and the port's, with the same random weights."""
    jmodel = jbuild(dict(cfg))
    params = _random_params(jmodel, seed)
    pmodel = pbuild(dict(cfg), device="cpu").train()
    pmodel.load_state_dict(params_from_jax(params, target=pmodel), strict=True)
    return jmodel, params, pmodel


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    x = (0.3 * rng.standard_normal((B, F, T, 2))).astype(np.float32)
    y = (x + 0.2 * rng.standard_normal((B, F, T, 2))).astype(np.float32)
    t = np.asarray([0.1, 0.7], np.float32)
    z = (rng.standard_normal((B, F, T, 2)) / np.sqrt(2)).astype(np.float32)
    return x, y, t, z


def _assert_grads_close(pmodel, jgrads):
    want = params_from_jax(to_numpy_tree(jgrads), target=pmodel)
    floor = max(float(w.abs().max()) for w in want.values())
    for name, p in pmodel.named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        err = float((got - want[name]).abs().max())
        tol = 1e-4 * float(want[name].abs().max()) + 1e-5 * floor
        assert err <= tol, f"{name}: max abs err {err:.3e} > {tol:.3e}"


@pytest.mark.parametrize("loss_type", ["mse", "mae"])
@pytest.mark.parametrize("mode", ["regen-joint-training", "regen-freeze-denoiser"])
def test_loss_and_gradients_match_reference(mode, loss_type):
    cfg = dict(CONFIG, mode=mode, loss_type_score=loss_type, loss_type_denoiser=loss_type)
    jmodel, params, pmodel = _models(cfg)
    x, y, t, z = _batch()
    (want, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p, *a: jmodel.loss_given_tz(p, a[:2], *a[2:]), has_aux=True))(params, x, y, t, z)

    aux = pmodel.compute_gradients((tt(x), tt(y)), tt(t), tt(z))
    assert set(aux) == set(jaux) == {"loss", "loss_score", "loss_denoiser"}
    for k in aux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-5, err_msg=k)
    _assert_grads_close(pmodel, jgrads)
    if mode == "regen-freeze-denoiser":
        assert all(float(p.grad.abs().max()) == 0 for p in pmodel.denoiser_net.parameters()
                   if p.requires_grad)


def test_per_example_losses_sum_to_the_loss():
    _, _, pmodel = _models(CONFIG)
    x, y, _, _ = _batch(1)
    batch = (tt(x), tt(y))
    per_example = pmodel.loss_per_example(batch, torch.Generator().manual_seed(3))
    loss, _ = pmodel.loss_fn(batch, torch.Generator().manual_seed(3))
    assert per_example.shape == (B,)
    torch.testing.assert_close(per_example.sum(), loss, rtol=1e-5, atol=0)
    t, z = pmodel.draw_tz(batch[0], torch.Generator().manual_seed(3))
    assert t.shape == (B,) and bool(((t >= pmodel.t_eps) & (t <= pmodel.sde.T)).all())
    assert z.shape == batch[0].shape


def test_adam_and_ema_steps_match_optax():
    """Two optimizer + EMA steps from the same gradients (random, except the
    frozen Fourier W, whose reference gradient is stopped)."""
    cfg = dict(CONFIG, lr=1e-2, ema_decay=0.999)
    _, params, pmodel = _models(cfg)
    rng = np.random.default_rng(4)

    def grad_tree(tree):
        return {k: (grad_tree(v) if isinstance(v, dict) else
                    np.zeros_like(v) if k == "W" else
                    rng.standard_normal(v.shape).astype(np.float32)) for k, v in tree.items()}

    tx = optax.adam(1e-2)

    @jax.jit
    def jstep(grads, opt, p, ema, step):
        updates, opt = tx.update(grads, opt, p)
        p = optax.apply_updates(p, updates)
        return opt, p, jema_update(ema, p, 0.999, step)

    jp, jema, opt = params, params, tx.init(params)
    state = init_train_state(pmodel, pmodel.lr)
    for step in (1, 2):
        grads = grad_tree(params)
        opt, jp, jema = jstep(grads, opt, jp, jema, jnp.asarray(step))
        for name, g in params_from_jax(grads, target=pmodel).items():
            p = pmodel.get_parameter(name)
            if p.requires_grad:
                p.grad = g.clone()
        pmodel.apply_update(state)
        assert state.step == step
    for got, want in ((pmodel.state_dict(), jp), (state.ema, jema)):
        want = params_from_jax(to_numpy_tree(want), target=pmodel)
        for name, w in want.items():
            torch.testing.assert_close(got[name], w, atol=1e-6, rtol=1e-5, msg=name)


def _write_corpus(root, n_train=6, n_valid=5, seed=0, valid_len=None):
    """wsj0 layout; lengths on both sides of the 496-sample crop (num_frames 32,
    hop 16), 5 validation files so batch 2 leaves a short last batch.
    `valid_len`: a (low, high) range of validation lengths instead; ESTOI
    needs 30 frames at 10 kHz, about 0.4 s."""
    rng = np.random.default_rng(seed)
    for subset, n_files in (("tr", n_train), ("cv", n_valid)):
        for kind in ("clean", "noisy"):
            os.makedirs(os.path.join(root, subset, kind))
        low, high = valid_len if subset == "cv" and valid_len else (300, 1500)
        for i in range(n_files):
            n = int(rng.integers(low, high))
            x = 0.3 * np.sin(2 * np.pi * 300 * np.arange(n) / 16000)
            save_wav(os.path.join(root, subset, "clean", f"u{i}.wav"), x)
            save_wav(os.path.join(root, subset, "noisy", f"u{i}.wav"),
                     x + 0.05 * rng.standard_normal(n))
    return str(root)


def test_batches_match_reference(tmp_path):
    root = _write_corpus(tmp_path / "corpus")
    kw = dict(base_dir=root, batch_size=2, hop_length=16, num_frames=32, num_workers=2, seed=3)
    jdm, pdm = JDataModule(**kw), PDataModule(**kw)
    jdm.setup("fit")
    pdm.setup("fit")
    for epoch in (0, 1):
        jl, pl = jdm.train_dataloader(), pdm.train_dataloader()
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        jb, pb = list(jl), list(pl)
        assert len(jb) == len(pb) == 3
        for (jx, jy), (px, py) in zip(jb, pb):
            assert px.shape == (2, 31 * 16)
            np.testing.assert_array_equal(px, jx)
            np.testing.assert_array_equal(py, jy)
    jv, pv = list(jdm.val_dataloader()), list(pdm.val_dataloader())
    assert [b[0].shape[0] for b in pv] == [2, 2, 1]
    for (jx, jy), (px, py) in zip(jv, pv):
        np.testing.assert_array_equal(px, jx)
        np.testing.assert_array_equal(py, jy)


TRAIN_ARGS = ["--mode", "regen-joint-training", "--format", "wsj0", "--batch_size", "2",
              "--num_frames", "32", "--n_fft", "62", "--hop_length", "16", "--nf", "8",
              "--ch_mult", "1,2", "--num_workers", "2", "--num_eval_files", "0",
              "--log_every_n_steps", "1"]


def test_cli_trains_resumes_and_enhances_on_cpu(tmp_path):
    root = _write_corpus(tmp_path / "corpus")
    logs = tmp_path / "logs"
    args = TRAIN_ARGS + ["--base_dir", root, "--log_dir", str(logs), "--device", "cpu"]
    train.main(args + ["--max_steps", "2"])
    (run,) = os.listdir(logs)
    ckpts = logs / run / "checkpoints"
    assert sorted(os.listdir(ckpts)) == ["best_loss.pt", "last.pt"]
    first = load_training_checkpoint(str(ckpts / "last.pt"))
    assert first["step"] == 2 and first["meta"]["epoch"] == 0

    train.main(args + ["--max_steps", "4", "--resume_from_checkpoint", str(ckpts / "last.pt")])
    rows = [json.loads(line) for line in open(logs / run / "metrics.jsonl")]
    assert [r["step"] for r in rows if "train_loss" in r] == [1, 2, 3, 4]
    assert all(set(r) == {"step", "train_loss", "train_loss_score", "train_loss_denoiser"}
               for r in rows if "train_loss" in r)
    epochs = [r for r in rows if "valid_loss" in r]
    assert [r["step"] for r in epochs] == [2, 4]
    assert all(np.isfinite(r["valid_loss"]) and np.isfinite(r["train_loss_epoch"]) for r in epochs)
    last = load_training_checkpoint(str(ckpts / "last.pt"))
    assert last["step"] == 4 and last["meta"]["epoch"] == 1
    assert last["config"]["nf"] == 8 and last["config"]["spec_factor"] == 0.33
    moved = [k for k in last["params"] if not torch.equal(last["params"][k], first["params"][k])]
    assert moved and not all(torch.equal(last["ema_params"][k], first["ema_params"][k])
                             for k in moved)

    noisy, out = tmp_path / "noisy", tmp_path / "out"
    noisy.mkdir()
    save_wav(str(noisy / "a.wav"), 0.1 * np.random.default_rng(0).standard_normal(900))
    enhancement.main(["--test_dir", str(noisy), "--enhanced_dir", str(out), "--ckpt",
                      str(ckpts / "last.pt"), "--mode", "storm", "--N", "2", "--device", "cpu"])
    x, sr = load_wav(str(out / "a.wav"))
    assert sr == 16000 and x.shape == (1, 900) and np.isfinite(x).all()


@pytest.mark.parametrize("flag", [
    ["--backbone_score", "ncsnpp_6M"],
    ["--spatial_channels", "2"], ["--return_time"], ["--pretrained_denoiser", "ckpt"],
])
def test_cli_refuses_what_is_not_ported(flag, tmp_path):
    args = TRAIN_ARGS + ["--base_dir", str(tmp_path), "--nolog", "--device", "cpu"]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train.main(args + flag)


def test_cli_debug_nans_raises_on_a_non_finite_loss(tmp_path):
    """`--debug_nans` (the reference's flag, train.py:171-174): the steps run
    under autograd's anomaly detection, and a non-finite loss raises; without
    it the same run trains on and logs the NaN."""
    from storm_tpu_torch.models.storm import StochasticRegenerationModel

    root = _write_corpus(tmp_path / "corpus", n_train=2, n_valid=1)
    args = TRAIN_ARGS + ["--base_dir", root, "--max_steps", "1", "--device", "cpu"]
    assert train.parse_args(args + ["--debug_nans"]).debug_nans

    def nan_loss(self, batch, t, z):
        loss, aux = StochasticRegenerationModel.loss_given_tz(self, batch, t, z)
        return loss * float("nan"), {**aux, "loss": loss * float("nan")}

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(StochasticRegenerationModel, "step_loss", nan_loss)
        with pytest.raises((RuntimeError, FloatingPointError), match="nan"):
            train.main(args + ["--debug_nans", "--log_dir", str(tmp_path / "a")])
        train.main(args + ["--log_dir", str(tmp_path / "b")])
    rows = [json.loads(line) for line in open(_run(tmp_path / "b") / "metrics.jsonl")]
    assert [np.isnan(r["train_loss"]) for r in rows if "train_loss" in r] == [True]


# the reference's metrics.jsonl keys (train.py:622-627): per logged step, and per epoch
STEP_KEYS = {"step", "train_loss", "train_loss_score", "train_loss_denoiser"}
EPOCH_KEYS = {"step", "train_loss_epoch", "valid_loss", "ValidationPESQ", "ValidationSISDR",
              "ValidationESTOI"}
# the evaluation enhances whole validation files (0.41-0.44 s: 512 frames once
# bucketed); a third level keeps the bottleneck's attention at 8 x 128
EVAL_ARGS = ["--num_eval_files", "2", "--eval_N", "2", "--ch_mult", "1,2,2"]
VALID_LEN = (6600, 7100)


def _run(logs):
    (run,) = os.listdir(logs)
    return logs / run


def test_cli_num_eval_files_logs_finite_metrics(tmp_path):
    """The reference's default, an evaluation every epoch (here of 2 files at
    N=2, float32): finite SI-SDR and ESTOI, PESQ NaN without the `pesq`
    package, under the reference's keys; `best_pesq.pt` follows ESTOI, and
    the meta says so."""
    root = _write_corpus(tmp_path / "corpus", n_train=4, n_valid=3, valid_len=VALID_LEN)
    logs = tmp_path / "logs"
    args = TRAIN_ARGS[:-4] + ["--log_every_n_steps", "1", "--base_dir", root, "--log_dir",
                              str(logs), "--device", "cpu", "--max_steps", "4"]
    assert "--num_eval_files" not in args  # the default, 10, covers the 3 files
    train.main(args + EVAL_ARGS[2:])
    run = _run(logs)
    rows = [json.loads(line) for line in open(run / "metrics.jsonl")]
    epochs = [r for r in rows if "valid_loss" in r]
    assert len(epochs) == 2 and all(set(r) == EPOCH_KEYS for r in epochs)
    assert all(set(r) == STEP_KEYS for r in rows if "train_loss" in r)
    for r in epochs:
        assert np.isfinite(r["ValidationSISDR"]) and np.isfinite(r["ValidationESTOI"])
        assert np.isnan(r["ValidationPESQ"])
    assert sorted(os.listdir(run / "checkpoints")) == ["best_loss.pt", "best_pesq.pt", "last.pt"]
    meta = load_training_checkpoint(str(run / "checkpoints" / "last.pt"))["meta"]
    assert meta["quality_metric"] == "estoi"
    assert meta["best_quality"] == max(r["ValidationESTOI"] for r in epochs)


def test_cli_logs_nan_when_the_evaluation_fails_and_trains_on(tmp_path, capsys):
    """As the reference (train.py:615): an evaluation that raises (ESTOI on
    validation files under 0.4 s) is printed, its metrics are logged as NaN,
    no `best_pesq.pt` is written, and training goes on."""
    root = _write_corpus(tmp_path / "corpus", n_train=4, n_valid=2)
    logs = tmp_path / "logs"
    train.main(TRAIN_ARGS[:-4] + ["--log_every_n_steps", "1", "--base_dir", root, "--log_dir",
                                  str(logs), "--device", "cpu", "--max_steps", "4"] + EVAL_ARGS)
    assert capsys.readouterr().out.count("eval failed at epoch") == 2
    run = _run(logs)
    epochs = [json.loads(line) for line in open(run / "metrics.jsonl") if "valid_loss" in line]
    assert [r["step"] for r in epochs] == [2, 4]
    assert all(np.isnan(r[k]) for r in epochs for k in EPOCH_KEYS if k.startswith("Validation"))
    assert sorted(os.listdir(run / "checkpoints")) == ["best_loss.pt", "last.pt"]


def test_cli_trains_in_bf16_resumes_bit_identically_and_enhances(tmp_path):
    """`--dtype bfloat16` with the evaluation: finite losses and metrics, the
    three checkpoints, the config's dtype; two steps and a resume to four
    equal four steps in one run, bit for bit (parameters, EMA, Adam's
    moments); the checkpoint enhances in bfloat16 through `--dtype
    checkpoint`."""
    root = _write_corpus(tmp_path / "corpus", n_train=4, n_valid=2, valid_len=VALID_LEN)
    base = TRAIN_ARGS[:-4] + ["--log_every_n_steps", "1", "--base_dir", root, "--device", "cpu",
                              "--dtype", "bfloat16"] + EVAL_ARGS
    whole, split = tmp_path / "whole", tmp_path / "split"
    train.main(base + ["--log_dir", str(whole), "--max_steps", "4"])
    train.main(base + ["--log_dir", str(split), "--max_steps", "2"])
    ckpts = _run(split) / "checkpoints"
    train.main(base + ["--log_dir", str(split), "--max_steps", "4", "--resume_from_checkpoint",
                       str(ckpts / "last.pt")])
    assert sorted(os.listdir(ckpts)) == ["best_loss.pt", "best_pesq.pt", "last.pt"]
    rows = [json.loads(line) for line in open(_run(split) / "metrics.jsonl")]
    assert all(np.isfinite(r[k]) for r in rows for k in r if k != "ValidationPESQ")
    got = load_training_checkpoint(str(ckpts / "last.pt"))
    want = load_training_checkpoint(str(_run(whole) / "checkpoints" / "last.pt"))
    assert got["config"]["dtype"] == "bfloat16" and got["step"] == want["step"] == 4
    for key in ("params", "ema_params"):
        for name, w in want[key].items():
            assert w.dtype == torch.float32 and torch.equal(got[key][name], w), (key, name)
    for sg, sw in zip(got["optimizer"]["state"].values(), want["optimizer"]["state"].values()):
        assert all(torch.equal(sg[k], sw[k]) for k in ("exp_avg", "exp_avg_sq"))
    assert got["meta"] == want["meta"] and got["meta"]["quality_metric"] == "estoi"

    noisy, out = tmp_path / "noisy", tmp_path / "out"
    noisy.mkdir()
    save_wav(str(noisy / "a.wav"), 0.1 * np.random.default_rng(0).standard_normal(900))
    seen = []

    def build(cfg, *a, **k):
        model = pbuild(cfg, *a, **k)
        seen.append((model.denoiser_net.dtype, model.score_net.dtype))
        return model

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(enhancement, "build_model", build)
        enhancement.main(["--test_dir", str(noisy), "--enhanced_dir", str(out), "--ckpt",
                          str(ckpts / "best_pesq.pt"), "--mode", "storm", "--N", "2",
                          "--device", "cpu", "--dtype", "checkpoint"])
    assert seen == [(torch.bfloat16, torch.bfloat16)]
    x, sr = load_wav(str(out / "a.wav"))
    assert sr == 16000 and x.shape == (1, 900) and np.isfinite(x).all()


def test_default_device_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    root = _write_corpus(tmp_path / "corpus", n_train=2, n_valid=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(TRAIN_ARGS + ["--base_dir", root, "--nolog"])
