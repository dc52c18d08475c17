"""The in-training evaluation against the reference on the CPU: the metrics
(SI-SDR, STOI and ESTOI, PESQ gated on the `pesq` package), the raw
validation pairs, `evaluate_model` on a tiny model and corpus with the
reference's noise replayed, and the checkpoint manager's `best_pesq` policy
with its ESTOI fallback across a resume.

Metrics on the same numpy signals: 1e-6 relative (both compute in float64
from the same float32 inputs, with the same numpy and scipy calls; measured
equal). `evaluate_model`: the enhanced waveforms 1e-4 of their scale, as in
tests/test_torch_inference.py, and the mean metrics computed from them
1e-3 relative (measured: 1e-6 and below).
"""
import os
import sys
import types
from unittest import mock

import jax
import numpy as np
import pytest
import torch
from torch_parity import ReplayNoise, assert_close_rel

from storm_tpu.ckpt import CheckpointManager as JManager
from storm_tpu.data.datasets import Specs as JSpecs
from storm_tpu.utils import inference as jinference
from storm_tpu.utils import metrics as jmetrics
from storm_tpu.utils import stoi as jstoi
from storm_tpu_torch.ckpt import CheckpointManager, load_training_checkpoint
from storm_tpu_torch.data.audio import save_wav
from storm_tpu_torch.data.datasets import Specs
from storm_tpu_torch.models.base import init_train_state
from storm_tpu_torch.utils import inference, metrics
from test_torch_inference import F, frames, jax_chunk_noise, tiny_storm_pair

SR = 16000


def _pair(n, seed, noise=0.3):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    x = (0.3 * np.sin(2 * np.pi * 220 * t) * (1 + np.sin(2 * np.pi * 3 * t))
         + 0.02 * rng.standard_normal(n)).astype(np.float32)
    return x, (x + noise * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("n,noise", [(8000, 0.3), (24000, 0.05), (13001, 1.0)])
def test_metrics_match_reference(n, noise):
    x, y = _pair(n, n, noise)
    for name in ("si_sdr",):
        want, got = getattr(jmetrics, name)(x, y), getattr(metrics, name)(x, y)
        assert isinstance(got, float)
        np.testing.assert_allclose(got, want, rtol=1e-6)
    for extended in (True, False):
        want = jstoi.stoi(x, y, SR, extended=extended)
        got = metrics.stoi(x, y, SR, extended=extended)
        np.testing.assert_allclose(got, want, rtol=1e-6)
    assert np.isnan(metrics.pesq_wb(SR, x, y)) and np.isnan(jmetrics.pesq_wb(SR, x, y))


def test_stoi_refuses_short_signals_as_the_reference_does():
    x, y = _pair(4000, 1)  # 0.25 s: fewer than 30 frames at 10 kHz
    for fn in (jstoi.stoi, metrics.stoi):
        with pytest.raises(ValueError, match="30-frame"):
            fn(x, y, SR, extended=True)


def test_pesq_is_nan_without_the_package_or_with_a_stub():
    """Without `pesq` (as here and on the card) both return NaN; a module
    named `pesq` without a file (a stub) counts as missing in both."""
    x, y = _pair(8000, 2)
    stub = types.ModuleType("pesq")
    stub.pesq = lambda *a: 4.5
    with mock.patch.dict(sys.modules, {"pesq": stub}):
        assert np.isnan(metrics.pesq_wb(SR, x, y)) and np.isnan(jmetrics.pesq_wb(SR, x, y))


def _write_valid(root, lengths, seed=0):
    """A wsj0-layout `cv` subset of (clean, noisy) pairs of `lengths`."""
    for kind in ("clean", "noisy"):
        os.makedirs(os.path.join(root, "cv", kind), exist_ok=True)
    for i, n in enumerate(lengths):
        x, y = _pair(n, seed + i)
        save_wav(os.path.join(root, "cv", "clean", f"u{i}.wav"), x)
        save_wav(os.path.join(root, "cv", "noisy", f"u{i}.wav"), y[: n - 50])  # shorter
    return str(root)


def test_raw_items_match_reference(tmp_path):
    root = _write_valid(tmp_path, [6800, 7500])
    kw = dict(num_frames=32, hop_length=16, format="wsj0")
    jset, pset = JSpecs(root, "valid", **kw), Specs(root, "valid", **kw)
    for i in range(2):
        (jx, jy), (px, py) = jset.__getitem__(i, raw=True), pset.__getitem__(i, raw=True)
        assert px.shape == py.shape == (1, [6800, 7500][i] - 50)
        np.testing.assert_array_equal(px, jx)
        np.testing.assert_array_equal(py, jy)
        assert pset[i][0].shape == (1, 31 * 16)  # a crop without raw


def test_evaluate_model_matches_reference(tmp_path):
    """Three files in two buckets (7168 and 8192 samples: 512 frames each
    once padded to 64), one chunk of 8 rows per bucket, N=2 without a
    corrector (the model's enhance defaults but N), PESQ NaN on both sides.
    The reference's noise, PRNGKey(0) split per bucket and per chunk, is
    replayed; the port's default is a generator seeded with 0 per call, so
    two calls agree."""
    jmodel, params, pmodel = tiny_storm_pair(seed=5)
    root = _write_valid(tmp_path, [6700, 7000, 7300], seed=3)
    kw = dict(num_frames=32, hop_length=16, format="wsj0")
    jset, pset = JSpecs(root, "valid", **kw), Specs(root, "valid", **kw)
    N = 2
    jseen = []
    jenhance = jinference.BucketedEnhancer.__call__

    def jwatched(self, y, key=None):
        out = jenhance(self, y, key)
        jseen.append(np.asarray(out[0]))
        return out

    with mock.patch.object(jinference.BucketedEnhancer, "__call__", jwatched):
        want = jinference.evaluate_model(jmodel, params, jset, 3, N=N)
    draws = []
    key = jax.random.PRNGKey(0)
    for L in (7168, 8192):
        key, k = jax.random.split(key)
        draws += jax_chunk_noise(k, [(8, F, frames(L))], N, corrector="none")
    noise = ReplayNoise(draws)
    seen = []
    enhance = inference.BucketedEnhancer.__call__

    def watched(self, y, generator=None, noise=None):
        out = enhance(self, y, generator=generator, noise=noise)
        seen.append(out[0])
        return out

    with mock.patch.object(inference.BucketedEnhancer, "__call__", watched):
        got = inference.evaluate_model(pmodel, pset, 3, noise=noise, N=N)
    assert noise.exhausted() and [s.shape for s in seen] == [(2, 7168), (1, 8192)]
    for L, got_x, want_x in zip((7168, 8192), seen, jseen):
        assert_close_rel(got_x, want_x, 1e-4, f"bucket {L}")
    assert got[3] is None and got[4] is None and want[3] is None and want[4] is None
    assert np.isnan(got[0]) and np.isnan(want[0])
    np.testing.assert_allclose(got[1:3], want[1:3], rtol=1e-3)

    a = inference.evaluate_model(pmodel, pset, 2, N=1)
    b = inference.evaluate_model(pmodel, pset, 2, N=1)
    assert a[1:3] == b[1:3]


class _State:
    """What CheckpointManager.step reads of a TrainState."""

    def __init__(self, model):
        train = init_train_state(model, 1e-4)
        self.model, self.ema, self.optimizer, self.step = model, train.ema, train.optimizer, 0


def test_best_pesq_follows_estoi_without_pesq_and_survives_a_resume(tmp_path):
    """The reference's policy (storm_tpu/ckpt.py:175-260) on the same epochs:
    PESQ NaN, so ESTOI decides and the meta names it; a worse epoch leaves
    `best_pesq.pt`; a resumed manager keeps the best quality and the
    metric, and a run whose metric changes raises in both."""
    _, _, pmodel = tiny_storm_pair(seed=0)
    state = _State(pmodel)
    epochs = [(5.0, 0.40), (4.0, 0.35), (4.5, 0.45)]  # (valid loss, ESTOI)
    pman, jman = CheckpointManager(str(tmp_path / "p"), {"nf": 16}), None
    jman = JManager.__new__(JManager)  # its policy, without orbax's writes
    jman.ckpt_dir, jman.config = str(tmp_path / "j"), {"nf": 16}
    jman.best_loss, jman.best_quality, jman.quality_metric = float("inf"), -float("inf"), None
    copies = []
    for epoch, (loss, estoi) in enumerate(epochs):
        state.step = epoch + 1
        before = os.path.getmtime(pman.path("best_pesq")) if epoch else None
        pman.step(state, valid_loss=loss, epoch=epoch, bad_epochs=0, best_valid=min(
            e[0] for e in epochs[: epoch + 1]), pesq=float("nan"), estoi=estoi)
        with mock.patch("storm_tpu.ckpt.save_checkpoint"), \
                mock.patch.object(JManager, "_copy_tag", lambda self, src, tag: copies.append(
                    (epoch, tag))):
            jman.step(None, valid_loss=loss, pesq=float("nan"), estoi=estoi, epoch=epoch)
        best = load_training_checkpoint(pman.path("best_pesq"))
        assert best["meta"]["quality_metric"] == jman.quality_metric == "estoi"
        assert best["meta"]["best_quality"] == jman.best_quality
        if epoch == 1:  # ESTOI fell: best_pesq.pt stays epoch 0's
            assert best["step"] == 1 and os.path.getmtime(pman.path("best_pesq")) == before
    assert [c for c in copies if c[1] == "best_pesq"] == [(0, "best_pesq"), (2, "best_pesq")]
    assert load_training_checkpoint(pman.path("best_pesq"))["step"] == 3
    assert load_training_checkpoint(pman.path("best_loss"))["step"] == 2

    meta = load_training_checkpoint(pman.path("last"))["meta"]
    resumed = CheckpointManager(str(tmp_path / "p"), {"nf": 16})
    resumed.restore_from_meta(meta)
    assert (resumed.best_quality, resumed.quality_metric) == (0.45, "estoi")
    state.step = 4
    resumed.step(state, valid_loss=6.0, epoch=3, bad_epochs=1, best_valid=4.0,
                 pesq=float("nan"), estoi=0.44)  # worse: best_pesq.pt keeps step 3
    assert load_training_checkpoint(pman.path("best_pesq"))["step"] == 3
    for manager in (resumed, jman):
        with pytest.raises(ValueError, match="metric changed"):
            with mock.patch("storm_tpu.ckpt.save_checkpoint"):
                manager.step(state if manager is resumed else None, valid_loss=6.0,
                             **({"epoch": 4, "bad_epochs": 2, "best_valid": 4.0}
                                if manager is resumed else {}), pesq=3.0, estoi=0.5)
    torch.testing.assert_close(load_training_checkpoint(pman.path("last"))["params"]
                               ["score_net.output_layer.weight"],
                               pmodel.state_dict()["score_net.output_layer.weight"])
