"""The port's streaming enhancement against the reference's
(storm_tpu/utils/streaming.py): the crossfade ramp, the chunking and
overlap-add through an identity enhancer, the tiny model with replayed noise,
and the CLI's `--stream_chunk_s`, whose int8 calibration runs on one chunk's
length and records it in the scale cache.

Tolerances: the ramp and the identity path exact (the same float32
operations in the same order); the tiny model 1e-4 relative to the wave's
scale, as for whole files (test_torch_inference).
"""
import json
from unittest import mock

import jax
import numpy as np
import pytest
from test_torch_inference import STORM_TINY, jax_chunk_noise, tiny_storm_pair, wave
from torch_parity import ReplayNoise, assert_close_rel

from storm_tpu.utils.inference import BucketedEnhancer as JBucketed
from storm_tpu.utils.streaming import crossfade_ramp as jramp
from storm_tpu.utils.streaming import stream_enhance as jstream
from storm_tpu_torch import enhancement
from storm_tpu_torch.ckpt import save_checkpoint
from storm_tpu_torch.data.audio import load_wav, save_wav
from storm_tpu_torch.utils.inference import BucketedEnhancer
from storm_tpu_torch.utils.serving import params_digest, scale_cache_path
from storm_tpu_torch.utils.streaming import crossfade_ramp, stream_enhance


@pytest.mark.parametrize("n", [1, 2, 7, 64, 8000])
def test_crossfade_ramp_equals_reference(n):
    got = crossfade_ramp(n)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jramp(n))
    np.testing.assert_allclose(got + got[::-1], np.ones(n), atol=1e-6)


class _Identity:
    """Stands in for either package's BucketedEnhancer: x_hat = y, nfe 3."""

    def __init__(self, bucket=1024):
        self.bucket = bucket
        self.calls = []

    def padded_len(self, T):
        return -(-T // self.bucket) * self.bucket

    def __call__(self, y, *rest):
        y = np.asarray(y, np.float32)
        self.calls.append(y.shape)
        return y, 3


@pytest.mark.parametrize("T,chunk,overlap,max_batch", [
    (50_000, 8192, 2048, 4), (50_000, 8000, 0, 3), (30_001, 5000, 1999, 16),
    (8192, 8192, 1024, 2), (1000, 8192, 1024, 2), (9000, 1024, 500, 1)])
def test_stream_identity_equals_reference(T, chunk, overlap, max_batch):
    y = np.random.default_rng(T).standard_normal(T).astype(np.float32)
    kw = dict(chunk_samples=chunk, overlap_samples=overlap, max_batch=max_batch)
    port, ref = _Identity(), _Identity()
    got, nfe = stream_enhance(port, y, None, **kw)
    want, jnfe = jstream(ref, y, jax.random.PRNGKey(0), **kw)
    assert got.shape == y.shape and nfe == jnfe and port.calls == ref.calls
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_allclose(got, y, atol=1e-5)  # sum-to-one: the input back


def test_stream_refuses_bad_overlap_and_multichannel():
    with pytest.raises(ValueError, match="overlap"):
        stream_enhance(_Identity(), np.zeros(5000, np.float32), None, chunk_samples=1024,
                       overlap_samples=1024)
    with pytest.raises(NotImplementedError, match="multichannel"):
        stream_enhance(_Identity(), np.zeros((2, 5000), np.float32), None)


def test_stream_tiny_model_matches_reference():
    """4 chunks of 1024 samples (128 frames), 2 per call, each call chunked
    by a minibatch of 2: the reference's keys, replayed in order."""
    jmodel, params, pmodel = tiny_storm_pair(seed=5)
    N, T = 2, 3000
    y = wave(T, 3)
    kw = dict(chunk_samples=1000, overlap_samples=256, max_batch=2)  # 1000 -> 1024
    key = jax.random.PRNGKey(6)
    want, nfe = jstream(JBucketed(jmodel, params, minibatch=2, N=N, corrector="ald"), y, key,
                        **kw)
    draws = []
    k = key
    for _ in range(2):  # one key per call of stream_enhance, split again per chunk
        k, kc = jax.random.split(k)
        draws += jax_chunk_noise(kc, [(2, 32, 128)], N)
    noise = ReplayNoise(draws)
    got, pnfe = stream_enhance(BucketedEnhancer(pmodel, minibatch=2, N=N, corrector="ald"), y,
                               noise=noise, **kw)
    assert noise.exhausted() and got.shape == (T,) and pnfe == int(nfe) == 2 * (1 + 2 * N)
    assert_close_rel(got, np.asarray(want), 1e-4, "streamed tiny model")


def test_cli_streams_and_calibrates_on_one_chunk(tmp_path, capsys):
    _, _, pmodel = tiny_storm_pair(seed=5)
    ckpt = str(tmp_path / "tiny.pt")
    save_checkpoint(ckpt, STORM_TINY, pmodel.state_dict())
    noisy, out = tmp_path / "noisy", tmp_path / "out"
    noisy.mkdir()
    lengths = {"long.wav": 5000, "short.wav": 800}
    for name, n in lengths.items():
        save_wav(str(noisy / name), wave(n, n))
    calls = []
    enhance = type(pmodel).enhance

    def recorded(model, yb, **kw):
        calls.append(tuple(yb.shape))
        return enhance(model, yb, **kw)

    argv = ["--test_dir", str(noisy), "--enhanced_dir", str(out), "--ckpt", ckpt,
            "--mode", "storm", "--N", "1", "--corrector", "none", "--device", "cpu",
            "--stream_chunk_s", "0.0625", "--stream_overlap_s", "0.016", "--timeit"]
    with mock.patch.object(type(pmodel), "enhance", recorded):
        enhancement.main(argv)
    # long: 1000-sample chunks -> 1024, hop 768: 7 chunks, one call of 8 rows;
    # short: one chunk (800 <= 1024), its own call of 8 rows
    assert calls == [(8, 1024), (8, 1024)]
    said = capsys.readouterr().out
    assert "long.wav: nfe=2 rtf=" in said and "short.wav: nfe=2 rtf=" in said
    for name, n in lengths.items():
        x, sr = load_wav(str(out / name))
        assert sr == 16000 and x.shape == (1, n) and np.isfinite(x).all()

    enhancement.main(argv + ["--quant", "int8", "--quant_min_channels", "8"])
    assert "int8 calibration done (82 convs quantized" in capsys.readouterr().out
    meta = json.load(open(scale_cache_path(ckpt)))["_meta"]
    assert meta == {"params": "ema", "min_channels": 8, "mode": "storm", "stream_chunk_s": 0.0625,
                    "calib_N": 1, "params_sha256": params_digest(pmodel), "calib_len": 1024,
                    "calib_files": 2}
    enhancement.main(argv[:-5] + ["--quant", "int8", "--quant_min_channels", "8"])  # whole files
    said = capsys.readouterr().out
    assert "config mismatch" in said and "calibration done" in said
    assert json.load(open(scale_cache_path(ckpt)))["_meta"]["stream_chunk_s"] == 0.0
