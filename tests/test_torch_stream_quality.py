"""The port's stream_quality script (storm_tpu_torch/scripts/stream_quality.py)
against the JAX package's scripts/stream_quality.py and against direct calls.

A tiny StoRM (nf 16, n_fft 62) on 2 s pairs: the script's whole and
streamed outputs (captured where it scores them) must equal, bit for bit, a
direct `BucketedEnhancer` / `stream_enhance` call with a generator of the
same seed; its pairs must equal the JAX script's and its noisy SI-SDR and
ESTOI the JAX metric functions' within 1e-6; its rows and SUMMARY must carry
the JAX script's keys.
"""
import ast
import json
import os
import runpy

import numpy as np
import pytest
import torch
from test_torch_inference import STORM_TINY, tiny_storm_pair

from storm_tpu.utils.metrics import si_sdr as jsi_sdr
from storm_tpu.utils.stoi import stoi as jstoi
from storm_tpu_torch.ckpt import save_checkpoint
from storm_tpu_torch.scripts import stream_quality
from storm_tpu_torch.utils.inference import BucketedEnhancer
from storm_tpu_torch.utils.streaming import stream_enhance

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 16000
ARGV = ["--dur_s", "2", "--n_files", "2", "--N", "2", "--chunk_s", "0.5", "--overlap_s",
        "0.125", "--batch", "2", "--seed", "3", "--device", "cpu"]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    _, _, pmodel = tiny_storm_pair()
    path = str(tmp_path_factory.mktemp("stream_quality") / "tiny.pt")
    save_checkpoint(path, STORM_TINY, pmodel.state_dict())
    return path, pmodel


def _reference_keys():
    """The keys of the JAX script's per-file row and SUMMARY dicts."""
    tree = ast.parse(open(os.path.join(REPO, "scripts", "stream_quality.py")).read())
    keys = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and isinstance(node.targets[0], ast.Name)):
            keys[node.targets[0].id] = [k.value for k in node.value.keys]
    return keys["row"], keys["summary"]


def test_outputs_equal_direct_calls_and_the_reference_metrics(tiny, tmp_path, monkeypatch,
                                                              capsys):
    path, model = tiny
    scored, si_sdr = [], stream_quality.si_sdr

    def recording_si_sdr(x, est):
        scored.append(np.array(est, copy=True))
        return si_sdr(x, est)

    monkeypatch.setattr(stream_quality, "si_sdr", recording_si_sdr)
    out = stream_quality.main(ARGV + ["--ckpt", path, "--json", str(tmp_path / "sq.json")])
    assert out == json.load(open(tmp_path / "sq.json"))
    printed = capsys.readouterr().out.splitlines()
    assert [json.loads(ln) for ln in printed if ln.startswith("{")] == out["rows"]
    assert json.loads(printed[-1][len("SUMMARY "):]) == out["summary"]

    # the same pairs and noise, directly: whole at B=1, then streamed, per file
    pairs = stream_quality.make_pairs(2, 2.0, 5.0, 3)
    gen = torch.Generator().manual_seed(3)
    kw = dict(sampler_type="pc", N=2, corrector="none", quant=None)
    whole, chunked = BucketedEnhancer(model, minibatch=1, **kw), BucketedEnhancer(
        model, minibatch=2, **kw)
    for i, (x, y) in enumerate(pairs):
        xw = whole(y, gen)[0][: len(x)]
        xs = stream_enhance(chunked, y, gen, chunk_samples=8000, overlap_samples=2000,
                            max_batch=2)[0][: len(x)]
        noisy, got_w, got_s = scored[3 * i: 3 * i + 3]
        np.testing.assert_array_equal(noisy, y)
        np.testing.assert_array_equal(got_w, xw)
        np.testing.assert_array_equal(got_s, xs)
        assert np.isfinite(xw).all() and xw.shape == x.shape == (2 * SR,)
        row = out["rows"][i]
        assert abs(row["noisy_sisdr"] - float(jsi_sdr(x, y))) <= 1e-6
        assert abs(row["noisy_estoi"] - float(jstoi(x, y, SR, extended=True))) <= 1e-6
    assert not np.array_equal(scored[1], scored[2])  # the chunking shows

    # the JAX script's pairs
    synth = runpy.run_path(os.path.join(REPO, "scripts", "make_synth_corpus.py"))
    rng = np.random.default_rng(3)
    for x, y in pairs:
        jx = synth["make_utterance"](rng, 2.0)
        jn = synth["make_noise"](rng, len(jx))
        g = np.sqrt((jx**2).mean() / ((jn**2).mean() * 10 ** (5.0 / 10)))
        np.testing.assert_array_equal(x, jx.astype(np.float32))
        np.testing.assert_array_equal(y, (jx + g * jn).astype(np.float32))


def test_rows_and_summary_have_the_reference_keys(tiny):
    row_keys, summary_keys = _reference_keys()
    out = stream_quality.main(ARGV + ["--ckpt", tiny[0], "--n_files", "1", "--dur_s", "1"])
    assert list(out["rows"][0]) == row_keys
    assert list(out["summary"]) == summary_keys
    s = out["summary"]
    assert (s["quant"], s["deepcache"], s["deepcache_depth"], s["stream_audio_s_per_s"]) == (
        None, 0, None, None)
    assert np.isfinite(s["whole"] + s["stream"] + s["noisy"]).all()


def test_int8_deepcache_dtype_and_timeit(tiny, capsys):
    path, _ = tiny
    out = stream_quality.main(ARGV + ["--ckpt", path, "--n_files", "1", "--dur_s", "1",
                                      "--quant", "int8", "--quant_min_channels", "8",
                                      "--deepcache", "2", "--deepcache_depth", "1",
                                      "--dtype", "float32", "--timeit"])
    text = capsys.readouterr().out
    assert "int8 calibration done" in text and "chunked-serving throughput" in text
    s = out["summary"]
    assert (s["quant"], s["deepcache"], s["deepcache_depth"]) == ("int8", 2, 1)
    assert s["stream_audio_s_per_s"] > 0 and np.isfinite(s["whole"] + s["stream"]).all()
    with pytest.raises(SystemExit, match="quantized 0 convs"):
        stream_quality.main(ARGV + ["--ckpt", path, "--n_files", "1", "--dur_s", "1",
                                    "--quant", "int8", "--quant_min_channels", "4096"])
