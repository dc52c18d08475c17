"""Distillation through the port's entry points, after the reference's
tests/test_distill_cli.py: a tiny StoRM teacher, `train --mode distill`,
a checkpoint whose config says `mode: distill`, then `enhancement` (one
file, `--batch`, streaming, int8), `serve` and `evaluate` at `--mode
distill` (NFE 2), with the teacher refusals and the deepcache refusal; and
the two scripts of the quality record: the synthetic corpus (the port's
script writes the reference script's bytes) and the quality grid (its noisy
row is the reference script's, and a row is `evaluate`'s on the same files).

Tiny nets (nf 8, ch_mult (1, 1), n_fft 62), on the CPU.
"""
import csv
import glob
import http.client
import json
import os
import runpy
import sys
import threading

import jax
import numpy as np
import pytest
import torch
from test_torch_distill import TEACHER
from test_torch_inference import wave
from test_torch_train import _write_corpus
from torch_parity import random_params

from storm_tpu.ckpt import save_checkpoint as jsave_checkpoint
from storm_tpu.models.base import init_train_state as jinit_state
from storm_tpu.models.base import make_optimizer as jmake_optimizer
from storm_tpu.models.factory import build_model as jbuild
from storm_tpu_torch import enhancement, evaluate, serve, train
from storm_tpu_torch.ckpt import load_training_checkpoint, save_checkpoint
from storm_tpu_torch.convert import params_from_jax
from storm_tpu_torch.data.audio import load_wav, save_wav
from storm_tpu_torch.models.factory import build_model as pbuild
from storm_tpu_torch.scripts import make_synth_corpus, nfe_quality
from storm_tpu_torch.utils.server import decode_wav_bytes, encode_wav_bytes
from storm_tpu_torch.utils.serving import scale_cache_path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CORPUS = ["--n_train", "2", "--n_valid", "1", "--n_test", "1", "--seed", "0"]
SHORT = ["--dur_lo", "0.5", "--dur_hi", "0.8"]  # the quality grid's files: 0.5-0.8 s
MIN_CH = 8


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _run_reference_script(name, argv, monkeypatch):
    """scripts/<name>.py of the reference, in-process, as its CLI runs it."""
    monkeypatch.setattr(sys, "argv", [name] + argv)
    runpy.run_path(os.path.join(REPO, "scripts", f"{name}.py"), run_name="__main__")


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """{durations: (the tiny corpus by the port's script, by the reference's)},
    at the default durations (2.2-4.0 s) and at SHORT's."""
    root = tmp_path_factory.mktemp("corpora")
    out = {}
    for name, extra in (("default", []), ("short", SHORT)):
        port, ref = str(root / name / "port"), str(root / name / "reference")
        make_synth_corpus.main(["--root", port] + TINY_CORPUS + extra)
        with pytest.MonkeyPatch.context() as mp:
            _run_reference_script("make_synth_corpus", ["--root", ref] + TINY_CORPUS + extra, mp)
        out[name] = port, ref
    return out


@pytest.mark.parametrize("durations,low,high", [("default", 2.2, 4.0), ("short", 0.5, 0.8)])
def test_corpus_script_writes_the_reference_bytes(corpora, durations, low, high):
    port, ref = corpora[durations]
    names = _files(port)
    assert names == _files(ref) and len(names) == 8
    for name in names:
        with open(os.path.join(port, name), "rb") as a, open(os.path.join(ref, name), "rb") as b:
            assert a.read() == b.read(), name
    x, sr = load_wav(os.path.join(port, "tt", "clean", "u0000.wav"))
    assert sr == 16000 and low * sr <= x.shape[-1] <= high * sr


def test_corpus_script_has_the_reference_flags():
    ours = make_synth_corpus.parse_args(["--root", "r"])
    assert vars(ours) == {"root": "r", "n_train": 512, "n_valid": 32, "n_test": 32,
                          "snr_lo": 0.0, "snr_hi": 8.0, "dur_lo": 2.2, "dur_hi": 4.0, "seed": 0}


@pytest.fixture(scope="module")
def teacher(tmp_path_factory):
    """A tiny StoRM teacher's checkpoint (its EMA weights are what distill reads)."""
    path = str(tmp_path_factory.mktemp("teacher") / "teacher.pt")
    model = pbuild(dict(TEACHER), device="cpu", seed=1)
    save_checkpoint(path, TEACHER, model.state_dict())
    return path


@pytest.fixture(scope="module")
def student(tmp_path_factory, teacher):
    """`train --mode distill` from the teacher: one epoch of 2 steps with the
    evaluation (NFE 2) on a validation file of ~0.43 s."""
    root = tmp_path_factory.mktemp("student")
    corpus = _write_corpus(root / "corpus", n_train=4, n_valid=1, valid_len=(6600, 7100))
    out = _capture(lambda: train.main(
        ["--mode", "distill", "--teacher_ckpt", teacher, "--distill_N", "2",
         "--distill_method", "euler", "--base_dir", corpus, "--batch_size", "2",
         "--num_frames", "32", "--num_workers", "2", "--num_eval_files", "1",
         "--max_steps", "2", "--log_every_n_steps", "1", "--log_dir", str(root / "logs"),
         "--device", "cpu"]))
    (run,) = glob.glob(str(root / "logs" / "mode=distill_*"))
    return run, out


def _capture(fn):
    from io import StringIO
    from contextlib import redirect_stdout

    buf = StringIO()
    with redirect_stdout(buf):
        fn()
    return buf.getvalue()


def test_train_distills_from_the_teacher(student, teacher):
    run, out = student
    assert "distilling teacher" in out and "(N=2 euler targets)" in out
    assert os.path.basename(run).startswith("mode=distill_sde=OUVESDE_")
    last = load_training_checkpoint(os.path.join(run, "checkpoints", "last.pt"))
    cfg = last["config"]
    assert cfg["mode"] == "distill" and cfg["nf"] == 8 and cfg["ch_mult"] == [1, 1]
    assert (cfg["distill_N"], cfg["distill_method"], cfg["distill_gt_weight"]) == (2, "euler", 0.0)
    assert (cfg["n_fft"], cfg["hop_length"]) == (62, 16)  # the teacher's, not the CLI's
    t_ema = load_training_checkpoint(teacher)["ema_params"]
    den = [k for k in t_ema if k.startswith("denoiser_net.")]
    assert den and all(torch.equal(last["params"][k], t_ema[k]) for k in den)
    assert any(not torch.equal(last["params"][k], t_ema[k]) for k in t_ema
               if k.startswith("score_net."))
    rows = [json.loads(line) for line in open(os.path.join(run, "metrics.jsonl"))]
    (epoch,) = [r for r in rows if "valid_loss" in r]
    assert np.isfinite(epoch["valid_loss"]) and np.isfinite(epoch["ValidationSISDR"])
    assert [r["step"] for r in rows if "train_loss" in r] == [1, 2]


def test_train_refuses_a_missing_or_non_storm_teacher(tmp_path, corpora):
    args = ["--mode", "distill", "--base_dir", corpora["short"][0], "--nolog", "--device", "cpu"]
    with pytest.raises(SystemExit, match="--mode distill requires --teacher_ckpt"):
        train.main(args)
    other = str(tmp_path / "score.pt")
    cfg = dict(TEACHER, mode="score-only")
    save_checkpoint(other, cfg, pbuild(dict(cfg), device="cpu").state_dict())
    with pytest.raises(SystemExit, match=r"--teacher_ckpt must be a storm \(regen-\*\) "
                                         r"checkpoint, got mode='score-only'"):
        train.main(args + ["--teacher_ckpt", other])


def test_trainer_parser_has_the_reference_distill_flags():
    from test_torch_evaluate import _options, _port_parser, _reference_parser

    flags = ["teacher_ckpt", "distill_N", "distill_method", "distill_gt_weight", "debug_nans"]
    ours = _port_parser(lambda argv: train.parse_args(argv))
    assert _options(ours, flags) == _options(_reference_parser("train", []), flags)


def _ckpt(student):
    return os.path.join(student[0], "checkpoints", "last.pt")


def _noisy_dir(root, lengths=(900, 1531, 1400)):
    noisy = root / "noisy"
    noisy.mkdir()
    for i, n in enumerate(lengths):
        save_wav(str(noisy / f"u{i}.wav"), wave(n, i))
    return noisy, {f"u{i}.wav": n for i, n in enumerate(lengths)}


@pytest.mark.parametrize("extra", [[], ["--batch", "2"],
                                   ["--stream_chunk_s", "0.06", "--stream_overlap_s", "0.01"],
                                   ["--quant", "int8", "--quant_min_channels", str(MIN_CH)]],
                         ids=["one", "batch", "stream", "int8"])
def test_cli_enhances_at_nfe2(tmp_path, student, extra, capsys):
    noisy, lengths = _noisy_dir(tmp_path)
    ckpt = _ckpt(student)
    if "int8" in extra:  # a checkpoint of its own, so that it calibrates
        ckpt = str(tmp_path / "s.pt")
        os.link(_ckpt(student), ckpt)
    argv = ["--test_dir", str(noisy), "--enhanced_dir", str(tmp_path / "out"), "--ckpt", ckpt,
            "--mode", "distill", "--device", "cpu", "--timeit", "--N", "7", *extra]
    enhancement.main(argv)
    text = capsys.readouterr().out
    for name, n in lengths.items():
        x, sr = load_wav(str(tmp_path / "out" / name))
        assert sr == 16000 and x.shape == (1, n) and np.isfinite(x).all()
    if not extra:
        assert all(f"{name}: nfe=2 " in text for name in lengths)
    if "int8" in extra:
        assert "int8 calibration done (" in text and "(0 convs" not in text
        meta = json.load(open(scale_cache_path(ckpt)))["_meta"]
        assert (meta["mode"], meta["calib_N"]) == ("distill", 0)
        enhancement.main(argv)
        assert "int8 scales loaded from" in capsys.readouterr().out


def test_cli_mode_checks_and_deepcache_refusal(tmp_path, student, teacher):
    noisy, _ = _noisy_dir(tmp_path, (900,))
    base = ["--test_dir", str(noisy), "--enhanced_dir", str(tmp_path / "o"), "--device", "cpu"]
    with pytest.raises(SystemExit, match="--mode storm incompatible with checkpoint mode distill"):
        enhancement.main(base + ["--ckpt", _ckpt(student), "--mode", "storm"])
    with pytest.raises(SystemExit, match="--mode distill incompatible with checkpoint mode "
                                         "regen-joint-training"):
        enhancement.main(base + ["--ckpt", teacher, "--mode", "distill"])
    with pytest.raises(ValueError, match="distilled serving does not support --deepcache"):
        enhancement.main(base + ["--ckpt", _ckpt(student), "--mode", "distill",
                                 "--deepcache", "3"])
    with pytest.raises(ValueError, match="distilled serving does not support --deepcache"):
        serve.build_server(serve.build_argparser().parse_args(
            ["--ckpt", _ckpt(student), "--mode", "distill", "--port", "0", "--deepcache", "3",
             "--device", "cpu"]))
    with pytest.raises(ValueError, match="distilled serving does not support --deepcache"):
        evaluate.main(["--ckpt", _ckpt(student), "--mode", "distill", "--base_dir", str(tmp_path),
                       "--deepcache", "3", "--device", "cpu"])


def test_server_replies_with_nfe2(student):
    args = serve.build_argparser().parse_args(
        ["--ckpt", _ckpt(student), "--mode", "distill", "--port", "0", "--batch", "2",
         "--warmup_buckets", "0.06", "--device", "cpu"])
    httpd, batcher = serve.build_server(args)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        host, port = httpd.server_address[:2]
        conn = http.client.HTTPConnection(host, port, timeout=120)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        assert (health["mode"], health["dtype"]) == ("distill", "bfloat16")
        conn.request("POST", "/enhance", body=encode_wav_bytes(wave(1100, 5), 16000))
        r = conn.getresponse()
        x, sr = decode_wav_bytes(r.read())
        assert r.status == 200 and r.getheader("X-NFE") == "2"
        assert sr == 16000 and x.shape == (1, 1100) and np.isfinite(x).all()
        conn.close()
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
        thread.join(timeout=60)


@pytest.fixture(scope="module")
def twin_ckpts(tmp_path_factory):
    """One student's random weights as a reference checkpoint (orbax) and a
    port checkpoint."""
    root = tmp_path_factory.mktemp("twins")
    cfg = dict(TEACHER, mode="distill")
    jmodel = jbuild(dict(cfg))
    params = random_params(jax.eval_shape(
        lambda: jmodel.init_params(jax.random.PRNGKey(0), (1, 32, 64))), 2)
    jsave_checkpoint(str(root / "reference"), jinit_state(params, jmake_optimizer(1e-4)), cfg)
    pmodel = pbuild(dict(cfg), device="cpu")
    sd = params_from_jax(params, target=pmodel)
    save_checkpoint(str(root / "port.pt"), cfg, sd)
    return str(root / "reference"), str(root / "port.pt")


def test_nfe_quality_rows_match_the_reference_and_evaluate(corpora, twin_ckpts, tmp_path,
                                                           monkeypatch):
    """On the tiny corpus: the noisy row is the reference script's (the same
    files through the same metrics), and the port's row is `evaluate`'s mean
    over the same files (the same buckets, batches and noise)."""
    corpus = corpora["short"][0]
    jref, pref = twin_ckpts
    monkeypatch.setenv("STORM_TPU_JAX_CACHE", "0")
    _run_reference_script("nfe_quality", ["--ckpt", jref, "--base_dir", corpus, "--num_files",
                                          "24", "--configs", "pc N=30 none", "--json",
                                          str(tmp_path / "ref.json")], monkeypatch)
    want = json.load(open(tmp_path / "ref.json"))
    got = nfe_quality.main(["--ckpt", pref, "--base_dir", corpus, "--num_files", "24",
                            "--configs", "pc N=30 none", "--bucket_frames", "64",
                            "--json", str(tmp_path / "port.json"), "--device", "cpu"])
    assert got == json.load(open(tmp_path / "port.json")) and got["num_files"] == 1
    for k in ("si_sdr", "estoi"):
        np.testing.assert_allclose(got["noisy"][k], want["noisy"][k], rtol=1e-6, atol=1e-9)
    (row,) = got["results"]
    assert (row["config"], row["nfe"]) == ("pc N=30 none", 2) == (want["results"][0]["config"],
                                                                  want["results"][0]["nfe"])
    evaluate.main(["--ckpt", pref, "--mode", "distill", "--base_dir", corpus, "--num_files",
                   "24", "--csv", str(tmp_path / "e.csv"), "--device", "cpu"])
    rows = list(csv.DictReader(open(tmp_path / "e.csv")))
    assert len(rows) == 1
    assert row["si_sdr"] == np.mean([float(r["si_sdr"]) for r in rows])
    assert row["estoi"] == np.mean([float(r["estoi"]) for r in rows])
