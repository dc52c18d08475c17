"""Multichannel input (`spatial_channels` D = 2) in the port against the
reference on the CPU (the port's counterpart of tests/test_multichannel.py),
and on every entry point: the enhancement CLI (B=1, `--batch`,
`--stream_chunk_s`, `--quant int8`), the HTTP server, `evaluate` and the
in-training evaluation, each held against the in-process enhancer.

Tiny nets (nf 16, n_fft 62, hop 16), the same random weights in both
packages through the carrier (`convert.params_from_jax`), inputs from
numpy seeds. Tolerances: losses 1e-5 relative and gradients as
tests/test_torch_train.py holds them (1e-4 of each tensor's scale plus 1e-5
of the model's largest gradient); enhanced waveforms 1e-4 of their scale
with the reference's noise replayed (NCSN++'s float32 tolerance through a
few sampler steps and the iSTFT, as tests/test_torch_inference.py); an
entry point against the in-process enhancer on the same generator, bit for
bit before the WAV's 16-bit rounding and exactly after it.
"""
import csv
import http.client
import json
import os
import threading
from unittest import mock

import jax
import numpy as np
import pytest
import torch
from test_torch_inference import STORM_TINY, jax_chunk_noise, random_params, wave
from test_torch_train import _assert_grads_close
from torch_parity import ReplayNoise, assert_close_rel, jax_noise_schedule, tt

from storm_tpu.data.datasets import Specs as JSpecs
from storm_tpu.models.factory import build_model as jbuild
from storm_tpu.utils.inference import BucketedEnhancer as JBucketed
from storm_tpu.utils.inference import evaluate_model as jevaluate_model
from storm_tpu_torch import enhancement, evaluate, serve
from storm_tpu_torch.ckpt import save_checkpoint
from storm_tpu_torch.convert import params_from_jax
from storm_tpu_torch.data import datasets as pds
from storm_tpu_torch.data.audio import load_wav, save_wav
from storm_tpu_torch.models.base import spatial_channels
from storm_tpu_torch.models.factory import build_model as pbuild
from storm_tpu_torch.utils import metrics as pm
from storm_tpu_torch.utils.graphs import programs_of
from storm_tpu_torch.utils.inference import BucketedEnhancer, evaluate_model
from storm_tpu_torch.utils.server import decode_wav_bytes, encode_wav_bytes
from storm_tpu_torch.utils.serving import calibrate_or_load_scales
from storm_tpu_torch.utils.streaming import stream_enhance

D, F = 2, 32
STORM2 = dict(STORM_TINY, spatial_channels=D)
ONE_NET = {"nf": 16, "ch_mult": [1, 2], "init_scale": 1.0, "n_fft": 62, "hop_length": 16,
           "sde": "ouve", "spatial_channels": D}
WAIT = 120


def _pair(cfg, seed=0):
    """(reference model, its weights, the port model with them, on the CPU)."""
    jmodel = jbuild(dict(cfg))
    params = random_params(jmodel, (1, F, 64), seed)
    pmodel = pbuild(dict(cfg), device="cpu")
    pmodel.load_state_dict(params_from_jax(params, target=pmodel), strict=True)
    return jmodel, params, pmodel


@pytest.fixture(scope="module")
def pair():
    return _pair(STORM2, seed=7)


def waves(n, seed, channels=D):
    """`channels` channels of the tone in noise of their own: (channels, n)."""
    return np.stack([wave(n, seed + 100 * c) for c in range(channels)])


def _spec_batch(seed, B=2, T=32):
    rng = np.random.default_rng(seed)
    x = (0.3 * rng.standard_normal((B, D, F, T, 2))).astype(np.float32)
    y = (x + 0.2 * rng.standard_normal((B, D, F, T, 2))).astype(np.float32)
    t = np.asarray([0.2, 0.8], np.float32)
    z = (rng.standard_normal((B, D, F, T, 2)) / np.sqrt(2)).astype(np.float32)
    return x, y, t, z


# --- the model layer: losses, gradients, a step


def test_storm_d2_loss_and_gradients_match_reference(pair):
    jmodel, params, pmodel = pair
    x, y, t, z = _spec_batch(0)
    (want, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p, *a: jmodel.loss_given_tz(p, a[:2], *a[2:]), has_aux=True))(params, x, y, t, z)
    pmodel.train()
    aux = pmodel.compute_gradients((tt(x), tt(y)), tt(t), tt(z))
    assert set(aux) == set(jaux)
    for k in aux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-5, err_msg=k)
    _assert_grads_close(pmodel, jgrads)


def test_storm_d2_train_step_moves_the_weights_and_sums_its_examples():
    """The reference test's step: the loss is finite, every net moves, and
    the per-example losses (the masked validation's) sum to the loss."""
    from storm_tpu_torch.models.base import init_train_state

    _, _, pmodel = _pair(STORM2, seed=1)
    x, y, _, _ = _spec_batch(1)
    batch = (tt(x), tt(y))
    before = {k: v.clone() for k, v in pmodel.state_dict().items()}
    state = init_train_state(pmodel.train(), 1e-3)
    aux = pmodel.train_step(state, batch, torch.Generator().manual_seed(2))
    assert state.step == 1 and np.isfinite(float(aux["loss"]))
    for net in ("denoiser_net.", "score_net."):
        assert any(not torch.equal(v, before[k]) for k, v in pmodel.state_dict().items()
                   if k.startswith(net))
    per = pmodel.loss_per_example(batch, torch.Generator().manual_seed(3))
    loss, _ = pmodel.loss_fn(batch, torch.Generator().manual_seed(3))
    assert per.shape == (2,)
    torch.testing.assert_close(per.sum(), loss, rtol=1e-5, atol=0)


@pytest.mark.parametrize("mode", ["score-only", "denoiser-only"])
def test_single_net_d2_losses_and_gradients_match_reference(mode):
    """The score model's DSM loss and the denoiser's mse loss, both the
    batch's mean, at D = 2 (the reference test's `test_score_d2_loss` and
    `test_discriminative_d2_loss`)."""
    jmodel, params, pmodel = _pair(dict(ONE_NET, mode=mode), seed=2)
    x, y, t, z = _spec_batch(4)
    if mode == "score-only":
        fn = lambda p, x, y: jmodel.loss_given_tz(p, (x, y), t, z)  # noqa: E731
        drawn = (tt(t), tt(z))
    else:
        fn = lambda p, x, y: jmodel.loss_fn(p, jax.random.PRNGKey(0), (x, y), False)  # noqa
        drawn = ()
    (want, _), jgrads = jax.jit(jax.value_and_grad(fn, has_aux=True))(params, x, y)
    aux = pmodel.train().compute_gradients((tt(x), tt(y)), *drawn)
    np.testing.assert_allclose(float(aux["loss"]), float(want), rtol=1e-5)
    _assert_grads_close(pmodel, jgrads)


# --- enhancement


def test_storm_d2_enhance_matches_reference(pair):
    """(1, D, samples) through both packages' enhance at N=3 (NFE 4), the
    reference's noise replayed."""
    jmodel, params, pmodel = pair
    n = 31 * 16
    y = (0.1 * np.random.default_rng(0).standard_normal((1, D, n))).astype(np.float32)
    key = jax.random.PRNGKey(1)
    want, jnfe = jmodel.make_enhance(N=3)(params, y, key)
    noise = ReplayNoise(jax_noise_schedule(key, (1, D, F, 64), 3, corrector="none"))
    got, nfe = pmodel.enhance(tt(y), N=3, noise=noise)
    assert noise.exhausted() and got.shape == (1, D, n) and nfe == int(jnfe) == 4
    assert_close_rel(got.numpy(), np.asarray(want), 1e-4, "enhance D=2")


def test_bucketed_enhancer_d2_matches_reference(pair):
    """(D, T) and (B, D, T) keep their shape and equal the reference's;
    another channel count raises ValueError in both."""
    jmodel, params, pmodel = pair
    rng = np.random.default_rng(0)
    enh = BucketedEnhancer(pmodel, N=2, bucket_frames=16)
    jenh = JBucketed(jmodel, params, N=2, bucket_frames=16)
    assert enh.spatial_channels == spatial_channels(pmodel) == D
    for rows, seed in ((None, 1), (3, 2)):
        shape = (D, 3000) if rows is None else (rows, D, 3000)
        y = (0.1 * rng.standard_normal(shape)).astype(np.float32)
        key = jax.random.PRNGKey(seed)
        want, jnfe = jenh(y, key)
        noise = ReplayNoise(jax_noise_schedule(key, (rows or 1, D, F, 256), 2,
                                               corrector="none"))
        got, nfe = enh(y, noise=noise)
        assert noise.exhausted() and got.shape == y.shape and nfe == int(jnfe)
        assert_close_rel(got, np.asarray(want), 1e-4, f"BucketedEnhancer {shape}")
    bad = rng.standard_normal((3, 3000)).astype(np.float32)
    with pytest.raises(ValueError, match="expected 2 spatial channels"):
        enh(bad)
    with pytest.raises(ValueError):
        jenh(bad, jax.random.PRNGKey(3))


def test_d2_program_replays_the_eager_loop(pair):
    """The captured program's key holds the D axis, and its replays (on the
    CPU: its body on the static buffers) equal the eager loop bit for bit,
    a minibatch's row-padded chunk included."""
    _, _, pmodel = pair
    y = waves(1500, 3)
    yb = np.stack([waves(900, 4), waves(900, 5), waves(900, 6)])
    for kw, inp in (({}, y), ({"minibatch": 2}, yb)):
        eager = BucketedEnhancer(pmodel, N=1, graphs=False, **kw)(
            inp, torch.Generator().manual_seed(8))[0]
        graphed = BucketedEnhancer(pmodel, N=1, **kw)
        for _ in range(3):  # the eager first call, the warm-up, a replay
            got = graphed(inp, torch.Generator().manual_seed(8))[0]
            np.testing.assert_array_equal(got, eager)
    shapes = {k[0] for k in programs_of(pmodel).programs}
    assert (1, D, 2048) in shapes and (2, D, 1024) in shapes


def test_stream_d2_matches_reference(pair):
    """A (D, T) recording in 1024-sample chunks, 2 per call, each call
    chunked by a minibatch of 2: the reference's keys replayed in order."""
    from storm_tpu.utils.streaming import stream_enhance as jstream

    jmodel, params, pmodel = pair
    N, y = 1, waves(3000, 9)
    kw = dict(chunk_samples=1000, overlap_samples=256, max_batch=2)
    key = jax.random.PRNGKey(6)
    want, nfe = jstream(JBucketed(jmodel, params, minibatch=2, N=N), y, key, **kw)
    draws, k = [], key
    for _ in range(2):
        k, kc = jax.random.split(k)
        draws += jax_chunk_noise(kc, [(2, D, F, 128)], N, corrector="none")
    noise = ReplayNoise(draws)
    got, pnfe = stream_enhance(BucketedEnhancer(pmodel, minibatch=2, N=N), y, noise=noise, **kw)
    assert noise.exhausted() and got.shape == y.shape and pnfe == int(nfe)
    assert_close_rel(got, np.asarray(want), 1e-4, "streamed D=2")


def test_evaluate_model_d2_matches_reference(pair, tmp_path):
    """The in-training evaluation enhances each validation pair's D channels
    and scores the first, as the reference's `evaluate_model` does."""
    jmodel, params, pmodel = pair
    _corpus(tmp_path, {"cv": [7000, 7100]})
    jset = JSpecs(str(tmp_path), "valid", format="wsj0", spatial_channels=D)
    pset = pds.Specs(str(tmp_path), "valid", format="wsj0", spatial_channels=D)
    key = jax.random.PRNGKey(0)
    want = jevaluate_model(jmodel, params, jset, 2, key=key, minibatch=2, N=1)
    noise = ReplayNoise(jax_chunk_noise(jax.random.split(key)[1], [(2, D, F, 512)], 1,
                                        corrector="none"))
    got = evaluate_model(pmodel, pset, 2, noise=noise, minibatch=2, N=1)
    assert noise.exhausted()
    np.testing.assert_allclose(got[1:3], want[1:3], rtol=1e-3)  # SI-SDR, ESTOI


# --- the entry points on two-channel WAVs


def _corpus(root, subsets, channels=D):
    for sub, lengths in subsets.items():
        for kind in ("clean", "noisy"):
            os.makedirs(os.path.join(root, sub, kind), exist_ok=True)
        for i, n in enumerate(lengths):
            x = np.stack([0.3 * np.sin(2 * np.pi * 300 * (c + 1) * np.arange(n) / 16000)
                          for c in range(channels)]).astype(np.float32)
            save_wav(os.path.join(root, sub, "clean", f"u{i}.wav"), x)
            save_wav(os.path.join(root, sub, "noisy", f"u{i}.wav"),
                     x + 0.05 * waves(n, i, channels))


@pytest.fixture(scope="module")
def served(pair, tmp_path_factory):
    """The pair's port model as a checkpoint, and a directory of noisy
    files: two of 2 channels in two buckets, one of 3 channels."""
    root = tmp_path_factory.mktemp("d2")
    ckpt = str(root / "tiny.pt")
    save_checkpoint(ckpt, STORM2, pair[2].state_dict())
    noisy = root / "noisy"
    noisy.mkdir()
    save_wav(str(noisy / "a.wav"), waves(700, 1))
    save_wav(str(noisy / "b.wav"), waves(1500, 2))
    save_wav(str(noisy / "c.wav"), waves(900, 3, channels=3))
    return ckpt, noisy


def _cli(ckpt, noisy, out, *extra):
    saved = {}
    with mock.patch.object(enhancement, "save_wav",
                           lambda path, x, sr: saved.update({os.path.basename(path): x})):
        enhancement.main(["--test_dir", str(noisy), "--enhanced_dir", str(out), "--ckpt", ckpt,
                          "--mode", "storm", "--N", "1", "--device", "cpu", *extra])
    return saved


def _files(noisy):
    return {f: load_wav(str(noisy / f))[0][:D] for f in sorted(os.listdir(noisy))}


@pytest.mark.parametrize("how", ["b1", "batch", "stream"])
def test_cli_d2_equals_the_in_process_enhancer(how, pair, served, tmp_path):
    """Each file's first D channels, enhanced as the CLI groups them (one a
    call; `--batch 2` by padded length; `--stream_chunk_s` in crossfaded
    chunks), equal the in-process enhancer's on the same generator; the
    3-channel file serves its first 2."""
    ckpt, noisy = served
    extra = {"b1": [], "batch": ["--batch", "2"],
             "stream": ["--stream_chunk_s", "0.05", "--stream_overlap_s", "0.01"]}[how]
    saved = _cli(ckpt, noisy, tmp_path / "out", *extra)
    files = _files(noisy)
    gen = torch.Generator().manual_seed(0)
    if how == "b1":
        enh = BucketedEnhancer(pair[2], N=1, corrector="ald")
        want = {f: enh(y, gen)[0] for f, y in files.items()}
    elif how == "batch":
        enh = BucketedEnhancer(pair[2], minibatch=2, N=1, corrector="ald")
        want = {}
        for group in (["a.wav", "c.wav"], ["b.wav"]):  # buckets 1024 and 2048
            L = enh.padded_len(max(files[f].shape[-1] for f in group))
            out = enh(np.stack([np.pad(files[f], [(0, 0), (0, L - files[f].shape[-1])])
                                for f in group]), gen)[0]
            want.update({f: o[..., : files[f].shape[-1]] for f, o in zip(group, out)})
    else:
        enh = BucketedEnhancer(pair[2], minibatch=8, N=1, corrector="ald")
        want = {f: stream_enhance(enh, y, gen, chunk_samples=800, overlap_samples=160,
                                  max_batch=8)[0] for f, y in files.items()}
    assert sorted(saved) == sorted(want)
    for f in want:
        assert saved[f].shape == files[f].shape
        np.testing.assert_array_equal(saved[f], want[f], err_msg=f)


def test_cli_d2_writes_d_channel_wavs_and_refuses_a_mono_file(served, tmp_path, capsys):
    ckpt, noisy = served
    out = tmp_path / "out"
    enhancement.main(["--test_dir", str(noisy), "--enhanced_dir", str(out), "--ckpt", ckpt,
                      "--mode", "storm", "--N", "1", "--device", "cpu"])
    for f, y in _files(noisy).items():
        x, sr = load_wav(str(out / f))
        assert sr == 16000 and x.shape == y.shape and np.isfinite(x).all()
    mono = tmp_path / "mono"
    mono.mkdir()
    save_wav(str(mono / "m.wav"), wave(800, 1))
    with pytest.raises(SystemExit, match="m.wav: has 1 channels, model needs 2"):
        enhancement.main(["--test_dir", str(mono), "--enhanced_dir", str(out), "--ckpt", ckpt,
                          "--mode", "storm", "--device", "cpu"])


def test_cli_d2_int8_calibrates_on_d_channel_files(pair, served, tmp_path, capsys):
    """`--quant int8` calibrates on the files' D channels and serves what the
    in-process enhancer serves with the cached scales."""
    ckpt, noisy = served
    saved = _cli(ckpt, noisy, tmp_path / "out", "--quant", "int8", "--quant_min_channels", "8")
    assert "int8 calibration done (88 convs quantized" in capsys.readouterr().out
    files = _files(noisy)
    quant = calibrate_or_load_scales(
        pair[2], "storm", ckpt, lambda: list(files.values()), torch.Generator().manual_seed(1),
        N=1, min_channels=8, params_source="ema", model_sr=16000)
    assert "int8 scales loaded" in capsys.readouterr().out
    enh = BucketedEnhancer(pair[2], N=1, corrector="ald", quant=quant)
    gen = torch.Generator().manual_seed(0)
    for f, y in files.items():
        np.testing.assert_array_equal(saved[f], enh(y, gen)[0], err_msg=f)


def test_server_d2(pair, served):
    """The server warms (rows, D, T), reports `spatial_channels`, serves a
    2-channel payload (the first 2 of 3) as the enhancer serves it, and
    answers 400 to a mono one."""
    ckpt, _ = served
    warmed = []
    warm_up = BucketedEnhancer.warm_up

    def recorded(self, y, generator=None):
        warmed.append(np.shape(y))
        return warm_up(self, y, generator)

    args = serve.build_argparser().parse_args(
        ["--ckpt", ckpt, "--mode", "storm", "--N", "1", "--corrector", "none", "--port", "0",
         "--device", "cpu", "--dtype", "float32", "--batch", "2", "--max_wait_ms", "1",
         "--warmup_s", "0.05", "--seed", "4"])
    with mock.patch.object(BucketedEnhancer, "warm_up", recorded):
        httpd, batcher = serve.build_server(args)
    assert warmed == [(1, D, 1024), (2, D, 1024)]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    host, port = httpd.server_address[:2]
    conn = http.client.HTTPConnection(host, port, timeout=WAIT)
    try:
        conn.request("GET", "/healthz")
        assert json.loads(conn.getresponse().read())["spatial_channels"] == D
        y = waves(1500, 5, channels=3)
        conn.request("POST", "/enhance", body=encode_wav_bytes(y))
        r = conn.getresponse()
        assert r.status == 200, r.read()[:500]
        x, _ = decode_wav_bytes(r.read())
        conn.request("POST", "/enhance", body=encode_wav_bytes(wave(900, 1)))
        r = conn.getresponse()
        assert r.status == 400 and "1 channels, model needs 2" in json.loads(r.read())["error"]
        conn.request("GET", "/stats")
        stats = json.loads(conn.getresponse().read())
        assert stats["spatial_channels"] == D and stats["requests"] == 1
    finally:
        conn.close()
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
        thread.join(timeout=WAIT)
    # the request's wave as the server decoded it, through the warmed-up
    # enhancer's generator: two warm-up calls, then this row
    y2 = decode_wav_bytes(encode_wav_bytes(y))[0][:D]
    gen = torch.Generator().manual_seed(4)
    enh = BucketedEnhancer(pair[2], N=1, corrector="none")
    for rows in (1, 2):
        enh(np.zeros((rows, D, 1024), np.float32), gen)
    want = enh(np.pad(y2, [(0, 0), (0, 2048 - 1500)])[None], gen)[0][0, :, :1500]
    assert x.shape == (D, 1500)
    np.testing.assert_array_equal(x, decode_wav_bytes(encode_wav_bytes(want))[0])


def test_evaluate_cli_d2_scores_the_first_channel(pair, served, tmp_path, capsys):
    """`evaluate` enhances each test pair's D channels (in chunks of
    --batch) and scores channel 0: its rows are the in-process enhancer's."""
    ckpt, _ = served
    base = tmp_path / "corpus"
    _corpus(base, {"tt": [6600, 7000, 9000]})
    out_csv = str(tmp_path / "rows.csv")
    evaluate.main(["--ckpt", ckpt, "--mode", "storm", "--base_dir", str(base), "--device", "cpu",
                   "--N", "1", "--corrector", "none", "--batch", "2", "--csv", out_csv])
    rows = {r["file"]: r for r in csv.DictReader(open(out_csv))}
    pset = pds.Specs(str(base), "test", format="wsj0", spatial_channels=D)
    enh = BucketedEnhancer(pair[2], minibatch=2, N=1, corrector="none")
    gen = torch.Generator().manual_seed(0)
    items = [pset.__getitem__(i, raw=True) for i in range(3)]
    for idxs in ([0, 1], [2]):  # buckets 7168 and 9216
        L = enh.padded_len(max(items[i][1].shape[-1] for i in idxs))
        x_hats = enh(np.stack([np.pad(items[i][1], [(0, 0), (0, L - items[i][1].shape[-1])])
                               for i in idxs]), gen)[0]
        for j, i in enumerate(idxs):
            want = pm.si_sdr(items[i][0][0], x_hats[j][0, : items[i][1].shape[-1]])
            assert float(rows[f"u{i}.wav"]["si_sdr"]) == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("extra", [[], ["--train"], ["--distill"]], ids=["serving", "train",
                                                                        "distill"])
def test_bench_d2_lines(extra, capsys):
    """`bench --spatial_channels 2` builds both nets for two channels and
    runs each line on (B, 2, T) batches: the nets see 2-channel spectrograms."""
    from storm_tpu_torch import bench

    seen = []
    real = bench.build_model

    def build_and_watch(*args, **kwargs):
        model = real(*args, **kwargs)
        model.denoiser_net.register_forward_pre_hook(lambda m, inp: seen.append(inp[0].shape))
        return model

    with mock.patch.object(bench, "build_model", build_and_watch):
        bench.main(["--device", "cpu", "--nf", "16", "--batch", "2", "--frames", "32", "--N",
                    "1", "--reps", "1", "--spatial_channels", str(D), *extra])
    (line,) = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert np.isfinite(line["value"]) and line["value"] > 0
    assert seen and all(s[:2] == (2, D) for s in seen)


def test_server_d2_int8_calibrates_on_d_channels(served, capsys):
    """The server's int8 calibration reads the calibration files' first D
    channels: the reference's serve.py reads their first channel alone,
    which a D = 2 model refuses (ROADMAP Queue 3)."""
    ckpt, noisy = served
    args = serve.build_argparser().parse_args(
        ["--ckpt", ckpt, "--mode", "storm", "--N", "1", "--port", "0", "--device", "cpu",
         "--quant", "int8", "--quant_min_channels", "8", "--calib_dir", str(noisy)])
    with mock.patch("storm_tpu_torch.utils.serving.scale_cache_path",
                    lambda path: path + ".server_scales.json"):
        httpd, batcher = serve.build_server(args)
    httpd.server_close()
    batcher.close()
    assert "int8 calibration done (88 convs quantized" in capsys.readouterr().out
