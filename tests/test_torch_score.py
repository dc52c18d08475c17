"""The score-only model (SGMSE+) against the reference's `ScoreModel`:
`score_apply`, the DSM loss and its gradients (mse, mae; OUVE and OUVP),
one `train_step` against `make_train_step`, `enhance` with pc (the
reference's noise replayed), ode, picard and deepcache, bfloat16, the int8
calibration and its scale file, and the CLIs on a tiny checkpoint.

Tiny nets (nf 16, three levels) with a small STFT (n_fft 62 -> 32 bins),
weights made with numpy from a seed and carried across by convert.py.
Tolerances: the score 1e-5 of its scale and the calibration's amax 1e-4
relative (the reference's float32 GroupNorm, test_torch_quant); losses 1e-5
relative and gradients per tensor 1e-4 of the tensor's scale plus 1e-5 of
the largest gradient element (test_torch_train); after one Adam step the
parameters 1e-6 absolute, except where the reference's gradient is below
that floor, whose sign Adam's first step follows (held to the step's bound,
2 lr); `enhance` 1e-4 of the output's scale in float32 (test_torch_storm),
bfloat16 in the ratio form of test_torch_bf16.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bf16 import RATIO, REALLY, _ratios
from test_torch_inference import wave
from test_torch_quant import _by_module
from test_torch_train import _write_corpus
from torch_parity import (ReplayNoise, assert_close_rel, jax_noise_schedule, random_params,
                          to_numpy_tree, tt)

from storm_tpu.models import quant as jquant
from storm_tpu.models.base import init_train_state as jinit_state
from storm_tpu.models.base import make_optimizer as jmake_optimizer
from storm_tpu.models.factory import build_model as jbuild
from storm_tpu.signal import cplx as jcplx
from storm_tpu_torch import enhancement, evaluate, serve, train
from storm_tpu_torch.ckpt import load_training_checkpoint, save_checkpoint
from storm_tpu_torch.convert import params_from_jax
from storm_tpu_torch.data.audio import load_wav, save_wav
from storm_tpu_torch.models import quant as pquant
from storm_tpu_torch.models.base import init_train_state
from storm_tpu_torch.models.factory import build_model as pbuild
from storm_tpu_torch.models.score import ScoreModel
from storm_tpu_torch.sde.sdes import OUVPSDE
from storm_tpu_torch.utils.serving import scale_cache_path

CONFIG = {"mode": "score-only", "nf": 16, "ch_mult": [1, 2, 2], "init_scale": 1.0,
          "n_fft": 62, "hop_length": 16, "sde": "ouve"}
OUVP = {"sde": "ouvp", "beta_min": 0.1, "beta_max": 1.0, "stiffness": 1.3}
F, MIN_CH = 32, 8
B, T = 2, 32  # training batch: 2 specs of 32 x 32


def _pair(cfg, shape=(1, F, 64), seed=0):
    """(reference model, its random weights, the port model with them)."""
    jmodel = jbuild(dict(cfg))
    params = random_params(jax.eval_shape(
        lambda: jmodel.init_params(jax.random.PRNGKey(0), shape)), seed)
    pmodel = pbuild(dict(cfg), device="cpu")
    pmodel.load_state_dict(params_from_jax(params, target=pmodel), strict=True)
    return jmodel, params, pmodel


@pytest.fixture(scope="module")
def pair():
    return _pair(CONFIG)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    x = (0.3 * rng.standard_normal((B, F, T, 2))).astype(np.float32)
    y = (x + 0.2 * rng.standard_normal((B, F, T, 2))).astype(np.float32)
    t = np.asarray([0.1, 0.7], np.float32)
    z = (rng.standard_normal((B, F, T, 2)) / np.sqrt(2)).astype(np.float32)
    return x, y, t, z


def test_build_wires_the_reference_config(pair):
    jmodel, _, pmodel = pair
    assert isinstance(pmodel, ScoreModel) and pmodel.batch_reduction == "mean"
    assert pmodel.dnn.total_channels == 4 and pmodel.dnn.conditional
    assert (pmodel.t_eps, pmodel.loss_type, pmodel.lr) == (jmodel.t_eps, jmodel.loss_type,
                                                          jmodel.lr)
    assert pmodel.sde == type(pmodel.sde)(**{k: getattr(jmodel.sde, k)
                                             for k in ("theta", "sigma_min", "sigma_max", "N")})
    ouvp = pbuild(dict(CONFIG, **OUVP), device="cpu")
    assert ouvp.sde == OUVPSDE(0.1, 1.0, 1.3) == OUVPSDE(**{
        k: getattr(jbuild(dict(CONFIG, **OUVP)).sde, k)
        for k in ("beta_min", "beta_max", "stiffness", "N")})
    with pytest.raises(NotImplementedError, match="mse or mae"):
        pbuild(dict(CONFIG, loss_type="sisdr"), device="cpu")


def test_score_apply_and_its_statistics_match_reference(pair):
    jmodel, params, pmodel = pair
    x, y, t, _ = _batch(1)
    want, jstats = jax.jit(lambda p, *a: jmodel.score_apply(p, *a, collect_stats=True))(
        params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y))
    with torch.no_grad():
        got, stats = pmodel.score_apply(tt(x), tt(t), tt(y), collect_stats=True)
        plain = pmodel.score_apply(tt(x), tt(t), tt(y))
    assert got.shape == x.shape and torch.equal(got, plain)
    assert_close_rel(got.numpy(), np.asarray(want), 1e-5, "score")
    jl = _by_module(jstats, "amax")
    assert jl.keys() == stats.keys() and len(jl) > 41
    for k, v in jl.items():
        assert abs(stats[k].item() - v) <= 1e-4 * v, k


def _assert_grads_close(pmodel, jgrads):
    want = params_from_jax(to_numpy_tree(jgrads), target=pmodel)
    floor = max(float(w.abs().max()) for w in want.values())
    for name, p in pmodel.named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        err = float((got - want[name]).abs().max())
        tol = 1e-4 * float(want[name].abs().max()) + 1e-5 * floor
        assert err <= tol, f"{name}: max abs err {err:.3e} > {tol:.3e}"
    return want, floor


@pytest.mark.parametrize("loss_type,sde", [("mse", "ouve"), ("mae", "ouve"), ("mse", "ouvp")])
def test_loss_and_gradients_match_reference(loss_type, sde):
    cfg = dict(CONFIG, loss_type=loss_type, **(OUVP if sde == "ouvp" else {}))
    jmodel, params, pmodel = _pair(cfg, shape=(B, F, T))
    pmodel.train()
    x, y, t, z = _batch()
    (want, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p, *a: jmodel.loss_given_tz(p, a[:2], *a[2:]), has_aux=True))(params, x, y, t, z)
    aux = pmodel.compute_gradients((tt(x), tt(y)), tt(t), tt(z))
    assert set(aux) == set(jaux) == {"loss"}
    np.testing.assert_allclose(float(aux["loss"]), float(want), rtol=1e-5)
    _assert_grads_close(pmodel, jgrads)
    # the loss is the mean of the per-example losses (not StoRM's sum)
    per_example = pmodel._per_example((tt(x), tt(y)), tt(t), tt(z)).detach()
    assert per_example.shape == (B,)
    np.testing.assert_allclose(float(per_example.mean()), float(want), rtol=1e-5)
    gen = torch.Generator().manual_seed(3)
    drawn = pmodel.draw_step((tt(x), tt(y)), gen)
    loss, _ = pmodel.loss_fn((tt(x), tt(y)), torch.Generator().manual_seed(3))
    assert bool(((drawn[0] >= pmodel.t_eps) & (drawn[0] <= 1.0)).all())
    with torch.no_grad():
        torch.testing.assert_close(pmodel.loss_per_example(
            (tt(x), tt(y)), torch.Generator().manual_seed(3)).mean(), loss.detach(),
            rtol=1e-6, atol=0)


def test_train_step_matches_reference():
    """One step of the reference's jitted `make_train_step` (loss, gradients,
    Adam, EMA) and the port's on the same batch, with the reference's t and z
    (its key split three ways, as `loss_fn` splits it)."""
    jmodel, params, pmodel = _pair(CONFIG, shape=(B, F, T), seed=1)
    pmodel.train()
    x, y, _, _ = _batch(2)
    key = jax.random.PRNGKey(9)
    jstate, jaux = jmodel.make_train_step(donate=False)(
        jinit_state(params, jmake_optimizer(jmodel.lr)), (jnp.asarray(x), jnp.asarray(y)), key)
    kt, kz, _ = jax.random.split(key, 3)
    t = jax.random.uniform(kt, (B,), jnp.float32) * (jmodel.sde.T - jmodel.t_eps) + jmodel.t_eps
    z = jcplx.complex_normal(kz, x.shape[:-1])

    state = init_train_state(pmodel, pmodel.lr)
    aux = pmodel.compute_gradients((tt(x), tt(y)), tt(t), tt(z))
    grads = {n: p.grad.clone() if p.grad is not None else torch.zeros_like(p)  # frozen W
             for n, p in pmodel.named_parameters()}
    floor = 1e-5 * max(float(g.abs().max()) for g in grads.values())
    pmodel.apply_update(state)
    np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]), rtol=1e-5)
    assert state.step == int(jstate.step) == 1
    for got, want in ((pmodel.state_dict(), jstate.params), (state.ema, jstate.ema_params)):
        want = params_from_jax(to_numpy_tree(want), target=pmodel)
        for name, w in want.items():
            err = (got[name] - w).abs()
            noise = grads[name].abs() <= floor  # rounding noise: Adam steps by its sign
            assert float(err[~noise].max()) <= 1e-6 if bool((~noise).any()) else True, name
            assert float(err[noise].max()) <= 2 * pmodel.lr if bool(noise.any()) else True, name


# --- enhance


def _prior(key, shape):
    """The reference ODE's and Picard's one draw: the prior."""
    return ReplayNoise(jax_noise_schedule(key, shape, 0))


def test_enhance_pc_matches_reference(pair):
    """The prior is drawn around Y (the noisy spec), not D(Y): a port that
    centred it elsewhere parts from the reference here."""
    jmodel, params, pmodel = pair
    N, key = 3, jax.random.PRNGKey(5)
    y = np.stack([wave(900, 0), wave(900, 1)])
    want, jnfe = jmodel.make_enhance(None, N=N)(params, jnp.asarray(y), key)
    noise = ReplayNoise(jax_noise_schedule(key, (2, F, 64), N, corrector="ald"))
    got, nfe = pmodel.enhance(tt(y), N=N, noise=noise)  # the model's defaults: pc + ald
    assert noise.exhausted() and nfe == int(jnfe) == 2 * N
    assert got.shape == y.shape
    assert_close_rel(got.numpy(), np.asarray(want), 1e-4, "enhance pc")


@pytest.mark.parametrize("sampler", ["ode", "picard", "pc_dc2"])
def test_enhance_samplers_match_reference(pair, sampler):
    jmodel, params, pmodel = pair
    N, key = 3, jax.random.PRNGKey(6)
    y = wave(800, 2)[None]
    kw = {"ode": dict(sampler_type="ode", method="etd2"),
          "picard": dict(sampler_type="picard", sweeps=2),
          "pc_dc2": dict(sampler_type="pc", corrector="ald", deepcache=2)}[sampler]
    want, jnfe = jmodel.make_enhance(None, N=N, **kw)(params, jnp.asarray(y), key)
    noise = (ReplayNoise(jax_noise_schedule(key, (1, F, 64), N, corrector="ald"))
             if sampler == "pc_dc2" else _prior(key, (1, F, 64)))
    got, nfe = pmodel.enhance(tt(y), N=N, noise=noise, **kw)
    assert noise.exhausted() and nfe == int(jnfe)
    assert_close_rel(got.numpy(), np.asarray(want), 1e-4, f"enhance {sampler}")


def test_enhance_bf16_matches_reference():
    """pc + ald at N=3 in bfloat16 against the reference's bfloat16
    make_enhance, in the ratio form of test_torch_bf16."""
    jmodel, params, _ = _pair(CONFIG, seed=2)
    N, key = 3, jax.random.PRNGKey(7)
    y = wave(700, 3)[None]
    runs = {}
    for dtype in ("float32", "bfloat16"):
        want, _ = jbuild(dict(CONFIG, dtype=dtype)).make_enhance(None, N=N)(
            params, jnp.asarray(y), key)
        pmodel = pbuild(dict(CONFIG, dtype=dtype), device="cpu")
        pmodel.load_state_dict(params_from_jax(params, target=pmodel), strict=True)
        noise = ReplayNoise(jax_noise_schedule(key, (1, F, 64), N, corrector="ald"))
        got, _ = pmodel.enhance(tt(y), N=N, noise=noise)
        assert noise.exhausted() and got.dtype == torch.float32
        runs[dtype] = (got.numpy(), np.asarray(want))
    against_ref, really = _ratios(runs["bfloat16"][0], runs["float32"][0], runs["bfloat16"][1],
                                  runs["float32"][1])
    assert against_ref <= RATIO, against_ref
    assert really >= REALLY, really


# --- int8 calibration and the scale file


def test_calibrate_score_model_and_its_file_match_reference(pair, tmp_path):
    jmodel, params, pmodel = pair
    y = np.stack([wave(1024, 0), wave(1024, 1)])
    key, N = jax.random.PRNGKey(7), 3
    want = jquant.calibrate_score_model(jmodel, params, jnp.asarray(y), key, N=N,
                                        min_channels=MIN_CH)
    kprior, ksamp = jax.random.split(key)
    draws = [np.asarray(jcplx.complex_normal(kprior, (2, F, 128)))]
    draws += jax_noise_schedule(ksamp, (2, F, 128), N, corrector="none")
    noise = ReplayNoise(draws)
    got = pquant.calibrate_score_model(pmodel, tt(y), N=N, min_channels=MIN_CH, noise=noise)
    assert noise.exhausted()
    w = _by_module(want, "a_scale")
    assert w.keys() == got.keys() and len(w) == 41 == pquant.num_quantized_convs(got)
    for k in w:
        assert abs(got[k] - w[k]) <= 1e-4 * w[k], (k, got[k], w[k])

    meta = {"params": "ema", "min_channels": MIN_CH, "mode": "score-only",
            "stream_chunk_s": 0.0, "calib_N": N}
    pquant.save_scales(str(tmp_path / "p.json"), got, meta)  # port -> reference
    jtree, jmeta = jquant.load_scales_with_meta(str(tmp_path / "p.json"))
    assert jmeta == meta and _by_module(jtree, "a_scale") == got
    assert jquant.num_quantized_convs(jtree) == 41
    jquant.save_scales(str(tmp_path / "j.json"), jtree, meta)  # reference -> port
    assert pquant.load_scales_with_meta(str(tmp_path / "j.json"), single_net=True) == (got, meta)
    assert json.load(open(tmp_path / "j.json")) == json.load(open(tmp_path / "p.json"))
    with pytest.raises(ValueError, match="not <net>/<module path>/a_scale"):
        pquant.load_scales(str(tmp_path / "j.json"))  # a single net's file is not StoRM's
    with pytest.raises(ValueError, match="of one net"):
        pquant.save_scales(str(tmp_path / "s.json"), {"score": got, "denoiser": None}, meta)
        pquant.load_scales(str(tmp_path / "s.json"), single_net=True)
    # and the scales serve: one int8 enhance through the port
    x8, nfe = pmodel.enhance(tt(y[:1]), N=2, quant=got, generator=torch.Generator().manual_seed(0))
    assert nfe == 4 and bool(torch.isfinite(x8).all())


# --- the CLIs on a tiny checkpoint


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory, pair):
    path = str(tmp_path_factory.mktemp("score") / "score.pt")
    save_checkpoint(path, CONFIG, pair[2].state_dict())
    return path


def _noisy_dir(root, lengths=(900, 1531, 1400)):
    noisy = root / "noisy"
    noisy.mkdir()
    for i, n in enumerate(lengths):
        save_wav(str(noisy / f"u{i}.wav"), wave(n, i))
    return noisy, {f"u{i}.wav": n for i, n in enumerate(lengths)}


@pytest.mark.parametrize("extra", [[], ["--batch", "2"],
                                   ["--stream_chunk_s", "0.06", "--stream_overlap_s", "0.01"],
                                   ["--sampler", "ode", "--ode-method", "heun"],
                                   ["--deepcache", "2", "--dtype", "bfloat16"]],
                         ids=["pc", "batch", "stream", "ode", "dc2_bf16"])
def test_cli_enhances(tmp_path, tiny_ckpt, extra, capsys):
    noisy, lengths = _noisy_dir(tmp_path)
    out = tmp_path / "out"
    enhancement.main(["--test_dir", str(noisy), "--enhanced_dir", str(out), "--ckpt", tiny_ckpt,
                      "--mode", "score-only", "--N", "2", "--device", "cpu", "--timeit", *extra])
    text = capsys.readouterr().out
    for name, n in lengths.items():
        x, sr = load_wav(str(out / name))
        assert sr == 16000 and x.shape == (1, n) and np.isfinite(x).all()
    if not extra:
        assert all(f"{name}: nfe=4 " in text for name in lengths)  # N x (ald + predictor)


def test_cli_int8_calibrates_then_loads(tmp_path, capsys):
    ckpt = str(tmp_path / "s.pt")
    save_checkpoint(ckpt, CONFIG, pbuild(dict(CONFIG), device="cpu", seed=3).state_dict())
    noisy, _ = _noisy_dir(tmp_path)
    argv = ["--test_dir", str(noisy), "--enhanced_dir", str(tmp_path / "out"), "--ckpt", ckpt,
            "--mode", "score-only", "--N", "2", "--device", "cpu", "--quant", "int8",
            "--quant_min_channels", str(MIN_CH)]
    enhancement.main(argv)
    assert "int8 calibration done (41 convs quantized" in capsys.readouterr().out
    payload = json.load(open(scale_cache_path(ckpt)))
    assert payload["_meta"]["mode"] == "score-only" and payload["_meta"]["calib_N"] == 2
    assert all(not k.startswith(("denoiser/", "score/")) for k in payload["scales"])
    enhancement.main(argv)
    assert "int8 scales loaded from" in capsys.readouterr().out


def test_cli_refuses_another_checkpoint_mode(tmp_path, tiny_ckpt):
    noisy, _ = _noisy_dir(tmp_path, (900,))
    with pytest.raises(SystemExit, match="--mode storm incompatible with checkpoint mode "
                                         "score-only"):
        enhancement.main(["--test_dir", str(noisy), "--enhanced_dir", str(tmp_path / "o"),
                          "--ckpt", tiny_ckpt, "--mode", "storm", "--device", "cpu"])


def test_server_and_evaluate(tmp_path, tiny_ckpt, capsys):
    args = serve.build_argparser().parse_args(
        ["--ckpt", tiny_ckpt, "--mode", "score-only", "--port", "0", "--N", "2", "--batch", "2",
         "--warmup_buckets", "0.05", "--device", "cpu", "--dtype", "float32"])
    httpd, batcher = serve.build_server(args)
    httpd.server_close()
    try:
        x, nfe = batcher.submit(wave(900, 4))
        assert nfe == 4 and x.shape == (900,) and np.isfinite(x).all()
    finally:
        batcher.close()
    root = _write_corpus(tmp_path / "corpus", n_train=1, n_valid=1)
    os.makedirs(os.path.join(root, "tt", "clean"))
    os.makedirs(os.path.join(root, "tt", "noisy"))
    for i, n in enumerate((7000, 6800)):
        save_wav(os.path.join(root, "tt", "clean", f"t{i}.wav"), wave(n, 10 + i))
        save_wav(os.path.join(root, "tt", "noisy", f"t{i}.wav"), wave(n, 20 + i))
    evaluate.main(["--ckpt", tiny_ckpt, "--mode", "score-only", "--base_dir", root, "--N", "2",
                   "--batch", "2", "--csv", str(tmp_path / "m.csv"), "--device", "cpu"])
    rows = open(tmp_path / "m.csv").read().splitlines()
    assert len(rows) == 3 and "si_sdr: " in capsys.readouterr().out


@pytest.mark.parametrize("extra", [[], ["--sde", "ouvp", "--dtype", "bfloat16"]],
                         ids=["ouve_f32", "ouvp_bf16"])
def test_cli_trains_and_the_checkpoint_serves(tmp_path, extra):
    root = _write_corpus(tmp_path / "corpus", n_train=4, n_valid=3)
    logs = tmp_path / "logs"
    train.main(["--mode", "score-only", "--base_dir", root, "--format", "wsj0", "--batch_size",
                "2", "--num_frames", "32", "--n_fft", "62", "--hop_length", "16", "--nf", "8",
                "--ch_mult", "1,2", "--num_workers", "2", "--num_eval_files", "0",
                "--log_every_n_steps", "1", "--max_steps", "2", "--log_dir", str(logs),
                "--device", "cpu", *extra])
    (run,) = os.listdir(logs)
    sde = "OUVPSDE" if extra else "OUVESDE"
    assert run.startswith(f"mode=score-only_sde={sde}_")
    rows = [json.loads(line) for line in open(logs / run / "metrics.jsonl")]
    assert [r["step"] for r in rows if "train_loss" in r] == [1, 2]
    assert all(set(r) == {"step", "train_loss"} for r in rows if "train_loss" in r)
    (epoch,) = [r for r in rows if "valid_loss" in r]
    assert np.isfinite(epoch["valid_loss"])
    ckpt = load_training_checkpoint(str(logs / run / "checkpoints" / "last.pt"))
    config = ckpt["config"]
    assert config["mode"] == "score-only" and config["sde"] == ("ouvp" if extra else "ouve")
    dropped = ("theta", "sigma_min", "sigma_max") if extra else ("beta_min", "beta_max",
                                                                 "stiffness")
    assert not set(dropped) & set(config)
    noisy, lengths = _noisy_dir(tmp_path, (900,))
    enhancement.main(["--test_dir", str(noisy), "--enhanced_dir", str(tmp_path / "out"),
                      "--ckpt", str(logs / run / "checkpoints" / "last.pt"), "--mode",
                      "score-only", "--N", "2", "--device", "cpu"])
    assert load_wav(str(tmp_path / "out" / "u0.wav"))[0].shape == (1, 900)
