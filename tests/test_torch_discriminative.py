"""The denoiser-only model against the reference's `DiscriminativeModel`:
its forward (the reference's `apply`), the mse, mae and sisdr losses and
their gradients (sisdr in bfloat16 too), one `train_step` against
`make_train_step`, `enhance`, the int8 calibration and its scale file; the
factory on the reference's config dicts for all four trainable modes and
both SDEs; and the CLIs on a tiny checkpoint, with the parsers' flags
against the reference CLIs'.

Tiny nets (nf 16, three levels, n_fft 62), weights made with numpy from a
seed and carried across by convert.py. Tolerances: the forward 1e-5 of its
scale and the calibration's amax 1e-4 relative (test_torch_quant); losses
1e-5 relative (float32 sums; sisdr in float32 from float32 outputs, as
`si_sdr_jax`), gradients per tensor 1e-4 of the tensor's scale plus 1e-5 of
the largest gradient element (test_torch_train), bfloat16 gradients in the
ratio form of test_torch_train_bf16 (L2 distances over all tensors);
after one Adam step 1e-6 absolute, except where a gradient is rounding
noise (test_train_step_matches_reference); `enhance` 1e-4 of the output's
scale.
"""
import functools
import http.client
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bf16 import RATIO, REALLY
from test_torch_evaluate import _options, _port_parser, _reference_parser
from test_torch_inference import wave
from test_torch_quant import _by_module
from test_torch_train import _write_corpus
from torch_parity import assert_close_rel, random_params, to_numpy_tree, tt

from storm_tpu.models import quant as jquant
from storm_tpu.models.base import init_train_state as jinit_state
from storm_tpu.models.base import make_optimizer as jmake_optimizer
from storm_tpu.models.factory import build_model as jbuild
from storm_tpu_torch import enhancement, evaluate, serve, train
from storm_tpu_torch.ckpt import load_training_checkpoint, save_checkpoint
from storm_tpu_torch.convert import params_from_jax
from storm_tpu_torch.data.audio import load_wav, save_wav
from storm_tpu_torch.models import quant as pquant
from storm_tpu_torch.models.base import init_train_state
from storm_tpu_torch.models.discriminative import DiscriminativeModel
from storm_tpu_torch.models.factory import build_model as pbuild
from storm_tpu_torch.models.score import ScoreModel
from storm_tpu_torch.models.storm import StochasticRegenerationModel
from storm_tpu_torch.sde.sdes import OUVESDE, OUVPSDE
from storm_tpu_torch.utils.server import decode_wav_bytes, encode_wav_bytes
from storm_tpu_torch.utils.serving import scale_cache_path

CONFIG = {"mode": "denoiser-only", "nf": 16, "ch_mult": [1, 2, 2], "init_scale": 1.0,
          "n_fft": 62, "hop_length": 16}
F, MIN_CH = 32, 8
B, T = 2, 32


def _pair(cfg, shape=(1, F, 64), seed=0):
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
    return x, y


def test_forward_and_its_statistics_match_reference(pair):
    jmodel, params, pmodel = pair
    _, y = _batch(1)
    want, jstats = jax.jit(lambda p, Y: jmodel.apply(p, Y, collect_stats=True))(
        params, jnp.asarray(y))
    with torch.no_grad():
        got, stats = pmodel(tt(y), collect_stats=True)
        assert torch.equal(got, pmodel(tt(y))) and got.shape == y.shape
        five = pmodel(tt(y)[:, None])  # a (B, D, F, T, 2) spec keeps its shape
    assert five.shape == (B, 1, F, T, 2) and torch.equal(five[:, 0], got)
    assert_close_rel(got.numpy(), np.asarray(want), 1e-5, "forward")
    jl = _by_module(jstats, "amax")
    assert jl.keys() == stats.keys() and len(jl) > 41
    for k, v in jl.items():
        assert abs(stats[k].item() - v) <= 1e-4 * v, k


def _grads(pmodel):
    return {n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
            for n, p in pmodel.named_parameters()}


def _assert_grads_close(pmodel, jgrads):
    want = params_from_jax(to_numpy_tree(jgrads), target=pmodel)
    floor = max(float(w.abs().max()) for w in want.values())
    for name, got in _grads(pmodel).items():
        err = float((got - want[name]).abs().max())
        tol = 1e-4 * float(want[name].abs().max()) + 1e-5 * floor
        assert err <= tol, f"{name}: max abs err {err:.3e} > {tol:.3e}"


@functools.lru_cache(maxsize=None)
def _jax_fns(loss_type, dtype="float32"):
    """The reference model of `loss_type` in `dtype` and one jitted program,
    (params, x, y) -> (per-example losses, loss, gradients), compiled once
    for every seed's weights."""
    jmodel = jbuild(dict(CONFIG, loss_type=loss_type, dtype=dtype))
    key = jax.random.PRNGKey(0)  # the reference's loss draws nothing from it

    def fn(params, x, y):
        per_example = jmodel.loss_per_example(params, key, (x, y))
        (loss, _), grads = jax.value_and_grad(
            lambda p: jmodel.loss_fn(p, key, (x, y), False), has_aux=True)(params)
        return per_example, loss, grads

    shapes = jax.eval_shape(lambda: jmodel.init_params(jax.random.PRNGKey(0), (B, F, T)))
    return jmodel, shapes, jax.jit(fn)


def _port_model(loss_type, params, dtype="float32"):
    pmodel = pbuild(dict(CONFIG, loss_type=loss_type, dtype=dtype), device="cpu").train()
    pmodel.load_state_dict(params_from_jax(params, target=pmodel), strict=True)
    return pmodel


@pytest.mark.parametrize("loss_type", ["mse", "mae", "sisdr"])
def test_losses_and_gradients_match_reference(loss_type):
    _, shapes, fn = _jax_fns(loss_type)
    params = random_params(shapes, 0)
    pmodel = _port_model(loss_type, params)
    x, y = _batch()
    want_pe, want, jgrads = fn(params, jnp.asarray(x), jnp.asarray(y))
    with torch.no_grad():
        per_example = pmodel.loss_per_example((tt(x), tt(y)), torch.Generator().manual_seed(1))
    assert per_example.dtype == torch.float32 and per_example.shape == (B,)
    np.testing.assert_allclose(per_example.numpy(), np.asarray(want_pe), rtol=1e-5)
    aux = pmodel.compute_gradients((tt(x), tt(y)))
    assert set(aux) == {"loss"} and pmodel.batch_reduction == "mean"
    np.testing.assert_allclose(float(aux["loss"]), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(aux["loss"]), float(per_example.mean()), rtol=1e-6)
    _assert_grads_close(pmodel, jgrads)


def test_sisdr_bf16_gradients_in_the_ratio_form():
    """A bfloat16 net, the loss in float32 on its float32 output, over the
    weights of four seeds: the port's gradients within RATIO of the
    reference's bfloat16 effect from the reference's bfloat16 gradients, and
    at least REALLY of it from the port's float32 ones, the squared L2
    distances summed over the seeds (one seed's ratios spread from 0.6 to
    1.6: two roundings of one program part by bfloat16's noise). Measured:
    1.13 and 1.31."""
    x, y = _batch(3)
    sums = {"effect": 0.0, "against_ref": 0.0, "really": 0.0}
    for seed in range(4, 8):
        g = {}
        for dtype in ("float32", "bfloat16"):
            _, shapes, fn = _jax_fns("sisdr", dtype)
            params = random_params(shapes, seed)
            pmodel = _port_model("sisdr", params, dtype)
            _, _, jgrads = fn(params, jnp.asarray(x), jnp.asarray(y))
            aux = pmodel.compute_gradients((tt(x), tt(y)))
            assert aux["loss"].dtype == torch.float32 and bool(torch.isfinite(aux["loss"]))
            g["jax", dtype] = params_from_jax(to_numpy_tree(jgrads), target=pmodel)
            g["port", dtype] = _grads(pmodel)

        def d2(a, b):
            return float(sum(((g[a][n].double() - g[b][n].double()) ** 2).sum() for n in g[b]))

        sums["effect"] += d2(("jax", "bfloat16"), ("jax", "float32"))
        sums["against_ref"] += d2(("port", "bfloat16"), ("jax", "bfloat16"))
        sums["really"] += d2(("port", "bfloat16"), ("port", "float32"))
    against_ref, really = (np.sqrt(sums[k] / sums["effect"]) for k in ("against_ref", "really"))
    assert against_ref <= RATIO, against_ref
    assert really >= REALLY, really


def test_train_step_matches_reference():
    """The reference's jitted `make_train_step` (sisdr) and the port's
    `train_step`. Adam's first step is lr times each gradient's sign, so
    where a gradient is rounding noise (below 1e-5 of the largest element:
    the attention key bias's, exactly 0 in exact arithmetic) the two steps
    may go opposite ways: there the parameters are held to the step's bound,
    2 lr, elsewhere to 1e-6."""
    jmodel, shapes, _ = _jax_fns("sisdr")
    params = random_params(shapes, 2)
    pmodel = _port_model("sisdr", params)
    x, y = _batch(4)
    jstate, jaux = jmodel.make_train_step(donate=False)(
        jinit_state(params, jmake_optimizer(jmodel.lr)), (jnp.asarray(x), jnp.asarray(y)),
        jax.random.PRNGKey(1))
    state = init_train_state(pmodel, pmodel.lr)
    aux = pmodel.train_step(state, (tt(x), tt(y)), torch.Generator().manual_seed(0))
    grads = _grads(pmodel)
    floor = 1e-5 * max(float(v.abs().max()) for v in grads.values())
    np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]), rtol=1e-5)
    assert state.step == int(jstate.step) == 1
    for got, want in ((pmodel.state_dict(), jstate.params), (state.ema, jstate.ema_params)):
        for name, w in params_from_jax(to_numpy_tree(want), target=pmodel).items():
            err, noise = (got[name] - w).abs(), grads[name].abs() <= floor
            assert float(err[~noise].max()) <= 1e-6 if bool((~noise).any()) else True, name
            assert float(err[noise].max()) <= 2 * pmodel.lr if bool(noise.any()) else True, name


def test_enhance_matches_reference(pair):
    jmodel, params, pmodel = pair
    y = np.stack([wave(900, 0), wave(900, 1)])
    want, jnfe = jmodel.make_enhance(0)(params, jnp.asarray(y), jax.random.PRNGKey(0))
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    got, nfe = pmodel.enhance(tt(y), N=7, sampler_type="picard", corrector="ald", generator=gen)
    assert nfe == int(jnfe) == 1 and got.shape == y.shape
    assert torch.equal(gen.get_state(), state)  # no noise drawn; sampler options ignored
    assert_close_rel(got.numpy(), np.asarray(want), 1e-4, "enhance")


def test_calibrate_discriminative_and_its_file_match_reference(pair, tmp_path):
    jmodel, params, pmodel = pair
    y = np.stack([wave(1024, 2), wave(1024, 3)])
    want = _by_module(jquant.calibrate_discriminative(jmodel, params, jnp.asarray(y),
                                                      min_channels=MIN_CH), "a_scale")
    got = pquant.calibrate_discriminative(pmodel, tt(y), min_channels=MIN_CH)
    assert want.keys() == got.keys() and len(got) == 41
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-4 * want[k], k
    assert pquant.calibrate_discriminative(pmodel, tt(y)) is None  # nf 16: none reach 128
    meta = {"params": "ema", "min_channels": MIN_CH, "mode": "denoiser-only",
            "stream_chunk_s": 0.0, "calib_N": 0}
    pquant.save_scales(str(tmp_path / "p.json"), got, meta)
    jtree, jmeta = jquant.load_scales_with_meta(str(tmp_path / "p.json"))
    assert jmeta == meta and _by_module(jtree, "a_scale") == got
    jquant.save_scales(str(tmp_path / "j.json"), jtree, meta)
    assert pquant.load_scales_with_meta(str(tmp_path / "j.json"), single_net=True) == (got, meta)


# --- the factory on the reference's config dicts


def _train_config(mode, sde):
    """The config the reference's train.py writes at its CLI defaults
    (train.py:300-313), at a tiny width."""
    cfg = {"mode": mode, "backbone_denoiser": "ncsnpp", "backbone_score": "ncsnpp",
           "sde": sde, "lr": 1e-4, "ema_decay": 0.999, "t_eps": 0.03, "loss_type": "mse",
           "loss_type_denoiser": "mse", "loss_type_score": "mse",
           "weighting_denoiser_to_score": 0.5, "condition": "both", "spatial_channels": 1,
           "sde_n": 1000, "theta": 1.5, "sigma_min": 0.05, "sigma_max": 0.5,
           "beta_min": 0.1, "beta_max": 1.0, "stiffness": 1.0, "n_fft": 62, "hop_length": 16,
           "window": "hann", "spec_factor": 0.33, "spec_abs_exponent": 0.5, "dtype": "float32",
           "nf": 8, "ch_mult": [1, 2]}
    for k in {"ouve": ("beta_min", "beta_max", "stiffness"),
              "ouvp": ("theta", "sigma_min", "sigma_max")}[sde]:
        cfg.pop(k)
    return cfg


@pytest.mark.parametrize("sde", ["ouve", "ouvp"])
@pytest.mark.parametrize("mode", ["regen-joint-training", "regen-freeze-denoiser",
                                  "score-only", "denoiser-only"])
def test_factory_builds_the_references_configs(mode, sde):
    cfg = _train_config(mode, sde)
    argv = ["--mode", mode, "--sde", sde, "--base_dir", "corpus", "--nf", "8", "--ch_mult",
            "1,2", "--n_fft", "62", "--hop_length", "16"]
    assert train.model_config(train.parse_args(argv)) == cfg  # the port's trainer writes it
    jmodel = jbuild(dict(cfg))
    pmodel = pbuild(dict(cfg), device="cpu")
    cls = {"score-only": ScoreModel, "denoiser-only": DiscriminativeModel}.get(
        mode, StochasticRegenerationModel)
    assert type(pmodel) is cls
    shapes = jax.eval_shape(lambda: jmodel.init_params(jax.random.PRNGKey(0), (1, F, 64)))
    params_from_jax(random_params(shapes), target=pmodel)  # the same tree, name for name
    if mode == "denoiser-only":
        assert not hasattr(pmodel, "sde")
        return
    want = {"ouve": OUVESDE(1.5, 0.05, 0.5, 1000), "ouvp": OUVPSDE(0.1, 1.0, 1.0, 1000)}[sde]
    assert pmodel.sde == want
    assert all(getattr(jmodel.sde, f) == getattr(want, f) for f in want.__dataclass_fields__)
    assert (pmodel.t_eps, pmodel.lr, pmodel.ema_decay) == (jmodel.t_eps, jmodel.lr,
                                                           jmodel.ema_decay)


def test_factory_and_entry_points_refuse_distill(tmp_path):
    """distill is built from a StoRM config, and the trainer refuses it
    without a StoRM teacher, with the reference's messages."""
    from storm_tpu_torch.models.distill import DistilledModel

    storm = dict(CONFIG, mode="distill", ch_mult=[1, 1])
    assert isinstance(pbuild(storm, device="cpu"), DistilledModel)
    with pytest.raises(SystemExit, match="--mode distill requires --teacher_ckpt"):
        train.main(["--mode", "distill", "--base_dir", "c", "--device", "cpu"])
    ckpt = str(tmp_path / "denoiser.pt")
    save_checkpoint(ckpt, CONFIG, pbuild(dict(CONFIG), device="cpu").state_dict())
    with pytest.raises(SystemExit, match="--teacher_ckpt must be a storm .* got "
                                         "mode='denoiser-only'"):
        train.main(["--mode", "distill", "--base_dir", "c", "--teacher_ckpt", ckpt,
                    "--device", "cpu"])


TRAIN_FLAGS = ["mode", "sde", "loss_type", "beta_min", "beta_max", "stiffness", "theta",
               "sigma_min", "sigma_max", "sde_n", "t_eps", "loss_type_denoiser",
               "weighting_denoiser_to_score", "condition"]


def test_trainer_parser_has_the_reference_flags():
    ours = _port_parser(lambda argv: train.parse_args(argv))
    want = _options(_reference_parser("train", []), TRAIN_FLAGS)
    assert _options(ours, TRAIN_FLAGS) == want


# --- the CLIs on a tiny checkpoint


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory, pair):
    path = str(tmp_path_factory.mktemp("denoiser") / "denoiser.pt")
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
                                   ["--quant", "int8", "--quant_min_channels", str(MIN_CH)]],
                         ids=["one", "batch", "stream", "int8"])
def test_cli_enhances(tmp_path, tiny_ckpt, extra, capsys):
    noisy, lengths = _noisy_dir(tmp_path)
    out = tmp_path / "out"
    ckpt = tiny_ckpt
    if "int8" in extra:  # a checkpoint of its own, so that it calibrates
        ckpt = str(tmp_path / "d.pt")
        os.link(tiny_ckpt, ckpt)
    argv = ["--test_dir", str(noisy), "--enhanced_dir", str(out), "--ckpt", ckpt, "--mode",
            "denoiser-only", "--device", "cpu", "--timeit", *extra]
    enhancement.main(argv)
    text = capsys.readouterr().out
    for name, n in lengths.items():
        x, sr = load_wav(str(out / name))
        assert sr == 16000 and x.shape == (1, n) and np.isfinite(x).all()
    if not extra:
        assert all(f"{name}: nfe=1 " in text for name in lengths)
    if "int8" in extra:
        assert "int8 calibration done (41 convs quantized" in text
        meta = json.load(open(scale_cache_path(ckpt)))["_meta"]
        assert (meta["mode"], meta["calib_N"]) == ("denoiser-only", 0)
        enhancement.main(argv)
        assert "int8 scales loaded from" in capsys.readouterr().out


def test_cli_mode_mismatch_exits_with_the_references_message(tmp_path, tiny_ckpt):
    noisy, _ = _noisy_dir(tmp_path, (900,))
    for mode in ("storm", "score-only"):
        with pytest.raises(SystemExit, match=f"--mode {mode} incompatible with checkpoint mode "
                                             "denoiser-only"):
            enhancement.main(["--test_dir", str(noisy), "--enhanced_dir", str(tmp_path / "o"),
                              "--ckpt", tiny_ckpt, "--mode", mode, "--device", "cpu"])
    with pytest.raises(SystemExit, match="--mode distill incompatible with checkpoint mode "
                                         "denoiser-only"):
        enhancement.main(["--test_dir", str(noisy), "--enhanced_dir", str(tmp_path / "o"),
                          "--ckpt", tiny_ckpt, "--mode", "distill", "--device", "cpu"])


def test_server_replies_with_one_nfe_and_reports_the_mode(tiny_ckpt):
    args = serve.build_argparser().parse_args(
        ["--ckpt", tiny_ckpt, "--mode", "denoiser-only", "--port", "0", "--batch", "2",
         "--warmup_buckets", "0.06", "--deepcache", "3", "--device", "cpu"])
    httpd, batcher = serve.build_server(args)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        host, port = httpd.server_address[:2]
        conn = http.client.HTTPConnection(host, port, timeout=120)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        assert (health["mode"], health["dtype"]) == ("denoiser-only", "bfloat16")
        y = wave(1100, 5)
        conn.request("POST", "/enhance", body=encode_wav_bytes(y, 16000))
        r = conn.getresponse()
        x, sr = decode_wav_bytes(r.read())
        assert r.status == 200 and r.getheader("X-NFE") == "1"
        assert sr == 16000 and x.shape == (1, 1100) and np.isfinite(x).all()
        conn.close()
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
        thread.join(timeout=60)


def test_evaluate_and_train(tmp_path, tiny_ckpt, capsys):
    root = _write_corpus(tmp_path / "corpus", n_train=4, n_valid=3)
    os.makedirs(os.path.join(root, "tt", "clean"))
    os.makedirs(os.path.join(root, "tt", "noisy"))
    for i, n in enumerate((7000, 6800, 900)):
        save_wav(os.path.join(root, "tt", "clean", f"t{i}.wav"), wave(n, 10 + i))
        save_wav(os.path.join(root, "tt", "noisy", f"t{i}.wav"), wave(n, 20 + i))
    evaluate.main(["--ckpt", tiny_ckpt, "--mode", "denoiser-only", "--base_dir", root,
                   "--num_files", "2", "--batch", "2", "--csv", str(tmp_path / "m.csv"),
                   "--device", "cpu"])
    assert len(open(tmp_path / "m.csv").read().splitlines()) == 3
    assert "si_sdr: " in capsys.readouterr().out

    logs = tmp_path / "logs"
    train.main(["--mode", "denoiser-only", "--loss_type", "sisdr", "--base_dir", root,
                "--format", "wsj0", "--batch_size", "2", "--num_frames", "32", "--n_fft", "62",
                "--hop_length", "16", "--nf", "8", "--ch_mult", "1,2", "--num_workers", "2",
                "--num_eval_files", "0", "--log_every_n_steps", "1", "--max_steps", "2",
                "--log_dir", str(logs), "--device", "cpu"])
    (run,) = os.listdir(logs)
    assert run.startswith("mode=denoiser-only_sde=OUVESDE_")
    rows = [json.loads(line) for line in open(logs / run / "metrics.jsonl")]
    losses = [r["train_loss"] for r in rows if "train_loss" in r]
    (epoch,) = [r for r in rows if "valid_loss" in r]
    assert len(losses) == 2 and np.isfinite(losses).all() and np.isfinite(epoch["valid_loss"])
    ckpt = load_training_checkpoint(str(logs / run / "checkpoints" / "last.pt"))
    assert ckpt["config"]["loss_type"] == "sisdr" and ckpt["step"] == 2
