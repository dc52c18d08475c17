"""Port parity: the time-domain backbones (ConvTasNet, causal and not, and
ae-ncsnpp) and the path that runs them (`time_domain_denoise`, StoRM with a
time-domain denoiser, the denoiser-only model on `return_time` batches),
against storm_tpu; the trainer's `--return_time` and the enhancement CLI.

Tiny nets (ConvTasNet: 16 filters, 8 bottleneck channels, 2 x 2 blocks;
ae-ncsnpp: nf 16, two levels, a 32-filter bank; NCSN++ score nets nf 16),
n_fft 62, weights drawn with numpy and carried by `params_from_jax`.
Tolerances: forwards, gradients and `enhance` within 1e-4 of their scale
(tests/test_torch_ncsnpp.py; a time-domain net adds the STFT round trip and
cumulative sums over time); losses 1e-5 relative, parameters after one Adam
step 1e-6 absolute except where a gradient is rounding noise
(tests/test_torch_discriminative.py).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import _write_corpus
from torch_parity import (ReplayNoise, assert_close_rel, jax_noise_schedule, random_params,
                          to_numpy_tree, tt)

from storm_tpu.backbones.convtasnet import ConvTasNet as JConvTasNet
from storm_tpu.backbones.ncsnpp import AutoEncodeNCSNpp as JAutoEncode
from storm_tpu.models import base as jbase
from storm_tpu.models.base import init_train_state as jinit_state
from storm_tpu.models.base import make_optimizer as jmake_optimizer
from storm_tpu.models.factory import build_model as jbuild
from storm_tpu.signal.stft import STFTConfig as JSTFTConfig
from storm_tpu.signal.transforms import SpecTransform as JSpecTransform
from storm_tpu_torch import enhancement, train
from storm_tpu_torch.backbones.convtasnet import ConvTasNet, optional_bool
from storm_tpu_torch.backbones.ncsnpp import AutoEncodeNCSNpp
from storm_tpu_torch.ckpt import load_checkpoint
from storm_tpu_torch.convert import module_params_from_jax, params_from_jax
from storm_tpu_torch.data.audio import load_wav, save_wav
from storm_tpu_torch.models import quant as pquant
from storm_tpu_torch.models.base import init_train_state, time_domain_denoise
from storm_tpu_torch.models.factory import build_model as pbuild
from storm_tpu_torch.signal.stft import STFTConfig
from storm_tpu_torch.signal.transforms import SpecTransform

CT = dict(enc_dim=16, feature_dim=8, layer=2, stack=2, kernel=3)
AE = dict(nf=16, ch_mult=(1, 2), image_size=32, init_scale=1.0)
STFT = dict(n_fft=62, hop_length=16)


def draw(shapes, seed=0):
    """`random_params`, with the time-domain leaves drawn as their layers
    expect: 1-D conv kernels `*_w` (K, I, O) at fan-in scale, layer-norm
    gains near 1, PReLU slopes near 0.25."""
    rng = np.random.default_rng(seed + 100)

    def fix(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = fix(v)
            elif k.endswith("_w") and v.ndim == 3:
                out[k] = (rng.standard_normal(v.shape) / np.sqrt(np.prod(v.shape[:-1]))
                          ).astype(np.float32)
            elif k in ("gain", "alpha"):
                out[k] = ((1.0 if k == "gain" else 0.25)
                          + 0.05 * rng.standard_normal(v.shape)).astype(np.float32)
            else:
                out[k] = v
        return out

    return fix(random_params(shapes, seed))


def _net_pair(jnet, pnet, T, seed=0):
    # with a time, as the models initialize them (ae-ncsnpp's Fourier W then exists)
    shapes = jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0), jnp.zeros((2, T)),
                                              jnp.ones((2,))))
    params = draw(shapes["params"], seed)
    pnet.load_state_dict(module_params_from_jax(params), strict=True)
    return params


def _forward_and_grad(jnet, params, pnet, x, what):
    g = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)

    def jloss(xv):
        out = jnet.apply({"params": params}, xv)
        return jnp.sum(out * g), out

    (_, want), want_grad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jnp.asarray(x))
    xt = tt(x).requires_grad_()
    out = pnet(xt)
    (grad,) = torch.autograd.grad((out * tt(g)).sum(), xt)
    assert out.shape == x.shape and out.dtype == torch.float32
    assert_close_rel(out.detach().numpy(), np.asarray(want), 1e-4, f"{what} forward")
    assert_close_rel(grad.numpy(), np.asarray(want_grad), 1e-4, f"{what} input gradient")


def _wave(B, T, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 16000
    x = 0.3 * np.sin(2 * np.pi * 300 * t)[None] + 0.05 * rng.standard_normal((B, T))
    return x.astype(np.float32)


@pytest.mark.parametrize("causal", [False, True])
def test_convtasnet_forward_and_input_gradient(causal):
    """Its padding (`_pad_amounts`), encoder, TCN (cLN's cumulative moments
    when causal, GlobalLN else), mask and decoder, cropped to the input."""
    jnet, pnet = JConvTasNet(**CT, causal=causal), ConvTasNet(**CT, causal=causal)
    params = _net_pair(jnet, pnet, 1001, seed=int(causal))
    assert pnet._pad_amounts(1001) == jnet._pad_amounts(1001)
    _forward_and_grad(jnet, params, pnet, _wave(2, 1001, 1), f"convtasnet causal={causal}")


def test_ae_ncsnpp_forward_and_input_gradient():
    """The filterbank encoder, the 1-channel trunk padded to 64 frames and the
    transposed decoder, whose taps the converter flips."""
    jnet = JAutoEncode.from_kwargs(**AE)
    pnet = AutoEncodeNCSNpp.from_kwargs(**AE)
    params = _net_pair(jnet, pnet, 4000, seed=2)
    assert "output_layer" not in params  # the decoder reads the trunk's image
    _forward_and_grad(jnet, params, pnet, _wave(2, 4000, 3), "ae-ncsnpp")


def test_time_domain_denoise_matches_reference():
    jnet, pnet = JConvTasNet(**CT), ConvTasNet(**CT)
    params = _net_pair(jnet, pnet, 1000, seed=4)
    Y = (0.3 * np.random.default_rng(5).standard_normal((2, 32, 40, 2))).astype(np.float32)
    want = jbase.time_domain_denoise(jnet, params, jnp.asarray(Y), JSTFTConfig(**STFT),
                                     JSpecTransform())
    got = time_domain_denoise(pnet, tt(Y), STFTConfig(**STFT), SpecTransform())
    assert got.shape == Y.shape
    assert_close_rel(got.detach().numpy(), np.asarray(want), 1e-4, "time_domain_denoise")


def _storm(denoiser):
    cfg = {"mode": "regen-joint-training", "backbone_denoiser": denoiser, "nf": 16,
           "ch_mult": [1, 2], "init_scale": 1.0, "sde": "ouve", **STFT, **CT,
           "image_size": 32}
    jmodel = jbuild(dict(cfg))
    params = draw(jax.eval_shape(lambda: jmodel.init_params(jax.random.PRNGKey(0),
                                                              (1, 32, 64))), 6)
    pmodel = pbuild(dict(cfg), device="cpu")
    pmodel.load_state_dict(params_from_jax(params, target=pmodel), strict=True)
    return jmodel, params, pmodel


@pytest.mark.parametrize("denoiser", ["convtasnet", "ae-ncsnpp"])
def test_storm_enhance_with_a_time_domain_denoiser(denoiser):
    """StoRM's `enhance` with the denoiser wrapped spec -> wav -> net ->
    wav -> spec (the SDE and the score net stay spectral), with the
    reference's noise replayed; its int8 calibration gives the time-domain
    denoiser no scales, as the reference's does."""
    N, T = 2, 700
    jmodel, params, pmodel = _storm(denoiser)
    y = _wave(1, T, 7)
    key = jax.random.PRNGKey(3)
    want, nfe_j = jmodel.make_enhance(N=N, corrector="none")(params, jnp.asarray(y), key)
    noise = ReplayNoise(jax_noise_schedule(key, (1, 32, 64), N, corrector="none"))
    got, nfe = pmodel.enhance(tt(y), N=N, noise=noise)
    assert noise.exhausted() and nfe == int(nfe_j) == 1 + N and got.shape == (1, T)
    assert_close_rel(got.numpy(), np.asarray(want), 1e-4, f"enhance with {denoiser}")
    quant = pquant.calibrate_storm(pmodel, tt(y), N=2, min_channels=8,
                                   generator=torch.Generator().manual_seed(0))
    assert quant["denoiser"] is None and quant["score"]


DENOISER = {"mode": "denoiser-only", "backbone_denoiser": "convtasnet", "loss_type": "sisdr",
            **STFT, **CT}


def test_return_time_train_step_matches_reference():
    """One denoiser-only sisdr step on a `return_time` batch (waveforms in,
    waveforms compared) against the reference's jitted `make_train_step`;
    where a gradient is rounding noise Adam's first step may go either way
    (held to 2 lr there)."""
    jmodel = jbuild(dict(DENOISER))
    params = draw(jax.eval_shape(lambda: jmodel.init_params(jax.random.PRNGKey(0), (1, 32, 64))),
                  8)
    pmodel = pbuild(dict(DENOISER), device="cpu")
    pmodel.load_state_dict(params_from_jax(params, target=pmodel), strict=True)
    x = _wave(2, 496, 10)
    y = (x + 0.05 * np.random.default_rng(11).standard_normal(x.shape)).astype(np.float32)
    jstate, jaux = jmodel.make_train_step(donate=False)(
        jinit_state(params, jmake_optimizer(jmodel.lr)), (jnp.asarray(x), jnp.asarray(y)),
        jax.random.PRNGKey(1))
    state = init_train_state(pmodel, pmodel.lr)
    aux = pmodel.train_step(state, (tt(x), tt(y)))
    grads = {k: p.grad for k, p in pmodel.named_parameters()}
    floor = 1e-5 * max(float(v.abs().max()) for v in grads.values())
    np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]), rtol=1e-5)
    for got, want in ((pmodel.state_dict(), jstate.params), (state.ema, jstate.ema_params)):
        for name, w in params_from_jax(to_numpy_tree(want), target=pmodel).items():
            err, noise = (got[name] - w).abs(), grads[name].abs() <= floor
            assert float(err[~noise].max()) <= 1e-6 if bool((~noise).any()) else True, name
            assert float(err[noise].max()) <= 2 * pmodel.lr if bool(noise.any()) else True, name
    assert pquant.calibrate_discriminative(pmodel, tt(y), min_channels=1) is None


TRAIN_ARGS = ["--format", "wsj0", "--batch_size", "2", "--num_frames", "32", "--n_fft", "62",
              "--hop_length", "16", "--num_workers", "2", "--num_eval_files", "0",
              "--log_every_n_steps", "1", "--device", "cpu"]


def test_cli_trains_convtasnet_on_waveforms_and_enhances(tmp_path):
    """`train --mode denoiser-only --backbone_denoiser convtasnet
    --return_time --causal` (its argparse group's flag in the checkpoint's
    config), then the enhancement CLI on its checkpoint; `--return_time`
    with a spectral model exits with the reference's message."""
    root = _write_corpus(tmp_path / "corpus", n_train=4, n_valid=2)
    logs = tmp_path / "logs"
    args = TRAIN_ARGS + ["--base_dir", root, "--log_dir", str(logs)]
    train.main(args + ["--mode", "denoiser-only", "--backbone_denoiser", "convtasnet",
                       "--return_time", "--loss_type", "sisdr", "--causal", "--max_steps", "2"])
    (run,) = os.listdir(logs)
    ckpt = str(logs / run / "checkpoints" / "last.pt")
    config, _, _ = load_checkpoint(ckpt)
    assert config["backbone_denoiser"] == "convtasnet" and config["causal"] is True
    noisy, out = tmp_path / "noisy", tmp_path / "out"
    noisy.mkdir()
    save_wav(str(noisy / "a.wav"), _wave(1, 900, 12)[0])
    enhancement.main(["--test_dir", str(noisy), "--enhanced_dir", str(out), "--ckpt", ckpt,
                      "--mode", "denoiser-only", "--device", "cpu"])
    x, sr = load_wav(str(out / "a.wav"))
    assert sr == 16000 and x.shape == (1, 900) and np.isfinite(x).all()
    with pytest.raises(SystemExit, match="return_time requires"):
        train.main(args + ["--mode", "regen-joint-training", "--nf", "8", "--ch_mult", "1,2",
                           "--return_time", "--nolog"])


@pytest.mark.parametrize("cfg", [
    {"mode": "regen-joint-training", "backbone_denoiser": "convtasnet", "N": 2},
    {"mode": "regen-joint-training", "backbone_denoiser": "ae-ncsnpp", "N": 2},
    {"mode": "denoiser-only", "backbone_denoiser": "convtasnet"},
    {"mode": "regen-joint-training", "backbone_score": "ncsnpplarge", "ch_mult": [1, 1, 2],
     "num_res_blocks": 2, "attn_resolutions": [16], "N": 2},
    {"mode": "denoiser-only", "resblock_type": "ddpm", "progressive": "residual",
     "progressive_input": "residual"},
], ids=["storm-convtasnet", "storm-ae-ncsnpp", "convtasnet", "storm-ncsnpplarge", "ddpm"])
def test_programs_of_the_new_nets_equal_eager(cfg):
    """Their serving programs (utils/graphs.py; on the CPU the body on the
    static buffers) equal the eager loop bit for bit, as
    tests/test_torch_graphs.py holds the default nets'."""
    from test_torch_graphs import assert_program_equals_eager

    kw = {"N": cfg.pop("N")} if "N" in cfg else {}
    config = {"nf": 16, "ch_mult": [1, 2], "init_scale": 1.0, "image_size": 32, **STFT, **CT,
              **cfg}
    model = pbuild(config, device="cpu", seed=1)
    assert_program_equals_eager(model, _wave(2, 1500, 13), seeds=(0, 1, 2), **kw)


def test_backbone_groups_share_a_flag_once(capsys):
    """The trainer's per-backbone argparse groups (train.py `_DedupGroup`):
    a flag a second group registers again is skipped, the first wins, and
    one registered with another arity is reported; `--causal` parses bare
    and as True/False, as the reference's."""
    import argparse

    parser = argparse.ArgumentParser()
    assert train.add_backbone_groups(parser, ["convtasnet", "convtasnet", "ncsnpp"]) == ["causal"]
    group = train.DedupGroup(parser.add_argument_group("another"))
    assert group.add_argument("--causal", nargs="?", const=True, default=False,
                              type=optional_bool) is None
    assert capsys.readouterr().err == ""
    assert group.add_argument("--causal", action="store_true") is None
    assert "duplicate flag --causal" in capsys.readouterr().err
    for argv, want in (([], False), (["--causal"], True), (["--causal", "False"], False)):
        assert parser.parse_args(argv).causal is want
