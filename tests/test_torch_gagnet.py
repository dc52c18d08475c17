"""Port parity: GaGNet (storm_tpu_torch/backbones/gagnet.py) and the models
that run it, against storm_tpu.

Backbone cases at the JAX package's test sizes (tests/test_backbones_extra.py:
F 256, so d_feat 448 = 64 x 7; T 16), with c = cd1 = 16, p = q = 1, each
option moved off its default one at a time. Model cases at n_fft 126 (F 64,
padded to 65 = fft_num 128 / 2 + 1; the U^2 encoder's five stride-2 stages
need an odd F of at least 65, so n_fft 62 cannot build it), d_feat 64, c 8.
Weights are drawn with numpy and carried by `params_from_jax`.

Tolerances. Forwards in float32 within 2e-5 of the output's scale: the net
normalizes every layer over 16 frames, which amplifies float32 rounding, so
each package's float32 output lies 0.7-1.2e-5 of scale from the float64
evaluation of the same net (`test_forward_matches_reference` asserts both
within 2e-5), and the two part by 0.6-1.3e-5.
bfloat16 in the ratio form of tests/test_torch_bf16.py (within 1.5 of the
reference's bfloat16-vs-float32 distance, and at least 0.5 of it from the
port's float32). Losses 1e-5 relative, parameters after one Adam step 1e-6
except where a gradient is rounding noise, and `enhance` 1e-4 of scale, as
tests/test_torch_discriminative.py holds them.
"""
import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.tree_util import tree_flatten_with_path
from test_torch_train import _write_corpus
from torch_parity import (ReplayNoise, assert_close_rel, jax_noise_schedule, to_numpy_tree,
                          tt)

from storm_tpu.backbones.gagnet import GaGNet as JGaGNet
from storm_tpu.backbones.gagnet import NormSwitch as JNormSwitch
from storm_tpu.compat.torch_ckpt import convert_gagnet_state_dict
from storm_tpu.models import quant as jquant
from storm_tpu.models.base import init_train_state as jinit_state
from storm_tpu.models.base import make_optimizer as jmake_optimizer
from storm_tpu.models.factory import build_model as jbuild
from storm_tpu.signal import cplx as jcplx
from storm_tpu_torch import backbones, enhancement, train
from storm_tpu_torch.backbones.gagnet import GaGNet, NormSwitch, norm_modules, stats_attached
from storm_tpu_torch.ckpt import load_checkpoint
from storm_tpu_torch.convert import (batch_stats_from_jax, module_params_from_jax, norm_name,
                                     params_from_jax)
from storm_tpu_torch.data.audio import load_wav, save_wav
from storm_tpu_torch.models import quant as pquant
from storm_tpu_torch.models.base import init_train_state
from storm_tpu_torch.models.factory import build_model as pbuild
from storm_tpu_torch.utils import graphs

SMALL = dict(c=16, cd1=16, d_feat=448, p=1, q=1)
F32_RTOL = 2e-5
RATIO, REALLY = 1.5, 0.5


def gdraw(shapes, seed=0):
    """Weights for a flax tree of these shapes: conv kernels (`w`, `*_w`,
    `kernel`, NIN's `W`) at fan-in scale, PReLU slopes near 0.25, norm
    scales near 1, biases near 0, the Fourier features' W at scale 16."""
    rng = np.random.default_rng(seed)

    def draw(name, s):
        z = rng.standard_normal(s).astype(np.float32)
        if name == "W" and len(s) == 1:
            return 16.0 * z
        if name in ("w", "kernel", "W") or name.endswith("_w"):
            return z / np.sqrt(np.prod(s[:-1]))
        return {"alpha": 0.25, "scale": 1.0}.get(name, 0.0) + 0.05 * z

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else np.float32(draw(k, v.shape))
                for k, v in tree.items()}

    return walk(shapes)


def _x(B=2, F=256, T=16, seed=0, scale=0.3):
    return (scale * np.random.default_rng(seed).standard_normal((B, 1, F, T, 2))).astype(
        np.float32)


def _pair(seed=1, x=None, **kw):
    """(JAX net, its weights, the port's net with them) for `kw` over SMALL."""
    kw = dict(SMALL, **kw)
    jnet = JGaGNet.from_kwargs(**kw)
    x = _x() if x is None else x
    params = gdraw(jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"],
                   seed)
    pnet = GaGNet.from_kwargs(**kw).eval()
    pnet.load_state_dict(module_params_from_jax(params), strict=True)
    return jnet, params, pnet


def random_stats(pnet, seed=3):
    """A flax batch_stats tree for every norm of `pnet`'s JAX twin: means
    near 0, variances positive."""
    rng = np.random.default_rng(seed)
    tree = {}
    for path in _norm_paths(pnet):
        C = len(dict(pnet.named_parameters())[norm_name(path) + ".weight"])
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = {"mean": (0.2 * rng.standard_normal(C)).astype(np.float32),
                          "var": (0.5 + rng.random(C)).astype(np.float32)}
    return tree


def _norm_paths(pnet):
    """The flax paths of the JAX twin's norms, from its parameter tree."""
    tree = convert_gagnet_state_dict({k: v.numpy() for k, v in pnet.state_dict().items()})
    return [tuple(k.key for k in kp)[:-1] for kp, _ in tree_flatten_with_path(tree)[0]
            if kp[-1].key == "scale"]


CASES = {"IN": {}, "BN": {"norm_type": "BN"}, "unet": {"is_u2": False},
         "add": {"intra_connect": "add"}, "causal": {"causal": True},
         "squeezed": {"is_squeezed": True}, "tanh": {"acti_type": "tanh"},
         "relu": {"acti_type": "relu"}}


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_reference(case):
    """The whole net in float32: the gated encoder (U^2 or plain U-Net, skips
    concatenated or added), the causal or centred TCMs, shared or separate
    gaze TCNs, each gain activation; BN on the batch's statistics."""
    jnet, params, pnet = _pair(**CASES[case])
    x = _x()
    want = np.asarray(jax.jit(jnet.apply)({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = pnet(tt(x))
        pnet.double().dtype = torch.float64  # the same net in float64: the exact output
        exact = pnet(torch.from_numpy(x).double()).numpy()
    assert got.dtype == torch.float32 and got.shape == x.shape
    scale = np.abs(exact).max()
    print(f"{case}: of scale, port-reference {np.abs(got.numpy() - want).max() / scale:.2e}, "
          f"port-float64 {np.abs(got.numpy() - exact).max() / scale:.2e}, reference-float64 "
          f"{np.abs(want - exact).max() / scale:.2e}")
    assert_close_rel(got.numpy(), want, F32_RTOL, case)
    assert_close_rel(got.numpy(), exact, F32_RTOL, f"{case}: the port against float64")
    assert_close_rel(want, exact, F32_RTOL, f"{case}: the reference against float64")


def test_forward_with_running_statistics_matches_reference():
    """A BN net with a batch_stats tree (torch eval-mode BatchNorm): the
    reference's collection and the port's `stats_attached` give the same
    output, which differs from the batch-statistics output; the stats go
    with the block."""
    jnet, params, pnet = _pair(norm_type="BN")
    x = _x(B=1, seed=4)
    stats = random_stats(pnet)
    want = np.asarray(jax.jit(jnet.apply)({"params": params, "batch_stats": stats},
                                          jnp.asarray(x)))
    with torch.no_grad():
        with stats_attached(pnet, batch_stats_from_jax(stats)):
            got = pnet(tt(x)).numpy()
        batch = pnet(tt(x)).numpy()
    assert_close_rel(got, want, F32_RTOL, "with running stats")
    assert np.abs(batch - want).max() > 1e-3
    assert all(m.stats is None for m in norm_modules(pnet).values())


@pytest.mark.parametrize("case", ["IN", "BN-stats"])
def test_bf16_forward_matches_reference_in_ratio(case):
    """bfloat16 inside (convs, norms normalized in bfloat16 with float32
    moments rounded to it, the mask), float32 out, in the ratio form."""
    kw = {"norm_type": "BN"} if case == "BN-stats" else {}
    jnet, params, pnet = _pair(**kw)
    x = _x(B=1, seed=5)
    variables = {"params": params}
    pstats = None
    if case == "BN-stats":
        variables["batch_stats"] = random_stats(pnet)
        pstats = batch_stats_from_jax(variables["batch_stats"])
    want = np.asarray(jax.jit(JGaGNet.from_kwargs(**SMALL, **kw, dtype=jnp.bfloat16).apply)(
        variables, jnp.asarray(x)))
    want_f32 = np.asarray(jax.jit(jnet.apply)(variables, jnp.asarray(x)))
    pb = GaGNet.from_kwargs(**SMALL, **kw, dtype=torch.bfloat16).eval()
    pb.load_state_dict(pnet.state_dict())
    with torch.no_grad(), stats_attached(pb, pstats), stats_attached(pnet, pstats):
        got = pb(tt(x)).numpy()
        got_f32 = pnet(tt(x)).numpy()
    effect = np.abs(want - want_f32).max()
    assert np.abs(got - want).max() / effect <= RATIO
    assert np.abs(got - got_f32).max() / effect >= REALLY


@pytest.mark.parametrize("norm_type,dims", [("IN", 3), ("IN", 4), ("BN", 3), ("BN", 4)])
def test_norm_switch_matches_reference(norm_type, dims):
    """One NormSwitch, channels first here and last there: the per-sample
    (IN) or batch (BN) biased moments, eps 1e-5, the affine; a mean without
    its var raises in both."""
    rng = np.random.default_rng(6)
    shape = (3, 5, 7) if dims == 3 else (3, 5, 6, 7)
    x = (1.0 + rng.standard_normal(shape)).astype(np.float32)  # channels last
    gain = (1 + 0.1 * rng.standard_normal(7)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(7)).astype(np.float32)
    jn = JNormSwitch(norm_type)
    want = np.asarray(jn.apply({"params": {"scale": gain, "bias": bias}}, jnp.asarray(x)))
    pn = NormSwitch(norm_type, 7)
    pn.load_state_dict({"norm.weight": tt(gain), "norm.bias": tt(bias)})
    order = (0, dims - 1) + tuple(range(1, dims - 1))
    with torch.no_grad():
        got = pn(tt(x).permute(*order)).permute(0, *range(2, dims), 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if norm_type == "BN":
        with pytest.raises(ValueError, match="without"):
            jn.apply({"params": {"scale": gain, "bias": bias},
                      "batch_stats": {"mean": np.zeros(7, np.float32)}}, jnp.asarray(x))
        with pytest.raises(ValueError, match="without"), stats_attached(
                pn, {"norm": {"mean": torch.zeros(7)}}):
            pn(tt(x).permute(*order))


def test_stats_attached_refuses_unknown_names_and_in_ignores_stats():
    """A name that is no norm raises KeyError; an IN net ignores attached
    statistics, as the reference's IN ignores the collection."""
    jnet, params, pnet = _pair()
    with pytest.raises(KeyError, match="no GaGNet norm"), stats_attached(
            pnet, {"en.nothing.norm": {"mean": torch.zeros(1), "var": torch.ones(1)}}):
        pass
    x = _x(B=1, seed=7)
    stats = random_stats(pnet)
    want = np.asarray(jax.jit(jnet.apply)({"params": params, "batch_stats": stats},
                                          jnp.asarray(x)))
    with torch.no_grad(), stats_attached(pnet, batch_stats_from_jax(stats)):
        got = pnet(tt(x)).numpy()
    with torch.no_grad():
        plain = pnet(tt(x)).numpy()
    assert np.array_equal(got, plain)
    assert_close_rel(got, want, F32_RTOL, "IN with stats")


def test_registry_size_and_names_at_the_reference_defaults():
    """`get_by_name("gagnet")` builds the port's net; at the reference CLI's
    defaults it has the JAX net's parameter count (~6M in the reference's
    self-test) and the reference's 815 parameter tensors."""
    net = backbones.get_by_name("gagnet").from_kwargs(discriminative=True, nf=128)
    assert isinstance(net, GaGNet) and not net.SUPPORTS_DEEPCACHE and not net.FORCE_STFT_OUT
    jnet = JGaGNet.from_kwargs()
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.zeros((1, 1, 256, 8, 2)))
    n_jax = sum(int(np.prod(v.shape)) for v in jax.tree.leaves(shapes))
    assert sum(p.numel() for p in net.parameters()) == n_jax and 2e6 < n_jax < 15e6
    assert len(net.state_dict()) == 815
    assert set(module_params_from_jax(gdraw(shapes["params"]))) == set(net.state_dict())


def test_argparse_group_matches_reference():
    """The same flags and parsers as the reference's group: comma tuples,
    the optional-bool `--causal`, the string bools."""
    argv = ["--k1", "2,5", "--dilas", "1,3", "--is_u2", "false", "--causal", "--is_squeezed",
            "True", "--norm_type", "BN", "--acti_type", "relu", "--c", "8"]
    want, got = argparse.ArgumentParser(), argparse.ArgumentParser()
    JGaGNet.add_argparse_args(want)
    GaGNet.add_argparse_args(got)
    for a in (argv, [], ["--causal", "False"]):
        assert vars(got.parse_args(a)) == vars(want.parse_args(a)), a


def test_score_net_input_is_refused_at_forward_in_both():
    """GaGNet takes one spectrogram channel: the reference builds it as a
    score net and refuses the score input (D > 1) at its forward; so does
    the port."""
    jnet, params, pnet = _pair()
    x = np.concatenate([_x(B=1), _x(B=1, seed=1)], axis=1)
    with pytest.raises(AssertionError, match="dnn_channels=1"):
        jnet.apply({"params": params}, jnp.asarray(x))
    with pytest.raises(ValueError, match="dnn_channels=1"):
        pnet(tt(x))


def test_bn_without_stats_normalizes_over_padded_rows_in_both():
    """Without running statistics a BN net takes its moments over every row
    of the batch, zero rows added to pad it included, in both packages: a
    row-padded call moves the real row's output, by the same amount in both.
    The padded call is ill-conditioned (a zero row makes each channel's
    values bimodal): measured, the reference's float32 output lies 1.9e-4 of
    scale from the float64 evaluation of the same weights and the port's
    1.6e-5, so the two are held to 5e-4 there."""
    jnet, params, pnet = _pair(norm_type="BN")
    x = _x(B=1, seed=8)
    outs = {}
    for inp, rtol in ((x, F32_RTOL), (np.concatenate([x, np.zeros_like(x)]), 5e-4)):
        want = np.asarray(jax.jit(jnet.apply)({"params": params}, jnp.asarray(inp)))
        with torch.no_grad():
            got = pnet(tt(inp)).numpy()
        assert_close_rel(got, want, rtol, f"B={len(inp)}")
        outs[len(inp)] = got[0], want[0]
    moved_port = np.abs(outs[2][0] - outs[1][0]).max()
    moved_ref = np.abs(outs[2][1] - outs[1][1]).max()
    assert moved_port > 1e-2 and abs(moved_port - moved_ref) <= 1e-3 * moved_ref


# --- the models: n_fft 126 (F 64), GaGNet d_feat 64

STFT = dict(n_fft=126, hop_length=32)
GAG = dict(c=8, cd1=8, d_feat=64, p=1, q=1, fft_num=128)
NCSN = dict(nf=16, ch_mult=[1, 2], init_scale=1.0, image_size=64)


def _models(cfg, seed=6):
    """(JAX model, its weights, the port's model with them) of `cfg`."""
    cfg = {**STFT, **GAG, **NCSN, "sde": "ouve", **cfg}
    jmodel = jbuild(dict(cfg))
    params = gdraw(jax.eval_shape(lambda: jmodel.init_params(jax.random.PRNGKey(0),
                                                              (1, 64, 64))), seed)
    pmodel = pbuild(dict(cfg), device="cpu")
    pmodel.load_state_dict(params_from_jax(params, target=pmodel), strict=True)
    return jmodel, params, pmodel


def _wave(B, T, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 16000
    x = 0.3 * np.sin(2 * np.pi * 300 * t)[None] + 0.05 * rng.standard_normal((B, T))
    return x.astype(np.float32)


def _spec_batch(seed, B=2, T=64):
    rng = np.random.default_rng(seed)
    x = (0.3 * rng.standard_normal((B, 64, T, 2))).astype(np.float32)
    y = (x + 0.2 * rng.standard_normal((B, 64, T, 2))).astype(np.float32)
    return x, y


def _assert_step_matches(jmodel, params, pmodel, batch, generator=None):
    """One optimizer step of both from the same weights; where a gradient is
    rounding noise Adam's first step may go either way (2 lr there)."""
    x, y = batch
    jstate, jaux = jmodel.make_train_step(donate=False)(
        jinit_state(params, jmake_optimizer(jmodel.lr)), (jnp.asarray(x), jnp.asarray(y)),
        jax.random.PRNGKey(1))
    state = init_train_state(pmodel, pmodel.lr)
    if generator is None:
        aux = pmodel.train_step(state, (tt(x), tt(y)))
    else:
        aux = pmodel.step_on_device(state, (tt(x), tt(y)), *generator)
        state.step += 1
    grads = {k: torch.zeros_like(p) if p.grad is None else p.grad  # the frozen Fourier W
             for k, p in pmodel.named_parameters()}
    floor = 1e-5 * max(float(v.abs().max()) for v in grads.values())
    np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]), rtol=1e-5)
    for got, want in ((pmodel.state_dict(), jstate.params), (state.ema, jstate.ema_params)):
        for name, w in params_from_jax(to_numpy_tree(want), target=pmodel).items():
            err, noise = (got[name] - w).abs(), grads[name].abs() <= floor
            assert float(err[~noise].max()) <= 1e-6 if bool((~noise).any()) else True, name
            assert float(err[noise].max()) <= 2 * pmodel.lr if bool(noise.any()) else True, name


@pytest.mark.parametrize("norm_type", ["IN", "BN"])
def test_denoiser_only_train_step_matches_reference(norm_type):
    """A denoiser-only GaGNet step (mse) against the reference's jitted
    step; BN trains on the batch's statistics in both."""
    jmodel, params, pmodel = _models({"mode": "denoiser-only", "backbone_denoiser": "gagnet",
                                      "norm_type": norm_type})
    _assert_step_matches(jmodel, params, pmodel.train(), _spec_batch(10))


def test_storm_train_step_matches_reference():
    """StoRM with a GaGNet denoiser and an NCSN++ score net: one joint step,
    with the t and z the reference's step draws under PRNGKey(1)
    (storm_tpu/models/storm.py:349-362) replayed."""
    jmodel, params, pmodel = _models({"mode": "regen-joint-training",
                                      "backbone_denoiser": "gagnet"})
    x, y = _spec_batch(11)
    kt, kz, _, _ = jax.random.split(jax.random.PRNGKey(1), 4)
    t = (jax.random.uniform(kt, (x.shape[0],), jnp.float32) * (jmodel.sde.T - jmodel.t_eps)
         + jmodel.t_eps)
    z = jcplx.complex_normal(kz, x.shape[:-1])
    _assert_step_matches(jmodel, params, pmodel.train(), (x, y),
                         generator=(tt(np.asarray(t)), tt(np.asarray(z))))


def test_storm_enhance_and_calibration_match_reference():
    """StoRM + GaGNet `enhance` at N=2 with the reference's noise replayed;
    int8 calibration quantizes the score net only (GaGNet has no
    quantizable conv), as the reference's."""
    N, T = 2, 2000
    jmodel, params, pmodel = _models({"mode": "regen-joint-training",
                                      "backbone_denoiser": "gagnet"})
    y = _wave(1, T, 7)
    key = jax.random.PRNGKey(3)
    want, nfe_j = jmodel.make_enhance(N=N, corrector="none")(params, jnp.asarray(y), key)
    noise = ReplayNoise(jax_noise_schedule(key, (1, 64, 64), N, corrector="none"))
    got, nfe = pmodel.enhance(tt(y), N=N, noise=noise)
    assert noise.exhausted() and nfe == int(nfe_j) == 1 + N and got.shape == (1, T)
    assert_close_rel(got.numpy(), np.asarray(want), 1e-4, "enhance with gagnet")
    quant = pquant.calibrate_storm(pmodel, tt(y), N=2, min_channels=8,
                                   generator=torch.Generator().manual_seed(0))
    jq = jquant.calibrate_storm(jmodel, params, jnp.asarray(y), N=2, min_channels=8,
                                key=jax.random.PRNGKey(0))
    assert quant["denoiser"] is None and jq["denoiser"] is None and quant["score"]


def test_denoiser_only_enhance_with_stats_and_calibration_match_reference():
    """A BN denoiser-only GaGNet served with running statistics against the
    reference's `make_enhance(batch_stats=...)`; its int8 calibration gives
    None in both (JAX tests/test_quant.py:177-189)."""
    jmodel, params, pmodel = _models({"mode": "denoiser-only", "backbone_denoiser": "gagnet",
                                      "norm_type": "BN"})
    stats = random_stats(pmodel.dnn, seed=9)
    y = _wave(2, 3000, 8)
    want, _ = jmodel.make_enhance(batch_stats=stats)(params, jnp.asarray(y),
                                                     jax.random.PRNGKey(0))
    got, nfe = pmodel.enhance(tt(y), batch_stats=batch_stats_from_jax(stats))
    plain, _ = pmodel.enhance(tt(y))
    assert nfe == 1
    assert_close_rel(got.numpy(), np.asarray(want), 1e-4, "enhance with stats")
    assert np.abs(plain.numpy() - got.numpy()).max() > 1e-4
    assert pquant.calibrate_discriminative(pmodel, tt(y), min_channels=1) is None
    assert jquant.calibrate_discriminative(jmodel, params, jnp.asarray(y), min_channels=1) is None


@pytest.mark.parametrize("cfg", [
    {"mode": "regen-joint-training", "backbone_denoiser": "gagnet", "N": 2},
    {"mode": "denoiser-only", "backbone_denoiser": "gagnet", "norm_type": "BN", "stats": True},
], ids=["storm-gagnet", "gagnet-bn-stats"])
def test_programs_equal_eager(cfg):
    """The serving programs (utils/graphs.py; on the CPU the body on the
    static buffers) equal the eager loop bit for bit, with and without
    running statistics; a program keys on whether they were supplied."""
    from test_torch_graphs import assert_program_equals_eager

    cfg = dict(cfg)
    kw = {"N": cfg.pop("N")} if "N" in cfg else {}
    model = pbuild({**STFT, **GAG, **NCSN, **cfg}, device="cpu", seed=1)
    if cfg.pop("stats", False):
        kw["batch_stats"] = batch_stats_from_jax(random_stats(model.dnn))
        y = torch.zeros(2, 2048)
        with_stats = graphs.program_key(model, y, kw)
        assert with_stats != graphs.program_key(model, y, {})
        assert with_stats == graphs.program_key(model, y, dict(kw))
    assert_program_equals_eager(model, _wave(2, 2500, 13), seeds=(0, 1, 2), **kw)


TRAIN_ARGS = ["--format", "wsj0", "--batch_size", "2", "--num_frames", "64", "--n_fft", "126",
              "--hop_length", "32", "--num_workers", "2", "--num_eval_files", "0",
              "--log_every_n_steps", "1", "--device", "cpu", "--nf", "8", "--ch_mult", "1,2",
              "--fft_num", "128", "--d_feat", "64", "--c", "8", "--cd1", "8", "--p", "1",
              "--q", "1", "--max_steps", "2"]


@pytest.mark.parametrize("mode", ["storm", "denoiser-only-bn"])
def test_cli_trains_gagnet_and_enhances(mode, tmp_path):
    """`train --backbone_denoiser gagnet` (its argparse group's flags in the
    checkpoint's config; `--norm_type BN` trains on batch statistics), then
    the enhancement CLI on the checkpoint."""
    root = _write_corpus(tmp_path / "corpus", n_train=4, n_valid=2)
    logs = tmp_path / "logs"
    extra = (["--mode", "regen-joint-training"] if mode == "storm"
             else ["--mode", "denoiser-only", "--norm_type", "BN"])
    train.main(TRAIN_ARGS + ["--base_dir", root, "--log_dir", str(logs),
                             "--backbone_denoiser", "gagnet"] + extra)
    (run,) = os.listdir(logs)
    ckpt = str(logs / run / "checkpoints" / "last.pt")
    config, _, _ = load_checkpoint(ckpt)
    assert config["backbone_denoiser"] == "gagnet" and config["d_feat"] == 64
    assert config["norm_type"] == ("IN" if mode == "storm" else "BN")
    noisy, out = tmp_path / "noisy", tmp_path / "out"
    noisy.mkdir()
    save_wav(str(noisy / "a.wav"), _wave(1, 2100, 12)[0])
    enhancement.main(["--test_dir", str(noisy), "--enhanced_dir", str(out), "--ckpt", ckpt,
                      "--mode", "storm" if mode == "storm" else "denoiser-only", "--N", "2",
                      "--device", "cpu"])
    x, sr = load_wav(str(out / "a.wav"))
    assert sr == 16000 and x.shape == (1, 2100) and np.isfinite(x).all()


def test_bench_with_gagnet_builds_both_nets_and_refuses_the_score_input():
    """`bench --backbone gagnet` sets both nets, as the reference's bench
    does (bench.py:54-56, 111); GaGNet then refuses the score net's
    multi-channel input at its forward, as the reference's asserts."""
    from storm_tpu_torch import bench

    with pytest.raises(ValueError, match="dnn_channels=1"):
        bench.main(["--device", "cpu", "--batch", "1", "--frames", "16", "--N", "1",
                    "--reps", "1", "--quant", "none", "--deepcache", "0",
                    "--backbone", "gagnet"])


def test_bf16_at_the_reference_width_parts_from_f32_as_the_reference_does():
    """At the reference CLI's width (c 64, d_feat 448, p 2, q 3) bfloat16
    GaGNet parts from its float32 output by a large share of the output in
    both packages (the phases of near-empty bins, the tanh mask): the
    port's relative L2 distance within 0.5-1.5 of the reference's, and the
    two bfloat16 outputs no further apart than the reference's from its
    float32. chip_smoke.py phase 65 bounds the card's distance by this."""
    x = _x(B=1, T=16, seed=11)
    jnet = JGaGNet.from_kwargs()
    params = gdraw(jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"], 12)
    want = np.asarray(jax.jit(jnet.apply)({"params": params}, jnp.asarray(x)))
    want_bf16 = np.asarray(jax.jit(JGaGNet.from_kwargs(dtype=jnp.bfloat16).apply)(
        {"params": params}, jnp.asarray(x)))
    pnet = GaGNet.from_kwargs().eval()
    pnet.load_state_dict(module_params_from_jax(params), strict=True)
    with torch.no_grad():
        got = pnet(tt(x)).numpy()
        pnet.dtype = torch.bfloat16
        got_bf16 = pnet(tt(x)).numpy()

    def l2(a, b):
        return np.linalg.norm(a - b) / np.linalg.norm(b)

    ref_effect = l2(want_bf16, want)
    print(f"relative L2 bf16-f32: reference {ref_effect:.3f}, port {l2(got_bf16, got):.3f}, "
          f"port-reference bf16 {l2(got_bf16, want_bf16):.3f}")
    assert 0.05 < ref_effect < 1.0, ref_effect
    assert 0.5 <= l2(got_bf16, got) / ref_effect <= 1.5
    assert l2(got_bf16, want_bf16) <= 1.5 * ref_effect
    assert_close_rel(got, want, 5e-4, "f32 at the reference width")
