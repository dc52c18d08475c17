"""Port parity: the reference-checkpoint converters (storm_tpu_torch/compat/,
tools/orbax_to_pt.py) against storm_tpu's (storm_tpu/compat/torch_ckpt.py,
storm_tpu/ckpt.py).

No reference checkpoint is in the repository: Lightning checkpoints are
synthesized in the reference's key layout from seeded weights (NCSN++
through the JAX package's inverse converter, ConvTasNet by its documented
names, GaGNet from the port's state_dict, which carries the reference's
names, with BatchNorm buffers), with torch-ema shadow parameters. The
conversions are held to be exact: the port's equals `params_from_jax` of
the JAX package's, bit for bit. Served outputs are held to 1e-4 of their
scale where the two packages compute them (tests/test_torch_gagnet.py) and
bit for bit where the port serves one model two ways.
"""
import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_gagnet import GAG, NCSN, SMALL, STFT, _wave, gdraw, random_stats
from torch_parity import ReplayNoise, assert_close_rel, jax_noise_schedule, to_numpy_tree, tt

from storm_tpu.backbones.convtasnet import ConvTasNet as JConvTasNet
from storm_tpu.backbones.gagnet import GaGNet as JGaGNet
from storm_tpu.backbones.ncsnpp import NCSNpp as JNCSNpp
from storm_tpu.ckpt import load_checkpoint as jload_checkpoint
from storm_tpu.ckpt import save_checkpoint as jsave_checkpoint
from storm_tpu.compat import torch_ckpt as jtc
from storm_tpu.models.base import init_train_state as jinit_state
from storm_tpu.models.base import make_optimizer as jmake_optimizer
from storm_tpu.models.factory import build_model as jbuild
from storm_tpu_torch import enhancement
from storm_tpu_torch.backbones.convtasnet import ConvTasNet
from storm_tpu_torch.backbones.gagnet import GaGNet
from storm_tpu_torch.ckpt import load_checkpoint, save_checkpoint
from storm_tpu_torch.compat import convert as pconvert
from storm_tpu_torch.compat import torch_ckpt as ptc
from storm_tpu_torch.convert import batch_stats_from_jax, module_params_from_jax, params_from_jax
from storm_tpu_torch.data.audio import load_wav, save_wav
from storm_tpu_torch.models.factory import build_model as pbuild
from storm_tpu_torch.utils.serving import batch_stats_path, load_gagnet_batch_stats


def _trees_equal(a, b, path=""):
    assert set(a) == set(b), f"{path}: {sorted(set(a) ^ set(b))[:6]}"
    for k in a:
        if isinstance(a[k], dict):
            _trees_equal(a[k], b[k], f"{path}/{k}")
        else:
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), f"{path}/{k}"


def _sd_equal(a, b):
    assert set(a) == set(b), sorted(set(a) ^ set(b))[:6]
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _gagnet(seed=1, **kw):
    """(flax tree, the port's GaGNet carrying it)."""
    kw = dict(SMALL, **kw)
    shapes = jax.eval_shape(JGaGNet.from_kwargs(**kw).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 1, 256, 16, 2)))["params"]
    tree = gdraw(shapes, seed)
    net = GaGNet.from_kwargs(**kw)
    net.load_state_dict(module_params_from_jax(tree), strict=True)
    return tree, net


def with_bn_buffers(sd, seed=2):
    """`sd` with torch BatchNorm's buffers after each norm's bias, as a
    reference norm_type "BN" state_dict orders them: positive variances."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in sd.items():
        out[k] = v
        if k.endswith(".norm.bias"):
            stem = k[: -len("bias")]
            out[stem + "running_mean"] = torch.from_numpy(
                (0.2 * rng.standard_normal(v.shape)).astype(np.float32))
            out[stem + "running_var"] = torch.from_numpy(
                (0.5 + rng.random(v.shape)).astype(np.float32))
            out[stem + "num_batches_tracked"] = torch.tensor(7)
    return out


@pytest.mark.parametrize("kw", [{}, {"norm_type": "BN"}, {"is_squeezed": True},
                                {"intra_connect": "add", "causal": True}],
                         ids=["IN", "BN", "squeezed", "add-causal"])
def test_reference_converter_inverts_the_port_state_dict(kw):
    """The port's GaGNet state_dict is in the reference's layout: the JAX
    package's `convert_gagnet_state_dict` of it gives back exactly the tree
    `params_from_jax` started from, every key consumed (BN buffers aside)."""
    tree, net = _gagnet(**kw)
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    if kw.get("norm_type") == "BN":
        sd = {k: np.asarray(v) for k, v in with_bn_buffers(net.state_dict()).items()}
    _trees_equal(jtc.convert_gagnet_state_dict(sd), tree)
    _sd_equal(ptc.convert_gagnet_state_dict(sd), net.state_dict())


def _convtasnet_reference_sd(net):
    """The reference ConvTasNet's names for the port's parameters
    (storm_tpu/compat/torch_ckpt.py `convert_convtasnet_state_dict`)."""
    out = {}
    for k, v in net.state_dict().items():
        p = k.split(".")
        if k in ("encoder_w", "decoder_w"):
            name = k.replace("_w", ".weight")
        elif p[1] in ("LN",):
            name = f"TCN.LN.{'weight' if p[2] == 'gain' else 'bias'}"
        elif p[1] in ("BN_w", "BN_b", "output_w", "output_b"):
            stem, wb = p[1].split("_")
            name = (f"TCN.{stem}." if stem == "BN" else "TCN.output.1.") + (
                "weight" if wb == "w" else "bias")
        elif p[1] == "output_prelu":
            name = "TCN.output.0.weight"
        else:  # TCN.TCN_{i}.<...>
            i = p[1].split("_")[1]
            if p[2] in ("reg1", "reg2"):
                name = f"TCN.TCN.{i}.{p[2]}.{'weight' if p[3] == 'gain' else 'bias'}"
            elif p[2].startswith("nonlinearity"):
                name = f"TCN.TCN.{i}.{p[2]}.weight"
            else:
                sub, wb = p[2].rsplit("_", 1)
                name = f"TCN.TCN.{i}.{sub}.{'weight' if wb == 'w' else 'bias'}"
        out[name] = v
    return out


def _reference_sd(backbone):
    """(reference-layout state_dict of one net under 'dnn.', flax tree)."""
    if backbone == "ncsnpp":
        jnet = JNCSNpp.from_kwargs(input_channels=4, nf=16, ch_mult=(1, 2), image_size=64)
        tree = gdraw(jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.zeros((1, 2, 64, 32, 2)),
                                    jnp.ones((1,)))["params"], 3)
        sd = {k: torch.from_numpy(np.ascontiguousarray(v))
              for k, v in jtc.flax_to_torch_backbone(tree, prefix="dnn.").items()}
        return sd, tree
    if backbone == "convtasnet":
        kw = dict(enc_dim=16, feature_dim=8, layer=2, stack=2)
        shapes = jax.eval_shape(JConvTasNet(**kw).init, jax.random.PRNGKey(0),
                                jnp.zeros((1, 1000)), jnp.ones((1,)))["params"]
        tree = gdraw(shapes, 4)
        net = ConvTasNet(**kw)
        net.load_state_dict(module_params_from_jax(tree), strict=True)
        return {"dnn." + k: v for k, v in _convtasnet_reference_sd(net).items()}, tree
    tree, net = _gagnet(norm_type="BN")
    return {"dnn." + k: v for k, v in with_bn_buffers(net.state_dict()).items()}, tree


def _lightning(sd):
    """A Lightning checkpoint of `sd` with torch-ema's shadow parameters
    (0.5x each trainable parameter, in state_dict order)."""
    trainable = list(jtc._iter_trainable_keys(sd))
    return {"state_dict": sd, "ema": {"shadow_params": [0.5 * sd[k] for k in trainable],
                                      "decay": 0.999, "num_updates": 3}}


@pytest.mark.parametrize("backbone", ["ncsnpp", "convtasnet", "gagnet"])
def test_lightning_conversion_matches_reference(backbone):
    """The port's `convert_lightning_checkpoint` is `params_from_jax` of the
    JAX package's, raw and EMA; the EMA replay skips the frozen Fourier W and
    the BN buffers."""
    sd, tree = _reference_sd(backbone)
    ckpt = _lightning(sd)
    jp, je = jtc.convert_lightning_checkpoint(ckpt, prefix="dnn.", backbone=backbone)
    p, e = ptc.convert_lightning_checkpoint(ckpt, prefix="dnn.", backbone=backbone)
    _trees_equal(to_numpy_tree(jp), tree)
    _sd_equal(p, module_params_from_jax(to_numpy_tree(jp)))
    _sd_equal(e, module_params_from_jax(to_numpy_tree(je)))
    assert not all(torch.equal(p[k], e[k]) for k in p)
    with pytest.raises(ValueError, match="EMA shadow length"):
        ptc.convert_lightning_checkpoint({"state_dict": sd, "ema": {"shadow_params": [1.0]}},
                                         backbone=backbone)


def test_storm_reference_checkpoint_matches_reference(tmp_path):
    """`load_reference_checkpoint` of a StoRM file (a GaGNet-BN denoiser and
    an NCSN++ score net, each under its prefix; the backbones named in the
    hyperparameters) against the JAX package's, through `params_from_jax`."""
    den, _ = _reference_sd("gagnet")
    score, _ = _reference_sd("ncsnpp")
    sd = {**{"denoiser_net." + k[4:]: v for k, v in den.items()},
          **{"score_net." + k[4:]: v for k, v in score.items()}}
    ckpt = dict(_lightning(sd), hyper_parameters={"backbone_denoiser": "gagnet",
                                                  "backbone_score": "ncsnpp"})
    path = str(tmp_path / "storm.ckpt")
    torch.save(ckpt, path)
    jp, je, jh = jtc.load_reference_checkpoint(path, mode="storm")
    p, e, h = ptc.load_reference_checkpoint(path, mode="storm")
    assert h == jh
    _sd_equal(p, params_from_jax(to_numpy_tree(jp)))
    _sd_equal(e, params_from_jax(to_numpy_tree(je)))


def test_batch_stats_agree_and_the_side_file_is_shared(tmp_path):
    """`convert_gagnet_batch_stats` gives the JAX package's tree; a side file
    written by either package loads in the other; the port validates it
    against the model and maps it onto the norms; a corrupt or mis-pathed
    file raises."""
    sd, _ = _reference_sd("gagnet")
    want = jtc.convert_gagnet_batch_stats(sd, prefix="dnn.")
    got = ptc.convert_gagnet_batch_stats(sd, prefix="dnn.")
    _trees_equal(got, want)
    assert ptc.convert_gagnet_batch_stats(_reference_sd("ncsnpp")[0], prefix="dnn.") is None
    model = pbuild({"mode": "denoiser-only", "backbone_denoiser": "gagnet", "norm_type": "BN",
                    **SMALL, "n_fft": 510}, device="cpu")
    jfile, pfile = str(tmp_path / "j.json"), str(tmp_path / "p.json")
    jtc.save_batch_stats(jfile, want)
    ptc.save_batch_stats(pfile, got)
    assert json.load(open(jfile)) == json.load(open(pfile))
    _trees_equal(ptc.load_batch_stats(jfile), jtc.load_batch_stats(pfile))
    ptc.validate_batch_stats(ptc.load_batch_stats(jfile), model)
    mapped = ptc.model_batch_stats(ptc.load_batch_stats(jfile), model)
    assert set(mapped) == {k[4:-len(".running_mean")] for k in sd if k.endswith("running_mean")}
    storm_form = ptc.model_batch_stats({"denoiser": want}, model)
    assert storm_form["score"] is None and set(storm_form["denoiser"]) == set(mapped)
    corrupt = json.load(open(jfile))
    key = next(k for k in corrupt if k.endswith("/var"))
    for bad, what in (({k: v for k, v in corrupt.items() if k != key}, "both mean and var"),
                      ({**corrupt, key: [1.0]}, "shape"),
                      ({"en/no_norm/mean": [0.0], "en/no_norm/var": [1.0]}, "mis-pathed")):
        with open(pfile, "w") as f:
            json.dump(bad, f)
        with pytest.raises(ValueError, match=what):
            ptc.validate_batch_stats(ptc.load_batch_stats(pfile), model)
    with pytest.raises(ValueError, match="mis-pathed"):  # a StoRM tree on a one-net model
        ptc.validate_batch_stats({"denoiser": want}, model)


def _bn_lightning_ckpt(path, hparams):
    """A denoiser-only GaGNet-BN Lightning checkpoint at the model tests'
    width, with EMA and running statistics; returns the reference sd."""
    model = pbuild({"mode": "denoiser-only", "backbone_denoiser": "gagnet", "norm_type": "BN",
                    **STFT, **GAG}, device="cpu", seed=5)
    sd = {"dnn." + k: v for k, v in with_bn_buffers(model.dnn.state_dict(), seed=6).items()}
    torch.save(dict(_lightning(sd), hyper_parameters=hparams), path)
    return sd


def test_convert_cli_serves_a_bn_checkpoint(tmp_path, capsys):
    """`python -m storm_tpu_torch.compat.convert` on a GaGNet-BN denoiser: the
    config from the hyperparameters (the backbone's fields too) and `--set`,
    the EMA weights, the side file; the enhancement CLI loads the file, says
    so, and serves what the model's `enhance` gives with those statistics,
    not the batch's."""
    hp = {"backbone": "gagnet", "norm_type": "BN", "c": GAG["c"], "cd1": GAG["cd1"],
          "d_feat": GAG["d_feat"], "p": 1, "q": 1, "spec_factor": 0.33,
          "spec_abs_exponent": 0.5, "window": "hann", "hop_length": STFT["hop_length"],
          "loss_type": "mse", "unknown": object()}
    ckpt, pt = str(tmp_path / "ref.ckpt"), str(tmp_path / "conv.pt")
    sd = _bn_lightning_ckpt(ckpt, hp)
    pconvert.main(["--ckpt", ckpt, "--out", pt, "--mode", "denoiser-only",
                   "--set", f"n_fft={STFT['n_fft']}", "--set", f"fft_num={GAG['fft_num']}"])
    assert "BatchNorm running stats saved to" in capsys.readouterr().out
    config, params, ema = load_checkpoint(pt)
    assert config["mode"] == "denoiser-only" and config["norm_type"] == "BN"
    assert config["n_fft"] == STFT["n_fft"] and config["d_feat"] == GAG["d_feat"]
    assert torch.equal(ema["dnn.en.last_conv.2.weight"], 0.5 * sd["dnn.en.last_conv.2.weight"])
    assert os.path.exists(batch_stats_path(pt))

    noisy, out = tmp_path / "noisy", tmp_path / "out"
    noisy.mkdir()
    y = _wave(1, 2500, 3)[0]
    save_wav(str(noisy / "a.wav"), y)
    enhancement.main(["--test_dir", str(noisy), "--enhanced_dir", str(out), "--ckpt", pt,
                      "--mode", "denoiser-only", "--device", "cpu"])
    assert f"BatchNorm running stats loaded from {batch_stats_path(pt)}" in capsys.readouterr().out
    got, _ = load_wav(str(out / "a.wav"))
    model = pbuild(config, device="cpu")
    model.load_state_dict(ema)
    y16 = load_wav(str(noisy / "a.wav"))[0]
    stats = load_gagnet_batch_stats(pt, model)
    pad = np.pad(y16, [(0, 0), (0, 4096 - 2500)])  # the CLI's bucket: a multiple of 64 hops
    want = model.enhance(tt(pad), batch_stats=stats)[0][..., :2500].numpy()
    plain = model.enhance(tt(pad))[0][..., :2500].numpy()
    # the server loads the side file too, as the reference's serve.py:239 does
    from storm_tpu_torch import serve

    args = serve.build_argparser().parse_args(["--ckpt", pt, "--mode", "denoiser-only",
                                               "--port", "0", "--device", "cpu"])
    httpd, batcher = serve.build_server(args)
    try:
        assert batcher.enhancer.enhance_kwargs["batch_stats"] is not None
    finally:
        httpd.server_close()
        batcher.close()
    assert f"BatchNorm running stats loaded from {batch_stats_path(pt)}" in capsys.readouterr().out
    # the WAV's 16-bit codes (save_wav truncates x * 32767, load_wav divides by
    # 32768): the same codes, or the next one where float rounding crosses a step
    codes = np.trunc(np.clip(want, -1, 1) * 32767.0) / 32768.0
    assert np.abs(got - codes).max() <= 1.0 / 32768 and np.mean(got == codes) > 0.99
    assert np.abs(plain - want).max() > 1e-2


def test_convert_cli_refuses_a_mismatched_config(tmp_path):
    ckpt = str(tmp_path / "ref.ckpt")
    _bn_lightning_ckpt(ckpt, {"backbone": "gagnet", "norm_type": "BN"})
    with pytest.raises(SystemExit, match="do not match"):
        pconvert.main(["--ckpt", ckpt, "--out", str(tmp_path / "x.pt"), "--mode",
                       "denoiser-only", "--set", "n_fft=126", "--set", "c=4"])
    with pytest.raises(SystemExit, match="no parameters found"):
        pconvert.main(["--ckpt", ckpt, "--out", str(tmp_path / "x.pt"), "--mode", "storm"])


def test_orbax_to_pt_serves_like_the_reference(tmp_path):
    """tools/orbax_to_pt.py on a checkpoint the JAX package saved on the CPU
    (StoRM with a GaGNet denoiser, and a side file): the port's `enhance`
    with the converted EMA weights equals the JAX package's on the same
    draws."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "orbax_to_pt", os.path.join(os.path.dirname(__file__), "..", "tools", "orbax_to_pt.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)

    config = {"mode": "regen-joint-training", "backbone_denoiser": "gagnet", "sde": "ouve",
              **STFT, **GAG, **NCSN, "spec_factor": 0.33, "spec_abs_exponent": 0.5,
              "window": "hann"}
    jmodel = jbuild(dict(config))
    params = gdraw(jax.eval_shape(lambda: jmodel.init_params(jax.random.PRNGKey(0),
                                                              (1, 64, 64))), 6)
    state = jinit_state(jax.tree.map(jnp.asarray, params), jmake_optimizer(jmodel.lr))
    ckdir = str(tmp_path / "orbax")
    jsave_checkpoint(ckdir, state, config)
    # the reference's own loader restores into a (1, 256, 64) skeleton, which
    # a GaGNet built for 65 bins refuses; the tool passes one at the config's
    with pytest.raises(TypeError, match="incompatible shapes"):
        jload_checkpoint(ckdir)
    with open(os.path.join(ckdir, "gagnet_batch_stats.json"), "w") as f:
        json.dump({}, f)
    pt = tool.main(["--ckpt", ckdir, "--out", str(tmp_path / "m.pt")])
    assert os.path.exists(batch_stats_path(pt))
    pconfig, _, ema = load_checkpoint(pt)
    pmodel = pbuild(pconfig, device="cpu")
    pmodel.load_state_dict(ema)
    N, T = 2, 2000
    y = _wave(1, T, 7)
    key = jax.random.PRNGKey(3)
    want, _ = jmodel.make_enhance(N=N, corrector="none")(params, jnp.asarray(y), key)
    noise = ReplayNoise(jax_noise_schedule(key, (1, 64, 64), N, corrector="none"))
    got, _ = pmodel.enhance(tt(y), N=N, noise=noise)
    assert noise.exhausted()
    assert_close_rel(got.numpy(), np.asarray(want), 1e-4, "enhance after orbax_to_pt")


def test_truncated_config_warns(tmp_path):
    """A checkpoint whose config lacks a signal-processing field warns when
    it is loaded (storm_tpu/ckpt.py:125-145); a full one does not."""
    model = pbuild({"mode": "denoiser-only", "backbone_denoiser": "gagnet", **STFT, **GAG},
                   device="cpu")
    path = str(tmp_path / "t.pt")
    save_checkpoint(path, {"mode": "denoiser-only", "n_fft": 126}, model.state_dict())
    with pytest.warns(UserWarning, match=r"lacks \['hop_length', 'window', 'spec_factor'"):
        load_checkpoint(path)
    full = {"n_fft": 126, "hop_length": 32, "window": "hann", "spec_factor": 0.33,
            "spec_abs_exponent": 0.5}
    save_checkpoint(path, full, model.state_dict())
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        load_checkpoint(path)


def test_batch_stats_from_jax_names_every_norm():
    """The flax batch_stats tree of every norm maps onto the port's norm
    names, which are the reference's running-statistics prefixes."""
    tree, net = _gagnet(norm_type="BN")
    stats = batch_stats_from_jax(random_stats(net))
    names = {k[: -len(".running_mean")] for k in with_bn_buffers(net.state_dict())
             if k.endswith("running_mean")}
    assert set(stats) == names and all(set(v) == {"mean", "var"} for v in stats.values())
