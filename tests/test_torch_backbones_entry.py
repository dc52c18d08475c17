"""Port parity and entry points for the NCSN++ family's options and sizes:
the int8 calibration of DDPM-resblock nets against storm_tpu's (the same
convs quantized, scales within 1e-4 relative, as tests/test_torch_quant.py),
`bench --backbone` and the trainer and enhancement CLIs with an ncsnpplarge
score net, on the CPU with tiny nets (nf 16 or 8, n_fft 62)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import random_params, tt


@pytest.mark.parametrize("kw", [dict(resblock_type="ddpm", progressive="residual",
                                     progressive_input="residual"),
                                dict(resblock_type="ddpm", fir=False)], ids=["fir", "no_fir"])
def test_ddpm_options_quantize_like_the_reference(kw):
    """The int8 calibration of a denoiser-only model with DDPM resblocks: the
    same convs take scales as in the reference (its 3x3 convs, and the
    plain resamplers' `Conv_0` where `fir` is off; not the strided conv of
    a plain Downsample, nor the FIR resamplers' `Conv2d_0`), at the same
    values (1e-4 relative, as tests/test_torch_quant.py), and the int8
    forward through them runs."""
    from storm_tpu.models import quant as jquant
    from storm_tpu.models.factory import build_model as jbuild
    from storm_tpu_torch.convert import params_from_jax
    from storm_tpu_torch.models import quant as pquant
    from storm_tpu_torch.models.factory import build_model as pbuild
    from test_torch_quant import _by_module

    cfg = {"mode": "denoiser-only", "nf": 16, "ch_mult": [1, 2], "n_fft": 62, "hop_length": 16,
           "init_scale": 1.0, **kw}
    jmodel = jbuild(dict(cfg))
    params = random_params(jax.eval_shape(lambda: jmodel.init_params(jax.random.PRNGKey(0),
                                                                       (1, 32, 64))), 5)
    pmodel = pbuild(dict(cfg), device="cpu")
    pmodel.load_state_dict(params_from_jax(params, target=pmodel), strict=True)
    y = (0.3 * np.random.default_rng(6).standard_normal((2, 1024))).astype(np.float32)
    want = _by_module(jquant.calibrate_discriminative(jmodel, params, jnp.asarray(y),
                                                      min_channels=8), "a_scale")
    got = pquant.calibrate_discriminative(pmodel, tt(y), min_channels=8)
    assert got.keys() == want.keys()
    assert not any(k.endswith("Conv2d_0") for k in got)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-4 * want[k], k
    x_hat, nfe = pmodel.enhance(tt(y), quant=got)
    assert nfe == 1 and torch.isfinite(x_hat).all()


def test_bench_runs_a_registered_backbone(capsys):
    """`python -m storm_tpu_torch.bench --backbone ncsnpp12M` builds both nets
    from the registry (here narrowed by --nf) and reports the name."""
    import json

    from storm_tpu_torch import bench

    bench.main(["--device", "cpu", "--nf", "16", "--batch", "1", "--frames", "64", "--N", "1",
                "--reps", "1", "--quant", "none", "--deepcache", "0",
                "--backbone", "ncsnpp12M"])
    (line,) = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    detail = json.loads(line)["detail"]
    assert detail["backbone"] == "ncsnpp12M" and json.loads(line)["value"] > 0


def test_cli_trains_storm_with_an_ncsnpplarge_score_net(tmp_path):
    """`train --backbone_score ncsnpplarge` (narrowed by --nf / --ch_mult; its
    two resblocks a level kept) writes a checkpoint whose config names it,
    and the enhancement CLI serves it."""
    import os

    from test_torch_train import TRAIN_ARGS, _write_corpus

    from storm_tpu_torch import enhancement, train
    from storm_tpu_torch.ckpt import load_checkpoint
    from storm_tpu_torch.data.audio import load_wav, save_wav

    root = _write_corpus(tmp_path / "corpus", n_train=2, n_valid=1)
    logs = tmp_path / "logs"
    train.main(TRAIN_ARGS + ["--base_dir", root, "--log_dir", str(logs), "--device", "cpu",
                             "--backbone_score", "ncsnpplarge", "--max_steps", "1"])
    (run,) = os.listdir(logs)
    ckpt = str(logs / run / "checkpoints" / "last.pt")
    config, params, _ = load_checkpoint(ckpt)
    assert config["backbone_score"] == "ncsnpplarge"
    n_modules = {net: 1 + max(int(k.split(".")[2]) for k in params
                              if k.startswith(f"{net}.all_modules."))
                 for net in ("denoiser_net", "score_net")}
    assert n_modules["score_net"] > n_modules["denoiser_net"]  # two resblocks a level
    noisy, out = tmp_path / "noisy", tmp_path / "out"
    noisy.mkdir()
    save_wav(str(noisy / "a.wav"), 0.1 * np.random.default_rng(0).standard_normal(700))
    enhancement.main(["--test_dir", str(noisy), "--enhanced_dir", str(out), "--ckpt", ckpt,
                      "--mode", "storm", "--N", "1", "--device", "cpu"])
    x, _ = load_wav(str(out / "a.wav"))
    assert x.shape == (1, 700) and np.isfinite(x).all()


@pytest.mark.parametrize("config, want", [
    ({"backbone_denoiser": "convtasnet", "backbone_score": "ncsnpplarge"},
     {"backbone_denoiser": "convtasnet", "backbone_score": "ncsnpplarge"}),
    ({"mode": "denoiser-only", "backbone_denoiser": "ae-ncsnpp", "backbone_score": "ncsnpp"},
     {"backbone_denoiser": "ae-ncsnpp"}),
    ({"mode": "score-only", "backbone": "ncsnpp6M"}, {"backbone_score": "ncsnpp6M"}),
], ids=["storm", "denoiser-only", "score-only"])
def test_backbones_of_names_each_net_as_the_factory_builds_it(config, want):
    """The server reports each net's backbone as `build_model` resolves it."""
    from storm_tpu_torch.models.factory import backbones_of

    assert backbones_of(config) == want
