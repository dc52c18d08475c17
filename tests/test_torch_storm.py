"""The slice end to end: StoRM `enhance` against the reference's `make_enhance`
with the same weights and replayed noise, then the port's CLI on the CPU.

Tiny nets (nf 16, three levels) with a small STFT (n_fft 62 -> 32 bins).
Tolerance 1e-4 relative to the wave's scale: the NCSN++ tolerance carried
through a few sampler steps and the iSTFT.
"""
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import ReplayNoise, assert_close_rel, jax_noise_schedule, perturb_tree, to_numpy_tree, tt

from storm_tpu.models.factory import build_model as jbuild
from storm_tpu_torch import enhancement
from storm_tpu_torch.ckpt import load_checkpoint, save_checkpoint
from storm_tpu_torch.convert import params_from_jax
from storm_tpu_torch.data.audio import load_wav, save_wav
from storm_tpu_torch.models.factory import build_model as pbuild

CONFIG = {"mode": "regen-joint-training", "nf": 16, "ch_mult": [1, 2, 2],
          "init_scale": 1.0, "n_fft": 62, "hop_length": 16, "sde": "ouve"}


def _wave(n, seed):
    rng = np.random.default_rng(seed)
    x = 0.3 * np.sin(2 * np.pi * 300 * np.arange(n) / 16000) + 0.05 * rng.standard_normal(n)
    return x.astype(np.float32)


@pytest.mark.parametrize("corrector", ["ald", "none"])
def test_tiny_enhance_matches_reference(corrector):
    N, T = 3, 700  # 44 frames, padded to 64
    jmodel = jbuild(dict(CONFIG))
    jparams = jmodel.init_params(jax.random.PRNGKey(0), (1, 32, 64))
    params = {k: perturb_tree(to_numpy_tree(v), seed=i)
              for i, (k, v) in enumerate(jparams.items())}
    y = _wave(T, 0)[None]
    key = jax.random.PRNGKey(5)
    enhance = jmodel.make_enhance(N=N, corrector=corrector)
    want, nfe_j = enhance(params, jnp.asarray(y), key)

    pmodel = pbuild(dict(CONFIG), device="cpu")
    pmodel.load_state_dict(params_from_jax(params, target=pmodel), strict=True)
    noise = ReplayNoise(jax_noise_schedule(key, (1, 32, 64), N, corrector=corrector))
    got, nfe_p = pmodel.enhance(tt(y), N=N, corrector=corrector, noise=noise)
    assert noise.exhausted()
    assert nfe_p == int(nfe_j) == 1 + N * (1 + (corrector != "none"))
    assert got.shape == (1, T)
    assert_close_rel(got.numpy(), np.asarray(want), 1e-4, f"enhance/{corrector}")


def test_cli_enhances_on_cpu(tmp_path):
    model = pbuild(dict(CONFIG), device="cpu")
    ckpt = str(tmp_path / "tiny.pt")
    save_checkpoint(ckpt, CONFIG, model.state_dict())
    config, params, ema = load_checkpoint(ckpt)
    assert config == CONFIG and params.keys() == ema.keys()
    noisy, out = tmp_path / "noisy", tmp_path / "out"
    noisy.mkdir()
    lengths = {"a.wav": 900, "b.wav": 1531}
    for name, n in lengths.items():
        save_wav(str(noisy / name), _wave(n, n))
    enhancement.main(["--test_dir", str(noisy), "--enhanced_dir", str(out), "--ckpt", ckpt,
                      "--mode", "storm", "--N", "2", "--device", "cpu", "--timeit"])
    written = sorted(os.path.basename(p) for p in glob.glob(str(out / "*.wav")))
    assert written == sorted(lengths)
    for name, n in lengths.items():
        x, sr = load_wav(str(out / name))
        assert sr == 16000 and x.shape == (1, n) and np.isfinite(x).all()


def test_no_silent_cpu(tmp_path):
    """Without a card, the default device (cuda) raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pbuild(dict(CONFIG))
    ckpt = str(tmp_path / "tiny.pt")
    save_checkpoint(ckpt, CONFIG, pbuild(dict(CONFIG), device="cpu").state_dict())
    (tmp_path / "noisy").mkdir()
    save_wav(str(tmp_path / "noisy" / "a.wav"), _wave(900, 1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        enhancement.main(["--test_dir", str(tmp_path / "noisy"), "--enhanced_dir",
                          str(tmp_path / "out"), "--ckpt", ckpt, "--mode", "storm"])
