"""The port's `BucketedEnhancer` and the enhancement CLI's bucketing against
the reference's: the bucket rule, the width NCSN++ sees, enhancement with
replayed noise at B=1, with a ragged minibatch and with int8 scales, and the
CLI's `--batch` grouping by WAV-header length.

Tiny nets (nf 16, three levels, n_fft 62, hop 16: a bucket of 64 hops is
1024 samples). Tolerances: waveforms 1e-4 relative to their scale (NCSN++'s
float32 tolerance carried through a few sampler steps and the iSTFT, as in
test_torch_storm); int8 conv outputs 1e-5 of their scale at every quantized
conv call, as in test_torch_quant; lengths, widths and groupings exact.
"""
import glob
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import ReplayNoise, assert_close_rel, jax_noise_schedule, nhwc, tt

from storm_tpu.models import quant as jquant
from storm_tpu.models.factory import build_model as jbuild
from storm_tpu.nn.qconv import QuantizableConv as JConv
from storm_tpu.utils.inference import BucketedEnhancer as JBucketed
from storm_tpu_torch import enhancement
from storm_tpu_torch.ckpt import save_checkpoint
from storm_tpu_torch.convert import params_from_jax
from storm_tpu_torch.data.audio import load_wav, save_wav, wav_info
from storm_tpu_torch.models.factory import build_model as pbuild
from storm_tpu_torch.sampling import samplers
from storm_tpu_torch.signal.stft import STFTConfig
from storm_tpu_torch.utils.inference import BucketedEnhancer

F = 32  # frequency bins at n_fft 62
BUCKET = 64 * 16


STORM_TINY = {"mode": "regen-joint-training", "nf": 16, "ch_mult": [1, 2, 2],
              "init_scale": 1.0, "n_fft": 62, "hop_length": 16, "sde": "ouve"}


def random_params(jmodel, shape, seed=0):
    """Weights for the reference model's parameter tree, drawn with numpy:
    fan-in scaled kernels, the Fourier features' W at scale 16, biases and
    norm scales near 0 and 1 (jax.eval_shape gives the tree without running
    the reference's initialisers)."""
    shapes = jax.eval_shape(lambda: jmodel.init_params(jax.random.PRNGKey(0), shape))
    rng = np.random.default_rng(seed)

    def draw(name, s):
        z = rng.standard_normal(s).astype(np.float32)
        if name == "W" and len(s) == 1:
            return 16.0 * z
        if name in ("kernel", "W"):
            return z / np.sqrt(np.prod(s[:-1]))
        return (1.0 if name == "scale" else 0.0) + 0.05 * z

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else draw(k, v.shape) for k, v in tree.items()}

    return walk(shapes)


def tiny_storm_pair(seed=0):
    """(reference model, its parameters, the port model with the same
    weights on the CPU) at STORM_TINY."""
    jmodel = jbuild(dict(STORM_TINY))
    params = random_params(jmodel, (1, 32, 64), seed)
    pmodel = pbuild(dict(STORM_TINY), device="cpu")
    pmodel.load_state_dict(params_from_jax(params, target=pmodel), strict=True)
    return jmodel, params, pmodel


def wave(n, seed):
    """A 300 Hz tone in white noise, float32 at 16 kHz."""
    rng = np.random.default_rng(seed)
    x = 0.3 * np.sin(2 * np.pi * 300 * np.arange(n) / 16000) + 0.05 * rng.standard_normal(n)
    return x.astype(np.float32)


def jax_chunk_noise(key, shapes, n_steps, corrector="ald"):
    """The draws of the reference's `BucketedEnhancer` with `minibatch` set:
    one key split off per chunk, each chunk's `pc_sample` draws from it.
    `shapes`: the (rows, F, frames) of each chunk, in order."""
    draws = []
    for shape in shapes:
        key, k = jax.random.split(key)
        draws += jax_noise_schedule(k, shape, n_steps, corrector=corrector)
    return draws


def frames(T):
    """NCSN++ width of a T-sample input already padded to its bucket."""
    n = T // 16 + 1
    return -(-n // 64) * 64


@pytest.fixture(scope="module")
def pair():
    return tiny_storm_pair(seed=3)


# --- the fault: the CLI enhanced each file at its exact length


def test_cli_enhances_at_the_reference_bucket_width(pair, tmp_path):
    """The port's CLI feeds NCSN++ the width the reference CLI does and gives
    its output: a 700-sample file is padded to 1024 samples (65 frames,
    padded to 128), not enhanced at its 44 frames (padded to 64)."""
    jmodel, params, pmodel = pair
    N, T = 3, 700
    ckpt = str(tmp_path / "tiny.pt")
    save_checkpoint(ckpt, STORM_TINY, pmodel.state_dict())
    noisy, out = tmp_path / "noisy", tmp_path / "out"
    noisy.mkdir()
    save_wav(str(noisy / "a.wav"), wave(T, 0))
    y = load_wav(str(noisy / "a.wav"))[0][0]

    key = jax.random.PRNGKey(11)
    want, nfe = JBucketed(jmodel, params, N=N, corrector="ald")(y, key)
    assert want.shape == (T,) and int(nfe) == 1 + 2 * N
    replay = ReplayNoise(jax_noise_schedule(key, (1, F, frames(BUCKET)), N))

    widths, saved = [], {}
    build = enhancement.build_model

    def build_and_watch(*args, **kwargs):
        model = build(*args, **kwargs)
        for net in (model.denoiser_net, model.score_net):
            net.register_forward_pre_hook(lambda m, inp: widths.append(inp[0].shape[-2]))
        return model

    with mock.patch.object(enhancement, "build_model", build_and_watch), \
            mock.patch.object(samplers, "generator_noise", lambda *a, **k: replay), \
            mock.patch.object(enhancement, "save_wav",
                              lambda path, x, sr: saved.update({os.path.basename(path): x})):
        enhancement.main(["--test_dir", str(noisy), "--enhanced_dir", str(out), "--ckpt", ckpt,
                          "--mode", "storm", "--N", str(N), "--device", "cpu"])
    assert widths == [frames(BUCKET)] * (1 + 2 * N)  # (B, D, F, T, 2): T at -2
    assert replay.exhausted()
    assert saved["a.wav"].shape == (T,)
    assert_close_rel(saved["a.wav"], np.asarray(want), 1e-4, "CLI against the reference CLI path")


# --- the bucket rule


class _Stub(torch.nn.Module):
    def __init__(self, hop):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(1))
        self.stft_config = STFTConfig(n_fft=4 * hop - 2, hop_length=hop)


@pytest.mark.parametrize("bucket_frames", [64, 16])
@pytest.mark.parametrize("hop", [16, 128])
def test_padded_len_matches_reference(hop, bucket_frames):
    port = BucketedEnhancer(_Stub(hop), bucket_frames=bucket_frames)
    ref = JBucketed(port.model, {}, bucket_frames=bucket_frames)
    b = bucket_frames * hop
    lengths = list(range(0, 3 * b + 2)) if hop == 16 else list(range(0, 3 * b + 2, 97)) + [
        b - 1, b, b + 1, 16000, 40000, 64000, 65536, 192000]
    for T in lengths:
        assert port.padded_len(T) == ref.padded_len(T), T


# --- enhancement against the reference's BucketedEnhancer


def test_b1_matches_reference(pair):
    jmodel, params, pmodel = pair
    N, T = 2, 1500  # bucket 2048: 129 frames, padded to 192
    y = wave(T, 1)
    key = jax.random.PRNGKey(2)
    want, nfe = JBucketed(jmodel, params, N=N, corrector="ald")(y, key)
    noise = ReplayNoise(jax_noise_schedule(key, (1, F, frames(2048)), N))
    got, pnfe = BucketedEnhancer(pmodel, N=N, corrector="ald")(y, noise=noise)
    assert noise.exhausted() and got.shape == (T,) and pnfe == int(nfe) == 1 + 2 * N
    assert_close_rel(got, np.asarray(want), 1e-4, "B=1")


def test_ragged_minibatch_matches_reference(pair):
    """Three rows in chunks of two: the last chunk is row-padded to two."""
    jmodel, params, pmodel = pair
    N = 2
    y = np.stack([wave(900, 4), wave(900, 5), wave(900, 6)])
    y[1, 700:] = 0.0  # a shorter file, padded by its caller
    key = jax.random.PRNGKey(4)
    want, nfe = JBucketed(jmodel, params, minibatch=2, N=N, corrector="ald")(y, key)
    noise = ReplayNoise(jax_chunk_noise(key, [(2, F, frames(BUCKET))] * 2, N))
    enh = BucketedEnhancer(pmodel, minibatch=2, N=N, corrector="ald")
    got, pnfe = enh(y, noise=noise)
    assert noise.exhausted()
    assert got.shape == y.shape and pnfe == int(nfe) == 2 * (1 + 2 * N)
    assert_close_rel(got, np.asarray(want), 1e-4, "ragged minibatch")


def test_chunks_are_row_padded_to_minibatch(pair):
    _, _, pmodel = pair
    calls = []
    enh = BucketedEnhancer(pmodel, minibatch=4, N=1, corrector="none")
    with mock.patch.object(enh, "_enhance",
                           side_effect=lambda yb, g, n: (calls.append(tuple(yb.shape)),
                                                         (yb.clone(), 3))[1]):
        x, nfe = enh(np.ones((5, 1100), np.float32))
    assert calls == [(4, 2048), (4, 2048)] and nfe == 6
    assert x.shape == (5, 1100) and np.all(x == 1.0)


def test_int8_enhancer_matches_reference_per_conv_call(pair, tmp_path):
    """An int8 enhancement through the enhancer at the bucket width: every
    quantized conv call held to the reference's QuantizableConv, with the same
    scales, on the input the port gave it."""
    from test_torch_quant import MIN_CH, _flax_node, _recorded_calls

    from storm_tpu_torch.models import quant as pquant

    jmodel, params, pmodel = pair
    N, T = 1, 700
    pq = pquant.calibrate_storm(pmodel, tt(wave(1024, 8)[None]), N=1, min_channels=MIN_CH,
                                generator=torch.Generator().manual_seed(1))
    pquant.save_scales(str(tmp_path / "scales.json"), pq, meta=None)
    quant = jax.tree_util.tree_map(jnp.float32,
                                   jquant.load_scales(str(tmp_path / "scales.json")))

    calls, hooks = _recorded_calls({net: (getattr(pmodel, f"{net}_net"), pq[net])
                                    for net in ("denoiser", "score")})
    try:
        got, nfe = BucketedEnhancer(pmodel, N=N, corrector="ald", quant=pq)(
            wave(T, 7), torch.Generator().manual_seed(0))
    finally:
        for h in hooks:
            h.remove()
    assert got.shape == (T,) and np.isfinite(got).all()
    assert len(calls) == 41 * nfe
    # the bucket's width (128 frames) and its halvings, level by level
    assert {tuple(x.shape[-1:]) for _, _, x, _ in calls} == {(128,), (64,), (32,)}
    jconvs = {}
    for net, name, x, out in calls:
        conv = _flax_node(params[net], name)
        k, cout = conv["kernel"].shape[0], conv["kernel"].shape[-1]
        if (k, cout) not in jconvs:
            jconvs[k, cout] = jax.jit(JConv(cout, (k, k), padding=[(k // 2, k // 2)] * 2).apply)
        ref = jconvs[k, cout]({"params": conv, "quant": _flax_node(quant[net], name)},
                              jnp.asarray(nhwc(x)))
        assert_close_rel(nhwc(out), np.asarray(ref), 1e-5, f"{net} {name}")


def test_enhance_async_returns_the_padded_batch_on_the_device(pair):
    _, _, pmodel = pair
    y = np.stack([wave(1100, 1), wave(1100, 2)])
    enh = BucketedEnhancer(pmodel, N=1, corrector="none")
    assert enh.supports_async
    x_dev, nfe = enh.enhance_async(y, torch.Generator().manual_seed(0))
    assert isinstance(x_dev, torch.Tensor) and x_dev.shape == (2, 2048) and nfe == 2
    x, _ = enh(y, torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(x_dev.numpy()[:, :1100], x)
    enh.minibatch = 2
    assert not enh.supports_async
    with pytest.raises(NotImplementedError, match="minibatch=None"):
        enh.enhance_async(y)


def test_refusals(pair):
    _, _, pmodel = pair
    for kw in ({"data_parallel": True}, {"seq_parallel": 2}):
        with pytest.raises(NotImplementedError, match="R7"):
            BucketedEnhancer(pmodel, **kw)
    with pytest.raises(NotImplementedError, match="multichannel"):
        BucketedEnhancer(pmodel)(np.zeros((1, 2, 100), np.float32))


# --- the CLI's --batch


def test_wav_info_reads_the_header(tmp_path):
    from scipy.io import wavfile

    from storm_tpu import native

    cases = {"mono16.wav": (16000, (np.zeros(1531) + 0.1 * 32767).astype(np.int16)),
             "stereo_f32.wav": (8000, np.zeros((777, 2), np.float32)),
             "i32.wav": (16000, np.arange(300, dtype=np.int32))}
    for name, (sr, data) in cases.items():
        wavfile.write(str(tmp_path / name), sr, data)
    # a LIST chunk before the data chunk, of odd size (padded to even)
    raw = (tmp_path / "mono16.wav").read_bytes()
    listed = raw[:36] + b"LIST" + (5).to_bytes(4, "little") + b"abcde\0" + raw[36:]
    listed = listed[:4] + (len(listed) - 8).to_bytes(4, "little") + listed[8:]
    (tmp_path / "listed.wav").write_bytes(listed)
    cases["listed.wav"] = cases["mono16.wav"]
    for name, (sr, data) in cases.items():
        path = str(tmp_path / name)
        x, sr_loaded = load_wav(path)
        assert wav_info(path) == (sr, x.shape[0], x.shape[1]) and sr_loaded == sr, name
        if native.available():
            assert wav_info(path) == tuple(native.wav_info(path)), name
    (tmp_path / "bad.wav").write_bytes(b"RIFX0000WAVE")
    with pytest.raises(ValueError, match="not a RIFF/WAVE"):
        wav_info(str(tmp_path / "bad.wav"))


def test_cli_batch_groups_files_by_bucket(pair, tmp_path, capsys):
    _, _, pmodel = pair
    ckpt = str(tmp_path / "tiny.pt")
    save_checkpoint(ckpt, STORM_TINY, pmodel.state_dict())
    noisy, out = tmp_path / "noisy", tmp_path / "out"
    noisy.mkdir()
    lengths = {"a.wav": 900, "b.wav": 1531, "c.wav": 1000, "d.wav": 2000, "e.wav": 700}
    for name, n in lengths.items():
        save_wav(str(noisy / name), wave(n, n))
    shapes = []
    enhance = type(pmodel).enhance

    def recorded(model, y, **kw):
        shapes.append(tuple(y.shape))
        return enhance(model, y, **kw)

    with mock.patch.object(type(pmodel), "enhance", recorded):
        enhancement.main(["--test_dir", str(noisy), "--enhanced_dir", str(out), "--ckpt", ckpt,
                          "--mode", "storm", "--N", "1", "--corrector", "none", "--batch", "2",
                          "--timeit", "--device", "cpu"])
    said = capsys.readouterr().out
    # bucket 1024: a, c, e (in name order) -> [a, c], [e]; bucket 2048: b, d -> [b, d]
    assert shapes == [(2, 1024), (2, 1024), (2, 2048)]
    assert said.count("  batch of 2: nfe=2 rtf=") == 2 and said.count("  batch of 1: nfe=2") == 1
    written = {}
    for name, n in lengths.items():
        x, sr = load_wav(str(out / name))
        assert sr == 16000 and x.shape == (1, n) and np.isfinite(x).all()
        written[name] = x[0]
    # the same groups through the enhancer, with the CLI's generator: the same
    enh = BucketedEnhancer(pmodel, minibatch=2, N=1, corrector="none")
    gen = torch.Generator().manual_seed(0)
    for group, L in ((("a.wav", "c.wav"), 1024), (("e.wav",), 1024), (("b.wav", "d.wav"), 2048)):
        ys = np.stack([np.pad(load_wav(str(noisy / g))[0][0], (0, L - lengths[g]))
                       for g in group])
        x, _ = enh(ys, gen)
        for g, row in zip(group, x):
            np.testing.assert_array_equal(
                written[g], load_wav_roundtrip(row[: lengths[g]], tmp_path))
    assert sorted(os.path.basename(p) for p in glob.glob(str(out / "*.wav"))) == sorted(lengths)


def load_wav_roundtrip(x, tmp_path):
    """x written as the CLI writes it and read back."""
    save_wav(str(tmp_path / "roundtrip.wav"), x)
    return load_wav(str(tmp_path / "roundtrip.wav"))[0][0]


def test_cli_refuses_unported_flags(pair, tmp_path):
    ckpt = str(tmp_path / "tiny.pt")
    save_checkpoint(ckpt, STORM_TINY, pair[2].state_dict())
    save_wav(str(tmp_path / "a.wav"), wave(700, 0))
    base = ["--test_dir", str(tmp_path), "--enhanced_dir", str(tmp_path / "o"), "--ckpt", ckpt,
            "--mode", "storm", "--device", "cpu"]
    for extra in (["--data_parallel"], ["--seq_parallel", "2"]):
        with pytest.raises(NotImplementedError, match="R7"):
            enhancement.main(base + extra)
