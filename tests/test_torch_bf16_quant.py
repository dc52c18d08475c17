"""The int8 W8A8 path under bfloat16 compute against the reference's, and the
serving CLIs in bfloat16 (items 6-7 of tests/test_torch_bf16.py's list):

6. The quantizer forms x * inv in the compute dtype (K3's bfloat16-product
   mode: `jnp.round(v.astype(bf16) * inv.astype(bf16))`), and the epilogue
   rounds acc to bfloat16 (int32 -> float32 -> bfloat16, as XLA converts),
   multiplies by the scale rounded to bfloat16 and adds the bias rounded to
   bfloat16, each step rounded.
7. Calibration runs the nets in their dtype; the scale cache's meta has no
   dtype (storm_tpu/utils/serving.py:52-61), so scales calibrated in float32
   serve bfloat16 too, as in the reference.

Tiny sizes (convs of 16-32 channels, StoRM with nf 16, n_fft 62, the
quantization threshold lowered to 8 channels). Codes and integer sums are
held exactly; bfloat16 outputs in ulps of their scale
(torch_parity.ulps_of_scale).
"""
import glob
import http.client
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (
    ReplayNoise,
    bf16_values,
    jax_noise_schedule,
    nchw,
    nhwc,
    random_params,
    tt,
    ulps_of_scale,
)

from storm_tpu.models import quant as jquant
from storm_tpu.models.factory import build_model as jbuild
from storm_tpu.nn.qconv import QuantizableConv as JConv
from storm_tpu.signal import cplx as jcplx
from storm_tpu_torch import enhancement, serve
from storm_tpu_torch.ckpt import save_checkpoint
from storm_tpu_torch.convert import flax_path, module_name, module_params_from_jax, params_from_jax
from storm_tpu_torch.data.audio import load_wav, save_wav
from storm_tpu_torch.kernels.quant import quantize_int8, quantize_int8_plain
from storm_tpu_torch.models import quant as pquant
from storm_tpu_torch.models.factory import build_model as pbuild
from storm_tpu_torch.nn.layers import conv1x1, conv3x3
from storm_tpu_torch.nn.qconv import activation_inverse, quantizable_convs, scales_attached
from storm_tpu_torch.utils.server import decode_wav_bytes, encode_wav_bytes
from storm_tpu_torch.utils.serving import scale_cache_path

BF = jnp.bfloat16
CONFIG = {"mode": "regen-joint-training", "nf": 16, "ch_mult": [1, 2, 2],
          "init_scale": 1.0, "n_fft": 62, "hop_length": 16, "sde": "ouve"}
MIN_CH = 8
WAIT = 60  # seconds: the bound of every HTTP wait in this file


def _jax_codes(v, a_scale, cdt):
    """The activation codes of storm_tpu/nn/qconv.py `_int8_conv` (:128,
    :143-146) in compute dtype `cdt`."""
    inv = jnp.asarray(1.0, jnp.float32) / jnp.maximum(jnp.asarray(a_scale, jnp.float32), 1e-20)
    return np.asarray(jnp.clip(jnp.round(jnp.asarray(v).astype(cdt) * inv.astype(cdt)),
                               -127.0, 127.0).astype(jnp.int8))


def _every_bf16(limit: float) -> np.ndarray:
    """Every finite bfloat16 value of magnitude below `limit`, as float32."""
    x = (np.arange(1 << 16, dtype=np.uint32) << 16).view(np.float32)
    return x[np.isfinite(x) & (np.abs(x) < limit)]


# --- K3's bfloat16-product mode


@pytest.mark.parametrize("a_scale", [0.0371, 1.3e-3, 0.21])
def test_bf16_product_codes_equal_the_reference(a_scale):
    """Every bfloat16 input below saturation (and past it): the plain
    version's bfloat16-product codes equal the reference's qconv codes
    under bfloat16 compute, and its float32-product codes those under
    float32; the two modes part where the float32 and bfloat16 products
    round to different sides of a .5, as constructed here: every value whose
    bfloat16 product is an exact tie and whose float32 product is not."""
    inv = activation_inverse(a_scale)
    x = _every_bf16(140.0 * a_scale)
    xb = torch.from_numpy(x).bfloat16()
    got = quantize_int8_plain(xb, inv, product=torch.bfloat16).numpy()
    np.testing.assert_array_equal(got, _jax_codes(x, a_scale, BF))
    np.testing.assert_array_equal(quantize_int8(xb, inv, torch.bfloat16).numpy(), got)
    f32 = quantize_int8_plain(xb, inv).numpy()
    np.testing.assert_array_equal(f32, _jax_codes(x, a_scale, jnp.float32))
    inv_b = float(torch.tensor(np.float32(inv)).bfloat16())
    p_b = (xb * inv_b).float().numpy()
    p_f = x * np.float32(inv)
    ties = (p_b - np.floor(p_b) == 0.5) & (p_f - np.floor(p_f) != 0.5)
    assert ties.sum() > 100
    assert (got[ties] != f32[ties]).sum() > 10  # the modes part at the constructed ties


def test_bf16_product_of_a_float32_input_rounds_the_input_first():
    """`v.astype(bf16)`: a float32 input is rounded to bfloat16 before the
    product."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(4096) * 40).astype(np.float32)
    inv = activation_inverse(0.21)
    got = quantize_int8_plain(tt(x), inv, product=torch.bfloat16).numpy()
    np.testing.assert_array_equal(got, _jax_codes(x, 0.21, BF))
    np.testing.assert_array_equal(
        got, quantize_int8_plain(tt(x).bfloat16(), inv, product=torch.bfloat16).numpy())


def test_quantizer_refuses_other_products():
    with pytest.raises(ValueError, match="product"):
        quantize_int8(torch.zeros(4, 8), 1.0, product=torch.float16)


# --- the int8 conv's epilogue under bfloat16


def test_int32_to_bf16_conversion_equals_xla():
    """|acc| reaches 127 * 127 * 9 * 768 > 2^24: int32 -> bfloat16 then rounds
    twice, through float32, in XLA and in PyTorch alike (2^25 + 2^17 + 1
    goes to 2^25 where one rounding would give 2^25 + 2^18)."""
    rng = np.random.default_rng(0)
    acc = np.concatenate([rng.integers(-(127 * 127 * 9 * 768), 127 * 127 * 9 * 768, 100000),
                          [2**25 + 2**17 + 1, 2**25 + 2**17 - 1, -(2**25 + 2**17 + 1),
                           2**24 + 2**16 + 1, 127 * 127 * 9 * 768]]).astype(np.int32)
    want = np.asarray(jnp.asarray(acc).astype(BF).astype(jnp.float32))
    got = torch.from_numpy(acc).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got, want)
    assert got[-5] == 2.0**25


def _conv_case(k, cin, cout, split, seed, x):
    parts = [x] if split is None else [x[..., :split], x[..., split:]]
    jconv = JConv(cout, (k, k), padding=[(k // 2, k // 2)] * 2, dtype=BF)
    jargs = [jnp.asarray(p, BF) for p in parts]
    params = random_params(jax.eval_shape(jconv.init, jax.random.PRNGKey(k), *jargs)["params"],
                           seed)
    conv = (conv3x3 if k == 3 else conv1x1)(cin, cout)
    conv.load_state_dict(module_params_from_jax(params), strict=True)
    return jconv, jargs, params, conv


@pytest.mark.parametrize("split", [None, (24, 8)], ids=["single", "split"])
@pytest.mark.parametrize("k", [3, 1])
def test_int8_conv_bf16_matches_reference(k, split):
    """The quantizable conv's int8 path on a bfloat16 input against the
    reference's `_int8_conv` with dtype bfloat16 (codes of the concatenated
    halves for the up path's split input), and its default path against
    the reference's bfloat16 conv: the same codes, integer sums and rounded
    epilogue, so equal outputs (held to 1 ulp of their scale); the default
    path of the split input within 2 ulps of split_skip's two partial
    products (measured 1.5)."""
    cin, cout = 32, 16
    x = bf16_values(np.random.default_rng(k).standard_normal((2, 6, 10, cin)) * 1.7)
    jconv, jargs, params, conv = _conv_case(k, cin, cout, None if split is None else split[0],
                                            k, x)
    px = nchw(x).bfloat16()
    a_scale = np.float32(np.abs(x).max()) / np.float32(127.0)
    want = np.asarray(jconv.apply({"params": params, "quant": {"a_scale": jnp.float32(a_scale)}},
                                  *jargs).astype(jnp.float32))
    with torch.inference_mode(), scales_attached(conv, {"": float(a_scale)}):
        got = conv(px)
    assert got.dtype == torch.bfloat16
    assert ulps_of_scale(nhwc(got.float()), want) <= 1.0  # measured: equal
    with torch.inference_mode():
        default = nhwc(conv(px).float())
    # the reference's split input: two partial products, each rounded (item 5)
    assert ulps_of_scale(default, np.asarray(jconv.apply({"params": params}, *jargs)
                                             .astype(jnp.float32))) <= (1.0 if split is None
                                                                        else 2.0)


def test_int8_conv_bf16_epilogue_past_2_to_the_24():
    """768 input channels of saturated codes against weights of one sign: acc
    = 127 * 127 * 9 * 768 and neighbours, past float32's exact integers; the
    port's epilogue rounds as the reference's does."""
    cin, cout = 768, 4
    rng = np.random.default_rng(9)
    x = bf16_values(np.abs(rng.standard_normal((1, 4, 4, cin))) * 0.5 + 1.0)
    jconv, jargs, params, conv = _conv_case(3, cin, cout, None, 9, x)
    params["kernel"] = np.abs(params["kernel"]) + 0.01  # one sign: the sums grow
    conv.load_state_dict(module_params_from_jax(params), strict=True)
    a_scale = np.float32(1.0 / 127.0)  # every code 127
    want = np.asarray(jconv.apply({"params": params, "quant": {"a_scale": jnp.float32(a_scale)}},
                                  *jargs).astype(jnp.float32))
    with torch.inference_mode(), scales_attached(conv, {"": float(a_scale)}):
        got = nhwc(conv(nchw(x).bfloat16()).float())
    np.testing.assert_array_equal(got, want)


# --- calibration and int8 enhance in bfloat16


@pytest.fixture(scope="module")
def models():
    """(reference model in bfloat16, its parameters, the port's model in
    bfloat16 with the same weights)."""
    cfg = dict(CONFIG, dtype="bfloat16")
    jmodel = jbuild(cfg)
    params = random_params(jax.eval_shape(
        lambda: jmodel.init_params(jax.random.PRNGKey(0), (1, 32, 64))), seed=4)
    pmodel = pbuild(cfg, device="cpu")
    pmodel.load_state_dict(params_from_jax(params, target=pmodel), strict=True)
    return jmodel, params, pmodel


def _wave(n, seed):
    rng = np.random.default_rng(seed)
    x = 0.3 * np.sin(2 * np.pi * 300 * np.arange(n) / 16000) + 0.05 * rng.standard_normal(n)
    return x.astype(np.float32)


def _by_module(tree, leaf):
    out = {}
    for path, v in jax.tree_util.tree_leaves_with_path(tree):
        *mods, last = [str(getattr(k, "key", k)) for k in path]
        assert last == leaf, path
        out[module_name(mods)] = float(v)
    return out


def test_calibrate_storm_bf16_matches_reference(models):
    """Item 7: calibration along a bfloat16 trajectory with the reference's
    noise replayed: the same convs quantized, and the scales about as far
    from the reference's as bfloat16 moves the port's own: max relative
    |port bf16 - reference bf16| over a net's scales <= 2 x max relative
    |port bf16 - port float32|. An amax is a bfloat16 activation's magnitude;
    the two bfloat16 trajectories part by rounding (items 8-9 of the layer
    list), as two independent roundings would (about sqrt(2) times either's
    distance from float32), and the maxima move with them. Measured: 0.030
    against 0.030 (denoiser), 0.087 against 0.061 (score)."""
    jmodel, params, pmodel = models
    y = np.stack([_wave(1024, 0), _wave(1024, 1)])
    key = jax.random.PRNGKey(7)
    N = 3
    want = jquant.calibrate_storm(jmodel, params, jnp.asarray(y), key, N=N, min_channels=MIN_CH)
    kprior, ksamp = jax.random.split(key)
    shape = (2, 32, 128)
    draws = ([np.asarray(jcplx.complex_normal(kprior, shape))]
             + jax_noise_schedule(ksamp, shape, N, corrector="none"))
    got = {}
    for dtype in ("bfloat16", "float32"):
        model = pmodel
        if dtype == "float32":
            model = pbuild(dict(CONFIG), device="cpu")
            model.load_state_dict(pmodel.state_dict(), strict=True)
        noise = ReplayNoise(draws)
        got[dtype] = pquant.calibrate_storm(model, tt(y), N=N, min_channels=MIN_CH, noise=noise)
        assert noise.exhausted()
    for net in ("denoiser", "score"):
        w, g, g32 = _by_module(want[net], "a_scale"), got["bfloat16"][net], got["float32"][net]
        assert w.keys() == g.keys() == g32.keys() and len(w) == 41, net
        off = max(abs(g[k] - w[k]) / w[k] for k in w)
        bf16_effect = max(abs(g[k] - g32[k]) / g32[k] for k in w)
        assert off <= 2.0 * bf16_effect, (net, off, bf16_effect)


def _flax_node(tree, name):
    for p in flax_path(name):
        tree = tree[p]
    return tree


def test_int8_enhance_bf16_matches_reference_per_conv_call(models):
    """Item 6, as test_torch_quant.py holds the float32 path: an int8
    bfloat16 `enhance` with the reference's scales, and each of its 2 x 41
    quantized conv calls held to the reference's QuantizableConv in bfloat16
    on the input the port gave it, within 1 ulp of the output's scale
    (measured: equal)."""
    jmodel, params, pmodel = models
    y = _wave(700, 4)[None]
    quant = jax.tree_util.tree_map(jnp.float32, jquant.calibrate_storm(
        jmodel, params, jnp.asarray(y), jax.random.PRNGKey(1), N=2, min_channels=MIN_CH))
    pq = {net: _by_module(tree, "a_scale") for net, tree in quant.items()}
    calls = []
    hooks = [m.register_forward_hook(
        lambda mod, inp, out, net=net, name=name: calls.append((net, name, inp[0], out)))
        for net in ("denoiser", "score")
        for name, m in quantizable_convs(getattr(pmodel, f"{net}_net")).items() if name in pq[net]]
    key = jax.random.PRNGKey(5)
    try:
        noise = ReplayNoise(jax_noise_schedule(key, (1, 32, 64), 1, corrector="none"))
        got, nfe = pmodel.enhance(tt(y), N=1, corrector="none", noise=noise, quant=pq)
    finally:
        for h in hooks:
            h.remove()
    assert nfe == 2 and len(calls) == 41 * 2 and got.dtype == torch.float32
    assert np.isfinite(got.numpy()).all()
    applies = {}
    for net, name, x, out in calls:
        assert x.dtype == out.dtype == torch.bfloat16
        conv = _flax_node(params[net], name)
        k, cout = conv["kernel"].shape[0], conv["kernel"].shape[-1]
        if (k, cout) not in applies:
            applies[k, cout] = jax.jit(JConv(cout, (k, k), padding=[(k // 2, k // 2)] * 2,
                                             dtype=BF).apply)
        ref = applies[k, cout]({"params": conv, "quant": _flax_node(quant[net], name)},
                               jnp.asarray(nhwc(x.float()), BF))
        assert ulps_of_scale(nhwc(out.float()), np.asarray(ref.astype(jnp.float32))) <= 1.0, (
            net, name)


# --- the CLIs in bfloat16


def _tiny_ckpt(tmp_path, config=CONFIG, name="tiny.pt"):
    ckpt = str(tmp_path / name)
    save_checkpoint(ckpt, config, pbuild(dict(config), device="cpu").state_dict())
    return ckpt


def test_cli_int8_bf16_calibrates_and_reuses_scales_across_dtypes(tmp_path):
    """`--quant int8 --dtype bfloat16` calibrates in bfloat16 and writes the
    reference's meta keys, no dtype among them; a float32 run then loads the
    same scales, as the reference's cache would (item 7)."""
    ckpt = _tiny_ckpt(tmp_path)
    noisy, out = tmp_path / "noisy", tmp_path / "out"
    noisy.mkdir()
    for i, n in enumerate((900, 1531)):
        save_wav(str(noisy / f"{i}.wav"), _wave(n, i))
    argv = ["--test_dir", str(noisy), "--enhanced_dir", str(out), "--ckpt", ckpt, "--mode",
            "storm", "--N", "2", "--device", "cpu", "--quant", "int8", "--quant_min_channels",
            str(MIN_CH)]
    outputs = []
    for dtype, calibrates in (("bfloat16", True), ("bfloat16", False), ("float32", False)):
        printed = []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr("builtins.print", lambda *a, **k: printed.append(" ".join(map(str, a))))
            enhancement.main(argv + ["--dtype", dtype])
        text = "\n".join(printed)
        assert ("int8 calibration done (82 convs" in text) == calibrates, text
        assert ("int8 scales loaded" in text) == (not calibrates), text
        for i, n in enumerate((900, 1531)):
            x, sr = load_wav(str(out / f"{i}.wav"))
            assert sr == 16000 and x.shape == (1, n) and np.isfinite(x).all()
        outputs.append(load_wav(str(out / "0.wav"))[0])
    meta = json.load(open(scale_cache_path(ckpt)))["_meta"]
    assert set(meta) == {"params", "min_channels", "mode", "stream_chunk_s", "calib_N",
                         "params_sha256", "calib_len", "calib_files"}
    np.testing.assert_array_equal(outputs[0], outputs[1])  # the same program twice
    assert not np.array_equal(outputs[0], outputs[2])  # float32 serves otherwise


def _serve_args(ckpt, *extra):
    return serve.build_argparser().parse_args(
        ["--ckpt", ckpt, "--mode", "storm", "--N", "1", "--corrector", "none", "--port", "0",
         "--device", "cpu", *extra])


def _served(args, wave):
    """Build the server, read /healthz, enhance `wave` once; returns (health,
    the reply's waveform, the model's compute dtype)."""
    httpd, batcher = serve.build_server(args)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        conn = http.client.HTTPConnection(*httpd.server_address[:2], timeout=WAIT)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        conn.request("POST", "/enhance", body=encode_wav_bytes(wave))
        r = conn.getresponse()
        assert r.status == 200
        x, sr = decode_wav_bytes(r.read())
        conn.close()
        return health, x, batcher.enhancer.model.score_net.dtype
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
        thread.join(timeout=WAIT)


def test_serve_defaults_to_bf16_and_reports_the_dtype_served(tmp_path):
    """The server serves bfloat16 unless told otherwise, as the reference's
    does, and /healthz reports the dtype it serves: `--dtype float32`, and
    `checkpoint` following the checkpoint's config."""
    assert serve.build_argparser().parse_args(["--ckpt", "c", "--mode", "storm"]).dtype \
        == "bfloat16"
    ckpt = _tiny_ckpt(tmp_path)
    ckpt_bf16 = _tiny_ckpt(tmp_path, dict(CONFIG, dtype="bfloat16"), "tiny_bf16.pt")
    wave = _wave(900, 2)
    for args, want in ((_serve_args(ckpt), torch.bfloat16),
                       (_serve_args(ckpt, "--dtype", "float32"), torch.float32),
                       (_serve_args(ckpt, "--dtype", "checkpoint"), torch.float32),
                       (_serve_args(ckpt_bf16, "--dtype", "checkpoint"), torch.bfloat16)):
        health, x, dtype = _served(args, wave)
        assert dtype == want and health["dtype"] == str(want).split(".")[-1], health
        assert x.shape == (1, 900) and np.isfinite(x).all()


def test_serve_int8_bf16(tmp_path):
    """int8 under bfloat16 through the server: calibrated on --calib_dir,
    reported, and a request served."""
    ckpt = _tiny_ckpt(tmp_path)
    calib = tmp_path / "calib"
    calib.mkdir()
    save_wav(str(calib / "a.wav"), _wave(1024, 5))
    health, x, dtype = _served(_serve_args(ckpt, "--quant", "int8", "--quant_min_channels",
                                           str(MIN_CH), "--calib_dir", str(calib)),
                               _wave(700, 6))
    assert dtype == torch.bfloat16 and health["dtype"] == "bfloat16" and health["quant"] == "int8"
    assert x.shape == (1, 700) and np.isfinite(x).all()
    assert os.path.exists(scale_cache_path(ckpt)) and glob.glob(str(calib / "*.wav"))
