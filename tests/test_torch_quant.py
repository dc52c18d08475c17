"""The int8 W8A8 serving path against the reference: the activation quantizer
(K3) against the probe's Pallas kernel in interpret mode, the quantizable conv
against storm_tpu.nn.qconv, scale trees and files, calibration along a
sampling trajectory with replayed noise, an int8 `enhance`, and the CLI.

Tiny sizes: convs of 16-32 channels, StoRM with nf 16, n_fft 62, and the
quantization threshold lowered to 8 channels. Tolerances: int8 codes exact
(the same float32 product, rounded half to even); amax 1e-6 relative for one
conv; through whole nets 1e-5 against the port's own float64 run and 1e-4
against the reference, whose float32 GroupNorm is ~3e-5 off float64 there;
int8 conv outputs 1e-5 of their scale (the same integer sums, one float32
epilogue), at every quantized conv call of an int8 `enhance`; the int8
`enhance` end to end within the int8 path's own effect, since float32
rounding flips codes at .5 ties and the flips grow (shown call by call).
"""
import copy
import glob
import json
import os
from unittest import mock

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu
from torch_parity import (
    ReplayNoise,
    assert_close_rel,
    jax_noise_schedule,
    nchw,
    nhwc,
    perturb_tree,
    to_numpy_tree,
    tt,
)

from storm_tpu.models import quant as jquant
from storm_tpu.models.base import normalize_wav as jnormalize_wav
from storm_tpu.models.base import prepare_spec as jprepare_spec
from storm_tpu.models.factory import build_model as jbuild
from storm_tpu.nn.qconv import QuantizableConv as JConv
from storm_tpu.signal import cplx as jcplx
from storm_tpu_torch import enhancement
from storm_tpu_torch.ckpt import save_checkpoint
from storm_tpu_torch.convert import flax_path, module_name, module_params_from_jax, params_from_jax
from storm_tpu_torch.data.audio import load_wav, save_wav
from storm_tpu_torch.kernels.quant import quantize_int8, quantize_int8_plain
from storm_tpu_torch.kernels.upfirdn import upfirdn2d_plain
from storm_tpu_torch.models import quant as pquant
from storm_tpu_torch.models.base import normalize_wav, prepare_spec
from storm_tpu_torch.models.factory import build_model as pbuild
from storm_tpu_torch.nn import resample
from storm_tpu_torch.nn.layers import conv1x1, conv3x3
from storm_tpu_torch.nn.qconv import (
    activation_inverse,
    conv2d_int8,
    quantizable_convs,
    quantize_weight,
    scales_attached,
    stats_collected,
    weight_columns,
)
from storm_tpu_torch.utils.serving import params_digest, scale_cache_path

CONFIG = {"mode": "regen-joint-training", "nf": 16, "ch_mult": [1, 2, 2],
          "init_scale": 1.0, "n_fft": 62, "hop_length": 16, "sde": "ouve"}
MIN_CH = 8
# amax through whole nets, port against reference: the reference's own
# float32 error against float64 reaches ~3e-5 (see the scale-tree test)
AMAX_RTOL = 1e-4
TILE = 1024  # the probe's row tile


# --- (a) K3: the quantizer against the probe's kernel and qconv's expression


def _probe_quantize(x, s):
    """`qkernel` of scripts/perf_fusion_probe.py, its grid of rows // TILE
    row blocks, with the constant 12.7 made a parameter."""
    rows, C = x.shape

    def qkernel(x_ref, o_ref):
        v = x_ref[:].astype(jnp.float32) * s
        o_ref[:] = jnp.clip(jnp.round(v), -127.0, 127.0).astype(jnp.int8)

    with pltpu.force_tpu_interpret_mode():
        qcall = pl.pallas_call(
            qkernel,
            out_shape=jax.ShapeDtypeStruct((rows, C), jnp.int8),
            grid=(rows // TILE,),
            in_specs=[pl.BlockSpec((TILE, C), lambda i: (i, 0), memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec((TILE, C), lambda i: (i, 0), memory_space=pltpu.VMEM),
        )
        return np.asarray(qcall(x))


def _qconv_quantize(x, a_scale):
    """The activation quantizer of storm_tpu/nn/qconv.py `_int8_conv` (float32)."""
    a_scale = jnp.asarray(a_scale, jnp.float32)
    inv = jnp.asarray(1.0, jnp.float32) / jnp.maximum(a_scale, 1e-20)
    return np.asarray(jnp.clip(jnp.round(x.astype(jnp.float32) * inv), -127.0, 127.0)
                      .astype(jnp.int8))


def _quant_inputs(rows, C, s, seed):
    """Values that land on exact .5 ties under a power-of-two scale, beyond
    +-127 after scaling, and ordinary normals."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, C)).astype(np.float32) * (60.0 / s)
    ties = (rng.integers(-130, 130, size=rows * C // 4) + 0.5).astype(np.float32)
    x.reshape(-1)[: ties.size] = ties / np.float32(s)
    x.reshape(-1)[-8:] = np.array([1e4, -1e4, 127.5, -127.5, 126.5, -126.5, 0.5, -0.5],
                                  np.float32) / np.float32(s)
    return x


def _bf16_pair(x):
    """The same bfloat16 values as a JAX array and a torch tensor."""
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16))
    return jnp.asarray(xb), torch.from_numpy(xb.view(np.int16).copy()).view(torch.bfloat16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [12.7, 2.0, 0.25], ids=["probe", "two", "quarter"])
def test_quantizer_codes_equal_the_probe_kernel(s, dtype):
    x = _quant_inputs(2 * TILE, 128, s, seed=int(s * 100))
    jx, px = (jnp.asarray(x), tt(x)) if dtype == "float32" else _bf16_pair(x)
    want = _probe_quantize(jx, s)
    got = quantize_int8_plain(px, s).numpy()
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(quantize_int8(px, s).numpy(), want)  # the CPU dispatcher
    if s != 12.7:  # qconv multiplies by inv = 1 / a_scale; exact for these powers of two
        np.testing.assert_array_equal(got, _qconv_quantize(jx, 1.0 / s))
    if s == 2.0:  # ties went to even, and both ends saturated
        assert {-127, 127} <= set(np.unique(got).tolist())


@pytest.mark.parametrize("a_scale", [0.0371, 1.3e-3, 0.0])
def test_quantizer_with_an_activation_scale_equals_qconv(a_scale):
    x = _quant_inputs(64, 24, 1.0 / max(a_scale, 1e-3), seed=3)
    got = quantize_int8_plain(tt(x), activation_inverse(a_scale)).numpy()
    np.testing.assert_array_equal(got, _qconv_quantize(jnp.asarray(x), a_scale))


def test_quantizer_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        quantize_int8(x.double(), 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        quantize_int8(x.t(), 1.0)


# --- (b) the quantizable conv against storm_tpu.nn.qconv.QuantizableConv


def _jax_weight_codes(kernel):
    """Weight codes and scales as `_int8_conv` computes them (qconv.py:133-136)."""
    kf = kernel.astype(jnp.float32)
    w_amax = jnp.max(jnp.abs(kf), axis=(0, 1, 2), keepdims=True)
    w_scale = jnp.maximum(w_amax, 1e-20) / 127.0
    return np.asarray(jnp.clip(jnp.round(kf / w_scale), -127.0, 127.0).astype(jnp.int8))


@pytest.mark.parametrize("split", [None, (24, 8)], ids=["single", "split"])
@pytest.mark.parametrize("k", [3, 1])
def test_quantizable_conv_matches_reference(k, split):
    cin, cout = 32, 16
    rng = np.random.default_rng(k + (0 if split is None else 10))
    x = rng.standard_normal((2, 6, 10, cin)).astype(np.float32) * 1.7
    parts = [x] if split is None else [x[..., :split[0]], x[..., split[0]:]]
    jconv = JConv(cout, (k, k), padding=[(k // 2, k // 2)] * 2)
    jparams = jconv.init(jax.random.PRNGKey(k), *[jnp.asarray(p) for p in parts])["params"]
    params = perturb_tree(to_numpy_tree(jparams), seed=k)
    conv = (conv3x3 if k == 3 else conv1x1)(cin, cout)
    conv.load_state_dict(module_params_from_jax(params), strict=True)
    jargs = [jnp.asarray(p) for p in parts]
    px = torch.cat([nchw(p) for p in parts], dim=1)  # the port's concatenated input

    # calibration: amax of the (virtual) concatenation
    _, jstats = jconv.apply({"params": params}, *jargs, mutable=["quant_stats"])
    with torch.inference_mode(), stats_collected(conv) as stats:
        conv(px)
    want_amax = float(jstats["quant_stats"]["amax"])
    assert abs(stats[""].item() - want_amax) <= 1e-6 * want_amax

    # weight codes, exactly; columns ordered (i*k + j)*C + c
    codes, w_scale = quantize_weight(conv.weight)
    np.testing.assert_array_equal(codes.numpy().transpose(2, 3, 1, 0),
                                  _jax_weight_codes(jnp.asarray(params["kernel"])))
    np.testing.assert_array_equal(weight_columns(codes).numpy(),
                                  codes.permute(0, 2, 3, 1).reshape(cout, -1).t().numpy())

    # the int8 path
    a_scale = np.float32(want_amax) / np.float32(127.0)
    want = np.asarray(jconv.apply({"params": params, "quant": {"a_scale": jnp.float32(a_scale)}},
                                  *jargs))
    with torch.inference_mode(), scales_attached(conv, {"": float(a_scale)}):
        got = nhwc(conv(px))
    assert conv.a_scale is None  # detached after the block
    assert_close_rel(got, want, 1e-5, f"int8 conv k={k} split={split}")
    with torch.inference_mode():  # and the default path is float32 again
        f32 = nhwc(conv(px))
    assert_close_rel(f32, np.asarray(jconv.apply({"params": params}, *jargs)), 1e-5, "f32")


def test_int8_conv_is_exact():
    """The im2col product equals the integer conv computed in float64."""
    rng = np.random.default_rng(5)
    xq = torch.from_numpy(rng.integers(-127, 128, (2, 24, 5, 7), dtype=np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (16, 24, 3, 3), dtype=np.int8))
    got = conv2d_int8(xq, weight_columns(wq), 3, 1)
    want = torch.nn.functional.conv2d(xq.double(), wq.double(), padding=1)
    assert got.dtype == torch.int32
    assert torch.equal(got.double(), want)


def test_scales_for_unknown_modules_raise():
    conv = conv3x3(16, 16)
    with pytest.raises(KeyError, match="no quantizable conv"):
        with scales_attached(conv, {"Conv_9": 0.1}):
            pass


# --- (c)-(e): trees, files, calibration and enhance with the whole model


def _wave(n, seed):
    rng = np.random.default_rng(seed)
    x = 0.3 * np.sin(2 * np.pi * 300 * np.arange(n) / 16000) + 0.05 * rng.standard_normal(n)
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def models():
    jmodel = jbuild(dict(CONFIG))
    jparams = jmodel.init_params(jax.random.PRNGKey(0), (1, 32, 64))
    params = {k: perturb_tree(to_numpy_tree(v), seed=i) for i, (k, v) in enumerate(jparams.items())}
    pmodel = pbuild(dict(CONFIG), device="cpu")
    pmodel.load_state_dict(params_from_jax(params, target=pmodel), strict=True)
    return jmodel, params, pmodel


def _by_module(tree, leaf):
    """A reference tree nested by flax module path, `leaf` under each module
    -> {the port's module name: value as a Python float}."""
    out = {}
    for path, v in jax.tree_util.tree_leaves_with_path(tree):
        *mods, last = [str(getattr(k, "key", k)) for k in path]
        assert last == leaf, path
        out[module_name(mods)] = float(v)
    return out


def test_scales_from_stats_and_files_match_reference(models, tmp_path):
    jmodel, params, pmodel = models
    Y = np.random.default_rng(0).standard_normal((1, 32, 64, 2)).astype(np.float32) * 0.5
    _, jstats = jmodel.forward_denoiser(params, jnp.asarray(Y), collect_stats=True)
    with torch.inference_mode():
        _, pstats = pmodel.forward_denoiser(tt(Y), collect_stats=True)
    jl, pl_ = _by_module(jstats, "amax"), {k: v.item() for k, v in pstats.items()}
    assert jl.keys() == pl_.keys() and len(jl) > 41  # every conv3x3 / conv1x1 ran
    # the port in float64 (plain upfirdn2d): the port's float32 amax is within
    # 1e-5 of it; the reference's float32 amax is up to ~3e-5 away from it
    # (GroupNorm's E[x^2] - E[x]^2 variance), so the two packages meet at AMAX_RTOL
    with torch.inference_mode(), mock.patch.object(resample, "upfirdn2d", upfirdn2d_plain):
        _, dstats = copy.deepcopy(pmodel).double().forward_denoiser(tt(Y).double(),
                                                                     collect_stats=True)
    for k, v in dstats.items():
        assert abs(pl_[k] - v.item()) <= 1e-5 * v.item(), k
        assert abs(pl_[k] - jl[k]) <= AMAX_RTOL * jl[k], k

    # the same statistics give the same scales, exactly
    same = {k: torch.tensor(np.float32(v)) for k, v in jl.items()}
    for min_ch in (MIN_CH, 32, 128):
        want = jquant.scales_from_stats(jstats, params["denoiser"], min_ch)
        got = pquant.scales_from_stats(same, pmodel.denoiser_net, min_ch)
        if want is None:
            assert got is None
            continue
        assert _by_module(want, "a_scale") == got
        assert pquant.num_quantized_convs(got) == jquant.num_quantized_convs(want)
    assert pquant.scales_from_stats(same, pmodel.denoiser_net, 128) is None  # nf 16: none

    quant = pquant.scales_from_stats(same, pmodel.denoiser_net, MIN_CH)
    meta = {"params": "ema", "min_channels": MIN_CH, "mode": "storm", "stream_chunk_s": 0.0,
            "calib_N": 3}
    # port -> reference
    pquant.save_scales(str(tmp_path / "p.json"), {"denoiser": quant, "score": None}, meta)
    jtree, jmeta = jquant.load_scales_with_meta(str(tmp_path / "p.json"))
    assert jmeta == meta and set(jtree) == {"denoiser"}
    assert _by_module(jtree["denoiser"], "a_scale") == quant
    # reference -> port
    jquant.save_scales(str(tmp_path / "j.json"), jtree, meta)
    ptree, pmeta = pquant.load_scales_with_meta(str(tmp_path / "j.json"))
    assert pmeta == meta and ptree == {"denoiser": quant}
    assert json.load(open(tmp_path / "j.json")) == json.load(open(tmp_path / "p.json"))
    # the older format (a bare flat map) has no meta; a file without scales gives None
    (tmp_path / "old.json").write_text(json.dumps({"denoiser/m4/Conv_0/a_scale": 0.5}))
    assert pquant.load_scales_with_meta(str(tmp_path / "old.json")) == (
        {"denoiser": {"all_modules.4.Conv_0": 0.5}}, None)
    pquant.save_scales(str(tmp_path / "none.json"), None, meta)
    assert pquant.load_scales_with_meta(str(tmp_path / "none.json")) == (None, meta)
    # a key that names no StoRM net is refused, not served
    (tmp_path / "one_net.json").write_text(json.dumps({"m4/Conv_0/a_scale": 0.5}))
    with pytest.raises(ValueError, match="not <net>/<module path>/a_scale"):
        pquant.load_scales(str(tmp_path / "one_net.json"))


def _calibrate_both(models, y, N, key):
    jmodel, params, pmodel = models
    want = jquant.calibrate_storm(jmodel, params, jnp.asarray(y), key, N=N, min_channels=MIN_CH)
    kprior, ksamp = jax.random.split(key)
    frames = y.shape[-1] // 16 + 1  # centred STFT frames at hop 16
    shape = (y.shape[0], 32, -(-frames // 64) * 64)
    draws = [np.asarray(jcplx.complex_normal(kprior, shape))]
    draws += jax_noise_schedule(ksamp, shape, N, corrector="none")
    noise = ReplayNoise(draws)
    got = pquant.calibrate_storm(pmodel, tt(y), N=N, min_channels=MIN_CH, noise=noise)
    assert noise.exhausted()
    return want, got


def test_calibrate_storm_matches_reference(models):
    y = np.stack([_wave(1024, 0), _wave(1024, 1)])  # two files, one 64-hop multiple
    want, got = _calibrate_both(models, y, N=3, key=jax.random.PRNGKey(7))
    for net in ("denoiser", "score"):
        w, g = _by_module(want[net], "a_scale"), got[net]
        assert w.keys() == g.keys(), net  # the same convs are quantized
        assert len(w) == 41 == pquant.num_quantized_convs(g)
        for k in w:
            assert abs(g[k] - w[k]) <= AMAX_RTOL * w[k], (net, k, g[k], w[k])


def _flax_node(tree, name):
    for p in flax_path(name):
        tree = tree[p]
    return tree


@pytest.fixture(scope="module")
def int8_case(models):
    """(y, the reference's scale trees, the same scales by module name),
    calibrated by the reference on y at N = 3."""
    jmodel, params, _ = models
    y = _wave(700, 4)[None]
    quant = jax.tree_util.tree_map(
        jnp.float32, jquant.calibrate_storm(jmodel, params, jnp.asarray(y), jax.random.PRNGKey(1),
                                            N=3, min_channels=MIN_CH))
    return y, quant, {net: _by_module(tree, "a_scale") for net, tree in quant.items()}


def _recorded_calls(net_modules):
    """Forward hooks on the named convs of {net: (module, names)}: returns
    (the list they append (net, name, input, output) to, the handles)."""
    calls = []
    hooks = [m.register_forward_hook(
        lambda mod, inp, out, net=net, name=name: calls.append((net, name, inp[0], out)))
        for net, (module, names) in net_modules.items()
        for name, m in quantizable_convs(module).items() if name in names]
    return calls, hooks


def test_int8_enhance_matches_reference(models, int8_case):
    """An int8 `enhance` with the reference's scales and noise.

    Each of the run's 7 x 41 quantized conv calls is held to the reference's
    `QuantizableConv` on the input the port gave it (1e-5 of its output's
    scale): the same codes, integer sums and epilogue at every call. End to
    end the two packages cannot meet closer than the int8 path's own
    sensitivity: test_int8_differences_start_at_rounding_ties shows a
    float32-rounding difference flipping a few codes at exact .5 ties in
    the first quantized conv, and those flips growing through every later
    one. So the port's int8 output is held to be no farther from the
    reference's int8 output than int8 is from float32 (measured here: 0.72
    of it), and the float32 run of the same path to 1e-4 as in
    test_torch_storm."""
    jmodel, params, pmodel = models
    y, quant, pq = int8_case
    N = 3
    key = jax.random.PRNGKey(5)
    want, _ = jmodel.make_enhance(N=N, corrector="ald", quant=quant)(params, jnp.asarray(y), key)
    want_f32, _ = jmodel.make_enhance(N=N, corrector="ald")(params, jnp.asarray(y), key)

    calls, hooks = _recorded_calls({net: (getattr(pmodel, f"{net}_net"), pq[net])
                                    for net in ("denoiser", "score")})
    try:
        noise = ReplayNoise(jax_noise_schedule(key, (1, 32, 64), N, corrector="ald"))
        got, nfe = pmodel.enhance(tt(y), N=N, corrector="ald", noise=noise, quant=pq)
    finally:
        for h in hooks:
            h.remove()
    assert noise.exhausted() and nfe == 1 + 2 * N
    assert len(calls) == 41 * nfe  # 41 quantized convs per forward of each net
    jconvs = {}
    for net, name, x, out in calls:
        conv = _flax_node(params[net], name)
        k, cout = conv["kernel"].shape[0], conv["kernel"].shape[-1]
        if (k, cout) not in jconvs:
            jconvs[k, cout] = JConv(cout, (k, k), padding=[(k // 2, k // 2)] * 2)
        ref = jconvs[k, cout].apply({"params": conv, "quant": _flax_node(quant[net], name)},
                                    jnp.asarray(nhwc(x)))
        assert_close_rel(nhwc(out), np.asarray(ref), 1e-5, f"{net} {name}")

    want, want_f32, got = np.asarray(want), np.asarray(want_f32), got.numpy()
    int8_effect = np.abs(want - want_f32).max()
    err = np.abs(got - want).max()
    assert 0 < err <= int8_effect, (err, int8_effect)
    noise = ReplayNoise(jax_noise_schedule(key, (1, 32, 64), N, corrector="ald"))
    got_f32, _ = pmodel.enhance(tt(y), N=N, corrector="ald", noise=noise)
    assert_close_rel(got_f32.numpy(), want_f32, 1e-4, "the same run in float32")


def test_int8_differences_start_at_rounding_ties(models, int8_case):
    """Where the int8 runs of the two packages part: the denoiser's forward
    on the same waveform, the reference's compiled forward with every
    quantized conv's input sent out by a debug callback. The first quantized conv's inputs differ by
    float32 rounding only (<= 1e-2 of a quantization step); the codes that
    differ there are a handful, each by 1, each at a value within that
    difference of an exact .5 tie. No later call's input differs by more than
    rounding unless an earlier call flipped a code: the differences grow
    from those tie flips. On this model: 3 of 32768 codes flip at the first
    conv, whose inputs differ by 2.8e-3 of a step; the next conv's inputs
    differ by 0.49 of a step (50 flips), the last ones' by several steps."""
    jmodel, params, pmodel = models
    y, quant, pq = int8_case
    ref = []  # (module name, input, a_scale) of every quantized conv call

    def record(next_fun, args, kwargs, context):
        m = context.module
        if (isinstance(m, JConv) and context.method_name == "__call__"
                and m.has_variable("quant", "a_scale")):
            parts = [v for v in args[:2] if v is not None]
            jax.debug.callback(
                lambda x, s, name=module_name(m.scope.path): ref.append(
                    (name, np.asarray(x), float(s))),
                jnp.concatenate(parts, -1), m.get_variable("quant", "a_scale"), ordered=True)
        return next_fun(*args, **kwargs)

    @jax.jit
    def denoise(params, y):
        Y = jprepare_spec(jnormalize_wav(y)[0], jmodel.stft_config, jmodel.transform)[0]
        return jmodel.forward_denoiser(params, Y, quant=quant["denoiser"])

    with fnn.intercept_methods(record):
        jax.block_until_ready(denoise(params, jnp.asarray(y)))
    jax.effects_barrier()

    calls, hooks = _recorded_calls({"denoiser": (pmodel.denoiser_net, pq["denoiser"])})
    try:
        with torch.inference_mode(), scales_attached(pmodel.denoiser_net, pq["denoiser"]):
            pY = prepare_spec(normalize_wav(tt(y))[0], pmodel.stft_config, pmodel.transform)[0]
            pmodel.forward_denoiser(pY)
    finally:
        for h in hooks:
            h.remove()
    assert [c[1] for c in calls] == [r[0] for r in ref] and len(ref) == 41

    flipped_before, steps = False, []
    for i, ((_, name, x, _), (_, xj, a_scale)) in enumerate(zip(calls, ref)):
        inv = np.float32(activation_inverse(a_scale))
        vp, vj = nhwc(x) * inv, xj * inv  # in quantization steps
        cp, cj = (np.clip(np.round(v), -127, 127) for v in (vp, vj))
        step = float(np.abs(vp - vj).max())
        flips = cp != cj
        if i == 0:
            assert step <= 1e-2, step
            assert flips.sum() <= 1e-3 * flips.size, int(flips.sum())
            assert (np.abs(cp - cj)[flips] == 1).all()
            assert (np.abs(np.abs(vj - np.floor(vj)) - 0.5)[flips] <= step).all()
        elif step > 1e-2:  # grown past rounding: only after a flip upstream
            assert flipped_before, (i, name, step)
        flipped_before |= bool(flips.any())
        steps.append(step)
    assert flipped_before and max(steps) > 1.0, steps  # the cascade is what we see


def test_pc_sample_trajectory_matches_reference(models):
    from storm_tpu.sampling.samplers import pc_sample as jpc
    from storm_tpu.sde.sdes import OUVESDE as JSDE
    from storm_tpu_torch.sampling.samplers import pc_sample as ppc
    from storm_tpu_torch.sde.sdes import OUVESDE as PSDE

    rng = np.random.default_rng(2)
    y = rng.standard_normal((2, 4, 6, 2)).astype(np.float32)
    key = jax.random.PRNGKey(3)

    def jscore(x, t, y_):
        return -x * t[:, None, None, None]

    x, traj, nfe = jpc(key, JSDE(), jscore, jnp.asarray(y), corrector="none", N=4,
                       intermediate=True)
    noise = ReplayNoise(jax_noise_schedule(key, (2, 4, 6), 4, corrector="none"))
    px, ptraj, pnfe = ppc(PSDE(), lambda x_, t, y_: -x_ * t[:, None, None, None], tt(y),
                          corrector="none", N=4, noise=noise, intermediate=True)
    assert pnfe == nfe == 4 and ptraj.shape == traj.shape == (4, 2, 4, 6, 2)
    assert_close_rel(ptraj.numpy(), np.asarray(traj), 1e-5, "trajectory")
    assert torch.equal(ptraj[-1], px)


# --- (f) the CLI


def test_cli_int8_calibrates_then_reuses_the_cache(tmp_path, capsys):
    model = pbuild(dict(CONFIG), device="cpu")
    ckpt = str(tmp_path / "tiny.pt")
    save_checkpoint(ckpt, CONFIG, model.state_dict())
    noisy, out = tmp_path / "noisy", tmp_path / "out"
    noisy.mkdir()
    lengths = {"a.wav": 900, "b.wav": 1531}
    for name, n in lengths.items():
        save_wav(str(noisy / name), _wave(n, n))
    argv = ["--test_dir", str(noisy), "--enhanced_dir", str(out), "--ckpt", ckpt, "--mode",
            "storm", "--N", "2", "--device", "cpu", "--quant", "int8",
            "--quant_min_channels", str(MIN_CH)]
    enhancement.main(argv)
    first = capsys.readouterr().out
    cache = scale_cache_path(ckpt)
    assert cache == ckpt + ".quant_int8_scales.json" and os.path.exists(cache)
    assert "int8 calibration done (82 convs quantized" in first
    payload = json.load(open(cache))
    assert payload["_meta"] == {"params": "ema", "min_channels": MIN_CH, "mode": "storm",
                                "stream_chunk_s": 0.0, "calib_N": 2,
                                "params_sha256": params_digest(model), "calib_len": 2048,
                                "calib_files": 2}
    assert all(k.split("/")[0] in ("denoiser", "score") and k.endswith("/a_scale")
               for k in payload["scales"])
    outputs = {}
    for name, n in lengths.items():
        x, sr = load_wav(str(out / name))
        assert sr == 16000 and x.shape == (1, n) and np.isfinite(x).all()
        outputs[name] = x

    enhancement.main(argv)  # the second run loads the scales and serves the same
    second = capsys.readouterr().out
    assert f"int8 scales loaded from {cache} (82 convs quantized" in second
    assert "calibration done" not in second
    for name in lengths:
        np.testing.assert_array_equal(load_wav(str(out / name))[0], outputs[name])

    enhancement.main(argv[:-1] + ["16"])  # another threshold: recalibrate
    third = capsys.readouterr().out
    assert "config mismatch" in third and "calibration done" in third
    assert sorted(os.path.basename(p) for p in glob.glob(str(out / "*.wav"))) == sorted(lengths)


def test_cli_int8_recalibrates_for_new_weights(tmp_path, capsys):
    """A checkpoint written anew at the same path (as training rewrites
    last.pt and best_loss.pt) does not meet the scales of the old one."""
    ckpt = str(tmp_path / "last.pt")
    noisy, out = tmp_path / "noisy", tmp_path / "out"
    noisy.mkdir()
    save_wav(str(noisy / "a.wav"), _wave(900, 9))
    argv = ["--test_dir", str(noisy), "--enhanced_dir", str(out), "--ckpt", ckpt, "--mode",
            "storm", "--N", "2", "--device", "cpu", "--quant", "int8",
            "--quant_min_channels", str(MIN_CH)]
    said, digests = [], []
    for seed in (0, 1, 1):  # new weights at the same path, then the same again
        model = pbuild(dict(CONFIG), device="cpu", seed=seed)
        save_checkpoint(ckpt, CONFIG, model.state_dict())
        enhancement.main(argv)
        said.append(capsys.readouterr().out)
        digests.append(json.load(open(scale_cache_path(ckpt)))["_meta"]["params_sha256"])
        assert digests[-1] == params_digest(model)
    assert "int8 calibration done" in said[0]
    assert "config mismatch" in said[1] and "int8 calibration done" in said[1]
    assert "int8 scales loaded" in said[2] and "calibration" not in said[2]
    assert digests[0] != digests[1] == digests[2]
