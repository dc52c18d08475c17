"""Port parity in bfloat16: the port's layers, NCSN++ and `enhance` computing
in bfloat16 against the reference's with `dtype=jnp.bfloat16`, the same
float32 weights, and the upfirdn2d kernel's plain bfloat16 version; then the
enhancement CLI's `--dtype`.

Tiny sizes (nf 16, n_fft 62). One bfloat16 ulp is 2^-7 of the leading power
of two, and each tolerance is counted in ulps of the output's scale
(torch_parity.ulps_of_scale). Where the two packages' numbers can part, each
place named by the test that pins it:

1. GroupNorm: moments and normalize in float32, one rounding (both).
2. Convs, Dense, NIN: the product rounded, then the bias added in bfloat16
   (both). The FIR taps stay float32 in the port; the reference casts them
   to x's type, which leaves NCSN++'s FIR exact.
3. Attention: logits rounded, scaled by C^-0.5 in bfloat16, softmax in
   float32, its weights rounded (both).
4. Type promotion: Python scalars rounded to bfloat16 as JAX's weak typing
   rounds them; sigma cast to bfloat16 before the division (both).
5. The up path's split_skip: the reference sums two partial convs, each
   rounded; the port convolves the concatenation once.
6-7. The int8 epilogue and calibration: tests/test_torch_bf16_quant.py.
8. SiLU: `jax.nn.silu` lowers to four bfloat16 ops (exp, add, divide,
   multiply), each rounded; the port's F.silu rounds once.
9. GroupNorm's variance: flax's E[x^2] - E[x]^2 in float32, summed in XLA's
   order, against the port's two-pass variance; where a group's mean is
   large against its spread (NCSN++'s input shift 2x - 1 makes it so in the
   first blocks) the reference's variance is off by up to ~1e-2 relative.

With items 5 and 8 put in the reference's form, every layer here agrees
with the reference's to an ulp at a few elements at most (float32 sums in
another order, item 9). Through a whole net the port and the reference are
two bfloat16 roundings of one program: a flip at item 8 or 9 in an early
block is carried to the output by bfloat16's own rounding, so the two part
by about as much as either parts from float32 (measured 0.98-1.36 of it),
not less; the whole-net tests hold that ratio to 1.5, and hold the port's
bfloat16 output to part from its float32 output by at least half as much
as the reference's does (measured 0.91-1.07), which fails if the port
computes in float32.
"""
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu
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

import storm_tpu_torch.backbones.ncsnpp as pncsnpp
from storm_tpu.backbones.ncsnpp import NCSNpp as JNCSNpp
from storm_tpu.kernels import upfirdn2d_pallas
from storm_tpu.models.factory import build_model as jbuild
from storm_tpu.nn import layers as jl
from storm_tpu.nn import resample as jres
from storm_tpu_torch import enhancement
from storm_tpu_torch.ckpt import save_checkpoint
from storm_tpu_torch.convert import module_params_from_jax, params_from_jax
from storm_tpu_torch.data.audio import load_wav, save_wav
from storm_tpu_torch.kernels import upfirdn as kup
from storm_tpu_torch.models.factory import build_model as pbuild
from storm_tpu_torch.nn import layers as pl
from storm_tpu_torch.nn.cast import cast_params

BF = jnp.bfloat16
SYM = np.outer([1, 3, 3, 1], [1, 3, 3, 1]).astype(np.float32) / 64.0
ASYM = np.random.default_rng(7).standard_normal((4, 4)).astype(np.float32)
CONFIGS = {"down": (1, 2, (1, 1)), "up": (2, 1, (2, 1))}  # NCSN++'s two
TINY = dict(nf=16, ch_mult=(1, 2, 2), init_scale=1.0)
CONFIG = {"mode": "regen-joint-training", "nf": 16, "ch_mult": [1, 2, 2],
          "init_scale": 1.0, "n_fft": 62, "hop_length": 16, "sde": "ouve"}


def _x(shape, seed, scale=1.0):
    return bf16_values(scale * np.random.default_rng(seed).standard_normal(shape))


def _jf(a):
    """A JAX bfloat16 result as float32 numpy."""
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _pb(a) -> torch.Tensor:
    """NHWC float32 numpy of bfloat16 values -> NCHW bfloat16 tensor."""
    return nchw(a).bfloat16()


def _pf(t: torch.Tensor) -> np.ndarray:
    """NCHW tensor -> NHWC float32 numpy."""
    return nhwc(t.float())


def jax_silu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.silu` as the reference computes it in bfloat16: x * (1 / (1 +
    exp(-x))), each of the four ops rounded (item 8)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def assert_bf16_close(got, want, ulps=1.0, share=0.01):
    """Within `ulps` bfloat16 ulps of the output's scale, and no more than
    `share` of the elements different at all: one float32 sum taken in
    another order than the reference's can straddle a bfloat16 rounding
    boundary."""
    assert ulps_of_scale(got, want) <= ulps
    assert np.mean(np.asarray(got) != np.asarray(want)) <= share


def _load(port_module, jax_module, *args, seed=0, **kwargs):
    """Random reference parameters for `jax_module` called on `args`, loaded
    into `port_module` too; returns (params, port_module)."""
    shapes = jax.eval_shape(jax_module.init, jax.random.PRNGKey(0), *args, **kwargs)["params"]
    params = random_params(shapes, seed)
    port_module.load_state_dict(module_params_from_jax(params), strict=True)
    return params, port_module.eval()


# --- K1's plain bfloat16 version


@pytest.mark.parametrize("W", [16, 15], ids=["even", "odd"])
@pytest.mark.parametrize("kname", ["sym", "asym"])
@pytest.mark.parametrize("cfg", ["down", "up"])
def test_upfirdn2d_plain_bf16_matches_xla(cfg, kname, W):
    """Against the reference's XLA lowering in bfloat16, which casts the taps
    to bfloat16: NCSN++'s are exact there, the asymmetric FIR is rounded to
    bfloat16 first so that both packages sum the same taps (item 2). Both
    sum 16 exact products in float32 and round once: equal, or 1 ulp apart
    where the sum's order shows."""
    up, down, pad = CONFIGS[cfg]
    k = {"sym": SYM, "asym": bf16_values(ASYM)}[kname] * (4.0 if up == 2 else 1.0)
    x = _x((2, 11, W, 6), seed=W)
    want = _jf(jres.upfirdn2d(jnp.asarray(x, BF), jnp.asarray(k), up=up, down=down, pad=pad))
    got = kup.upfirdn2d_plain(_pb(x), k, up=up, down=down, pad=pad)
    assert got.dtype == torch.bfloat16
    assert ulps_of_scale(_pf(got), want) <= 1.0
    assert np.mean(_pf(got) != want) <= 0.01  # measured: 0


@pytest.mark.parametrize("W", [16, 15], ids=["even", "odd"])
@pytest.mark.parametrize("kname", ["sym", "asym"])
@pytest.mark.parametrize("cfg", ["down", "up"])
def test_upfirdn2d_plain_bf16_matches_pallas_interpret(cfg, kname, W):
    """Against the Pallas kernel in interpret mode, which keeps float32 taps,
    sums tap by tap in float32 in the plain version's order and writes x's
    type: bit for bit with NCSN++'s FIR, whose products with bfloat16 values
    are exact; the asymmetric FIR's are not, and where XLA fuses a product
    into its sum the float32 result can differ in the last bit: within 1 ulp
    of the output's scale (measured: 1 element of 9216 at up, 2.4e-7)."""
    up, down, pad = CONFIGS[cfg]
    k = {"sym": SYM, "asym": ASYM}[kname] * (4.0 if up == 2 else 1.0)
    x = _x((2, 12, W, 6), seed=W + 1)
    with pltpu.force_tpu_interpret_mode():
        want = _jf(upfirdn2d_pallas(jnp.asarray(x, BF), jnp.asarray(k), up=up, down=down,
                                    pad=pad))
    got = _pf(kup.upfirdn2d_plain(_pb(x), k, up=up, down=down, pad=pad))
    if kname == "sym":
        np.testing.assert_array_equal(got, want)
    assert ulps_of_scale(got, want) <= 1.0 and np.mean(got != want) <= 0.01


def test_upfirdn2d_bf16_rounds_the_float32_sum_once():
    x = _x((1, 9, 13, 4), seed=3)
    for up, down, pad in CONFIGS.values():
        got = kup.upfirdn2d(_pb(x), SYM, up=up, down=down, pad=pad)  # the CPU dispatcher
        want = kup.upfirdn2d_plain(nchw(x), SYM, up=up, down=down, pad=pad).bfloat16()
        assert torch.equal(got, want)


# --- layers (items 1-5 and 8)


@pytest.mark.parametrize("form", ["plain", "split"])
def test_group_norm_bf16(form):
    """Item 1: against flax's GroupNorm and the reference's SplitGroupNorm
    (the up path's), both in bfloat16; the output is bfloat16, the scale and
    bias stay float32."""
    x = _x((2, 8, 12, 32), seed=1, scale=3.0) + 0.5
    jm = jl.group_norm(32, dtype=BF)
    params, pm = _load(pl.group_norm(32), jm, jnp.asarray(x, BF))
    if form == "plain":
        want = _jf(jm.apply({"params": params}, jnp.asarray(x, BF)))
    else:
        split = jl.SplitGroupNorm(num_groups=8, dtype=BF)
        a, b = split.apply({"params": params}, jnp.asarray(x[..., :12], BF),
                           jnp.asarray(x[..., 12:], BF))
        want = np.concatenate([_jf(a), _jf(b)], axis=-1)
    with torch.no_grad():
        got = pm(_pb(x))
    assert got.dtype == torch.bfloat16 and pm.weight.dtype == torch.float32
    assert_bf16_close(_pf(got), want)  # measured: equal
    xt = _pb(x).requires_grad_()  # under autograd: the same arithmetic
    assert torch.equal(pm(xt).detach(), got)


def test_group_norm_variance_against_flax():
    """Item 9: a group whose mean is 20 spreads; flax's E[x^2] - E[x]^2 in
    float32 loses the variance's low digits, the port's two-pass variance
    keeps them. Against the float64 result the port stays within 1 ulp; the
    reference's error is larger."""
    x = _x((2, 8, 16, 16), seed=5, scale=0.7) + 20.0
    x = bf16_values(x)
    jm = jl.group_norm(16, dtype=BF)
    params, pm = _load(pl.group_norm(16), jm, jnp.asarray(x, BF))
    want = _jf(jm.apply({"params": params}, jnp.asarray(x, BF)))
    with torch.no_grad():
        got = _pf(pm(_pb(x)))
        exact = nhwc(F.group_norm(nchw(x).double(), 4, pm.weight.double(), pm.bias.double(),
                                  pm.eps))
    assert ulps_of_scale(got, exact) <= 1.0
    assert np.abs(want - exact).max() > np.abs(got - exact).max()


@pytest.mark.parametrize("k", [3, 1])
def test_conv_bf16(k):
    """Item 2: the product rounded, then the bias (not zero) added in
    bfloat16."""
    x = _x((2, 8, 12, 32), seed=2)
    jc = (jl.conv3x3 if k == 3 else jl.conv1x1)(24, init_scale=1.0, dtype=BF)
    params, pc = _load((pl.conv3x3 if k == 3 else pl.conv1x1)(32, 24, init_scale=1.0), jc,
                       jnp.asarray(x, BF))
    want = _jf(jc.apply({"params": params}, jnp.asarray(x, BF)))
    with torch.no_grad():
        got = pc(_pb(x))
    assert got.dtype == torch.bfloat16
    assert_bf16_close(_pf(got), want)  # measured: equal


def test_dense_and_nin_bf16():
    """Item 2: flax's Dense with dtype bfloat16 and the reference's NIN on a
    bfloat16 input."""
    import flax.linen as fnn

    x = _x((3, 32), seed=3)
    jd = fnn.Dense(24, dtype=BF, param_dtype=jnp.float32)
    params, pd = _load(pl.Dense(32, 24), jd, jnp.asarray(x, BF))
    want = _jf(jd.apply({"params": params}, jnp.asarray(x, BF)))
    with torch.no_grad():
        got = pd(tt(x).bfloat16())
    assert_bf16_close(got.float().numpy(), want)  # measured: equal

    x = _x((2, 4, 6, 16), seed=4)
    jn = jl.NIN(12)
    params, pn = _load(pl.NIN(16, 12), jn, jnp.asarray(x, BF))
    with torch.no_grad():
        got = pn(_pb(x))
    assert_bf16_close(_pf(got), _jf(jn.apply({"params": params}, jnp.asarray(x, BF))))


@pytest.mark.parametrize("C", [16, 12])
def test_attn_block_bf16(C):
    """Item 3 (and 4: C^-0.5 and 1/sqrt(2) rounded to bfloat16 first; 12^-0.5
    is not exact there)."""
    x = _x((2, 4, 6, C), seed=4)
    jblk = jl.AttnBlockpp(skip_rescale=True, init_scale=1.0)
    params, pblk = _load(pl.AttnBlockpp(C, skip_rescale=True, init_scale=1.0), jblk,
                         jnp.asarray(x, BF))
    want = _jf(jblk.apply({"params": params}, jnp.asarray(x, BF)))
    with torch.no_grad():
        got = pblk(_pb(x))
    assert_bf16_close(_pf(got), want)  # measured: equal


def _resblock_case(variant, act):
    """(the port's block output, the reference's: split_skip's form and the
    concatenated one) for one BigGAN resblock in bfloat16."""
    in_ch, out_ch = {"plain": (8, 8), "plain_shortcut": (8, 16), "up": (8, 8),
                     "down": (8, 8), "skip": (8, 8)}[variant]
    kw = dict(up=variant == "up", down=variant == "down")
    x = _x((2, 8, 12, 8), 1)
    skip = _x((2, 8, 12, 8), 2) if variant == "skip" else None
    temb = _x((2, 32), 3)
    blk_in = in_ch + (8 if skip is not None else 0)
    jblk = jl.ResnetBlockBigGANpp(act=jax.nn.silu, in_ch=blk_in, out_ch=out_ch, temb_dim=32,
                                  fir=True, dropout=0.0, init_scale=1.0, **kw)
    args = (jnp.asarray(x, BF), jnp.asarray(temb, BF))
    jkw = {} if skip is None else {"skip": jnp.asarray(skip, BF)}
    params, pblk = _load(pl.ResnetBlockBigGANpp(act, blk_in, out_ch, temb_dim=32, fir=True,
                                                dropout=0.0, init_scale=1.0, **kw), jblk,
                         *args, **jkw)
    want = _jf(jblk.apply({"params": params}, *args, **jkw))
    xcat = x if skip is None else np.concatenate([x, skip], axis=-1)
    want_cat = _jf(jblk.apply({"params": params}, jnp.asarray(xcat, BF), args[1]))
    with torch.no_grad():
        got = _pf(pblk(_pb(xcat), tt(temb).bfloat16()))
    return got, want, want_cat


@pytest.mark.parametrize("variant", ["plain", "plain_shortcut", "up", "down", "skip"])
def test_resnet_block_bf16_with_the_references_silu(variant):
    """Items 1-4 through a whole block, with item 8 put in the reference's form
    (its SiLU's four roundings): the block agrees with the reference's, and
    the up path's block (skip) with the reference's block called on the
    concatenation (measured: equal but for 0.07% of the plain block's
    elements, 0.19 ulp of its scale apart: GroupNorm's float32 arithmetic,
    item 9). split_skip's form parts from it by its two partial products'
    roundings (item 5): measured 2.0 ulps of the output's scale, held to 3:
    half an ulp for each partial product and one for their sum, carried
    through GroupNorm_1 and Conv_1."""
    got, want, want_cat = _resblock_case(variant, jax_silu)
    assert_bf16_close(got, want_cat)
    if variant == "skip":
        assert 0 < ulps_of_scale(got, want) <= 3.0


@pytest.mark.parametrize("variant", ["plain", "plain_shortcut", "up", "down", "skip"])
def test_resnet_block_bf16(variant):
    """The block as the port runs it (F.silu, item 8; the concatenated conv,
    item 5): within 2 ulps of the output's scale of the reference's (the
    skip block, against split_skip's form: its own bound, 3 ulps, as above).
    Measured: 1.0, 1.0, 1.5, 2.0 and 2.0 ulps, half the elements or more
    apart (SiLU's roundings); the reference's own bfloat16 block is 0.98-1.56
    ulps from its float32 one."""
    got, want, _ = _resblock_case(variant, F.silu)
    assert ulps_of_scale(got, want) <= (3.0 if variant == "skip" else 2.0)


# --- NCSN++ and enhance (the whole-net ratio, and the "really bf16" check)

# max|port_bf16 - reference_bf16| <= RATIO * max|reference_bf16 - reference_f32|:
# two bfloat16 roundings of one program that part at items 5, 8 and 9 in
# the first blocks (see the module docstring) differ by about as much as
# either differs from float32 (independent roundings: about sqrt(2) times).
RATIO = 1.5
# max|port_bf16 - port_f32| >= REALLY * max|reference_bf16 - reference_f32|:
# fails if the port silently computes in float32
REALLY = 0.5


def _ncsnpp_case(variant):
    kw = dict(TINY)
    if variant == "denoiser":
        kw.update(input_channels=2, discriminative=True)
        cc, t = 1, np.ones(2, np.float32)
    else:
        kw.update(input_channels=6)
        cc, t = 3, np.asarray([0.04, 0.7], np.float32)
    x = (0.5 * np.random.default_rng(0).standard_normal((2, cc, 32, 64, 2))).astype(np.float32)
    shapes = jax.eval_shape(JNCSNpp.from_kwargs(**kw).init, jax.random.PRNGKey(0),
                            jnp.asarray(x), jnp.asarray(t))["params"]
    return kw, x, t, random_params(shapes, seed=1)


def _ratios(port_bf16, port_f32, ref_bf16, ref_f32):
    bf16_effect = np.abs(ref_bf16 - ref_f32).max()
    return (np.abs(port_bf16 - ref_bf16).max() / bf16_effect,
            np.abs(port_bf16 - port_f32).max() / bf16_effect)


@pytest.mark.parametrize("variant", ["score", "denoiser"])
def test_tiny_ncsnpp_bf16(variant):
    """NCSN++ in bfloat16 against the reference's: float32 out, bfloat16
    inside (the trunk ends in bfloat16: item 4's division by sigma cast to
    it), the Fourier features (float32) and the first layers (the time
    embedding's Dense on its input cast to bfloat16, the first conv) as the
    reference's, and the whole net's ratios. Measured (score, denoiser):
    port against reference 0.98, 1.15 of the reference's bfloat16 effect;
    port bfloat16 against port float32 1.07, 0.91 of it."""
    kw, x, t, params = _ncsnpp_case(variant)
    jnet = JNCSNpp.from_kwargs(**kw, dtype=BF)
    want, inter = jax.jit(lambda p, x, t: jnet.apply(
        {"params": p}, x, t, capture_intermediates=True, mutable=["intermediates"]))(
        params, jnp.asarray(x), jnp.asarray(t))
    want = np.asarray(want)
    want_f32 = np.asarray(jax.jit(JNCSNpp.from_kwargs(**kw).apply)(
        {"params": params}, jnp.asarray(x), jnp.asarray(t)))
    nets = {}
    for dtype in (torch.float32, torch.bfloat16):
        nets[dtype] = pncsnpp.NCSNpp.from_kwargs(**kw, dtype=dtype).eval()
        nets[dtype].load_state_dict(module_params_from_jax(params), strict=True)
    pnet = nets[torch.bfloat16]
    outs = {}
    with torch.no_grad():
        hooks = [m.register_forward_hook(lambda mod, i, o, n=n: outs.setdefault(n, o))
                 for n, m in enumerate(pnet.all_modules)]
        got = pnet(tt(x), tt(t))
        for h in hooks:
            h.remove()
        got_f32 = nets[torch.float32](tt(x), tt(t)).numpy()
        h_in = tt(x).permute(0, 1, 4, 2, 3).reshape(2, -1, 32, 64).bfloat16().contiguous()
        assert pnet._unet(h_in, tt(t)).dtype == torch.bfloat16
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert next(pnet.parameters()).dtype == torch.float32
    # the first modules: Fourier features (float32), the time embedding's
    # Dense layers (their input cast to bfloat16), the first conv
    first = 4 if variant == "score" else 2
    for n in range(first):
        ref = np.asarray(inter["intermediates"][f"m{n}"]["__call__"][0]).astype(np.float32)
        mine = outs[n].float().numpy()
        mine = mine if mine.ndim < 4 else nhwc(outs[n].float())
        if n == 0:  # float32 sin and cos of two libraries: the last bit
            np.testing.assert_allclose(mine, ref, rtol=2e-7, atol=1e-7)
        elif n == 2:  # the second Dense takes SiLU's output (item 8)
            assert ulps_of_scale(mine, ref) <= 1.0
        else:  # measured: equal, and 1 of 65536 elements of the first conv
            assert_bf16_close(mine, ref, share=1e-3)
    assert outs[0].dtype == torch.float32 and outs[first - 1].dtype == torch.bfloat16
    against_ref, really = _ratios(got.numpy(), got_f32, want, want_f32)
    assert against_ref <= RATIO, against_ref
    assert really >= REALLY, really


def _wave(n, seed):
    rng = np.random.default_rng(seed)
    x = 0.3 * np.sin(2 * np.pi * 300 * np.arange(n) / 16000) + 0.05 * rng.standard_normal(n)
    return x.astype(np.float32)


def test_tiny_enhance_bf16():
    """`enhance` at N=3 with the ald corrector and the reference's noise
    replayed, bfloat16 against the reference's make_enhance in bfloat16:
    float32 out, the ratios as for NCSN++. Measured: port against reference
    1.36 of the reference's bfloat16 effect, port bfloat16 against port
    float32 1.01 of it."""
    N, T = 3, 700
    jmodel = jbuild(dict(CONFIG))
    params = random_params(jax.eval_shape(
        lambda: jmodel.init_params(jax.random.PRNGKey(0), (1, 32, 64))), seed=2)
    y = _wave(T, 0)[None]
    key = jax.random.PRNGKey(5)
    runs = {}
    for dtype in ("float32", "bfloat16"):
        want, _ = jbuild(dict(CONFIG, dtype=dtype)).make_enhance(N=N, corrector="ald")(
            params, jnp.asarray(y), key)
        pmodel = pbuild(dict(CONFIG, dtype=dtype), device="cpu")
        pmodel.load_state_dict(params_from_jax(params, target=pmodel), strict=True)
        noise = ReplayNoise(jax_noise_schedule(key, (1, 32, 64), N, corrector="ald"))
        got, nfe = pmodel.enhance(tt(y), N=N, corrector="ald", noise=noise)
        assert noise.exhausted() and nfe == 1 + 2 * N
        assert got.dtype == torch.float32 and got.shape == (1, T)
        runs[dtype] = (got.numpy(), np.asarray(want))
    against_ref, really = _ratios(runs["bfloat16"][0], runs["float32"][0], runs["bfloat16"][1],
                                  runs["float32"][1])
    assert against_ref <= RATIO, against_ref
    assert really >= REALLY, really


def test_cast_params_casts_once_and_restores():
    """`enhance` reads bfloat16 copies made once per call: inside
    `cast_params` every cast-parameter module holds them, GroupNorm keeps
    float32, and afterwards the copies are gone."""
    model = pbuild(dict(CONFIG, dtype="bfloat16"), device="cpu")
    net = model.score_net
    with cast_params(net, torch.bfloat16):
        casts = [m for m in net.modules() if "_cast" in m.__dict__]
        assert casts and all(t.dtype == torch.bfloat16 for m in casts for t in m._cast.values())
        assert not any(isinstance(m, pl.GroupNorm) for m in casts)
        conv = net.all_modules[4].Conv_1  # 16 -> 16 channels, 3 x 3
        with torch.no_grad():
            x = torch.randn(1, 16, 8, 8).bfloat16()
            assert torch.equal(conv(x), torch.nn.functional.conv2d(
                x, conv.weight.bfloat16(), None, padding=1) + conv.bias.bfloat16()[:, None, None])
    assert not any("_cast" in m.__dict__ for m in net.modules())
    with cast_params(net, torch.float32):
        assert not any("_cast" in m.__dict__ for m in net.modules())


def test_factory_dtypes():
    for dtype, want in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        model = pbuild(dict(CONFIG, dtype=dtype), device="cpu")
        assert model.denoiser_net.dtype == model.score_net.dtype == want
        assert {p.dtype for p in model.parameters()} == {torch.float32}
    with pytest.raises(NotImplementedError, match="float16"):
        pbuild(dict(CONFIG, dtype="float16"), device="cpu")


# --- the enhancement CLI's --dtype


def _cli(tmp_path, config, *extra):
    ckpt = str(tmp_path / "tiny.pt")
    save_checkpoint(ckpt, config, pbuild(dict(config), device="cpu").state_dict())
    noisy, out = tmp_path / "noisy", tmp_path / "out"
    noisy.mkdir(exist_ok=True)
    save_wav(str(noisy / "a.wav"), _wave(900, 1))
    seen = []
    original = pbuild

    def build(cfg, *a, **k):
        model = original(cfg, *a, **k)
        seen.append(model.score_net.dtype)
        return model

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(enhancement, "build_model", build)
        enhancement.main(["--test_dir", str(noisy), "--enhanced_dir", str(out), "--ckpt", ckpt,
                          "--mode", "storm", "--N", "2", "--device", "cpu", *extra])
    x, sr = load_wav(str(out / "a.wav"))
    assert sr == 16000 and x.shape == (1, 900) and np.isfinite(x).all()
    assert sorted(os.path.basename(p) for p in glob.glob(str(out / "*.wav"))) == ["a.wav"]
    return seen, x


def test_cli_dtype(tmp_path):
    """`--dtype bfloat16` serves a float32 checkpoint in bfloat16; `checkpoint`
    (the default) follows the checkpoint's config, both ways."""
    assert enhancement.parse_args(["--test_dir", "a", "--enhanced_dir", "b", "--ckpt", "c",
                                   "--mode", "storm"]).dtype == "checkpoint"
    seen, x_bf16 = _cli(tmp_path, CONFIG, "--dtype", "bfloat16")
    assert seen == [torch.bfloat16]
    seen, x_f32 = _cli(tmp_path, CONFIG)
    assert seen == [torch.float32] and not np.array_equal(x_bf16, x_f32)
    seen, x_ckpt = _cli(tmp_path, dict(CONFIG, dtype="bfloat16"))
    assert seen == [torch.bfloat16]
    np.testing.assert_array_equal(x_ckpt, x_bf16)  # the same weights, noise and dtype
    seen, _ = _cli(tmp_path, dict(CONFIG, dtype="bfloat16"), "--dtype", "float32")
    assert seen == [torch.float32]
