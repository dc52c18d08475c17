"""Port parity: NCSN++ layers against storm_tpu.nn.layers with the same weights.

Weights come from the reference's `init` (biases and norm scales perturbed)
and pass through the port's converter. Tolerance 1e-4 relative to the
output's scale: GroupNorm variance formulas and conv summation order differ.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.nn.functional as F
from torch_parity import assert_close_rel, nchw, nhwc, perturb_tree, to_numpy_tree, tt

from storm_tpu.nn import layers as jl
from storm_tpu_torch.convert import module_params_from_jax
from storm_tpu_torch.nn import layers as pl


def _load(port_module, jax_params, seed=0):
    params = perturb_tree(to_numpy_tree(jax_params), seed)
    port_module.load_state_dict(module_params_from_jax(params), strict=True)
    return params, port_module.eval()


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("variant", ["plain", "plain_shortcut", "up", "down", "skip"])
def test_resnet_block_biggan(variant):
    in_ch, out_ch = {"plain": (8, 8), "plain_shortcut": (8, 16), "up": (8, 8),
                     "down": (8, 8), "skip": (8, 8)}[variant]
    kw = dict(up=variant == "up", down=variant == "down")
    x = _x((2, 8, 12, 8), 1)
    skip = _x((2, 8, 12, 8), 2) if variant == "skip" else None
    temb = _x((2, 32), 3)
    blk_in = in_ch + (8 if skip is not None else 0)
    jblk = jl.ResnetBlockBigGANpp(act=jax.nn.silu, in_ch=blk_in, out_ch=out_ch,
                                  temb_dim=32, fir=True, dropout=0.0, init_scale=1.0, **kw)
    args = (jnp.asarray(x), jnp.asarray(temb))
    jkw = {} if skip is None else {"skip": jnp.asarray(skip)}
    jparams = jblk.init(jax.random.PRNGKey(0), *args, **jkw)["params"]
    params, pblk = _load(pl.ResnetBlockBigGANpp(F.silu, blk_in, out_ch, temb_dim=32,
                                                fir=True, dropout=0.0, init_scale=1.0, **kw),
                         jparams)
    want = np.asarray(jblk.apply({"params": params}, *args, **jkw))
    px = nchw(x) if skip is None else nchw(np.concatenate([x, skip], axis=-1))
    got = nhwc(pblk(px, tt(temb)))
    assert_close_rel(got, want, 1e-4, variant)


def test_attn_block():
    x = _x((2, 4, 6, 16), 4)
    jblk = jl.AttnBlockpp(skip_rescale=True, init_scale=1.0)
    jparams = jblk.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    params, pblk = _load(pl.AttnBlockpp(16, skip_rescale=True, init_scale=1.0), jparams)
    want = np.asarray(jblk.apply({"params": params}, jnp.asarray(x)))
    assert_close_rel(nhwc(pblk(nchw(x))), want, 1e-4, "attn")


@pytest.mark.parametrize("method", ["sum", "cat"])
def test_combine(method):
    x, y = _x((2, 8, 8, 6), 5), _x((2, 8, 8, 16), 6)
    jmod = jl.Combine(dim2=16, method=method)
    jparams = jmod.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(y))["params"]
    params, pmod = _load(pl.Combine(6, 16, method=method), jparams)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x), jnp.asarray(y)))
    assert_close_rel(nhwc(pmod(nchw(x), nchw(y))), want, 1e-5, method)


def test_gaussian_fourier_projection():
    t = np.log(np.asarray([0.03, 0.4, 1.0], np.float32))
    jmod = jl.GaussianFourierProjection(embedding_size=16, scale=16.0)
    jparams = jmod.init(jax.random.PRNGKey(3), jnp.asarray(t))["params"]
    params, pmod = _load(pl.GaussianFourierProjection(16, 16.0), jparams)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(t)))
    # sin/cos of arguments up to ~|2 pi * 3.5 * 16 * 3|: float32 argument rounding
    assert_close_rel(pmod(tt(t)).detach().numpy(), want, 1e-4, "fourier")
