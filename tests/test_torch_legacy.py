"""The port's legacy RefineNet blocks and norms (storm_tpu_torch/nn/legacy.py)
against storm_tpu/nn/legacy.py: each block's forward with the JAX block's
parameters carried by `convert.legacy_params_from_jax` (strict load), within
1e-5 of the output's scale, on NHWC inputs transposed to NCHW.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_close_rel, nchw, nhwc

from storm_tpu.nn import legacy as jl
from storm_tpu_torch.convert import legacy_params_from_jax
from storm_tpu_torch.nn import legacy as pl


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _carry(jblock, pblock, *args, seed=1):
    """Init the flax block, perturb its parameters (so a zero bias or unit
    scale cannot hide a mapping error), load them into the port's block."""
    params = jblock.init(jax.random.PRNGKey(0), *args)["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda v: np.asarray(v) + 0.1 * rng.standard_normal(v.shape)
                          .astype(np.float32), params)
    pblock.load_state_dict(legacy_params_from_jax(params), strict=True)
    return params


def _both(jblock, pblock, jargs, pargs):
    params = _carry(jblock, pblock, *jargs)
    want = np.asarray(jblock.apply({"params": params}, *jargs))
    with torch.no_grad():
        got = pblock(*pargs)
    return got, want


@pytest.mark.parametrize("maxpool", [True, False])
def test_crp_block(maxpool):
    x = _x(2, 9, 11, 8)
    got, want = _both(jl.CRPBlock(8, 3, maxpool=maxpool), pl.CRPBlock(8, 3, maxpool=maxpool),
                      (jnp.asarray(x),), (nchw(x),))
    assert_close_rel(nhwc(got), want, 1e-5, "CRPBlock")


@pytest.mark.parametrize("n_blocks,n_stages", [(1, 2), (3, 2), (2, 1)])
def test_rcu_block(n_blocks, n_stages):
    x = _x(2, 8, 10, 6, seed=2)
    got, want = _both(jl.RCUBlock(6, n_blocks, n_stages), pl.RCUBlock(6, n_blocks, n_stages),
                      (jnp.asarray(x),), (nchw(x),))
    assert_close_rel(nhwc(got), want, 1e-5, "RCUBlock")


@pytest.mark.parametrize("shape", [(16, 20), (8, 10), (6, 7)])
def test_msf_block_resizes_as_jax_image_resize(shape):
    """Up (16 x 20 from 8 x 10 and 4 x 5), the same size, and down (6 x 7:
    the antialiased shrink)."""
    xs = [_x(2, 8, 10, 4, seed=3), _x(2, 4, 5, 6, seed=4)]
    jblock, pblock = jl.MSFBlock(5), pl.MSFBlock([4, 6], 5)
    got, want = _both(jblock, pblock, ([jnp.asarray(x) for x in xs], shape),
                      ([nchw(x) for x in xs], shape))
    assert got.shape == (2, 5) + shape
    assert_close_rel(nhwc(got), want, 1e-5, f"MSFBlock {shape}")


@pytest.mark.parametrize("n_inputs,end,maxpool", [(1, False, True), (2, True, False),
                                                  (2, False, True)])
def test_refine_block(n_inputs, end, maxpool):
    xs = [_x(2, 8, 8, 6, seed=5), _x(2, 4, 4, 4, seed=6)][:n_inputs]
    planes = [x.shape[-1] for x in xs]
    jblock = jl.RefineBlock(6, n_inputs, end=end, maxpool=maxpool)
    pblock = pl.RefineBlock(planes, 6, end=end, maxpool=maxpool)
    got, want = _both(jblock, pblock, ([jnp.asarray(x) for x in xs], (8, 8)),
                      ([nchw(x) for x in xs], (8, 8)))
    assert_close_rel(nhwc(got), want, 1e-5, "RefineBlock")
    with pytest.raises(ValueError, match="inputs"):
        pblock([nchw(xs[0])] * (n_inputs + 1), (8, 8))


@pytest.mark.parametrize("norm", ["variance", "instance_plus", "instance_plus_no_bias"])
def test_norms(norm):
    x = 3.0 + 2.0 * _x(2, 7, 9, 5, seed=7)
    jblock, pblock = {
        "variance": (jl.VarianceNorm2d(5), pl.VarianceNorm2d(5)),
        "instance_plus": (jl.InstanceNorm2dPlus(5), pl.InstanceNorm2dPlus(5)),
        "instance_plus_no_bias": (jl.InstanceNorm2dPlus(5, bias=False),
                                  pl.InstanceNorm2dPlus(5, bias=False)),
    }[norm]
    got, want = _both(jblock, pblock, (jnp.asarray(x),), (nchw(x),))
    assert_close_rel(nhwc(got), want, 1e-5, norm)


@pytest.mark.parametrize("bias", [True, False])
def test_conditional_instance_norm_plus(bias):
    x = 1.0 + _x(3, 6, 8, 4, seed=8)
    y = np.asarray([2, 0, 2], np.int32)
    jblock = jl.ConditionalInstanceNorm2dPlus(4, 3, bias=bias)
    pblock = pl.ConditionalInstanceNorm2dPlus(4, 3, bias=bias)
    got, want = _both(jblock, pblock, (jnp.asarray(x), jnp.asarray(y)),
                      (nchw(x), torch.from_numpy(y).long()))
    assert_close_rel(nhwc(got), want, 1e-5, f"ConditionalInstanceNorm2dPlus bias={bias}")


def test_ncsn_conv3x3_and_the_carry_are_strict():
    conv = pl.ncsn_conv3x3(3, 5, bias=False, stride=2, init_scale=0.0)
    assert conv.weight.shape == (5, 3, 3, 3) and conv.bias is None and conv.stride == (2, 2)
    assert conv.weight.abs().max() < 1e-8  # init_scale 0 -> 1e-10
    x = _x(1, 8, 8, 3, seed=9)
    jconv = jl.ncsn_conv3x3(5, bias=True, stride=2)
    params = jconv.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    pconv = pl.ncsn_conv3x3(3, 5, stride=2)
    pconv.load_state_dict(legacy_params_from_jax(params), strict=True)
    with torch.no_grad():
        assert_close_rel(nhwc(pconv(nchw(x))), jconv.apply({"params": params}, jnp.asarray(x)),
                         1e-5, "ncsn_conv3x3")
    with pytest.raises(KeyError, match="no mapping"):
        legacy_params_from_jax({"m0": {"scale": np.ones(3, np.float32)}})
