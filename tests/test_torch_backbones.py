"""Port parity: the NCSN++ family and its option axes against
storm_tpu.backbones.ncsnpp, and the backbone registry.

Each published size holds the reference's parameter count and module names
(the flax tree converted by `params_from_jax` loads strictly). Every option
axis of tests/test_backbone_ncsnpp.py runs on a tiny net (nf 16, two levels,
64 x 32) with weights drawn by `random_params` and carried by the converter:
forward and the gradient with respect to the input against `NCSNpp.apply`
and `jax.grad`, within 1e-4 of the output's (or gradient's) scale, as
tests/test_torch_ncsnpp.py holds the default (GroupNorm's variance formula
and the convolutions' summation order differ between the frameworks).
Deep-feature caching on an attention-at-16 net equals the exact forward.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_close_rel, random_params, tt

from storm_tpu.backbones import BackboneRegistry
from storm_tpu.backbones.ncsnpp import NCSNpp as JNCSNpp
from storm_tpu_torch import backbones
from storm_tpu_torch.backbones.ncsnpp import DEEPCACHE_REFUSED, NCSNpp, count_parameters
from storm_tpu_torch.convert import check_state_dict, module_params_from_jax

SIZES = ["ncsnpp", "ncsnpplarge", "ncsnpp12M", "ncsnpp6M"]
TINY = dict(input_channels=4, nf=16, ch_mult=(1, 2), image_size=64, init_scale=1.0)
# the axes of tests/test_backbone_ncsnpp.py::test_config_variants
AXES = [
    dict(resblock_type="ddpm"),
    dict(progressive="residual"),
    dict(progressive_input="residual"),
    dict(progressive="none", progressive_input="none"),
    dict(progressive_combine="cat"),
    dict(fir=False),
    dict(embedding_type="positional"),
    dict(resblock_type="ddpm", progressive="residual", progressive_input="residual", fir=False),
    dict(resblock_type="ddpm", progressive="residual", progressive_input="residual"),
]


def _shapes(net, x_shape):
    x = jnp.zeros(x_shape, jnp.float32)
    t = jnp.ones((x_shape[0],), jnp.float32)
    return jax.eval_shape(lambda: net.init(jax.random.PRNGKey(0), x, t))["params"]


def _leaves(tree):
    return sum(int(np.prod(s.shape)) for s in jax.tree.leaves(tree))


@pytest.mark.parametrize("name", SIZES)
def test_size_parameter_count_and_module_names(name):
    """The size's parameter count equals the reference's (27.8M, ~65M, ~12M,
    ~6M), and the reference's tree converts key for key onto the port's
    modules in their order (`m{i}` is `all_modules.{i}`)."""
    jnet = BackboneRegistry.get_by_name(name).from_kwargs(input_channels=4)
    shapes = _shapes(jnet, (1, 2, 256, 64, 2))
    pnet = backbones.get_by_name(name).from_kwargs(input_channels=4)
    assert count_parameters(pnet) == _leaves(shapes)
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    check_state_dict(module_params_from_jax(zeros), pnet)
    assert [f"m{i}" for i in range(len(pnet.all_modules))] == sorted(
        (k for k in shapes if k.startswith("m")), key=lambda k: int(k[1:]))


def _pair(kw, seed=0, **extra):
    """(reference net, its random params, port net loaded with them)."""
    jnet = JNCSNpp.from_kwargs(**kw, **extra)
    params = random_params(_shapes(jnet, (2, 2, 64, 32, 2)), seed=seed)
    pnet = NCSNpp.from_kwargs(**kw, **extra).eval()
    pnet.load_state_dict(module_params_from_jax(params), strict=True)
    return jnet, params, pnet


@pytest.mark.parametrize("kw", AXES, ids=lambda kw: "-".join(f"{v}" for v in kw.values()))
def test_option_axis_forward_and_input_gradient(kw):
    cfg = {**TINY, **kw}
    jnet, params, pnet = _pair(cfg, seed=1)
    rng = np.random.default_rng(2)
    x = (0.5 * rng.standard_normal((2, 2, 64, 32, 2))).astype(np.float32)
    t = np.asarray([0.3, 0.8], np.float32)
    g = rng.standard_normal((2, 1, 64, 32, 2)).astype(np.float32)

    def jloss(xv):
        out = jnet.apply({"params": params}, xv, jnp.asarray(t))
        return jnp.sum(out * g), out

    # one compiled program: the reference's eager dispatch is ~10x slower here
    (_, want), want_grad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jnp.asarray(x))
    want, want_grad = np.asarray(want), np.asarray(want_grad)
    xt = tt(x).requires_grad_()
    out = pnet(xt, tt(t))
    (grad,) = torch.autograd.grad((out * tt(g)).sum(), xt)
    assert out.shape == want.shape == (2, 1, 64, 32, 2)
    assert_close_rel(out.detach().numpy(), want, 1e-4, f"{kw} forward")
    assert_close_rel(grad.numpy(), want_grad, 1e-4, f"{kw} input gradient")


def test_deepcache_with_attention_at_16_equals_the_forward():
    """ncsnpplarge's layout at a tiny width (two resblocks per level,
    attention at the 16-resolution of the middle levels): every cache depth's
    shallow pass of its deep features is the exact forward, bit for bit, and
    the forward agrees with the reference's."""
    kw = dict(input_channels=4, nf=16, ch_mult=(1, 1, 2, 2), num_res_blocks=2,
              attn_resolutions=(16,), image_size=64, init_scale=1.0)
    jnet, params, pnet = _pair(kw, seed=3)
    x = (0.4 * np.random.default_rng(4).standard_normal((2, 2, 64, 32, 2))).astype(np.float32)
    t = tt(np.asarray([0.6, 0.2], np.float32))
    with torch.no_grad():
        full = pnet(tt(x), t)
        for depth in (1, 2, 3):
            cache = pnet.deep_features(tt(x), t, cache_depth=depth)
            assert torch.equal(pnet.forward_shallow(tt(x), t, cache, cache_depth=depth), full)
    want = np.asarray(jax.jit(lambda v: jnet.apply({"params": params}, v, jnp.asarray(t.numpy())))(
        jnp.asarray(x)))
    assert_close_rel(full.numpy(), want, 1e-4, "attention at 16")


@pytest.mark.parametrize("kw", [dict(resblock_type="ddpm"), dict(progressive="residual"),
                                dict(progressive_input="none")])
def test_deepcache_refuses_other_configurations_with_the_reference_message(kw):
    jnet = JNCSNpp.from_kwargs(**TINY, **kw)
    x = jnp.zeros((1, 2, 64, 32, 2))
    t = jnp.ones((1,))
    params = random_params(_shapes(jnet, (1, 2, 64, 32, 2)))
    with pytest.raises(AssertionError, match=re.escape(DEEPCACHE_REFUSED)):
        jnet.apply({"params": params}, x, t, method="deep_features", cache_depth=1)
    pnet = NCSNpp.from_kwargs(**TINY, **kw)
    with pytest.raises(ValueError, match=re.escape(DEEPCACHE_REFUSED)):
        pnet.deep_features(torch.zeros(1, 2, 64, 32, 2), torch.ones(1), cache_depth=1)


def test_registry_names_and_the_gagnet_refusal():
    """Every name of the reference's registry builds in the port, GaGNet
    included (no backbone is refused any more); an unknown name raises."""
    from storm_tpu_torch.backbones.gagnet import GaGNet

    assert set(backbones.get_all_names()) == set(BackboneRegistry.get_all_names())
    gagnet = backbones.get_by_name("gagnet").from_kwargs(discriminative=True, q=1, p=1)
    assert isinstance(gagnet, GaGNet) and not gagnet.SUPPORTS_DEEPCACHE
    with pytest.raises(ValueError, match="unknown"):
        backbones.get_by_name("unet")
    for name in ("ncsnpp", "ncsnpplarge", "ncsnpp12M", "ncsnpp6M"):
        assert backbones.get_by_name(name).SUPPORTS_DEEPCACHE
    for name in ("ae-ncsnpp", "convtasnet"):
        cls = backbones.get_by_name(name)
        assert cls.FORCE_STFT_OUT and not cls.SUPPORTS_DEEPCACHE

