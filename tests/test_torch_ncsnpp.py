"""Port parity: NCSN++ forward against storm_tpu.backbones.ncsnpp, and the
full-width parameter count and strict load.

Tiny nets (nf 16, three levels, 32 x 64 spectrogram) with the reference's
weights (init_scale 1 so that no branch starts at ~0; biases and norm scales
perturbed). Tolerance 1e-4 relative to the output's scale: GroupNorm
variance formulas and conv summation order differ between the frameworks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_parity import assert_close_rel, perturb_tree, to_numpy_tree, tt

from storm_tpu.backbones.ncsnpp import NCSNpp as JNCSNpp
from storm_tpu.models.storm import StochasticRegenerationModel as JStoRM
from storm_tpu_torch.backbones.ncsnpp import NCSNpp as PNCSNpp
from storm_tpu_torch.backbones.ncsnpp import count_parameters
from storm_tpu_torch.convert import check_state_dict, module_params_from_jax
from storm_tpu_torch.models.factory import build_model

TINY = dict(nf=16, ch_mult=(1, 2, 2), init_scale=1.0)


@pytest.mark.parametrize("variant", ["score", "score_attn_level", "denoiser"])
def test_tiny_ncsnpp_forward_matches(variant):
    kw = dict(TINY)
    if variant == "denoiser":
        kw.update(input_channels=2, discriminative=True)
        cc, t = 1, np.ones(2, np.float32)
    else:
        kw.update(input_channels=6)
        cc, t = 3, np.asarray([0.04, 0.7], np.float32)
    if variant == "score_attn_level":
        kw.update(image_size=32, attn_resolutions=(16,))  # attention at level 1 too
    rng = np.random.default_rng(0)
    x = (0.5 * rng.standard_normal((2, cc, 32, 64, 2))).astype(np.float32)
    jnet = JNCSNpp.from_kwargs(**kw)
    jparams = jnet.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t))["params"]
    params = perturb_tree(to_numpy_tree(jparams), seed=1)
    want = np.asarray(jnet.apply({"params": params}, jnp.asarray(x), jnp.asarray(t)))

    pnet = PNCSNpp.from_kwargs(**kw).eval()
    pnet.load_state_dict(module_params_from_jax(params), strict=True)
    got = pnet(tt(x), tt(t)).detach().numpy()
    assert got.shape == want.shape == (2, 1, 32, 64, 2)
    assert_close_rel(got, want, 1e-4, variant)


def _jax_param_shapes(net, x_shape):
    x = jnp.zeros(x_shape, jnp.float32)
    t = jnp.ones((x_shape[0],), jnp.float32)
    return jax.eval_shape(lambda: net.init(jax.random.PRNGKey(0), x, t))["params"]


def test_full_width_parameter_count_and_strict_load():
    shapes = _jax_param_shapes(JNCSNpp(), (1, 2, 256, 64, 2))
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    pnet = PNCSNpp()
    assert count_parameters(pnet) == n_jax  # 27.8M
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = module_params_from_jax(zeros)
    check_state_dict(sd, pnet)
    pnet.load_state_dict(sd, strict=True)


def test_full_width_storm_parameter_count():
    jmodel = JStoRM.create()
    shapes = jax.eval_shape(lambda: jmodel.init_params(jax.random.PRNGKey(0), (1, 256, 64)))
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    pmodel = build_model({}, device="cpu")
    assert count_parameters(pmodel) == n_jax  # 2 x 27.8M
    assert count_parameters(pmodel.denoiser_net) == sum(
        int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["denoiser"]))


def test_converter_is_strict():
    from storm_tpu_torch.convert import params_from_jax

    net = PNCSNpp.from_kwargs(**TINY, input_channels=2, discriminative=True)
    with pytest.raises(KeyError):
        params_from_jax({"denoiser": {}, "extra": {}})
    with pytest.raises(KeyError):
        module_params_from_jax({"m0": {"mystery": np.zeros(3, np.float32)}})
    with pytest.raises(KeyError):
        check_state_dict({}, net)
