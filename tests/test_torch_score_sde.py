"""The port's legacy score-sde helpers (storm_tpu_torch/utils/score_sde.py)
against storm_tpu/utils/score_sde.py.

The noise tables must be equal (float64, atol 0), the registry must refuse
as the JAX one does, and `get_score_fn` over a tiny NCSN++ (nf 16, 32 bins
of n_fft 62) with carried weights must agree within 1e-5 of the output's
scale for OUVE and OUVP, continuous and discrete labels.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_close_rel, random_params, tt

from storm_tpu.backbones.ncsnpp import NCSNpp as JNCSNpp
from storm_tpu.sde.sdes import OUVESDE as JOUVE
from storm_tpu.sde.sdes import OUVPSDE as JOUVP
from storm_tpu.utils import score_sde as jss
from storm_tpu_torch.backbones.ncsnpp import NCSNpp as PNCSNpp
from storm_tpu_torch.convert import module_params_from_jax
from storm_tpu_torch.sde.sdes import OUVESDE, OUVPSDE
from storm_tpu_torch.utils import score_sde as ss

TINY = dict(nf=16, ch_mult=(1, 2, 2), init_scale=1.0, input_channels=4)


@pytest.mark.parametrize("lo,hi,n", [(0.01, 50.0, 10), (0.05, 0.5, 1000), (1e-3, 1.0, 1)])
def test_sigmas_equal_the_reference(lo, hi, n):
    np.testing.assert_array_equal(ss.get_sigmas(lo, hi, n), jss.get_sigmas(lo, hi, n))


@pytest.mark.parametrize("b0,b1,n", [(0.1, 20.0, 1000), (0.1, 1.0, 30), (0.01, 2.0, 1)])
def test_ddpm_tables_equal_the_reference(b0, b1, n):
    got, want = ss.get_ddpm_params(b0, b1, n), jss.get_ddpm_params(b0, b1, n)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_registry_roundtrip_and_refusals_as_the_reference():
    for mod in (ss, jss):
        @mod.register_model(name="_legacy_dummy")
        class Dummy:
            def __init__(self, k=3):
                self.k = k

        @mod.register_model
        class _LegacyNamed:
            pass

        assert mod.get_model("_legacy_dummy") is Dummy
        assert mod.get_model("_LegacyNamed") is _LegacyNamed
        assert mod.create_model("_legacy_dummy", k=7).k == 7
        with pytest.raises(ValueError, match="legacy-score-sde-model _legacy_dummy already"):
            mod.register_model(name="_legacy_dummy")(Dummy)
        with pytest.raises(ValueError, match="with name 'nope' unknown! Available"):
            mod.get_model("nope")
    with pytest.raises(NotImplementedError, match="not yet supported"):
        ss.get_score_fn(object(), lambda *a, **k: None)


def test_flatten_roundtrip():
    x = torch.arange(12.0).reshape(3, 4)
    flat = ss.to_flattened_numpy(x)
    np.testing.assert_array_equal(flat, jss.to_flattened_numpy(jnp.arange(12.0).reshape(3, 4)))
    back = ss.from_flattened_numpy(flat, (3, 4))
    assert torch.equal(back, x)


@pytest.fixture(scope="module")
def nets():
    rng = np.random.default_rng(0)
    x = (0.5 * rng.standard_normal((2, 2, 32, 32, 2))).astype(np.float32)
    jnet = JNCSNpp.from_kwargs(**TINY)
    params = random_params(jax.eval_shape(lambda: jnet.init(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.ones(2)))["params"], seed=1)
    pnet = PNCSNpp.from_kwargs(**TINY).eval()
    pnet.load_state_dict(module_params_from_jax(params), strict=True)
    seen = []

    def japply(x, labels, deterministic):
        seen.append(("jax", np.asarray(labels), deterministic))
        return jnet.apply({"params": params}, x, labels, train=not deterministic)

    def papply(x, labels, deterministic):
        seen.append(("port", labels.numpy(), deterministic))
        with torch.no_grad():
            return pnet(x, labels)

    return x, japply, papply, seen


SDES = {
    "ouve": (lambda: OUVESDE(theta=1.5, sigma_min=0.05, sigma_max=0.5, N=30),
             lambda: JOUVE(theta=1.5, sigma_min=0.05, sigma_max=0.5, N=30)),
    "ouvp": (lambda: OUVPSDE(beta_min=0.1, beta_max=1.0, N=30),
             lambda: JOUVP(beta_min=0.1, beta_max=1.0, N=30)),
}


@pytest.mark.parametrize("sde", list(SDES))
@pytest.mark.parametrize("continuous", [True, False])
def test_score_fn_over_a_tiny_ncsnpp_matches_the_reference(nets, sde, continuous):
    x, japply, papply, seen = nets
    t = np.asarray([0.3, 0.77], np.float32)
    seen.clear()
    want = np.asarray(jss.get_score_fn(SDES[sde][1](), japply, continuous=continuous)(
        jnp.asarray(x), jnp.asarray(t)))
    got = ss.get_score_fn(SDES[sde][0](), papply, continuous=continuous)(tt(x), tt(t)).numpy()
    assert got.shape == want.shape == (2, 1, 32, 32, 2)
    assert_close_rel(got, want, 1e-5, f"{sde} continuous={continuous}")
    (_, jlabels, jdet), (_, plabels, pdet) = seen
    assert jdet is pdet is True
    assert plabels.dtype == jlabels.dtype
    np.testing.assert_allclose(plabels, jlabels, rtol=1e-7)
    if not continuous:
        assert plabels.dtype == np.int32 and plabels.tolist() == (
            [20, 7] if sde == "ouve" else [8, 22])
