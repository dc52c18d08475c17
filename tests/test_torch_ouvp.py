"""Port parity for the OUVP SDE: every method of `OUVPSDE` against
storm_tpu.sde.sdes.OUVPSDE, the pc sampler (ald and reverse_diffusion) and
the probability-flow ODE (euler, heun) on an analytic score, the etd
refusals with the reference's messages, and StoRM's loss under OUVP.

Inputs are made with numpy from a seed. Tolerances: the SDE's closed forms
1e-6 relative to the output's scale (the same float32 expressions, two
libraries' exp); the samplers 1e-5 of the output's scale (float32 updates
over a few steps); StoRM's loss 1e-5 relative, as in test_torch_train. The
SDE runs at stiffness 1.7 and at several t, against float64 closed forms
too, so a formula copied from OUVE's shape, or a lost stiffness, shows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_train import _batch, _models
from torch_parity import ReplayNoise, assert_close_rel, jax_noise_schedule, tt

from storm_tpu.sampling import samplers as jsamplers
from storm_tpu.sde.sdes import OUVPSDE as JOUVP
from storm_tpu.signal import cplx as jcplx
from storm_tpu.utils.tensors import right_pad_dims as jpad
from storm_tpu_torch.sampling.samplers import ode_sample, pc_sample
from storm_tpu_torch.sde.sdes import SDES, OUVESDE, OUVPSDE
from storm_tpu_torch.utils.tensors import right_pad_dims as ppad

RNG = np.random.default_rng(0)
X = RNG.standard_normal((4, 8, 10, 2)).astype(np.float32)
Y = RNG.standard_normal((4, 8, 10, 2)).astype(np.float32)
T = np.asarray([0.03, 0.31, 0.77, 1.0], np.float32)
KW = dict(beta_min=0.1, beta_max=1.0, stiffness=1.7, N=30)
EPS = 0.03


def _pair(**kw):
    kw = {**KW, **kw}
    return JOUVP(**kw), OUVPSDE(**kw)


def _np_forms(sde, t):
    """The reference's closed forms in float64: (beta, mean factor, std)."""
    b0, b1, s = sde.beta_min, sde.beta_max, sde.stiffness
    t = t.astype(np.float64)
    beta = b0 + t * (b1 - b0)
    fac = np.exp(-0.25 * s * t * (t * (b1 - b0) + 2 * b0))
    std = (1 - np.exp(-0.5 * s * t * (t * (b1 - b0) + 2 * b0))) / s
    return beta, fac, std


def test_fields_defaults_and_registry():
    assert SDES == {"ouve": OUVESDE, "ouvp": OUVPSDE}
    with pytest.raises(TypeError):
        OUVPSDE()  # beta_min and beta_max have no defaults, as in the reference
    sde = OUVPSDE(0.1, 1.0)
    assert (sde.stiffness, sde.N, sde.T) == (1.0, 1000, 1.0)
    assert sde.copy(N=7) == OUVPSDE(0.1, 1.0, N=7)
    # at the CLI's defaults the std at T is about 0.42 (OUVE's: 0.39)
    assert float(sde._std(tt(np.ones(1)))) == pytest.approx(0.4231, abs=1e-4)


@pytest.mark.parametrize("stiffness", [1.0, 1.7])
def test_closed_forms_match_reference(stiffness):
    j, p = _pair(stiffness=stiffness)
    jx, jy, jt = jnp.asarray(X), jnp.asarray(Y), jnp.asarray(T)
    px, py, pt = tt(X), tt(Y), tt(T)
    beta, fac, std = _np_forms(p, T)
    pad = (slice(None),) + (None,) * 3
    # _std and the mean as the reference writes them (no square root in _std)
    assert_close_rel(p._std(pt).numpy(), np.asarray(j._std(jt)), 1e-6, "_std")
    assert_close_rel(p._std(pt).numpy(), std, 1e-6, "_std against float64")
    assert_close_rel(p._mean(px, pt, py).numpy(), np.asarray(j._mean(jx, jt, jy)), 1e-6, "_mean")
    assert_close_rel(p._mean(px, pt, py).numpy(), Y + fac[pad] * (X - Y), 1e-6, "_mean f64")
    for a, b, what in ((j.sde(jx, jt, jy), p.sde(px, pt, py), "sde"),
                       (j.marginal_prob(jx, jt, jy), p.marginal_prob(px, pt, py), "marginal"),
                       (j.discretize(jx, jt, jy), p.discretize(px, pt, py), "discretize")):
        for k, (want, got) in enumerate(zip(a, b)):
            assert_close_rel(got.numpy(), np.asarray(want), 1e-6, f"{what}[{k}]")
    drift, diffusion = p.sde(px, pt, py)
    assert_close_rel(drift.numpy(), 0.5 * stiffness * beta[pad] * (Y - X), 1e-6, "drift f64")
    assert_close_rel(diffusion.numpy(), np.sqrt(beta), 1e-6, "diffusion f64")


def test_prior_sampling_with_injected_noise():
    j, p = _pair()
    z = (RNG.standard_normal(Y.shape) / np.sqrt(2.0)).astype(np.float32)
    std_T = np.asarray(j._std(jnp.ones(Y.shape[0])))
    got = p.prior_sampling(tt(Y), tt(z)).numpy()
    assert_close_rel(got, Y + z * std_T[:, None, None, None], 1e-6, "prior_sampling")
    # and the reference's own draw, its noise replayed
    key = jax.random.PRNGKey(3)
    want = np.asarray(j.prior_sampling(key, jnp.asarray(Y)))
    zj = np.asarray(jcplx.complex_normal(key, Y.shape[:-1]), np.float32)  # its draw
    assert_close_rel(p.prior_sampling(tt(Y), tt(zj)).numpy(), want, 1e-6, "reference draw")


@pytest.mark.parametrize("pf", [False, True])
def test_reverse_sde_matches_reference(pf):
    j, p = _pair()
    jr = j.reverse(lambda x, t, y: -(x - y) * (1.0 + t)[:, None, None, None], pf)
    pr = p.reverse(lambda x, t, y: -(x - y) * (1.0 + t)[:, None, None, None], pf)
    jx, jy, jt = jnp.asarray(X), jnp.asarray(Y), jnp.asarray(T)
    px, py, pt = tt(X), tt(Y), tt(T)
    for a, b, what in ((jr.sde(jx, jt, jy), pr.sde(px, pt, py), "rsde.sde"),
                       (jr.discretize(jx, jt, jy), pr.discretize(px, pt, py), "rsde.disc")):
        for k, (want, got) in enumerate(zip(a, b)):
            assert_close_rel(got.numpy(), np.asarray(want), 1e-6, f"{what}[{k}] pf={pf}")


# --- the samplers on the exact score of an OUVP marginal


def _case(seed=0, shape=(2, 8, 12)):
    rng = np.random.default_rng(seed)
    x0 = (0.5 * rng.standard_normal(shape + (2,))).astype(np.float32)
    y = (x0 + 0.3 * rng.standard_normal(shape + (2,))).astype(np.float32)
    xT = (y + 0.4 * rng.standard_normal(shape + (2,))).astype(np.float32)
    return x0, y, xT


def _jscore(sde, x0):
    def score_fn(x, t, y):
        mean, std = sde.marginal_prob(jnp.asarray(x0), t, y)
        return -(x - mean) / jpad(std, x) ** 2
    return score_fn


def _pscore(sde, x0):
    def score_fn(x, t, y):
        mean, std = sde.marginal_prob(tt(x0), t, y)
        return -(x - mean) / ppad(std, x) ** 2
    return score_fn


@pytest.mark.parametrize("predictor,corrector", [("reverse_diffusion", "ald"),
                                                 ("reverse_diffusion", "none"),
                                                 ("euler_maruyama", "ald")])
def test_pc_sample_matches_reference(predictor, corrector):
    j, p = _pair()
    x0, y, _ = _case(1)
    key, N = jax.random.PRNGKey(4), 4
    want, jnfe = jsamplers.pc_sample(key, j, _jscore(j, x0), jnp.asarray(y), predictor=predictor,
                                     corrector=corrector, N=N, eps=EPS)
    noise = ReplayNoise(jax_noise_schedule(key, y.shape[:-1], N, predictor=predictor,
                                           corrector=corrector))
    got, nfe = pc_sample(p, _pscore(p, x0), tt(y), predictor=predictor, corrector=corrector,
                         N=N, eps=EPS, noise=noise)
    assert noise.exhausted() and nfe == int(jnfe) == N * (1 + (corrector != "none"))
    assert_close_rel(got.numpy(), np.asarray(want), 1e-5, f"pc {predictor} {corrector}")


@pytest.mark.parametrize("method", ["euler", "heun"])
def test_ode_sample_matches_reference(method):
    j, p = _pair()
    x0, y, xT = _case(2)
    N = 4
    want, jnfe = jsamplers.ode_sample(jax.random.PRNGKey(0), j, _jscore(j, x0), jnp.asarray(y),
                                      N=N, method=method, eps=EPS, x_init=jnp.asarray(xT))
    got, nfe = ode_sample(p, _pscore(p, x0), tt(y), N=N, method=method, eps=EPS, x_init=tt(xT))
    assert nfe == int(jnfe) == N * {"euler": 1, "heun": 2}[method] + 1
    assert_close_rel(got.numpy(), np.asarray(want), 1e-5, method)


@pytest.mark.parametrize("method", ["etd1", "etd2", "etd2-ms"])
def test_etd_methods_refuse_ouvp_as_the_reference(method):
    j, p = _pair()
    x0, y, xT = _case(3)
    with pytest.raises(ValueError) as jerr:
        jsamplers.ode_sample(jax.random.PRNGKey(0), j, _jscore(j, x0), jnp.asarray(y), N=2,
                             method=method, x_init=jnp.asarray(xT))
    with pytest.raises(ValueError) as perr:
        ode_sample(p, _pscore(p, x0), tt(y), N=2, method=method, x_init=tt(xT))
    assert str(perr.value) == str(jerr.value)
    assert str(perr.value) == (f"{method} requires an SDE with constant linear drift (OUVE); "
                               "got OUVPSDE")


def test_etd_predictor_refuses_ouvp_as_the_reference():
    j, p = _pair()
    x0, y, _ = _case(4)
    with pytest.raises(ValueError) as jerr:
        jsamplers.pc_sample(jax.random.PRNGKey(0), j, _jscore(j, x0), jnp.asarray(y),
                            predictor="etd", corrector="none", N=2)
    with pytest.raises(ValueError) as perr:
        pc_sample(p, _pscore(p, x0), tt(y), predictor="etd", corrector="none", N=2,
                  noise=ReplayNoise(jax_noise_schedule(jax.random.PRNGKey(0), y.shape[:-1], 2,
                                                       predictor="etd", corrector="none")))
    assert str(perr.value) == str(jerr.value) == "etd predictor requires an OUVE-style SDE"


# --- StoRM under OUVP


def test_storm_loss_under_ouvp_matches_reference():
    cfg = {"mode": "regen-joint-training", "nf": 16, "ch_mult": [1, 2, 2], "init_scale": 1.0,
           "n_fft": 62, "hop_length": 16, "sde": "ouvp", "beta_min": 0.1, "beta_max": 1.0,
           "stiffness": 1.7}
    jmodel, params, pmodel = _models(cfg)
    assert isinstance(pmodel.sde, OUVPSDE) and pmodel.sde.stiffness == 1.7
    x, y, t, z = _batch(2)
    want, jaux = jax.jit(lambda p, *a: jmodel.loss_given_tz(p, a[:2], *a[2:]))(params, x, y, t, z)
    got, aux = pmodel.loss_given_tz((tt(x), tt(y)), tt(t), tt(z))
    assert set(aux) == set(jaux)
    for k in aux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-5, err_msg=k)
