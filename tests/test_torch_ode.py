"""Port parity for the probability-flow samplers: `ode_sample` (every
method), `dopri45_integrate`, `picard_sample` and the `etd` predictor
against storm_tpu.sampling's, and the ODE and Picard paths of `enhance`.

Inputs are made with numpy from a seed. The sampler tests use the exact
score of an OUVE marginal (a Gaussian around a fixed clean spectrogram),
written once for each framework, and start both ODEs from the same x(T)
(`x_init`), so they hold the grid, the step rules, the controller and the
NFE: 1e-5 relative to the output's scale (float32 updates over a few steps
in another summation order). `enhance` runs the tiny StoRM of
test_torch_inference (nf 16, n_fft 62) with the weights carried across by
convert.py and the reference's prior draw replayed: 1e-4 of the output's
scale in float32, as in test_torch_storm; bfloat16 in the ratio form of
test_torch_bf16 (RATIO, REALLY). Deepcache at interval 1 with the
single-evaluation methods is the exact trajectory, bit for bit.
"""
import http.client
import json
import re
import threading
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.integrate import solve_ivp
from test_torch_bf16 import RATIO, REALLY, _ratios
from test_torch_inference import STORM_TINY, tiny_storm_pair, wave
from torch_parity import ReplayNoise, assert_close_rel, jax_noise_schedule, tt

from storm_tpu.models.base import check_deepcache_config as jcheck_deepcache
from storm_tpu.models.factory import build_model as jbuild
from storm_tpu.sampling import predictors as jpredictors
from storm_tpu.sampling import samplers as jsamplers
from storm_tpu.sde.sdes import OUVESDE as JOUVE
from storm_tpu.utils.tensors import right_pad_dims as jpad
from storm_tpu_torch import enhancement, serve
from storm_tpu_torch.ckpt import save_checkpoint
from storm_tpu_torch.data.audio import load_wav, save_wav
from storm_tpu_torch.models.base import check_deepcache_config
from storm_tpu_torch.models.factory import build_model as pbuild
from storm_tpu_torch.sampling import samplers
from storm_tpu_torch.sampling.predictors import PREDICTORS
from storm_tpu_torch.sampling.samplers import (DeepCache, dopri45_integrate, ode_sample,
                                               pc_sample, picard_sample)
from storm_tpu_torch.sde.sdes import OUVESDE as POUVE
from storm_tpu_torch.signal import cplx
from storm_tpu_torch.utils.inference import BucketedEnhancer
from storm_tpu_torch.utils.server import decode_wav_bytes, encode_wav_bytes
from storm_tpu_torch.utils.tensors import right_pad_dims as ppad

F = 32  # frequency bins at n_fft 62
FIXED_STEP = ("euler", "heun", "rk4", "etd1", "etd2", "etd2-ms")
EPS = 0.03


def _case(seed=0, shape=(2, 8, 12)):
    """(clean x0, steady state y, start state x(T)), packed-real float32."""
    rng = np.random.default_rng(seed)
    x0 = (0.5 * rng.standard_normal(shape + (2,))).astype(np.float32)
    y = (x0 + 0.3 * rng.standard_normal(shape + (2,))).astype(np.float32)
    xT = (y + 0.5 * rng.standard_normal(shape + (2,))).astype(np.float32)
    return x0, y, xT


def _jscore(sde, x0):
    """Exact score of the OUVE marginal N(mean(x0, t, y), std(t)^2), JAX."""
    def score_fn(x, t, y):
        mean, std = sde.marginal_prob(jnp.asarray(x0), t, y)
        return -(x - mean) / jpad(std, x) ** 2
    return score_fn


def _pscore(sde, x0):
    """The same score on torch tensors."""
    def score_fn(x, t, y):
        mean, std = sde.marginal_prob(tt(x0), t, y)
        return -(x - mean) / ppad(std, x) ** 2
    return score_fn


# --- ode_sample on the analytic score


@pytest.mark.parametrize("method", FIXED_STEP)
def test_ode_sample_fixed_step_methods_match_reference(method):
    x0, y, xT = _case(0)
    N = 4
    want, jnfe = jsamplers.ode_sample(jax.random.PRNGKey(0), JOUVE(), _jscore(JOUVE(), x0),
                                      jnp.asarray(y), N=N, method=method, eps=EPS,
                                      x_init=jnp.asarray(xT))
    got, nfe = ode_sample(POUVE(), _pscore(POUVE(), x0), tt(y), N=N, method=method, eps=EPS,
                          x_init=tt(xT))
    per_step = {"euler": 1, "heun": 2, "rk4": 4, "etd1": 1, "etd2": 2}
    want_nfe = (N + 1 if method == "etd2-ms" else N * per_step[method]) + 1
    assert nfe == int(jnfe) == want_nfe
    assert_close_rel(got.numpy(), np.asarray(want), 1e-5, method)


def test_ode_sample_without_denoising_matches_reference():
    x0, y, xT = _case(1)
    want, jnfe = jsamplers.ode_sample(jax.random.PRNGKey(0), JOUVE(), _jscore(JOUVE(), x0),
                                      jnp.asarray(y), N=3, method="etd2", eps=EPS,
                                      denoise=False, x_init=jnp.asarray(xT))
    got, nfe = ode_sample(POUVE(), _pscore(POUVE(), x0), tt(y), N=3, method="etd2", eps=EPS,
                          denoise=False, x_init=tt(xT))
    assert nfe == int(jnfe) == 6
    assert_close_rel(got.numpy(), np.asarray(want), 1e-5, "etd2 without denoising")


# --- dopri45_integrate


def _drifts(x0, y):
    """The probability-flow drift of the analytic score, (JAX, port)."""
    jsde, psde = JOUVE(), POUVE()
    jr = jsde.reverse(_jscore(jsde, x0), probability_flow=True)
    pr = psde.reverse(_pscore(psde, x0), probability_flow=True)
    B = y.shape[0]

    def jdrift(x, t):
        return jr.sde(x, jnp.full((B,), t, jnp.float32), jnp.asarray(y))[0]

    def pdrift(x, t):
        return pr.sde(x, torch.full((B,), float(t)), tt(y))[0]

    return jdrift, pdrift


@pytest.mark.parametrize("tol", [1e-3, 1e-4, 1e-5])
def test_dopri45_takes_the_reference_steps(tol):
    """The same accepted and attempted steps, the same NFE, x to 1e-5 of its
    scale. The step controller reads an error estimate that cancels to ~tol
    of the state, so an ulp's difference in a stage shifts the next step:
    the reference's own compiled loop (XLA fuses each stage's sums) and its
    eager run (each operation rounded on its own, as the port's are) part by
    up to 1.3e-5 of the scale and by a step (seeds 2 and 3, tolerances 1e-3
    to 1e-5). The port is held to the eager run."""
    x0, y, xT = _case(2)
    jdrift, pdrift = _drifts(x0, y)
    with jax.disable_jit():
        jx, jnfe, jacc = jsamplers.dopri45_integrate(jdrift, jnp.asarray(xT), 1.0, EPS,
                                                     rtol=tol, atol=tol)
    x, nfe, acc = dopri45_integrate(pdrift, tt(xT), 1.0, EPS, rtol=tol, atol=tol)
    assert (nfe, acc) == (int(jnfe), int(jacc))
    assert (nfe - 2) % 6 == 0 and (nfe - 2) // 6 >= acc > 0
    assert_close_rel(x.numpy(), np.asarray(jx), 1e-5, f"dopri45 at tolerance {tol}")


def test_dopri45_max_steps_bounds_the_attempts():
    x0, y, xT = _case(2)
    _, pdrift = _drifts(x0, y)
    _, nfe, acc = dopri45_integrate(pdrift, tt(xT), 1.0, EPS, rtol=1e-7, atol=1e-7,
                                    max_steps=3)
    assert nfe == 2 + 6 * 3 and acc <= 3


def test_dopri45_matches_scipy_on_a_linear_ode():
    """dx/dt = A x (A symmetric, positive definite: the state decays as t
    runs down) from 1 to 0.03 against
    scipy.integrate.solve_ivp(method="RK45") at the same tolerances and
    against the exact solution (tests/test_rk45.py's pattern)."""
    rng = np.random.default_rng(3)
    M = rng.standard_normal((6, 6))
    A = (M @ M.T) / 6 + np.eye(6)
    x_init = rng.standard_normal(6)
    At = torch.from_numpy(A.astype(np.float32))

    def drift(x, t):
        return x @ At.T

    sol = solve_ivp(lambda t, x: A @ x, (1.0, EPS), x_init, method="RK45", rtol=1e-6, atol=1e-6)
    x, nfe, acc = dopri45_integrate(drift, torch.from_numpy(x_init.astype(np.float32))[None],
                                    1.0, EPS, rtol=1e-6, atol=1e-6)
    w, V = np.linalg.eigh(A)
    exact = V @ (np.exp(w * (EPS - 1.0)) * (V.T @ x_init))
    np.testing.assert_allclose(x[0].numpy(), sol.y[:, -1], atol=2e-5)
    np.testing.assert_allclose(x[0].numpy(), exact, atol=2e-5)
    assert abs(acc - (sol.t.size - 1)) <= 2  # the same regime as scipy's own step count


def test_ode_sample_rk45_matches_reference():
    x0, y, xT = _case(4)
    with jax.disable_jit():  # as test_dopri45_takes_the_reference_steps
        want, jnfe = jsamplers.ode_sample(jax.random.PRNGKey(0), JOUVE(), _jscore(JOUVE(), x0),
                                          jnp.asarray(y), N=5, method="rk45", eps=EPS,
                                          rtol=1e-4, atol=1e-4, x_init=jnp.asarray(xT))
    got, nfe = ode_sample(POUVE(), _pscore(POUVE(), x0), tt(y), N=5, method="rk45", eps=EPS,
                          rtol=1e-4, atol=1e-4, x_init=tt(xT))
    assert nfe == int(jnfe) and (nfe - 3) % 6 == 0
    assert_close_rel(got.numpy(), np.asarray(want), 1e-5, "rk45")


# --- picard_sample and the etd predictor


@pytest.mark.parametrize("sweeps", [1, 3])
def test_picard_sample_matches_reference(sweeps):
    x0, y, _ = _case(5)
    N, key = 5, jax.random.PRNGKey(4)
    want, jnfe = jsamplers.picard_sample(key, JOUVE(), _jscore(JOUVE(), x0), jnp.asarray(y),
                                         N=N, sweeps=sweeps, eps=EPS)
    calls = []

    def score(x, t, yy):  # the score sees N x B rows, time-major
        calls.append((x.shape[0], t.clone()))
        return _pscore(POUVE(), np.tile(x0, (x.shape[0] // y.shape[0], 1, 1, 1)))(x, t, yy)

    noise = ReplayNoise(jax_noise_schedule(key, y.shape[:-1], 0))
    got, nfe = picard_sample(POUVE(), score, tt(y), N=N, sweeps=sweeps, eps=EPS, noise=noise)
    assert noise.exhausted() and nfe == int(jnfe) == sweeps * N + 1
    assert [rows for rows, _ in calls] == [N * 2] * sweeps + [2]
    ts = np.linspace(1.0, EPS, N + 1, dtype=np.float32)
    np.testing.assert_array_equal(calls[0][1].numpy(), np.repeat(ts[:N], 2))
    assert_close_rel(got.numpy(), np.asarray(want), 1e-5, f"picard, {sweeps} sweeps")


def test_picard_with_n_sweeps_is_euler():
    """Picard iteration of explicit Euler is exact after N sweeps."""
    x0, y, _ = _case(6)
    N = 4
    score = _pscore(POUVE(), x0)

    def tiled(x, t, yy):
        return _pscore(POUVE(), np.tile(x0, (x.shape[0] // 2, 1, 1, 1)))(x, t, yy)

    gen = torch.Generator().manual_seed(0)
    got, _ = picard_sample(POUVE(), tiled, tt(y), N=N, sweeps=N, eps=EPS, generator=gen)
    xT = POUVE().prior_sampling(tt(y), cplx.complex_normal(
        y.shape[:-1], generator=torch.Generator().manual_seed(0)))
    want, _ = ode_sample(POUVE(), score, tt(y), N=N, method="euler", eps=EPS, x_init=xT)
    assert_close_rel(got.numpy(), want.numpy(), 1e-5, "picard N sweeps against euler")


@pytest.mark.parametrize("corrector", ["ald", "none"])
def test_pc_sample_with_etd_predictor_matches_reference(corrector):
    x0, y, _ = _case(7)
    N, key = 4, jax.random.PRNGKey(8)
    want, jnfe = jsamplers.pc_sample(key, JOUVE(), _jscore(JOUVE(), x0), jnp.asarray(y),
                                     predictor="etd", corrector=corrector, N=N, eps=EPS)
    noise = ReplayNoise(jax_noise_schedule(key, y.shape[:-1], N, "etd", corrector))
    got, nfe = pc_sample(POUVE(), _pscore(POUVE(), x0), tt(y), predictor="etd",
                         corrector=corrector, N=N, eps=EPS, noise=noise)
    assert "etd" in PREDICTORS and noise.exhausted()
    assert nfe == int(jnfe) == N * (1 + (corrector != "none"))
    assert_close_rel(got.numpy(), np.asarray(want), 1e-5, f"etd/{corrector}")


# --- refusals, with the reference's messages


class _NoTheta:
    """An SDE without a constant linear drift coefficient."""
    N, T = 4, 1.0

    def __init__(self, sde):
        self._sde = sde

    def __getattr__(self, name):
        if name == "theta":
            raise AttributeError(name)
        return getattr(self._sde, name)

    def copy(self, **kw):
        return self


def _message(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


def _deep_fns():
    def deep_fn(x, t):
        return x

    def cached(x, t, cache):
        return x
    return deep_fn, cached


@pytest.mark.parametrize("method", ["etd2-ms", "rk45"])
def test_deepcache_refusals_match_reference(method):
    _, y, _ = _case(0)
    want = _message(lambda: jsamplers.ode_sample(
        jax.random.PRNGKey(0), JOUVE(), None, jnp.asarray(y), N=2, method=method,
        deepcache=2, deep_fn=_deep_fns()[0], cached_score_fn=_deep_fns()[1]))
    got = _message(lambda: ode_sample(POUVE(), None, tt(y), N=2, method=method,
                                      deepcache=DeepCache(2, *_deep_fns())))
    assert got == want and method in got
    model = pbuild(dict(STORM_TINY), device="cpu")
    assert _message(lambda: check_deepcache_config(model.score_net, 2, "ode",
                                                   method=method)) == want
    # enhance refuses before any work: the denoiser never runs
    with mock.patch.object(model, "forward_denoiser", side_effect=AssertionError("ran")):
        assert _message(lambda: model.enhance(torch.zeros(1, 1024), N=2, sampler_type="ode",
                                              method=method, deepcache=2)) == want


def test_picard_deepcache_refusal_matches_reference():
    net = pbuild(dict(STORM_TINY), device="cpu").score_net
    want = _message(lambda: jcheck_deepcache(None, 3, "picard"))
    assert _message(lambda: check_deepcache_config(net, 3, "picard")) == want
    model = pbuild(dict(STORM_TINY), device="cpu")
    assert _message(lambda: model.enhance(torch.zeros(1, 1024), N=2, sampler_type="picard",
                                          deepcache=3)) == want


@pytest.mark.parametrize("method", ["etd1", "etd2", "etd2-ms"])
def test_etd_without_theta_is_refused_as_the_reference(method):
    _, y, xT = _case(0)
    want = _message(lambda: jsamplers.ode_sample(
        jax.random.PRNGKey(0), _NoTheta(JOUVE()), None, jnp.asarray(y), N=2, method=method,
        x_init=jnp.asarray(xT)))
    got = _message(lambda: ode_sample(_NoTheta(POUVE()), None, tt(y), N=2, method=method,
                                      x_init=tt(xT)))
    assert got.replace("_NoTheta", "") == want.replace("_NoTheta", "")


def test_etd_predictor_without_theta_is_refused_as_the_reference():
    _, y, _ = _case(0)
    jr = JOUVE().reverse(None)
    pr = POUVE().reverse(None)
    want = _message(lambda: jpredictors.etd_update(
        type(jr)(_NoTheta(jr.forward), None), jnp.asarray(y), jnp.ones(2), jnp.asarray(y),
        jax.random.PRNGKey(0)))
    got = _message(lambda: PREDICTORS["etd"](type(pr)(_NoTheta(pr.forward), None), tt(y),
                                             torch.ones(2), tt(y), None))
    assert got == want


def test_unknown_method_and_sampler_are_refused():
    _, y, xT = _case(0)
    with pytest.raises(ValueError, match="Unknown ODE method 'midpoint'"):
        ode_sample(POUVE(), None, tt(y), N=2, method="midpoint", x_init=tt(xT))
    model = pbuild(dict(STORM_TINY), device="cpu")
    with pytest.raises(ValueError, match="sde is not a valid sampler type"):
        model.enhance(torch.zeros(1, 1024), sampler_type="sde")


# --- enhance on the tiny StoRM


@pytest.fixture(scope="module")
def pair():
    return tiny_storm_pair(seed=4)


def _jax_prior(key, shape):
    """The reference ODE's and Picard's one draw: the prior."""
    return ReplayNoise(jax_noise_schedule(key, shape, 0))


@pytest.fixture(scope="module")
def etd2_case(pair):
    """(y, key, the reference's float32 etd2 output) at N=3, 1500 samples."""
    jmodel, params, _ = pair
    y, key = wave(1500, 1)[None], jax.random.PRNGKey(2)
    want, jnfe = jmodel.make_enhance(sampler_type="ode", method="etd2", N=3)(
        params, jnp.asarray(y), key)
    assert int(jnfe) == 1 + 2 * 3 + 1
    return y, key, np.asarray(want)


def test_enhance_ode_matches_reference(pair, etd2_case):
    """The CLI's default method; the others are held on the analytic score."""
    y, key, want = etd2_case
    noise = _jax_prior(key, (1, F, 128))
    got, nfe = pair[2].enhance(tt(y), N=3, sampler_type="ode", method="etd2", noise=noise)
    assert noise.exhausted() and nfe == 1 + 2 * 3 + 1
    assert_close_rel(got.numpy(), want, 1e-4, "enhance ode etd2")


def test_enhance_picard_matches_reference(pair):
    """Picard through the model: the conditioning tiled to N x B rows."""
    jmodel, params, pmodel = pair
    N, sweeps, key = 3, 2, jax.random.PRNGKey(6)
    y = np.stack([wave(900, 2), wave(900, 3)])
    want, jnfe = jmodel.make_enhance(sampler_type="picard", sweeps=sweeps, N=N)(
        params, jnp.asarray(y), key)
    noise = _jax_prior(key, (2, F, 64))
    got, nfe = pmodel.enhance(tt(y), N=N, sampler_type="picard", sweeps=sweeps, noise=noise)
    assert noise.exhausted() and nfe == int(jnfe) == 1 + sweeps * N + 1
    assert_close_rel(got.numpy(), np.asarray(want), 1e-4, "enhance picard")


def test_enhance_ode_etd2_dc3_matches_reference(pair):
    jmodel, params, pmodel = pair
    N, T, key = 4, 700, jax.random.PRNGKey(3)
    y = wave(T, 4)[None]
    want, jnfe = jmodel.make_enhance(sampler_type="ode", method="etd2", N=N, deepcache=3)(
        params, jnp.asarray(y), key)
    noise = _jax_prior(key, (1, F, 64))
    got, nfe = pmodel.enhance(tt(y), N=N, sampler_type="ode", method="etd2", deepcache=3,
                              noise=noise)
    assert noise.exhausted() and nfe == int(jnfe) == 1 + 2 * N + 1
    assert_close_rel(got.numpy(), np.asarray(want), 1e-4, "enhance ode etd2 dc3")


@pytest.mark.parametrize("method", ["euler", "etd1"])
def test_deepcache1_single_evaluation_methods_are_exact(pair, method):
    _, _, pmodel = pair
    y = torch.from_numpy(wave(1200, 5)[None])
    runs = [pmodel.enhance(y, N=3, sampler_type="ode", method=method, deepcache=dc,
                           generator=torch.Generator().manual_seed(1)) for dc in (0, 1)]
    assert runs[0][1] == runs[1][1] == 1 + 3 + 1
    torch.testing.assert_close(runs[1][0], runs[0][0], rtol=0, atol=0)


def test_ode_refresh_schedule_and_stage_reads():
    """The cache is made at (x(T), T) and refreshed at the top of every
    step i with i % K == 0, i > 0; both of etd2's evaluations read the
    newest cache; the denoising step calls the exact score."""
    events = []

    def deep_fn(x, t):
        events.append(("refresh", round(float(t[0]), 4)))
        return len([e for e in events if e[0] == "refresh"])

    def cached(x, t, cache):
        events.append(("eval", cache))
        return torch.zeros_like(x)

    def exact(x, t, y):
        events.append(("exact",))
        return torch.zeros_like(x)

    _, y, xT = _case(0)
    N, K = 5, 2
    ode_sample(POUVE(), exact, tt(y), N=N, method="etd2", x_init=tt(xT),
               deepcache=DeepCache(K, deep_fn, cached))
    ts = [round(t, 4) for t in np.linspace(1.0, EPS, N + 1, dtype=np.float32).tolist()]
    want, cache = [], 0
    for i in range(N):
        if i % K == 0:
            cache += 1
            want.append(("refresh", ts[i]))
        want += [("eval", cache)] * 2
    assert events == want + [("exact",)]


def test_ode_draws_one_prior_from_the_generator(pair):
    """An ODE or Picard call takes the prior's noise and nothing more: the
    generator's next draw is the one after a prior's worth."""
    _, _, pmodel = pair
    y = torch.from_numpy(wave(1000, 6)[None])
    for kw in (dict(sampler_type="ode", method="etd2"), dict(sampler_type="picard", sweeps=1),
               dict(sampler_type="ode", method="rk45", rtol=1e-2, atol=1e-2)):
        gen = torch.Generator().manual_seed(9)
        pmodel.enhance(y, N=2, generator=gen, **kw)
        ref = torch.Generator().manual_seed(9)
        cplx.complex_normal((1, F, 64), generator=ref)
        assert torch.equal(torch.randn(8, generator=gen), torch.randn(8, generator=ref)), kw


def test_enhance_ode_bf16_in_ratio_form(pair, etd2_case):
    """etd2 at N=3 in bfloat16 against the reference's in bfloat16, with its
    prior replayed: the port and the reference part by bfloat16's own noise
    (RATIO), and the port's bfloat16 run parts from its float32 run
    (REALLY)."""
    _, params, pmodel = pair
    y, key, want_f32 = etd2_case
    config = dict(STORM_TINY, dtype="bfloat16")
    want, _ = jbuild(dict(config)).make_enhance(sampler_type="ode", method="etd2", N=3)(
        params, jnp.asarray(y), key)
    runs = {}
    for dtype, model in (("float32", pmodel), ("bfloat16", pbuild(config, device="cpu"))):
        model.load_state_dict(pmodel.state_dict(), strict=True)
        got, nfe = model.enhance(tt(y), N=3, sampler_type="ode", method="etd2",
                                 noise=_jax_prior(key, (1, F, 128)))
        assert nfe == 1 + 2 * 3 + 1 and got.dtype == torch.float32
        runs[dtype] = got.numpy()
    against_ref, really = _ratios(runs["bfloat16"], runs["float32"], np.asarray(want), want_f32)
    assert against_ref <= RATIO, against_ref
    assert really >= REALLY, really


def test_ode_methods_list_matches_the_reference_cli():
    assert samplers.ODE_METHODS == ("euler", "heun", "rk4", "etd1", "etd2", "etd2-ms", "rk45")


# --- the CLI, the server and the enhancer's asynchronous path


@pytest.fixture(scope="module")
def tiny_files(tmp_path_factory, pair):
    root = tmp_path_factory.mktemp("ode")
    ckpt = str(root / "tiny.pt")
    save_checkpoint(ckpt, STORM_TINY, pair[2].state_dict())
    noisy = root / "noisy"
    noisy.mkdir()
    lengths = {"a.wav": 900, "b.wav": 1531}
    for name, n in lengths.items():
        save_wav(str(noisy / name), wave(n, n))
    return ckpt, str(noisy), lengths


@pytest.mark.parametrize("extra,nfe", [
    (["--sampler", "ode"], 1 + 2 * 2 + 1),
    (["--sampler", "ode", "--ode-method", "rk4", "--batch", "2"], 1 + 4 * 2 + 1),
    (["--sampler", "ode", "--deepcache", "2", "--stream_chunk_s", "0.05",
      "--stream_overlap_s", "0.01"], None),
    (["--sampler", "ode", "--ode-method", "rk45", "--rtol", "1e-2", "--atol", "1e-2"], None),
    (["--sampler", "picard", "--sweeps", "2"], 1 + 2 * 2 + 1),
    (["--predictor", "etd", "--corrector", "none"], 1 + 2)],
    ids=["etd2", "rk4-batch", "etd2-dc2-stream", "rk45", "picard", "pc-etd"])
def test_cli_samplers(tiny_files, tmp_path, capsys, extra, nfe):
    """Every file written, finite, of its length; the NFE each call reports."""
    ckpt, noisy, lengths = tiny_files
    out = tmp_path / "out"
    enhancement.main(["--test_dir", noisy, "--enhanced_dir", str(out), "--ckpt", ckpt,
                      "--mode", "storm", "--N", "2", "--device", "cpu", "--timeit", *extra])
    text = capsys.readouterr().out
    for name, n in lengths.items():
        x, sr = load_wav(str(out / name))
        assert sr == 16000 and x.shape == (1, n) and np.isfinite(x).all()
    nfes = {int(v) for v in re.findall(r"nfe=(\d+)", text)}
    assert nfes and (nfe is None or nfes == {nfe}), text
    if "rk45" in extra:
        assert all((v - 4) % 6 == 0 for v in nfes), nfes  # 1 + 2 + 6 x attempts + 1


def test_cli_refuses_deepcache_with_rk45(tiny_files, tmp_path):
    ckpt, noisy, _ = tiny_files
    with pytest.raises(ValueError, match="adaptive 'rk45'"):
        enhancement.main(["--test_dir", noisy, "--enhanced_dir", str(tmp_path / "o"), "--ckpt",
                          ckpt, "--mode", "storm", "--device", "cpu", "--sampler", "ode",
                          "--ode-method", "rk45", "--deepcache", "2"])


def test_server_refuses_deepcache_with_etd2_ms_at_build(tiny_files):
    """With no warm-up to run the sampler, the build itself refuses."""
    ckpt, _, _ = tiny_files
    args = serve.build_argparser().parse_args(
        ["--ckpt", ckpt, "--mode", "storm", "--N", "2", "--port", "0", "--device", "cpu",
         "--sampler", "ode", "--ode-method", "etd2-ms", "--deepcache", "3", "--warmup_s", "0"])
    with pytest.raises(ValueError, match="multistep 'etd2-ms'"):
        serve.build_server(args)


def test_server_serves_the_ode_sampler(tiny_files):
    ckpt, _, _ = tiny_files
    args = serve.build_argparser().parse_args(
        ["--ckpt", ckpt, "--mode", "storm", "--N", "2", "--port", "0", "--device", "cpu",
         "--batch", "2", "--sampler", "ode", "--ode-method", "heun", "--warmup_buckets", "0.05"])
    httpd, batcher = serve.build_server(args)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        assert batcher.enhancer.supports_async
        host, port = httpd.server_address[:2]
        conn = http.client.HTTPConnection(host, port, timeout=60)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        assert (health["sampler"], health["ode_method"]) == ("ode", "heun")
        conn.request("POST", "/enhance", body=encode_wav_bytes(wave(1500, 3)))
        r = conn.getresponse()
        assert r.status == 200 and int(r.getheader("X-NFE")) == 1 + 2 * 2 + 1
        x, _ = decode_wav_bytes(r.read())
        assert x.shape == (1, 1500) and np.isfinite(x).all()
        conn.close()
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
        thread.join(timeout=60)
    with pytest.raises(SystemExit):  # the server offers no rk45, as the reference's
        serve.build_argparser().parse_args(["--ckpt", ckpt, "--mode", "storm", "--sampler",
                                            "ode", "--ode-method", "rk45"])


def test_enhance_async_takes_every_sampler_but_rk45(pair):
    _, _, pmodel = pair
    y = wave(900, 8)[None]
    for kw in (dict(sampler_type="ode", method="etd2"), dict(sampler_type="picard", sweeps=1)):
        enh = BucketedEnhancer(pmodel, N=2, **kw)
        x, nfe = enh.enhance_async(y, torch.Generator().manual_seed(0))
        assert enh.supports_async and x.shape == (1, 1024) and nfe == 1 + 2 * (1 + (
            kw["sampler_type"] == "ode")) + 1
    enh = BucketedEnhancer(pmodel, N=2, sampler_type="ode", method="rk45")
    assert not enh.supports_async
    with pytest.raises(NotImplementedError, match="rk45"):
        enh.enhance_async(y, torch.Generator().manual_seed(0))
