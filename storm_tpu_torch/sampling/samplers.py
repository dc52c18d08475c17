"""Reverse-diffusion samplers (counterpart of storm_tpu/sampling/samplers.py):
predictor-corrector sampling (`pc_sample`), the probability-flow ODE
(`ode_sample`, with the adaptive `dopri45_integrate`) and parallel-in-time
Picard iteration of the ODE (`picard_sample`).

The reference runs each loop as one `lax.scan` (or `lax.while_loop`) on the
device; here it is a Python loop over eager PyTorch calls. Noise comes from
an injectable source `noise(shape) -> tensor of shape + (2,)`, drawn in the
reference's order: the prior first, then for each step the corrector's
draws and then the predictor's. The ODE samplers draw the prior only.

With a `DeepCache` of interval K the score net's deep features are cached
(DeepCache-style serving, arXiv:2312.00858): made before the loop at the
prior, refreshed at the top of every K-th step, and every score evaluation
of the step recomputes only the top levels from the cache. Whether a step
refreshes is decided on the host from the step's index, so the loop reads
no device value and uploads nothing (Picard's grid is a cached device
constant): every sampler but rk45 is captured whole in a CUDA graph
(`utils/graphs.py`), and `BucketedEnhancer.enhance_async` and the server's
pipelined finalizer rely on it enqueueing without a sync.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..signal import cplx
from ..utils.tensors import host_constant, right_pad_dims
from .correctors import CORRECTORS
from .predictors import PREDICTORS

NoiseSource = Callable[[tuple], torch.Tensor]


def generator_noise(generator: Optional[torch.Generator], device, dtype=torch.float32) -> NoiseSource:
    """The default noise source: standard complex normal from `generator`."""
    def draw(shape):
        return cplx.complex_normal(shape, generator=generator, device=device, dtype=dtype)
    return draw


class DeepCache:
    """Deep-feature caching for one sampler call: the refresh interval,
    `deep_fn(x, t) -> cache` and `cached_score_fn(x, t, cache) -> score`
    (other conditioning closed over), and the cache the step's score
    evaluations read, which `refresh` replaces."""

    def __init__(self, interval: int, deep_fn: Callable, cached_score_fn: Callable):
        self.interval, self.deep_fn, self.cached_score_fn = interval, deep_fn, cached_score_fn
        self.cache = None

    def refresh(self, x: torch.Tensor, t: torch.Tensor) -> None:
        self.cache = self.deep_fn(x, t)

    def score_fn(self, x: torch.Tensor, t: torch.Tensor, y_sde: torch.Tensor) -> torch.Tensor:
        return self.cached_score_fn(x, t, self.cache)


def pc_sample(
    sde,
    score_fn: Callable,
    y: torch.Tensor,
    predictor: str = "reverse_diffusion",
    corrector: str = "ald",
    N: Optional[int] = None,
    snr: float = 0.5,
    corrector_steps: int = 1,
    probability_flow: bool = False,
    denoise: bool = True,
    eps: float = 3e-2,
    noise: Optional[NoiseSource] = None,
    generator: Optional[torch.Generator] = None,
    intermediate: bool = False,
    deepcache: Optional[DeepCache] = None,
):
    """Predictor-corrector sampling of the reverse SDE started at p_T(.|y).

    Args:
        score_fn: `(x, t, y) -> score`, packed-real; other conditioning is
            closed over.
        y: SDE steady-state input, packed-real (B, ..., 2).
        N: reverse steps (replaces sde.N).
        denoise: return the noise-free mean of the last predictor step.
        noise: noise source; by default drawn from `generator`.
        intermediate: also return the (N, ...) trajectory of the predictor's
            means, one per step.
        deepcache: if given, its cache is made at the prior and refreshed
            at the top of every `deepcache.interval`-th step, and every
            score evaluation reads it (`score_fn` is not called). With
            interval 1 and no corrector the trajectory is exact (the cache
            is made at the very (x, t) the predictor evaluates). Refreshes
            are not counted in nfe, as in the reference.

    Returns:
        (x, nfe), nfe = N * (corrector_steps * (corrector != "none") + 1);
        (x, trajectory, nfe) with `intermediate`.
    """
    if N is not None and N != sde.N:
        sde = sde.copy(N=N)
    n = sde.N
    predictor_fn = PREDICTORS[predictor]
    corrector_fn = CORRECTORS[corrector]
    if noise is None:
        noise = generator_noise(generator, y.device, y.dtype)

    x = sde.prior_sampling(y, noise(y.shape[:-1]))
    x_mean = x
    timesteps = torch.linspace(sde.T, eps, n, dtype=torch.float32).tolist()
    batch = y.shape[0]

    def vector(t: float) -> torch.Tensor:
        return torch.full((batch,), t, dtype=torch.float32, device=y.device)

    if deepcache is not None:
        deepcache.refresh(x, vector(timesteps[0]))
        score_fn = deepcache.score_fn
    rsde = sde.reverse(score_fn, probability_flow=probability_flow)
    trajectory = []
    # one step body for both modes: the draws' order cannot part between them
    for i, t in enumerate(timesteps):
        vec_t = vector(t)
        if deepcache is not None and i % deepcache.interval == 0 and i > 0:
            deepcache.refresh(x, vec_t)
        x, x_mean = corrector_fn(sde, score_fn, x, vec_t, y, noise, snr, corrector_steps)
        x, x_mean = predictor_fn(rsde, x, vec_t, y, noise)
        if intermediate:
            trajectory.append(x_mean)
    nfe = n * (corrector_steps * (corrector != "none") + 1)
    if intermediate:
        return (x_mean if denoise else x), torch.stack(trajectory), nfe
    return (x_mean if denoise else x), nfe


# --- the probability-flow ODE ------------------------------------------------

f32 = np.float32

# Dormand-Prince 5(4), the tableau of scipy.integrate.RK45: 6 fresh
# evaluations per attempted step and FSAL (the 7th stage of an accepted step
# is the first of the next)
_DP_C = (0.2, 0.3, 0.8, 8.0 / 9.0, 1.0)
_DP_A = (
    (1.0 / 5.0,),
    (3.0 / 40.0, 9.0 / 40.0),
    (44.0 / 45.0, -56.0 / 15.0, 32.0 / 9.0),
    (19372.0 / 6561.0, -25360.0 / 2187.0, 64448.0 / 6561.0, -212.0 / 729.0),
    (9017.0 / 3168.0, -355.0 / 33.0, 46732.0 / 5247.0, 49.0 / 176.0, -5103.0 / 18656.0),
)
_DP_B = (35.0 / 384.0, 0.0, 500.0 / 1113.0, 125.0 / 192.0, -2187.0 / 6784.0, 11.0 / 84.0)
_DP_E = (71.0 / 57600.0, 0.0, -71.0 / 16695.0, 71.0 / 1920.0, -17253.0 / 339200.0,
         22.0 / 525.0, -1.0 / 40.0)
_RK_SAFETY, _RK_MIN_FACTOR, _RK_MAX_FACTOR = f32(0.9), f32(0.2), f32(10.0)
_RK_ERR_EXP = f32(-0.2)  # -1 / (error estimator order + 1), order 4


def _rms(v: torch.Tensor) -> np.float32:
    """sqrt(mean(v^2)) in float32, read to the host (a device sync)."""
    return f32(torch.sqrt(torch.mean(torch.square(v.float()))).item())


def dopri45_integrate(drift_fn: Callable, x0: torch.Tensor, t0: float, t1: float,
                      rtol: float = 1e-5, atol: float = 1e-5, max_steps: int = 1000):
    """Integrate dx/dt = drift_fn(x, t) (t a float) from t0 to t1 with the
    Dormand-Prince 5(4) pair and scipy's step-size controller
    (scipy/integrate/_ivp/rk.py): the error is the RMS over the whole state
    (the batch included, as the reference flattens it into one scipy
    vector) of the elementwise error scaled by atol + rtol * max(|x|,
    |x_new|); an accepted step grows by SAFETY * norm^-1/5, at most 10x and
    not at all straight after a rejection; a rejected one shrinks by the
    same rule, at least to 0.2x. The first step is scipy's
    `select_initial_step`. Time, step and controller run in float32 on the
    host, as the reference's do on the device, so that both take the same
    steps.

    The loop runs on the host and reads the error norm of every attempted
    step: one device sync per 6 drift evaluations (and three to choose the
    first step). Its step count depends on the data, so a CUDA graph cannot
    capture it and `BucketedEnhancer.enhance_async` refuses it.

    Returns (x(t1), nfe, accepted steps), nfe = 2 + 6 x attempted steps.
    """
    direction = f32(1.0 if t1 >= t0 else -1.0)
    t0, t1 = f32(t0), f32(t1)
    rtol, atol = f32(rtol), f32(atol)

    f0 = drift_fn(x0, t0)
    scale0 = float(atol) + float(rtol) * x0.float().abs()
    d0, d1 = _rms(x0.float() / scale0), _rms(f0.float() / scale0)
    h0 = f32(1e-6) if min(d0, d1) < f32(1e-5) else f32(0.01) * d0 / d1
    f_probe = drift_fn(x0 + float(h0 * direction) * f0, t0 + h0 * direction)
    d2 = _rms((f_probe - f0).float() / scale0) / h0
    h1 = (max(f32(1e-6), h0 * f32(1e-3)) if max(d1, d2) <= f32(1e-15)
          else (f32(0.01) / max(d1, d2)) ** f32(0.2))
    h_abs = min(min(f32(100.0) * h0, h1), abs(t1 - t0))

    t, x, k1 = t0, x0, f0
    nfe, n_acc, n_att, rejected = 2, 0, 0, False
    while (t1 - t) * direction > f32(1e-10) and n_att < max_steps:
        h_abs = min(h_abs, abs(t1 - t))  # never past t1
        h = f32(h_abs * direction)
        ks = [k1]
        for c, arow in zip(_DP_C, _DP_A):
            xs = x
            for a, kk in zip(arow, ks):
                xs = xs + float(h * f32(a)) * kk
            ks.append(drift_fn(xs, t + f32(c) * h))
        x_new = x
        for b, kk in zip(_DP_B, ks):
            x_new = x_new + float(h * f32(b)) * kk
        ks.append(drift_fn(x_new, t + h))

        err = torch.zeros_like(x, dtype=torch.float32)
        for e, kk in zip(_DP_E, ks):
            err = err + float(f32(e)) * kk.float()
        scale = float(atol) + float(rtol) * torch.maximum(x.float().abs(), x_new.float().abs())
        err_norm = _rms(float(h) * err / scale)

        accept = bool(err_norm <= f32(1.0))
        factor = (_RK_SAFETY * err_norm ** _RK_ERR_EXP if err_norm > f32(0.0)
                  else f32(np.inf))
        grow = min(_RK_MAX_FACTOR, factor)
        if rejected:
            grow = min(f32(1.0), grow)
        shrink = max(_RK_MIN_FACTOR, factor)
        h_abs = f32(h_abs * (grow if accept else shrink))
        if accept:
            t, x, k1 = f32(t + h), x_new, ks[-1]
        nfe, n_acc, n_att, rejected = nfe + 6, n_acc + int(accept), n_att + 1, not accept
    return x, nfe, n_acc


ODE_METHODS = ("euler", "heun", "rk4", "etd1", "etd2", "etd2-ms", "rk45")


def _denoise_mean(sde, score_fn, x, y, eps: float) -> torch.Tensor:
    """The mean of one reverse-diffusion predictor step at t = eps (the
    reference's final denoising step): its noise is not drawn, so an ODE
    call takes no noise from the source beyond the prior."""
    rsde = sde.reverse(score_fn, probability_flow=False)
    vec_eps = torch.full((y.shape[0],), eps, dtype=torch.float32, device=y.device)
    f, _ = rsde.discretize(x, vec_eps, y)
    return x - f


def check_deepcache_method(method: str) -> None:
    """Refuse the ODE methods a deep-feature cache cannot serve, with the
    reference's messages."""
    if method in ("etd2-ms", "rk45"):
        raise ValueError(
            "deepcache does not support the "
            + ("multistep 'etd2-ms' method (stale features would compound "
               "through the AB2 history); use method='etd2'"
               if method == "etd2-ms" else
               "adaptive 'rk45' method (the error estimate would measure "
               "cache staleness, not integration error, and drive the step "
               "controller); use a fixed-step method"))


def ode_sample(
    sde,
    score_fn: Callable,
    y: torch.Tensor,
    N: Optional[int] = None,
    method: str = "heun",
    denoise: bool = True,
    eps: float = 3e-2,
    deepcache: Optional[DeepCache] = None,
    x_init: Optional[torch.Tensor] = None,
    rtol: float = 1e-5,
    atol: float = 1e-5,
    max_steps: int = 1000,
    noise: Optional[NoiseSource] = None,
    generator: Optional[torch.Generator] = None,
):
    """Probability-flow ODE sampling from p_T(.|y) on the float32 grid
    linspace(T, eps, N + 1), then (with `denoise`) the mean of one
    reverse-diffusion step at eps.

    Methods: `euler`, `heun`, `rk4`; `etd1` and `etd2` (exponential Euler
    and Cox-Matthews ETD2RK), which integrate the OUVE drift's linear part
    theta (y - x) exactly over each step and approximate only the score
    term; `etd2-ms`, exponential Adams-Bashforth-2 (one evaluation per step
    after an ETD2RK first step); `rk45`, the adaptive `dopri45_integrate`
    from T to eps under `rtol` / `atol` (N sets only the denoising step
    there). The etd methods need an SDE with `theta`.

    `x_init`: the start state x(T) in place of the prior draw (no noise is
    drawn then). `deepcache`: its cache is made at (x(T), T) and refreshed
    at the top of every `interval`-th step (i > 0) at that step's (x, t);
    every evaluation of a step, the later stages of heun, rk4 and etd2
    included, reads it. With interval 1, euler and etd1 give the exact
    trajectory; `etd2-ms` and `rk45` refuse it. The denoising step calls
    `score_fn` itself.

    Returns (x, nfe): nfe is N x {euler 1, heun 2, rk4 4, etd1 1, etd2 2},
    N + 1 for etd2-ms, 2 + 6 x attempts for rk45, plus 1 for the denoising
    step; cache refreshes are not counted.
    """
    if N is not None and N != sde.N:
        sde = sde.copy(N=N)
    n = sde.N
    batch = y.shape[0]
    if method not in ODE_METHODS:
        raise ValueError(f"Unknown ODE method {method!r}")
    if deepcache is not None:
        check_deepcache_method(method)
    if method.startswith("etd") and not hasattr(sde, "theta"):
        raise ValueError(f"{method} requires an SDE with constant linear drift "
                         "(OUVE); got " + type(sde).__name__)
    if x_init is None:
        if noise is None:
            noise = generator_noise(generator, y.device, y.dtype)
        x = sde.prior_sampling(y, noise(y.shape[:-1]))
    else:
        x = x_init
    ts = np.linspace(sde.T, eps, n + 1, dtype=np.float32)

    def vector(t) -> torch.Tensor:
        return torch.full((batch,), float(t), dtype=torch.float32, device=y.device)

    def drift(sf, x, t):
        return sde.reverse(sf, probability_flow=True).sde(x, vector(t), y)[0]

    # dx/dt = a x + nonlinear(x, t) with a = -theta, the OUVE linear part
    theta = getattr(sde, "theta", None)
    a = None if theta is None else f32(-theta)

    def nonlinear(sf, x, t):
        vec_t = vector(t)
        g2 = right_pad_dims(sde.sde(x, vec_t, y)[1] ** 2, x)
        return theta * y - 0.5 * g2 * sf(x, vec_t, y)

    def etd_coefficients(dt):
        ea = np.exp(a * dt)
        return ea, (ea - f32(1.0)) / a, (ea - f32(1.0) - a * dt) / (a * a * dt)

    # one step body per method over (sf, x, i), sf the score this step reads
    def step(sf, x, i):
        t0, t1 = ts[i], ts[i + 1]
        dt = t1 - t0
        if method == "euler":
            return x + float(dt) * drift(sf, x, t0)
        if method == "heun":
            d0 = drift(sf, x, t0)
            d1 = drift(sf, x + float(dt) * d0, t1)
            return x + float(dt * f32(0.5)) * (d0 + d1)
        if method == "rk4":
            tm, half = t0 + f32(0.5) * dt, float(f32(0.5) * dt)
            k1 = drift(sf, x, t0)
            k2 = drift(sf, x + half * k1, tm)
            k3 = drift(sf, x + half * k2, tm)
            k4 = drift(sf, x + float(dt) * k3, t1)
            return x + float(dt / f32(6.0)) * (k1 + 2 * k2 + 2 * k3 + k4)
        ea, phi1, phi2 = (float(c) for c in etd_coefficients(dt))
        n0 = nonlinear(sf, x, t0)
        x_pred = ea * x + phi1 * n0
        if method == "etd1":
            return x_pred
        return x_pred + phi2 * (nonlinear(sf, x_pred, t1) - n0)  # etd2

    if method == "rk45":
        x, nfe, _ = dopri45_integrate(lambda xx, tt: drift(score_fn, xx, tt), x,
                                      float(sde.T), eps, rtol=rtol, atol=atol,
                                      max_steps=max_steps)
    elif method == "etd2-ms":
        # x_{k+1} = e^{a dt} x_k + phi1 N_k + phi2 (N_k - N_{k-1}) on the
        # uniform grid, the first step by ETD2RK
        ea, phi1, phi2 = (float(c) for c in etd_coefficients(ts[1] - ts[0]))
        n0 = nonlinear(score_fn, x, ts[0])
        x_pred = ea * x + phi1 * n0
        n_prev = nonlinear(score_fn, x_pred, ts[1])
        x = x_pred + phi2 * (n_prev - n0)
        for i in range(1, n):
            nk = nonlinear(score_fn, x, ts[i])
            x = ea * x + phi1 * nk + phi2 * (nk - n_prev)
            n_prev = nk
        nfe = n + 1
    else:
        sf = score_fn
        if deepcache is not None:
            deepcache.refresh(x, vector(ts[0]))
            sf = deepcache.score_fn
        for i in range(n):
            if deepcache is not None and i % deepcache.interval == 0 and i > 0:
                deepcache.refresh(x, vector(ts[i]))
            x = step(sf, x, i)
        nfe = n * {"euler": 1, "heun": 2, "rk4": 4, "etd1": 1, "etd2": 2}[method]

    if denoise:
        x = _denoise_mean(sde, score_fn, x, y, eps)
        nfe += 1
    return x, nfe


def time_major(v: torch.Tensor, n: int) -> torch.Tensor:
    """(B, ...) -> (n B, ...), row i B + b a copy of row b: Picard's layout
    of n grid points folded into the batch."""
    return v.repeat((n,) + (1,) * (v.ndim - 1))


def _picard_steps(T: float, eps: float, n: int) -> np.ndarray:
    """The n float32 steps of the grid linspace(T, eps, n + 1)."""
    ts = np.linspace(T, eps, n + 1, dtype=np.float32)
    return ts[1:] - ts[:-1]


def _picard_times(T: float, eps: float, n: int, B: int) -> np.ndarray:
    """The grid's first n times, each repeated for the B rows of its block."""
    return np.repeat(np.linspace(T, eps, n + 1, dtype=np.float32)[:n], B)


def picard_sample(
    sde,
    score_fn: Callable,
    y: torch.Tensor,
    N: Optional[int] = None,
    sweeps: int = 8,
    denoise: bool = True,
    eps: float = 3e-2,
    noise: Optional[NoiseSource] = None,
    generator: Optional[torch.Generator] = None,
    wide_score_fn: Optional[Callable] = None,
):
    """Parallel-in-time probability-flow sampling by Picard iteration of
    explicit Euler (ParaDiGMS-style, arXiv:2305.16317).

    Each sweep evaluates the drift at all N grid points in one call, time
    folded into the batch: N x B rows laid out by `time_major`. The
    sweeps call `wide_score_fn` (default `score_fn`) on those rows, so a
    score with conditioning of B rows gets it through `time_major` too;
    the denoising step calls `score_fn` on B rows. The trajectory is then
    rebuilt from the prior by a cumulative sum of the Euler increments.
    Exact after N sweeps; a call costs `sweeps` wide evaluations instead
    of N sequential ones, and N times a sequential call's activation
    memory.

    Returns (x, nfe), nfe = sweeps x N, plus 1 for the denoising step.
    """
    if N is not None and N != sde.N:
        sde = sde.copy(N=N)
    n = sde.N
    B = y.shape[0]
    if noise is None:
        noise = generator_noise(generator, y.device, y.dtype)
    x0 = sde.prior_sampling(y, noise(y.shape[:-1]))
    grid = (float(sde.T), float(eps), n)
    dts = host_constant(_picard_steps, grid, y.device).reshape((n,) + (1,) * x0.ndim)
    t_all = host_constant(_picard_times, grid + (B,), y.device)  # (n B,), time-major
    y_all = time_major(y, n)
    rsde = sde.reverse(wide_score_fn or score_fn, probability_flow=True)

    X = x0.expand((n,) + x0.shape)
    last = None
    for _ in range(sweeps):
        D = rsde.sde(X.reshape((n * B,) + x0.shape[1:]), t_all, y_all)[0]
        incr = torch.cumsum(dts * D.reshape((n,) + x0.shape), dim=0)
        # x_i = x0 + sum_{j<i} dt_j d_j; x_0 stays the prior draw
        X = torch.cat([x0[None], x0 + incr[:-1]], dim=0)
        last = incr[-1]
    x = x0 + last
    nfe = sweeps * n

    if denoise:
        x = _denoise_mean(sde, score_fn, x, y, eps)
        nfe += 1
    return x, nfe
