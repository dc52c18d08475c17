"""The one-step distilled student against the reference's `DistilledModel`:
the marginal mean factor (OUVE and OUVP), the one-step map at teacher
initialisation, the distillation loss (euler and etd2 teachers at N=2, with
and without the clean-target term), one `train_step` against
`make_train_step`, `enhance` at NFE 2 in float32 and bfloat16, the int8
calibration and its scale file, the refusals, and the factory.

Tiny nets (nf 8, ch_mult (1, 1), n_fft 62 -> 32 bins), weights made with
numpy from a seed and carried across by convert.py; the student and the
teacher get different weights, so the loss is far from zero. The reference's
noise is replayed: the loss's key splits into (kz, kd), z from kz and kd
unused (the teacher's ODE starts at x_init and draws nothing); `enhance`
draws its one z from the key itself. Tolerances: the mean factor 1e-6
relative (float32 exp); the one-step map 1e-5 of its scale (the score's
tolerance, test_torch_score); losses 1e-5 relative (float32 sums over a
teacher ODE of 2-4 forwards); after one Adam step the parameters and the EMA
1e-6 absolute, except where a gradient is rounding noise (2 lr, ROADMAP
Queue 3), and the denoiser bit for bit; `enhance` 1e-4 of the output's
scale in float32 (test_torch_storm), bfloat16 in the ratio form of
test_torch_bf16; the calibration's scales 1e-4 relative (test_torch_quant).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bf16 import RATIO, REALLY
from test_torch_inference import wave
from test_torch_quant import _by_module
from torch_parity import ReplayNoise, assert_close_rel, random_params, to_numpy_tree, tt

from storm_tpu.models import quant as jquant
from storm_tpu.models.base import init_train_state as jinit_state
from storm_tpu.models.base import make_optimizer as jmake_optimizer
from storm_tpu.models.distill import _mean_factor as jmean_factor
from storm_tpu.models.factory import build_model as jbuild
from storm_tpu.signal import cplx as jcplx
from storm_tpu_torch.convert import params_from_jax
from storm_tpu_torch.models import quant as pquant
from storm_tpu_torch.models.base import init_train_state
from storm_tpu_torch.models.distill import DEEPCACHE_REFUSAL, DistilledModel, _mean_factor
from storm_tpu_torch.models.factory import build_model as pbuild
from storm_tpu_torch.models.storm import StochasticRegenerationModel
from storm_tpu_torch.sde.sdes import OUVESDE, OUVPSDE

TEACHER = {"mode": "regen-joint-training", "nf": 8, "ch_mult": [1, 1], "init_scale": 1.0,
           "n_fft": 62, "hop_length": 16, "sde": "ouve"}
F, MIN_CH = 32, 8
B, T = 2, 32  # training batch: 2 specs of 32 x 32


def _config(**distill):
    return dict(TEACHER, mode="distill", **distill)


@pytest.fixture(scope="module")
def weights():
    """(student params, teacher params): two seeds of the same tree."""
    shapes = jax.eval_shape(lambda: jbuild(dict(TEACHER)).init_params(
        jax.random.PRNGKey(0), (1, F, 64)))
    return random_params(shapes, 0), random_params(shapes, 1)


def _pair(weights, dtype="float32", **distill):
    """(the reference student taught by the teacher's score weights, the port's)."""
    student, teacher = weights
    cfg = dict(_config(**distill), dtype=dtype)
    jmodel = jbuild(dict(cfg)).with_teacher(teacher["score"])
    pmodel = pbuild(dict(cfg), device="cpu")
    pmodel.load_state_dict(params_from_jax(student, target=pmodel), strict=True)
    teacher_sd = params_from_jax(teacher, target=pmodel)
    pmodel.with_teacher({k[len("score_net."):]: v for k, v in teacher_sd.items()
                         if k.startswith("score_net.")})
    return jmodel, pmodel


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    x = (0.3 * rng.standard_normal((B, F, T, 2))).astype(np.float32)
    y = (x + 0.2 * rng.standard_normal((B, F, T, 2))).astype(np.float32)
    return x, y


def _loss_z(key, shape):
    """The reference loss's z: its key split into (kz, kd), z from kz."""
    kz, _ = jax.random.split(key)
    return np.asarray(jcplx.complex_normal(kz, shape), np.float32)


OUVP = OUVPSDE(0.1, 1.0, 1.3)


@pytest.mark.parametrize("sde", ["ouve", "ouvp"])
@pytest.mark.parametrize("t", [1.0, 0.37])
def test_mean_factor_matches_reference(sde, t):
    if sde == "ouve":
        cfg = dict(TEACHER)
        psde = OUVESDE(1.5, 0.05, 0.5)
    else:
        cfg = dict(TEACHER, sde="ouvp", beta_min=0.1, beta_max=1.0, stiffness=1.3)
        psde = OUVP
    jsde = jbuild(cfg).sde
    assert pbuild(dict(cfg), device="cpu").sde == psde
    want = float(jmean_factor(jsde, t))
    assert abs(_mean_factor(psde, t) - want) <= 1e-6 * want, (_mean_factor(psde, t), want)
    # the factor inverts the SDE's own marginal mean at t
    x0, y = torch.ones(1, 1, 1, 2), torch.zeros(1, 1, 1, 2)
    mean = psde.marginal_prob(x0, torch.tensor([t]), y)[0]
    assert abs(float(mean[0, 0, 0, 0]) - _mean_factor(psde, t)) <= 1e-6


def test_build_wires_the_reference_config(weights):
    jmodel, pmodel = _pair(weights, distill_N=3, distill_method="heun", distill_gt_weight=0.25)
    assert isinstance(pmodel, DistilledModel) and pmodel.batch_reduction == "sum"
    assert isinstance(pmodel.storm, StochasticRegenerationModel)
    assert (pmodel.distill_N, pmodel.distill_method, pmodel.distill_gt_weight) == (
        jmodel.distill_N, jmodel.distill_method, jmodel.distill_gt_weight) == (3, "heun", 0.25)
    assert (pmodel.lr, pmodel.ema_decay) == (jmodel.lr, jmodel.ema_decay)
    assert pmodel.storm.denoiser_net is pmodel.denoiser_net
    # StoRM's state_dict, name for name and weight for weight at one seed;
    # the teacher is in neither the state_dict nor the parameters
    storm = pbuild(dict(TEACHER), device="cpu", seed=3)
    student = pbuild(_config(), device="cpu", seed=3)
    assert student.state_dict().keys() == storm.state_dict().keys()
    assert all(torch.equal(v, storm.state_dict()[k]) for k, v in student.state_dict().items())
    assert student.teacher_net is None
    n_params = len(list(pmodel.parameters()))
    assert pmodel.teacher_net is not None and n_params == len(list(storm.parameters()))
    assert not any(p.requires_grad for p in pmodel.teacher_net.parameters())
    with pytest.raises(ValueError, match="distill_method"):
        pbuild(_config(distill_method="rk45"), device="cpu")


def test_student_x0_is_the_posterior_mean_at_teacher_init(weights):
    """At student == teacher the one-step map is the Tweedie estimate
    inverted through the marginal mean (storm_tpu tests/test_distill.py:166),
    and it is the reference's map on the same inputs."""
    student, _ = weights
    jmodel, pmodel = _pair((student, student))
    x, y = _batch(9)
    z = np.asarray(jcplx.complex_normal(jax.random.PRNGKey(10), x.shape[:-1]))
    with torch.no_grad():
        y_den = pmodel.storm.forward_denoiser(tt(y))
        x_T, std_T = pmodel.prior(tt(x), y_den, tt(z))
        cond = pmodel.storm._conditioning(tt(y), y_den)
        got = pmodel._student_x0(x_T, cond, std_T, y_den)
        s = pmodel.storm.forward_score(x_T, torch.full((B,), 1.0), cond,
                                       net=pmodel.teacher_net)
    fac = _mean_factor(pmodel.sde, pmodel.sde.T)
    tweedie = y_den + (x_T + std_T[:, None, None, None] ** 2 * s - y_den) / fac
    torch.testing.assert_close(got, tweedie, rtol=0, atol=1e-5 * float(got.abs().max()))

    jy_den = jmodel.storm.forward_denoiser(student, jnp.asarray(y))
    jstd = jmodel.sde.marginal_prob(jnp.asarray(x), jnp.ones((B,)), jy_den)[1]
    jx_T = jy_den + jstd[:, None, None, None] * jnp.asarray(z)
    want = jmodel._student_x0(student, jx_T, jmodel.storm._conditioning(jnp.asarray(y), jy_den),
                              jstd, jy_den)
    assert_close_rel(got.numpy(), np.asarray(want), 1e-5, "student x0")


@pytest.mark.parametrize("method", ["euler", "etd2"])
@pytest.mark.parametrize("gt_weight", [0.0, 0.5])
def test_loss_per_example_matches_reference(weights, method, gt_weight):
    jmodel, pmodel = _pair(weights, distill_N=2, distill_method=method,
                           distill_gt_weight=gt_weight)
    x, y = _batch(1)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jax.jit(lambda p, x, y: jmodel.loss_per_example(p, key, (x, y)))(
        weights[0], jnp.asarray(x), jnp.asarray(y)))
    with torch.no_grad():
        got = pmodel.per_example_given_z((tt(x), tt(y)), tt(_loss_z(key, x.shape[:-1])))
    assert got.shape == (B,) and np.all(want > 1.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    # the batch's loss is the sum, and the generator path draws z like x
    loss, aux = pmodel.loss_fn((tt(x), tt(y)), torch.Generator().manual_seed(2))
    with torch.no_grad():
        per_ex = pmodel.loss_per_example((tt(x), tt(y)), torch.Generator().manual_seed(2))
    torch.testing.assert_close(per_ex.sum(), loss.detach(), rtol=1e-6, atol=0)
    assert set(aux) == {"loss"}


def test_train_step_matches_reference(weights):
    """One step of the reference's jitted `make_train_step` from the
    trainer's start (params and EMA at the teacher's weights) and the
    port's, with the reference's z. The denoiser gets no gradient: Adam
    leaves it bit-identical in both packages, and so does the EMA's
    warmed-up update of an unchanged parameter (d e + (1 - d) e rounds back
    to e for every denoiser weight here); the score net moves."""
    _, teacher = weights
    jmodel, pmodel = _pair((teacher, teacher), distill_N=2, distill_method="etd2")
    pmodel.train()
    x, y = _batch(2)
    key = jax.random.PRNGKey(9)
    jstate, jaux = jmodel.make_train_step(donate=False)(
        jinit_state(teacher, jmake_optimizer(jmodel.lr)), (jnp.asarray(x), jnp.asarray(y)), key)
    state = init_train_state(pmodel, pmodel.lr)
    before = {k: v.clone() for k, v in pmodel.state_dict().items()}
    aux = pmodel.compute_gradients((tt(x), tt(y)), tt(_loss_z(key, x.shape[:-1])))
    grads = {n: p.grad.clone() for n, p in pmodel.named_parameters() if p.requires_grad}
    assert all(not bool(g.any()) for n, g in grads.items() if n.startswith("denoiser_net."))
    floor = 1e-5 * max(float(g.abs().max()) for g in grads.values())
    pmodel.apply_update(state)
    np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]), rtol=1e-5)
    assert state.step == int(jstate.step) == 1
    jden = (jax.tree.leaves(jstate.params["denoiser"])
            + jax.tree.leaves(jstate.ema_params["denoiser"]))
    jden0 = jax.tree.leaves(to_numpy_tree(teacher["denoiser"])) * 2
    assert all(np.array_equal(np.asarray(a), b) for a, b in zip(jden, jden0))
    moved = 0
    for got, want in ((pmodel.state_dict(), jstate.params), (state.ema, jstate.ema_params)):
        want = params_from_jax(to_numpy_tree(want), target=pmodel)
        for name, w in want.items():
            if name.startswith("denoiser_net."):
                assert torch.equal(got[name], before[name]), name
                continue
            moved += not torch.equal(got[name], before[name])
            err = (got[name] - w).abs()
            g = grads.get(name)
            noise = (g.abs() <= floor) if g is not None else torch.zeros_like(err, dtype=bool)
            if bool((~noise).any()):
                assert float(err[~noise].max()) <= 1e-6, name
            if bool(noise.any()):
                assert float(err[noise].max()) <= 2 * pmodel.lr, name
    assert moved > 0


def test_enhance_nfe2_matches_reference(weights):
    jmodel, pmodel = _pair(weights)
    key = jax.random.PRNGKey(5)
    y = np.stack([wave(900, 0), wave(900, 1)])
    want, jnfe = jmodel.make_enhance()(weights[0], jnp.asarray(y), key)
    noise = ReplayNoise([np.asarray(jcplx.complex_normal(key, (2, F, 64)), np.float32)])
    got, nfe = pmodel.enhance(tt(y), noise=noise, N=30, corrector="ald", sampler_type="ode")
    assert noise.exhausted() and nfe == int(jnfe) == 2
    assert got.shape == y.shape
    assert_close_rel(got.numpy(), np.asarray(want), 1e-4, "distilled enhance")
    again, _ = pmodel.enhance(tt(y), generator=torch.Generator().manual_seed(0))
    assert bool(torch.isfinite(again).all())


def test_enhance_bf16_in_ratio_form(weights):
    """The NFE-2 program in bfloat16 against the reference's bfloat16
    make_enhance, in the ratio form of test_torch_bf16 over the weights of
    four seeds, the squared L2 distances summed (as the denoiser's bf16
    gradients in test_torch_discriminative: one seed's max-abs ratio is
    bf16's noise, 1.53 against the reference on seed 0, and the output is
    one student forward scaled by 1 / fac(T) = 4.5). Measured: 1.15 and
    0.97."""
    key = jax.random.PRNGKey(7)
    y = wave(700, 3)[None]
    z = np.asarray(jcplx.complex_normal(key, (1, F, 64)), np.float32)
    shapes = jax.eval_shape(lambda: jbuild(dict(TEACHER)).init_params(
        jax.random.PRNGKey(0), (1, F, 64)))
    jfns = {dtype: jbuild(dict(_config(), dtype=dtype)).make_enhance()
            for dtype in ("float32", "bfloat16")}
    sums = {"effect": 0.0, "against_ref": 0.0, "really": 0.0}
    for seed in range(4):
        student = random_params(shapes, seed)
        out = {}
        for dtype in ("float32", "bfloat16"):
            _, pmodel = _pair((student, weights[1]), dtype=dtype)
            out["jax", dtype] = np.asarray(jfns[dtype](student, jnp.asarray(y), key)[0],
                                           np.float64)
            got, _ = pmodel.enhance(tt(y), noise=ReplayNoise([z]))
            assert got.dtype == torch.float32
            out["port", dtype] = got.numpy().astype(np.float64)

        def d2(a, b):
            return float(((out[a] - out[b]) ** 2).sum())

        sums["effect"] += d2(("jax", "bfloat16"), ("jax", "float32"))
        sums["against_ref"] += d2(("port", "bfloat16"), ("jax", "bfloat16"))
        sums["really"] += d2(("port", "bfloat16"), ("port", "float32"))
    against_ref, really = (np.sqrt(sums[k] / sums["effect"]) for k in ("against_ref", "really"))
    assert against_ref <= RATIO, against_ref
    assert really >= REALLY, really


def test_enhance_refuses_deepcache_with_the_references_message(weights):
    jmodel, pmodel = _pair(weights)
    with pytest.raises(ValueError) as jerr:
        jmodel.make_enhance(deepcache=3)
    assert str(jerr.value) == DEEPCACHE_REFUSAL
    with pytest.raises(ValueError, match="does not support --deepcache"):
        pmodel.enhance(tt(wave(700, 0)[None]), deepcache=3)


def test_loss_needs_a_teacher(weights):
    pmodel = pbuild(_config(), device="cpu")
    x, y = _batch()
    with pytest.raises(ValueError, match="teacher_score_params"):
        pmodel.loss_fn((tt(x), tt(y)))


def test_calibrate_distill_and_its_file_match_reference(weights, tmp_path):
    jmodel, pmodel = _pair(weights)
    y = np.stack([wave(1024, 0), wave(1024, 1)])
    key = jax.random.PRNGKey(2)
    want = jquant.calibrate_distill(jmodel, weights[0], jnp.asarray(y), key,
                                    min_channels=MIN_CH)
    draws = [np.asarray(jcplx.complex_normal(k, (2, F, 128)), np.float32)
             for k in jax.random.split(key, 4)]
    noise = ReplayNoise(draws)
    got = pquant.calibrate_distill(pmodel, tt(y), min_channels=MIN_CH, noise=noise)
    assert noise.exhausted() and set(got) == {"denoiser", "score"}
    for net in ("denoiser", "score"):
        w = _by_module(want[net], "a_scale")
        assert w.keys() == got[net].keys() and len(w) > 10, net
        for k in w:
            assert abs(got[net][k] - w[k]) <= 1e-4 * w[k], (net, k, got[net][k], w[k])

    meta = {"params": "ema", "min_channels": MIN_CH, "mode": "distill",
            "stream_chunk_s": 0.0, "calib_N": 0}
    pquant.save_scales(str(tmp_path / "p.json"), got, meta)  # port -> reference
    jtree, jmeta = jquant.load_scales_with_meta(str(tmp_path / "p.json"))
    assert jmeta == meta and {n: _by_module(t, "a_scale") for n, t in jtree.items()} == got
    jquant.save_scales(str(tmp_path / "j.json"), jtree, meta)  # reference -> port
    assert pquant.load_scales_with_meta(str(tmp_path / "j.json")) == (got, meta)
    assert json.load(open(tmp_path / "j.json")) == json.load(open(tmp_path / "p.json"))
    # and the scales serve: the int8 program at NFE 2 stays near the float one
    gen = torch.Generator().manual_seed(0)
    xf, _ = pmodel.enhance(tt(y), generator=gen)
    xq, nfe = pmodel.enhance(tt(y), quant=got, generator=torch.Generator().manual_seed(0))
    rel = float((xq - xf).abs().max() / xf.abs().max())
    assert nfe == 2 and 0 < rel < 0.25, rel
