"""bfloat16 joint training against the reference on the CPU: one step's loss
and gradients against `jax.value_and_grad(loss_given_tz)` of the reference's
bfloat16 model with the same weights, t and z; gradients reaching every
float32 parameter through the casts; K1's adjoint in bfloat16 at every
train-step shape; Adam and the EMA after a bfloat16 step.

Tiny nets (nf 16, three levels, 32 x 32 specs). Whole-step tolerances take
the ratio form of tests/test_torch_bf16.py: the port's and the reference's
bfloat16 steps are two roundings of one program, which part at SiLU's and
GroupNorm's roundings in the first blocks (that file's items 8 and 9) and
then by bfloat16's own noise, so they are held to RATIO times the distance
between the reference's bfloat16 and float32 results, and the port's
bfloat16 result must part from its float32 one by at least REALLY times
that distance (it would not if the port trained in float32). Distances are
L2 norms over all gradient tensors together (the largest elements of a
max-norm sit in a few tensors). Elementwise results are counted in bfloat16
ulps of the output's scale.

The losses are float32 sums of ~10^4 terms of bfloat16 precision, so the
distance of a bfloat16 loss from its float32 value is a random walk that can
cancel, or carry a bias of one package's own: measured, the reference's
bfloat16 score loss lies 0.017 from its float32 one and the port's 0.65,
while the reference's denoiser loss lies 11.0 from float32 (its GroupNorm's
fast variance, tests/test_torch_bf16.py item 9) and the port's 0.94. A
ratio of two such distances says nothing, so each bfloat16 loss is held
within LOSS_ULP (one bfloat16 ulp, relative) of the reference's bfloat16
loss, and at least LOSS_REALLY (ten times the float32 parity tolerance of
tests/test_torch_train.py) away from the port's float32 loss, both relative
to the float32 loss.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_parity import (
    bf16_ulp,
    bf16_values,
    nchw,
    nhwc,
    to_numpy_tree,
    tt,
    ulps_of_scale,
)

from storm_tpu.kernels import upfirdn as jkup
from storm_tpu.models.base import ema_update as jema_update
from storm_tpu.nn import resample as jres
from storm_tpu_torch.convert import params_from_jax
from storm_tpu_torch.kernels import upfirdn as kup
from storm_tpu_torch.models.base import init_train_state
from test_torch_train import CONFIG, _batch, _models

RATIO = 1.5
REALLY = 0.5
LOSS_ULP = 2.0 ** -7
LOSS_REALLY = 1e-4
SYM = np.outer([1, 3, 3, 1], [1, 3, 3, 1]).astype(np.float32) / 64.0


@functools.lru_cache(maxsize=None)
def _step_grads():
    """{(package, dtype): (aux, {parameter name: gradient})} of one joint
    training step in float32 and bfloat16, the same weights, batch, t and z
    (the frozen Fourier W's gradient 0, as the reference stops it); and
    "jax tree": the reference's bfloat16 gradient tree."""
    x, y, t, z = _batch()
    out = {}
    for dtype in ("float32", "bfloat16"):
        jmodel, params, pmodel = _models(dict(CONFIG, dtype=dtype))
        (_, jaux), jgrads = jax.jit(jax.value_and_grad(
            lambda p, *a: jmodel.loss_given_tz(p, a[:2], *a[2:]), has_aux=True))(
            params, x, y, t, z)
        jgrads = to_numpy_tree(jgrads)
        out["jax", dtype] = ({k: float(v) for k, v in jaux.items()},
                             params_from_jax(jgrads, target=pmodel))
        aux = pmodel.compute_gradients((tt(x), tt(y)), tt(t), tt(z))
        out["port", dtype] = ({k: float(v) for k, v in aux.items()},
                              {n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
                               for n, p in pmodel.named_parameters()})
    out["jax tree"] = jgrads
    return out


def _grad_distance(a, b):
    return float(torch.sqrt(sum(((a[n].double() - b[n].double()) ** 2).sum() for n in b)))


def test_bf16_step_against_reference():
    """Measured: gradients 1.08 of the reference's bfloat16 effect from the
    reference's bfloat16 gradients, and 0.89 of it from the port's float32
    ones; losses (joint, denoiser, score) 3.1e-3, 4.8e-3, 5.9e-4 of their
    scale from the reference's bfloat16 losses, and 5.2e-4, 4.7e-4, 5.9e-4
    from the port's float32 ones. Every loss is float32, as the
    reference's."""
    steps = _step_grads()
    (j32_aux, j32), (j16_aux, j16) = steps["jax", "float32"], steps["jax", "bfloat16"]
    (p32_aux, p32), (p16_aux, p16) = steps["port", "float32"], steps["port", "bfloat16"]
    assert set(p16_aux) == set(j16_aux)
    assert all(g.dtype == torch.float32 for g in p16.values())
    effect = _grad_distance(j16, j32)
    assert effect > 0
    assert _grad_distance(p16, j16) <= RATIO * effect, _grad_distance(p16, j16) / effect
    assert _grad_distance(p16, p32) >= REALLY * effect, _grad_distance(p16, p32) / effect
    for k in j16_aux:
        scale = abs(p32_aux[k])
        assert abs(p16_aux[k] - j16_aux[k]) <= LOSS_ULP * scale, k
        assert abs(p16_aux[k] - p32_aux[k]) >= LOSS_REALLY * scale, k


def test_bf16_gradients_reach_every_parameter():
    """Every parameter with a nonzero float32 gradient has a nonzero bfloat16
    one (no cast was detached), the frozen Fourier W has none, and a
    training forward inside `cast_nets` (detached copies) raises."""
    x, y, t, z = _batch()
    grads = {}
    for dtype in ("float32", "bfloat16"):
        _, _, pmodel = _models(dict(CONFIG, dtype=dtype))
        pmodel.compute_gradients((tt(x), tt(y)), tt(t), tt(z))
        grads[dtype] = {n: p.grad for n, p in pmodel.named_parameters() if p.requires_grad}
        frozen = [n for n, p in pmodel.named_parameters() if not p.requires_grad]
        assert frozen and all(n.endswith("all_modules.0.W") for n in frozen)
        assert all(pmodel.get_parameter(n).grad is None for n in frozen)
    reached = [n for n, g in grads["float32"].items() if bool(g.abs().max() > 0)]
    assert len(reached) > 0.9 * len(grads["float32"])
    assert [n for n in reached if not bool(grads["bfloat16"][n].abs().max() > 0)] == []
    with pytest.raises(RuntimeError, match="cast_params"), pmodel.cast_nets():
        pmodel.loss_given_tz((tt(x), tt(y)), tt(t), tt(z))
    with torch.no_grad(), pmodel.cast_nets():  # validation's use of it
        assert torch.isfinite(pmodel.loss_per_example((tt(x), tt(y)))).all()


def _train_shapes():
    """(config name, C, H, W) of every upfirdn2d call of the tiny training
    step (CONFIG, 32 x 32), both nets, as NCSN++ gives them."""
    calls = set()
    for pyramid in (2, 6):
        for i in range(2):  # down: resblock h and x, and the input pyramid
            calls |= {("down", 16 * (1, 2, 2)[i], 32 >> i, 32 >> i),
                      ("down", pyramid, 32 >> i, 32 >> i)}
        for i in (2, 1):  # up: the output pyramid, resblock h and x
            calls |= {("up", pyramid, 32 >> i, 32 >> i), ("up", 16 * (1, 2, 2)[i], 32 >> i,
                                                           32 >> i)}
    return sorted(calls)


@pytest.mark.parametrize("cfg,C,H,W", _train_shapes())
def test_upfirdn2d_bwd_bf16_against_the_references_vjp(cfg, C, H, W):
    """K1's adjoint in bfloat16 (what `UpFirDn2d.backward` runs on a bfloat16
    gradient: the plain version here, the kernel on a card) against the
    reference's bfloat16 VJPs: its custom VJP rule (`_ufd_bwd`, whose
    adjoint K1-bwd replaces) and XLA's autodiff of the dilated conv that its
    NCSN++ differentiates. NCSN++'s FIR's products are exact, and all sum in
    float32 and round once: equal, or 1 ulp apart where the order of the sum
    shows, at no more than 1% of the elements (measured: equal). The
    gradient stays bfloat16 on the way, and the dispatcher launches nothing
    on the CPU."""
    up, down, pad = {"down": (1, 2, (1, 1)), "up": (2, 1, (2, 1))}[cfg]
    k = SYM * (4.0 if up == 2 else 1.0)
    rng = np.random.default_rng(C + H)
    x = bf16_values(rng.standard_normal((2, H, W, C)))
    Ho = kup.output_size(H, 4, up, down, pad)
    g = bf16_values(rng.standard_normal((2, Ho, Ho, C)))
    wants = []
    for fn in (jkup.upfirdn2d, jres.upfirdn2d):
        _, vjp = jax.vjp(lambda v: fn(v, jnp.asarray(k), up, down, pad),
                         jnp.asarray(x, jnp.bfloat16))
        (gx,) = vjp(jnp.asarray(g, jnp.bfloat16))
        assert gx.dtype == jnp.bfloat16
        wants.append(np.asarray(gx.astype(jnp.float32)))
    px = nchw(x).bfloat16().requires_grad_()
    kup.upfirdn2d_cuda.launches = kup.upfirdn2d_bwd_cuda.launches = 0
    out = kup.upfirdn2d(px, k, up=up, down=down, pad=pad)
    (got,) = torch.autograd.grad(out, px, nchw(g).bfloat16())
    assert out.dtype == got.dtype == torch.bfloat16
    assert kup.upfirdn2d_cuda.launches == kup.upfirdn2d_bwd_cuda.launches == 0
    got = nhwc(got.float())
    for want in wants:
        assert ulps_of_scale(got, want) <= 1.0
        assert np.mean(got != want) <= 0.01


def test_adam_and_ema_after_a_bf16_step_match_optax():
    """Two optimizer and EMA steps with the reference's gradients of one
    bfloat16 step (float32, of float32 parameters), through the port's Adam
    and EMA and through optax's Adam and the reference's EMA: 1e-6
    absolute, 1e-5 relative, as in float32 (tests/test_torch_train.py)."""
    cfg = dict(CONFIG, dtype="bfloat16", lr=1e-2)
    _, params, pmodel = _models(cfg)
    grads = _step_grads()["jax tree"]
    assert all(v.dtype == np.float32 for v in jax.tree.leaves(grads))
    state = init_train_state(pmodel, pmodel.lr)
    tx = optax.adam(1e-2)

    @jax.jit
    def jstep(grads, opt, p, ema, step):
        updates, opt = tx.update(grads, opt, p)
        p = optax.apply_updates(p, updates)
        return opt, p, jema_update(ema, p, 0.999, step)

    jp, jema, opt = params, params, tx.init(params)
    for step in (1, 2):
        opt, jp, jema = jstep(grads, opt, jp, jema, jnp.asarray(step))
        for name, g in params_from_jax(grads, target=pmodel).items():
            p = pmodel.get_parameter(name)
            if p.requires_grad:
                p.grad = g.clone()
        pmodel.apply_update(state)
    for got, want in ((pmodel.state_dict(), jp), (state.ema, jema)):
        want = params_from_jax(to_numpy_tree(want), target=pmodel)
        for name, w in want.items():
            assert got[name].dtype == torch.float32
            torch.testing.assert_close(got[name], w, atol=1e-6, rtol=1e-5, msg=name)


def _autograd_group_norm(gn, x):
    """The bfloat16 GroupNorm's arithmetic left to autograd (which keeps a
    float32 copy of x for the variance's backward)."""
    B, C = x.shape[:2]
    G = gn.num_groups
    var, mean = torch.var_mean(x.reshape(B, G, -1).float(), dim=-1, correction=0)
    mul = (torch.rsqrt(var + gn.eps)[:, :, None] * gn.weight.view(G, -1)).reshape(B, C)
    add = gn.bias - mean.repeat_interleave(C // G, dim=1) * mul
    return torch.addcmul(add.view(B, C, 1, 1), x, mul.view(B, C, 1, 1)).to(x.dtype)


@pytest.mark.parametrize("C,shape", [(32, (2, 8, 12, 32)), (64, (2, 16, 16, 64))])
def test_group_norm_bf16_backward_keeps_no_float32_copy(C, shape):
    """`LowPrecisionGroupNorm` keeps x (bfloat16) and the float32 group
    statistics for its backward, no float32 copy of x, and computes what
    autograd of the same arithmetic computes: the output equal, the
    gradients of x, scale and bias equal (measured); against `jax.vjp` of
    flax's bfloat16 GroupNorm the input gradient within 1 ulp of its scale
    at no more than 1% of the elements (measured 0 and 0.25 ulps at 0 and
    0.02% of them), scale and bias gradients 1e-5 of their scale."""
    from storm_tpu.nn import layers as jl
    from storm_tpu_torch.convert import module_params_from_jax
    from storm_tpu_torch.nn import layers as pl

    rng = np.random.default_rng(C)
    x = bf16_values(bf16_values(3.0 * rng.standard_normal(shape)) + 0.5)
    g = bf16_values(rng.standard_normal(shape))
    params = {"scale": (1 + 0.1 * rng.standard_normal(C)).astype(np.float32),
              "bias": (0.1 * rng.standard_normal(C)).astype(np.float32)}
    jm = jl.group_norm(C, dtype=jnp.bfloat16)
    _, vjp = jax.vjp(lambda p, v: jm.apply({"params": p}, v), params,
                     jnp.asarray(x, jnp.bfloat16))
    jparams, jgx = vjp(jnp.asarray(g, jnp.bfloat16))
    gn = pl.group_norm(C)
    gn.load_state_dict(module_params_from_jax(params))
    grads = []
    for fn in (gn, lambda v: _autograd_group_norm(gn, v)):
        xt = nchw(x).bfloat16().requires_grad_()
        y = fn(xt)
        if fn is gn:
            kept = y.grad_fn.saved_tensors
            assert type(y.grad_fn).__name__.startswith("LowPrecisionGroupNorm")
            assert [t.dtype for t in kept if t.numel() == xt.numel()] == [torch.bfloat16]
        grads.append((y.detach(),) + torch.autograd.grad(y, (xt, gn.weight, gn.bias),
                                                         nchw(g).bfloat16()))
    for got, want in zip(grads[0], grads[1]):
        assert got.dtype == want.dtype and torch.equal(got, want)
    _, gx, gw, gb = grads[0]
    jgx = np.asarray(jgx.astype(jnp.float32))
    assert ulps_of_scale(nhwc(gx.float()), jgx) <= 1.0
    assert np.mean(nhwc(gx.float()) != jgx) <= 0.01
    for got, want in ((gw, jparams["scale"]), (gb, jparams["bias"])):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def _layer_case(name):
    """(reference module, port module, NHWC or (B, C) input) for one layer."""
    import flax.linen as fnn

    from storm_tpu.nn import layers as jl
    from storm_tpu_torch.nn import layers as pl

    rng = np.random.default_rng(len(name))
    if name == "dense":
        return (fnn.Dense(24, dtype=jnp.bfloat16, param_dtype=jnp.float32), pl.Dense(32, 24),
                bf16_values(rng.standard_normal((3, 32))))
    x = bf16_values(rng.standard_normal((2, 8, 12, 16)))
    if name == "nin":
        return jl.NIN(12), pl.NIN(16, 12), x
    if name == "attn":
        return (jl.AttnBlockpp(skip_rescale=True, init_scale=1.0),
                pl.AttnBlockpp(16, skip_rescale=True, init_scale=1.0), x)
    k = int(name[-1])
    return ((jl.conv3x3 if k == 3 else jl.conv1x1)(24, init_scale=1.0, dtype=jnp.bfloat16),
            (pl.conv3x3 if k == 3 else pl.conv1x1)(16, 24, init_scale=1.0), x)


@pytest.mark.parametrize("name", ["conv3x3", "conv1x1", "dense", "nin", "attn"])
def test_layer_backward_bf16_against_reference(name):
    """The layers' backward in bfloat16 (the bias added after the rounded
    product, the weights read through the differentiable cast). The input
    gradient against `jax.vjp` of the reference's layer in bfloat16: within
    1 ulp of its scale (measured: 0, and 1 for attention). Each parameter
    gradient (float32 of bfloat16 precision: the cotangent of the weight's
    cast) against the float64 gradient of the same layer at the same
    bfloat16 values: within 1.5 ulps of its scale, plus 2^-8 of the
    layer's largest gradient element for the attention key's bias, whose
    exact gradient is 0 (measured: 0.25-1.2 ulps). The reference's weight
    gradients equal the port's (0-0.25 ulps), but it reduces the bias
    cotangents in bfloat16 (0.75-6.2 ulps from float64) where the port sums
    in float32 and rounds once."""
    import copy

    from storm_tpu_torch.convert import module_params_from_jax

    jm, pm, x = _layer_case(name)
    flat = x.ndim == 2
    xj = jnp.asarray(x, jnp.bfloat16)
    params = jax.tree.map(lambda v: np.asarray(v, np.float32),
                          jm.init(jax.random.PRNGKey(1), xj)["params"])
    params = jax.tree.map(lambda v: v + 0.05 * np.random.default_rng(v.size).standard_normal(
        v.shape).astype(np.float32), params)  # biases not zero
    pm.load_state_dict(module_params_from_jax(params), strict=True)
    out, vjp = jax.vjp(lambda v: jm.apply({"params": params}, v), xj)
    g = bf16_values(np.random.default_rng(9).standard_normal(out.shape))
    (jgx,) = vjp(jnp.asarray(g, jnp.bfloat16))
    xt = (tt(x) if flat else nchw(x)).bfloat16().requires_grad_()
    gt = (tt(g) if flat else nchw(g)).bfloat16()
    y = pm(xt)
    assert y.dtype == torch.bfloat16
    grads = torch.autograd.grad(y, [xt] + list(pm.parameters()), gt)
    assert grads[0].dtype == torch.bfloat16
    got_x = grads[0].float().numpy() if flat else nhwc(grads[0].float())
    assert ulps_of_scale(got_x, np.asarray(jgx.astype(jnp.float32))) <= 1.0

    exact = copy.deepcopy(pm).double()
    with torch.no_grad():
        for p in exact.parameters():
            p.copy_(p.to(torch.bfloat16))
    want = torch.autograd.grad(exact(xt.detach().double()), list(exact.parameters()),
                               gt.double())
    floor = max(float(w.abs().max()) for w in want)
    for (pname, _), got, w in zip(pm.named_parameters(), grads[1:], want):
        assert got.dtype == torch.float32
        scale = float(w.abs().max())
        tol = 1.5 * bf16_ulp(scale) + (2.0 ** -8 * floor if pname == "NIN_1.b" else 0.0)
        assert float((got.double() - w).abs().max()) <= tol, pname
