"""K2, fused bias + leaky ReLU, against the reference: the forward against
`fused_leaky_relu` and `fused_leaky_relu_pallas` (interpret mode), the
gradient through the port's autograd Function against the reference's custom
VJP. Tolerance 1e-6: the same float32 operations in the same order (add, the
slope product, the scale product); the bias gradient sums in another order,
so it is held to 1e-6 of its scale.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from torch_parity import assert_close_rel, tt

from storm_tpu.kernels import fused_leaky_relu as jfla
from storm_tpu.kernels import fused_leaky_relu_pallas as jfla_pallas
from storm_tpu_torch.kernels import fused_leaky_relu, fused_leaky_relu_plain
from storm_tpu_torch.kernels.fused_act import FusedLeakyReLU

SHAPES = [(2, 5, 6, 8), (3, 17, 33, 6), (7, 4)]


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    x.reshape(-1)[:3] = [0.0, -0.0, 1e-30]  # the sign test at zero
    b = rng.standard_normal(shape[-1]).astype(np.float32)
    b[0] = 0.0
    return x, b


@pytest.mark.parametrize("args", [(), (0.1, 1.0), (0.3, 2.5)], ids=["default", "s0.1", "s0.3"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_forward_matches_reference_and_pallas(shape, args):
    x, b = _inputs(shape, len(shape))
    want = np.asarray(jfla(jnp.asarray(x), jnp.asarray(b), *args))
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(jfla_pallas(jnp.asarray(x), jnp.asarray(b), *args))
    got = fused_leaky_relu(tt(x), tt(b), *args)
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(got.numpy(), pallas, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(fused_leaky_relu_plain(tt(x), tt(b), *args).numpy(), want,
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_gradient_matches_reference_vjp(shape):
    x, b = _inputs(shape, 10 + len(shape))
    g = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    out, vjp = jax.vjp(lambda x_, b_: jfla(x_, b_), jnp.asarray(x), jnp.asarray(b))
    want_gx, want_gb = (np.asarray(v) for v in vjp(jnp.asarray(g)))

    px, pb = tt(x).requires_grad_(), tt(b).requires_grad_()
    y = fused_leaky_relu(px, pb)
    assert y.grad_fn is not None and type(y.grad_fn).__name__.startswith("FusedLeakyReLU")
    gx, gb = torch.autograd.grad(y, (px, pb), tt(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(out), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(gx.numpy(), want_gx, atol=1e-6, rtol=1e-6)
    assert_close_rel(gb.numpy(), want_gb, 1e-6, "bias gradient")

    # and against autograd of the plain version: the same operations
    qx, qb = tt(x).requires_grad_(), tt(b).requires_grad_()
    hx, hb = torch.autograd.grad(fused_leaky_relu_plain(qx, qb), (qx, qb), tt(g))
    np.testing.assert_allclose(gx.numpy(), hx.numpy(), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(gb.numpy(), hb.numpy(), atol=1e-6, rtol=1e-6)


def test_mask_is_kept_only_for_a_gradient():
    x, b = _inputs((4, 8), 1)
    with torch.no_grad():
        out = FusedLeakyReLU.apply(tt(x), tt(b), 0.2, math.sqrt(2.0))
    assert out.grad_fn is None
    px = tt(x).requires_grad_()
    out = fused_leaky_relu(px, tt(b))
    (mask,) = out.grad_fn.saved_tensors
    assert mask.dtype == torch.bool and torch.equal(mask, tt(x + b) >= 0)


def test_refuses_what_the_kernel_does_not_take():
    x, b = tt(np.zeros((4, 8), np.float32)), tt(np.zeros(8, np.float32))
    with pytest.raises(ValueError, match="float32"):
        fused_leaky_relu(x.double(), b.double())
    with pytest.raises(ValueError, match="channels last"):
        fused_leaky_relu(x, b[:4])
    with pytest.raises(ValueError, match="contiguous"):
        fused_leaky_relu(x.t(), tt(np.zeros(4, np.float32)))
