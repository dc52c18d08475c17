"""K2, fused bias + leaky ReLU, against the reference: the forward against
`fused_leaky_relu` and `fused_leaky_relu_pallas` (interpret mode), the
gradient through the port's autograd Function against the reference's custom
VJP. Tolerance 1e-6: the same float32 operations in the same order (add, the
slope product, the scale product); the bias gradient sums in another order,
so it is held to 1e-6 of its scale.

In bfloat16 (x and bias both bfloat16) the reference rounds each of its
three operations to bfloat16, and so does the port: the forward equals the
Pallas kernel (interpret mode) and the jnp expression bit for bit, and the
input gradient equals `jax.vjp`'s bit for bit (0 ulps; its order, slope * g
first); the bias gradient, a float32 sum over rows in another order rounded
once, within 1 ulp of its scale (measured: equal). Against autograd of the
plain version, which multiplies by scale first, the input gradient is
within 1 ulp of each element. A bfloat16 x with a float32 bias is refused,
as the Pallas kernel refuses it.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from torch_parity import assert_close_rel, bf16_values, tt, ulps_of_scale

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


def _bf16_inputs(shape, seed):
    """bfloat16 values (as float32 numpy) with zeros, a tiny value and exact
    ties of x + bias written in."""
    x, b = _inputs(shape, seed)
    x, b = bf16_values(3.0 * x).copy(), bf16_values(b)
    x.reshape(-1)[3] = -b[3 % shape[-1]]  # h exactly 0
    return x, b


def _jb(a):
    return jnp.asarray(a, jnp.bfloat16)


def _f(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) if not isinstance(a, torch.Tensor) \
        else a.detach().float().numpy()


@pytest.mark.parametrize("args", [(), (0.1, 1.0)], ids=["default", "s0.1"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_bf16_forward_matches_pallas_bit_for_bit(shape, args):
    x, b = _bf16_inputs(shape, 20 + len(shape))
    want = _f(jfla(_jb(x), _jb(b), *args))
    with pltpu.force_tpu_interpret_mode():
        pallas = _f(jfla_pallas(_jb(x), _jb(b), *args))
    got = fused_leaky_relu(tt(x).bfloat16(), tt(b).bfloat16(), *args)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(pallas, want)
    np.testing.assert_array_equal(_f(got), pallas)
    np.testing.assert_array_equal(
        _f(fused_leaky_relu_plain(tt(x).bfloat16(), tt(b).bfloat16(), *args)), pallas)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_bf16_gradient_matches_reference_vjp(shape):
    x, b = _bf16_inputs(shape, 30 + len(shape))
    g = bf16_values(np.random.default_rng(5).standard_normal(shape))
    _, vjp = jax.vjp(lambda x_, b_: jfla(x_, b_), _jb(x), _jb(b))
    want_gx, want_gb = (_f(v) for v in vjp(_jb(g)))
    px, pb = tt(x).bfloat16().requires_grad_(), tt(b).bfloat16().requires_grad_()
    gx, gb = torch.autograd.grad(fused_leaky_relu(px, pb), (px, pb), tt(g).bfloat16())
    assert gx.dtype == gb.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f(gx), want_gx)
    assert ulps_of_scale(_f(gb), want_gb) <= 1.0

    qx, qb = tt(x).bfloat16().requires_grad_(), tt(b).bfloat16().requires_grad_()
    hx, hb = torch.autograd.grad(fused_leaky_relu_plain(qx, qb), (qx, qb), tt(g).bfloat16())
    one_ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(_f(hx)), 2.0 ** -126))) - 7)
    assert np.all(np.abs(_f(gx) - _f(hx)) <= one_ulp)
    assert ulps_of_scale(_f(gb), _f(hb)) <= 1.0


def test_bf16_x_with_a_float32_bias_is_refused_as_the_pallas_kernel_refuses_it():
    """The reference's jnp expression promotes the pair to a float32 output;
    its Pallas kernel, which the CUDA kernel replaces, refuses it. The op
    refuses it too; the plain version, the expression, promotes as jnp."""
    x, b = _bf16_inputs((4, 8), 2)
    with pytest.raises(ValueError):
        with pltpu.force_tpu_interpret_mode():
            jfla_pallas(_jb(x), jnp.asarray(b))
    with pytest.raises(ValueError, match="refuses a bfloat16 x with a float32 bias"):
        fused_leaky_relu(tt(x).bfloat16(), tt(b))
    want = np.asarray(jfla(_jb(x), jnp.asarray(b)))
    got = fused_leaky_relu_plain(tt(x).bfloat16(), tt(b))
    assert want.dtype == np.float32 and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
