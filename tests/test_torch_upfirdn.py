"""Port parity: upfirdn2d's plain version against the reference's XLA lowering
and its Pallas kernel (interpret mode), the FIR resampling built on it, and
the gradient through `UpFirDn2d` against the reference's custom VJP, XLA's
autodiff and PyTorch's autodiff of the plain version.

The CUDA kernel itself runs only on a card (tests/test_torch_cuda.py and
chip_smoke.py hold it against this plain version there). Tolerance 1e-5
absolute and relative, as tests/test_kernels.py uses: a 16-tap float32 sum.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from torch_parity import nchw, nhwc, tt

from storm_tpu.kernels import upfirdn2d_pallas
from storm_tpu.kernels import upfirdn as jup
from storm_tpu.nn import resample as jres
from storm_tpu_torch.kernels import upfirdn as kup
from storm_tpu_torch.nn import resample as pres

SYM = np.outer([1, 3, 3, 1], [1, 3, 3, 1]).astype(np.float32) / 64.0
ASYM = np.random.default_rng(7).standard_normal((4, 4)).astype(np.float32)
KERNELS = {"sym": SYM, "asym": ASYM}
# the four cases of tests/test_kernels.py; the 2nd and 3rd are NCSN++'s
CASES = [(1, 1, (1, 2)), (1, 2, (1, 1)), (2, 1, (2, 1)), (1, 2, (2, 2))]


def _x(C, seed=0, H=12, W=16):
    return np.random.default_rng(seed).standard_normal((2, H, W, C)).astype(np.float32)


@pytest.mark.parametrize("kname", ["sym", "asym"])
@pytest.mark.parametrize("C", [2, 6, 8])
@pytest.mark.parametrize("up,down,pad", CASES)
def test_plain_matches_xla(up, down, pad, C, kname):
    x, k = _x(C), KERNELS[kname]
    if up == 2:
        k = k * 4  # NCSN++ up path gain (factor**2)
    want = np.asarray(jres.upfirdn2d(jnp.asarray(x), jnp.asarray(k), up=up, down=down, pad=pad))
    got = nhwc(kup.upfirdn2d_plain(nchw(x), k, up=up, down=down, pad=pad))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kname", ["sym", "asym"])
@pytest.mark.parametrize("up,down,pad", CASES)
def test_plain_matches_pallas_interpret(up, down, pad, kname):
    x, k = _x(6, seed=1), KERNELS[kname]
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(upfirdn2d_pallas(jnp.asarray(x), jnp.asarray(k), up=up,
                                           down=down, pad=pad))
    got = nhwc(kup.upfirdn2d_plain(nchw(x), k, up=up, down=down, pad=pad))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("C", [2, 6, 8])
def test_resample_2d_matches(C):
    x = _x(C, seed=2, H=16, W=8)
    for jf, pf in ((jres.upsample_2d, pres.upsample_2d),
                   (jres.downsample_2d, pres.downsample_2d)):
        want = np.asarray(jf(jnp.asarray(x), (1, 3, 3, 1), factor=2))
        got = nhwc(pf(nchw(x), (1, 3, 3, 1), factor=2))
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(
        nhwc(pres.naive_upsample_2d(nchw(x))), np.asarray(jres.naive_upsample_2d(jnp.asarray(x))))
    np.testing.assert_allclose(
        nhwc(pres.naive_downsample_2d(nchw(x))),
        np.asarray(jres.naive_downsample_2d(jnp.asarray(x))), atol=1e-6)
    np.testing.assert_array_equal(pres.setup_kernel([1, 3, 3, 1]), SYM)


def test_cpu_tensor_takes_plain_version_and_counts_nothing():
    kup.upfirdn2d_cuda.launches = 0
    x = nchw(_x(6, seed=3))
    out = pres.upfirdn2d(x, SYM, down=2, pad=(1, 1))
    torch.testing.assert_close(out, kup.upfirdn2d_plain(x, SYM, down=2, pad=(1, 1)),
                               rtol=0, atol=0)
    pres.upsample_2d(x, (1, 3, 3, 1))
    assert kup.upfirdn2d_cuda.launches == 0


def test_cpu_dispatch_refuses_what_the_kernel_refuses():
    x = nchw(_x(2, seed=4))
    with pytest.raises(ValueError, match="contiguous"):
        pres.upfirdn2d(x.transpose(2, 3), SYM, down=2, pad=(1, 1))
    with pytest.raises(ValueError, match="float32"):
        pres.upfirdn2d(x.double(), SYM, down=2, pad=(1, 1))
    with pytest.raises(ValueError, match="not built"):
        pres.upfirdn2d(x, SYM, up=2, down=2, pad=(1, 1))
    with pytest.raises(ValueError, match="4x4"):
        pres.upfirdn2d(x, np.ones((3, 3), np.float32), down=2, pad=(1, 1))


def test_kernel_wrapper_refuses_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA tensor"):
        kup.upfirdn2d_cuda(tt(np.zeros((1, 2, 8, 8))), SYM, down=2, pad=(1, 1))
    assert kup.upfirdn2d_cuda.launches == 0


# NCSN++'s two configurations, at even sizes (as NCSN++ runs them) and odd ones,
# where the reference's g_pad1 of the down config is 2, not 1
BWD_CASES = [(1, 2, (1, 1)), (2, 1, (2, 1))]
BWD_SIZES = [(12, 16), (13, 9)]


def _grad_case(up, down, pad, kname, H, W, seed=5):
    k = KERNELS[kname] * (4.0 if up == 2 else 1.0)
    x = _x(3, seed=seed, H=H, W=W)
    rng = np.random.default_rng(seed + 1)
    Ho, Wo = kup.output_size(H, 4, up, down, pad), kup.output_size(W, 4, up, down, pad)
    g = rng.standard_normal((2, Ho, Wo, 3)).astype(np.float32)  # NHWC
    return k, x, g


def _port_grad(x, g, k, up, down, pad):
    """d<upfirdn2d(x), g>/dx through UpFirDn2d, with an upstream gradient that
    is a non-contiguous view (the backward makes it contiguous)."""
    xt = nchw(x).requires_grad_()
    out = kup.upfirdn2d(xt, k, up=up, down=down, pad=pad)
    gt = torch.from_numpy(np.ascontiguousarray(g.transpose(0, 3, 2, 1))).permute(0, 1, 3, 2)
    assert not gt.is_contiguous() and gt.shape == out.shape
    (grad,) = torch.autograd.grad(out, xt, gt)
    assert grad.shape == xt.shape
    return nhwc(grad)


@pytest.mark.parametrize("H,W", BWD_SIZES)
@pytest.mark.parametrize("kname", ["sym", "asym"])
@pytest.mark.parametrize("up,down,pad", BWD_CASES)
def test_grad_matches_reference_vjp_and_xla_autodiff(up, down, pad, kname, H, W):
    k, x, g = _grad_case(up, down, pad, kname, H, W)
    got = _port_grad(x, g, k, up, down, pad)
    for f in (jup.upfirdn2d, jres.upfirdn2d):  # custom VJP, then XLA autodiff
        want = np.asarray(jax.grad(
            lambda v: jnp.sum(f(v, jnp.asarray(k), up=up, down=down, pad=pad) * g)
        )(jnp.asarray(x)))
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("H,W", BWD_SIZES + [(8, 11)])
@pytest.mark.parametrize("kname", ["sym", "asym"])
@pytest.mark.parametrize("up,down,pad", BWD_CASES)
def test_grad_matches_autograd_of_plain(up, down, pad, kname, H, W):
    k, x, g = _grad_case(up, down, pad, kname, H, W, seed=9)
    got = _port_grad(x, g, k, up, down, pad)
    xt = nchw(x).requires_grad_()
    (want,) = torch.autograd.grad(kup.upfirdn2d_plain(xt, k, up=up, down=down, pad=pad),
                                  xt, nchw(g))
    np.testing.assert_allclose(got, nhwc(want), atol=1e-5, rtol=1e-5)


def test_cpu_backward_counts_nothing_and_keeps_graph():
    kup.upfirdn2d_cuda.launches = kup.upfirdn2d_bwd_cuda.launches = 0
    x = nchw(_x(2, seed=6)).requires_grad_()
    out = pres.downsample_2d(pres.upsample_2d(x, (1, 3, 3, 1)), (1, 3, 3, 1))
    assert out.grad_fn is not None
    out.square().sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    assert kup.upfirdn2d_cuda.launches == kup.upfirdn2d_bwd_cuda.launches == 0


def test_backward_wrapper_refuses_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA tensor"):
        kup.upfirdn2d_bwd_cuda(tt(np.zeros((1, 2, 4, 4))), SYM, 1, 2, (1, 1), (8, 8))
    assert kup.upfirdn2d_bwd_cuda.launches == 0
