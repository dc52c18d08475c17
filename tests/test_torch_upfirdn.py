"""Port parity: upfirdn2d's plain version against the reference's XLA lowering
and its Pallas kernel (interpret mode), and the FIR resampling built on it.

The CUDA kernel itself runs only on a card (tests/test_torch_cuda.py and
chip_smoke.py hold it against this plain version there). Tolerance 1e-5
absolute and relative, as tests/test_kernels.py uses: a 16-tap float32 sum.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from torch_parity import nchw, nhwc, tt

from storm_tpu.kernels import upfirdn2d_pallas
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
