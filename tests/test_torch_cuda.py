"""The port's CUDA kernel against its plain version, on a card, in both
directions (forward, and the gradient through `UpFirDn2d`).

Skips without a CUDA device. On a card, from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest`: the repository's conftest imports JAX, which a GPU host
need not have; this file imports only the port.) Tolerance atol = rtol = 1e-5:
a 16-tap float32 sum in another order, with fused multiply-adds.
"""
import numpy as np
import pytest
import torch

from storm_tpu_torch.kernels import upfirdn as kup

pytestmark = pytest.mark.cuda

SYM = np.outer([1, 3, 3, 1], [1, 3, 3, 1]).astype(np.float32) / 64.0
ASYM = np.random.default_rng(7).standard_normal((4, 4)).astype(np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("kernel", [SYM, ASYM], ids=["sym", "asym"])
@pytest.mark.parametrize("up,down,pad", [(1, 2, (1, 1)), (2, 1, (2, 1)), (1, 2, (2, 2)),
                                         (1, 2, (-1, 0)), (2, 1, (1, 2))])
@pytest.mark.parametrize("shape", [(2, 3, 12, 16), (1, 1, 7, 9), (1, 6, 33, 65)])
def test_kernel_matches_plain(cuda, shape, up, down, pad, kernel):
    x = torch.randn(shape, generator=torch.Generator().manual_seed(0)).to(cuda)
    before = kup.upfirdn2d_cuda.launches
    got = kup.upfirdn2d(x, kernel, up=up, down=down, pad=pad)
    torch.cuda.synchronize()
    assert kup.upfirdn2d_cuda.launches == before + 1
    want = kup.upfirdn2d_plain(x, kernel, up=up, down=down, pad=pad)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_kernel_refuses_what_it_was_not_built_for(cuda):
    x = torch.zeros(1, 2, 8, 8, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        kup.upfirdn2d_cuda(x.double(), SYM, down=2, pad=(1, 1))
    with pytest.raises(ValueError, match="contiguous"):
        kup.upfirdn2d_cuda(x.transpose(2, 3), SYM, down=2, pad=(1, 1))
    with pytest.raises(ValueError, match="not built"):
        kup.upfirdn2d_cuda(x, SYM, up=2, down=2, pad=(1, 1))
    with pytest.raises(ValueError, match="4x4"):
        kup.upfirdn2d_cuda(x, np.ones((3, 3), np.float32), down=2, pad=(1, 1))


@pytest.mark.parametrize("kernel", [SYM, ASYM], ids=["sym", "asym"])
@pytest.mark.parametrize("up,down,pad", [(1, 2, (1, 1)), (2, 1, (2, 1))])
@pytest.mark.parametrize("shape", [(2, 3, 12, 16), (1, 6, 33, 65), (2, 4, 13, 9)])
def test_gradient_launches_the_kernel_and_matches_plain(cuda, shape, up, down, pad, kernel):
    """A CUDA input that needs a gradient gets an output with a grad_fn, and
    the backward launches the kernel once: without the autograd Function the
    gradient through upfirdn2d was silently dropped on the card."""
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(shape, generator=gen).to(cuda).requires_grad_()
    fwd, bwd = kup.upfirdn2d_cuda.launches, kup.upfirdn2d_bwd_cuda.launches
    out = kup.upfirdn2d(x, kernel, up=up, down=down, pad=pad)
    assert out.grad_fn is not None
    g = torch.randn(out.shape[::-1], generator=gen).to(cuda).permute(3, 2, 1, 0)  # a strided view
    (got,) = torch.autograd.grad(out, x, g)
    torch.cuda.synchronize()
    assert kup.upfirdn2d_cuda.launches == fwd + 1
    assert kup.upfirdn2d_bwd_cuda.launches == bwd + 1
    xp = x.detach().clone().requires_grad_()
    (want,) = torch.autograd.grad(kup.upfirdn2d_plain(xp, kernel, up=up, down=down, pad=pad), xp, g)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
