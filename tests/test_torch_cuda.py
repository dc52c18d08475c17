"""The port's CUDA kernels against their plain versions, on a card: upfirdn2d
in both directions (forward, and the gradient through `UpFirDn2d`), also at
the serving path's batches and bucket widths, the int8 quantizer (codes
identical) and the int8 conv built on it, and the fused bias + leaky ReLU
(forward and gradient); and the dynamic batcher's pipelined path on the card.

Skips without a CUDA device. On a card, from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest`: the repository's conftest imports JAX, which a GPU host
need not have; this file imports only the port.) Tolerance for upfirdn2d
atol = rtol = 1e-5: a 16-tap float32 sum in another order, with fused
multiply-adds; the quantizer's codes are exact; fused_leaky_relu's forward
1e-6 (the same float32 operations), its gradients exact (autograd's own).
"""
import threading

import numpy as np
import pytest
import torch

from storm_tpu_torch.kernels import fused_act as kfa
from storm_tpu_torch.kernels import quant as kq
from storm_tpu_torch.kernels import upfirdn as kup
from storm_tpu_torch.nn.layers import conv1x1, conv3x3
from storm_tpu_torch.models.factory import build_model
from storm_tpu_torch.nn.qconv import conv2d_int8, scales_attached, weight_columns
from storm_tpu_torch.utils.inference import BucketedEnhancer
from storm_tpu_torch.utils.server import DynamicBatcher

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


# shapes that cross the kernel's tile and vector boundaries (output tiles of
# 16 x 64 for down, 32 x 128 for up; 16-byte chunks): H and W that are not
# multiples of the tile or of 4, H = 1, W = 1, one past a tile, whole aligned
# tiles, and more planes than one grid dimension holds
EDGE_SHAPES = [(1, 2, 17, 131), (2, 3, 1, 70), (2, 3, 45, 1), (1, 1, 33, 129),
               (2, 4, 128, 256), (1, 65537, 2, 3)]
EDGE_CONFIGS = [(1, 2, (1, 1)), (1, 2, (2, 2)), (2, 1, (2, 1)), (2, 1, (1, 2))]
EDGE_CASES = [(shape, cfg) for shape in EDGE_SHAPES for cfg in EDGE_CONFIGS
              if min(kup.output_size(n, 4, *cfg) for n in shape[2:]) >= 1]


@pytest.mark.parametrize("kernel", [SYM, ASYM], ids=["sym", "asym"])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "odd_offset"])
@pytest.mark.parametrize("shape,cfg", EDGE_CASES)
def test_kernel_matches_plain_at_tile_edges(cuda, shape, cfg, offset, kernel):
    """offset 1: a contiguous view one float into its storage, which the
    kernel fills through its 4-byte copies."""
    up, down, pad = cfg
    n = int(np.prod(shape))
    x = torch.randn(n + offset, generator=torch.Generator().manual_seed(n)).to(cuda)
    x = x[offset:].view(shape)
    assert x.is_contiguous() and x.storage_offset() == offset
    got = kup.upfirdn2d_cuda(x, kernel, up=up, down=down, pad=pad)
    want = kup.upfirdn2d_plain(x, kernel, up=up, down=down, pad=pad)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def _serving_calls(B, W):
    """(config, shape) of the distinct upfirdn2d calls of a full-width NCSN++
    forward (nf 128, ch_mult 1,2,2,2, 256 bins) on B rows of width W: down
    into each of the three lower levels, up out of them, each at the
    resblock's channels and at the pyramids' 6 and 2."""
    calls = set()
    for level, C in ((0, 128), (1, 256), (2, 256)):
        H, Wl = 256 >> level, W >> level
        calls |= {((1, 2, (1, 1)), (B, c, H, Wl)) for c in (C, 6, 2)}
        calls |= {((2, 1, (2, 1)), (B, c, H // 2, Wl // 2)) for c in (256, 6, 2)}
    return sorted(calls)


@pytest.mark.parametrize("W", [192, 320, 384, 576])
@pytest.mark.parametrize("B", [2, 4, 8])
def test_kernel_matches_plain_at_serving_shapes(cuda, B, W):
    """The batches the batched CLI, the server and streaming give the kernel:
    B rows at the bucket widths of 1, 2 (a stream chunk), 2.5 and 4 s."""
    gen = torch.Generator(device=cuda).manual_seed(B * W)
    for (up, down, pad), shape in _serving_calls(B, W):
        x = torch.randn(shape, device=cuda, generator=gen)
        for kernel in (SYM, ASYM):
            got = kup.upfirdn2d_cuda(x, kernel, up=up, down=down, pad=pad)
            want = kup.upfirdn2d_plain(x, kernel, up=up, down=down, pad=pad)
            torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kernel", [SYM, ASYM], ids=["sym", "asym"])
@pytest.mark.parametrize("shape,cfg", [c for c in EDGE_CASES if c[1] in ((1, 2, (1, 1)),
                                                                         (2, 1, (2, 1)))])
def test_adjoint_matches_plain_at_tile_edges(cuda, shape, cfg, kernel):
    """The backward kernel's explicit output size is the forward input's:
    odd, 1, or one past a tile."""
    up, down, pad = cfg
    Ho, Wo = (kup.output_size(n, 4, up, down, pad) for n in shape[2:])
    g = torch.randn(shape[:2] + (Ho, Wo), generator=torch.Generator().manual_seed(2)).to(cuda)
    got = kup.upfirdn2d_bwd_cuda(g, kernel, up, down, pad, shape[2:])
    want = kup.upfirdn2d_bwd_plain(g, kernel, up, down, pad, shape[2:])
    assert got.shape == shape
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


def _quant_input(n, inv, gen):
    """Normals spread over the code range, exact .5 ties at inv (a power of
    two) and values beyond +-127 after scaling."""
    x = torch.randn(n, generator=gen) * (70.0 / inv)
    k = torch.randint(-130, 130, (n // 3,), generator=gen).float() + 0.5
    x[: k.numel()] = k / inv
    x[-2:] = torch.tensor([200.0, -200.0]) / inv
    return x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("inv", [2.0, 12.7, 1 / 0.0371])
@pytest.mark.parametrize("n,offset", [(2 * 1024 * 128, 0), (100003, 0), (77, 0), (4099, 1)])
def test_quantizer_kernel_codes_equal_plain(cuda, dtype, inv, n, offset):
    """Vector path (aligned, whole vectors), tail, tiny and unaligned inputs."""
    x = _quant_input(n + offset, inv, torch.Generator().manual_seed(n)).to(dtype).to(cuda)[offset:]
    assert x.is_contiguous()
    before = kq.quantize_int8_cuda.launches
    got = kq.quantize_int8(x, inv)
    torch.cuda.synchronize()
    assert kq.quantize_int8_cuda.launches == before + 1
    want = kq.quantize_int8_plain(x, inv)
    assert got.dtype == torch.int8 and torch.equal(got, want)
    assert torch.equal(got.cpu(), kq.quantize_int8_plain(x.cpu(), inv))
    if inv == 2.0:
        assert got.min().item() == -127 and got.max().item() == 127


@pytest.mark.parametrize("shape", [(4, 256, 256, 576), (8, 384, 128, 160), (2, 512, 32, 48)])
def test_quantizer_codes_equal_plain_at_serving_shapes(cuda, shape):
    """Quantized-conv inputs of B > 1 batches at bucket widths, ties included."""
    n = int(np.prod(shape))
    x = _quant_input(n, 2.0, torch.Generator().manual_seed(n % 1000)).to(cuda).view(shape)
    got = kq.quantize_int8(x, 2.0)
    assert torch.equal(got, kq.quantize_int8_plain(x, 2.0))


def test_quantizer_refuses_what_it_was_not_built_for(cuda):
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        kq.quantize_int8(torch.zeros(8, 8, device=cuda, dtype=torch.float16), 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        kq.quantize_int8(torch.zeros(8, 8, device=cuda).t(), 1.0)


@pytest.mark.parametrize("k,cin,cout", [(3, 128, 128), (3, 384, 128), (1, 256, 256)])
def test_int8_conv_on_the_card_equals_the_cpu(cuda, k, cin, cout):
    """The int8 conv: the same integer product as on the CPU, and a quantized
    conv call launches the quantizer once."""
    gen = torch.Generator().manual_seed(k + cin)
    xq = torch.randint(-127, 128, (2, cin, 8, 12), generator=gen, dtype=torch.int8)
    wq = torch.randint(-127, 128, (cout, cin, k, k), generator=gen, dtype=torch.int8)
    want = conv2d_int8(xq, weight_columns(wq), k, k // 2)
    got = conv2d_int8(xq.to(cuda), weight_columns(wq.to(cuda)), k, k // 2)
    assert torch.equal(got.cpu(), want)

    conv = (conv3x3 if k == 3 else conv1x1)(cin, cout)
    conv.init_from(gen)
    x = torch.randn(2, cin, 8, 12, generator=gen)
    outs = []
    for device in ("cpu", cuda):
        conv.to(device)
        with torch.inference_mode(), scales_attached(conv, {"": 0.031}):
            before = kq.quantize_int8_cuda.launches
            outs.append(conv(x.to(device)).cpu())
            assert kq.quantize_int8_cuda.launches == before + (device != "cpu")
    torch.testing.assert_close(outs[1], outs[0], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", [(8, 16, 16, 128), (3, 17, 33, 6), (5, 7)])
def test_fused_leaky_relu_kernel_matches_plain(cuda, shape):
    gen = torch.Generator().manual_seed(len(shape))
    x = torch.randn(shape, generator=gen).to(cuda).requires_grad_()
    b = torch.randn(shape[-1], generator=gen).to(cuda).requires_grad_()
    g = torch.randn(shape, generator=gen).to(cuda)
    before = kfa.fused_leaky_relu_cuda.launches
    out = kfa.fused_leaky_relu(x, b)
    gx, gb = torch.autograd.grad(out, (x, b), g)
    torch.cuda.synchronize()
    assert kfa.fused_leaky_relu_cuda.launches == before + 1
    xp, bp = x.detach().clone().requires_grad_(), b.detach().clone().requires_grad_()
    want = kfa.fused_leaky_relu_plain(xp, bp)
    hx, hb = torch.autograd.grad(want, (xp, bp), g)
    torch.testing.assert_close(out, want, atol=1e-6, rtol=1e-6)
    # the backward is autograd's own arithmetic on the kernel's mask: exact
    assert torch.equal(gx, hx) and torch.equal(gb, hb)
    with torch.no_grad():  # an unaligned input takes the kernel's scalar path
        flat = torch.randn(x.numel() + 1, generator=gen).to(cuda)[1:].view(shape)
        torch.testing.assert_close(kfa.fused_leaky_relu(flat, b),
                                   kfa.fused_leaky_relu_plain(flat, b), atol=1e-6, rtol=1e-6)


def test_fused_leaky_relu_refuses_what_it_was_not_built_for(cuda):
    with pytest.raises(ValueError, match="float32"):
        kfa.fused_leaky_relu(torch.zeros(4, 8, device=cuda).half(),
                             torch.zeros(8, device=cuda).half())
    with pytest.raises(ValueError, match="contiguous"):
        kfa.fused_leaky_relu(torch.zeros(8, 4, device=cuda).t(), torch.zeros(8, device=cuda))


def test_pipelined_batcher_on_the_card_equals_the_enhancer(cuda):
    """Two concurrent requests in one batch through the pipelined path
    (`enhance_async`, the copy to pinned memory and its event): the results
    of the enhancer on the same batch with the same generator, exactly."""
    config = {"mode": "regen-joint-training", "nf": 16, "ch_mult": [1, 2, 2],
              "init_scale": 1.0, "n_fft": 62, "hop_length": 16}
    model = build_model(config, device=cuda, seed=0)
    enh = BucketedEnhancer(model, N=2, corrector="ald")
    waves = [np.sin(np.arange(n) / 7.0).astype(np.float32) for n in (900, 1500)]
    batcher = DynamicBatcher(enh, torch.Generator(device=cuda).manual_seed(0), max_batch=2,
                             max_wait_ms=20_000.0)
    outs = [None, None]
    try:
        assert batcher._async

        def work(i):
            outs[i] = batcher.submit(waves[i], timeout=120)

        threads = [threading.Thread(target=work, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        batcher.close()
    assert batcher.stats["batches"] == 1 and batcher.stats["errors"] == 0
    ys = np.stack([np.pad(w, (0, 2048 - w.shape[0])) for w in waves])
    want, nfe = enh(ys, torch.Generator(device=cuda).manual_seed(0))
    for (x, n), w, row in zip(outs, waves, want):
        assert n == nfe == 5
        np.testing.assert_array_equal(x, row[: w.shape[0]])
