"""The port's CUDA kernels against their plain versions, on a card: upfirdn2d
in both directions (forward, and the gradient through `UpFirDn2d`), also at
the serving path's batches and bucket widths, in float32 and bfloat16, the
int8 quantizer in both product modes (codes identical) and the int8 conv
built on it, and the fused bias + leaky ReLU (forward and gradient); the
bfloat16 GroupNorm; the dynamic batcher's pipelined path on the card;
deep-feature caching through the kernels; the ODE, Picard and etd
samplers through them; and the distilled student's step and NFE-2 output.

Skips without a CUDA device. On a card, from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest`: the repository's conftest imports JAX, which a GPU host
need not have; this file imports only the port.) Tolerance for upfirdn2d
atol = rtol = 1e-5: a 16-tap float32 sum in another order, with fused
multiply-adds; in bfloat16 equal with NCSN++'s FIR, whose products with
bfloat16 values are exact in float32 and summed in the same order, and
with an asymmetric FIR 1 ulp of each element plus the float32 sum's
rounding (a fused multiply-add rounds an inexact product once less); the
quantizer's
codes are exact; fused_leaky_relu's forward 1e-6 (the same float32
operations), its gradients exact (autograd's own); in bfloat16 its forward
equal (the same three roundings), its input gradient within 1 ulp of each
element of autograd's (the reference's order of the two products) and its
bias gradient within 1 ulp of its scale. A bfloat16 training step of a tiny
StoRM through the kernels against the plain path: exact launch counts, and
gradients within a tenth of the step's bfloat16-against-float32 distance.
"""
import contextlib
import threading
from unittest import mock

import numpy as np
import pytest
import torch

from storm_tpu_torch.kernels import fused_act as kfa
from storm_tpu_torch.nn import resample
from storm_tpu_torch.kernels import quant as kq
from storm_tpu_torch.kernels import upfirdn as kup
from storm_tpu_torch.nn.layers import conv1x1, conv3x3, group_norm
from storm_tpu_torch.models.factory import build_model
from storm_tpu_torch.nn.qconv import conv2d_int8, scales_attached, weight_columns
from storm_tpu_torch.utils.inference import BucketedEnhancer
from storm_tpu_torch.utils.server import DynamicBatcher

pytestmark = pytest.mark.cuda
launch = kup._launch  # the real one, for tests that watch it

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


# shapes that cross the kernel's tile and box boundaries (`tile_plan`: column
# tiles of at most 120 outputs down and 288 up, boxes of at most 256 elements
# a row, the row tile from a box's byte budget) and its copy paths: one
# column past the down config's widest tile (W 242 -> Wo 121) and past a
# 256-element row (264, 257), the up config past its widest tile (145 ->
# Wo 290), widths that are not a multiple of 8 (the producer warp's element
# fill instead of TMA), H = 1, W = 1, whole tiles, and more planes than one
# grid dimension holds (65537, with TMA at W = 8 and without at W = 3)
EDGE_SHAPES = [(1, 2, 17, 242), (1, 2, 33, 264), (1, 1, 9, 257), (1, 1, 5, 145),
               (2, 3, 1, 70), (2, 3, 45, 1), (2, 4, 128, 256), (1, 65537, 2, 3),
               (1, 65537, 2, 8)]
EDGE_CONFIGS = [(1, 2, (1, 1)), (1, 2, (2, 2)), (2, 1, (2, 1)), (2, 1, (1, 2))]
EDGE_CASES = [(shape, cfg) for shape in EDGE_SHAPES for cfg in EDGE_CONFIGS
              if min(kup.output_size(n, 4, *cfg) for n in shape[2:]) >= 1]


@pytest.mark.parametrize("kernel", [SYM, ASYM], ids=["sym", "asym"])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "odd_offset"])
@pytest.mark.parametrize("shape,cfg", EDGE_CASES)
def test_kernel_matches_plain_at_tile_edges(cuda, shape, cfg, offset, kernel):
    """offset 1: a contiguous view one float into its storage, off the 16
    bytes TMA needs: the producer warp fills its boxes element by element."""
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


def _within_one_bf16_ulp(got, want, terms):
    """Each element of got within 1 bfloat16 ulp of want's, plus the float32
    rounding of its sum: 2^-18 of `terms`, the sum of its products'
    magnitudes (an asymmetric FIR's products are not exact in float32, the
    kernel fuses them into its sum, and where the sum cancels, the two
    float32 sums' difference can be many ulps of a small result)."""
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape
    w = want.float().abs().clamp_min(2.0 ** -126)
    allowed = torch.exp2(torch.floor(torch.log2(w)) - 7) + 2.0 ** -18 * terms.float()
    assert ((got.float() - want.float()).abs() <= allowed).all()


@pytest.mark.parametrize("kernel", [SYM, ASYM], ids=["sym", "asym"])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "odd_offset"])
@pytest.mark.parametrize("shape,cfg", EDGE_CASES)
def test_bf16_kernel_matches_plain_at_tile_edges(cuda, shape, cfg, offset, kernel):
    """bfloat16: offset 1 puts the base off 16 bytes, W % 8 != 0 a row off
    them; both take the producer warp's element-by-element fill, TMA the
    others."""
    up, down, pad = cfg
    n = int(np.prod(shape))
    x = torch.randn(n + offset, generator=torch.Generator().manual_seed(n)).to(cuda)
    x = x.bfloat16()[offset:].view(shape)
    assert x.is_contiguous() and x.storage_offset() == offset
    got = kup.upfirdn2d_cuda(x, kernel, up=up, down=down, pad=pad)
    want = kup.upfirdn2d_plain(x, kernel, up=up, down=down, pad=pad)
    _within_one_bf16_ulp(got, want, kup.upfirdn2d_plain(x.abs(), np.abs(kernel), up=up,
                                                        down=down, pad=pad))
    if kernel is SYM:
        assert torch.equal(got, want)


@pytest.mark.parametrize("W", [192, 320, 576])
@pytest.mark.parametrize("B", [1, 4])
def test_bf16_kernel_equals_plain_at_serving_shapes(cuda, B, W):
    gen = torch.Generator(device=cuda).manual_seed(B * W)
    for (up, down, pad), shape in _serving_calls(B, W):
        x = torch.randn(shape, device=cuda, generator=gen).bfloat16()
        got = kup.upfirdn2d_cuda(x, SYM * (4.0 if up == 2 else 1.0), up=up, down=down, pad=pad)
        want = kup.upfirdn2d_plain(x, SYM * (4.0 if up == 2 else 1.0), up=up, down=down, pad=pad)
        assert torch.equal(got, want)


@pytest.mark.parametrize("kernel", [SYM, ASYM], ids=["sym", "asym"])
@pytest.mark.parametrize("shape,cfg", [c for c in EDGE_CASES if c[1] in ((1, 2, (1, 1)),
                                                                         (2, 1, (2, 1)))])
def test_bf16_adjoint_matches_plain_at_tile_edges(cuda, shape, cfg, kernel):
    up, down, pad = cfg
    Ho, Wo = (kup.output_size(n, 4, up, down, pad) for n in shape[2:])
    g = torch.randn(shape[:2] + (Ho, Wo), generator=torch.Generator().manual_seed(2)).to(cuda)
    g = g.bfloat16()
    got = kup.upfirdn2d_bwd_cuda(g, kernel, up, down, pad, shape[2:])
    want = kup.upfirdn2d_bwd_plain(g, kernel, up, down, pad, shape[2:])
    assert got.shape == shape
    _within_one_bf16_ulp(got, want, kup.upfirdn2d_bwd_plain(g.abs(), np.abs(kernel), up, down,
                                                            pad, shape[2:]))
    if kernel is SYM:
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernel_at_every_bucket_width(cuda, dtype):
    """Every bucket's level widths (64 k frames, k = 1..9: the column tiles
    `tile_plan` picks for them) in both configurations and through the
    adjoint, with NCSN++'s FIR: bfloat16 equal to plain bit for bit, float32
    to 1e-5."""
    gen = torch.Generator(device=cuda).manual_seed(11)

    def same(got, want):
        if dtype == torch.bfloat16:
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)

    for k in range(1, 10):
        for (up, down, pad), (B, C, H, W) in _serving_calls(1, 64 * k):
            if C > 6:
                C = 8  # the resblocks' widths and heights at a few planes
            fir = SYM * (4.0 if up == 2 else 1.0)
            x = torch.randn((B, C, H, W), device=cuda, generator=gen).to(dtype)
            got = kup.upfirdn2d_cuda(x, fir, up=up, down=down, pad=pad)
            same(got, kup.upfirdn2d_plain(x, fir, up=up, down=down, pad=pad))
            g = torch.randn(got.shape, device=cuda, generator=gen).to(dtype)
            same(kup.upfirdn2d_bwd_cuda(g, fir, up, down, pad, (H, W)),
                 kup.upfirdn2d_bwd_plain(g, fir, up, down, pad, (H, W)))


def test_bf16_kernel_replays_in_a_captured_graph(cuda):
    """A bfloat16 launch captured in a CUDA graph (its tensor map and plan are
    kernel arguments the graph keeps) replays on new input in the same
    buffer and equals plain bit for bit, and counts one launch at capture."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    fir = SYM * 4.0
    x = torch.randn((1, 256, 64, 144), device=cuda, generator=gen).bfloat16()
    kup.upfirdn2d_cuda(x, fir, up=2, down=1, pad=(2, 1))  # the instance is set up eagerly
    torch.cuda.synchronize()
    graph, before = torch.cuda.CUDAGraph(), kup.upfirdn2d_cuda.launches
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream), torch.cuda.graph(graph, stream=stream):
        out = kup.upfirdn2d_cuda(x, fir, up=2, down=1, pad=(2, 1))
    torch.cuda.current_stream().wait_stream(stream)
    assert kup.upfirdn2d_cuda.launches == before + 1
    for _ in range(2):
        x.copy_(torch.randn(x.shape, device=cuda, generator=gen))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, kup.upfirdn2d_plain(x, fir, up=2, down=1, pad=(2, 1)))


@pytest.mark.parametrize("shape", [(1, 128, 256, 576), (4, 32, 33, 65)])
def test_bf16_group_norm_rounds_float32_group_norm_once(cuda, shape):
    """PyTorch's CUDA group_norm refuses a bfloat16 input with float32 scale
    and bias; the port's GroupNorm takes float32 statistics and normalizes in
    float32: within 1 ulp of the output's scale of float32 GroupNorm rounded
    once, at a few elements (the two take their moments in other orders)."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    gn = group_norm(shape[1]).to(cuda)
    with torch.no_grad():
        gn.weight.copy_(1.0 + 0.1 * torch.randn(shape[1], device=cuda, generator=gen))
        gn.bias.copy_(0.1 * torch.randn(shape[1], device=cuda, generator=gen))
        x = (torch.randn(shape, device=cuda, generator=gen) + 0.5).bfloat16()
        got = gn(x)
        want = torch.nn.functional.group_norm(x.float(), gn.num_groups, gn.weight, gn.bias,
                                              gn.eps).bfloat16()
    scale = want.float().abs().max()
    ulp = torch.exp2(torch.floor(torch.log2(scale)) - 7)
    assert (got.float() - want.float()).abs().max().item() <= ulp.item()  # of the output's scale
    assert (got != want).float().mean().item() < 1e-3


@pytest.mark.parametrize("shape", [(8, 128, 256, 256), (2, 48, 33, 65)])
def test_bf16_group_norm_backward_on_the_card(cuda, shape):
    """`LowPrecisionGroupNorm`'s backward against autograd of the same
    arithmetic (which keeps a float32 copy of x) on the card: the output
    equal, each gradient within 1 ulp of its scale (the float32 sums run in
    other orders); it keeps no float32 tensor of x's size."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    gn = group_norm(shape[1]).to(cuda)
    with torch.no_grad():
        gn.weight.copy_(1.0 + 0.1 * torch.randn(shape[1], device=cuda, generator=gen))
        gn.bias.copy_(0.1 * torch.randn(shape[1], device=cuda, generator=gen))
    x = (torch.randn(shape, device=cuda, generator=gen) + 0.5).bfloat16()
    g = torch.randn(shape, device=cuda, generator=gen).bfloat16()
    B, C, G = shape[0], shape[1], gn.num_groups
    results = []
    for autograd in (False, True):
        xt = x.clone().requires_grad_()
        if autograd:
            var, mean = torch.var_mean(xt.reshape(B, G, -1).float(), dim=-1, correction=0)
            mul = (torch.rsqrt(var + gn.eps)[:, :, None] * gn.weight.view(G, -1)).reshape(B, C)
            add = gn.bias - mean.repeat_interleave(C // G, dim=1) * mul
            y = torch.addcmul(add.view(B, C, 1, 1), xt, mul.view(B, C, 1, 1)).to(xt.dtype)
        else:
            y = gn(xt)
            big = [t.dtype for t in y.grad_fn.saved_tensors if t.numel() == x.numel()]
            assert big == [torch.bfloat16]
        results.append((y.detach(),) + torch.autograd.grad(y, (xt, gn.weight, gn.bias), g))
    assert torch.equal(results[0][0], results[1][0])
    for got, want in zip(results[0][1:], results[1][1:]):
        scale = want.float().abs().max()
        ulp = torch.exp2(torch.floor(torch.log2(scale)) - (7 if got.dtype == torch.bfloat16
                                                            else 23))
        assert (got.float() - want.float()).abs().max() <= max(ulp, 1e-5 * scale)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("inv", [12.7, 1 / 0.0371, 0.5 / 0.0913])
@pytest.mark.parametrize("n,offset", [(2 * 1024 * 128, 0), (100003, 0), (77, 0), (4099, 1)])
def test_quantizer_bf16_product_codes_equal_plain(cuda, dtype, inv, n, offset):
    """The bfloat16-product mode: x and inv rounded to bfloat16, their product
    rounded to bfloat16; codes equal plain's, on vector, tail, tiny and
    unaligned inputs, every bfloat16 value below saturation included."""
    every = (np.arange(1 << 16, dtype=np.uint32) << 16).view(np.float32)
    every = torch.from_numpy(every[np.isfinite(every) & (np.abs(every) < 140 / inv)])
    x = torch.cat([every, _quant_input(n + offset, inv, torch.Generator().manual_seed(n))])
    x = x.to(dtype).to(cuda)[offset:]
    before = kq.quantize_int8_cuda.launches
    got = kq.quantize_int8(x, inv, torch.bfloat16)
    torch.cuda.synchronize()
    assert kq.quantize_int8_cuda.launches == before + 1
    want = kq.quantize_int8_plain(x, inv, torch.bfloat16)
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), kq.quantize_int8_plain(x.cpu(), inv, torch.bfloat16))
    # where the two products round to different sides of a .5, the modes part
    assert not torch.equal(got, kq.quantize_int8(x, inv))


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


@pytest.mark.parametrize("shape", [(8, 16, 16, 128), (3, 17, 33, 6), (5, 7), (4, 3, 40)])
def test_fused_leaky_relu_bf16_kernel_matches_plain(cuda, shape):
    gen = torch.Generator().manual_seed(10 + len(shape))
    x = (3 * torch.randn(shape, generator=gen)).bfloat16().to(cuda).requires_grad_()
    b = torch.randn(shape[-1], generator=gen).bfloat16().to(cuda).requires_grad_()
    g = torch.randn(shape, generator=gen).bfloat16().to(cuda)
    before = kfa.fused_leaky_relu_cuda.launches
    out = kfa.fused_leaky_relu(x, b)
    gx, gb = torch.autograd.grad(out, (x, b), g)
    torch.cuda.synchronize()
    assert kfa.fused_leaky_relu_cuda.launches == before + 1
    assert out.dtype == gx.dtype == gb.dtype == torch.bfloat16
    xp, bp = x.detach().clone().requires_grad_(), b.detach().clone().requires_grad_()
    want = kfa.fused_leaky_relu_plain(xp, bp)
    hx, hb = torch.autograd.grad(want, (xp, bp), g)
    assert torch.equal(out, want)
    ulp = torch.exp2(torch.floor(torch.log2(hx.float().abs().clamp_min(2.0 ** -126))) - 7)
    assert bool(((gx.float() - hx.float()).abs() <= ulp).all())
    scale = hb.float().abs().max()
    assert (gb.float() - hb.float()).abs().max() <= torch.exp2(torch.floor(torch.log2(scale)) - 7)
    with torch.no_grad():  # an unaligned input takes the kernel's scalar path
        flat = torch.randn(x.numel() + 1, generator=gen).bfloat16().to(cuda)[1:].view(shape)
        assert torch.equal(kfa.fused_leaky_relu(flat, b), kfa.fused_leaky_relu_plain(flat, b))


def test_bf16_train_step_on_the_card_matches_the_plain_path(cuda):
    """One bfloat16 step of a tiny StoRM (three levels, 32 x 32, B=2): 24
    forward and 22 backward K1 launches, all in bfloat16, and gradients
    through the kernels within a tenth of the bfloat16-against-float32
    distance of the same step from the plain path's (cuDNN deterministic)."""
    config = {"mode": "regen-joint-training", "nf": 16, "ch_mult": [1, 2, 2],
              "init_scale": 1.0, "n_fft": 62, "hop_length": 16}
    gen = torch.Generator().manual_seed(0)
    x = (0.3 * torch.randn(2, 32, 32, 2, generator=gen)).to(cuda)
    batch = (x, x + 0.2 * torch.randn(2, 32, 32, 2, generator=gen).to(cuda))
    t = torch.tensor([0.3, 0.8], device=cuda)
    z = torch.randn(2, 32, 32, 2, generator=gen).to(cuda) / 2 ** 0.5

    def grads(dtype):
        model = build_model(dict(config, dtype=dtype), device=cuda, seed=0).train()
        model.compute_gradients(batch, t, z)
        return torch.cat([p.grad.flatten() for p in model.parameters() if p.requires_grad])

    torch.backends.cudnn.deterministic = True
    try:
        kup.upfirdn2d_cuda.launches = kup.upfirdn2d_bwd_cuda.launches = 0
        seen = []
        with mock.patch.object(kup, "_launch", side_effect=lambda x, *a: (
                seen.append(x.dtype), launch(x, *a))[1]):
            g_kernel = grads("bfloat16")
        counts = (kup.upfirdn2d_cuda.launches, kup.upfirdn2d_bwd_cuda.launches)
        with mock.patch.object(resample, "upfirdn2d", kup.upfirdn2d_plain):
            g_plain = grads("bfloat16")
            g_f32 = grads("float32")
    finally:
        torch.backends.cudnn.deterministic = False
    assert counts == (24, 22) and seen == [torch.bfloat16] * 46
    effect = (g_plain - g_f32).norm()
    assert effect > 0 and (g_kernel - g_plain).norm() <= 0.1 * effect


def test_fused_leaky_relu_refuses_what_it_was_not_built_for(cuda):
    with pytest.raises(ValueError, match="float32"):
        kfa.fused_leaky_relu(torch.zeros(4, 8, device=cuda).half(),
                             torch.zeros(8, device=cuda).half())
    with pytest.raises(ValueError, match="contiguous"):
        kfa.fused_leaky_relu(torch.zeros(8, 4, device=cuda).t(), torch.zeros(8, device=cuda))
    with pytest.raises(ValueError, match="float32 bias"):
        kfa.fused_leaky_relu(torch.zeros(4, 8, device=cuda).bfloat16(),
                             torch.zeros(8, device=cuda))


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("depth", [1, 2])
def test_deepcache_on_the_card(cuda, dtype, depth):
    """Deep-feature caching on the card, tiny StoRM (three levels): the
    score net's shallow pass on its deep cache equals its forward exactly
    (the same kernels on the same shapes), the cache is in the compute
    dtype, and a dc2 + ald enhancement through the kernels equals the same
    enhancement with plain upfirdn2d (cuDNN deterministic, same noise)."""
    config = {"mode": "regen-joint-training", "nf": 16, "ch_mult": [1, 2, 2],
              "init_scale": 1.0, "n_fft": 62, "hop_length": 16, "dtype": dtype}
    model = build_model(config, device=cuda, seed=0)
    net = model.score_net
    gen = torch.Generator().manual_seed(0)
    x = (0.5 * torch.randn(2, 3, 32, 64, 2, generator=gen)).to(cuda)
    t = torch.tensor([0.3, 0.8], device=cuda)
    with torch.no_grad(), model.cast_nets():
        cache = net.deep_features(x, t, cache_depth=depth)
        assert all(c.dtype == getattr(torch, dtype) for c in cache)
        assert torch.equal(net.forward_shallow(x, t, cache, cache_depth=depth), net(x, t))

    y = torch.from_numpy(np.sin(np.arange(2048) / 7.0).astype(np.float32)[None]).to(cuda)
    torch.backends.cudnn.deterministic = True
    try:
        kup.upfirdn2d_cuda.launches = 0
        got, nfe = model.enhance(y, N=4, corrector="ald", deepcache=2, deepcache_depth=depth,
                                 generator=torch.Generator(device=cuda).manual_seed(1))
        launched = kup.upfirdn2d_cuda.launches
        with mock.patch.object(resample, "upfirdn2d", kup.upfirdn2d_plain):
            want, _ = model.enhance(y, N=4, corrector="ald", deepcache=2, deepcache_depth=depth,
                                    generator=torch.Generator(device=cuda).manual_seed(1))
    finally:
        torch.backends.cudnn.deterministic = False
    # 12 K1 calls per forward of a three-level net; depth 1: deep 11, shallow 1;
    # depth 2: deep 8, shallow 7 (level 0's down resblock and pyramid rerun)
    deep, shallow = {1: (11, 1), 2: (8, 7)}[depth]
    assert nfe == 9 and launched == 12 + 2 * deep + 8 * shallow
    scale = want.abs().max()
    assert (got - want).abs().max() <= (1e-5 if dtype == "float32" else 1e-2) * scale


@pytest.mark.parametrize("kw,forwards", [
    (dict(sampler_type="ode", method="etd2"), 1 + 2 * 4 + 1),
    (dict(sampler_type="ode", method="rk45", rtol=1e-3, atol=1e-3), None),
    (dict(sampler_type="picard", sweeps=2), 1 + 2 * 4 + 1),
    (dict(sampler_type="pc", predictor="etd", corrector="ald"), 1 + 2 * 4)],
    ids=["etd2", "rk45", "picard", "pc-etd"])
def test_probability_flow_samplers_on_the_card(cuda, kw, forwards):
    """The ODE, Picard and etd samplers of tiny StoRM (three levels: 12 K1
    calls per forward) on the card: one K1 call per forward's 12 (Picard's
    N x B rows included), and the enhancement through the kernels equal to
    the one with plain upfirdn2d (cuDNN deterministic, same noise)."""
    config = {"mode": "regen-joint-training", "nf": 16, "ch_mult": [1, 2, 2],
              "init_scale": 1.0, "n_fft": 62, "hop_length": 16}
    model = build_model(config, device=cuda, seed=0)
    y = torch.from_numpy(np.sin(np.arange(2048) / 7.0).astype(np.float32)[None]).to(cuda)
    torch.backends.cudnn.deterministic = True
    try:
        kup.upfirdn2d_cuda.launches = 0
        got, nfe = model.enhance(y, N=4, generator=torch.Generator(device=cuda).manual_seed(1),
                                 **kw)
        launched = kup.upfirdn2d_cuda.launches
        with mock.patch.object(resample, "upfirdn2d", kup.upfirdn2d_plain):
            want, _ = model.enhance(y, N=4, **kw,
                                    generator=torch.Generator(device=cuda).manual_seed(1))
    finally:
        torch.backends.cudnn.deterministic = False
    calls = {"picard": 1 + kw.get("sweeps", 0) + 1}.get(kw["sampler_type"], nfe)
    assert launched == 12 * calls and (forwards is None or nfe == forwards), (launched, nfe)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_enhance_async_on_the_card_refuses_rk45(cuda):
    config = {"mode": "regen-joint-training", "nf": 16, "ch_mult": [1, 2, 2],
              "n_fft": 62, "hop_length": 16}
    model = build_model(config, device=cuda, seed=0)
    y = np.sin(np.arange(1500) / 7.0).astype(np.float32)[None]
    x, nfe = BucketedEnhancer(model, N=2, sampler_type="ode").enhance_async(
        y, torch.Generator(device=cuda).manual_seed(0))
    assert x.is_cuda and x.shape == (1, 2048) and nfe == 1 + 4 + 1
    with pytest.raises(NotImplementedError, match="rk45"):
        BucketedEnhancer(model, N=2, sampler_type="ode", method="rk45").enhance_async(
            y, torch.Generator(device=cuda).manual_seed(0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,W", [(1, 576), (8, 256), (4, 192)])
def test_kernel_matches_plain_at_the_score_models_pyramid_shapes(cuda, dtype, B, W):
    """The score-only net's 4-channel input and output pyramids (full width,
    four levels): K1 down at 256 x W, 128 x W/2, 64 x W/4 and up at their
    halves, in both FIRs; float32 to 1e-5, bfloat16 equal with NCSN++'s FIR
    and within 1 ulp plus the sum's rounding with the asymmetric one."""
    g = torch.Generator(device=cuda).manual_seed(B * W)
    for level in range(3):
        H, Wl = 256 >> level, W >> level
        x = torch.randn(B, 4, H, Wl, device=cuda, generator=g).to(dtype)
        for kern, up, down, pad in ((SYM, 1, 2, (1, 1)), (SYM * 4, 2, 1, (2, 1)),
                                    (ASYM, 1, 2, (1, 1)), (ASYM, 2, 1, (2, 1))):
            xin = x if down == 2 else x[:, :, : H // 2, : Wl // 2].contiguous()
            got = kup.upfirdn2d_cuda(xin, kern, up=up, down=down, pad=pad)
            want = kup.upfirdn2d_plain(xin, kern, up=up, down=down, pad=pad)
            assert got.dtype == want.dtype == dtype and got.shape == want.shape
            if dtype == torch.float32:
                torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
            elif kern is not ASYM:
                assert torch.equal(got, want)
            else:
                terms = kup.upfirdn2d_plain(xin.abs().float(), np.abs(kern), up=up, down=down,
                                            pad=pad)
                w = want.float().abs().clamp_min(2.0 ** -126)
                allowed = torch.exp2(torch.floor(torch.log2(w)) - 7) + 2.0 ** -18 * terms
                assert bool(((got.float() - want.float()).abs() <= allowed).all())


@pytest.mark.parametrize("mode", ["score-only", "denoiser-only"])
def test_single_net_models_on_the_card(cuda, mode):
    """Tiny score-only and denoiser-only models (three levels: 12 K1 calls
    per forward) on the card: a training step launches 12 K1 and 10 of its
    adjoint (not the input pyramid's 2), and `enhance` through the kernels
    equals the one with plain upfirdn2d (cuDNN deterministic, same noise)."""
    config = {"mode": mode, "nf": 16, "ch_mult": [1, 2, 2], "init_scale": 1.0,
              "n_fft": 62, "hop_length": 16}
    model = build_model(config, device=cuda, seed=0).train()
    g = torch.Generator(device=cuda).manual_seed(0)
    x = 0.3 * torch.randn(2, 32, 32, 2, device=cuda, generator=g)
    batch = (x, x + 0.1 * torch.randn(2, 32, 32, 2, device=cuda, generator=g))
    kup.upfirdn2d_cuda.launches = kup.upfirdn2d_bwd_cuda.launches = 0
    model.compute_gradients(batch, *model.draw_step(batch, g))
    torch.cuda.synchronize()
    assert (kup.upfirdn2d_cuda.launches, kup.upfirdn2d_bwd_cuda.launches) == (12, 10)
    model.eval()
    y = torch.from_numpy(np.sin(np.arange(2048) / 7.0).astype(np.float32)[None]).to(cuda)
    torch.backends.cudnn.deterministic = True
    try:
        kup.upfirdn2d_cuda.launches = 0
        got, nfe = model.enhance(y, N=3, generator=torch.Generator(device=cuda).manual_seed(1))
        launched = kup.upfirdn2d_cuda.launches
        with mock.patch.object(resample, "upfirdn2d", kup.upfirdn2d_plain):
            want, _ = model.enhance(y, N=3, generator=torch.Generator(device=cuda).manual_seed(1))
    finally:
        torch.backends.cudnn.deterministic = False
    assert nfe == {"score-only": 6, "denoiser-only": 1}[mode] and launched == 12 * nfe
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_distilled_student_on_the_card(cuda):
    """A tiny distilled student (three levels: 12 K1 calls per forward; an
    euler teacher at N=2, 3 forwards) on the card: one float32 step launches
    12 x (1 + 3 + 1) K1 and 10 of its adjoint (the student's; its input
    pyramid's 2 read data only), with gradients through the kernels within
    1e-5 of plain's (global norm); `enhance` at NFE 2 launches 24 and equals
    the one with plain upfirdn2d (cuDNN deterministic, same noise)."""
    config = {"mode": "distill", "nf": 16, "ch_mult": [1, 2, 2], "init_scale": 1.0,
              "n_fft": 62, "hop_length": 16, "distill_N": 2, "distill_method": "euler"}
    model = build_model(config, device=cuda, seed=0).train()
    model.with_teacher(build_model(config, device=cuda, seed=1).score_net.state_dict())
    g = torch.Generator(device=cuda).manual_seed(0)
    x = 0.3 * torch.randn(2, 32, 32, 2, device=cuda, generator=g)
    batch = (x, x + 0.1 * torch.randn(2, 32, 32, 2, device=cuda, generator=g))
    z = model.draw_step(batch, g)

    def grads():
        model.compute_gradients(batch, *z)
        return torch.cat([p.grad.flatten() for p in model.parameters() if p.requires_grad])

    y = torch.from_numpy(np.sin(np.arange(2048) / 7.0).astype(np.float32)[None]).to(cuda)
    torch.backends.cudnn.deterministic = True
    try:
        kup.upfirdn2d_cuda.launches = kup.upfirdn2d_bwd_cuda.launches = 0
        g_kernel = grads()
        torch.cuda.synchronize()
        counts = (kup.upfirdn2d_cuda.launches, kup.upfirdn2d_bwd_cuda.launches)
        model.eval()
        kup.upfirdn2d_cuda.launches = 0
        got, nfe = model.enhance(y, generator=torch.Generator(device=cuda).manual_seed(1))
        launched = kup.upfirdn2d_cuda.launches
        with mock.patch.object(resample, "upfirdn2d", kup.upfirdn2d_plain):
            want, _ = model.enhance(y, generator=torch.Generator(device=cuda).manual_seed(1))
            model.train()
            g_plain = grads()
    finally:
        torch.backends.cudnn.deterministic = False
    assert counts == (60, 10) and nfe == 2 and launched == 24
    assert (g_kernel - g_plain).norm() <= 1e-5 * g_plain.norm()
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


GRAPH_TINY = {"mode": "regen-joint-training", "nf": 16, "ch_mult": [1, 2, 2],
              "init_scale": 1.0, "n_fft": 62, "hop_length": 16}


def _graph_waves(rows=2, T=1500):
    return np.stack([np.sin(np.arange(T) / (5.0 + i)).astype(np.float32) for i in range(rows)])


def _all_int8(model):
    """A scale of 0.5 on every conv of 16 or more input and output channels."""
    from storm_tpu_torch.nn.qconv import quantizable_convs
    return {k: {n: 0.5 for n, m in quantizable_convs(getattr(model, net)).items()
                if m.in_channels >= 16 and m.out_channels >= 16}
            for k, net in (("denoiser", "denoiser_net"), ("score", "score_net"))}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw", [
    dict(N=3, corrector="ald"), dict(N=3, sampler_type="ode", method="etd2"),
    dict(N=3, sampler_type="picard", sweeps=2), dict(N=4, corrector="ald", deepcache=2),
    dict(N=2, corrector="ald", quant="int8")],
    ids=["pc-ald", "etd2", "picard", "dc2", "int8"])
def test_graph_replay_equals_eager_on_the_card(cuda, dtype, kw):
    """Tiny StoRM: the first call (the eager loop), the second (eager
    warm-up, then the capture) and two replays, each from its own generator
    state, equal the eager loop's calls from the same states bit for bit."""
    from storm_tpu_torch.utils import graphs
    model = build_model(dict(GRAPH_TINY, dtype=dtype), device=cuda, seed=0)
    if kw.get("quant") == "int8":
        kw = dict(kw, quant=_all_int8(model))
    eager = BucketedEnhancer(model, graphs=False, **kw)
    graphed = BucketedEnhancer(model, **kw)
    y = _graph_waves()
    for seed in (0, 1, 2, 3):
        want, nfe = eager(y, torch.Generator(device=cuda).manual_seed(seed))
        got, gnfe = graphed(y, torch.Generator(device=cuda).manual_seed(seed))
        assert gnfe == nfe
        np.testing.assert_array_equal(got, want)
    stats = graphs.programs_of(model).stats
    assert (stats["first_calls"], stats["captures"], stats["replays"]) == (1, 1, 2)
    assert stats["pool_bytes"] > 0 and stats["static_bytes"] > 0


def test_graph_replays_add_their_launches_to_the_counters(cuda):
    """A replay adds to the K1 and K3 counters what the eager call launches."""
    model = build_model(GRAPH_TINY, device=cuda, seed=0)
    kw = dict(N=2, corrector="ald", quant=_all_int8(model))
    y = _graph_waves(1)
    per_call = []
    for graphs_on in (False, True, True, True, True):
        enh = BucketedEnhancer(model, graphs=graphs_on, **kw)
        before = (kup.upfirdn2d_cuda.launches, kq.quantize_int8_cuda.launches)
        enh(y, torch.Generator(device=cuda).manual_seed(0))
        per_call.append((kup.upfirdn2d_cuda.launches - before[0],
                         kq.quantize_int8_cuda.launches - before[1]))
    n_fwd = 1 + 2 * 2
    assert per_call[0][0] == 12 * n_fwd and per_call[0][1] > 0
    # eager, the first call (eager), warm-up + capture, two replays
    assert per_call == [per_call[0]] * 5


@pytest.mark.parametrize("what", ["sync", "upload"])
def test_a_capture_that_syncs_or_uploads_raises(cuda, what):
    """The body reads the device (or uploads from pageable memory) after
    its work: the first call (the eager loop) and the warm-up run, the
    capture raises naming it, and no program is kept: no eager fallback."""
    from storm_tpu_torch.utils import graphs
    model = build_model(GRAPH_TINY, device=cuda, seed=0)
    real = model.enhance

    def broken(y, **kw):
        x, nfe = real(y, **kw)
        if what == "sync":
            x = x * float(x.abs().max())
        else:
            x = x + torch.ones(x.shape[-1]).to(x.device)
        return x, nfe

    y = torch.from_numpy(_graph_waves(1)).to(cuda)
    with mock.patch.object(model, "enhance", broken):
        graphs.graphed_enhance(model, y, torch.Generator(device=cuda).manual_seed(0), N=2)
        with pytest.raises(RuntimeError, match="no eager fallback"):
            graphs.graphed_enhance(model, y, torch.Generator(device=cuda).manual_seed(0), N=2)
    assert not graphs.programs_of(model).programs
    x, _ = graphs.graphed_enhance(model, y, torch.Generator(device=cuda).manual_seed(0), N=2)
    assert torch.isfinite(x).all()


def test_moved_parameters_capture_anew_on_the_card(cuda):
    """Parameters moved to new storage drop the model's programs (their
    graphs release the pool); the next call captures into a new pool and
    its replays equal the eager loop with the moved weights."""
    from storm_tpu_torch.utils import graphs
    model = build_model(GRAPH_TINY, device=cuda, seed=0)
    y = torch.from_numpy(_graph_waves(1)).to(cuda)

    def gen(seed):
        return torch.Generator(device=cuda).manual_seed(seed)

    graphs.graphed_enhance(model, y, gen(0), N=2, warm_up=True)
    graphs.graphed_enhance(model, y, gen(1), N=2)
    p = next(model.parameters())
    p.data = p.data * 1.5  # new storage
    for seed in (2, 3):  # the capture anew, then a replay
        got, _ = graphs.graphed_enhance(model, y, gen(seed), N=2)
        want, _ = model.enhance(y, N=2, generator=gen(seed))
        assert torch.equal(got, want)
    stats = graphs.programs_of(model).stats
    assert (stats["invalidated"], stats["captures"], stats["replays"]) == (1, 2, 2)


def test_queued_batches_of_one_shape_stay_distinct(cuda):
    """The pipelined server keeps two batches of one shape in flight; each
    reply is its own batch's output (the denoiser-only model draws no
    noise, so each equals the eager loop on its input)."""
    model = build_model(dict(GRAPH_TINY, mode="denoiser-only"), device=cuda, seed=0)
    enh = BucketedEnhancer(model)
    waves = [np.sin(np.arange(1500) / (3.0 + i)).astype(np.float32) for i in range(6)]
    enh.warm_up(np.zeros((1, 2048), np.float32))  # captured before traffic
    batcher = DynamicBatcher(enh, None, max_batch=1, max_wait_ms=0.0, pipeline_depth=2)
    outs = [None] * len(waves)
    try:
        assert batcher._async

        def work(i):
            outs[i] = batcher.submit(waves[i], timeout=120)

        threads = [threading.Thread(target=work, args=(i,)) for i in range(len(waves))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        batcher.close()
    assert batcher.stats["batches"] == len(waves) and batcher.stats["errors"] == 0
    eager = BucketedEnhancer(model, graphs=False)
    for (x, _), w in zip(outs, waves):
        np.testing.assert_array_equal(x, eager(w)[0])
    assert len({x.tobytes() for x, _ in outs}) == len(waves)


def _train_waves(seed, rows=2, samples=31 * 16):
    rng = np.random.default_rng(seed)
    x = 0.3 * np.sin(np.arange(samples) / rng.uniform(3.0, 9.0, (rows, 1)))
    return (x.astype(np.float32),
            (x + 0.05 * rng.standard_normal((rows, samples))).astype(np.float32))


@pytest.mark.parametrize("mode", ["regen-joint-training", "denoiser-only"])
def test_replayed_train_step_equals_eager_on_the_card(cuda, mode):
    """A tiny bf16 model trained through the programs (the eager first call,
    the warm-up and capture, then replays) and a twin trained eagerly
    (graphs=False), from the same generator states, cuDNN deterministic:
    losses, parameters, EMA and Adam's state equal bit for bit after every
    step; each replay adds the launches the eager step makes; after a
    replay Adam's step counts and the EMA's count are on the card and
    equal the host's count."""
    from storm_tpu_torch.models.base import init_train_state
    from storm_tpu_torch.utils.train_graphs import TrainPrograms
    cfg = dict(GRAPH_TINY, mode=mode, dtype="bfloat16")
    runs = []
    for graphs_on in (True, False):
        model = build_model(cfg, device=cuda, seed=0).train()
        state = init_train_state(model, model.lr)
        runs.append((state, TrainPrograms(state, graphs=graphs_on)))
    torch.backends.cudnn.deterministic = True
    try:
        for i in range(5):
            out, launched = [], []
            for state, programs in runs:
                before = (kup.upfirdn2d_cuda.launches, kup.upfirdn2d_bwd_cuda.launches)
                aux = programs.step(_train_waves(i), torch.Generator(device=cuda).manual_seed(i))
                out.append({k: v.clone() for k, v in aux.items()})
                launched.append((kup.upfirdn2d_cuda.launches - before[0],
                                 kup.upfirdn2d_bwd_cuda.launches - before[1]))
            assert launched[0] == launched[1] and launched[0][0] > 0, (i, launched)
            assert all(torch.equal(out[0][k], out[1][k]) for k in out[1]), i
            (a, _), (b, _) = runs
            for k, v in b.model.state_dict().items():
                assert torch.equal(a.model.state_dict()[k], v) and torch.equal(a.ema[k], b.ema[k])
            for sa, sb in zip(a.optimizer.state.values(), b.optimizer.state.values()):
                assert all(torch.equal(sa[k], sb[k]) for k in sb)
    finally:
        torch.backends.cudnn.deterministic = False
    state, programs = runs[0]
    assert (programs.stats["captures"], programs.stats["replays"]) == (1, 3)
    assert state.device_step.is_cuda and int(state.device_step) == state.step == 5
    steps = [s["step"] for s in state.optimizer.state.values()]
    assert all(s.is_cuda and float(s) == 5 for s in steps)


def test_d2_graph_replay_equals_eager_on_the_card(cuda):
    """A tiny two-channel StoRM ((B, 2, T) waves): the captured program's
    replays equal the eager loop bit for bit, as at one channel."""
    model = build_model(dict(GRAPH_TINY, spatial_channels=2, dtype="bfloat16"), device=cuda,
                        seed=0)
    kw = dict(N=3, corrector="ald")
    eager, graphed = BucketedEnhancer(model, graphs=False, **kw), BucketedEnhancer(model, **kw)
    y = np.stack([_graph_waves(), _graph_waves()[::-1]], axis=1)
    for seed in (0, 1, 2, 3):
        want, _ = eager(y, torch.Generator(device=cuda).manual_seed(seed))
        got, _ = graphed(y, torch.Generator(device=cuda).manual_seed(seed))
        assert got.shape == y.shape
        np.testing.assert_array_equal(got, want)


def test_data_parallel_programs_replay_the_eager_split_step_on_the_card(cuda):
    """The data-parallel step's "grads" and "update" programs around the
    all-reduce (gloo on a card's tensor), as process 0 of 2 in a one-member
    gloo group (the sum is the identity): losses, parameters,
    EMA and Adam's state equal the eager split step's bit for bit after
    every step, cuDNN deterministic."""
    import socket

    import torch.distributed as dist

    from storm_tpu_torch.models.base import init_train_state
    from storm_tpu_torch.utils.distributed import World
    from storm_tpu_torch.utils.train_graphs import TrainPrograms
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    torch.backends.cudnn.deterministic = True
    try:
        runs = []
        for graphs_on in (True, False):
            model = build_model(dict(GRAPH_TINY, dtype="bfloat16"), device=cuda, seed=0).train()
            state = init_train_state(model, model.lr)
            runs.append((state, TrainPrograms(state, graphs=graphs_on,
                                              world=World(0, 2, "gloo", cuda))))
        for i in range(4):
            out = []
            for state, programs in runs:
                aux = programs.step(_train_waves(i), torch.Generator(device=cuda).manual_seed(i))
                out.append({k: v.clone() for k, v in aux.items()})
            assert all(torch.equal(out[0][k], out[1][k]) for k in out[1]), i
            (a, _), (b, _) = runs
            for k, v in b.model.state_dict().items():
                assert torch.equal(a.model.state_dict()[k], v) and torch.equal(a.ema[k], b.ema[k])
            for sa, sb in zip(a.optimizer.state.values(), b.optimizer.state.values()):
                assert all(torch.equal(sa[k], sb[k]) for k in sb)
    finally:
        torch.backends.cudnn.deterministic = False
        dist.destroy_process_group()
    programs = runs[0][1]
    assert (programs.stats["captures"], programs.stats["replays"]) == (2, 4)
    assert programs.stats["allreduces"] == 4 and programs.flat.is_cuda


def test_ema_update_on_the_card_is_a_fused_multiply_add(cuda):
    """The EMA on the card rounds d*e inside a fused multiply-add, as the
    reference's compiled update does: against fma emulated in float64 on
    the host (the exact product, the sum's float64 rounding then float32's:
    equal unless the float64 sum falls on a float32 midpoint), at step 1
    (d = 2/11) where the two terms are of one size."""
    from storm_tpu_torch.models.base import ema_update
    rng = np.random.default_rng(0)
    e = rng.standard_normal(1 << 20).astype(np.float32)
    p = (e + 0.1 * rng.standard_normal(e.shape)).astype(np.float32)
    ema = {"w": torch.from_numpy(e).to(cuda)}
    ema_update(ema, {"w": torch.from_numpy(p).to(cuda)}, 0.999,
               torch.ones((), dtype=torch.int32, device=cuda))
    d = np.float32(2) / np.float32(11)
    q = ((np.float32(1) - d) * p).astype(np.float32)
    want = (np.float64(d) * e.astype(np.float64) + q.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(ema["w"].cpu().numpy(), want)


# the stride-1 configuration (up = down = 1): pad 1 after upsample_conv_2d's
# transposed conv (odd sizes 2n + 1 in), pad 2 before conv_downsample_2d's
# strided one (odd sizes n + 1 out); the adjoint of pad p is the call at 3 - p
S1_SHAPES = [(1, 4, 17, 33), (2, 3, 33, 257), (1, 2, 9, 3), (1, 2, 5, 9), (2, 8, 64, 144),
             (1, 2, 45, 1), (1, 65537, 2, 3), (1, 65537, 3, 8)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "odd_offset"])
@pytest.mark.parametrize("pad0", [1, 2])
@pytest.mark.parametrize("shape", S1_SHAPES)
def test_stride1_kernel_and_adjoint_match_plain(cuda, shape, pad0, offset, dtype):
    """The stride-1 instance in both directions, both FIRs: float32 to 1e-5,
    bfloat16 within 1 ulp (equal with NCSN++'s FIR); odd widths and an odd
    base take row copies (tensors whose bytes neither start nor end on 16
    bytes among them), the rest TMA; none the element copy."""
    pad = (pad0, pad0)
    Ho, Wo = (kup.output_size(n, 4, 1, 1, pad) for n in shape[2:])
    if min(Ho, Wo) < 1:
        pytest.skip("empty output")
    n = int(np.prod(shape))
    gen = torch.Generator().manual_seed(n + pad0)
    x = torch.randn(n + offset, generator=gen).to(cuda).to(dtype)[offset:].view(shape)
    g = torch.randn(shape[:2] + (Ho, Wo), generator=gen).to(cuda).to(dtype)
    fwd, bwd = kup.upfirdn2d_cuda.launches, kup.upfirdn2d_bwd_cuda.launches
    for kernel in (SYM, ASYM):
        for got, want, terms in (
                (kup.upfirdn2d_cuda(x, kernel, pad=pad), kup.upfirdn2d_plain(x, kernel, pad=pad),
                 kup.upfirdn2d_plain(x.abs(), np.abs(kernel), pad=pad)),
                (kup.upfirdn2d_bwd_cuda(g, kernel, 1, 1, pad, shape[2:]),
                 kup.upfirdn2d_bwd_plain(g, kernel, 1, 1, pad, shape[2:]),
                 kup.upfirdn2d_bwd_plain(g.abs(), np.abs(kernel), 1, 1, pad, shape[2:]))):
            if dtype == torch.float32:
                torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
            else:
                _within_one_bf16_ulp(got, want, terms)
                if kernel is SYM:
                    assert torch.equal(got, want)
    torch.cuda.synchronize()
    assert (kup.upfirdn2d_cuda.launches, kup.upfirdn2d_bwd_cuda.launches) == (fwd + 2, bwd + 2)
    for inp, p, out_hw in ((x, pad0, (Ho, Wo)), (g, 3 - pad0, shape[2:])):
        out = torch.empty(shape[:2] + tuple(out_hw), device=cuda, dtype=dtype)
        plan = kup.launch_plan(inp, out, 1, 1, p)
        pitched = inp.data_ptr() % 16 == 0 and inp.shape[-1] * inp.element_size() % 16 == 0
        assert (plan.tma, plan.rows) == (pitched, not pitched)


def _ncsnpplarge_calls(B, W):
    """(config, shape) of the distinct upfirdn2d calls of a full-width
    ncsnpplarge forward (nf 128, ch_mult 1,1,2,2,2,2,2, 256 bins) on B rows
    of width W: down into each of the six lower levels, up out of them, at
    the resblocks' channels and the pyramids' 6 and 2; the deepest level is
    4 x W/64 (3 frames at the 1 s bucket, 9 at 4 s)."""
    chans = [128 * m for m in (1, 1, 2, 2, 2, 2, 2)]
    calls = set()
    for level in range(6):
        H, Wl = 256 >> level, W >> level
        calls |= {((1, 2, (1, 1)), (B, c, H, Wl)) for c in (chans[level], 6, 2)}
        calls |= {((2, 1, (2, 1)), (B, c, H // 2, Wl // 2)) for c in (chans[level + 1], 6, 2)}
    return sorted(calls)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("W", [192, 576])
def test_kernel_at_ncsnpplarges_deepest_widths(cuda, W, dtype):
    """ncsnpplarge's calls down to W/64 frames (rows of 3 and 9 elements:
    not multiples of 16 bytes, so the producer warp's fill, not TMA), both
    directions, NCSN++'s FIR: bfloat16 equal to plain, float32 to 1e-5."""
    gen = torch.Generator(device=cuda).manual_seed(W)
    for (up, down, pad), (B, C, H, Wl) in _ncsnpplarge_calls(1, W):
        fir = SYM * (4.0 if up == 2 else 1.0)
        x = torch.randn((B, C, H, Wl), device=cuda, generator=gen).to(dtype)
        got = kup.upfirdn2d_cuda(x, fir, up=up, down=down, pad=pad)
        g = torch.randn(got.shape, device=cuda, generator=gen).to(dtype)
        for a, b in ((got, kup.upfirdn2d_plain(x, fir, up=up, down=down, pad=pad)),
                     (kup.upfirdn2d_bwd_cuda(g, fir, up, down, pad, (H, Wl)),
                      kup.upfirdn2d_bwd_plain(g, fir, up, down, pad, (H, Wl)))):
            if dtype == torch.bfloat16:
                assert torch.equal(a, b)
            else:
                torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_ddpm_resamplers_launch_the_stride1_kernel(cuda, dtype):
    """A tiny DDPM + residual NCSN++ on the card: 12 stride-1 launches per
    forward and 12 adjoints per backward (read from its module list: one per
    convolving resampler), the output and the input gradient against the
    same net on the plain path (1e-4 of their scale in float32, 2e-2 in
    bfloat16: the convolutions' own rounding). The convolutions run without
    TF32, as `models/factory.py` sets it for a model it builds, and the flags
    are set back after the test."""
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        _check_ddpm_resamplers(cuda, dtype)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def _check_ddpm_resamplers(cuda, dtype):
    from storm_tpu_torch.backbones.ncsnpp import NCSNpp
    from storm_tpu_torch.nn.init import reset_parameters
    from storm_tpu_torch.nn.layers import Downsample, Upsample

    net = NCSNpp(input_channels=4, nf=16, ch_mult=(1, 2, 2, 2), image_size=64, init_scale=1.0,
                 resblock_type="ddpm", progressive="residual", progressive_input="residual",
                 dtype=dtype)
    reset_parameters(net, torch.Generator().manual_seed(0))
    net = net.to(cuda)
    n_calls = sum(isinstance(m, (Upsample, Downsample)) and m.fir for m in net.all_modules)
    assert n_calls == 12
    gen = torch.Generator().manual_seed(1)
    x = (0.5 * torch.randn(2, 2, 64, 64, 2, generator=gen)).to(cuda)
    t = torch.tensor([0.3, 0.8], device=cuda)
    outs = []
    for plain in (False, True):
        xg = x.clone().requires_grad_()
        with mock.patch.object(resample, "upfirdn2d", kup.upfirdn2d_plain) if plain \
                else contextlib.nullcontext():
            fwd, bwd = kup.upfirdn2d_cuda.launches, kup.upfirdn2d_bwd_cuda.launches
            out = net(xg, t)
            (grad,) = torch.autograd.grad(out.square().sum(), xg)
            torch.cuda.synchronize()
            launched = (kup.upfirdn2d_cuda.launches - fwd, kup.upfirdn2d_bwd_cuda.launches - bwd)
        assert launched == ((0, 0) if plain else (n_calls, n_calls))
        outs.append((out.detach(), grad))
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for got, want in zip(*outs):
        assert (got - want).abs().max() <= tol * want.abs().max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("extra", [
    {"backbone_denoiser": "convtasnet"}, {"backbone_denoiser": "ae-ncsnpp", "image_size": 64},
    {"backbone_score": "ncsnpplarge", "ch_mult": [1, 1, 2, 2], "num_res_blocks": 2,
     "attn_resolutions": [16], "image_size": 32},
    {"resblock_type": "ddpm", "progressive": "residual", "progressive_input": "residual"}],
    ids=["convtasnet", "ae-ncsnpp", "ncsnpplarge", "ddpm"])
def test_graph_replay_of_the_new_nets_equals_eager_on_the_card(cuda, dtype, extra):
    """StoRM with a time-domain denoiser (the iSTFT, the net and the STFT
    inside the captured program), an ncsnpplarge-layout score net, and
    DDPM + residual nets (the stride-1 instance): the eager call, the
    capture and two replays equal the eager loop bit for bit, at cuDNN's
    default flags, as the CLIs and the server run them: the transposed
    convolutions (ae-ncsnpp's decoder, ConvTasNet's, the DDPM upsampler's)
    hold cuDNN to deterministic algorithms themselves and leave the flag as
    it was."""
    from storm_tpu_torch.utils import graphs
    model = build_model(dict(GRAPH_TINY, dtype=dtype, **extra), device=cuda, seed=0)
    eager = BucketedEnhancer(model, graphs=False, N=2, corrector="ald")
    graphed = BucketedEnhancer(model, N=2, corrector="ald")
    y = _graph_waves()
    assert not torch.backends.cudnn.deterministic
    for seed in (0, 1, 2, 3):
        want, nfe = eager(y, torch.Generator(device=cuda).manual_seed(seed))
        got, gnfe = graphed(y, torch.Generator(device=cuda).manual_seed(seed))
        assert gnfe == nfe and np.isfinite(got).all()
        np.testing.assert_array_equal(got, want)
    assert not torch.backends.cudnn.deterministic
    stats = graphs.programs_of(model).stats
    assert (stats["first_calls"], stats["captures"], stats["replays"]) == (1, 1, 2)


GAGNET_TINY = {"backbone_denoiser": "gagnet", "n_fft": 126, "hop_length": 32, "fft_num": 128,
               "d_feat": 64, "c": 8, "cd1": 8, "p": 1, "q": 1, "image_size": 64}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode,stats", [("regen-joint-training", False),
                                        ("denoiser-only", False), ("denoiser-only", True)],
                         ids=["storm", "denoiser-in", "denoiser-bn-stats"])
def test_graph_replay_of_gagnet_equals_eager_on_the_card(cuda, dtype, mode, stats):
    """GaGNet as StoRM's denoiser and alone (BN served with running
    statistics): the eager call, the capture and two replays equal the eager
    loop bit for bit at cuDNN's default flags (its transposed convs hold
    cuDNN to deterministic algorithms themselves); no K1 launch of its own."""
    from storm_tpu_torch.backbones.gagnet import norm_modules
    from storm_tpu_torch.utils import graphs
    config = dict(GRAPH_TINY, **GAGNET_TINY, mode=mode, dtype=dtype,
                  norm_type="BN" if stats else "IN")
    model = build_model(config, device=cuda, seed=0)
    kw = {"N": 2, "corrector": "ald"}
    if stats:
        g = torch.Generator(device=cuda).manual_seed(3)
        kw["batch_stats"] = {n: {"mean": 0.1 * torch.randn(m.norm.weight.shape[0], device=cuda,
                                                           generator=g),
                                 "var": 0.5 + torch.rand(m.norm.weight.shape[0], device=cuda,
                                                         generator=g)}
                             for n, m in norm_modules(model.dnn).items()}
    eager = BucketedEnhancer(model, graphs=False, **kw)
    graphed = BucketedEnhancer(model, **kw)
    y = _graph_waves(T=2500)
    before = kup.upfirdn2d_cuda.launches
    for seed in (0, 1, 2, 3):
        want, nfe = eager(y, torch.Generator(device=cuda).manual_seed(seed))
        got, gnfe = graphed(y, torch.Generator(device=cuda).manual_seed(seed))
        assert gnfe == nfe and np.isfinite(got).all()
        np.testing.assert_array_equal(got, want)
    assert not torch.backends.cudnn.deterministic
    stats_ = graphs.programs_of(model).stats
    assert (stats_["first_calls"], stats_["captures"], stats_["replays"]) == (1, 1, 2)
    if mode == "denoiser-only":
        assert kup.upfirdn2d_cuda.launches == before
        if stats:
            plain, _ = BucketedEnhancer(model, graphs=False)(y)  # the batch's statistics
            assert np.abs(plain - want).max() > 1e-4


def test_int8_storm_with_gagnet_launches_k3_for_the_score_net_alone(cuda):
    """int8 StoRM with a GaGNet denoiser: calibration gives the denoiser no
    scales; per call K3 launches once per quantized conv of each score
    forward (N x 2 with ald) and K1 18 times per score forward, as the
    module list says (GaGNet adds none)."""
    from storm_tpu_torch.models import quant as quant_mod
    from storm_tpu_torch.nn.qconv import quantizable_convs
    model = build_model(dict(GRAPH_TINY, **GAGNET_TINY), device=cuda, seed=0)
    y = torch.from_numpy(_graph_waves(T=2048)).to(cuda)
    quant = quant_mod.calibrate_storm(model, y, N=2, min_channels=16,
                                      generator=torch.Generator(device=cuda).manual_seed(0))
    assert quant["denoiser"] is None and quant["score"]
    assert set(quant["score"]) <= set(quantizable_convs(model.score_net))
    n_calls = 0
    real = kup.upfirdn2d

    def counted(*args, **kwargs):
        nonlocal n_calls
        n_calls += 1
        return real(*args, **kwargs)

    with mock.patch.object(resample, "upfirdn2d", counted), torch.inference_mode():
        model.score_net(torch.zeros(1, 3, 64, 64, 2, device=cuda), torch.ones(1, device=cuda))
    k1, k3 = kup.upfirdn2d_cuda.launches, kq.quantize_int8_cuda.launches
    _, nfe = model.enhance(y, N=2, corrector="ald", quant=quant,
                           generator=torch.Generator(device=cuda).manual_seed(1))
    torch.cuda.synchronize()
    score_forwards = nfe - 1
    assert kup.upfirdn2d_cuda.launches - k1 == n_calls * score_forwards
    assert kq.quantize_int8_cuda.launches - k3 == len(quant["score"]) * score_forwards
