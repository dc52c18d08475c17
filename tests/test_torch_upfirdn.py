"""Port parity: upfirdn2d's plain version against the reference's XLA lowering
and its Pallas kernel (interpret mode), the FIR resampling built on it, and
the gradient through `UpFirDn2d` against the reference's custom VJP, XLA's
autodiff and PyTorch's autodiff of the plain version.

The CUDA kernel itself runs only on a card (tests/test_torch_cuda.py and
chip_smoke.py hold it against this plain version there). Tolerance 1e-5
absolute and relative, as tests/test_kernels.py uses: a 16-tap float32 sum.
"""
import re
from pathlib import Path

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
    with pytest.raises(ValueError, match="float32 or bfloat16 only"):
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


@pytest.mark.parametrize("factor_gain", [(2, 1.0), (2, 4.0)])
def test_resample_fir_is_made_once_and_unchanged(factor_gain):
    """The FIR of upsample_2d / downsample_2d is computed once per tuple and
    equals, bit for bit, the one computed on every call before."""
    factor, gain = factor_gain
    scale = gain * factor**2
    first = pres._scaled_kernel((1, 3, 3, 1), scale)
    assert pres._scaled_kernel((1, 3, 3, 1), scale) is first
    assert not first.flags.writeable
    np.testing.assert_array_equal(first, pres.setup_kernel([1, 3, 3, 1]) * scale)
    assert first.dtype == np.float32
    x = nchw(_x(2, seed=7))
    want = kup.upfirdn2d_plain(x, pres.setup_kernel([1, 3, 3, 1]) * scale, up=2, pad=(2, 1))
    for k in ((1, 3, 3, 1), [1, 3, 3, 1]):  # a list of taps finds the same FIR
        torch.testing.assert_close(pres.upsample_2d(x, k, gain=gain), want, rtol=0, atol=0)
    assert pres._scaled_kernel((1, 3, 3, 1), scale) is first


@pytest.mark.parametrize("kname", ["sym", "asym"])
def test_launch_taps_are_converted_once(kname):
    """The launch path's taps: the float32 FIR that nn/resample.py makes once
    is passed as it is (no copy per call); other dtypes and CPU tensors become
    the same float32 values. The adjoint passes the same taps with its flag:
    the C entry reads element K*K-1-i for i, which is the FIR flipped in both
    axes, and `_adjoint` gives the swapped (up, down) and pad0' = K-pad0-1."""
    k = KERNELS[kname]
    fir = pres._scaled_kernel((1, 3, 3, 1), 4.0)
    assert kup._host_taps(fir) is fir
    for other in (k.astype(np.float64), torch.from_numpy(k)):
        got = kup._host_taps(other)
        assert got.dtype == np.float32 and got.flags.c_contiguous
        np.testing.assert_array_equal(got, k)
    np.testing.assert_array_equal(k.ravel()[::-1].reshape(4, 4), k[::-1, ::-1])
    assert kup._adjoint(1, 2, (1, 1)) == (2, 1, 2)
    assert kup._adjoint(2, 1, (2, 1)) == (1, 2, 1)


# The launch plan (`tile_plan`), which the wrapper computes on the host and
# the kernel follows: NCSN++'s pads and the others the kernel takes, at the
# bucket widths (64 k frames, k = 1..9) of every level, in both storage types.
PLAN_PADS = [-1, 0, 1, 2]
BUCKET_WIDTHS = [64 * k for k in range(1, 10)]


def _level_calls(W, H=256):
    """(up, down, H, W) of the forward calls at one bucket width: down out of
    each of the three upper levels, up into them."""
    return ([(1, 2, H >> i, W >> i) for i in range(3)]
            + [(2, 1, H >> i, W >> i) for i in range(1, 4)])


def _read_span(o0, n, up, down, pad0):
    """First and last input index that outputs o0 .. o0+n-1 read with a
    nonzero tap in the plain version: inputs i with up*i = down*o + k - pad0."""
    lo = -(-(down * o0 - pad0) // up)
    hi = (down * (o0 + n - 1) + 3 - pad0) // up
    return lo, hi


def _check_plan(plan, up, down, pad0, H, W, Ho, Wo, planes, es, sms=132):
    e = 16 // es
    for n_out, start, t, tiles, step, i0, box in (
            (Ho, plan.oy0, plan.th, plan.tiles_y, plan.iy_step, plan.iy0, plan.box_h),
            (Wo, plan.ox0, plan.tw, plan.tiles_x, plan.ix_step, plan.ix0, plan.box_w)):
        # the tiles cover [start, start + tiles*t) without overlap: every
        # output once, and no tile lies wholly outside the image
        assert -t < start <= 0 and start + tiles * t >= n_out and start + (tiles - 1) * t < n_out
        shift = plan.sx if box == plan.box_w else 0  # columns of the box before the window
        for j in range(tiles):
            lo, hi = _read_span(start + j * t, t, up, down, pad0)
            assert i0 + j * step + shift == lo  # the window starts where the plain one does
            assert hi < i0 + j * step + box  # and the box holds every input the tile reads
        assert 1 <= box <= kup.BOX_LIMIT  # TMA: at most 256 elements per dimension
    assert plan.th % 2 == 0 and plan.tw % (e if up == 1 else 2 * e) == 0
    # TMA: a box's first column on 16 bytes (it faults otherwise), its width too
    assert 0 <= plan.sx < e and plan.ix0 % e == 0 and plan.ix_step % e == 0
    assert (plan.box_w * es) % 16 == 0
    # the kernel's items read 2*tw (down) or tw/2 (up) columns past sx, and 2
    # more, in whole chunks
    tail = -(-(plan.sx + 2) // e) * e
    assert plan.box_w == (2 * plan.tw if up == 1 else plan.tw // 2) + tail
    assert plan.tma == (W % e == 0)  # TMA: the row stride a multiple of 16 bytes
    stage = -(-plan.box_h * plan.box_w * es // 128) * 128  # each box on 128 bytes
    assert plan.stages * stage + 128 <= kup.SMEM_LIMIT
    tiles = planes * plan.tiles_y * plan.tiles_x
    assert plan.grid == min(tiles, kup.BLOCKS_PER_SM * sms)


@pytest.mark.parametrize("es", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("pad0", PLAN_PADS)
@pytest.mark.parametrize("up,down", [(1, 2), (2, 1)])
def test_plan_covers_every_output_once_from_the_plain_window(up, down, pad0, es):
    """At every bucket width and level, for NCSN++'s 128 / 256 channels and
    the pyramids' 6, and for 1 row or column: each output lies in exactly
    one tile, each box starts where the plain version's window for its tile
    starts, holds all of it, and is within TMA's limits."""
    shapes = [c[2:] for W in BUCKET_WIDTHS for c in _level_calls(W) if c[:2] == (up, down)]
    for H, W in shapes + [(1, 1), (1, 70), (45, 1), (17, 131)]:
        Ho, Wo = (kup.output_size(n, 4, up, down, (pad0, 1)) for n in (H, W))
        if min(Ho, Wo) < 1:
            continue
        for planes in (6, 256, 65537):
            plan = kup.tile_plan(up, down, pad0, H, W, Ho, Wo, planes, es)
            _check_plan(plan, up, down, pad0, H, W, Ho, Wo, planes, es)


@pytest.mark.parametrize("es", [2, 4], ids=["bf16", "f32"])
def test_plan_splits_the_bucket_widths_into_whole_tiles(es):
    """NCSN++'s calls (pad0 1 down, 2 up: an adjoint is the other config's
    call at the same sizes) at every bucket width: whole column tiles,
    16-byte stores, TMA boxes, and a
    ring of STAGES boxes of at most STAGE_BYTES, at least half of it full on
    the wide calls (a bfloat16 box holds as many bytes as a float32 one)."""
    for W in BUCKET_WIDTHS:
        for up, down, H, Wi in _level_calls(W):
            pad0 = 1 if up == 1 else 2
            Ho, Wo = (kup.output_size(n, 4, up, down, (pad0, 1)) for n in (H, Wi))
            plan = kup.tile_plan(up, down, pad0, H, Wi, Ho, Wo, 256, es)
            assert Wo % plan.tw == 0 and plan.tma and plan.vec_out
            assert plan.stages == kup.STAGES
            box = plan.box_h * plan.box_w * es
            assert box <= kup.STAGE_BYTES
            if H >= 128 and Wi >= 256:
                assert box >= kup.STAGE_BYTES // 2


def _emulate(x, k, up, down, pad0, Ho, Wo, plan):
    """The kernel's tiling on the CPU: each tile's outputs from its box alone
    (zeros outside x: TMA's fill), stored where they fall in the image.
    Returns (output, how many tiles stored each output)."""
    B, C, H, W = x.shape
    out = torch.zeros(B, C, Ho, Wo)
    cover = torch.zeros(Ho, Wo, dtype=torch.int64)
    for oy, ox, iy, ix in plan.tiles():
        box = torch.zeros(B, C, plan.box_h, plan.box_w)
        ys = range(max(iy, 0), min(iy + plan.box_h, H))
        xs = range(max(ix, 0), min(ix + plan.box_w, W))
        if len(ys) and len(xs):
            box[:, :, ys.start - iy:ys.stop - iy, xs.start - ix:xs.stop - ix] = \
                x[:, :, ys.start:ys.stop, xs.start:xs.stop]
        # the window starts sx columns into the box: pad 0 from there
        tile = kup.upfirdn2d_plain(box[..., plan.sx:].contiguous(), k, up=up, down=down,
                                   pad=(0, 0))
        assert tile.shape[-2] >= plan.th and tile.shape[-1] >= plan.tw
        r0, r1 = max(oy, 0), min(oy + plan.th, Ho)
        c0, c1 = max(ox, 0), min(ox + plan.tw, Wo)
        out[:, :, r0:r1, c0:c1] = tile[:, :, r0 - oy:r1 - oy, c0 - ox:c1 - ox]
        cover[r0:r1, c0:c1] += 1
    return out, cover


# small shapes whose output is not empty; a small stage budget and column
# tile, so that each shape takes several tiles in both axes
EMULATED = [(H, W, up, down, pad0) for H, W in [(17, 40), (41, 131), (2, 9)]
            for up, down in [(1, 2), (2, 1)] for pad0 in PLAN_PADS
            if min(kup.output_size(n, 4, up, down, (pad0, 1)) for n in (H, W)) >= 1]


@pytest.mark.parametrize("es", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("H,W,up,down,pad0", EMULATED)
def test_plan_tiles_reassemble_the_plain_output(H, W, up, down, pad0, es):
    """The tiles computed from their boxes alone, as the kernel computes them,
    give the plain version's output bit for bit, each output once."""
    rng = np.random.default_rng(H * W + pad0)
    x = torch.from_numpy(rng.standard_normal((1, 2, H, W)).astype(np.float32))
    k = ASYM * (4.0 if up == 2 else 1.0)
    pad = (pad0, 1)
    Ho, Wo = (kup.output_size(n, 4, up, down, pad) for n in (H, W))
    plan = kup.tile_plan(up, down, pad0, H, W, Ho, Wo, 2, es, sms=1, stage_bytes=1024,
                         max_tw=16)
    out, cover = _emulate(x, k, up, down, pad0, Ho, Wo, plan)
    assert (cover == 1).all()
    assert torch.equal(out, kup.upfirdn2d_plain(x, k, up=up, down=down, pad=pad))


def test_plan_args_are_the_plan_in_the_kernels_order():
    """The C entry's int array holds the plan's fields in `PlanField`'s order
    (csrc/upfirdn2d.cu), and one array serves every call of a shape."""
    key = (2, 1, 2, 128, 288, 256, 576, 256, 2, True, True, 132)
    args = kup._plan_args(*key)
    assert list(args) == list(kup.tile_plan(*key))
    assert kup._plan_args(*key) is args
    src = (Path(kup.__file__).parent.parent / "csrc" / "upfirdn2d.cu").read_text()
    fields = re.search(r"enum PlanField \{([^}]*)\}", src).group(1)
    names = [f.strip() for f in fields.split(",") if f.strip()]
    assert names[-1] == "kPlanLen" and len(names) - 1 == len(kup.TilePlan._fields)
    assert names[:-1] == ["k" + "".join(w.capitalize() for w in f.split("_"))
                          for f in kup.TilePlan._fields]
