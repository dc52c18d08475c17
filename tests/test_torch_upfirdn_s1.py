"""Port parity: upfirdn2d's stride-1 configuration (up = down = 1), which
NCSN++'s resamplers with a 3x3 conv call between a transposed conv and the
bias (pad (1, 1)) and before a strided conv (pad (2, 2)); its adjoint, the
stride-1 call at pad0' = 3 - pad0; the kernel's launch plan for it; and the
two resamplers built on it, against storm_tpu.

The CUDA kernel itself runs only on a card (tests/test_torch_cuda.py and
chip_smoke.py hold it against the plain version there). Tolerance 1e-5
absolute and relative, as tests/test_torch_upfirdn.py: a 16-tap float32 sum.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from test_torch_upfirdn import _emulate, _read_span
from torch_parity import nchw, nhwc

from storm_tpu.kernels import upfirdn as jup
from storm_tpu.kernels import upfirdn2d_pallas
from storm_tpu.nn import resample as jres
from storm_tpu_torch.kernels import upfirdn as kup
from storm_tpu_torch.nn import resample as pres

SYM = np.outer([1, 3, 3, 1], [1, 3, 3, 1]).astype(np.float32) / 64.0
ASYM = np.random.default_rng(7).standard_normal((4, 4)).astype(np.float32)
KERNELS = {"sym": SYM, "asym": ASYM}
PADS = [(1, 1), (2, 2)]  # after upsample_conv_2d's transposed conv, before conv_downsample_2d's


def _x(C, seed=0, H=12, W=17):
    return np.random.default_rng(seed).standard_normal((2, H, W, C)).astype(np.float32)


@pytest.mark.parametrize("kname", ["sym", "asym"])
@pytest.mark.parametrize("pad", PADS)
def test_plain_matches_xla_and_pallas_interpret(pad, kname):
    x, k = _x(3), KERNELS[kname]
    got = nhwc(kup.upfirdn2d_plain(nchw(x), k, up=1, down=1, pad=pad))
    want = np.asarray(jres.upfirdn2d(jnp.asarray(x), jnp.asarray(k), pad=pad))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(upfirdn2d_pallas(jnp.asarray(x), jnp.asarray(k), up=1, down=1, pad=pad))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("H,W", [(12, 16), (13, 9)])
@pytest.mark.parametrize("kname", ["sym", "asym"])
@pytest.mark.parametrize("pad", PADS)
def test_grad_matches_reference_vjp_and_autograd_of_plain(pad, kname, H, W):
    """The gradient through `UpFirDn2d` (the adjoint call) against the
    reference's custom VJP (`_ufd_bwd`), XLA's autodiff and PyTorch's
    autodiff of the plain version."""
    k, x = KERNELS[kname], _x(3, seed=5, H=H, W=W)
    Ho, Wo = (kup.output_size(n, 4, 1, 1, pad) for n in (H, W))
    g = np.random.default_rng(6).standard_normal((2, Ho, Wo, 3)).astype(np.float32)
    xt = nchw(x).requires_grad_()
    (got,) = torch.autograd.grad(kup.upfirdn2d(xt, k, pad=pad), xt, nchw(g))
    for f in (jup.upfirdn2d, jres.upfirdn2d):
        want = np.asarray(jax.grad(
            lambda v: jnp.sum(f(v, jnp.asarray(k), up=1, down=1, pad=pad) * g))(jnp.asarray(x)))
        np.testing.assert_allclose(nhwc(got), want, atol=1e-5, rtol=1e-5)
    xp = nchw(x).requires_grad_()
    (want,) = torch.autograd.grad(kup.upfirdn2d_plain(xp, k, pad=pad), xp, nchw(g))
    np.testing.assert_allclose(nhwc(got), nhwc(want), atol=1e-5, rtol=1e-5)
    assert kup._adjoint(1, 1, pad) == (1, 1, 3 - pad[0])


def ddpm_calls(B, T, F=256, nf=128, ch_mult=(1, 2, 2, 2), pyramid=6):
    """(C, H, W, pad0) of the stride-1 upfirdn2d calls of one forward of a
    DDPM-resblock, residual-pyramid NCSN++ at (B, F, T): per down level the
    trunk's and the input pyramid's conv_downsample_2d (pad 2 on the level's
    size), per up level the output pyramid's and the trunk's
    upsample_conv_2d (pad 1 on the transposed conv's 2n + 1). Their
    adjoints are the same calls at pad 3 - pad0, on the outputs' sizes."""
    chans = [nf * m for m in ch_mult]
    L = len(ch_mult)
    calls = []
    for i in range(L - 1):
        calls += [(chans[i], F >> i, T >> i, 2), (pyramid if i == 0 else chans[i - 1],
                                                   F >> i, T >> i, 2)]
    for i in range(L - 1, -1, -1):
        if i < L - 1:  # the pyramid, from level i + 1 into level i's channels
            calls.append((chans[i], 2 * (F >> (i + 1)) + 1, 2 * (T >> (i + 1)) + 1, 1))
        if i > 0:
            calls.append((chans[i], 2 * (F >> i) + 1, 2 * (T >> i) + 1, 1))
    return [(B * C, H, W, p) for C, H, W, p in calls]


def _check_s1_plan(plan, pad0, H, W, Ho, Wo, planes, es, sms=132):
    e = 16 // es
    for n_out, start, t, tiles, step, i0, box in (
            (Ho, plan.oy0, plan.th, plan.tiles_y, plan.iy_step, plan.iy0, plan.box_h),
            (Wo, plan.ox0, plan.tw, plan.tiles_x, plan.ix_step, plan.ix0, plan.box_w)):
        assert start == 0 and tiles * t >= n_out and (tiles - 1) * t < n_out
        shift = plan.sx if box == plan.box_w else 0
        for j in range(tiles):
            lo, hi = _read_span(j * t, t, 1, 1, pad0)
            assert i0 + j * step + shift == lo
            assert hi < i0 + j * step + box
        assert 1 <= box <= kup.BOX_LIMIT
    assert plan.th % 2 == 0 and plan.tw % e == 0
    assert 0 <= plan.sx < e and plan.ix0 % e == 0 and plan.ix_step % e == 0
    assert plan.box_w == plan.tw + -(-(plan.sx + 3) // e) * e  # tw + 3 columns past sx
    assert plan.box_h == plan.th + 3
    assert plan.tma == (W % e == 0)
    stage = -(-plan.box_h * plan.box_w * es // 128) * 128
    assert plan.stages * stage + 128 <= kup.SMEM_LIMIT
    assert plan.grid == min(planes * plan.tiles_y * plan.tiles_x, kup.BLOCKS_PER_SM * sms)


@pytest.mark.parametrize("es", [2, 4], ids=["bf16", "f32"])
def test_plan_covers_every_output_once_at_the_full_width_ddpm_shapes(es):
    """The third branch of `tile_plan` at every stride-1 call and adjoint of a
    full-width DDPM + residual NCSN++ (B=1 at 256 x 576, B=8 at 256 x 256),
    and at widths 3 and 9 (ncsnpplarge's deepest level at the 1 s and 4 s
    buckets, whose rows take the producer's copy, not TMA): each output in
    exactly one tile, each box where the plain window starts, holding it,
    within TMA's limits, its first column on 16 bytes."""
    shapes = ddpm_calls(1, 576) + ddpm_calls(8, 256)
    shapes += [(planes, H, W, p) for planes, H, W, _ in shapes[:4] for p in (1, 2)
               for W in (3, 9)]
    for planes, H, W, pad0 in shapes:
        Ho, Wo = (kup.output_size(n, 4, 1, 1, (pad0, pad0)) for n in (H, W))
        # the call, and its adjoint: the output's size in, pad 3 - pad0, the input's size out
        for h, w, p, ho, wo in ((H, W, pad0, Ho, Wo), (Ho, Wo, 3 - pad0, H, W)):
            plan = kup.tile_plan(1, 1, p, h, w, ho, wo, planes, es)
            _check_s1_plan(plan, p, h, w, ho, wo, planes, es)


@pytest.mark.parametrize("es", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("H,W,pad0", [(17, 40, 1), (17, 40, 2), (41, 131, 1), (9, 3, 2),
                                      (33, 9, 1)])
def test_plan_tiles_reassemble_the_plain_output(H, W, pad0, es):
    """The tiles computed from their boxes alone, as the kernel computes
    them, give the plain version's output bit for bit, each output once."""
    x = torch.from_numpy(np.random.default_rng(H * W).standard_normal((1, 2, H, W))
                         .astype(np.float32))
    pad = (pad0, pad0)
    Ho, Wo = (kup.output_size(n, 4, 1, 1, pad) for n in (H, W))
    plan = kup.tile_plan(1, 1, pad0, H, W, Ho, Wo, 2, es, sms=1, stage_bytes=1024, max_tw=16)
    out, cover = _emulate(x, ASYM, 1, 1, pad0, Ho, Wo, plan)
    assert (cover == 1).all()
    assert torch.equal(out, kup.upfirdn2d_plain(x, ASYM, pad=pad))


@pytest.mark.parametrize("C_in,C_out", [(4, 4), (6, 8)])
def test_conv_resamplers_match_the_reference(C_in, C_out):
    """upsample_conv_2d and conv_downsample_2d with an HWIO weight carried as
    OIHW, forward and input gradient, against storm_tpu.nn.resample's."""
    rng = np.random.default_rng(C_in + C_out)
    x = rng.standard_normal((2, 8, 12, C_in)).astype(np.float32)
    w = (rng.standard_normal((3, 3, C_in, C_out)) / 6).astype(np.float32)
    w_oihw = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    for jf, pf, scale in ((jres.upsample_conv_2d, pres.upsample_conv_2d, 2),
                          (jres.conv_downsample_2d, pres.conv_downsample_2d, 0.5)):
        g = rng.standard_normal((2, int(8 * scale), int(12 * scale), C_out)).astype(np.float32)
        out, vjp = jax.vjp(lambda v: jf(v, jnp.asarray(w), k=(1, 3, 3, 1)), jnp.asarray(x))
        xt = nchw(x).requires_grad_()
        got = pf(xt, w_oihw, k=(1, 3, 3, 1))
        (grad,) = torch.autograd.grad(got, xt, nchw(g))
        np.testing.assert_allclose(nhwc(got), np.asarray(out), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(nhwc(grad), np.asarray(vjp(jnp.asarray(g))[0]), atol=1e-5,
                                   rtol=1e-5)


def test_only_ncsnpps_configurations_are_built():
    """(2, 2) has no caller in either package and stays refused; (1, 1) is
    dispatched to the plain version on the CPU and counts no launch."""
    x = nchw(_x(2, seed=4))
    with pytest.raises(ValueError, match="not built"):
        pres.upfirdn2d(x, SYM, up=2, down=2, pad=(1, 1))
    kup.upfirdn2d_cuda.launches = kup.upfirdn2d_bwd_cuda.launches = 0
    out = pres.upfirdn2d(x.requires_grad_(), SYM, pad=(2, 2))
    out.square().sum().backward()
    assert kup.upfirdn2d_cuda.launches == kup.upfirdn2d_bwd_cuda.launches == 0
    with pytest.raises(ValueError, match="CUDA tensor"):
        kup.upfirdn2d_cuda(x.detach(), SYM, pad=(1, 1))


@pytest.mark.parametrize("dim", [1, 2])
def test_conv_transpose_holds_cudnn_deterministic_for_the_call(monkeypatch, dim):
    """The port's transposed conv runs with cuDNN's deterministic flag set and
    leaves it as it found it; its result is the library call's."""
    import torch.nn.functional as F

    from storm_tpu_torch.nn.resample import conv_transpose

    name = f"conv_transpose{dim}d"
    real, seen = getattr(F, name), []

    def spy(*args, **kwargs):
        seen.append(torch.backends.cudnn.deterministic)
        return real(*args, **kwargs)

    monkeypatch.setattr(F, name, spy)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 3) + (5,) * dim, dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 4) + (3,) * dim, dtype=np.float32))
    assert not torch.backends.cudnn.deterministic
    got = conv_transpose(x, w, stride=2)
    assert seen == [True] and not torch.backends.cudnn.deterministic
    torch.testing.assert_close(got, real(x, w, stride=2), rtol=0, atol=0)
