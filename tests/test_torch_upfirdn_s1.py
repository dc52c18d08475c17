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
from test_torch_upfirdn import _read_span
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


def _check_s1_plan(plan, pad0, H, W, Ho, Wo, planes, es, sms=132, x_aligned=True):
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
    # strips of STRIP_ROWS rows, columns in whole 16 bytes
    assert plan.th % kup.STRIP_ROWS == 0 and plan.tw % e == 0
    assert 0 <= plan.sx < e and plan.ix0 % e == 0 and plan.ix_step % e == 0
    # TMA where the rows allow it, else each row by a bulk copy at its own shift (< e); a
    # lane reads three aligned groups from its columns wherever the window starts: tw + 2e
    assert plan.tma == (x_aligned and W % e == 0) and plan.rows == 1 - plan.tma
    assert plan.box_w == plan.tw + 2 * e
    assert plan.box_h == plan.th + 3
    assert plan.vec_out == 0
    stage = -(-plan.box_h * plan.box_w * es // 128) * 128
    assert plan.stages * stage + 128 + kup.STAGING_BYTES <= kup.SMEM_LIMIT
    assert plan.grid == min(planes * plan.tiles_y * plan.tiles_x, kup.BLOCKS_PER_SM * sms)


def _full_width_shapes():
    """(planes, H, W, pad0) of every stride-1 call of a full-width DDPM + residual NCSN++
    (B=1 at 256 x 576, B=8 at 256 x 256), and of the first four at widths 3 and 9
    (ncsnpplarge's deepest level at the 1 s and 4 s buckets)."""
    shapes = ddpm_calls(1, 576) + ddpm_calls(8, 256)
    return shapes + [(planes, H, W, p) for planes, H, W, _ in shapes[:4] for p in (1, 2)
                     for W in (3, 9)]


def _calls_and_adjoints(shapes):
    """(planes, H, W, pad0, Ho, Wo) of each call and of its adjoint: the output's size in,
    pad 3 - pad0, the input's size out."""
    for planes, H, W, pad0 in shapes:
        Ho, Wo = (kup.output_size(n, 4, 1, 1, (pad0, pad0)) for n in (H, W))
        yield planes, H, W, pad0, Ho, Wo
        yield planes, Ho, Wo, 3 - pad0, H, W


@pytest.mark.parametrize("es", [2, 4], ids=["bf16", "f32"])
def test_plan_covers_every_output_once_at_the_full_width_ddpm_shapes(es):
    """The third branch of `tile_plan` at every stride-1 call and adjoint of a
    full-width DDPM + residual NCSN++ (B=1 at 256 x 576, B=8 at 256 x 256),
    and at widths 3 and 9 (ncsnpplarge's deepest level at the 1 s and 4 s
    buckets): each output in exactly one tile, each box where the plain
    window starts, holding it, within TMA's limits, its first column on 16
    bytes; every call's box by TMA or by row copies, none element by element."""
    for planes, h, w, p, ho, wo in _calls_and_adjoints(_full_width_shapes()):
        _check_s1_plan(kup.tile_plan(1, 1, p, h, w, ho, wo, planes, es), p, h, w, ho, wo,
                       planes, es)
    # an input whose address is off 16 bytes: row copies whatever the width
    plan = kup.tile_plan(1, 1, 2, 64, 64, 65, 65, 8, es, x_aligned=False)
    _check_s1_plan(plan, 2, 64, 64, 65, 65, 8, es, x_aligned=False)


def _floor16(a):
    return a // 16 * 16


def _emulate_s1(x, k, pad0, Ho, Wo, plan, es, base=0):
    """The stride-1 kernel on the CPU as it loads and reads its stages, for an
    input of `es`-byte elements whose first element lies at byte address
    `base` (a multiple of es). A TMA box: zeros outside x. Row copies
    (`copy_rows`): each box row inside [0, H) from the 16-byte floor of its
    first window column inside the row to the ceiling of its last, clamped
    to the 16-byte boundaries inside the tensor, the left-out elements one
    by one; every copy's source 16-byte aligned, whole 16 bytes, inside the
    tensor and its stage row. Every other stage element starts as NaN. The
    consumers (`strip`) read each stage row at its shift, sx or (the
    window's address mod 16) / es, and select zero for columns and rows
    outside x. Returns (output, how many tiles stored each output, the
    bytes read, as (start, end) ranges)."""
    B, C, H, W = x.shape
    flat = x.reshape(-1)
    n = flat.numel()
    lo16, hi16 = _floor16(base + 15), _floor16(base + n * es)
    e = 16 // es
    out = torch.zeros(B * C, Ho, Wo)
    cover = torch.zeros(Ho, Wo, dtype=torch.int64)
    reads = []
    h, w = plan.th + 3, plan.tw + 3  # the window of a tile
    for oy, ox, iy, ix in plan.tiles():
        wx = ix + plan.sx
        windows = torch.zeros(B * C, h, w)
        for plane in range(B * C):
            stage = torch.full((plan.box_h, plan.box_w), float("nan"))
            shifts = [plan.sx] * plan.box_h
            for r in range(plan.box_h):
                gy = iy + r
                if not 0 <= gy < H:
                    if plan.tma:
                        stage[r] = 0.0
                    continue
                row = (plane * H + gy) * W
                if plan.tma:  # the box from its 16-byte first column, zero fill outside
                    assert (base + (row + ix) * es) % 16 == 0 or ix < 0
                    cols = torch.arange(ix, ix + plan.box_w)
                    inside = (cols >= 0) & (cols < W)
                    stage[r] = torch.where(inside, flat[row + cols.clamp(0, W - 1)], 0.0)
                    reads.append((base + (row + max(ix, 0)) * es,
                                  base + (row + min(ix + plan.box_w, W)) * es))
                    continue
                c_lo, c_hi = max(wx, 0), min(wx + plan.tw + 3, W)
                if c_lo >= c_hi:
                    continue
                row_a = _floor16(base + (row + wx) * es)
                shifts[r] = (base + (row + wx) * es - row_a) // es
                a_lo, a_hi = base + (row + c_lo) * es, base + (row + c_hi) * es
                c0 = max(_floor16(a_lo), lo16)
                c1 = min(_floor16(a_hi + 15), hi16)
                pieces = []
                if c1 > c0:
                    assert c0 % 16 == 0 and (c1 - c0) % 16 == 0 and (c0 - row_a) % 16 == 0
                    pieces.append((c0, c1))
                else:
                    c0 = c1 = a_hi
                pieces += [(a, a + es) for a in range(a_lo, min(c0, a_hi), es)]
                pieces += [(a, a + es) for a in range(max(c1, a_lo), a_hi, es)]
                for a0, a1 in pieces:
                    assert 0 <= a0 - row_a and a1 - row_a <= plan.box_w * es
                    i0 = (a0 - base) // es
                    stage[r, (a0 - row_a) // es:(a1 - row_a) // es] = flat[i0:i0 + (a1 - a0) // es]
                    reads.append((a0, a1))
            for r in range(h):
                gy = iy + r
                cols = torch.arange(wx, wx + w)
                vals = stage[r, shifts[r]:shifts[r] + w]
                inside = (cols >= 0) & (cols < W) & (0 <= gy < H)
                windows[plane, r] = torch.where(inside, vals, 0.0)
        assert not torch.isnan(windows).any()
        tile = kup.upfirdn2d_plain(windows[None], k, pad=(0, 0))[0]
        assert tile.shape[-2:] == (plan.th, plan.tw)
        r0, r1 = max(oy, 0), min(oy + plan.th, Ho)
        c0, c1 = max(ox, 0), min(ox + plan.tw, Wo)
        out[:, r0:r1, c0:c1] = tile[:, r0 - oy:r1 - oy, c0 - ox:c1 - ox]
        cover[r0:r1, c0:c1] += 1
    return out.reshape(B, C, Ho, Wo), cover, reads


def _check_emulated(x, pad0, plan, es, base=0):
    H, W = x.shape[-2:]
    Ho, Wo = (kup.output_size(n, 4, 1, 1, (pad0, pad0)) for n in (H, W))
    out, cover, reads = _emulate_s1(x, ASYM, pad0, Ho, Wo, plan, es, base)
    assert (cover == 1).all()
    assert torch.equal(out, kup.upfirdn2d_plain(x, ASYM, pad=(pad0, pad0)))
    return reads


@pytest.mark.parametrize("es", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("H,W,pad0", [(17, 40, 1), (17, 40, 2), (41, 131, 1), (9, 3, 2),
                                      (33, 9, 1)])
def test_plan_tiles_reassemble_the_plain_output(H, W, pad0, es):
    """The tiles computed from their stages alone, loaded and read as the
    kernel loads and reads them, give the plain version's output bit for
    bit, each output once (a small stage budget, so that each shape takes
    several tiles in both axes)."""
    x = torch.from_numpy(np.random.default_rng(H * W).standard_normal((1, 2, H, W))
                         .astype(np.float32))
    Ho, Wo = (kup.output_size(n, 4, 1, 1, (pad0, pad0)) for n in (H, W))
    for x_aligned in (True, False):
        plan = kup.tile_plan(1, 1, pad0, H, W, Ho, Wo, 2, es, x_aligned, sms=1,
                             stage_bytes=2048, max_tw=16)
        assert plan.rows == (not x_aligned or W % (16 // es) != 0)
        _check_emulated(x, pad0, plan, es)


@pytest.mark.parametrize("es", [2, 4], ids=["bf16", "f32"])
def test_full_width_ddpm_tiles_reassemble_the_plain_output(es):
    """Every stride-1 call and adjoint of a full-width DDPM + residual NCSN++
    (B=1 at 256 x 576, B=8 at 256 x 256) and the calls at widths 3 and 9,
    with the plan of the call's own plane count, emulated on two of its
    planes (the tensor then ends after the second): each output once, bit
    for bit the plain version with the asymmetric FIR, no byte read outside
    the tensor."""
    rng = np.random.default_rng(es)
    for planes, h, w, p, ho, wo in _calls_and_adjoints(_full_width_shapes()):
        plan = kup.tile_plan(1, 1, p, h, w, ho, wo, planes, es)
        x = torch.from_numpy(rng.standard_normal((1, 2, h, w)).astype(np.float32))
        reads = _check_emulated(x, p, plan, es)
        assert min(a for a, _ in reads) >= 0 and max(b for _, b in reads) <= x.numel() * es


@pytest.mark.parametrize("es", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("H,W,base", [(5, 3, 1), (7, 9, 3), (6, 131, 1), (4, 2, 5)])
def test_row_copies_never_read_outside_the_tensor(H, W, base, es):
    """Rounding a row's span to 16 bytes never reaches past the tensor, also
    where the tensor neither starts nor ends on 16 bytes (its first element
    `base` elements past a boundary, a byte count off 16) and rows hold
    fewer than 16 bytes: the ends go element by element, and every output
    still equals the plain version's once."""
    x = torch.from_numpy(np.random.default_rng(W + base).standard_normal((1, 3, H, W))
                         .astype(np.float32))
    start, end = base * es, (base + x.numel()) * es
    for pad0 in (1, 2):
        Ho, Wo = (kup.output_size(n, 4, 1, 1, (pad0, pad0)) for n in (H, W))
        plan = kup.tile_plan(1, 1, pad0, H, W, Ho, Wo, 3, es, x_aligned=False, sms=1,
                             stage_bytes=2048, max_tw=32)
        assert plan.rows and not plan.tma
        reads = _check_emulated(x, pad0, plan, es, base=start)
        assert all(start <= a < b <= end for a, b in reads)
        assert any(b - a == es for a, b in reads)  # some ends went by element


def test_row_copies_serve_the_stride_1_instance_only():
    """The chunked configurations keep the element copy where TMA cannot
    load a box, and 16-byte stores where the output's rows allow them; the
    stride-1 instance copies such rows; `paths` names each for printing."""
    plan = kup.tile_plan(1, 2, 1, 9, 9, 5, 5, 4, 4)
    assert not plan.tma and not plan.rows and not plan.vec_out
    assert kup.paths(plan, 1, 2) == ("element copy", "lane-strided elements")
    plan = kup.tile_plan(2, 1, 2, 8, 8, 16, 16, 4, 4)
    assert plan.tma and not plan.rows and plan.vec_out
    assert kup.paths(plan, 2, 1) == ("TMA box", "16-byte chunks")
    plan = kup.tile_plan(1, 1, 1, 9, 9, 8, 8, 4, 4)
    assert not plan.tma and plan.rows and not plan.vec_out
    assert kup.paths(plan, 1, 1) == ("row copy", "warp rows")


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
