"""upfirdn2d: zero-insert upsample -> pad -> FIR -> downsample, on NCHW tensors
of float32 or bfloat16 (the sum in float32, the output in the input's type).

Replaces the Pallas TPU kernel `upfirdn2d_pallas` (storm_tpu/kernels/upfirdn.py,
`pl.pallas_call` in its body) with a CUDA kernel written for sm_90a
(`csrc/upfirdn2d.cu`). NCSN++ calls it 18 times per forward (down and up
BigGAN resblocks, input and output pyramids), always with a 4x4 FIR, in the
configurations up=1, down=2, pad=(1, 1) and up=2, down=1, pad=(2, 1); its
options with convolving resamplers (the DDPM resblock's levels, the
`residual` pyramids) call it at up=1, down=1 between a transposed 3x3 conv and
the bias (pad (1, 1)) or before a strided one (pad (2, 2)). The reference's
(2, 2) has no caller in either package and is not built.

Bound on the card: memory. The op does at most 16 multiply-adds per output
and reads each input once from device memory, so the least time is
(input bytes + output bytes) / 3.35 TB/s: 4 bytes per element in float32, 2
in bfloat16. The kernel moves only those bytes: each output tile's input box
arrives in shared memory by one TMA copy, whose zero fill writes the pad and
the crop (the zero-insertion becomes taps skipped at compile time), through
a ring of stages that persistent blocks keep loading while they compute, and
outputs leave 16 bytes per thread; the Pallas kernel instead wrote the
zero-inserted, padded input to memory first. On an NVIDIA H100 80GB HBM3 at
700 W the 18 calls of a full-width score forward take 1.53x that bound in
bfloat16 and 1.33x in float32 (chip_smoke.py; PERF.md §6). The stride-1
calls read or write rows that are not whole 16 bytes (2n + 1 or n + 1
wide): their boxes arrive by TMA where the input allows it and otherwise
row by row through the copy engine's 1-D bulk copies (`rows`), and their
outputs leave a row at a time, 32 neighbouring ones per warp store
(`paths` names a plan's load and store paths).
`tile_plan` computes each launch's tiles, boxes and grid here, on the host
(cached per shape), so the CPU tests hold it: every output in exactly one
tile, every tile's window where the plain version's starts, every box within
TMA's limits (a box's first column on 16 bytes among them). Per call
the launch path reads the taps' address; their conversion to float32 is a
no-op for the read-only float32 FIR that `nn/resample.py` makes once, and
the adjoint's flip happens where the C entry copies them.

The gradient replaces the reference's custom VJP (`_ufd_bwd`, same file): the
adjoint of upfirdn2d is upfirdn2d again with the taps flipped, up and down
swapped and pad0' = K - pad0 - 1, cut to the input's size. At NCSN++'s
configurations the backward of the down config is the up config (pad0 2)
and vice versa (pad0 1), and the adjoint of the stride-1 call at pad0 is
the stride-1 call at 3 - pad0, so the same kernel serves both directions.

`upfirdn2d` goes through the autograd Function `UpFirDn2d` on every device
and dispatches on the tensor's device in both directions: a CUDA tensor
launches the kernel (or raises), a CPU tensor takes `upfirdn2d_plain`, the
same function written tap by tap in PyTorch. The FIR taps are a host-side
float32 constant (numpy array or CPU tensor), as in the reference where they
are fixed at build time; the reference casts them to x's type, which leaves
the NCSN++ FIR (outer([1,3,3,1]) / 64, times 4 for up) exact in bfloat16.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Iterator, NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from . import build

_CONFIGS = {(1, 2), (2, 1), (1, 1)}  # (up, down) pairs the kernel is built for
_TAPS = 4
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the kernel's dtype codes

# The launch plan's defaults and the kernel's limits (csrc/upfirdn2d.cu).
STAGES = 4  # boxes in each block's ring
STAGE_BYTES = 24 << 10  # a box's budget: its rows follow from its columns
MAX_TW = 144  # widest column tile asked for (the boxes cap it further)
STRIP_ROWS = 8  # the stride-1 instance's output rows per consumer item (kStripRows)
WARP_COLS = 32 * 4  # the columns of its consumer warp's item: 32 lanes of 4 (kLaneCols)
STAGING_BYTES = 8 * WARP_COLS * 4  # its consumer warps' staging rows (kStagingBytes)
MIN_TH = 8  # narrowest row tile that spreading a small call goes down to
BOX_LIMIT = 256  # TMA: elements per box dimension
SMEM_LIMIT = 112 << 10  # a block's ring: two blocks on an SM
BLOCKS_PER_SM = 2  # resident blocks (__launch_bounds__ and SMEM_LIMIT hold two)


class TilePlan(NamedTuple):
    """One launch's plan, in the order of the kernel's `PlanField`. Tile
    (ty, tx) of a plane holds outputs [oy0 + ty*th, + th) x [ox0 + tx*tw, + tw)
    (those outside the image are not stored) and reads the box of box_h x
    box_w inputs at (iy0 + ty*iy_step, ix0 + tx*ix_step), zeros outside; its
    window (the first input its outputs read) is the box's column sx: a box
    starts on 16 bytes, as a TMA copy must. With `rows`, box_w is the pitch
    of a stage's rows, each copied from the 16-byte boundary before its
    window column 0, which then sits (its address mod 16) / elem_bytes
    columns in, not sx."""
    th: int
    tw: int
    tiles_y: int
    tiles_x: int
    oy0: int
    ox0: int
    iy0: int
    ix0: int
    iy_step: int
    ix_step: int
    box_h: int
    box_w: int
    grid: int
    stages: int
    tma: int  # boxes by TMA; 0: row copies (`rows`) or the producer warp's element copy
    vec_out: int  # 16-byte stores where a chunk lies in the row (not the stride-1 instance)
    sx: int
    rows: int  # each box row by a 1-D bulk copy at its own shift (the stride-1 instance)

    def tiles(self) -> Iterator[Tuple[int, int, int, int]]:
        """(output row, output column, box row, box column) of each tile of a plane."""
        for ty in range(self.tiles_y):
            for tx in range(self.tiles_x):
                yield (self.oy0 + ty * self.th, self.ox0 + tx * self.tw,
                       self.iy0 + ty * self.iy_step, self.ix0 + tx * self.ix_step)


def _best_tile(span: int, unit: int, limit: int, box_of, whole: bool = False) -> int:
    """The tile (a multiple of `unit`, at most `limit`) whose boxes, one per
    tile over `span` outputs, read the fewest inputs (`box_of(tile)` each:
    the overshoot past the image and the halo both cost); on a tie the one
    that overshoots least, then the larger. `whole`: among the tiles that
    divide `span` where there are any."""
    tiles = range(unit, max(unit, limit) + 1, unit)
    if whole and any(span % t == 0 for t in tiles):
        tiles = [t for t in tiles if span % t == 0]
    return min(tiles, key=lambda t: (-(-span // t) * box_of(t), -(-span // t) * t, -t))


@functools.lru_cache(maxsize=4096)
def tile_plan(up: int, down: int, pad0: int, H: int, W: int, Ho: int, Wo: int, planes: int,
              elem_bytes: int, x_aligned: bool = True, out_aligned: bool = True, sms: int = 132,
              stages: int = STAGES, stage_bytes: int = STAGE_BYTES, max_tw: int = None) -> TilePlan:
    """The kernel's tiles, boxes and grid for one call (`x_aligned` /
    `out_aligned`: the tensor's address is a multiple of 16 bytes; `sms`:
    the card's multiprocessors; `max_tw`: the widest column tile, by default
    MAX_TW, at stride 1 only the box's limit).

    An item of the kernel is one 16-byte chunk of outputs (e = 16 /
    elem_bytes) in two rows; the up config's items read in pairs, so its
    column tile is a multiple of 2e, the down config's of e. The stride-1
    instance's item is a warp's: STRIP_ROWS output rows by up to WARP_COLS
    columns, 4 a lane; its tiles are multiples of e columns and STRIP_ROWS
    rows, and its column tile the one that leaves the fewest lanes idle (its
    warps compute ceil(tw / WARP_COLS) x WARP_COLS columns), then reads the
    fewest inputs. A box starts on 16 bytes (a TMA copy faults otherwise),
    sx columns before its window, and spans the columns the items read
    (2*tw or tw/2, and the sx + 2 more, rounded up to 16 bytes): at most
    256. At stride 1 the window starts up to e - 1 columns into a box row,
    in a TMA box and a row copy alike, and a lane reads three aligned
    groups of four from its columns, so the box spans tw + 2e columns.
    Where TMA cannot load the box (a row pitch or base off 16 bytes), the
    stride-1 instance copies each box row from the 16-byte boundary before
    its window; the other configurations take the producer warp's element
    copy. Each tile is the one whose boxes read the fewest inputs over the
    row or column, the column tile among those that divide the row where
    any do (so the 64 k-frame bucket widths split into whole tiles), the
    row tile within the box's byte budget, its limit halved while the call
    has fewer tiles than resident blocks (down to MIN_TH rows), so a small
    call spreads its copies over the card."""
    if (up, down) not in _CONFIGS:
        raise ValueError(f"upfirdn2d: (up, down)={(up, down)} not built")
    stride1 = up == down == 1
    e = 16 // elem_bytes
    reach = 2  # the window's columns past the tile's span, less one
    unit_h = 2
    if up == 1:  # output o reads inputs down*o - pad0 .. + 3
        oy0 = ox0 = 0
        wy0, wx0 = -pad0, -pad0  # tile 0's window
        if down == 2:
            unit_w, span_of, of_span = e, (lambda tw: 2 * tw), (lambda cols: cols // 2)
            box_h_of, th_of_rows = (lambda th: 2 * th + 2), (lambda rows: (rows - 2) // 2)
        else:
            reach, unit_h = 3, STRIP_ROWS
            unit_w, span_of, of_span = e, (lambda tw: tw), (lambda cols: cols)
            box_h_of, th_of_rows = (lambda th: th + 3), (lambda rows: rows - 3)
    else:  # a tile starts on an even zero-inserted coordinate: the lead
        oy0 = ox0 = -(pad0 & 1)
        wy0 = wx0 = (ox0 - pad0) // 2  # (o - pad0) is even at a tile's first output
        unit_w, span_of, of_span = 2 * e, (lambda tw: tw // 2), (lambda cols: 2 * cols)
        box_h_of, th_of_rows = (lambda th: th // 2 + 2), (lambda rows: 2 * (rows - 2))
    sx = wx0 % e  # the box starts on 16 bytes, sx columns before the window
    tma = x_aligned and W % e == 0
    rows = stride1 and not tma
    tail = -(-((e - 1 if stride1 else sx) + reach) // e) * e  # the box's columns past the tile
    box_w_of = lambda tw: span_of(tw) + tail  # noqa: E731
    if max_tw is None:
        max_tw = BOX_LIMIT if stride1 else MAX_TW
    tw_limit = max(unit_w, min(of_span(BOX_LIMIT - tail), max_tw) // unit_w * unit_w)
    if stride1:
        lane_cols = lambda tw: -(-tw // WARP_COLS) * WARP_COLS  # noqa: E731
        tw = min(range(unit_w, tw_limit + 1, unit_w),
                 key=lambda t: (-(-Wo // t) * lane_cols(t), -(-Wo // t) * box_w_of(t), -t))
    else:
        tw = _best_tile(Wo - ox0, unit_w, tw_limit, box_w_of, whole=True)
    box_w = box_w_of(tw)
    n_rows = min(BOX_LIMIT, stage_bytes // (box_w * elem_bytes))
    th_limit = th_of_rows(n_rows) // unit_h * unit_h
    if th_limit < unit_h:
        raise ValueError(f"upfirdn2d: a stage of {stage_bytes} bytes holds no tile")
    staging = STAGING_BYTES if stride1 else 0
    if stages * (-(-box_h_of(th_limit) * box_w * elem_bytes // 128) * 128) + 128 + staging \
            > SMEM_LIMIT:
        raise ValueError(f"upfirdn2d: {stages} stages of {stage_bytes} bytes exceed the ring's "
                         f"{SMEM_LIMIT} bytes")
    tiles_x = -(-(Wo - ox0) // tw)
    resident = BLOCKS_PER_SM * sms
    while True:
        th = _best_tile(Ho - oy0, unit_h, th_limit, box_h_of)
        tiles_y = -(-(Ho - oy0) // th)
        if planes * tiles_y * tiles_x >= resident or th_limit <= MIN_TH:
            break
        th_limit = max(MIN_TH, th_limit // 2 // unit_h * unit_h)
    iy_step, ix_step = span_of(th), span_of(tw)
    return TilePlan(th=th, tw=tw, tiles_y=tiles_y, tiles_x=tiles_x, oy0=oy0, ox0=ox0, iy0=wy0,
                    ix0=wx0 - sx, iy_step=iy_step, ix_step=ix_step, box_h=box_h_of(th),
                    box_w=box_w, grid=min(planes * tiles_y * tiles_x, resident), stages=stages,
                    tma=int(tma), vec_out=int(not stride1 and out_aligned and Wo % e == 0
                                              and ox0 == 0),
                    sx=sx, rows=int(rows))


def paths(plan: TilePlan, up: int, down: int) -> Tuple[str, str]:
    """Display names of the (load path, store path) of a launch with this
    plan, for printing (callers check the plan's fields): "TMA box", "row
    copy" or "element copy" in; "16-byte chunks", "lane-strided elements"
    (the chunked configurations' element stores: a warp's lanes 16 bytes
    apart) or "warp rows" (the stride-1 instance: 32 neighbouring outputs
    of a row per warp store) out."""
    load = "TMA box" if plan.tma else "row copy" if plan.rows else "element copy"
    if up == down == 1:
        return load, "warp rows"
    return load, "16-byte chunks" if plan.vec_out else "lane-strided elements"


@functools.lru_cache(maxsize=4096)
def _plan_args(*key) -> ctypes.Array:
    """`tile_plan(*key)` as the C entry's int array (kept alive by the cache)."""
    return (ctypes.c_int * len(TilePlan._fields))(*tile_plan(*key))


_SMS = {}  # multiprocessors per device index


def _sms(device: int) -> int:
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SMS[device]


def _host_taps(kernel) -> np.ndarray:
    k = np.ascontiguousarray(kernel, dtype=np.float32)  # a CUDA tensor raises here
    if k.ndim != 2 or k.shape[0] != k.shape[1]:
        raise ValueError(f"upfirdn2d: kernel must be square 2-D, got {k.shape}")
    return k


def output_size(n: int, k: int, up: int, down: int, pad: Sequence[int]) -> int:
    """Output length along one axis: (n*up + pad0 + pad1 - k) // down + 1."""
    return (n * up + int(pad[0]) + int(pad[1]) - k) // down + 1


def upfirdn2d_plain(x: torch.Tensor, kernel, up: int = 1, down: int = 1,
                    pad: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Plain PyTorch upfirdn2d on (B, C, H, W): zero-insert, pad, then a sum
    over the K*K taps of strided slices (the kernel flipped: a convolution).
    A bfloat16 input is summed in float32 and the output rounded once to
    bfloat16, as the kernel does."""
    if x.dtype == torch.bfloat16:
        return upfirdn2d_plain(x.float(), kernel, up, down, pad).to(torch.bfloat16)
    k = _host_taps(kernel)
    K = k.shape[0]
    B, C, H, W = x.shape
    if up > 1:
        # zeros after every sample, the last one included
        z = x.new_zeros((B, C, H, up, W, up))
        z[:, :, :, 0, :, 0] = x
        x = z.reshape(B, C, H * up, W * up)
    pad0, pad1 = int(pad[0]), int(pad[1])
    x = F.pad(x, (pad0, pad1, pad0, pad1))  # negative pads crop
    Ho = (x.shape[2] - K) // down + 1
    Wo = (x.shape[3] - K) // down + 1
    out = x.new_zeros((B, C, Ho, Wo))
    for ky in range(K):
        for kx in range(K):
            tap = float(k[K - 1 - ky, K - 1 - kx])
            out += tap * x[:, :, ky: ky + (Ho - 1) * down + 1: down,
                           kx: kx + (Wo - 1) * down + 1: down]
    return out


def _adjoint(up: int, down: int, pad: Sequence[int], K: int = _TAPS):
    """(up', down', pad0') of the adjoint call (`_ufd_bwd`), whose taps are
    the forward's flipped in both axes.

    pad1' is not needed: an output sample depends on pad0 alone, and pad1
    only sets how many there are, which the adjoint takes from the forward
    input's size (the reference's g_pad1 = H*up - Ho*down + pad0 - up + 1
    gives exactly that size along H)."""
    return down, up, K - int(pad[0]) - 1


def upfirdn2d_bwd_plain(g: torch.Tensor, kernel, up: int, down: int,
                        pad: Tuple[int, int], x_hw: Tuple[int, int]) -> torch.Tensor:
    """Gradient of upfirdn2d(x, kernel, up, down, pad) w.r.t. x of spatial size
    `x_hw`, given the output's gradient `g`: the adjoint identity run through
    `upfirdn2d_plain`. pad1' is made large enough on both axes and the result
    cut to `x_hw`."""
    k = _host_taps(kernel)
    K = k.shape[0]
    g_up, g_down, g_pad0 = _adjoint(up, down, pad, K)
    H, W = x_hw
    g_pad1 = max((n - 1) * g_down + K - m * g_up - g_pad0
                 for n, m in ((H, g.shape[2]), (W, g.shape[3])))
    out = upfirdn2d_plain(g, k[::-1, ::-1], up=g_up, down=g_down, pad=(g_pad0, g_pad1))
    return out[:, :, :H, :W]


def _lib() -> ctypes.CDLL:
    lib = build.load("upfirdn2d")
    fn = lib.storm_upfirdn2d
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
    return lib


def _check_kernel_contract(x: torch.Tensor, k: np.ndarray, up: int, down: int) -> None:
    """Raise unless the CUDA kernel was built for these arguments. The
    dispatcher checks CPU tensors too, so a CPU run refuses what a card would."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"upfirdn2d: float32 or bfloat16 only, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("upfirdn2d: input must be a contiguous (B, C, H, W) tensor")
    if x.numel() == 0:  # a sharded caller skips a part with no frames (nn/seqpar.py)
        raise ValueError(f"upfirdn2d: an input of no elements {tuple(x.shape)}")
    if k.shape != (_TAPS, _TAPS):
        raise ValueError(f"upfirdn2d: built for a {_TAPS}x{_TAPS} FIR, got {k.shape}")
    if (up, down) not in _CONFIGS:
        raise ValueError(f"upfirdn2d: (up, down)={(up, down)} not built")


def _plan_key(x: torch.Tensor, out: torch.Tensor, up: int, down: int, pad0: int) -> tuple:
    """`tile_plan`'s arguments for a launch from x into out."""
    B, C, H, W = x.shape
    return (up, down, pad0, H, W, *out.shape[-2:], B * C, x.element_size(),
            x.data_ptr() % 16 == 0, out.data_ptr() % 16 == 0, _sms(x.get_device()))


def launch_plan(x: torch.Tensor, out: torch.Tensor, up: int, down: int, pad0: int) -> TilePlan:
    """The plan a launch from the CUDA tensor x into out takes."""
    return tile_plan(*_plan_key(x, out, up, down, pad0))


def _launch(x: torch.Tensor, kernel, flip: bool, up: int, down: int, pad0: int,
            Ho: int, Wo: int) -> torch.Tensor:
    """Run the kernel on a CUDA tensor into a new (B, C, Ho, Wo) tensor, with
    the FIR `kernel` (flipped if `flip`); the output size carries pad1 (the
    kernel takes pad0 only)."""
    if not x.is_cuda:
        raise ValueError("upfirdn2d_cuda: input must be a CUDA tensor")
    k = _host_taps(kernel)
    _check_kernel_contract(x, k, up, down)
    if Ho < 1 or Wo < 1:
        raise ValueError(f"upfirdn2d_cuda: empty output {Ho}x{Wo}")
    B, C, H, W = x.shape
    out = torch.empty((B, C, Ho, Wo), dtype=x.dtype, device=x.device)
    device = x.get_device()
    lib = _lib()
    x_ptr, out_ptr = x.data_ptr(), out.data_ptr()
    plan = _plan_args(*_plan_key(x, out, up, down, pad0))
    err = lib.storm_upfirdn2d(x_ptr, out_ptr, k.ctypes.data, flip, device, B * C, H, W, Ho, Wo,
                              up, down, pad0, _DTYPES[x.dtype],
                              torch._C._cuda_getCurrentRawStream(device), plan)
    if err:
        build.check_launch(lib, err, f"upfirdn2d_cuda {tuple(x.shape)} {x.dtype} -> {Ho}x{Wo}, "
                                     f"plan {TilePlan(*plan)}")
    return out


def upfirdn2d_cuda(x: torch.Tensor, kernel, up: int = 1, down: int = 1,
                   pad: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Launch the sm_90a kernel on a contiguous float32 or bfloat16 CUDA tensor
    (B, C, H, W).
    The output has no grad_fn: `upfirdn2d` is the differentiable entry."""
    H, W = x.shape[-2:]
    out = _launch(x, kernel, False, up, down, int(pad[0]),
                  output_size(H, _TAPS, up, down, pad), output_size(W, _TAPS, up, down, pad))
    upfirdn2d_cuda.launches += 1
    return out


def upfirdn2d_bwd_cuda(g: torch.Tensor, kernel, up: int, down: int,
                       pad: Tuple[int, int], x_hw: Tuple[int, int]) -> torch.Tensor:
    """The gradient of `upfirdn2d_cuda(x, kernel, up, down, pad)` w.r.t. x of
    spatial size `x_hw`: one launch of the same kernel with the adjoint's
    arguments (`_adjoint`), on the output gradient `g` made contiguous."""
    g_up, g_down, g_pad0 = _adjoint(up, down, pad)
    out = _launch(g.contiguous(), kernel, True, g_up, g_down, g_pad0, *x_hw)
    upfirdn2d_bwd_cuda.launches += 1
    return out


# kernel launches since the caller last set them to 0, one count per direction
upfirdn2d_cuda.launches = 0
upfirdn2d_bwd_cuda.launches = 0


class UpFirDn2d(torch.autograd.Function):
    """upfirdn2d with its adjoint as the backward, both dispatched on the
    device: the kernel for CUDA tensors, the plain version for CPU tensors."""

    @staticmethod
    def forward(ctx, x, kernel, up, down, pad):
        ctx.args = (kernel, up, down, pad, tuple(x.shape[-2:]))
        if x.is_cuda:
            return upfirdn2d_cuda(x, kernel, up=up, down=down, pad=pad)
        _check_kernel_contract(x, _host_taps(kernel), up, down)
        return upfirdn2d_plain(x, kernel, up=up, down=down, pad=pad)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        kernel, up, down, pad, x_hw = ctx.args
        if g.is_cuda:
            return upfirdn2d_bwd_cuda(g, kernel, up, down, pad, x_hw), None, None, None, None
        g = g.contiguous()
        g_up, g_down, _ = _adjoint(up, down, pad)
        _check_kernel_contract(g, _host_taps(kernel), g_up, g_down)
        return upfirdn2d_bwd_plain(g, kernel, up, down, pad, x_hw), None, None, None, None


def upfirdn2d(x: torch.Tensor, kernel, up: int = 1, down: int = 1,
              pad: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU tensor, in
    both directions; both only for arguments the kernel was built for."""
    if not (x.is_cuda or x.device.type == "cpu"):
        raise ValueError(f"upfirdn2d: no implementation for device {x.device}")
    return UpFirDn2d.apply(x, kernel, up, down, (int(pad[0]), int(pad[1])))
