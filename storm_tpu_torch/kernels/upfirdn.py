"""upfirdn2d: zero-insert upsample -> pad -> FIR -> downsample, on NCHW tensors.

Replaces the Pallas TPU kernel `upfirdn2d_pallas` (storm_tpu/kernels/upfirdn.py,
`pl.pallas_call` in its body) with a CUDA kernel written for sm_90a
(`csrc/upfirdn2d.cu`). NCSN++ calls it 18 times per forward (down and up
BigGAN resblocks, input and output pyramids), always with a 4x4 FIR in one of
two configurations: up=1, down=2, pad=(1, 1) and up=2, down=1, pad=(2, 1).

Bound on the card: memory. The op does at most 16 multiply-adds per output
and reads each input once from device memory, so the least time is
(input bytes + output bytes) / 3.35 TB/s. The kernel folds the zero-insertion
and the padding into its index arithmetic, so it moves only those bytes: the
Pallas kernel instead wrote the zero-inserted, padded input to memory first.

The gradient replaces the reference's custom VJP (`_ufd_bwd`, same file): the
adjoint of upfirdn2d is upfirdn2d again with the taps flipped, up and down
swapped and pad0' = K - pad0 - 1, cut to the input's size. At NCSN++'s
configurations the backward of the down config is the up config (pad0 2)
and vice versa (pad0 1), so the same kernel serves both directions.

`upfirdn2d` goes through the autograd Function `UpFirDn2d` on every device
and dispatches on the tensor's device in both directions: a CUDA tensor
launches the kernel (or raises), a CPU tensor takes `upfirdn2d_plain`, the
same function written tap by tap in PyTorch. The FIR taps are a host-side
constant (numpy array or CPU tensor), as in the reference where they are
fixed at build time.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from . import build

_CONFIGS = {(1, 2), (2, 1)}  # (up, down) pairs the kernel is built for
_TAPS = 4


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
    over the K*K taps of strided slices (the kernel flipped: a convolution)."""
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


def _bwd_args(kernel, up: int, down: int, pad: Sequence[int]):
    """(flipped taps, up', down', pad0') of the adjoint call (`_ufd_bwd`).

    pad1' is not needed: an output sample depends on pad0 alone, and pad1
    only sets how many there are, which the adjoint takes from the forward
    input's size (the reference's g_pad1 = H*up - Ho*down + pad0 - up + 1
    gives exactly that size along H)."""
    k = _host_taps(kernel)
    return np.ascontiguousarray(k[::-1, ::-1]), down, up, k.shape[0] - int(pad[0]) - 1


def upfirdn2d_bwd_plain(g: torch.Tensor, kernel, up: int, down: int,
                        pad: Tuple[int, int], x_hw: Tuple[int, int]) -> torch.Tensor:
    """Gradient of upfirdn2d(x, kernel, up, down, pad) w.r.t. x of spatial size
    `x_hw`, given the output's gradient `g`: the adjoint identity run through
    `upfirdn2d_plain`. pad1' is made large enough on both axes and the result
    cut to `x_hw`."""
    kflip, g_up, g_down, g_pad0 = _bwd_args(kernel, up, down, pad)
    H, W = x_hw
    K = kflip.shape[0]
    g_pad1 = max((n - 1) * g_down + K - m * g_up - g_pad0
                 for n, m in ((H, g.shape[2]), (W, g.shape[3])))
    out = upfirdn2d_plain(g, kflip, up=g_up, down=g_down, pad=(g_pad0, g_pad1))
    return out[:, :, :H, :W]


def _lib() -> ctypes.CDLL:
    lib = build.load("upfirdn2d")
    fn = lib.storm_upfirdn2d_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.storm_cuda_error_string.argtypes = [ctypes.c_int]
        lib.storm_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_kernel_contract(x: torch.Tensor, k: np.ndarray, up: int, down: int) -> None:
    """Raise unless the CUDA kernel was built for these arguments. The
    dispatcher checks CPU tensors too, so a CPU run refuses what a card would."""
    if x.dtype != torch.float32:
        raise ValueError(f"upfirdn2d: float32 only, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("upfirdn2d: input must be a contiguous (B, C, H, W) tensor")
    if k.shape != (_TAPS, _TAPS):
        raise ValueError(f"upfirdn2d: built for a {_TAPS}x{_TAPS} FIR, got {k.shape}")
    if (up, down) not in _CONFIGS:
        raise ValueError(f"upfirdn2d: (up, down)={(up, down)} not built")


def _launch(x: torch.Tensor, k: np.ndarray, up: int, down: int, pad0: int,
            Ho: int, Wo: int) -> torch.Tensor:
    """Run the kernel on a CUDA tensor into a new (B, C, Ho, Wo) tensor; the
    output size carries pad1 (the kernel takes pad0 only)."""
    if not x.is_cuda:
        raise ValueError("upfirdn2d_cuda: input must be a CUDA tensor")
    _check_kernel_contract(x, k, up, down)
    if Ho < 1 or Wo < 1:
        raise ValueError(f"upfirdn2d_cuda: empty output {Ho}x{Wo}")
    B, C, H, W = x.shape
    out = torch.empty((B, C, Ho, Wo), dtype=x.dtype, device=x.device)
    lib = _lib()
    err = lib.storm_upfirdn2d_f32(
        x.data_ptr(), out.data_ptr(), k.ctypes.data, x.device.index, B * C,
        H, W, Ho, Wo, up, down, pad0,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError("upfirdn2d_cuda: launch failed: "
                           + lib.storm_cuda_error_string(err).decode())
    return out


def upfirdn2d_cuda(x: torch.Tensor, kernel, up: int = 1, down: int = 1,
                   pad: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Launch the sm_90a kernel on a contiguous float32 CUDA tensor (B, C, H, W).
    The output has no grad_fn: `upfirdn2d` is the differentiable entry."""
    k = _host_taps(kernel)
    H, W = x.shape[-2:]
    out = _launch(x, k, up, down, int(pad[0]),
                  output_size(H, _TAPS, up, down, pad), output_size(W, _TAPS, up, down, pad))
    upfirdn2d_cuda.launches += 1
    return out


def upfirdn2d_bwd_cuda(g: torch.Tensor, kernel, up: int, down: int,
                       pad: Tuple[int, int], x_hw: Tuple[int, int]) -> torch.Tensor:
    """The gradient of `upfirdn2d_cuda(x, kernel, up, down, pad)` w.r.t. x of
    spatial size `x_hw`: one launch of the same kernel with the adjoint's
    arguments, on the output gradient `g` made contiguous."""
    kflip, g_up, g_down, g_pad0 = _bwd_args(kernel, up, down, pad)
    out = _launch(g.contiguous(), kflip, g_up, g_down, g_pad0, *x_hw)
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
        kflip, g_up, g_down, _ = _bwd_args(kernel, up, down, pad)
        _check_kernel_contract(g, kflip, g_up, g_down)
        return upfirdn2d_bwd_plain(g, kernel, up, down, pad, x_hw), None, None, None, None


def upfirdn2d(x: torch.Tensor, kernel, up: int = 1, down: int = 1,
              pad: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU tensor, in
    both directions; both only for arguments the kernel was built for."""
    if not (x.is_cuda or x.device.type == "cpu"):
        raise ValueError(f"upfirdn2d: no implementation for device {x.device}")
    return UpFirDn2d.apply(x, kernel, up, down, (int(pad[0]), int(pad[1])))
