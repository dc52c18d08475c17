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

`upfirdn2d` dispatches on the tensor's device: a CUDA tensor launches the
kernel (or raises), a CPU tensor takes `upfirdn2d_plain`, the same function
written tap by tap in PyTorch. The FIR taps are a host-side constant (numpy
array or CPU tensor), as in the reference where they are fixed at build time.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

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


def upfirdn2d_cuda(x: torch.Tensor, kernel, up: int = 1, down: int = 1,
                   pad: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Launch the sm_90a kernel on a contiguous float32 CUDA tensor (B, C, H, W)."""
    if not x.is_cuda:
        raise ValueError("upfirdn2d_cuda: input must be a CUDA tensor")
    k = _host_taps(kernel)
    _check_kernel_contract(x, k, up, down)
    B, C, H, W = x.shape
    Ho = output_size(H, _TAPS, up, down, pad)
    Wo = output_size(W, _TAPS, up, down, pad)
    if Ho < 1 or Wo < 1:
        raise ValueError(f"upfirdn2d_cuda: empty output {Ho}x{Wo}")
    out = torch.empty((B, C, Ho, Wo), dtype=x.dtype, device=x.device)
    lib = _lib()
    err = lib.storm_upfirdn2d_f32(
        x.data_ptr(), out.data_ptr(), k.ctypes.data, x.device.index, B * C,
        H, W, Ho, Wo, up, down, int(pad[0]),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError("upfirdn2d_cuda: launch failed: "
                           + lib.storm_cuda_error_string(err).decode())
    upfirdn2d_cuda.launches += 1
    return out


upfirdn2d_cuda.launches = 0  # kernel launches since the caller last set it to 0


def upfirdn2d(x: torch.Tensor, kernel, up: int = 1, down: int = 1,
              pad: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU tensor; both
    only for arguments the kernel was built for."""
    if x.is_cuda:
        return upfirdn2d_cuda(x, kernel, up=up, down=down, pad=pad)
    if x.device.type == "cpu":
        _check_kernel_contract(x, _host_taps(kernel), up, down)
        return upfirdn2d_plain(x, kernel, up=up, down=down, pad=pad)
    raise ValueError(f"upfirdn2d: no implementation for device {x.device}")
