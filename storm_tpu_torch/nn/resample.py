"""StyleGAN2-style FIR resampling on NCHW tensors (counterpart of storm_tpu/nn/resample.py).

`upfirdn2d` is the kernel's dispatcher (kernels/upfirdn.py): the CUDA kernel
for a CUDA tensor, the plain PyTorch version for a CPU tensor, in the input's
dtype (float32 or bfloat16). FIR kernels are host-side float32 numpy
constants, in bfloat16 too: NCSN++'s are exact there.

`upsample_conv_2d` and `conv_downsample_2d` are the resamplers with a 3x3
conv of the reference's DDPM levels and `residual` pyramids: a transposed
conv (cuDNN) then the FIR at stride 1, or the FIR at stride 1 then a strided
conv (cuDNN). Their weights are OIHW, the reference's HWIO transposed.
`conv_transpose` is the port's one transposed convolution, held to cuDNN's
deterministic algorithms.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.upfirdn import upfirdn2d

__all__ = ["upfirdn2d", "setup_kernel", "upsample_2d", "downsample_2d",
           "naive_upsample_2d", "naive_downsample_2d", "upsample_conv_2d",
           "conv_downsample_2d", "conv_transpose"]


def setup_kernel(k) -> np.ndarray:
    """Outer product (for a 1-D kernel) normalised to sum 1, float32."""
    k = np.asarray(k, dtype=np.float32)
    if k.ndim == 1:
        k = np.outer(k, k)
    k = k / np.sum(k)
    if k.ndim != 2 or k.shape[0] != k.shape[1]:
        raise ValueError(f"FIR kernel must be square, got {k.shape}")
    return k


@functools.lru_cache(maxsize=None)
def _scaled_kernel(k: tuple, scale: float) -> np.ndarray:
    """setup_kernel(k) * scale for 1-D taps `k`, made once per (taps, scale)
    and read-only, so a forward's 18 resampling calls compute no FIR."""
    kern = setup_kernel(k) * scale
    kern.setflags(write=False)  # shared by every later call
    return kern


def upsample_2d(x: torch.Tensor, k=None, factor: int = 2, gain: float = 1.0) -> torch.Tensor:
    """FIR upsample by `factor` (gain factor**2 keeps the DC level)."""
    if k is None:
        k = (1,) * factor
    kern = _scaled_kernel(tuple(k), gain * factor**2)
    p = kern.shape[0] - factor
    return upfirdn2d(x, kern, up=factor, pad=((p + 1) // 2 + factor - 1, p // 2))


def downsample_2d(x: torch.Tensor, k=None, factor: int = 2, gain: float = 1.0) -> torch.Tensor:
    """FIR downsample by `factor`."""
    if k is None:
        k = (1,) * factor
    kern = _scaled_kernel(tuple(k), gain)
    p = kern.shape[0] - factor
    return upfirdn2d(x, kern, down=factor, pad=((p + 1) // 2, p // 2))


def naive_upsample_2d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour upsample."""
    return x.repeat_interleave(factor, dim=2).repeat_interleave(factor, dim=3)


def naive_downsample_2d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Mean-pool downsample."""
    return F.avg_pool2d(x, factor)


def conv_transpose(x: torch.Tensor, w: torch.Tensor, **kwargs) -> torch.Tensor:
    """`F.conv_transpose1d` or `F.conv_transpose2d` (by x's rank) with
    cuDNN held to deterministic algorithms for the call: a transposed conv
    runs cuDNN's backward-data algorithms, and in float32 its default choice
    at these nets' shapes is not deterministic, so a captured program's
    replay would not equal its eager call bit for bit. The flag is set back
    after the call."""
    conv = F.conv_transpose1d if x.dim() == 3 else F.conv_transpose2d
    cudnn = torch.backends.cudnn
    if cudnn.deterministic:
        return conv(x, w, **kwargs)
    cudnn.deterministic = True
    try:
        return conv(x, w, **kwargs)
    finally:
        cudnn.deterministic = False


def upsample_conv_2d(x: torch.Tensor, w: torch.Tensor, k=None, factor: int = 2,
                     gain: float = 1.0) -> torch.Tensor:
    """Transposed conv by `factor` with the OIHW weight `w` (odd, square),
    then the FIR at stride 1: (B, C_in, H, W) -> (B, C_out, H*factor,
    W*factor). The reference correlates the zero-inserted input with its
    HWIO kernel unflipped; a transposed conv convolves with its weight, so
    it gets `w` flipped, as (C_in, C_out, kh, kw)."""
    kh, kw = w.shape[-2:]
    if kh != kw:
        raise ValueError(f"upsample_conv_2d: square kernel only, got {kh}x{kw}")
    if k is None:
        k = (1,) * factor
    kern = _scaled_kernel(tuple(k), gain * factor**2)
    p = (kern.shape[0] - factor) - (kw - 1)
    h = conv_transpose(x, w.flip((2, 3)).transpose(0, 1), stride=factor).contiguous()
    return upfirdn2d(h, kern, pad=((p + 1) // 2 + factor - 1, p // 2 + 1))


def conv_downsample_2d(x: torch.Tensor, w: torch.Tensor, k=None, factor: int = 2,
                       gain: float = 1.0) -> torch.Tensor:
    """The FIR at stride 1, then a conv of stride `factor` with the OIHW
    weight `w`, unpadded: (B, C_in, H, W) -> (B, C_out, H/factor, W/factor)."""
    kh, kw = w.shape[-2:]
    if kh != kw:
        raise ValueError(f"conv_downsample_2d: square kernel only, got {kh}x{kw}")
    if k is None:
        k = (1,) * factor
    kern = _scaled_kernel(tuple(k), gain)
    p = (kern.shape[0] - factor) + (kw - 1)
    x = upfirdn2d(x, kern, pad=((p + 1) // 2, p // 2))
    return F.conv2d(x, w, stride=factor)
