"""StyleGAN2-style FIR resampling on NCHW tensors (counterpart of storm_tpu/nn/resample.py).

`upfirdn2d` is the kernel's dispatcher (kernels/upfirdn.py): the CUDA kernel
for a CUDA tensor, the plain PyTorch version for a CPU tensor, in the input's
dtype (float32 or bfloat16). FIR kernels are host-side float32 numpy
constants, in bfloat16 too: NCSN++'s are exact there.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.upfirdn import upfirdn2d

__all__ = ["upfirdn2d", "setup_kernel", "upsample_2d", "downsample_2d",
           "naive_upsample_2d", "naive_downsample_2d"]


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
