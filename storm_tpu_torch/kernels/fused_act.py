"""Fused bias + leaky ReLU: scale * leaky_relu(x + bias), bias on the last axis.

Replaces the Pallas TPU kernel `fused_leaky_relu_pallas`
(storm_tpu/kernels/fused_act.py, `pl.pallas_call` in its body) with a CUDA
kernel written for sm_90a (`csrc/fused_act.cu`), and the reference's custom
VJP `fused_leaky_relu` with the autograd Function `FusedLeakyReLU`: its
forward keeps the 1-byte mask (x + bias) >= 0, as `_fla_fwd` does, and its
backward is the reference rule gx = scale * where(mask, g, slope * g),
gbias = sum of gx over every axis but the last. The reference computes that
rule in plain jnp outside any kernel, so the backward is plain PyTorch here,
the same operations that autograd of `fused_leaky_relu_plain` runs.

No model of the repository calls it (NCSN++ uses swish); it is the op API
that `storm_tpu.kernels` exports.

Bound on the card: memory, 8 bytes per element (x in, out; float32), 9 with
the mask. The forward dispatches on the tensor's device: a CUDA tensor
launches the kernel (or raises), a CPU tensor takes `fused_leaky_relu_plain`'s
arithmetic.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import numpy as np
import torch

from . import build

_MAX_ELEMENTS = 2**31  # the kernel's indices are 32-bit


def _act(h: torch.Tensor, negative_slope: float, scale: float) -> torch.Tensor:
    s, a = float(np.float32(negative_slope)), float(np.float32(scale))
    return a * torch.where(h >= 0, h, s * h)


def fused_leaky_relu_plain(x: torch.Tensor, bias: torch.Tensor, negative_slope: float = 0.2,
                           scale: float = math.sqrt(2.0)) -> torch.Tensor:
    """Plain PyTorch version, differentiable by autograd: the reference
    expression scale * where(h >= 0, h, slope * h), h = x + bias."""
    return _act(x + bias, negative_slope, scale)


def _check_contract(x: torch.Tensor, bias: torch.Tensor) -> None:
    if x.dtype != torch.float32 or bias.dtype != torch.float32:
        raise ValueError(f"fused_leaky_relu: float32 only, got {x.dtype} and {bias.dtype}")
    if x.dim() < 1 or bias.shape != (x.shape[-1],):
        raise ValueError(f"fused_leaky_relu: bias {tuple(bias.shape)} must be (C,) for x "
                         f"{tuple(x.shape)} (channels last)")
    if not x.is_contiguous():
        raise ValueError("fused_leaky_relu: input must be contiguous")
    if x.numel() >= _MAX_ELEMENTS:
        raise ValueError(f"fused_leaky_relu: at most 2^31 - 1 elements, got {x.numel()}")


def _lib() -> ctypes.CDLL:
    lib = build.load("fused_act")
    fn = lib.storm_fused_leaky_relu_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                                                ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def fused_leaky_relu_cuda(x: torch.Tensor, bias: torch.Tensor, negative_slope: float = 0.2,
                          scale: float = math.sqrt(2.0), with_mask: bool = False
                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the sm_90a kernel on a contiguous float32 CUDA tensor (..., C):
    (out, the bool mask (x + bias) >= 0 if `with_mask`, else None). The
    output has no grad_fn: `fused_leaky_relu` is the differentiable entry."""
    if not (x.is_cuda and bias.device == x.device):
        raise ValueError("fused_leaky_relu_cuda: x and bias must be on one CUDA device")
    _check_contract(x, bias)
    bias = bias.contiguous()
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    mask = torch.empty(x.shape, dtype=torch.bool, device=x.device) if with_mask else None
    lib = _lib()
    err = lib.storm_fused_leaky_relu_f32(
        x.data_ptr(), bias.data_ptr(), out.data_ptr(), None if mask is None else mask.data_ptr(),
        x.numel(), x.shape[-1], float(np.float32(negative_slope)), float(np.float32(scale)),
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch(lib, err, "fused_leaky_relu_cuda")
    fused_leaky_relu_cuda.launches += 1
    return out, mask


# kernel launches since the caller last set it to 0
fused_leaky_relu_cuda.launches = 0


class FusedLeakyReLU(torch.autograd.Function):
    """The kernel (CUDA) or the plain arithmetic (CPU) forward, keeping the
    mask; the reference's VJP rule as the backward."""

    @staticmethod
    def forward(ctx, x, bias, negative_slope, scale):
        ctx.args = (negative_slope, scale)
        keep_mask = any(ctx.needs_input_grad[:2])
        if x.is_cuda:
            out, mask = fused_leaky_relu_cuda(x, bias, negative_slope, scale, keep_mask)
        else:
            _check_contract(x, bias)
            h = x + bias
            out, mask = _act(h, negative_slope, scale), (h >= 0 if keep_mask else None)
        if keep_mask:
            ctx.save_for_backward(mask)
        return out

    @staticmethod
    def backward(ctx, g):
        negative_slope, scale = ctx.args
        (mask,) = ctx.saved_tensors
        gx = _act_grad(g, mask, negative_slope, scale)
        return gx, gx.sum_to_size(gx.shape[-1:]), None, None


def _act_grad(g: torch.Tensor, mask: torch.Tensor, negative_slope: float,
              scale: float) -> torch.Tensor:
    """scale * where(mask, g, slope * g), with the products in the order
    autograd of `fused_leaky_relu_plain` takes them, (g * scale) * slope, so
    that both gradients, and the bias gradient's reduction (`sum_to_size`, as
    autograd reduces a broadcast), agree bit for bit on the same mask."""
    s, a = float(np.float32(negative_slope)), float(np.float32(scale))
    ga = g * a
    return torch.where(mask, ga, ga * s)


def fused_leaky_relu(x: torch.Tensor, bias: torch.Tensor, negative_slope: float = 0.2,
                     scale: float = math.sqrt(2.0)) -> torch.Tensor:
    """scale * leaky_relu(x + bias, negative_slope) for x (..., C) and bias
    (C,): the kernel for a CUDA tensor, the plain arithmetic for a CPU
    tensor; differentiable in x and bias."""
    if not (x.is_cuda or x.device.type == "cpu"):
        raise ValueError(f"fused_leaky_relu: no implementation for device {x.device}")
    return FusedLeakyReLU.apply(x, bias, float(negative_slope), float(scale))
