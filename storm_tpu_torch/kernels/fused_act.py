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

dtypes: x and bias both float32 or both bfloat16, the output in that type.
In bfloat16 the reference's expression rounds h = x + bias, slope * h and
scale * (...) to bfloat16, with slope and scale rounded to bfloat16 first
(JAX's weak typing); the kernel and the plain version do the same three
roundings, so all three agree bit for bit. A bfloat16 x with a float32 bias
raises ValueError: the reference's Pallas kernel refuses that pair (its
float32 h cannot be stored into x's type), while its jnp expression
`fused_leaky_relu` promotes it to a float32 output; the port keeps the
kernel's contract. The backward in bfloat16 is the reference rule in its
order, scale * where(mask, g, slope * g), each product rounded (equal to
`jax.vjp` of the reference, and within 1 ulp of autograd of the plain
version, which multiplies by scale first); in float32 it keeps autograd's
order, bit for bit with autograd of the plain version.

Bound on the card: memory, x in and out once: 8 bytes per float32 element,
4 per bfloat16, plus 1 with the mask. The forward dispatches on the
tensor's device: a CUDA tensor launches the kernel (or raises), a CPU tensor
takes `fused_leaky_relu_plain`'s arithmetic.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ..nn.cast import scalar
from . import build

_MAX_ELEMENTS = 2**31  # the kernel's indices are 32-bit
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the kernel's dtype codes


def _scalars(negative_slope: float, scale: float, dtype: torch.dtype) -> Tuple[float, float]:
    """(slope, scale) rounded to `dtype` (float32 or bfloat16), as JAX rounds
    a Python scalar to the array's type."""
    return scalar(float(negative_slope), dtype), scalar(float(scale), dtype)


def _act(h: torch.Tensor, negative_slope: float, scale: float) -> torch.Tensor:
    s, a = _scalars(negative_slope, scale, h.dtype)
    return a * torch.where(h >= 0, h, s * h)


def fused_leaky_relu_plain(x: torch.Tensor, bias: torch.Tensor, negative_slope: float = 0.2,
                           scale: float = math.sqrt(2.0)) -> torch.Tensor:
    """Plain PyTorch version, differentiable by autograd: the reference
    expression scale * where(h >= 0, h, slope * h), h = x + bias, each
    operation in h's type (in bfloat16 each rounded, the scalars rounded
    first)."""
    return _act(x + bias, negative_slope, scale)


def _check_contract(x: torch.Tensor, bias: torch.Tensor) -> None:
    if x.dtype not in _DTYPES or bias.dtype != x.dtype:
        raise ValueError(
            f"fused_leaky_relu: x and bias both float32 or both bfloat16, got {x.dtype} and "
            f"{bias.dtype} (the reference's Pallas kernel refuses a bfloat16 x with a float32 "
            "bias)")
    if x.dim() < 1 or bias.shape != (x.shape[-1],):
        raise ValueError(f"fused_leaky_relu: bias {tuple(bias.shape)} must be (C,) for x "
                         f"{tuple(x.shape)} (channels last)")
    if not x.is_contiguous():
        raise ValueError("fused_leaky_relu: input must be contiguous")
    if x.numel() >= _MAX_ELEMENTS:
        raise ValueError(f"fused_leaky_relu: at most 2^31 - 1 elements, got {x.numel()}")


def _lib() -> ctypes.CDLL:
    lib = build.load("fused_act")
    fn = lib.storm_fused_leaky_relu
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                                                ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                                ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def fused_leaky_relu_cuda(x: torch.Tensor, bias: torch.Tensor, negative_slope: float = 0.2,
                          scale: float = math.sqrt(2.0), with_mask: bool = False
                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the sm_90a kernel on a contiguous float32 or bfloat16 CUDA
    tensor (..., C) with a bias of its type: (out, the bool mask
    (x + bias) >= 0 if `with_mask`, else None). The output has no grad_fn:
    `fused_leaky_relu` is the differentiable entry."""
    if not (x.is_cuda and bias.device == x.device):
        raise ValueError("fused_leaky_relu_cuda: x and bias must be on one CUDA device")
    _check_contract(x, bias)
    bias = bias.contiguous()
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    mask = torch.empty(x.shape, dtype=torch.bool, device=x.device) if with_mask else None
    lib = _lib()
    slope, scale = _scalars(negative_slope, scale, x.dtype)
    err = lib.storm_fused_leaky_relu(
        x.data_ptr(), bias.data_ptr(), out.data_ptr(), None if mask is None else mask.data_ptr(),
        x.numel(), x.shape[-1], slope, scale, _DTYPES[x.dtype], x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
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
    """scale * where(mask, g, slope * g) in g's type. In float32 the products
    go in the order autograd of `fused_leaky_relu_plain` takes them,
    (g * scale) * slope, so that both gradients, and the bias gradient's
    reduction (`sum_to_size`, as autograd reduces a broadcast), agree bit for
    bit on the same mask. In bfloat16 they go in the reference's order,
    slope * g first, each rounded: `jax.vjp`'s result, bit for bit."""
    s, a = _scalars(negative_slope, scale, g.dtype)
    if g.dtype == torch.bfloat16:
        return a * torch.where(mask, g, s * g)
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
