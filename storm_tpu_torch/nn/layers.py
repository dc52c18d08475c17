"""NCSN++ building blocks on NCHW tensors (counterpart of storm_tpu/nn/layers.py).

Module and parameter names follow the reference's (`GroupNorm_0`, `Conv_0`,
`Dense_0`, `NIN_0`, ...) so the converter maps flax paths one to one. Each
layer that owns weights has `init_from(generator)`, its DDPM initialisation.

Every layer computes in the dtype of its input, float32 or bfloat16, with
float32 parameters, as the reference's layers with `dtype=x.dtype`: convs,
Dense and NIN cast their parameters (nn/cast.py) and round the product
before adding the bias; GroupNorm takes its statistics and normalizes in
float32 and rounds once; attention's softmax runs in float32; Python
scalars are rounded to the dtype as JAX's weak typing rounds them.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .cast import param, scalar
from .init import ddpm_init_, lecun_normal_
from .qconv import QuantizableConv, conv_forward
from .resample import (
    downsample_2d,
    naive_downsample_2d,
    naive_upsample_2d,
    upsample_2d,
)


def get_act(name: str) -> Callable:
    if name == "elu":
        return F.elu
    if name == "relu":
        return F.relu
    if name == "lrelu":
        return lambda x: F.leaky_relu(x, negative_slope=0.2)
    if name == "swish":
        return F.silu
    raise NotImplementedError("activation function does not exist!")


class GroupNorm(nn.GroupNorm):
    """nn.GroupNorm in the dtype of its input, with float32 scale and bias.

    A float32 input takes `F.group_norm`. A bfloat16 input gets flax's
    numerics (storm_tpu/nn/layers.py:63-69, 103-128): the group moments in
    float32, the normalize step x * mul + add in float32 (the form of the
    reference's SplitGroupNorm; flax's GroupNorm writes (x - mean) * mul +
    bias, which differs in float32 rounding only), and one rounding to
    bfloat16. (PyTorch's CUDA `group_norm` refuses a bfloat16 input with
    float32 scale and bias, and rounding those to bfloat16 would change the
    result.) Without autograd the normalize step writes bfloat16 directly."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == self.weight.dtype:
            return super().forward(x)
        B, C = x.shape[:2]
        G = self.num_groups
        var, mean = torch.var_mean(x.reshape(B, G, -1).float(), dim=-1, correction=0)
        mul = (torch.rsqrt(var + self.eps)[:, :, None] * self.weight.view(G, -1)).reshape(B, C)
        add = self.bias - mean.repeat_interleave(C // G, dim=1) * mul
        shape = (B, C) + (1,) * (x.dim() - 2)
        if torch.is_grad_enabled() and (x.requires_grad or self.weight.requires_grad):
            return torch.addcmul(add.view(shape), x, mul.view(shape)).to(x.dtype)
        return torch.addcmul(add.view(shape), x, mul.view(shape), out=torch.empty_like(x))


def group_norm(ch: int) -> GroupNorm:
    """GroupNorm with the NCSN++ heuristic: min(ch // 4, 32) groups, eps 1e-6."""
    return GroupNorm(min(ch // 4, 32), ch, eps=1e-6)


class Conv2d(QuantizableConv):
    """nn.Conv2d with DDPM init at `init_scale` and zero bias; a
    QuantizableConv, so serving can put it on the int8 path (nn/qconv.py)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, padding: int = 0,
                 bias: bool = True, init_scale: float = 1.0):
        self.init_scale = init_scale
        super().__init__(in_ch, out_ch, kernel_size, padding=padding, bias=bias)

    def init_from(self, generator=None):
        rf = self.kernel_size[0] * self.kernel_size[1]
        ddpm_init_(self.weight, self.in_channels * rf, self.out_channels * rf,
                   self.init_scale, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def reset_parameters(self):
        self.init_from(None)


class OutputConv(nn.Conv2d):
    """1x1 output projection with flax's default (LeCun normal) init, in the
    dtype of its input."""

    CAST_PARAMS = ("weight", "bias")

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__(in_ch, out_ch, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_forward(self, x)

    def init_from(self, generator=None):
        lecun_normal_(self.weight, self.in_channels, generator)
        nn.init.zeros_(self.bias)

    def reset_parameters(self):
        self.init_from(None)


class Dense(nn.Linear):
    """nn.Linear with DDPM init and zero bias, in the dtype of its input: the
    product rounded, then the bias added (flax's Dense)."""

    CAST_PARAMS = ("weight", "bias")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, param(self, "weight", x.dtype)) + param(self, "bias", x.dtype)

    def init_from(self, generator=None):
        ddpm_init_(self.weight, self.in_features, self.out_features, 1.0, generator)
        nn.init.zeros_(self.bias)

    def reset_parameters(self):
        self.init_from(None)


def conv3x3(in_ch: int, out_ch: int, init_scale: float = 1.0, bias: bool = True) -> Conv2d:
    return Conv2d(in_ch, out_ch, 3, padding=1, bias=bias, init_scale=init_scale)


def conv1x1(in_ch: int, out_ch: int, init_scale: float = 1.0, bias: bool = True) -> Conv2d:
    return Conv2d(in_ch, out_ch, 1, bias=bias, init_scale=init_scale)


class GaussianFourierProjection(nn.Module):
    """[sin(2 pi t W), cos(2 pi t W)] with W ~ N(0, scale^2) frozen."""

    def __init__(self, embedding_size: int = 256, scale: float = 16.0):
        super().__init__()
        self.scale = scale
        self.W = nn.Parameter(torch.randn(embedding_size) * scale, requires_grad=False)

    def init_from(self, generator=None):
        with torch.no_grad():
            self.W.normal_(0.0, self.scale, generator=generator)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        proj = t[:, None] * self.W[None, :] * (2 * math.pi)
        return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


class NIN(nn.Module):
    """1x1 projection over channels with a (C_in, C_out) matrix `W`, in the
    dtype of its input."""

    CAST_PARAMS = ("W", "b")

    def __init__(self, in_dim: int, num_units: int, init_scale: float = 0.1):
        super().__init__()
        self.init_scale = init_scale
        self.W = nn.Parameter(torch.empty(in_dim, num_units))
        self.b = nn.Parameter(torch.zeros(num_units))
        self.init_from(None)

    def init_from(self, generator=None):
        ddpm_init_(self.W, self.W.shape[0], self.W.shape[1], self.init_scale, generator)
        nn.init.zeros_(self.b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        W, b = param(self, "W", x.dtype), param(self, "b", x.dtype)
        return torch.einsum("bchw,cd->bdhw", x, W) + b[None, :, None, None]


class Combine(nn.Module):
    """Combine a skip pyramid (`x`) with the trunk (`y`)."""

    def __init__(self, dim1: int, dim2: int, method: str = "cat"):
        super().__init__()
        if method not in ("cat", "sum"):
            raise ValueError(f"Method {method} not recognized.")
        self.method = method
        self.Conv_0 = conv1x1(dim1, dim2)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        h = self.Conv_0(x)
        return torch.cat([h, y], dim=1) if self.method == "cat" else h + y


class AttnBlockpp(nn.Module):
    """Single-head self-attention over all H*W positions, softmax in float32:
    the logits are rounded to the compute dtype, scaled by C^-0.5 in it, and
    the softmax's weights rounded to it before the second product
    (storm_tpu/nn/layers.py:319-332)."""

    def __init__(self, channels: int, skip_rescale: bool = False, init_scale: float = 0.0):
        super().__init__()
        self.skip_rescale = skip_rescale
        self.GroupNorm_0 = group_norm(channels)
        self.NIN_0 = NIN(channels, channels)
        self.NIN_1 = NIN(channels, channels)
        self.NIN_2 = NIN(channels, channels)
        self.NIN_3 = NIN(channels, channels, init_scale=init_scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        h = self.GroupNorm_0(x)
        q = self.NIN_0(h).reshape(B, C, H * W)
        k = self.NIN_1(h).reshape(B, C, H * W)
        v = self.NIN_2(h).reshape(B, C, H * W)
        logits = torch.einsum("bcq,bck->bqk", q, k) * scalar(int(C) ** (-0.5), x.dtype)
        w = torch.softmax(logits.float(), dim=-1).to(x.dtype)
        h = torch.einsum("bqk,bck->bcq", w, v).reshape(B, C, H, W)
        h = self.NIN_3(h)
        return (x + h) / scalar(math.sqrt(2.0), x.dtype) if self.skip_rescale else x + h


class Upsample(nn.Module):
    """2x FIR upsample without a conv (the NCSN++ output pyramid)."""

    def __init__(self, fir_kernel: Sequence[int] = (1, 3, 3, 1)):
        super().__init__()
        self.fir_kernel = tuple(fir_kernel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample_2d(x, self.fir_kernel, factor=2)


class Downsample(nn.Module):
    """2x FIR downsample without a conv (the NCSN++ input pyramid)."""

    def __init__(self, fir_kernel: Sequence[int] = (1, 3, 3, 1)):
        super().__init__()
        self.fir_kernel = tuple(fir_kernel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return downsample_2d(x, self.fir_kernel, factor=2)


class ResnetBlockBigGANpp(nn.Module):
    """BigGAN resblock with optional FIR up/down resampling.

    `temb_dim=None` builds no Dense_0 (the unconditional denoiser). The
    up path calls it on torch.cat([h, skip], dim=1): Conv_0 and Conv_2 are
    then each one conv of the concatenation, rounded once, where the
    reference (`split_skip`, storm_tpu/nn/qconv.py:109-118) sums two partial
    convs, each rounded: in float32 the two agree to rounding, in bfloat16
    the single rounding is the more exact.
    """

    def __init__(self, act: Callable, in_ch: int, out_ch: Optional[int] = None,
                 temb_dim: Optional[int] = None, up: bool = False, down: bool = False,
                 dropout: float = 0.1, fir: bool = False,
                 fir_kernel: Sequence[int] = (1, 3, 3, 1), skip_rescale: bool = True,
                 init_scale: float = 0.0):
        super().__init__()
        out_ch = out_ch if out_ch is not None else in_ch
        self.act = act
        self.up, self.down, self.fir = up, down, fir
        self.fir_kernel = tuple(fir_kernel)
        self.skip_rescale = skip_rescale
        self.GroupNorm_0 = group_norm(in_ch)
        self.Conv_0 = conv3x3(in_ch, out_ch)
        if temb_dim is not None:
            self.Dense_0 = Dense(temb_dim, out_ch)
        self.GroupNorm_1 = group_norm(out_ch)
        self.Dropout_0 = nn.Dropout(dropout)
        self.Conv_1 = conv3x3(out_ch, out_ch, init_scale=init_scale)
        if in_ch != out_ch or up or down:
            self.Conv_2 = conv1x1(in_ch, out_ch)

    def _resample(self, x: torch.Tensor) -> torch.Tensor:
        if self.up:
            return (upsample_2d(x, self.fir_kernel, factor=2) if self.fir
                    else naive_upsample_2d(x, factor=2))
        if self.down:
            return (downsample_2d(x, self.fir_kernel, factor=2) if self.fir
                    else naive_downsample_2d(x, factor=2))
        return x

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.act(self.GroupNorm_0(x))
        h = self._resample(h)
        x = self._resample(x)
        h = self.Conv_0(h)
        if temb is not None:
            h = h + self.Dense_0(self.act(temb))[:, :, None, None]
        h = self.act(self.GroupNorm_1(h))
        h = self.Dropout_0(h)
        h = self.Conv_1(h)
        if hasattr(self, "Conv_2"):
            x = self.Conv_2(x)
        return (x + h) / scalar(math.sqrt(2.0), x.dtype) if self.skip_rescale else x + h
