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

Each layer NCSN++ runs also takes a frame-sharded activation (nn/seqpar.py
`Sharded`, sequence-parallel serving): the convs, NIN and the resamplers on
halo'd shards, GroupNorm with cross-shard moments, attention with gathered
keys and values; the resblocks and `Combine` are compositions of those.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.autograd.function import once_differentiable

from . import seqpar
from .cast import param, scalar
from .init import ddpm_init_, lecun_normal_
from .qconv import QuantizableConv, conv_forward
from .seqpar import Sharded
from .resample import (
    conv_downsample_2d,
    downsample_2d,
    naive_downsample_2d,
    naive_upsample_2d,
    upsample_2d,
    upsample_conv_2d,
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
    numerics (storm_tpu/nn/layers.py:63-69, 103-128) through
    `LowPrecisionGroupNorm`: the group moments in float32, the normalize
    step x * mul + add in float32 (the form of the reference's
    SplitGroupNorm; flax's GroupNorm writes (x - mean) * mul + bias, which
    differs in float32 rounding only), and one rounding to bfloat16.
    (PyTorch's CUDA `group_norm` refuses a bfloat16 input with float32
    scale and bias, and rounding those to bfloat16 would change the
    result.)"""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if isinstance(x, Sharded):  # moments over every shard, then each shard normalized
            mean, var = seqpar.group_norm_moments(x, self.num_groups)
            mul, add = _group_affine(mean, torch.rsqrt(var + self.eps), self.weight, self.bias)
            return x.map(lambda p: _normalize(p, mul.to(p.device), add.to(p.device)))
        if x.dtype == self.weight.dtype:
            return super().forward(x)
        if torch.is_grad_enabled() and (x.requires_grad or self.weight.requires_grad
                                        or self.bias.requires_grad):
            return LowPrecisionGroupNorm.apply(x, self.weight, self.bias, self.num_groups,
                                               self.eps)
        return _group_norm_low(x, self.weight, self.bias, self.num_groups, self.eps)[0]


def _group_norm_low(x, weight, bias, G: int, eps: float):
    """(GroupNorm of x in x's dtype, the float32 group means, the float32
    inverse deviations): moments and normalize in float32, one rounding."""
    var, mean = torch.var_mean(x.reshape(x.shape[0], G, -1).float(), dim=-1, correction=0)
    rstd = torch.rsqrt(var + eps)
    return _normalize(x, *_group_affine(mean, rstd, weight, bias)), mean, rstd


def _group_affine(mean, rstd, weight, bias):
    """(mul, add), each (B, C) float32, of GroupNorm's x * mul + add from the
    group means and inverse deviations (B, G) and the scale and bias (C,)."""
    B, G = mean.shape
    C = weight.shape[0]
    mul = (rstd[:, :, None] * weight.view(G, -1)).reshape(B, C)
    return mul, bias - mean.repeat_interleave(C // G, dim=1) * mul


def _normalize(x, mul, add):
    """x * mul + add per channel in float32, written in x's dtype (one rounding)."""
    shape = mul.shape + (1,) * (x.dim() - 2)
    return torch.addcmul(add.view(shape), x, mul.view(shape), out=torch.empty_like(x))


class LowPrecisionGroupNorm(torch.autograd.Function):
    """GroupNorm of a bfloat16 x with float32 scale and bias, computed in
    float32 and written in x's dtype, rounded once; under autograd.

    Its backward is autograd's of the same arithmetic (x * mul + add, with
    mul = rstd * scale and add = bias - mean * mul from `var_mean` of a
    float32 copy of x), step by step: the gradient through the normalize
    step and the one through the group statistics are each computed in
    float32 and rounded to x's dtype, then summed there, as autograd sums
    them and as JAX's autodiff of flax's GroupNorm does (the two agree but
    for the order of float32 sums). What changes is what it keeps: x
    itself and the float32 group means and inverse deviations, where
    autograd keeps a float32 copy of x for the variance's backward, 4 bytes
    per element of every GroupNorm input (a third of a full-width bf16
    step's peak memory: chip_smoke.py phase 24, PERF.md)."""

    @staticmethod
    def forward(ctx, x, weight, bias, num_groups: int, eps: float):
        out, mean, rstd = _group_norm_low(x, weight, bias, num_groups, eps)
        ctx.save_for_backward(x, weight, mean, rstd)
        ctx.num_groups = num_groups
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, weight, mean, rstd = ctx.saved_tensors
        B, C = x.shape[:2]
        G = ctx.num_groups
        xf = x.reshape(B, C, -1).float()
        gf = g.reshape(B, C, -1).float()
        mul = (rstd[:, :, None] * weight.view(G, -1)).reshape(B, C)
        mean_c = mean.repeat_interleave(C // G, dim=1)
        # y = x * mul + add: the normalize step's gradients
        g_norm = (gf * mul[:, :, None]).to(x.dtype)
        d_add = gf.sum(dim=-1)
        d_mul = (gf * xf).sum(dim=-1) - d_add * mean_c  # add = bias - mean * mul
        # the statistics' gradients: mul = rstd * scale, rstd = (var + eps)^-1/2
        d_mean = -(d_add * mul).view(B, G, -1).sum(dim=-1)
        d_rstd = (d_mul * weight).view(B, G, -1).sum(dim=-1)
        d_var = -0.5 * d_rstd * rstd ** 3
        n = xf.shape[-1] * (C // G)  # elements per group
        xg = xf.reshape(B, G, -1)
        g_stats = (d_var[:, :, None] * (2.0 / n) * (xg - mean[:, :, None])
                   + (d_mean / n)[:, :, None]).to(x.dtype)
        gx = (g_norm.reshape(B, G, -1) + g_stats).reshape(x.shape)
        g_weight = (d_mul.view(B, G, -1) * rstd[:, :, None]).sum(dim=0).reshape(C)
        return gx, g_weight, d_add.sum(dim=0), None, None


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
        if isinstance(x, Sharded):
            return x.apply(self)
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
        if isinstance(x, Sharded):
            return x.apply(self)
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
        if isinstance(x, Sharded):
            h = self.GroupNorm_0(x)
            h = seqpar.attention_gathered(self.NIN_0(h), self.NIN_1(h), self.NIN_2(h))
            h = self.NIN_3(h)
            return (x + h) / scalar(math.sqrt(2.0), x.dtype) if self.skip_rescale else x + h
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


class StridedConv(nn.Conv2d):
    """nn.Conv2d with DDPM init and zero bias, in the dtype of its input:
    flax's plain Conv (not a QuantizableConv: the int8 path leaves it
    alone, as the reference's calibration does)."""

    CAST_PARAMS = ("weight", "bias")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_forward(self, x)

    def init_from(self, generator=None):
        rf = self.kernel_size[0] * self.kernel_size[1]
        ddpm_init_(self.weight, self.in_channels * rf, self.out_channels * rf, 1.0, generator)
        nn.init.zeros_(self.bias)

    def reset_parameters(self):
        self.init_from(None)


# the frames of halo a sharded 2x resampler takes on either side: every
# output frame of the FIR (4 taps) and of the 3x3 conv around it reads
# input frames within 2 of its own, and an even halo starts a stride-2 op's
# window on an even frame, its unsharded phase (nn/seqpar.py)
RESAMPLE_HALO = 2


class _Resample(nn.Module):
    """A 2x resampler, FIR or plain, with a 3x3 conv or none. With `fir` and
    `with_conv` the conv's weight and bias are its own parameters,
    `Conv2d_0_weight` (OIHW) and `Conv2d_0_bias`, read in the input's dtype;
    without `fir` the conv is the module `Conv_0` (`_plain_conv`)."""

    CAST_PARAMS = ()  # the weight and bias, where they exist

    def __init__(self, in_ch: Optional[int] = None, out_ch: Optional[int] = None,
                 with_conv: bool = False, fir: bool = False,
                 fir_kernel: Sequence[int] = (1, 3, 3, 1)):
        super().__init__()
        out_ch = out_ch if out_ch is not None else in_ch
        self.fir, self.with_conv = fir, with_conv
        self.fir_kernel = tuple(fir_kernel)
        if with_conv and fir:
            self.CAST_PARAMS = ("Conv2d_0_weight", "Conv2d_0_bias")
            self.Conv2d_0_weight = nn.Parameter(torch.empty(out_ch, in_ch, 3, 3))
            self.Conv2d_0_bias = nn.Parameter(torch.zeros(out_ch))
            self.init_from(None)
        elif with_conv:
            self.Conv_0 = self._plain_conv(in_ch, out_ch)

    def init_from(self, generator=None):
        if self.CAST_PARAMS:
            o, i = self.Conv2d_0_weight.shape[:2]
            ddpm_init_(self.Conv2d_0_weight, 9 * i, 9 * o, 1.0, generator)
            nn.init.zeros_(self.Conv2d_0_bias)

    def _fir_conv(self, resample: Callable, x: torch.Tensor) -> torch.Tensor:
        w = param(self, "Conv2d_0_weight", x.dtype)
        return resample(x, w, k=self.fir_kernel) + param(self, "Conv2d_0_bias",
                                                           x.dtype)[:, None, None]


class Upsample(_Resample):
    """2x upsample: FIR or nearest, with a 3x3 conv or none (layerspp.py:94-126);
    without a conv it is the NCSN++ output pyramid's."""

    @staticmethod
    def _plain_conv(in_ch: int, out_ch: int) -> nn.Module:
        return conv3x3(in_ch, out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if isinstance(x, Sharded):
            return x.apply(self, halo=RESAMPLE_HALO, scale=2)
        if not self.fir:
            h = naive_upsample_2d(x, factor=2)
            return self.Conv_0(h) if self.with_conv else h
        if not self.with_conv:
            return upsample_2d(x, self.fir_kernel, factor=2)
        return self._fir_conv(upsample_conv_2d, x)


class Downsample(_Resample):
    """2x downsample: FIR or mean pool, with a 3x3 conv or none
    (layerspp.py:129-163); without a conv it is the NCSN++ input pyramid's."""

    @staticmethod
    def _plain_conv(in_ch: int, out_ch: int) -> nn.Module:
        return StridedConv(in_ch, out_ch, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if isinstance(x, Sharded):
            return x.apply(self, halo=RESAMPLE_HALO, scale=0.5)
        if not self.fir:
            if not self.with_conv:
                return naive_downsample_2d(x, factor=2)
            # an asymmetric (0, 1) pad, then the stride-2 conv unpadded
            return self.Conv_0(F.pad(x, (0, 1, 0, 1)))
        if not self.with_conv:
            return downsample_2d(x, self.fir_kernel, factor=2)
        return self._fir_conv(conv_downsample_2d, x)


class ResnetBlockDDPMpp(nn.Module):
    """DDPM resblock (layerspp.py:166-209): no resampling; a NIN shortcut (or
    with `conv_shortcut` a 3x3 conv) where the channel count changes.
    `temb_dim=None` builds no Dense_0."""

    def __init__(self, act: Callable, in_ch: int, out_ch: Optional[int] = None,
                 temb_dim: Optional[int] = None, conv_shortcut: bool = False,
                 dropout: float = 0.1, skip_rescale: bool = False, init_scale: float = 0.0):
        super().__init__()
        out_ch = out_ch if out_ch is not None else in_ch
        self.act = act
        self.skip_rescale = skip_rescale
        self.GroupNorm_0 = group_norm(in_ch)
        self.Conv_0 = conv3x3(in_ch, out_ch)
        if temb_dim is not None:
            self.Dense_0 = Dense(temb_dim, out_ch)
        self.GroupNorm_1 = group_norm(out_ch)
        self.Dropout_0 = nn.Dropout(dropout)
        self.Conv_1 = conv3x3(out_ch, out_ch, init_scale=init_scale)
        if in_ch != out_ch:
            if conv_shortcut:
                self.Conv_2 = conv3x3(in_ch, out_ch)
            else:
                self.NIN_0 = NIN(in_ch, out_ch)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.Conv_0(self.act(self.GroupNorm_0(x)))
        if temb is not None:
            h = h + self.Dense_0(self.act(temb))[:, :, None, None]
        h = self.Conv_1(self.Dropout_0(self.act(self.GroupNorm_1(h))))
        if hasattr(self, "Conv_2"):
            x = self.Conv_2(x)
        elif hasattr(self, "NIN_0"):
            # the einsum's output is a permuted view, whose layout the sum
            # would pass on to the next convs and the FIR, which takes NCHW
            x = self.NIN_0(x).contiguous()
        return (x + h) / scalar(math.sqrt(2.0), x.dtype) if self.skip_rescale else x + h


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
        if isinstance(x, Sharded) and (self.up or self.down):
            return x.halo_map(lambda i, t: self._resample(t), RESAMPLE_HALO,
                              2 if self.up else 0.5)
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
