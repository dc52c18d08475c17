"""The legacy NCSNv1/v2 RefineNet blocks and normalization variants
(counterpart of storm_tpu/nn/legacy.py; upstream ncsnpp_utils/layers.py and
normalization.py).

No NCSN++ configuration uses them, upstream or here: they are kept for the
layer library's surface. `nn.Module`s in NCHW with the reference's torch
module names (`convs.{i}`, `{i}_{j}_conv`, `adapt_convs.{i}`, `msf`, `crp`,
`output_convs`, `embed`), so `convert.legacy_params_from_jax` carries a JAX
package block's parameters onto them. Where the JAX package parts from the
upstream torch code, the port follows the JAX package:

- MSFBlock resizes as `jax.image.resize(..., "bilinear")` does: half-pixel
  centres, antialiased when it shrinks (upstream: `align_corners=True`);
- the norms take biased variances (upstream `torch.var` is unbiased);
- RefineBlock fuses its inputs whenever it has more than one (`start` is
  kept for the signature);
- ConditionalInstanceNorm2dPlus scales the whole normalized sum by alpha.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .init import lecun_normal_


def ncsn_conv3x3(in_ch: int, out_ch: int, bias: bool = True, stride: int = 1,
                 init_scale: float = 1.0) -> nn.Conv2d:
    """3x3 conv, padding 1, flax's lecun-normal kernel times `init_scale`
    (0 taken as 1e-10)."""
    init_scale = 1e-10 if init_scale == 0 else init_scale
    conv = nn.Conv2d(in_ch, out_ch, 3, stride=stride, padding=1, bias=bias)
    lecun_normal_(conv.weight, in_ch * 9)
    with torch.no_grad():
        conv.weight.mul_(init_scale)
        if bias:
            conv.bias.zero_()
    return conv


def _pool5(x: torch.Tensor, maxpool: bool) -> torch.Tensor:
    """5x5 pooling, stride 1, padding 2 (average over 25 with the zeros)."""
    if maxpool:
        return F.max_pool2d(x, 5, stride=1, padding=2)
    return F.avg_pool2d(x, 5, stride=1, padding=2, count_include_pad=True)


class CRPBlock(nn.Module):
    """Chained residual pooling."""

    def __init__(self, features: int, n_stages: int, act: Callable = F.relu,
                 maxpool: bool = True):
        super().__init__()
        self.convs = nn.ModuleList(ncsn_conv3x3(features, features, bias=False)
                                   for _ in range(n_stages))
        self.act, self.maxpool = act, maxpool

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.act(x)
        path = x
        for conv in self.convs:
            path = conv(_pool5(path, self.maxpool))
            x = path + x
        return x


class RCUBlock(nn.Module):
    """Residual conv unit: `n_blocks` residual blocks of `n_stages` act +
    conv each."""

    def __init__(self, features: int, n_blocks: int, n_stages: int, act: Callable = F.relu):
        super().__init__()
        for i in range(n_blocks):
            for j in range(n_stages):
                setattr(self, f"{i + 1}_{j + 1}_conv",
                        ncsn_conv3x3(features, features, bias=False))
        self.n_blocks, self.n_stages, self.act = n_blocks, n_stages, act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_blocks):
            residual = x
            for j in range(self.n_stages):
                x = getattr(self, f"{i + 1}_{j + 1}_conv")(self.act(x))
            x = x + residual
        return x


class MSFBlock(nn.Module):
    """Multi-scale fusion: each input through a 3x3 conv to `features`,
    resized bilinearly to `shape` (H, W), summed."""

    def __init__(self, in_planes: Sequence[int], features: int):
        super().__init__()
        self.convs = nn.ModuleList(ncsn_conv3x3(c, features, bias=True) for c in in_planes)
        self.features = features

    def forward(self, xs: Sequence[torch.Tensor], shape) -> torch.Tensor:
        sums = xs[0].new_zeros((xs[0].shape[0], self.features) + tuple(shape))
        for conv, x in zip(self.convs, xs):
            h = F.interpolate(conv(x), size=tuple(shape), mode="bilinear",
                              align_corners=False, antialias=True)
            sums = sums + h
        return sums


class RefineBlock(nn.Module):
    """RefineNet block: an RCU per input, their fusion (MSF) when there is
    more than one, chained residual pooling, an output RCU (3 blocks at the
    end, else 1)."""

    def __init__(self, in_planes: Sequence[int], features: int, act: Callable = F.relu,
                 start: bool = False, end: bool = False, maxpool: bool = True):
        super().__init__()
        del start
        self.adapt_convs = nn.ModuleList(RCUBlock(c, 2, 2, act) for c in in_planes)
        self.msf = MSFBlock(in_planes, features) if len(in_planes) > 1 else None
        self.crp = CRPBlock(features, 2, act, maxpool=maxpool)
        self.output_convs = RCUBlock(features, 3 if end else 1, 2, act)

    def forward(self, xs: Sequence[torch.Tensor], output_shape) -> torch.Tensor:
        if len(xs) != len(self.adapt_convs):
            raise ValueError(f"got {len(xs)} inputs, expected {len(self.adapt_convs)}")
        hs = [rcu(x) for rcu, x in zip(self.adapt_convs, xs)]
        h = self.msf(hs, output_shape) if self.msf is not None else hs[0]
        return self.output_convs(self.crp(h))


def _near_one(n: int) -> nn.Parameter:
    return nn.Parameter(1.0 + 0.02 * torch.randn(n))


def _moments(x: torch.Tensor):
    """Instance mean and biased variance over (H, W), keepdim."""
    return x.mean(dim=(2, 3), keepdim=True), x.var(dim=(2, 3), keepdim=True, unbiased=False)


def _normalized_means(x: torch.Tensor) -> torch.Tensor:
    """The per-channel means normalized across channels, (B, C, 1, 1)."""
    means = x.mean(dim=(2, 3))
    m = means.mean(dim=-1, keepdim=True)
    v = means.var(dim=-1, keepdim=True, unbiased=False)
    return ((means - m) / torch.sqrt(v + 1e-5))[:, :, None, None]


class VarianceNorm2d(nn.Module):
    """Scale-only normalization by the feature variance, times alpha."""

    def __init__(self, num_features: int, bias: bool = False):
        super().__init__()
        del bias
        self.alpha = _near_one(num_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
        return x / torch.sqrt(var + 1e-5) * self.alpha[:, None, None]


class InstanceNorm2dPlus(nn.Module):
    """Instance norm plus the channel means normalized across channels."""

    def __init__(self, num_features: int, bias: bool = True):
        super().__init__()
        self.alpha = _near_one(num_features)
        self.gamma = _near_one(num_features)
        self.beta = nn.Parameter(torch.zeros(num_features)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean, var = _moments(x)
        h = (x - mean) / torch.sqrt(var + 1e-5)
        h = h + _normalized_means(x) * self.alpha[:, None, None]
        out = self.gamma[:, None, None] * h
        return out + self.beta[:, None, None] if self.beta is not None else out


class ConditionalInstanceNorm2dPlus(nn.Module):
    """InstanceNorm2dPlus with the affine (gamma, alpha[, beta]) of class y
    from an embedding."""

    def __init__(self, num_features: int, num_classes: int, bias: bool = True):
        super().__init__()
        n_out = 3 if bias else 2
        self.num_features, self.bias = num_features, bias
        self.embed = nn.Embedding(num_classes, n_out * num_features)
        with torch.no_grad():
            self.embed.weight.normal_(1.0, 0.02)
            if bias:
                self.embed.weight[:, 2 * num_features:].zero_()

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        C = self.num_features
        mean, var = _moments(x)
        h = (x - mean) / torch.sqrt(var + 1e-5) + _normalized_means(x)
        e = self.embed(y)
        h = h * e[:, C: 2 * C, None, None]
        out = e[:, :C, None, None] * h
        return out + e[:, 2 * C:, None, None] if self.bias else out
