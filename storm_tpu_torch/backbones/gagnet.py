"""GaGNet, the glance-and-gaze spectral denoiser (counterpart of
storm_tpu/backbones/gagnet.py), on NCHW (B, C, T, F) and NCL (B, C, T)
tensors.

A gated U^2-Net (or plain U-Net) encoder over (time, freq), stride 2 along
F and causal padding along T, feeds `q` stacked glance-gaze modules: each
glance block predicts a magnitude gain, each gaze block a complex residual,
combined as coarse filter plus residual; the output is a tanh complex mask
on the input spectrogram. Every conv is a library call (cuDNN): the
reference has no Pallas kernel here.

Modules carry the reference's torch names (`en.meta_unet_list.{i}.in_conv.
0.conv.1.weight`, `gags.{i}.glance_block.tcn_g.{j}.tcns.{k}.d_conv.3.weight`,
...) in PyTorch's layouts, as storm_tpu/compat/torch_ckpt.py
`convert_gagnet_state_dict` reads them, so a reference state_dict loads by
name (storm_tpu_torch/convert.py maps the flax tree).

`NormSwitch` is IN or BN over the per-sample spatial axes (IN) or the batch
and spatial axes (BN), with a biased variance and eps 1e-5; it keeps no
running statistics. Under `stats_attached(net, batch_stats)` a BN norm
named in `batch_stats` ({norm module name: {"mean", "var"}}, the converted
running statistics of a reference checkpoint) normalizes with those instead,
as torch's eval-mode BatchNorm does; the trainer never attaches them. Under
`moments_across(norms, world)`, which only the data-parallel trainer's
step and validation enter (utils/train_graphs.py), a BN norm takes its
moments over every process's rows (`utils/distributed.BatchMoments`), as
the reference's BN under the trainer's data `Mesh` takes them over the
global batch; a serving call, and the trainer's evaluation, never call a
collective.

The net computes in its `dtype` with float32 parameters, cast per use, and
returns float32, as the reference's `dtype` field does. The reference's
`padding_necessary` bug for odd F is fixed there and here: F is padded to
odd only when it is even.
"""
from __future__ import annotations

import contextlib
import inspect
import math
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.cast import param, scalar
from ..nn.init import lecun_normal_
from ..nn.resample import conv_transpose
from ..utils.distributed import BatchMoments, World
from .convtasnet import optional_bool

BatchStats = Mapping[str, Mapping[str, torch.Tensor]]


class _Conv(nn.Module):
    """A conv of the input's dtype: `weight` (and `bias`) cast to it, the
    product rounded to it, then the bias added in it, as flax computes.
    `kind`: "conv1d", "conv2d" or "conv_transpose2d" (weight (I, O, kh, kw),
    through `conv_transpose`, which holds cuDNN to deterministic algorithms)."""

    CAST_PARAMS = ("weight", "bias")

    def __init__(self, kind: str, cin: int, cout: int, kernel: Tuple[int, ...],
                 stride=1, bias: bool = True, dilation: int = 1):
        super().__init__()
        self.kind, self.stride, self.dilation = kind, stride, dilation
        shape = (cin, cout) if kind == "conv_transpose2d" else (cout, cin)
        self.weight = nn.Parameter(torch.empty(*shape, *kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.init_from(None)

    def init_from(self, generator=None):
        w = self.weight  # flax's LeCun normal over (kernel taps x input features)
        lecun_normal_(w, w.shape[0 if self.kind == "conv_transpose2d" else 1]
                      * math.prod(w.shape[2:]), generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = param(self, "weight", x.dtype)
        if self.kind == "conv_transpose2d":
            y = conv_transpose(x, w, stride=self.stride)
        elif self.kind == "conv2d":
            y = F.conv2d(x, w, stride=self.stride)
        else:
            y = F.conv1d(x, w, dilation=self.dilation)
        b = param(self, "bias", x.dtype)
        return y if b is None else y + b.reshape((-1,) + (1,) * (y.dim() - 2))


class PReLUc(nn.Module):
    """Per-channel PReLU (torch's nn.PReLU(c)): slopes `weight`, 0.25 at init."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,), 0.25))

    def init_from(self, generator=None):
        nn.init.constant_(self.weight, 0.25)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.weight.to(x.dtype).reshape((-1,) + (1,) * (x.dim() - 2))
        return torch.where(x >= 0, x, a * x)


class _Affine(nn.Module):
    """The norm's per-channel `weight` and `bias` (the reference's
    BatchNorm/InstanceNorm affine), and the module its running statistics
    are named after."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def init_from(self, generator=None):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)


class NormSwitch(nn.Module):
    """IN or BN of (B, C, ...) with the affine of its `norm` child.

    The statistics come from the input: over each example's spatial axes
    (IN), or over the batch and spatial axes (BN), in float32, rounded to the
    input's dtype, the variance biased; the normalization runs in the
    input's dtype. A BN norm with attached running statistics (`stats`,
    set by `stats_attached`) uses them instead; a mean without its var
    raises. A BN norm with a training `world` of several processes
    attached (`moments_across`) and no running statistics takes the batch
    axis over every process's rows, in the same float32 two-pass form."""

    def __init__(self, norm_type: str, channels: int, eps: float = 1e-5):
        super().__init__()
        if norm_type not in ("IN", "BN"):
            raise ValueError(norm_type)
        self.norm_type, self.eps = norm_type, eps
        self.norm = _Affine(channels)
        self.stats: Optional[Mapping[str, torch.Tensor]] = None
        self.world: Optional[World] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        stats = self.stats if self.norm_type == "BN" else None
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if stats is not None and ("mean" in stats) != ("var" in stats):
            have, lack = ("mean", "var") if "mean" in stats else ("var", "mean")
            raise ValueError(f"batch_stats of a GaGNet norm carry {have} without {lack}: "
                             "corrupt or mis-pathed running-stats tree (see compat.torch_ckpt."
                             "validate_batch_stats)")
        if stats is not None and "mean" in stats:
            mean = stats["mean"].to(x.dtype).reshape(shape)
            var = stats["var"].to(x.dtype).reshape(shape)
        else:
            axes = tuple(range(2, x.dim())) if self.norm_type == "IN" else (0,) + tuple(
                range(2, x.dim()))
            if self.norm_type == "BN" and self.world is not None and self.world.size > 1:
                mean, var = BatchMoments.apply(x, axes, self.world)
            else:
                xf = x.to(torch.promote_types(x.dtype, torch.float32))
                mean = xf.mean(dim=axes, keepdim=True)
                var = torch.square(xf - mean).mean(dim=axes, keepdim=True)
            mean, var = mean.to(x.dtype), var.to(x.dtype)
        x = (x - mean) * torch.rsqrt(var + scalar(self.eps, x.dtype))
        return x * self.norm.weight.to(x.dtype).reshape(shape) + self.norm.bias.to(
            x.dtype).reshape(shape)


def norm_modules(net: nn.Module) -> Dict[str, NormSwitch]:
    """{name of the norm's affine child (`...norm`): NormSwitch} under `net`:
    the names a reference checkpoint's running statistics carry."""
    return {f"{n}.norm" if n else "norm": m for n, m in net.named_modules()
            if isinstance(m, NormSwitch)}


@contextlib.contextmanager
def stats_attached(net: nn.Module, batch_stats: Optional[BatchStats]) -> Iterator[nn.Module]:
    """Serve `net` with running statistics for the BN norms named in
    `batch_stats`; the others keep the input's statistics. None or empty
    attaches nothing. Raises KeyError for a name that is no norm of `net`."""
    if not batch_stats:
        yield net
        return
    norms = norm_modules(net)
    unknown = sorted(set(batch_stats) - set(norms))
    if unknown:
        raise KeyError(f"batch_stats for modules that are no GaGNet norm: {unknown[:4]}")
    try:
        for name, stats in batch_stats.items():
            norms[name].stats = stats
        yield net
    finally:
        for name in batch_stats:
            norms[name].stats = None


def batch_norms(net: nn.Module) -> List[NormSwitch]:
    """The BN norms under `net`: those whose moments span the batch."""
    return [m for m in net.modules() if isinstance(m, NormSwitch) and m.norm_type == "BN"]


@contextlib.contextmanager
def moments_across(norms: Sequence[NormSwitch], world: World) -> Iterator[None]:
    """For the block, `norms` (`batch_norms`) take their moments over the
    rows of every process of `world`: each forward through them then calls
    collectives, which every process must enter in the same order."""
    try:
        for m in norms:
            m.world = world
        yield
    finally:
        for m in norms:
            m.world = None


def _unit(conv: nn.Module, norm_type: str, channels: int) -> nn.Sequential:
    """Sequential(conv, NormSwitch, PReLU), the reference's `*_conv` units."""
    return nn.Sequential(conv, NormSwitch(norm_type, channels), PReLUc(channels))


class GateConv2d(nn.Module):
    """Gated conv: a conv to 2 x `cout` channels, split, out * sigmoid(gate);
    causal zero padding of kt - 1 steps along T when kt > 1 (the reference's
    `conv` is then Sequential(pad, conv))."""

    def __init__(self, cin: int, cout: int, kernel: Tuple[int, int], stride: Tuple[int, int]):
        super().__init__()
        kt = kernel[0]
        conv = _Conv("conv2d", cin, 2 * cout, tuple(kernel), stride=tuple(stride))
        self.conv = nn.Sequential(nn.ZeroPad2d((0, 0, kt - 1, 0)), conv) if kt > 1 else conv

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out, gate = self.conv(x).chunk(2, dim=1)
        return out * torch.sigmoid(gate)


class Conv2dunit(nn.Module):
    """Conv (stride (1, 2)), norm, PReLU."""

    def __init__(self, k: Tuple[int, int], c: int, norm_type: str):
        super().__init__()
        self.conv = _unit(_Conv("conv2d", c, c, tuple(k), stride=(1, 2)), norm_type, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Deconv2dunit(nn.Module):
    """Transposed conv (stride (1, 2), unpadded), norm, PReLU; `cin` is 2c
    after a concatenated skip."""

    def __init__(self, k: Tuple[int, int], cin: int, c: int, norm_type: str):
        super().__init__()
        self.deconv = _unit(_Conv("conv_transpose2d", cin, c, tuple(k), stride=(1, 2)),
                            norm_type, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.deconv(x)


class EnUnetModule(nn.Module):
    """A residual inner U-Net stage: the gated input conv, `scale` strided
    conv units down and as many transposed conv units up, the skips added or
    concatenated (`intra_connect`), plus the input conv's output."""

    def __init__(self, cin: int, cout: int, k1: Tuple[int, int], k2: Tuple[int, int],
                 intra_connect: str, norm_type: str, scale: int):
        super().__init__()
        self.intra_connect = intra_connect
        self.in_conv = _unit(GateConv2d(cin, cout, k1, (1, 2)), norm_type, cout)
        self.enco = nn.ModuleList(Conv2dunit(k2, cout, norm_type) for _ in range(scale))
        wide = 2 * cout if intra_connect == "cat" else cout
        self.deco = nn.ModuleList(Deconv2dunit(k2, cout if i == 0 else wide, cout, norm_type)
                                  for i in range(scale))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_resi = self.in_conv(x)
        h, skips = x_resi, []
        for unit in self.enco:
            h = unit(h)
            skips.append(h)
        for i, unit in enumerate(self.deco):
            if i > 0:
                aux = skips[-(i + 1)]
                h = h + aux if self.intra_connect == "add" else torch.cat([h, aux], dim=1)
            h = unit(h)
        return x_resi + h


K_BEG, C_END = (2, 5), 64


class U2NetEncoder(nn.Module):
    """Four inner U-Net stages (scales 4, 3, 2, 1) and the last gated conv to 64."""

    def __init__(self, cin: int, k1, k2, c: int, intra_connect: str, norm_type: str):
        super().__init__()
        self.meta_unet_list = nn.ModuleList(
            EnUnetModule(cin if i == 0 else c, c, K_BEG if i == 0 else k1, k2, intra_connect,
                         norm_type, scale=4 - i) for i in range(4))
        self.last_conv = _unit(GateConv2d(c, C_END, k1, (1, 2)), norm_type, C_END)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for stage in self.meta_unet_list:
            x = stage(x)
        return self.last_conv(x)


class UNetEncoder(nn.Module):
    """Five gated conv units, the last to 64 channels."""

    def __init__(self, cin: int, k1, c: int, norm_type: str):
        super().__init__()
        ks = [K_BEG, k1, k1, k1, k1]
        cs = [c, c, c, c, C_END]
        cins = [cin] + cs[:-1]
        self.unet_list = nn.ModuleList(_unit(GateConv2d(ci, co, k, (1, 2)), norm_type, co)
                                       for ci, co, k in zip(cins, cs, ks))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for unit in self.unet_list:
            x = unit(x)
        return x


class SqueezedTCM(nn.Module):
    """Squeezed temporal conv module on (B, d_feat, T): a 1x1 conv down to
    `cd1`, PReLU, norm, the dilated conv (causal: all its padding in front;
    else centred), PReLU, norm, a 1x1 conv back, plus the input."""

    def __init__(self, kd1: int, cd1: int, d_feat: int, dilation: int, causal: bool,
                 norm_type: str):
        super().__init__()
        pad = (kd1 - 1) * dilation
        self.in_conv = _Conv("conv1d", d_feat, cd1, (1,), bias=False)
        self.d_conv = nn.Sequential(
            PReLUc(cd1), NormSwitch(norm_type, cd1),
            nn.ConstantPad1d((pad, 0) if causal else (pad // 2, pad - pad // 2), 0.0),
            _Conv("conv1d", cd1, cd1, (kd1,), bias=False, dilation=dilation))
        self.out_conv = nn.Sequential(PReLUc(cd1), NormSwitch(norm_type, cd1),
                                      _Conv("conv1d", cd1, d_feat, (1,), bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out_conv(self.d_conv(self.in_conv(x))) + x


class SqueezedTCNGroup(nn.Module):
    """One SqueezedTCM per dilation, in sequence."""

    def __init__(self, kd1: int, cd1: int, d_feat: int, dilas: Sequence[int], causal: bool,
                 norm_type: str):
        super().__init__()
        self.tcns = nn.Sequential(*(SqueezedTCM(kd1, cd1, d_feat, d, causal, norm_type)
                                    for d in dilas))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.tcns(x)


def _groups(p: int, *args) -> nn.Sequential:
    return nn.Sequential(*(SqueezedTCNGroup(*args) for _ in range(p)))


class _GatedIn(nn.Module):
    """The gated 1x1 input conv of the glance and gaze blocks: main *
    sigmoid(gate) (the reference's `in_conv_gate` is Sequential(conv,
    sigmoid))."""

    def __init__(self, cin: int, d_feat: int):
        super().__init__()
        self.in_conv_main = _Conv("conv1d", cin, d_feat, (1,))
        self.in_conv_gate = nn.Sequential(_Conv("conv1d", cin, d_feat, (1,)))

    def gated_in(self, inpt: torch.Tensor) -> torch.Tensor:
        return self.in_conv_main(inpt) * torch.sigmoid(self.in_conv_gate(inpt))


ACTIVATIONS = {"sigmoid": torch.sigmoid, "tanh": torch.tanh, "relu": torch.relu}


class GlanceBlock(_GatedIn):
    """The magnitude-gain branch: (B, d_feat + 2F, T) -> gain (B, F, T)."""

    def __init__(self, kd1, cd1, d_feat, p, dilas, freq_bins, causal, acti_type, norm_type):
        super().__init__(d_feat + 2 * freq_bins, d_feat)
        if acti_type not in ACTIVATIONS:
            raise ValueError(f"acti_type {acti_type!r}: sigmoid, tanh or relu")
        self.acti = ACTIVATIONS[acti_type]
        self.tcn_g = _groups(p, kd1, cd1, d_feat, dilas, causal, norm_type)
        self.linear_g = nn.Sequential(_Conv("conv1d", d_feat, freq_bins, (1,)))

    def forward(self, inpt: torch.Tensor) -> torch.Tensor:
        return self.acti(self.linear_g(self.tcn_g(self.gated_in(inpt))))


class GazeBlock(_GatedIn):
    """The complex-residual branch: (B, d_feat + 2F, T) -> (real, imag), each
    (B, F, T); the two share their TCN groups when `is_squeezed`."""

    def __init__(self, kd1, cd1, d_feat, p, dilas, freq_bins, causal, is_squeezed, norm_type):
        super().__init__(d_feat + 2 * freq_bins, d_feat)
        self.is_squeezed = is_squeezed
        args = (p, kd1, cd1, d_feat, dilas, causal, norm_type)
        if is_squeezed:
            self.tcm_ri = _groups(*args)
        else:
            self.tcm_r, self.tcm_i = _groups(*args), _groups(*args)
        self.linear_r = _Conv("conv1d", d_feat, freq_bins, (1,))
        self.linear_i = _Conv("conv1d", d_feat, freq_bins, (1,))

    def forward(self, inpt: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.gated_in(inpt)
        if self.is_squeezed:
            xr = xi = self.tcm_ri(x)
        else:
            xr, xi = self.tcm_r(x), self.tcm_i(x)
        return self.linear_r(xr), self.linear_i(xi)


class GlanceGazeModule(nn.Module):
    """Coarse magnitude filtering plus the complex residual:
    feat (B, d_feat, T) and the previous estimate (B, 2, T, F) -> (B, 2, T, F)."""

    def __init__(self, kd1, cd1, d_feat, p, dilas, freq_bins, causal, is_squeezed, acti_type,
                 norm_type):
        super().__init__()
        self.glance_block = GlanceBlock(kd1, cd1, d_feat, p, dilas, freq_bins, causal,
                                        acti_type, norm_type)
        self.gaze_block = GazeBlock(kd1, cd1, d_feat, p, dilas, freq_bins, causal, is_squeezed,
                                    norm_type)

    def forward(self, feat: torch.Tensor, pre_x: torch.Tensor) -> torch.Tensor:
        B, _, T, Fq = pre_x.shape
        # planar [re(all F), im(all F)] channels, the reference's pre_x.view(b, 2F, T)
        inpt = torch.cat([feat, pre_x.transpose(2, 3).reshape(B, 2 * Fq, T)], dim=1)
        gain = self.glance_block(inpt).transpose(1, 2)  # (B, T, F)
        res_r, res_i = self.gaze_block(inpt)
        re, im = pre_x[:, 0], pre_x[:, 1]
        mag = torch.sqrt(re ** 2 + im ** 2 + scalar(1e-12, re.dtype))
        phase = torch.atan2(im, re)
        filtered = mag * gain
        return torch.stack([filtered * torch.cos(phase) + res_r.transpose(1, 2),
                            filtered * torch.sin(phase) + res_i.transpose(1, 2)], dim=1)


class GaGNet(nn.Module):
    """Glance-and-gaze spectral denoiser; packed-real (B, 1, F, T, 2) in, the
    same shape out (the tanh complex mask times the input), float32.
    `time_cond` is accepted and ignored. Defaults are the reference CLI's."""

    FORCE_STFT_OUT = False
    SUPPORTS_DEEPCACHE = False

    def __init__(self, cin: int = 2, dnn_channels: int = 1, fft_num: int = 512,
                 k1: Tuple[int, int] = (2, 3), k2: Tuple[int, int] = (1, 3), c: int = 64,
                 kd1: int = 3, cd1: int = 64, d_feat: int = 448, p: int = 2, q: int = 3,
                 dilas: Tuple[int, ...] = (1, 2, 5, 9), is_u2: bool = True,
                 causal: bool = False, is_squeezed: bool = False, acti_type: str = "sigmoid",
                 intra_connect: str = "cat", norm_type: str = "IN",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise NotImplementedError(f"GaGNet: dtype {dtype} is not ported")
        self.dtype = dtype
        k1, k2, dilas = tuple(k1), tuple(k2), tuple(dilas)
        if is_u2:
            self.en = U2NetEncoder(cin, k1, k2, c, intra_connect, norm_type)
        else:
            self.en = UNetEncoder(cin, k1, c, norm_type)
        freq_bins = fft_num * dnn_channels // 2 + 1
        self.gags = nn.ModuleList(
            GlanceGazeModule(kd1, cd1, d_feat * dnn_channels, p, dilas, freq_bins, causal,
                             is_squeezed, acti_type, norm_type) for _ in range(q))

    @classmethod
    def from_kwargs(cls, **kwargs) -> "GaGNet":
        """Construct, ignoring keyword arguments that are not fields."""
        names = set(inspect.signature(cls.__init__).parameters) - {"self"}
        return cls(**{k: v for k, v in kwargs.items() if k in names})

    @staticmethod
    def add_argparse_args(parser):
        """The reference's CLI group (storm_tpu/backbones/gagnet.py:489-527):
        tuples as comma strings ("2,3"), `--causal` alone or `--causal
        True/False` (ConvTasNet's spelling of the same option string)."""
        def tup(s):
            return tuple(int(v) for v in str(s).split(","))

        parser.add_argument("--cin", type=int, default=2)
        parser.add_argument("--dnn_channels", type=int, default=1)
        parser.add_argument("--fft_num", type=int, default=512)
        parser.add_argument("--k1", type=tup, default=(2, 3))
        parser.add_argument("--k2", type=tup, default=(1, 3))
        parser.add_argument("--c", type=int, default=64)
        parser.add_argument("--kd1", type=int, default=3)
        parser.add_argument("--cd1", type=int, default=64)
        parser.add_argument("--d_feat", type=int, default=448)
        parser.add_argument("--p", type=int, default=2)
        parser.add_argument("--q", type=int, default=3)
        parser.add_argument("--dilas", type=tup, default=(1, 2, 5, 9))
        parser.add_argument("--is_u2", type=lambda s: s not in ("False", "false", "0"),
                            default=True)
        parser.add_argument("--causal", nargs="?", const=True, default=False,
                            type=optional_bool)
        parser.add_argument("--is_squeezed", type=lambda s: s in ("True", "true", "1"),
                            default=False)
        parser.add_argument("--acti_type", type=str, default="sigmoid",
                            choices=["sigmoid", "tanh", "relu"])
        parser.add_argument("--intra_connect", type=str, default="cat", choices=["cat", "add"])
        parser.add_argument("--norm_type", type=str, default="IN", choices=["BN", "IN"])
        return parser

    def forward(self, x: torch.Tensor, time_cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, D, Fq, T, _ = x.shape
        if D != 1:
            raise ValueError("GaGNet supports dnn_channels=1 here")
        x_in = x.to(self.dtype)
        h = x_in[:, 0].permute(0, 3, 2, 1)  # (B, 2, T, F)
        pad_f = 1 if Fq % 2 == 0 else 0  # F made odd
        if pad_f:
            h = F.pad(h, (0, pad_f))
        feat = self.en(h)  # (B, C, T, Ff)
        # C-major flattening (channel slow, freq fast), the reference's order
        z = feat.transpose(2, 3).reshape(B, -1, feat.shape[2])
        pre_z = h
        for gag in self.gags:
            pre_z = gag(z, pre_z)
        masks = torch.tanh(pre_z[..., :Fq].transpose(2, 3))  # (B, 2, F, T)
        xr, xi = x_in[:, 0, ..., 0], x_in[:, 0, ..., 1]
        mr, mi = masks[:, 0], masks[:, 1]
        out = torch.stack([mr * xr - mi * xi, mr * xi + mi * xr], dim=-1)
        return out[:, None].float()
