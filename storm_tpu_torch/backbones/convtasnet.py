"""ConvTasNet, the time-domain denoiser (counterpart of
storm_tpu/backbones/convtasnet.py), on NCL tensors.

A learned Conv1d filterbank (a `win`-ms window, half-window hop) encodes the
waveform; a TCN of dilated depthwise-separable blocks (PReLU, a cumulative
layer norm `cLN` when causal, else `GlobalLN`) estimates a sigmoid mask;
the masked encoding is decoded by a ConvTranspose1d and cropped back to the
input's length. `FORCE_STFT_OUT`: the models feed it waveforms
(models/base.time_domain_denoise). Every conv is a library call (cuDNN): the
reference has no Pallas kernel here.

Parameters keep the reference's flat names (`encoder_w`, `TCN.BN_w`,
`TCN.TCN_{i}.dconv1d_w`, `...reg1.gain`, `...nonlinearity1.alpha`) in
PyTorch's layouts: a conv1d weight (O, I/groups, K); `decoder_w` a
conv_transpose1d weight (I, O, K), the reference's taps flipped
(convert.py). The net computes in its `dtype` with float32 parameters,
cast per use, and returns float32, as the reference's `dtype` field does.
"""
from __future__ import annotations

import inspect
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.cast import param, scalar
from ..nn.init import lecun_normal_
from ..nn.resample import conv_transpose


def optional_bool(s: str) -> bool:
    """`--causal True/False` (and a bare `--causal`, through `const`)."""
    return s in ("True", "true", "1")


class _Conv1dParams(nn.Module):
    """A module whose `CAST_PARAMS` are read in the input's dtype through
    `param`; `init_from` draws each `*_w` with flax's LeCun normal (fan-in
    I/groups x K) and zeros each `*_b`."""

    CAST_PARAMS: Tuple[str, ...] = ()

    def init_from(self, generator=None):
        for name in self.CAST_PARAMS:
            p = getattr(self, name)
            if name.endswith("_w"):
                lecun_normal_(p, self._fan_in(name, p), generator)
            else:
                nn.init.zeros_(p)

    def _fan_in(self, name: str, p: torch.Tensor) -> int:
        return p.shape[1] * p.shape[2]

    def _conv(self, x: torch.Tensor, name: str, **kw) -> torch.Tensor:
        w = param(self, f"{name}_w", x.dtype)
        b = param(self, f"{name}_b", x.dtype)
        return F.conv1d(x, w, **kw) + b[:, None]


class PReLU(nn.Module):
    """PReLU with one shared slope `alpha` (torch's default, 0.25)."""

    def __init__(self, init: float = 0.25):
        super().__init__()
        self.init = init
        self.alpha = nn.Parameter(torch.full((1,), init))

    def init_from(self, generator=None):
        nn.init.constant_(self.alpha, self.init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.alpha.to(x.dtype) * x)


class cLN(nn.Module):  # noqa: N801 (the reference's name)
    """Cumulative (causal) layer norm over the channels up to each step, of
    (B, C, L): the running mean and variance of all channels of steps 0..l."""

    def __init__(self, channels: int, eps: float = 1e-8):
        super().__init__()
        self.eps = eps
        self.gain = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def init_from(self, generator=None):
        nn.init.ones_(self.gain)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, L = x.shape
        cum_sum = torch.cumsum(x.sum(dim=1), dim=1)  # (B, L)
        cum_pow = torch.cumsum((x ** 2).sum(dim=1), dim=1)
        cnt = torch.arange(C, C * (L + 1), C, dtype=x.dtype, device=x.device)[None, :]
        cum_mean = cum_sum / cnt
        cum_var = (cum_pow - 2 * cum_mean * cum_sum) / cnt + cum_mean ** 2
        cum_std = torch.sqrt(cum_var + scalar(self.eps, x.dtype))
        x = (x - cum_mean[:, None]) / cum_std[:, None]
        return x * self.gain.to(x.dtype)[:, None] + self.bias.to(x.dtype)[:, None]


class GlobalLN(nn.Module):
    """GroupNorm with one group: a layer norm over (C, L) jointly."""

    def __init__(self, channels: int, eps: float = 1e-8):
        super().__init__()
        self.eps = eps
        self.gain = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def init_from(self, generator=None):
        nn.init.ones_(self.gain)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=(1, 2), keepdim=True)
        var = ((x - mean) ** 2).mean(dim=(1, 2), keepdim=True)
        x = (x - mean) * torch.rsqrt(var + scalar(self.eps, x.dtype))
        return x * self.gain.to(x.dtype)[:, None] + self.bias.to(x.dtype)[:, None]


def _norm(causal: bool, channels: int) -> nn.Module:
    return cLN(channels) if causal else GlobalLN(channels)


class DepthConv1d(_Conv1dParams):
    """1x1 conv, PReLU, norm, dilated depthwise conv, PReLU, norm, then the
    residual and skip 1x1 convs. Causal: all the depthwise conv's padding on
    the left."""

    def __init__(self, input_channel: int, hidden_channel: int, kernel: int,
                 dilation: int = 1, skip: bool = True, causal: bool = False):
        super().__init__()
        H = hidden_channel
        self.kernel, self.dilation, self.skip, self.causal = kernel, dilation, skip, causal
        self.conv1d_w = nn.Parameter(torch.empty(H, input_channel, 1))
        self.conv1d_b = nn.Parameter(torch.zeros(H))
        self.nonlinearity1 = PReLU()
        self.reg1 = _norm(causal, H)
        self.dconv1d_w = nn.Parameter(torch.empty(H, 1, kernel))
        self.dconv1d_b = nn.Parameter(torch.zeros(H))
        self.nonlinearity2 = PReLU()
        self.reg2 = _norm(causal, H)
        self.res_out_w = nn.Parameter(torch.empty(input_channel, H, 1))
        self.res_out_b = nn.Parameter(torch.zeros(input_channel))
        names = ["conv1d_w", "conv1d_b", "dconv1d_w", "dconv1d_b", "res_out_w", "res_out_b"]
        if skip:
            self.skip_out_w = nn.Parameter(torch.empty(input_channel, H, 1))
            self.skip_out_b = nn.Parameter(torch.zeros(input_channel))
            names += ["skip_out_w", "skip_out_b"]
        self.CAST_PARAMS = tuple(names)
        self.init_from(None)

    def forward(self, x: torch.Tensor):
        out = self.reg1(self.nonlinearity1(self._conv(x, "conv1d")))
        pad = (self.kernel - 1) * self.dilation
        out = F.pad(out, (pad, 0) if self.causal else (pad // 2, pad - pad // 2))
        out = self._conv(out, "dconv1d", dilation=self.dilation, groups=out.shape[1])
        out = self.reg2(self.nonlinearity2(out))
        residual = self._conv(out, "res_out")
        if self.skip:
            return residual, self._conv(out, "skip_out")
        return residual


class TCN(_Conv1dParams):
    """The norm and 1x1 bottleneck, `stack` x `layer` dilated blocks whose
    skip outputs are summed, PReLU and the output 1x1 conv, on (B, C, L)."""

    CAST_PARAMS = ("BN_w", "BN_b", "output_w", "output_b")

    def __init__(self, input_dim: int, output_dim: int, BN_dim: int, hidden_dim: int,
                 layer: int, stack: int, kernel: int = 3, skip: bool = True,
                 causal: bool = False, dilated: bool = True):
        super().__init__()
        self.skip = skip
        self.LN = _norm(causal, input_dim)
        self.BN_w = nn.Parameter(torch.empty(BN_dim, input_dim, 1))
        self.BN_b = nn.Parameter(torch.zeros(BN_dim))
        self.n_blocks = layer * stack
        for idx in range(self.n_blocks):
            i = idx % layer
            setattr(self, f"TCN_{idx}", DepthConv1d(
                BN_dim, hidden_dim, kernel, dilation=2 ** i if dilated else 1, skip=skip,
                causal=causal))
        self.output_prelu = PReLU()
        self.output_w = nn.Parameter(torch.empty(output_dim, BN_dim, 1))
        self.output_b = nn.Parameter(torch.zeros(output_dim))
        self.init_from(None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        output = self._conv(self.LN(x), "BN")
        skip_connection = 0.0
        for idx in range(self.n_blocks):
            block = getattr(self, f"TCN_{idx}")
            if self.skip:
                residual, skip = block(output)
                output = output + residual
                skip_connection = skip_connection + skip
            else:
                output = output + block(output)
        h = skip_connection if self.skip else output
        return self._conv(self.output_prelu(h), "output")


class ConvTasNet(_Conv1dParams):
    """Time-domain masking denoiser (the reference's `convtasnet`): waveforms
    (B, T) or (B, 1, T) in, the same shape out, float32; `time_cond` is
    accepted and ignored."""

    FORCE_STFT_OUT = True
    SUPPORTS_DEEPCACHE = False
    CAST_PARAMS = ("encoder_w", "decoder_w")

    def __init__(self, fs: int = 16000, win: float = 2.0, enc_dim: int = 256,
                 feature_dim: int = 128, layer: int = 8, stack: int = 3, kernel: int = 3,
                 causal: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise NotImplementedError(f"ConvTasNet: dtype {dtype} is not ported")
        self.dtype = dtype
        self.win_samples = int(fs * win / 1000)
        self.stride = self.win_samples // 2
        self.encoder_w = nn.Parameter(torch.empty(enc_dim, 1, self.win_samples))
        self.TCN = TCN(enc_dim, enc_dim, feature_dim, feature_dim * 4, layer, stack,
                       kernel=kernel, causal=causal)
        self.decoder_w = nn.Parameter(torch.empty(enc_dim, 1, self.win_samples))
        self.init_from(None)

    def _fan_in(self, name: str, p: torch.Tensor) -> int:
        # the reference's kernels: encoder (win, 1, N), decoder (win, N, 1)
        return p.shape[2] * (p.shape[1] if name == "encoder_w" else p.shape[0])

    @classmethod
    def from_kwargs(cls, **kwargs) -> "ConvTasNet":
        """Construct, ignoring keyword arguments that are not fields."""
        names = set(inspect.signature(cls.__init__).parameters) - {"self"}
        return cls(**{k: v for k, v in kwargs.items() if k in names})

    @staticmethod
    def add_argparse_args(parser):
        """The reference's CLI group: `--causal` alone or `--causal
        True/False` (GaGNet's spelling of the same option string)."""
        parser.add_argument("--causal", nargs="?", const=True, default=False,
                            type=optional_bool)
        return parser

    def _pad_amounts(self, nsample: int) -> Tuple[int, int]:
        """(front, back) zeros: `stride` on each side, and at the end what
        makes the length a whole number of windows (the reference's
        pad_signal)."""
        win, stride = self.win_samples, self.stride
        rest = (win - (stride + nsample % win) % win) % win
        return stride, rest + stride

    def forward(self, x: torch.Tensor, time_cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        squeeze = x.dim() == 2
        if squeeze:
            x = x[:, None, :]
        if x.shape[1] != 1:
            raise ValueError("ConvTasNet is single-channel")
        T = x.shape[-1]
        front, back = self._pad_amounts(T)
        h = F.pad(x, (front, back)).to(self.dtype)  # (B, 1, L)
        enc = F.conv1d(h, param(self, "encoder_w", h.dtype), stride=self.stride)
        masked = enc * torch.sigmoid(self.TCN(enc))
        out = conv_transpose(masked, param(self, "decoder_w", h.dtype), stride=self.stride)
        out = out[:, 0, front:front + T].float()
        return out if squeeze else out[:, None, :]

