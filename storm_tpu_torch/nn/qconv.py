"""Quantizable 2-D convolution for int8 W8A8 serving (counterpart of
storm_tpu/nn/qconv.py `QuantizableConv`).

`QuantizableConv` is an `nn.Conv2d` (stride 1, symmetric zero padding, one
group: what `conv3x3` and `conv1x1` build) with the same parameters
(`weight`, `bias`, float32) and, by default, the reference's convolution in
the dtype of its input: the weight cast to it (nn/cast.py), the product
rounded to it, then the bias, cast to it, added in it (flax rounds twice in
bfloat16; a bias passed to `F.conv2d` would be added before the one
rounding on the CPU; on the card PyTorch adds it in a kernel of its own
either way). Two modes are switched on per module, for the duration of a
`with` block:

- calibration (`stats_collected`): the running max|input| of every conv that
  runs, kept on the device as a 0-d tensor (no host sync per call);
- quantized serving (`scales_attached`): given the calibrated activation
  scale `a_scale`, the input is quantized per tensor with the K3 kernel
  (`kernels/quant.py`, inv = 1 / a_scale), the weight per output channel
  (w_scale = max|w| over (I, kh, kw) / 127, codes round(w / w_scale)), the
  conv runs as an int8 x int8 -> int32 product with exact int32
  accumulation, and the epilogue is acc * (a_scale * w_scale) + bias in the
  compute dtype, in the reference's order (storm_tpu/nn/qconv.py:156-161).
  Under bfloat16 the quantizer forms x * inv in bfloat16, and the epilogue
  rounds acc to bfloat16 (through float32, as XLA converts int32 to
  bfloat16), multiplies by the scale rounded to bfloat16 and adds the bias
  rounded to bfloat16, each step rounded.

The scales become float32 values, and the weight codes and dequantizing
scales (float32 and bfloat16) tensors, once when they are attached, from
the weights as they are then and with no upload: a conv call then syncs
nothing with the host, and a captured enhancement, which attaches them
inside the graph, requantizes the live weights on every replay. The int8 product is an im2col of the int8 codes (a quarter of
the bytes of a float32 im2col) followed by `torch._int_mm`; the reference
leaves the same integer product to XLA's `conv_general_dilated` outside any
Pallas kernel. A float32 conv of the codes would not be exact: 3*3*512
products of up to 127^2 reach 7.4e7 > 2^24.

The reference's up path quantizes the two halves of a virtual concat
[h, skip] with one scale, its amax the max over both halves, and concatenates
the int8 codes (`x2`, storm_tpu/nn/qconv.py:90-93, 143-149). The port's
resblocks see `torch.cat([h, skip], 1)`: its max|.| is the same amax, and
quantizing it elementwise gives the same codes in the same order.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.quant import quantize_int8
from .cast import param


def activation_inverse(a_scale: float) -> float:
    """inv = float32(1) / max(float32(a_scale), 1e-20), in float32 (qconv.py:128)."""
    a = np.float32(a_scale)
    return float(np.float32(1.0) / np.maximum(a, np.float32(1e-20)))


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel int8 codes of a float32 (O, I, kh, kw) weight and
    their scales (O,): w_scale = max(max|w| over (I, kh, kw), 1e-20) / 127,
    codes clip(round(w / w_scale), -127, 127) (qconv.py:133-136)."""
    w = w.detach().to(torch.float32)
    w_scale = w.abs().amax(dim=(1, 2, 3)).clamp_min(1e-20) / 127.0
    codes = torch.round(w / w_scale[:, None, None, None]).clamp_(-127.0, 127.0)
    return codes.to(torch.int8), w_scale


def conv2d_int8(xq: torch.Tensor, wq_cols: torch.Tensor, kernel_size: int,
                padding: int) -> torch.Tensor:
    """Exact int32 stride-1 conv of int8 NCHW codes with int8 weight codes in
    the (kh * kw * I, O) layout of `weight_columns`; returns (B, O, Ho, Wo)
    int32 as a view of a (B * Ho * Wo, O) product."""
    B, C, H, W = xq.shape
    k = kernel_size
    Ho, Wo = H + 2 * padding - k + 1, W + 2 * padding - k + 1
    x = xq.permute(0, 2, 3, 1)  # NHWC view
    if padding:
        x = F.pad(x, (0, 0, padding, padding, padding, padding))
    if k == 1:
        cols = x.reshape(B * Ho * Wo, C)
    else:  # (B, Ho, Wo, k*k, C): column index (i*k + j)*C + c
        cols = torch.stack([x[:, i:i + Ho, j:j + Wo, :] for i in range(k) for j in range(k)],
                           dim=3).reshape(B * Ho * Wo, k * k * C)
    acc = torch._int_mm(cols, wq_cols)
    return acc.view(B, Ho, Wo, -1).permute(0, 3, 1, 2)


def weight_columns(codes: torch.Tensor) -> torch.Tensor:
    """(O, I, kh, kw) codes -> the (kh * kw * I, O) operand of `conv2d_int8`,
    a transposed view of a contiguous (O, kh * kw * I) tensor: both operands
    of the product are contiguous along the reduction."""
    O = codes.shape[0]
    return codes.permute(0, 2, 3, 1).reshape(O, -1).t()


def conv_forward(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """`conv` applied to x in x's dtype, as flax's Conv with `dtype=`: the
    product with the weight cast to x's dtype, rounded, then the bias, cast
    to x's dtype, added."""
    y = F.conv2d(x, param(conv, "weight", x.dtype), None, conv.stride, conv.padding,
                 conv.dilation, conv.groups)
    bias = param(conv, "bias", x.dtype)
    return y if bias is None else y.add_(bias[:, None, None])


class QuantizableConv(nn.Conv2d):
    """nn.Conv2d with a calibration mode and an int8 W8A8 serving path,
    computing in the dtype of its input."""

    CAST_PARAMS = ("weight", "bias")

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.calibrating = False
        self.amax: Optional[torch.Tensor] = None  # running max|input| while calibrating
        self.a_scale: Optional[float] = None
        # (inv, weight columns, {dtype: dequantizing scale (O,)}) while a scale is attached
        self._int8: Optional[Tuple[float, torch.Tensor, Dict[torch.dtype, torch.Tensor]]] = None

    def _check_int8_geometry(self) -> None:
        k, p = self.kernel_size, self.padding
        if (self.stride != (1, 1) or self.dilation != (1, 1) or self.groups != 1
                or k[0] != k[1] or isinstance(p, str) or p[0] != p[1]
                or self.padding_mode != "zeros"):
            raise NotImplementedError(
                "int8 path: stride 1, square kernel, symmetric zero padding, one group only")

    @torch.no_grad()
    def set_scale(self, a_scale: Optional[float]) -> None:
        """Attach the activation scale of the int8 path (None detaches):
        quantizes the weight as it is now."""
        if a_scale is None:
            self.a_scale = self._int8 = None
            return
        self._check_int8_geometry()
        a = np.float32(a_scale)
        codes, w_scale = quantize_weight(self.weight)
        dequant = w_scale * float(a)  # float32 (qconv.py:158); no upload, so a graph captures it
        self.a_scale = float(a)
        self._int8 = (activation_inverse(a), weight_columns(codes),
                      {torch.float32: dequant, torch.bfloat16: dequant.to(torch.bfloat16)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.calibrating:
            big = x.detach().abs().amax().to(torch.float32)
            self.amax = big if self.amax is None else torch.maximum(self.amax, big)
        if self._int8 is None:
            return conv_forward(self, x)
        inv, wq_cols, dequant = self._int8
        xq = quantize_int8(x.contiguous(), inv, product=x.dtype)  # K3
        acc = conv2d_int8(xq, wq_cols, self.kernel_size[0], self.padding[0])
        # acc in the compute dtype, times the scale in it, into a contiguous output
        y = torch.empty(acc.shape, dtype=x.dtype, device=acc.device)
        torch.mul(acc, dequant[x.dtype][:, None, None], out=y)
        bias = param(self, "bias", x.dtype)
        if bias is not None:
            y += bias[:, None, None]
        return y


def quantizable_convs(net: nn.Module) -> Dict[str, QuantizableConv]:
    """{module name: conv} for every QuantizableConv under `net`."""
    return {n: m for n, m in net.named_modules() if isinstance(m, QuantizableConv)}


@contextlib.contextmanager
def scales_attached(net: nn.Module, scales: Mapping[str, float]) -> Iterator[nn.Module]:
    """Serve `net` with the named convs on the int8 path; every other conv
    stays float32. Raises KeyError for a name that is no QuantizableConv."""
    convs = quantizable_convs(net)
    unknown = sorted(set(scales) - set(convs))
    if unknown:
        raise KeyError(f"int8 scales for modules that are no quantizable conv: {unknown[:4]}")
    try:
        for name, a_scale in scales.items():
            convs[name].set_scale(a_scale)
        yield net
    finally:
        for name in scales:
            convs[name].set_scale(None)


@contextlib.contextmanager
def stats_collected(net: nn.Module) -> Iterator[Dict[str, torch.Tensor]]:
    """Calibrate `net`: yields a dict that, after the block, maps the name of
    every QuantizableConv that ran to its max|input| (a 0-d float32 tensor on
    the device)."""
    convs = quantizable_convs(net)
    stats: Dict[str, torch.Tensor] = {}
    for m in convs.values():
        m.calibrating, m.amax = True, None
    try:
        yield stats
    finally:
        for name, m in convs.items():
            if m.amax is not None:
                stats[name] = m.amax
            m.calibrating, m.amax = False, None
