"""NCSN++ on NCHW tensors (counterpart of storm_tpu/backbones/ncsnpp.py).

Modules are built in the reference's order in `all_modules` (flax `m{i}` is
`all_modules.{i}` here), so parameters convert by position. This slice covers
the configuration StoRM runs: BigGAN resblocks, FIR resampling, output_skip /
input_skip pyramids combined by sum, Fourier time embedding, and the
discriminative (denoiser) variant. Other options raise NotImplementedError.

The public interface keeps the reference's packed-real layout: input
(B, Cc, F, T, 2) with complex channel c at real channels [2c, 2c+1], output
(B, D, F, T, 2) from a 1x1 conv whose channels are [re(d)...] + [im(d)...].
"""
from __future__ import annotations

import inspect
from typing import Optional, Sequence

import torch
from torch import nn

from ..nn.layers import (
    AttnBlockpp,
    Combine,
    Dense,
    Downsample,
    GaussianFourierProjection,
    OutputConv,
    ResnetBlockBigGANpp,
    Upsample,
    conv3x3,
    get_act,
    group_norm,
)


class NCSNpp(nn.Module):
    """NCSN++; the defaults are the 27.8M-parameter configuration."""

    def __init__(
        self,
        scale_by_sigma: bool = True,
        nonlinearity: str = "swish",
        nf: int = 128,
        ch_mult: Sequence[int] = (1, 2, 2, 2),
        num_res_blocks: int = 1,
        attn_resolutions: Sequence[int] = (0,),
        resamp_with_conv: bool = True,
        conditional: bool = True,
        fir: bool = True,
        fir_kernel: Sequence[int] = (1, 3, 3, 1),
        skip_rescale: bool = True,
        resblock_type: str = "biggan",
        progressive: str = "output_skip",
        progressive_input: str = "input_skip",
        progressive_combine: str = "sum",
        init_scale: float = 0.0,
        fourier_scale: float = 16.0,
        image_size: int = 256,
        embedding_type: str = "fourier",
        input_channels: int = 4,
        spatial_channels: int = 1,
        dropout: float = 0.0,
        centered: bool = False,
        discriminative: bool = False,
    ):
        super().__init__()
        unsupported = {
            "resblock_type": (resblock_type, "biggan"),
            "progressive": (progressive, "output_skip"),
            "progressive_input": (progressive_input, "input_skip"),
            "progressive_combine": (progressive_combine, "sum"),
            "embedding_type": (embedding_type, "fourier"),
            "fir": (fir, True),
        }
        for name, (got, want) in unsupported.items():
            if got != want:
                raise NotImplementedError(f"NCSNpp: {name}={got!r} is not ported yet")
        del resamp_with_conv  # only read by the ddpm resblock type

        # the discriminative variant is unconditional, unscaled, 2 channels
        self.conditional = False if discriminative else conditional
        self.scale_by_sigma = False if discriminative else scale_by_sigma
        self.total_channels = (2 if discriminative else input_channels) * spatial_channels
        self.spatial_channels = spatial_channels
        self.num_res_blocks = num_res_blocks
        self.num_resolutions = len(ch_mult)
        self.all_resolutions = [image_size // (2**i) for i in range(self.num_resolutions)]
        self.attn_resolutions = tuple(attn_resolutions)
        self.centered = centered
        self.act = act = get_act(nonlinearity)

        def ResBlock(in_ch, out_ch=None, **kw):
            return ResnetBlockBigGANpp(
                act=act, in_ch=in_ch, out_ch=out_ch,
                temb_dim=nf * 4 if self.conditional else None,
                dropout=dropout, fir=fir, fir_kernel=fir_kernel,
                skip_rescale=skip_rescale, init_scale=init_scale, **kw)

        def Attn(ch):
            return AttnBlockpp(ch, skip_rescale=skip_rescale, init_scale=init_scale)

        self.pyramid_upsample = Upsample(fir_kernel)
        self.pyramid_downsample = Downsample(fir_kernel)

        modules = [GaussianFourierProjection(embedding_size=nf, scale=fourier_scale)]
        if self.conditional:
            modules += [Dense(2 * nf, nf * 4), Dense(nf * 4, nf * 4)]

        # --- downsampling trunk
        modules.append(conv3x3(self.total_channels, nf))
        hs_c = [nf]
        in_ch = nf
        for i_level in range(self.num_resolutions):
            for _ in range(num_res_blocks):
                out_ch = nf * ch_mult[i_level]
                modules.append(ResBlock(in_ch, out_ch))
                in_ch = out_ch
                if self.all_resolutions[i_level] in self.attn_resolutions:
                    modules.append(Attn(in_ch))
                hs_c.append(in_ch)
            if i_level != self.num_resolutions - 1:
                modules.append(ResBlock(in_ch, down=True))
                modules.append(Combine(self.total_channels, in_ch, method="sum"))
                hs_c.append(in_ch)

        # --- bottleneck
        in_ch = hs_c[-1]
        modules += [ResBlock(in_ch), Attn(in_ch), ResBlock(in_ch)]

        # --- upsampling trunk
        for i_level in reversed(range(self.num_resolutions)):
            for _ in range(num_res_blocks + 1):
                out_ch = nf * ch_mult[i_level]
                modules.append(ResBlock(in_ch + hs_c.pop(), out_ch))
                in_ch = out_ch
            if self.all_resolutions[i_level] in self.attn_resolutions:
                modules.append(Attn(in_ch))
            modules.append(group_norm(in_ch))
            modules.append(conv3x3(in_ch, self.total_channels, init_scale=init_scale))
            if i_level != 0:
                modules.append(ResBlock(in_ch, up=True))
        assert not hs_c

        self.all_modules = nn.ModuleList(modules)
        self.output_layer = OutputConv(self.total_channels, 2 * spatial_channels)

    @classmethod
    def from_kwargs(cls, **kwargs) -> "NCSNpp":
        """Construct, ignoring keyword arguments that are not fields."""
        names = set(inspect.signature(cls.__init__).parameters) - {"self"}
        return cls(**{k: v for k, v in kwargs.items() if k in names})

    def forward(self, x: torch.Tensor, time_cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, Cc, F, T, 2) packed-real -> (B, spatial_channels, F, T, 2)."""
        B, Cc, Fdim, Tdim, _ = x.shape
        if 2 * Cc != self.total_channels:
            raise ValueError(f"got {Cc} complex channels, expected {self.total_channels // 2}")
        # contiguous: for Cc=1 the reshape is a strided view, which upfirdn2d refuses
        h_in = x.permute(0, 1, 4, 2, 3).reshape(B, 2 * Cc, Fdim, Tdim).contiguous()
        h = self._unet(h_in, time_cond)
        h = self.output_layer(h)  # (B, 2D, F, T): [re(d)...] + [im(d)...]
        D = self.spatial_channels
        return h.reshape(B, 2, D, Fdim, Tdim).permute(0, 2, 3, 4, 1)

    def _unet(self, h_in: torch.Tensor, time_cond: Optional[torch.Tensor]) -> torch.Tensor:
        modules = self.all_modules
        act = self.act
        m_idx = 0

        # Fourier features of log(t); computed (and unused) when unconditional
        temb = modules[m_idx](torch.log(time_cond)) if time_cond is not None else None
        m_idx += 1
        if self.conditional:
            temb = modules[m_idx](temb)
            m_idx += 1
            temb = modules[m_idx](act(temb))
            m_idx += 1
        else:
            temb = None

        if not self.centered:
            h_in = 2.0 * h_in - 1.0

        # --- downsampling
        input_pyramid = h_in
        hs = [modules[m_idx](h_in)]
        m_idx += 1
        for i_level in range(self.num_resolutions):
            for _ in range(self.num_res_blocks):
                h = modules[m_idx](hs[-1], temb)
                m_idx += 1
                if self.all_resolutions[i_level] in self.attn_resolutions:
                    h = modules[m_idx](h)
                    m_idx += 1
                hs.append(h)
            if i_level != self.num_resolutions - 1:
                h = modules[m_idx](hs[-1], temb)
                m_idx += 1
                input_pyramid = self.pyramid_downsample(input_pyramid)
                h = modules[m_idx](input_pyramid, h)
                m_idx += 1
                hs.append(h)

        # --- bottleneck
        h = modules[m_idx](hs[-1], temb)
        h = modules[m_idx + 1](h)
        h = modules[m_idx + 2](h, temb)
        m_idx += 3

        # --- upsampling
        pyramid = None
        for i_level in reversed(range(self.num_resolutions)):
            for _ in range(self.num_res_blocks + 1):
                h = modules[m_idx](torch.cat([h, hs.pop()], dim=1), temb)
                m_idx += 1
            if self.all_resolutions[i_level] in self.attn_resolutions:
                h = modules[m_idx](h)
                m_idx += 1
            pyramid_h = modules[m_idx + 1](act(modules[m_idx](h)))
            m_idx += 2
            if pyramid is None:
                pyramid = pyramid_h
            else:
                pyramid = self.pyramid_upsample(pyramid) + pyramid_h
            if i_level != 0:
                h = modules[m_idx](h, temb)
                m_idx += 1
        assert not hs and m_idx == len(modules)

        h = pyramid
        if self.scale_by_sigma:
            # divides by t itself, as the reference does
            h = h / time_cond[:, None, None, None]
        return h


def count_parameters(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
