"""NCSN++ on NCHW tensors (counterpart of storm_tpu/backbones/ncsnpp.py).

Modules are built in the reference's order in `all_modules` (flax `m{i}` is
`all_modules.{i}` here), so parameters convert by position. Every option of
the reference runs: BigGAN or DDPM resblocks, FIR or plain resampling (with
a 3x3 conv where `resamp_with_conv`), output and input pyramids that are
`output_skip` / `input_skip`, `residual` or `none`, combined by `sum` or
`cat`, the Fourier or the positional (sinusoidal) time embedding, and the
discriminative (denoiser) variant; `ncsnpplarge`, `ncsnpp12M` and
`ncsnpp6M` are its published sizes, `ae-ncsnpp` the trunk on a learned
filterbank of the waveform (the counterparts of the reference's registry
names, backbones/__init__.py).

The public interface keeps the reference's packed-real layout: input
(B, Cc, F, T, 2) with complex channel c at real channels [2c, 2c+1], output
(B, D, F, T, 2) from a 1x1 conv whose channels are [re(d)...] + [im(d)...].

`dtype` is the compute dtype (float32 or bfloat16), the reference's `dtype`
field (storm_tpu/backbones/ncsnpp.py:92): parameters stay float32, the
input is cast to it at the pack, the time embedding before its first Dense
(the Fourier features stay float32), sigma before the division, and the
output is cast back to float32, so the STFT, the SDE and the sampler around
the net stay float32.

Deep-feature caching (DeepCache, Ma et al., arXiv:2312.00858; the reference's
`deep_features` / `forward_shallow`): `deep_features` runs the down trunk,
the bottleneck and the up levels >= cache_depth and returns (h, pyramid) at
the entry of up level cache_depth - 1; `forward_shallow` reruns only the
down levels < cache_depth and resumes the up path from that cache, so
forward_shallow(x, t, deep_features(x, t)) == forward(x, t). The cache is
in the compute dtype, as the reference carries it. It splits the default
pyramids and BigGAN resblocks only; any other configuration refuses it with
the reference's message.

Sequence-parallel serving (`ShardedNCSNpp`, the counterpart of the
reference's `spec_sharding_constraint` meshes): the same `_unet` runs on a
frame-sharded activation (nn/seqpar.py), each layer dispatching on it;
`_pack`, `_unpack` and the output conv run per shard, the time embedding on
the group's first device (a per-row tensor each shard takes a copy of).
"""
from __future__ import annotations

import contextlib
import inspect
import math
from typing import Iterator, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..nn import seqpar
from ..nn.cast import cast_params, param, scalar
from ..nn.init import ddpm_init_
from ..nn.layers import (
    AttnBlockpp,
    Combine,
    Dense,
    Downsample,
    GaussianFourierProjection,
    OutputConv,
    ResnetBlockBigGANpp,
    ResnetBlockDDPMpp,
    Upsample,
    conv3x3,
    get_act,
    group_norm,
)
from ..nn.qconv import scales_like
from ..nn.resample import conv_transpose
from ..nn.seqpar import ShardContext, Sharded


DEEPCACHE_REFUSED = "deep-feature caching supports the default NCSN++ config only"


def timestep_embedding(timesteps: torch.Tensor, embedding_dim: int) -> torch.Tensor:
    """Sinusoidal (DDPM) embedding of (B,) times in float32: [sin, cos] of
    t * 10000^(-i / (half - 1)), zero-padded to an odd width (the reference's
    `_timestep_embedding`)."""
    half_dim = embedding_dim // 2
    emb = math.log(10000.0) / (half_dim - 1)
    emb = torch.exp(torch.arange(half_dim, dtype=torch.float32, device=timesteps.device) * -emb)
    emb = timesteps[:, None].float() * emb[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    return F.pad(emb, (0, 1)) if embedding_dim % 2 == 1 else emb


class NCSNpp(nn.Module):
    """NCSN++; the defaults are the 27.8M-parameter configuration."""

    # the cache split of `deep_features` / `forward_shallow` applies to the
    # output_skip / input_skip / biggan configuration; the others refuse it
    # when it is asked for (`check_cache_depth`), as the reference does
    SUPPORTS_DEEPCACHE = True
    FORCE_STFT_OUT = False  # a spectrogram net
    SEQ_PARALLEL = True  # shards along the frame axis (`ShardedNCSNpp`)

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
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise NotImplementedError(f"NCSNpp: dtype {dtype} is not ported")
        if progressive not in ("none", "output_skip", "residual"):
            raise ValueError(f"NCSNpp: progressive {progressive!r}")
        if progressive_input not in ("none", "input_skip", "residual"):
            raise ValueError(f"NCSNpp: progressive_input {progressive_input!r}")
        if embedding_type not in ("fourier", "positional"):
            raise ValueError(f"NCSNpp: embedding_type {embedding_type!r}")
        resblock_type = resblock_type.lower()
        if resblock_type not in ("ddpm", "biggan"):
            raise ValueError(f"resblock type {resblock_type} unrecognized.")
        combine = progressive_combine.lower()
        self.dtype = dtype
        self.nf = nf
        self.resblock_type = resblock_type
        self.progressive, self.progressive_input = progressive, progressive_input
        self.embedding_type = embedding_type
        self.skip_rescale = skip_rescale

        # the discriminative variant is unconditional, unscaled, 2 channels
        self.conditional = False if discriminative else conditional
        self.scale_by_sigma = False if discriminative else scale_by_sigma
        self.total_channels = self._input_channels(input_channels, discriminative) \
            * spatial_channels
        self.spatial_channels = spatial_channels
        self.num_res_blocks = num_res_blocks
        self.num_resolutions = len(ch_mult)
        self.all_resolutions = [image_size // (2**i) for i in range(self.num_resolutions)]
        self.attn_resolutions = tuple(attn_resolutions)
        self.centered = centered
        self.act = act = get_act(nonlinearity)
        temb_dim = nf * 4 if self.conditional else None

        def ResBlock(in_ch, out_ch=None, **kw):
            common = dict(act=act, in_ch=in_ch, out_ch=out_ch, temb_dim=temb_dim,
                          dropout=dropout, skip_rescale=skip_rescale, init_scale=init_scale)
            if resblock_type == "ddpm":
                return ResnetBlockDDPMpp(**common)
            return ResnetBlockBigGANpp(fir=fir, fir_kernel=fir_kernel, **common, **kw)

        def Attn(ch):
            return AttnBlockpp(ch, skip_rescale=skip_rescale, init_scale=init_scale)

        def Resample(cls, in_ch, out_ch=None, with_conv=True):
            return cls(in_ch, out_ch, with_conv=with_conv, fir=fir, fir_kernel=fir_kernel)

        # the pyramids' resamplers without a conv hold no parameters
        if progressive == "output_skip":
            self.pyramid_upsample = Upsample(fir=fir, fir_kernel=fir_kernel)
        if progressive_input == "input_skip":
            self.pyramid_downsample = Downsample(fir=fir, fir_kernel=fir_kernel)

        modules = []
        if embedding_type == "fourier":
            modules.append(GaussianFourierProjection(embedding_size=nf, scale=fourier_scale))
        if self.conditional:
            embed_dim = 2 * nf if embedding_type == "fourier" else nf
            modules += [Dense(embed_dim, nf * 4), Dense(nf * 4, nf * 4)]

        # --- downsampling trunk
        modules.append(conv3x3(self.total_channels, nf))
        hs_c = [nf]
        input_pyramid_ch = self.total_channels
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
                if resblock_type == "ddpm":
                    modules.append(Resample(Downsample, in_ch, with_conv=resamp_with_conv))
                else:
                    modules.append(ResBlock(in_ch, down=True))
                if progressive_input == "input_skip":
                    modules.append(Combine(input_pyramid_ch, in_ch, method=combine))
                    if combine == "cat":
                        in_ch *= 2
                elif progressive_input == "residual":
                    modules.append(Resample(Downsample, input_pyramid_ch, in_ch))
                    input_pyramid_ch = in_ch
                hs_c.append(in_ch)

        # --- bottleneck
        in_ch = hs_c[-1]
        modules += [ResBlock(in_ch), Attn(in_ch), ResBlock(in_ch)]

        # --- upsampling trunk; the module index at the start of each up level
        # is where `forward_shallow` resumes
        self._up_start_idx = [0] * self.num_resolutions
        pyramid_ch = 0
        for i_level in reversed(range(self.num_resolutions)):
            self._up_start_idx[i_level] = len(modules)
            for _ in range(num_res_blocks + 1):
                out_ch = nf * ch_mult[i_level]
                modules.append(ResBlock(in_ch + hs_c.pop(), out_ch))
                in_ch = out_ch
            if self.all_resolutions[i_level] in self.attn_resolutions:
                modules.append(Attn(in_ch))
            if progressive != "none":
                if i_level == self.num_resolutions - 1:
                    modules.append(group_norm(in_ch))
                    if progressive == "output_skip":
                        modules.append(conv3x3(in_ch, self.total_channels,
                                               init_scale=init_scale))
                        pyramid_ch = self.total_channels
                    else:
                        modules.append(conv3x3(in_ch, in_ch))
                        pyramid_ch = in_ch
                elif progressive == "output_skip":
                    modules.append(group_norm(in_ch))
                    modules.append(conv3x3(in_ch, self.total_channels, init_scale=init_scale))
                    pyramid_ch = self.total_channels
                else:  # residual
                    modules.append(Resample(Upsample, pyramid_ch, in_ch))
                    pyramid_ch = in_ch
            if i_level != 0:
                if resblock_type == "ddpm":
                    modules.append(Resample(Upsample, in_ch, with_conv=resamp_with_conv))
                else:
                    modules.append(ResBlock(in_ch, up=True))
        assert not hs_c
        if progressive != "output_skip":
            modules.append(group_norm(in_ch))
            modules.append(conv3x3(in_ch, self.total_channels, init_scale=init_scale))

        self.all_modules = nn.ModuleList(modules)
        self._make_output_layer()

    @staticmethod
    def _input_channels(input_channels: int, discriminative: bool) -> int:
        """Real input channels per spatial channel: 2 for the denoiser."""
        return 2 if discriminative else input_channels

    def _make_output_layer(self) -> None:
        # the 1x1 conv to 2 x spatial_channels real output channels
        self.output_layer = OutputConv(self.total_channels, 2 * self.spatial_channels)

    @classmethod
    def from_kwargs(cls, **kwargs) -> "NCSNpp":
        """Construct, ignoring keyword arguments that are not fields (the
        subclasses' defaults stand for what is not given)."""
        names = set()
        for c in cls.__mro__:
            if "__init__" in vars(c):
                names |= set(inspect.signature(c.__init__).parameters) - {"self", "kwargs"}
        return cls(**{k: v for k, v in kwargs.items() if k in names})

    def _pack(self, x: torch.Tensor) -> torch.Tensor:
        """(B, Cc, F, T, 2) packed-real -> (B, 2 Cc, F, T) in the compute dtype."""
        B, Cc, Fdim, Tdim, _ = x.shape
        if 2 * Cc != self.total_channels:
            raise ValueError(f"got {Cc} complex channels, expected {self.total_channels // 2}")
        # contiguous: for Cc=1 the reshape is a strided view, which upfirdn2d refuses
        h_in = x.permute(0, 1, 4, 2, 3).reshape(B, 2 * Cc, Fdim, Tdim)
        return h_in.to(self.dtype).contiguous()

    def _unpack(self, h: torch.Tensor, x_shape) -> torch.Tensor:
        """The trunk's output -> (B, D, F, T, 2) float32 through the 1x1 output conv."""
        B, _, Fdim, Tdim, _ = x_shape
        h = self.output_layer(h).float()  # (B, 2D, F, T): [re(d)...] + [im(d)...]
        D = self.spatial_channels
        return h.reshape(B, 2, D, Fdim, Tdim).permute(0, 2, 3, 4, 1)

    def forward(self, x: torch.Tensor, time_cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, Cc, F, T, 2) packed-real -> (B, spatial_channels, F, T, 2)."""
        return self._unpack(self._unet(self._pack(x), time_cond), x.shape)

    def deep_features(self, x: torch.Tensor, time_cond: Optional[torch.Tensor] = None,
                      cache_depth: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
        """Down trunk, bottleneck and up levels >= cache_depth: the (h, pyramid)
        cache that `forward_shallow` resumes from."""
        return self._unet(self._pack(x), time_cond, cache_depth=cache_depth, return_cache=True)

    def forward_shallow(self, x: torch.Tensor, time_cond: Optional[torch.Tensor],
                        cache: Tuple[torch.Tensor, torch.Tensor],
                        cache_depth: int = 1) -> torch.Tensor:
        """`forward` with the top `cache_depth` levels recomputed and the rest
        taken from a `deep_features` cache (made at the same cache_depth)."""
        h = self._unet(self._pack(x), time_cond, cache=cache, cache_depth=cache_depth)
        return self._unpack(h, x.shape)

    def check_cache_depth(self, cache_depth: int) -> None:
        """Raise ValueError unless 1 <= cache_depth < the number of levels and
        the net is in the configuration the cache splits."""
        if not 1 <= cache_depth < self.num_resolutions:
            raise ValueError(f"cache_depth must be in [1, {self.num_resolutions - 1}], "
                             f"got {cache_depth}")
        if (self.progressive, self.progressive_input, self.resblock_type) != (
                "output_skip", "input_skip", "biggan"):
            raise ValueError(DEEPCACHE_REFUSED)

    def _unet(self, h_in: torch.Tensor, time_cond: Optional[torch.Tensor],
              cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None, cache_depth: int = 0,
              return_cache: bool = False):
        """The trunk on (B, total_channels, F, T), scale_by_sigma included,
        up to the output conv. `return_cache` stops at the entry of up level
        cache_depth - 1 and returns (h, pyramid); with `cache` it runs the
        down levels < cache_depth only and resumes the up path there."""
        modules = self.all_modules
        act = self.act
        m_idx = 0
        shallow = cache is not None
        if shallow or return_cache:
            self.check_cache_depth(cache_depth)
        sqrt2 = scalar(math.sqrt(2.0), self.dtype)

        if self.embedding_type == "fourier":
            # Fourier features of log(t); computed (and unused) when unconditional
            temb = modules[m_idx](torch.log(time_cond)) if time_cond is not None else None
            m_idx += 1
        else:
            temb = timestep_embedding(time_cond, self.nf) if time_cond is not None else None
        if self.conditional:
            temb = modules[m_idx](temb.to(self.dtype))
            m_idx += 1
            temb = modules[m_idx](act(temb))
            m_idx += 1
        else:
            temb = None

        if not self.centered:
            h_in = 2.0 * h_in - 1.0

        # --- downsampling
        input_pyramid = h_in if self.progressive_input != "none" else None
        hs = [modules[m_idx](h_in)]
        m_idx += 1
        for i_level in range(cache_depth if shallow else self.num_resolutions):
            for _ in range(self.num_res_blocks):
                h = modules[m_idx](hs[-1], temb)
                m_idx += 1
                if self.all_resolutions[i_level] in self.attn_resolutions:
                    h = modules[m_idx](h)
                    m_idx += 1
                hs.append(h)
            # in shallow mode the last level's downsampled h would feed a
            # skipped up level: it is not computed
            if i_level != self.num_resolutions - 1 and not (shallow and i_level == cache_depth - 1):
                if self.resblock_type == "ddpm":
                    h = modules[m_idx](hs[-1])
                else:
                    h = modules[m_idx](hs[-1], temb)
                m_idx += 1
                if self.progressive_input == "input_skip":
                    input_pyramid = self.pyramid_downsample(input_pyramid)
                    h = modules[m_idx](input_pyramid, h)
                    m_idx += 1
                elif self.progressive_input == "residual":
                    input_pyramid = modules[m_idx](input_pyramid)
                    m_idx += 1
                    input_pyramid = ((input_pyramid + h) / sqrt2 if self.skip_rescale
                                     else input_pyramid + h)
                    h = input_pyramid
                hs.append(h)

        if shallow:
            h, pyramid = (c.to(self.dtype) for c in cache)
            m_idx = self._up_start_idx[cache_depth - 1]
            up_levels = range(cache_depth - 1, -1, -1)
        else:
            # --- bottleneck
            h = modules[m_idx](hs[-1], temb)
            h = modules[m_idx + 1](h)
            h = modules[m_idx + 2](h, temb)
            m_idx += 3
            pyramid = None
            up_levels = reversed(range(self.num_resolutions))

        # --- upsampling
        for i_level in up_levels:
            if return_cache and i_level == cache_depth - 1:
                return h, pyramid
            for _ in range(self.num_res_blocks + 1):
                h = modules[m_idx](torch.cat([h, hs.pop()], dim=1), temb)
                m_idx += 1
            if self.all_resolutions[i_level] in self.attn_resolutions:
                h = modules[m_idx](h)
                m_idx += 1
            if self.progressive != "none":
                if i_level == self.num_resolutions - 1:
                    pyramid = modules[m_idx + 1](act(modules[m_idx](h)))
                    m_idx += 2
                elif self.progressive == "output_skip":
                    pyramid_h = modules[m_idx + 1](act(modules[m_idx](h)))
                    m_idx += 2
                    pyramid = self.pyramid_upsample(pyramid) + pyramid_h
                else:  # residual
                    pyramid = modules[m_idx](pyramid)
                    m_idx += 1
                    pyramid = (pyramid + h) / sqrt2 if self.skip_rescale else pyramid + h
                    h = pyramid
            if i_level != 0:
                if self.resblock_type == "ddpm":
                    h = modules[m_idx](h)
                else:
                    h = modules[m_idx](h, temb)
                m_idx += 1
        assert not hs

        if self.progressive == "output_skip":
            h = pyramid
        else:
            h = modules[m_idx + 1](act(modules[m_idx](h)))
            m_idx += 2
        assert m_idx == len(modules)
        if self.scale_by_sigma:
            # divides by t itself, cast to h's dtype, as the reference does
            h = h / time_cond.to(h.dtype)[:, None, None, None]
        return h


class AutoEncodeNCSNpp(NCSNpp):
    """NCSN++ on a learned filterbank of the waveform (the reference's
    `ae-ncsnpp`, storm_tpu/backbones/ncsnpp.py:630-700): a Conv1d encoder
    (512 taps, stride 128, pad 256, no bias) to `image_size` channels, read
    as a 1-channel image of image_size x frames padded to 64 frames, the
    trunk (total_channels 1, no output conv), and a ConvTranspose1d decoder
    back to the waveform, cropped to the input's length. A time-domain
    backbone (`FORCE_STFT_OUT`). `encoder_w` is a conv1d weight (image_size,
    1, 512); `decoder_w` a conv_transpose1d weight (image_size, 1, 512), the
    reference's taps flipped (it writes the decoder as an lhs-dilated
    correlation with pad 255; convert.py flips them)."""

    SUPPORTS_DEEPCACHE = False  # the filterbank around the trunk is not split
    FORCE_STFT_OUT = True
    SEQ_PARALLEL = False  # a time-domain net runs whole

    def __init__(self, input_channels: int = 1, discriminative: bool = True, **kwargs):
        super().__init__(input_channels=input_channels, discriminative=discriminative, **kwargs)
        C = self.all_resolutions[0]  # image_size
        self.encoder_w = nn.Parameter(torch.empty(C, 1, 512))
        self.decoder_w = nn.Parameter(torch.empty(C, 1, 512))
        self.init_from(None)

    CAST_PARAMS = ("encoder_w", "decoder_w")

    @staticmethod
    def _input_channels(input_channels: int, discriminative: bool) -> int:
        return 1 if discriminative else input_channels

    def _make_output_layer(self) -> None:
        pass  # the decoder takes the trunk's image: no 1x1 output conv

    def init_from(self, generator=None):
        # flax's fan_avg of a (512, 1, C) / (512, C, 1) kernel: 512 x (1 + C) / 2
        C = self.encoder_w.shape[0]
        for w in (self.encoder_w, self.decoder_w):
            ddpm_init_(w, 512, 512 * C, 1.0, generator)

    def forward(self, x_time: torch.Tensor,
                time_cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Waveforms (B, T) or (B, 1, T) -> the same shape, float32."""
        squeeze = x_time.dim() == 2
        if not squeeze:
            if x_time.shape[1] != 1:
                raise ValueError("ae-ncsnpp assumes D=1")
            x_time = x_time[:, 0]
        T_orig = x_time.shape[-1]
        h = x_time[:, None, :].to(self.dtype)  # (B, 1, T)
        enc = F.conv1d(h, param(self, "encoder_w", h.dtype), stride=128, padding=256)
        img = enc[:, None]  # (B, 1, C, L): one channel, image_size x frames
        img = F.pad(img, (0, (-img.shape[-1]) % 64)).contiguous()
        h = self._unet(img, time_cond)[:, 0]  # (B, C, Lpad)
        out = conv_transpose(h, param(self, "decoder_w", h.dtype), stride=128, padding=256)
        out = out[:, 0, :T_orig].float()
        return out if squeeze else out[:, None, :]


class NCSNppLarge(NCSNpp):
    """~65M parameters (the reference's `ncsnpplarge`)."""

    def __init__(self, nf: int = 128, ch_mult: Sequence[int] = (1, 1, 2, 2, 2, 2, 2),
                 num_res_blocks: int = 2, attn_resolutions: Sequence[int] = (16,), **kwargs):
        super().__init__(nf=nf, ch_mult=ch_mult, num_res_blocks=num_res_blocks,
                         attn_resolutions=attn_resolutions, **kwargs)


class NCSNpp12M(NCSNpp):
    """~12M parameters (the reference's `ncsnpp12M`)."""

    def __init__(self, nf: int = 96, ch_mult: Sequence[int] = (1, 2, 2, 1),
                 num_res_blocks: int = 1, attn_resolutions: Sequence[int] = (0,), **kwargs):
        super().__init__(nf=nf, ch_mult=ch_mult, num_res_blocks=num_res_blocks,
                         attn_resolutions=attn_resolutions, **kwargs)


class NCSNpp6M(NCSNpp):
    """~6M parameters (the reference's `ncsnpp6M`)."""

    def __init__(self, nf: int = 96, ch_mult: Sequence[int] = (1, 1, 1, 1),
                 num_res_blocks: int = 1, attn_resolutions: Sequence[int] = (0,), **kwargs):
        super().__init__(nf=nf, ch_mult=ch_mult, num_res_blocks=num_res_blocks,
                         attn_resolutions=attn_resolutions, **kwargs)


class ShardedNCSNpp(nn.Module):
    """An NCSN++ spectrogram net with its activations split along the frame
    axis over `devices` (k of them; a device may repeat), with the net's call
    signatures: `forward`, `deep_features` (its cache stays sharded) and
    `forward_shallow`. Each call cuts its input (B, Cc, F, T, 2) along T at
    its `seqpar.FramePlan` (parts may be empty at the deep levels, and at the
    top where T < k), runs `_unet` on the shards and gathers the output
    (B, D, F, T, 2) on the first device, the net's. `nets[i]` is the net
    part i runs: the net itself on its own device, else a replica there
    (`serving` keeps the replicas' weights, casts and int8 scales the net's)."""

    SUPPORTS_DEEPCACHE = True
    FORCE_STFT_OUT = False

    def __init__(self, net: NCSNpp, devices: Sequence, nets: Optional[Sequence[nn.Module]] = None):
        super().__init__()
        self.net = net
        self.devices = [torch.device(d) for d in devices]
        home = next(net.parameters()).device
        if nets is None:
            copies = {}
            nets = [net if d == home else copies.setdefault(d, seqpar.replica(net, d))
                    for d in self.devices]
        self._nets = list(nets)  # not submodules: the net's own state_dict stays its own
        self.ctx = ShardContext(self.devices, net, self._nets)

    @property
    def dtype(self) -> torch.dtype:
        return self.net.dtype

    @property
    def spatial_channels(self) -> int:
        return self.net.spatial_channels

    def replicas(self) -> List[nn.Module]:
        """The distinct replicas (not the net itself)."""
        seen = {id(self.net)}
        return [r for r in self._nets if id(r) not in seen and not seen.add(id(r))]

    def check_cache_depth(self, cache_depth: int) -> None:
        self.net.check_cache_depth(cache_depth)

    def _scatter(self, x: torch.Tensor) -> Sharded:
        """x cut along T at the call's plan: every level's boundaries, which
        the skip connections, the pyramids and a deep-feature cache share,
        as each level is named by its frame count."""
        plan = seqpar.FramePlan.of(x.shape[-2], self.net.num_resolutions, len(self.devices))
        parts = seqpar.scatter(x, plan.widths(x.shape[-2]), self.devices, dim=-2)
        return Sharded([self.net._pack(p) for p in parts], self.ctx, plan)

    def _gather(self, h: Sharded, x_shape) -> torch.Tensor:
        B, Cc, Fdim, _, two = x_shape
        outs = [self._nets[i]._unpack(p, (B, Cc, Fdim, p.shape[-1], two)) if p.shape[-1]
                else p.new_empty((B, self.spatial_channels, Fdim, 0, two), dtype=torch.float32)
                for i, p in enumerate(h.parts)]
        return seqpar.gather(outs, self.devices[0], dim=-2)

    def forward(self, x: torch.Tensor, time_cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self._gather(self.net._unet(self._scatter(x), time_cond), x.shape)

    def deep_features(self, x: torch.Tensor, time_cond: Optional[torch.Tensor] = None,
                      cache_depth: int = 1) -> Tuple[Sharded, Sharded]:
        return self.net._unet(self._scatter(x), time_cond, cache_depth=cache_depth,
                              return_cache=True)

    def forward_shallow(self, x: torch.Tensor, time_cond: Optional[torch.Tensor],
                        cache: Tuple[Sharded, Sharded], cache_depth: int = 1) -> torch.Tensor:
        h = self.net._unet(self._scatter(x), time_cond, cache=cache, cache_depth=cache_depth)
        return self._gather(h, x.shape)

    @classmethod
    @contextlib.contextmanager
    def serving(cls, net: NCSNpp, devices: Sequence[str]) -> Iterator["ShardedNCSNpp"]:
        """The net sharded over `devices` for one inference call: made once
        per net and device group (kept on the net), its replicas given the
        net's weights as they are now, its casts (`cast_params`) and the int8
        scales attached to it, for the block."""
        made = net.__dict__.setdefault("_seq_parallel", {})
        key = tuple(str(d) for d in devices)
        sharded = made.get(key)
        if sharded is None:
            sharded = made[key] = cls(net, devices)
        with contextlib.ExitStack() as stack:
            for r in sharded.replicas():
                seqpar.copy_weights_(r, net)
                stack.enter_context(cast_params(r, net.dtype))
                stack.enter_context(scales_like(r, net))
            yield sharded


def count_parameters(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
