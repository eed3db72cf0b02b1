"""AutoencoderKL (VAE) in PyTorch: image <-> latent codec.

Port of the JAX package's ``models/vae.py``: ``Encoder`` (with
:func:`encode`, which returns the latent moments) and ``Decoder``. The
decoder runs in f32 under every policy (``VAEConfig.force_decoder_f32``:
bf16 decode shows banding); the encoder runs in the policy's compute dtype
with f32 norm statistics. The encoder's stride-2 downsamples pad one row and
one column at the bottom and right only (Flax's ``((0, 1), (0, 1))``), which
``Conv2d(padding=...)`` cannot express: they pad explicitly and convolve
unpadded. The single-head mid attention over h*w tokens went through XLA in
the JAX package, not a Pallas kernel, so here it goes through
``scaled_dot_product_attention`` on the backends of ``reproducible_sdpa``.
Public layout NHWC, like the JAX package.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from stable_diffusion_webui_distributed_tpu_torch.models.configs import (
    VAEConfig,
)
from stable_diffusion_webui_distributed_tpu_torch.models.unet import (
    Conv,
    Dense,
    GroupNorm32,
    from_tokens,
    reproducible_sdpa,
    to_tokens,
    upsample_nearest,
)


class VAEResBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm1 = GroupNorm32(in_channels)
        self.conv1 = Conv(in_channels, out_channels, 3, padding=1)
        self.norm2 = GroupNorm32(out_channels)
        self.conv2 = Conv(out_channels, out_channels, 3, padding=1)
        self.skip = (Conv(in_channels, out_channels, 1)
                     if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.skip is not None:
            x = self.skip(x)
        return x + h


class VAEAttention(nn.Module):
    """Single-head spatial self-attention (the mid-block attn)."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = GroupNorm32(channels)
        self.qkv = Dense(channels, 3 * channels)
        self.out_proj = Dense(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, C, H, W = x.shape
        q, k, v = (t[:, None] for t in
                   self.qkv(to_tokens(self.norm(x))).split(C, dim=-1))
        with reproducible_sdpa():
            out = F.scaled_dot_product_attention(q, k, v,
                                                 scale=1.0 / math.sqrt(C))
        return x + from_tokens(self.out_proj(out[:, 0]), H, W)


class Decoder(nn.Module):
    """``forward(latents (B,h,w,C) NHWC, already un-scaled)`` -> images
    ``(B,H,W,3)`` f32 in [-1, 1]."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        lat = cfg.latent_channels
        levels = cfg.block_out_channels
        cur = levels[-1]
        self.post_quant_conv = Conv(lat, lat, 1)
        self.conv_in = Conv(lat, cur, 3, padding=1)
        self.mid_res_0 = VAEResBlock(cur, cur)
        self.mid_attn = VAEAttention(cur)
        self.mid_res_1 = VAEResBlock(cur, cur)
        for idx, level in enumerate(reversed(range(len(levels)))):
            ch = levels[level]
            for i in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{level}_res_{i}", VAEResBlock(cur, ch))
                cur = ch
            if idx < len(levels) - 1:
                self.add_module(f"up_{level}_us",
                                Conv(ch, ch, 3, padding=1))
        self.norm_out = GroupNorm32(cur)
        self.conv_out = Conv(cur, cfg.in_channels, 3, padding=1)

    def forward(self, latents: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        x = self.post_quant_conv(latents.permute(0, 3, 1, 2))
        x = self.conv_in(x)
        x = self.mid_res_1(self.mid_attn(self.mid_res_0(x)))
        levels = c.block_out_channels
        for idx, level in enumerate(reversed(range(len(levels)))):
            for i in range(c.layers_per_block + 1):
                x = getattr(self, f"up_{level}_res_{i}")(x)
            if idx < len(levels) - 1:
                x = getattr(self, f"up_{level}_us")(upsample_nearest(x))
        x = self.conv_out(F.silu(self.norm_out(x)))
        return x.float().permute(0, 2, 3, 1)


class AsymmetricDownsample(Conv):
    """3x3 stride-2 convolution after padding one row at the bottom and one
    column at the right (Flax ``padding=((0, 1), (0, 1))``)."""

    def __init__(self, channels: int):
        super().__init__(channels, channels, 3, stride=2, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(F.pad(x, (0, 1, 0, 1)))


class Encoder(nn.Module):
    """``forward(images (B,H,W,3) NHWC in [-1, 1])`` -> the latent moments
    ``(B,h,w,2C)`` (mean, logvar) in the compute dtype."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        levels = cfg.block_out_channels
        cur = levels[0]
        self.conv_in = Conv(cfg.in_channels, cur, 3, padding=1)
        for level, ch in enumerate(levels):
            for i in range(cfg.layers_per_block):
                self.add_module(f"down_{level}_res_{i}", VAEResBlock(cur, ch))
                cur = ch
            if level < len(levels) - 1:
                self.add_module(f"down_{level}_ds", AsymmetricDownsample(ch))
        self.mid_res_0 = VAEResBlock(cur, cur)
        self.mid_attn = VAEAttention(cur)
        self.mid_res_1 = VAEResBlock(cur, cur)
        self.norm_out = GroupNorm32(cur)
        moments = 2 * cfg.latent_channels
        self.conv_out = Conv(cur, moments, 3, padding=1)
        self.quant_conv = Conv(moments, moments, 1)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        x = self.conv_in(images.permute(0, 3, 1, 2))
        levels = c.block_out_channels
        for level in range(len(levels)):
            for i in range(c.layers_per_block):
                x = getattr(self, f"down_{level}_res_{i}")(x)
            if level < len(levels) - 1:
                x = getattr(self, f"down_{level}_ds")(x)
        x = self.mid_res_1(self.mid_attn(self.mid_res_0(x)))
        x = self.conv_out(F.silu(self.norm_out(x)))
        return self.quant_conv(x).permute(0, 2, 3, 1)


def encode(encoder: Encoder, images: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """images (B,H,W,3) in [-1, 1] -> ``(mean, logvar)``, each (B,h,w,C),
    the log-variance clipped to [-30, 20] (the JAX package's
    ``VAE.encode``)."""
    mean, logvar = encoder(images).chunk(2, dim=-1)
    return mean, torch.clamp(logvar, -30.0, 20.0)
