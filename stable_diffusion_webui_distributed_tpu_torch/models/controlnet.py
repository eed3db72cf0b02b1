"""ControlNet: conditioned residuals for the UNet, and the preprocessors.

Port of the JAX package's ``models/controlnet.py``. ``ControlNet`` is a copy
of the UNet's down and mid path, built from the port's own ``ResBlock``,
``SpatialTransformer`` and ``Downsample`` (so its self-attention goes to
kernel K1), with a hint embedder that takes the image-space hint down x8
into latent space and a 1x1 zero convolution on every skip and on the mid
block's output. Its residuals are added to the UNet's skips and mid output
(``UNet.forward(control_residuals=...)``). Submodule and parameter names
mirror the Flax tree so ``bridge.controlnet_flax_to_torch`` maps one onto
the other. Flax initialises the zero convolutions and the hint's
``conv_out`` to zeros; ``bridge.init_seeded_controlnet`` draws them like any
other convolution, so seeded residuals are not zero.
:func:`convert_controlnet` maps an ldm ControlNet checkpoint
(``control_model.*``) onto the same names.

The preprocessors ("modules" in a unit's payload) are numpy, a copy of the
JAX package's: a unit's image goes through them on the host, and they give
the JAX package's arrays exactly (``canny`` is a Sobel-magnitude edge map
with a double threshold and one pass of hysteresis, close to but not
bit-equal with OpenCV's).
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from stable_diffusion_webui_distributed_tpu_torch.models import convert
from stable_diffusion_webui_distributed_tpu_torch.models.configs import (
    UNetConfig,
)
from stable_diffusion_webui_distributed_tpu_torch.models.unet import (
    Conv,
    Dense,
    Downsample,
    ResBlock,
    SpatialTransformer,
    reproducible_sdpa,
    timestep_embedding,
)

log = logging.getLogger(__name__)

#: Channel ladder of the conditioning-hint embedder (ldm input_hint_block).
HINT_CHANNELS = (16, 16, 32, 32, 96, 96, 256)


class HintEmbedder(nn.Module):
    """(B, H, W, 3) image-space hint, NHWC -> (B, ch0, H/8, W/8) NCHW."""

    _STRIDES = {2: 2, 4: 2, 6: 2}  # x8 down in all, at convs 2, 4 and 6

    def __init__(self, out_channels: int):
        super().__init__()
        prev = 3
        for i, ch in enumerate(HINT_CHANNELS):
            self.add_module(f"conv_{i}", Conv(
                prev, ch, 3, stride=self._STRIDES.get(i, 1), padding=1))
            prev = ch
        self.conv_out = Conv(prev, out_channels, 3, padding=1)

    def forward(self, hint: torch.Tensor) -> torch.Tensor:
        x = hint.permute(0, 3, 1, 2)
        for i in range(len(HINT_CHANNELS)):
            x = F.silu(getattr(self, f"conv_{i}")(x))
        return self.conv_out(x)


class ControlNet(nn.Module):
    """``forward(latents (B,h,w,4) NHWC, timesteps (B,), context (B,L,D),
    hint (B,8h,8w,3) NHWC, added_cond (B,P) for an SDXL family)`` -> one
    residual per UNet skip and then the mid residual, each NCHW in the
    compute dtype (the UNet's inner layout, where they are added)."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        ch0 = cfg.block_out_channels[0]
        time_dim = 4 * ch0
        ctx_dim = cfg.cross_attention_dim
        self.time_fc1 = Dense(ch0, time_dim)
        self.time_fc2 = Dense(time_dim, time_dim)
        if cfg.addition_embed_dim:
            self.add_fc1 = Dense(cfg.projection_input_dim, time_dim)
            self.add_fc2 = Dense(time_dim, time_dim)
        # the bare latent (an inpainting family's extra mask and
        # masked-image channels go to the UNet only)
        self.conv_in = Conv(cfg.out_channels, ch0, 3, padding=1)
        self.hint = HintEmbedder(ch0)
        self.zero_conv_0 = Conv(ch0, ch0, 1)
        n = 1
        cur = ch0
        n_levels = len(cfg.block_out_channels)
        for level, (ch, depth) in enumerate(zip(cfg.block_out_channels,
                                                cfg.down_blocks)):
            for i in range(cfg.layers_per_block):
                self.add_module(f"down_{level}_res_{i}",
                                ResBlock(cur, ch, time_dim))
                cur = ch
                if depth is not None:
                    self.add_module(f"down_{level}_attn_{i}",
                                    SpatialTransformer(ch, depth,
                                                       self.heads_for(ch),
                                                       ctx_dim))
                self.add_module(f"zero_conv_{n}", Conv(ch, ch, 1))
                n += 1
            if level < n_levels - 1:
                self.add_module(f"down_{level}_ds", Downsample(ch))
                self.add_module(f"zero_conv_{n}", Conv(ch, ch, 1))
                n += 1
        self.mid_res_0 = ResBlock(cur, cur, time_dim)
        self.mid_attn = (SpatialTransformer(cur, cfg.mid_block_depth,
                                            self.heads_for(cur), ctx_dim)
                         if cfg.mid_block_depth is not None else None)
        self.mid_res_1 = ResBlock(cur, cur, time_dim)
        self.mid_out = Conv(cur, cur, 1)

    def heads_for(self, channels: int) -> int:
        if self.cfg.num_attention_heads is not None:
            return self.cfg.num_attention_heads
        return max(1, channels // 64)

    def forward(self, latents: torch.Tensor, timesteps: torch.Tensor,
                context: torch.Tensor, hint: torch.Tensor,
                added_cond: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, ...]:
        if (added_cond is None) != (not self.cfg.addition_embed_dim):
            raise ValueError("added_cond is required by an SDXL family and "
                             "only by one")
        with reproducible_sdpa():
            return self._forward(latents, timesteps, context, hint,
                                 added_cond)

    def _forward(self, latents, timesteps, context, hint, added_cond):
        c = self.cfg
        dtype = self.conv_in.weight.dtype
        temb = self.time_fc1(
            timestep_embedding(timesteps, c.block_out_channels[0]).to(dtype))
        temb = self.time_fc2(F.silu(temb))
        if added_cond is not None:
            a = self.add_fc1(added_cond.to(dtype))
            temb = temb + self.add_fc2(F.silu(a))
        context = context.to(dtype)
        x = self.conv_in(latents.permute(0, 3, 1, 2))
        x = x + self.hint(hint)

        residuals: List[torch.Tensor] = [self.zero_conv_0(x)]
        n = 1
        n_levels = len(c.block_out_channels)
        for level, depth in enumerate(c.down_blocks):
            for i in range(c.layers_per_block):
                x = getattr(self, f"down_{level}_res_{i}")(x, temb)
                if depth is not None:
                    x = getattr(self, f"down_{level}_attn_{i}")(x, context)
                residuals.append(getattr(self, f"zero_conv_{n}")(x))
                n += 1
            if level < n_levels - 1:
                x = getattr(self, f"down_{level}_ds")(x)
                residuals.append(getattr(self, f"zero_conv_{n}")(x))
                n += 1
        x = self.mid_res_0(x, temb)
        if self.mid_attn is not None:
            x = self.mid_attn(x, context)
        x = self.mid_res_1(x, temb)
        residuals.append(self.mid_out(x))
        return tuple(residuals)


# --------------------------------------------------------------------------
# ldm checkpoint conversion (control_model.* layout)
# --------------------------------------------------------------------------

def convert_controlnet(sd, cfg: UNetConfig, prefix: str = "control_model"
                       ) -> Dict[str, torch.Tensor]:
    """An ldm ControlNet checkpoint (a mapping of tensors) -> the state
    dict of :class:`ControlNet` for a UNet of ``cfg``: the hint block,
    ``zero_convs``, ``middle_block_out`` and, for SDXL, ``label_emb``. A
    key the layout needs that the checkpoint lacks raises
    ``convert.MissingKeys``."""
    p = convert._Puller(sd)
    out: Dict = {
        "time_fc1": convert._linear(p, f"{prefix}.time_embed.0"),
        "time_fc2": convert._linear(p, f"{prefix}.time_embed.2"),
        "conv_in": convert._conv(p, f"{prefix}.input_blocks.0.0"),
        "mid_out": convert._conv(p, f"{prefix}.middle_block_out.0"),
    }
    if cfg.addition_embed_dim:
        out["add_fc1"] = convert._linear(p, f"{prefix}.label_emb.0.0")
        out["add_fc2"] = convert._linear(p, f"{prefix}.label_emb.0.2")

    hint: Dict = {}
    for i in range(len(HINT_CHANNELS)):
        hint[f"conv_{i}"] = convert._conv(
            p, f"{prefix}.input_hint_block.{2 * i}")
    hint["conv_out"] = convert._conv(
        p, f"{prefix}.input_hint_block.{2 * len(HINT_CHANNELS)}")
    out["hint"] = hint

    levels = list(zip(cfg.block_out_channels, cfg.down_blocks))
    out["zero_conv_0"] = convert._conv(p, f"{prefix}.zero_convs.0.0")
    n = 1
    prev = cfg.block_out_channels[0]
    for level, (ch, depth) in enumerate(levels):
        for i in range(cfg.layers_per_block):
            key = f"{prefix}.input_blocks.{n}"
            out[f"down_{level}_res_{i}"] = convert._res_block(
                p, f"{key}.0", has_skip=prev != ch)
            if depth is not None:
                out[f"down_{level}_attn_{i}"] = convert._transformer(
                    p, f"{key}.1", depth)
            out[f"zero_conv_{n}"] = convert._conv(
                p, f"{prefix}.zero_convs.{n}.0")
            prev = ch
            n += 1
        if level < len(levels) - 1:
            out[f"down_{level}_ds"] = {"conv": convert._conv(
                p, f"{prefix}.input_blocks.{n}.0.op")}
            out[f"zero_conv_{n}"] = convert._conv(
                p, f"{prefix}.zero_convs.{n}.0")
            n += 1

    out["mid_res_0"] = convert._res_block(p, f"{prefix}.middle_block.0",
                                          False)
    idx = 1
    if cfg.mid_block_depth is not None:
        out["mid_attn"] = convert._transformer(
            p, f"{prefix}.middle_block.1", cfg.mid_block_depth)
        idx = 2
    out["mid_res_1"] = convert._res_block(
        p, f"{prefix}.middle_block.{idx}", False)
    p.finish("controlnet")
    return convert._flatten(out)


# --------------------------------------------------------------------------
# preprocessors ("modules" in the unit payloads)
# --------------------------------------------------------------------------

def preprocess_none(img: np.ndarray) -> np.ndarray:
    """Pass-through: the image already is the control map."""
    return img.astype(np.float32) / 255.0 if img.dtype == np.uint8 else img


def preprocess_canny(img: np.ndarray, low: float = 100.0,
                     high: float = 200.0) -> np.ndarray:
    """Sobel-magnitude edge map with a double threshold (an OpenCV-free
    canny). Thresholds are on the 0-255 gradient scale, as OpenCV's."""
    gray = np.asarray(img, np.float32)
    if gray.ndim == 3:
        gray = gray @ np.array([0.299, 0.587, 0.114], np.float32)
    # 3x3 binomial blur
    k = np.array([1.0, 2.0, 1.0], np.float32) / 4.0
    gray = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, gray)
    gray = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, gray)
    gx = np.zeros_like(gray)
    gy = np.zeros_like(gray)
    gx[:, 1:-1] = gray[:, 2:] - gray[:, :-2]
    gy[1:-1, :] = gray[2:, :] - gray[:-2, :]
    # x2: the central difference is half the Sobel response OpenCV's
    # thresholds are calibrated against (the [1,2,1] smoothing is applied)
    mag = 2.0 * np.sqrt(gx**2 + gy**2)
    strong = mag >= high
    weak = (mag >= low) & ~strong
    # a weak pixel survives if any 8-neighbour is strong (one pass)
    pad = np.pad(strong, 1)
    neighbour = np.zeros_like(strong)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            neighbour |= pad[1 + dy: pad.shape[0] - 1 + dy,
                             1 + dx: pad.shape[1] - 1 + dx]
    edges = strong | (weak & neighbour)
    out = edges.astype(np.float32)
    return np.repeat(out[:, :, None], 3, axis=2)


def preprocess_inpaint(img: np.ndarray,
                       mask: Optional[np.ndarray] = None) -> np.ndarray:
    """ControlNet v1.1's inpaint convention: the hint is the image with the
    masked pixels set to -1.0 (white mask = repaint)."""
    out = preprocess_none(img).copy()
    if mask is not None:
        m = np.asarray(mask)
        if m.dtype == np.uint8 or m.max() > 1.0:
            m = m.astype(np.float32) / 255.0
        else:
            m = m.astype(np.float32)
        if m.ndim == 3:
            m = m[..., 0]
        out[m > 0.5] = -1.0
    return out


def _invert(img: np.ndarray) -> np.ndarray:
    return 1.0 - preprocess_none(img)


PREPROCESSORS = {
    "none": preprocess_none,
    "canny": preprocess_canny,
    "invert": _invert,
}


def run_preprocessor(module: str, img: np.ndarray,
                     mask: Optional[np.ndarray] = None) -> np.ndarray:
    """A webui module name -> its map of ``img``. ``inpaint*`` names take
    the unit's ``mask``; an unknown name passes the image through with a
    warning, as the JAX package does."""
    name = (module or "none").lower()
    if name.startswith("inpaint"):  # inpaint / inpaint_only / +lama
        return preprocess_inpaint(img, mask)
    fn = PREPROCESSORS.get(name)
    if fn is None:
        log.warning("controlnet preprocessor '%s' unavailable; passing the "
                    "image through unprocessed", module)
        fn = preprocess_none
    return fn(img)
