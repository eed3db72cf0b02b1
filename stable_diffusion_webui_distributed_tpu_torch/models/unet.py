"""Denoising UNet (SD 1.x and SDXL families), full forward, in PyTorch.

Port of the JAX package's ``models/unet.py`` for ``cache_mode=None`` without
int8. SDXL's added conditioning (pooled text
and the micro-conditioning time ids, :func:`make_added_cond`) goes through
``add_fc1``/``add_fc2`` onto the timestep embedding; the per-level
transformer depths come from the config (SDXL has none at level 0) and
heads are ``channels // 64`` where the config names no count.
Submodule and parameter names mirror the Flax tree (``down_0_res_0``,
``attn1/qkv`` ...) so ``bridge.flax_to_torch`` maps one onto the other.

The public forward keeps the JAX package's NHWC layout; inside, convs run
NCHW. Flax's conventions carry over: GroupNorm/LayerNorm use eps 1e-6 with
f32 statistics, groups are ``min(32, C)``, GEGLU's gelu is the tanh
approximation, the timestep embedding is ``[cos, sin]`` in f32, the
ResBlock residual add is f32, and 2x nearest upsampling is a plain repeat.

Latent self-attention goes to kernel K1 (``ops/flash_attention.py``);
cross-attention over the 77·n context tokens, which the JAX package left to
XLA, goes to ``scaled_dot_product_attention`` on the backends of
:func:`reproducible_sdpa`.

ControlNet residuals (``control_residuals``, from ``models/controlnet.py``,
NCHW): the last is added to the mid block's output and residual ``i`` to
skip ``i``, each cast to the activation's dtype first.

Traced LoRA (``lora``, ``models/lora.py``): a per-row factor tree along the
module paths (``down_{l}_attn_{i}`` / ``mid_attn`` / ``up_{l}_attn_{i}``,
``block_{i}``, ``attn1``...); each Dense site it names adds its delta to
the projection's output, computed from the projection's input. Without it
the forward runs the same ops as before.

Ragged rows (ragged dispatch): ``forward(..., true_rows, ctx_true)`` takes
``(B,)`` integer device tensors, the valid latent rows of each batch row
(padded at the bottom) and its valid context tokens. Each Downsample halves
the valid rows rounding up, a SpatialTransformer turns rows into a token
prefix of ``min(rows, H) * W``, and both attentions go to kernel K2
(``ops/ragged_attention.py``): self-attention masks keys and queries past
the prefix, cross-attention masks the context past ``ctx_true``. As in the
JAX package, the GroupNorms and convolutions are not masked: their
statistics and 3x3 windows span the padded rows, so a ragged image is not
the image of the same seed at its own size.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import SDPBackend, sdpa_kernel

from stable_diffusion_webui_distributed_tpu_torch.models.configs import (
    UNetConfig,
)
from stable_diffusion_webui_distributed_tpu_torch.models.lora import (
    apply_site,
)
from stable_diffusion_webui_distributed_tpu_torch.ops.flash_attention import (
    flash_attention,
)
from stable_diffusion_webui_distributed_tpu_torch.ops.ragged_attention import (
    ragged_attention,
)

EPS = 1e-6  # Flax's GroupNorm/LayerNorm epsilon (torch defaults to 1e-5)

# The backends ``scaled_dot_product_attention`` may take here. PyTorch's
# default on Hopper for bf16 is cuDNN's fused attention, which gave other
# bits in another process for the same inputs on the same card; these give
# the same bits in every process, so a seed gives the same image on every
# worker.
_SDPA_BACKENDS = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                  SDPBackend.MATH]


def reproducible_sdpa():
    """Context in which ``scaled_dot_product_attention`` takes only
    backends that give the same bits from process to process."""
    return sdpa_kernel(_SDPA_BACKENDS)


class Dense(nn.Linear):
    """``nn.Linear`` that computes in its weight's dtype (Flax ``Dense``
    with ``dtype`` = the policy's compute dtype)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(_cast(x, self.weight.dtype), self.weight, self.bias)


class Conv(nn.Conv2d):
    """``nn.Conv2d`` that computes in its weight's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(_cast(x, self.weight.dtype))


def _cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    # the check costs less than a dispatched no-op ``to``; the UNet makes
    # some 200 such calls per step
    return x if x.dtype == dtype else x.to(dtype)


class LayerNorm32(nn.LayerNorm):
    """Flax ``LayerNorm(dtype=float32)``: f32 statistics AND f32 output.
    Its scale and bias stay f32 whatever the policy stores (see
    :func:`norms_to_f32`)."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps)


class GroupNorm32(nn.Module):
    """GroupNorm over NCHW with f32 statistics, output in the input dtype.
    Its scale and bias stay f32 (see :func:`norms_to_f32`)."""

    def __init__(self, channels: int, num_groups: int = 32):
        super().__init__()
        self.gn = nn.GroupNorm(min(num_groups, channels), channels, eps=EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float(), self.gn.num_groups, self.gn.weight,
                         self.gn.bias, self.gn.eps)
        return _cast(y, x.dtype)


def norms_to_f32(module: nn.Module) -> nn.Module:
    """Hold every norm's scale and bias in f32, after the policy has stored
    them (in bf16 on the card): the values are the stored ones, and the
    norms, which compute in f32, need not cast them on every call."""
    for m in module.modules():
        if isinstance(m, (LayerNorm32, GroupNorm32)):
            m.float()
    return module


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding, (B,) -> (B, dim), ``[cos, sin]``, f32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def upsample_nearest(x: torch.Tensor) -> torch.Tensor:
    """2x nearest upsampling of NCHW (``jax.image.resize(nearest)``)."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def to_tokens(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> (B, H*W, C), row-major like the JAX package's NHWC reshape."""
    return x.permute(0, 2, 3, 1).flatten(1, 2)


def from_tokens(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return x.unflatten(1, (h, w)).permute(0, 3, 1, 2)


class ResBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, time_dim: int):
        super().__init__()
        self.norm1 = GroupNorm32(in_channels)
        self.conv1 = Conv(in_channels, out_channels, 3, padding=1)
        self.time_proj = Dense(time_dim, out_channels)
        self.norm2 = GroupNorm32(out_channels)
        self.conv2 = Conv(out_channels, out_channels, 3, padding=1)
        self.skip = (Conv(in_channels, out_channels, 1)
                     if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.skip is not None:
            x = self.skip(x)
        return (x.float() + h).to(h.dtype)


class Attention(nn.Module):
    """Self-attention (fused QKV, kernel K1) or cross-attention (fused KV,
    SDPA) over flattened spatial tokens. With ``true_len`` (a ``(B,)``
    valid prefix: of the tokens for self-attention, of the context for
    cross-attention) both take kernel K2."""

    def __init__(self, channels: int, num_heads: int,
                 context_dim: Optional[int] = None):
        super().__init__()
        self.num_heads = num_heads
        if context_dim is None:
            self.qkv = Dense(channels, 3 * channels, bias=False)
        else:
            self.q = Dense(channels, channels, bias=False)
            self.kv = Dense(context_dim, 2 * channels, bias=False)
        self.out_proj = Dense(channels, channels)

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor] = None,
                true_len: Optional[torch.Tensor] = None,
                lora: Optional[dict] = None) -> torch.Tensor:
        B, T, C = x.shape
        heads = self.num_heads
        scale = 1.0 / math.sqrt(C // heads)
        if context is None:
            # column slices of the fused projection, read in place by the
            # kernel
            qkv = apply_site(self.qkv(x), x, lora, "qkv")
            q, k, v = (t.unflatten(-1, (heads, C // heads))
                       for t in qkv.split(C, dim=-1))
            if true_len is None:
                out = flash_attention(q, k, v, scale=scale)
            else:
                out = ragged_attention(q, k, v, true_len, scale=scale)
        else:
            q = apply_site(self.q(x), x, lora, "q").unflatten(
                -1, (heads, C // heads))
            kv = apply_site(self.kv(context), context, lora, "kv")
            k, v = (t.unflatten(-1, (heads, C // heads))
                    for t in kv.split(C, dim=-1))
            if true_len is None:
                out = F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    scale=scale).transpose(1, 2)
            else:
                out = ragged_attention(q, k, v, true_len, scale=scale,
                                       mask_queries=False)
        out = out.reshape(B, T, C)
        return apply_site(self.out_proj(out), out, lora, "out_proj")


class GEGLU(nn.Module):
    def __init__(self, dim: int, dim_out: int):
        super().__init__()
        self.proj = Dense(dim, 2 * dim_out)

    def forward(self, x: torch.Tensor,
                lora: Optional[dict] = None) -> torch.Tensor:
        a, g = apply_site(self.proj(x), x, lora, "proj").chunk(2, dim=-1)
        return a * F.gelu(g, approximate="tanh")


class TransformerBlock(nn.Module):
    """self-attn -> cross-attn -> GEGLU MLP, each with pre-LN + residual."""

    def __init__(self, channels: int, num_heads: int, context_dim: int):
        super().__init__()
        self.ln1 = LayerNorm32(channels)
        self.attn1 = Attention(channels, num_heads)
        self.ln2 = LayerNorm32(channels)
        self.attn2 = Attention(channels, num_heads, context_dim)
        self.ln3 = LayerNorm32(channels)
        self.geglu = GEGLU(channels, 4 * channels)
        self.ff_out = Dense(4 * channels, channels)

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                true_len: Optional[torch.Tensor] = None,
                ctx_true: Optional[torch.Tensor] = None,
                lora: Optional[dict] = None) -> torch.Tensor:
        sub = {} if lora is None else lora
        x = x + self.attn1(self.ln1(x), true_len=true_len,
                           lora=sub.get("attn1"))
        x = x + self.attn2(self.ln2(x), context, true_len=ctx_true,
                           lora=sub.get("attn2"))
        g = self.geglu(self.ln3(x), lora=sub.get("geglu"))
        return x + apply_site(self.ff_out(g), g, lora, "ff_out")


class SpatialTransformer(nn.Module):
    """GN -> linear proj-in -> depth x TransformerBlock -> proj-out +
    residual."""

    def __init__(self, channels: int, depth: int, num_heads: int,
                 context_dim: int):
        super().__init__()
        self.depth = depth
        self.norm = GroupNorm32(channels)
        self.proj_in = Dense(channels, channels)
        for i in range(depth):
            self.add_module(f"block_{i}", TransformerBlock(
                channels, num_heads, context_dim))
        self.proj_out = Dense(channels, channels)

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                true_rows: Optional[torch.Tensor] = None,
                ctx_true: Optional[torch.Tensor] = None,
                lora: Optional[dict] = None) -> torch.Tensor:
        _, _, H, W = x.shape
        # row-major flatten: a valid prefix of true_rows rows is a valid
        # prefix of true_rows * W tokens
        true_len = (None if true_rows is None
                    else torch.clamp(true_rows, max=H) * W)
        sub = {} if lora is None else lora
        hn = to_tokens(self.norm(x))
        h = apply_site(self.proj_in(hn), hn, lora, "proj_in")
        for i in range(self.depth):
            h = getattr(self, f"block_{i}")(h, context, true_len, ctx_true,
                                            sub.get(f"block_{i}"))
        return x + from_tokens(
            apply_site(self.proj_out(h), h, lora, "proj_out"), H, W)


class Downsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv(channels, channels, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(upsample_nearest(x))


class UNet(nn.Module):
    """The conditional denoiser: ``forward(latents (B,H,W,Cin) NHWC,
    timesteps (B,) f32, context (B,L,D), added_cond (B,P), true_rows (B,)
    int, ctx_true (B,) int, control_residuals, lora)`` -> predicted noise
    ``(B,H,W,Cout)`` f32. ``added_cond`` is required by an SDXL family and
    refused by any other; the two length vectors are for ragged rows and
    optional; ``control_residuals`` (one per skip, then the mid residual,
    NCHW) are ControlNet's and optional; ``lora`` is a traced adapter
    tree with ``[B, S, ...]`` leaves and optional."""

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
        self.conv_in = Conv(cfg.in_channels, ch0, 3, padding=1)
        n_levels = len(cfg.block_out_channels)
        cur = ch0
        skips = [cur]
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
                skips.append(cur)
            if level < n_levels - 1:
                self.add_module(f"down_{level}_ds", Downsample(ch))
                skips.append(cur)
        self.mid_res_0 = ResBlock(cur, cur, time_dim)
        self.mid_attn = (SpatialTransformer(cur, cfg.mid_block_depth,
                                            self.heads_for(cur), ctx_dim)
                         if cfg.mid_block_depth is not None else None)
        self.mid_res_1 = ResBlock(cur, cur, time_dim)
        for level in reversed(range(n_levels)):
            ch = cfg.block_out_channels[level]
            for i in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{level}_res_{i}",
                                ResBlock(cur + skips.pop(), ch, time_dim))
                cur = ch
                if cfg.down_blocks[level] is not None:
                    self.add_module(f"up_{level}_attn_{i}",
                                    SpatialTransformer(
                                        ch, cfg.down_blocks[level],
                                        self.heads_for(ch), ctx_dim))
            if level > 0:
                self.add_module(f"up_{level}_us", Upsample(ch))
        self.norm_out = GroupNorm32(cur)
        self.conv_out = Conv(cur, cfg.out_channels, 3, padding=1)

    def heads_for(self, channels: int) -> int:
        if self.cfg.num_attention_heads is not None:
            return self.cfg.num_attention_heads
        return max(1, channels // 64)

    def forward(self, latents: torch.Tensor, timesteps: torch.Tensor,
                context: torch.Tensor,
                added_cond: Optional[torch.Tensor] = None,
                true_rows: Optional[torch.Tensor] = None,
                ctx_true: Optional[torch.Tensor] = None,
                control_residuals: Optional[Sequence[torch.Tensor]] = None,
                lora: Optional[dict] = None) -> torch.Tensor:
        if (added_cond is None) != (not self.cfg.addition_embed_dim):
            raise ValueError("added_cond is required by an SDXL family and "
                             "only by one")
        with reproducible_sdpa():
            return self._forward(latents, timesteps, context, added_cond,
                                 true_rows, ctx_true, control_residuals,
                                 {} if lora is None else lora)

    def _forward(self, latents: torch.Tensor, timesteps: torch.Tensor,
                 context: torch.Tensor, added_cond: Optional[torch.Tensor],
                 true_rows: Optional[torch.Tensor],
                 ctx_true: Optional[torch.Tensor],
                 control_residuals: Optional[Sequence[torch.Tensor]],
                 lora: dict) -> torch.Tensor:
        c = self.cfg
        dtype = self.conv_in.weight.dtype
        temb = self.time_fc1(
            timestep_embedding(timesteps, c.block_out_channels[0]).to(dtype))
        temb = self.time_fc2(F.silu(temb))
        if added_cond is not None:
            # SDXL micro-conditioning: pooled text ++ fourier(time ids)
            a = self.add_fc1(added_cond.to(dtype))
            temb = temb + self.add_fc2(F.silu(a))
        context = context.to(dtype)
        x = self.conv_in(latents.permute(0, 3, 1, 2))

        n_levels = len(c.block_out_channels)
        # valid rows per level: each stride-2 Downsample halves them,
        # rounding up, like the spatial size
        rows = [None] * n_levels
        if true_rows is not None:
            rows[0] = true_rows.to(torch.int32)
            for level in range(1, n_levels):
                rows[level] = (rows[level - 1] + 1) // 2
        skips = [x]
        for level, depth in enumerate(c.down_blocks):
            for i in range(c.layers_per_block):
                x = getattr(self, f"down_{level}_res_{i}")(x, temb)
                if depth is not None:
                    x = getattr(self, f"down_{level}_attn_{i}")(
                        x, context, rows[level], ctx_true,
                        lora.get(f"down_{level}_attn_{i}"))
                skips.append(x)
            if level < n_levels - 1:
                x = getattr(self, f"down_{level}_ds")(x)
                skips.append(x)

        x = self.mid_res_0(x, temb)
        if self.mid_attn is not None:
            x = self.mid_attn(x, context, rows[-1], ctx_true,
                              lora.get("mid_attn"))
        x = self.mid_res_1(x, temb)
        if control_residuals is not None:
            x, skips = control_residuals_added(x, skips, control_residuals)

        for level in reversed(range(n_levels)):
            for i in range(c.layers_per_block + 1):
                x = torch.cat([x, skips.pop()], dim=1)
                x = getattr(self, f"up_{level}_res_{i}")(x, temb)
                if c.down_blocks[level] is not None:
                    x = getattr(self, f"up_{level}_attn_{i}")(
                        x, context, rows[level], ctx_true,
                        lora.get(f"up_{level}_attn_{i}"))
            if level > 0:
                x = getattr(self, f"up_{level}_us")(x)

        x = F.silu(self.norm_out(x))
        return self.conv_out(x).float().permute(0, 2, 3, 1)


def control_residuals_added(x: torch.Tensor, skips: list,
                            residuals: Sequence[torch.Tensor]):
    """The mid output and the skips with ControlNet's residuals added: the
    last residual to ``x``, residual ``i`` to skip ``i``, each cast to the
    activation's dtype first."""
    if len(residuals) != len(skips) + 1:
        raise ValueError(f"expected {len(skips) + 1} control residuals, got "
                         f"{len(residuals)}")
    x = x + residuals[-1].to(x.dtype)
    return x, [s + r.to(s.dtype) for s, r in zip(skips, residuals[:-1])]


def make_added_cond(pooled_text: torch.Tensor, time_ids: torch.Tensor,
                    addition_time_embed_dim: int) -> torch.Tensor:
    """SDXL's added conditioning ``(B, P)`` f32: the pooled text ``(B,
    D)`` followed by each of the ``(B, n)`` time ids' sinusoidal
    embedding."""
    b = time_ids.shape[0]
    emb = timestep_embedding(time_ids.reshape(-1), addition_time_embed_dim)
    return torch.cat([pooled_text.float(), emb.reshape(b, -1)], dim=-1)
