"""Denoising UNet (SD 1.x and SDXL families) in PyTorch.

Port of the JAX package's ``models/unet.py``. SDXL's added conditioning
(pooled text and the micro-conditioning time ids, :func:`make_added_cond`)
goes through ``add_fc1``/``add_fc2`` onto the timestep embedding; the
per-level transformer depths come from the config (SDXL has none at level
0) and heads are ``channels // 64`` where the config names no count.
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

Serving precision (``precision``, ``pipeline/precision.py``): a forward
argument threaded down as ``lora`` is, so every precision shares one set
of weights. At ``int8`` the transformer linears (``proj_in``, ``qkv``,
``q``, ``kv``, ``out_proj``, GEGLU's ``proj``, ``ff_out``, ``proj_out``)
run W8A8 (``ops/quant.py``), at ``int8+conv`` also the ResBlock convs and
skips, the Downsamples and the Upsamples; the time and added-conditioning
MLPs, ``conv_in``, ``conv_out`` and the norms stay in the card policy. A
traced LoRA delta is added after the quantized product.

Step cache (``cache_mode``, ``pipeline/stepcache.py``): the levels from
:data:`CACHE_SPLIT` down and the mid block are the deep part. A ``"deep"``
call returns the hidden state after the split level's Upsample, a
``"reuse"`` call runs only the shallow levels from it. On SD1.5 a deep
call makes 13 of the plain call's 16 self-attentions, a reuse call 5.

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
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import SDPBackend, sdpa_kernel

from stable_diffusion_webui_distributed_tpu_torch.models.configs import (
    UNetConfig,
)
from stable_diffusion_webui_distributed_tpu_torch.models.lora import (
    apply_site,
    delta_down,
    delta_up,
    site_factors,
)
from stable_diffusion_webui_distributed_tpu_torch.ops.flash_attention import (
    flash_attention,
)
from stable_diffusion_webui_distributed_tpu_torch.ops.quant import (
    absmax,
    codes,
    dequantize,
    int8_accumulate,
    int8_conv,
    int8_conv_codes,
    int8_dot,
    int8_dot_codes,
    quantize,
    scale_of,
)
from stable_diffusion_webui_distributed_tpu_torch.ops.ragged_attention import (
    ragged_attention,
)
from stable_diffusion_webui_distributed_tpu_torch.ops.ring_attention import (
    ring_attention_over,
)
from stable_diffusion_webui_distributed_tpu_torch.parallel import sharding

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
    with ``dtype`` = the policy's compute dtype). ``quant``: the W8A8
    product of ``ops/quant.py`` from the same weight (JAX ``QuantDense``):
    the input quantized as it comes, the bias added in f32, the output in
    the weight's dtype. ``tp``: its shards on a mesh (:func:`place_layers`)."""

    tp = None

    def forward(self, x: torch.Tensor, quant: bool = False) -> torch.Tensor:
        if self.tp is not None:
            return self.tp(x, quant)
        if quant:
            out = int8_dot(x, self.weight)
            if self.bias is not None:
                out = out + self.bias.float()
            return out.to(self.weight.dtype)
        return F.linear(_cast(x, self.weight.dtype), self.weight, self.bias)


class Conv(nn.Conv2d):
    """``nn.Conv2d`` that computes in its weight's dtype; ``quant`` and
    ``tp`` as for :class:`Dense` (JAX ``QuantConv``)."""

    tp = None

    def forward(self, x: torch.Tensor, quant: bool = False) -> torch.Tensor:
        if self.tp is not None:
            return self.tp(x, quant)
        if quant:
            out = int8_conv(x, self.weight, self.stride, self.padding)
            if self.bias is not None:
                out = out + self.bias.float()[:, None, None]
            return out.to(self.weight.dtype)
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

    def forward(self, x: torch.Tensor, temb: torch.Tensor,
                qc: bool = False) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)), qc)
        h = h + self.time_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)), qc)
        if self.skip is not None:
            x = self.skip(x, qc)
        return (x.float() + h).to(h.dtype)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            self_attention: bool, true_len: Optional[torch.Tensor],
            ring: Optional[Sequence[torch.device]],
            scale: float) -> torch.Tensor:
    """One attention over ``(B, T, H, D)`` heads, in the JAX package's order
    of branches: ragged rows (kernel K2), the ``sp`` ring when the tokens
    divide it, then K1 for self-attention; cross-attention is K2 with a
    context mask, else SDPA."""
    if self_attention:
        if true_len is not None:
            return ragged_attention(q, k, v, true_len, scale=scale)
        if ring is not None and q.shape[1] % len(ring) == 0:
            return ring_attention_over(q, k, v, ring, scale,
                                       getattr(ring, "span", None))
        return flash_attention(q, k, v, scale=scale)
    if true_len is not None:
        return ragged_attention(q, k, v, true_len, scale=scale,
                                mask_queries=False)
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        scale=scale).transpose(1, 2)


class Attention(nn.Module):
    """Self-attention (fused QKV, kernel K1) or cross-attention (fused KV,
    SDPA) over flattened spatial tokens. With ``true_len`` (a ``(B,)``
    valid prefix: of the tokens for self-attention, of the context for
    cross-attention) both take kernel K2. ``ring``: the ``sp`` devices of
    its replica on a mesh; ``tp``: its head shards (:func:`place_layers`)."""

    tp = None
    ring = None

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
                lora: Optional[dict] = None,
                ql: bool = False) -> torch.Tensor:
        if self.tp is not None:
            return self.tp(x, context, true_len, lora, ql)
        B, T, C = x.shape
        heads = self.num_heads
        scale = 1.0 / math.sqrt(C // heads)
        if context is None:
            # column slices of the fused projection, read in place by the
            # kernel
            qkv = apply_site(self.qkv(x, ql), x, lora, "qkv")
            q, k, v = (t.unflatten(-1, (heads, C // heads))
                       for t in qkv.split(C, dim=-1))
        else:
            q = apply_site(self.q(x, ql), x, lora, "q").unflatten(
                -1, (heads, C // heads))
            kv = apply_site(self.kv(context, ql), context, lora, "kv")
            k, v = (t.unflatten(-1, (heads, C // heads))
                    for t in kv.split(C, dim=-1))
        out = _attend(q, k, v, context is None, true_len, self.ring, scale)
        out = out.reshape(B, T, C)
        return apply_site(self.out_proj(out, ql), out, lora, "out_proj")


class GEGLU(nn.Module):
    def __init__(self, dim: int, dim_out: int):
        super().__init__()
        self.proj = Dense(dim, 2 * dim_out)

    def forward(self, x: torch.Tensor, lora: Optional[dict] = None,
                ql: bool = False) -> torch.Tensor:
        a, g = apply_site(self.proj(x, ql), x, lora, "proj").chunk(2, dim=-1)
        return a * F.gelu(g, approximate="tanh")


class TransformerBlock(nn.Module):
    """self-attn -> cross-attn -> GEGLU MLP, each with pre-LN + residual.
    ``ffn_tp``: the GEGLU and ``ff_out`` on their shards
    (:func:`place_layers`)."""

    ffn_tp = None

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
                lora: Optional[dict] = None,
                ql: bool = False) -> torch.Tensor:
        sub = {} if lora is None else lora
        x = x + self.attn1(self.ln1(x), true_len=true_len,
                           lora=sub.get("attn1"), ql=ql)
        x = x + self.attn2(self.ln2(x), context, true_len=ctx_true,
                           lora=sub.get("attn2"), ql=ql)
        if self.ffn_tp is not None:
            return x + self.ffn_tp(self.ln3(x),
                                   (sub.get("geglu") or {}).get("proj"),
                                   sub.get("ff_out"), ql)
        g = self.geglu(self.ln3(x), lora=sub.get("geglu"), ql=ql)
        return x + apply_site(self.ff_out(g, ql), g, lora, "ff_out")


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
                lora: Optional[dict] = None,
                ql: bool = False) -> torch.Tensor:
        _, _, H, W = x.shape
        # row-major flatten: a valid prefix of true_rows rows is a valid
        # prefix of true_rows * W tokens
        true_len = (None if true_rows is None
                    else torch.clamp(true_rows, max=H) * W)
        sub = {} if lora is None else lora
        hn = to_tokens(self.norm(x))
        h = apply_site(self.proj_in(hn, ql), hn, lora, "proj_in")
        for i in range(self.depth):
            h = getattr(self, f"block_{i}")(h, context, true_len, ctx_true,
                                            sub.get(f"block_{i}"), ql)
        return x + from_tokens(
            apply_site(self.proj_out(h, ql), h, lora, "proj_out"), H, W)


class Downsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv(channels, channels, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor, qc: bool = False) -> torch.Tensor:
        return self.conv(x, qc)


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor, qc: bool = False) -> torch.Tensor:
        return self.conv(upsample_nearest(x), qc)


#: The level at which the step cache splits the UNet (JAX
#: ``models/unet.py``): levels below it are shallow (run every step), the
#: levels from it down and the mid block deep (run on refresh steps only,
#: reused in between). Split 1 caches everything below the top level.
CACHE_SPLIT = 1


def cache_supported(cfg: UNetConfig) -> bool:
    """The step cache needs at least one level below the split."""
    return len(cfg.block_out_channels) > CACHE_SPLIT


def deep_cache_shape(cfg: UNetConfig, batch: int, lat_h: int,
                     lat_w: int) -> Tuple[int, int, int, int]:
    """The cached deep feature's NHWC shape: the up path's hidden state
    right after the split level's Upsample (each Downsample halves the
    size rounding up; the Upsample doubles it)."""
    h, w = lat_h, lat_w
    for _ in range(CACHE_SPLIT):
        h, w = (h + 1) // 2, (w + 1) // 2
    return (batch, 2 * h, 2 * w, cfg.block_out_channels[CACHE_SPLIT])


class UNet(nn.Module):
    """The conditional denoiser: ``forward(latents (B,H,W,Cin) NHWC,
    timesteps (B,) f32, context (B,L,D), added_cond (B,P), true_rows (B,)
    int, ctx_true (B,) int, control_residuals, lora)`` -> predicted noise
    ``(B,H,W,Cout)`` f32. ``added_cond`` is required by an SDXL family and
    refused by any other; the two length vectors are for ragged rows and
    optional; ``control_residuals`` (one per skip, then the mid residual,
    NCHW) are ControlNet's and optional; ``lora`` is a traced adapter
    tree with ``[B, S, ...]`` leaves and optional.

    ``precision``: a ``pipeline/precision.py`` spec (None: bf16), whose
    ``quant_linears`` runs the transformer linears and ``quant_convs`` the
    ResBlock, Downsample and Upsample convs as W8A8 products of the same
    weights. ``cache_mode`` (the step cache): ``"deep"`` runs the whole
    down path, the mid block and the up levels from ``CACHE_SPLIT`` down,
    and returns the NHWC hidden state after the split level's Upsample;
    ``"reuse"`` runs the shallow down levels (without their last
    Downsample) and the shallow up levels from ``cache``, that state."""

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
                lora: Optional[dict] = None, precision=None,
                cache: Optional[torch.Tensor] = None,
                cache_mode: Optional[str] = None) -> torch.Tensor:
        if (added_cond is None) != (not self.cfg.addition_embed_dim):
            raise ValueError("added_cond is required by an SDXL family and "
                             "only by one")
        if cache_mode not in (None, "deep", "reuse"):
            raise ValueError(f"unknown cache_mode {cache_mode!r}")
        if cache_mode is not None:
            if not cache_supported(self.cfg):
                raise ValueError("the step cache needs a level below "
                                 "CACHE_SPLIT")
            if true_rows is not None or ctx_true is not None:
                raise ValueError("ragged rows run the plain forward only")
            if control_residuals is not None:
                raise ValueError("ControlNet residuals need the plain "
                                 "forward")
            if (cache is None) != (cache_mode == "deep"):
                raise ValueError("the reuse mode, and only it, takes the "
                                 "cached feature")
        quant = (bool(getattr(precision, "quant_linears", False)),
                 bool(getattr(precision, "quant_convs", False)))
        with reproducible_sdpa():
            return self._forward(latents, timesteps, context, added_cond,
                                 true_rows, ctx_true, control_residuals,
                                 {} if lora is None else lora, quant, cache,
                                 cache_mode)

    def _forward(self, latents: torch.Tensor, timesteps: torch.Tensor,
                 context: torch.Tensor, added_cond: Optional[torch.Tensor],
                 true_rows: Optional[torch.Tensor],
                 ctx_true: Optional[torch.Tensor],
                 control_residuals: Optional[Sequence[torch.Tensor]],
                 lora: dict, quant: Tuple[bool, bool],
                 cache: Optional[torch.Tensor],
                 cache_mode: Optional[str]) -> torch.Tensor:
        c = self.cfg
        ql, qc = quant
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
        split = CACHE_SPLIT
        # the reuse mode runs the shallow levels only, without the last
        # shallow Downsample: its output feeds the split level's down
        # blocks and, as a skip, its up blocks, both in the cached part
        down_levels = split if cache_mode == "reuse" else n_levels
        last_ds = split - 1 if cache_mode == "reuse" else n_levels - 1
        # valid rows per level: each stride-2 Downsample halves them,
        # rounding up, like the spatial size
        rows = [None] * n_levels
        if true_rows is not None:
            rows[0] = true_rows.to(torch.int32)
            for level in range(1, n_levels):
                rows[level] = (rows[level - 1] + 1) // 2
        skips = [x]
        for level in range(down_levels):
            depth = c.down_blocks[level]
            for i in range(c.layers_per_block):
                x = getattr(self, f"down_{level}_res_{i}")(x, temb, qc)
                if depth is not None:
                    x = getattr(self, f"down_{level}_attn_{i}")(
                        x, context, rows[level], ctx_true,
                        lora.get(f"down_{level}_attn_{i}"), ql)
                skips.append(x)
            if level < last_ds:
                x = getattr(self, f"down_{level}_ds")(x, qc)
                skips.append(x)

        if cache_mode != "reuse":
            x = self.mid_res_0(x, temb, qc)
            if self.mid_attn is not None:
                x = self.mid_attn(x, context, rows[-1], ctx_true,
                                  lora.get("mid_attn"), ql)
            x = self.mid_res_1(x, temb, qc)
        if control_residuals is not None:
            x, skips = control_residuals_added(x, skips, control_residuals)

        # the deep mode stops after the split level's Upsample and returns
        # the hidden state there; the reuse mode starts from it
        if cache_mode == "reuse":
            x = cache.permute(0, 3, 1, 2).to(dtype)
            levels = range(split - 1, -1, -1)
        else:
            stop = split if cache_mode == "deep" else 0
            levels = range(n_levels - 1, stop - 1, -1)
        for level in levels:
            for i in range(c.layers_per_block + 1):
                x = torch.cat([x, skips.pop()], dim=1)
                x = getattr(self, f"up_{level}_res_{i}")(x, temb, qc)
                if c.down_blocks[level] is not None:
                    x = getattr(self, f"up_{level}_attn_{i}")(
                        x, context, rows[level], ctx_true,
                        lora.get(f"up_{level}_attn_{i}"), ql)
            if level > 0:
                x = getattr(self, f"up_{level}_us")(x, qc)
        if cache_mode == "deep":
            # NHWC, as the JAX package returns it; the shallow skips are
            # left unconsumed by design
            return x.permute(0, 2, 3, 1)

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


# -- placement on a mesh (runtime/mesh.py, parallel/sharding.py) ------------
#
# Under ``tp`` every product gives the meshless layer's values. At int8 a
# column split quantizes its whole input once on the home device and sends
# the codes: each shard owns whole output channels, hence their weight
# scales. A row split needs a token's scale from its full feature row and a
# channel's from its full weight row: each is the max of the shards'
# maxima, and the shards' int32 accumulators add exactly before one
# dequantize. A traced LoRA site of a column split computes ``h = x @
# down^T`` once and each shard adds ``h @ up_j^T`` for its output rows; at a
# row split each shard multiplies its input columns by ``down``'s, the
# partial ``h`` are summed in f32 on the home device and multiplied by
# ``up`` there (the rank-sized ``h`` crosses the cards, not the input).
#
# Across processes (a replica whose entries span ranks) a placement holds
# and computes only this rank's shards: ``devices[j]`` is None for a shard
# it does not hold, and so are that shard's weights and parts; the layer's
# whole weights are freed (``sharding.Placement.release``). The
# collectives take the replica's ``span`` and fill in the other ranks'
# parts before they sum, max or concatenate in shard order: the int8
# maxima cross the processes before any shard quantizes.


def _to(inp, device: torch.device):
    """A product's input (a tensor, or int8 codes with their scales) on
    ``device``."""
    if isinstance(inp, tuple):
        return tuple(t.to(device, non_blocking=True) for t in inp)
    return inp.to(device, non_blocking=True)


def _one(cuts):
    """Each shard's only cut (:meth:`~..parallel.sharding.Placement.take`
    of one block), None where this process does not hold the shard."""
    return [None if c is None else c[0] for c in cuts]


def _dense(inp, w: torch.Tensor, b: Optional[torch.Tensor],
           dtype: torch.dtype) -> torch.Tensor:
    """A Dense shard's product as the meshless :class:`Dense` computes it:
    ``inp`` is the input in ``dtype`` or its ``(codes, scales)``."""
    if not isinstance(inp, tuple):
        return F.linear(inp, w, b)
    out = int8_dot_codes(inp[0], inp[1], w)
    if b is not None:
        out = out + b.float()
    return out.to(dtype)


def _dense_input(x: torch.Tensor, quant: bool, dtype: torch.dtype):
    """A column split's whole input on the home device: quantized once
    per token at int8, else in the layer's dtype."""
    return quantize(x, -1) if quant else _cast(x, dtype)


def _split_rows(xs, weights, bias: Optional[torch.Tensor],
                home: torch.device, dtype: torch.dtype, quant: bool = False,
                s_x: Optional[torch.Tensor] = None,
                span: Optional[sharding.Span] = None) -> torch.Tensor:
    """A row-parallel product ``sum_j xs[j] @ weights[j]^T`` on the home
    device, the bias added once in f32, in the layer's dtype. ``xs[j]``
    lies on ``weights[j]``'s device (both None for a shard another
    process computes, under ``span``). The bf16 partials are summed in
    f32. At int8 each token's scale is the max of the shards' maxima (or
    ``s_x``, where the caller quantized the whole input and ``xs`` are
    its codes), each output channel's weight scale likewise, and the
    shards' int32 accumulators are summed before one dequantize."""
    if not quant:
        out = sharding.reduce_sum(
            [None if w is None else F.linear(x, w).float()
             for x, w in zip(xs, weights)], home, span)
    else:
        acc, s_x, s_w = _int8_rows(xs, weights, home, s_x, span)
        out = dequantize(acc, s_x, s_w.reshape(-1))
    if bias is not None:
        out = out + bias.float()
    return out.to(dtype)


def _int8_rows(xs, weights, home: torch.device,
               s_x: Optional[torch.Tensor] = None,
               span: Optional[sharding.Span] = None):
    """An int8 row product's ``(acc, s_x, s_w)`` on the home device: the
    shards' int32 accumulators summed, the per-token scales (from the
    max of the shards' maxima unless ``s_x`` is given with ``xs`` its
    codes) and the per-output-channel weight scales (likewise)."""
    if s_x is None:
        s_x = scale_of(sharding.reduce_max(
            [None if x is None else absmax(x, -1) for x in xs], home, span))
        xs = [None if x is None else codes(x, _to(s_x, x.device))
              for x in xs]
    s_w = scale_of(sharding.reduce_max(
        [None if w is None else absmax(w, 1) for w in weights], home, span))
    acc = sharding.reduce_sum(
        [None if w is None else
         int8_accumulate(xq, codes(w, _to(s_w, w.device)))
         for xq, w in zip(xs, weights)], home, span)
    return acc, s_x, s_w


def _column_site(x: torch.Tensor, site: Optional[dict],
                 dtype: torch.dtype):
    """A traced site of a column split: ``(h, up)`` with ``h = x @
    down^T`` computed once on the home device (None without the site)."""
    if site is None:
        return None
    down, up = site_factors(site)
    return delta_down(_cast(x, dtype), down.to(dtype)), up.to(dtype)


def _column_delta(hu, rows: slice, device: torch.device) -> torch.Tensor:
    """A column shard's delta: ``h @ up^T`` over its output ``rows``."""
    h, up = hu
    return delta_up(_to(h, device), _to(up[..., rows, :], device))


def _row_delta(xs, site: dict, home: torch.device, dtype: torch.dtype,
               span: Optional[sharding.Span] = None) -> torch.Tensor:
    """A traced site of a row split, on the home device: each shard's
    ``xs[j] @ down[:, cols_j]^T``, summed in f32, times ``up`` (the
    shards of one width; ``span`` as for :func:`_split_rows`)."""
    down, up = site_factors(site)
    n = next(x for x in xs if x is not None).shape[-1]
    parts = []
    for j, x in enumerate(xs):
        if x is None:
            parts.append(None)
            continue
        cols = _to(down[..., j * n:(j + 1) * n].to(dtype), x.device)
        parts.append(delta_down(_cast(x, dtype), cols).float())
    h = sharding.reduce_sum(parts, home, span).to(dtype)
    return delta_up(h, up.to(dtype))


class _Column(sharding.Placement):
    """A Dense or Conv layer whose output features split over the ``tp``
    devices: each shard computes its slice, gathered on the home
    device."""

    def __init__(self, layer: nn.Module, devices, home: torch.device,
                 span: Optional[sharding.Span] = None):
        n = len(devices)
        self.layer_conv = isinstance(layer, nn.Conv2d)
        self.stride, self.padding = ((layer.stride, layer.padding)
                                     if self.layer_conv else (None, None))
        self.devices, self.home, self.span = devices, home, span
        self.dtype = layer.weight.dtype
        self.weights = _one(self.take(layer.weight, devices, 0))
        self.biases = (_one(self.take(layer.bias, devices, 0))
                       if layer.bias is not None else [None] * n)
        self.release()

    def __call__(self, x: torch.Tensor, quant: bool = False) -> torch.Tensor:
        dtype = self.dtype
        shards = list(zip(self.devices, self.weights, self.biases))
        if not self.layer_conv:
            inp = _dense_input(x, quant, dtype)
            return sharding.gather(
                [None if d is None else _dense(_to(inp, d), w, b, dtype)
                 for d, w, b in shards], -1, self.home, self.span)
        if not quant:
            x = _cast(x, dtype)
            return sharding.gather(
                [None if d is None else
                 F.conv2d(x.to(d, non_blocking=True), w, b, self.stride,
                          self.padding) for d, w, b in shards], 1,
                self.home, self.span)
        # one scale per image over C, H and W of the whole input
        xq, s_x = quantize(x, (1, 2, 3))
        parts = []
        for d, w, b in shards:
            if d is None:
                parts.append(None)
                continue
            out = int8_conv_codes(*_to((xq, s_x), d), w, self.stride,
                                  self.padding)
            if b is not None:
                out = out + b.float()[:, None, None]
            parts.append(out.to(dtype))
        return sharding.gather(parts, 1, self.home, self.span)


class _Row(sharding.Placement):
    """A Dense layer whose input features split over the ``tp`` devices:
    each shard multiplies its slice of the input, the partials summed on
    the home device. At int8 the whole input is quantized on the home
    device and its codes split."""

    def __init__(self, layer: nn.Module, devices, home: torch.device,
                 span: Optional[sharding.Span] = None):
        self.devices, self.home, self.span = devices, home, span
        self.dtype = layer.weight.dtype
        self.weights = _one(self.take(layer.weight, devices, 1))
        self.bias = layer.bias
        self.release()

    def __call__(self, x: torch.Tensor, quant: bool = False) -> torch.Tensor:
        n, s_x = len(self.devices), None
        if quant:
            x, s_x = quantize(x, -1)
        else:
            x = _cast(x, self.dtype)
        xs = [None if d is None else xj.to(d, non_blocking=True)
              for xj, d in zip(x.chunk(n, -1), self.devices)]
        return _split_rows(xs, self.weights, self.bias, self.home,
                           self.dtype, quant, s_x, self.span)


class _Heads(sharding.Placement):
    """An Attention layer split by heads over the ``tp`` devices: shard
    ``j`` projects its heads' q, k and v (the per-head rows of the fused
    ``qkv`` or ``kv`` weight, with their own int8 scales), runs the
    attention of those heads on its device (on its ``sp`` ring where it
    has one) and multiplies its ``out_proj`` columns, a row product whose
    int8 token scales take the max over the shards; the partials are
    summed on the home device. A traced ``qkv``, ``q`` or ``kv`` site adds
    each shard's rows of ``up``'s q, k and v blocks; ``out_proj``'s is a
    row delta."""

    def __init__(self, attn: Attention, devices, rings, home: torch.device,
                 span: Optional[sharding.Span] = None):
        c = attn.out_proj.in_features
        self.width = c
        self.heads = attn.num_heads // len(devices)
        self.head_dim = c // attn.num_heads
        self.devices, self.rings, self.home = devices, rings, home
        self.span, self.dtype = span, attn.out_proj.weight.dtype
        # each shard's (q, k, v) rows: of the fused qkv's three blocks, or
        # of q and kv's two
        if hasattr(attn, "qkv"):
            self.qkv = self.take(attn.qkv.weight, devices, 0, 3)
        else:
            self.qkv = [None if q is None else q + kv for q, kv in zip(
                self.take(attn.q.weight, devices, 0),
                self.take(attn.kv.weight, devices, 0, 2))]
        self.out = _one(self.take(attn.out_proj.weight, devices, 1))
        self.out_bias = attn.out_proj.bias
        self.release()

    def __call__(self, x: torch.Tensor, context: Optional[torch.Tensor],
                 true_len: Optional[torch.Tensor], lora: Optional[dict],
                 quant: bool) -> torch.Tensor:
        b, t, _ = x.shape
        lora = {} if lora is None else lora
        scale = 1.0 / math.sqrt(self.head_dim)
        os_ = []
        for d, qkv, ring in zip(self.devices,
                                self.project(x, context, lora, quant),
                                self.rings):
            if d is None:
                os_.append(None)
                continue
            tl = None if true_len is None else true_len.to(d)
            o = _attend(*qkv, context is None, tl, ring, scale)
            os_.append(o.reshape(b, t, -1))
        return self.output(os_, lora.get("out_proj"), quant)

    def project(self, x: torch.Tensor, context: Optional[torch.Tensor],
                lora: dict, quant: bool
                ) -> List[Optional[Tuple[torch.Tensor, ...]]]:
        """Each shard's ``(q, k, v)``, ``(B, T, heads, head_dim)`` on its
        device (None for a shard another process computes), with the
        traced ``qkv``, ``q`` and ``kv`` sites' deltas."""
        c = self.width
        dtype = self.dtype
        inp = _dense_input(x, quant, dtype)
        if context is None:
            src_inp = inp
            hq = hk = _column_site(x, lora.get("qkv"), dtype)
            offsets = (0, c, 2 * c)
        else:
            src_inp = _dense_input(context, quant, dtype)
            hq = _column_site(x, lora.get("q"), dtype)
            hk = _column_site(context, lora.get("kv"), dtype)
            offsets = (0, 0, c)
        cols = self.heads * self.head_dim
        out = []
        for j, (d, ws) in enumerate(zip(self.devices, self.qkv)):
            if d is None:
                out.append(None)
                continue
            xd = _to(inp, d)
            sd = xd if context is None else _to(src_inp, d)
            qkv = []
            for a, w, hu, at in zip((xd, sd, sd), ws, (hq, hk, hk),
                                    offsets):
                y = _dense(a, w, None, dtype)
                if hu is not None:
                    y = y + _column_delta(
                        hu, slice(at + j * cols, at + (j + 1) * cols), d)
                qkv.append(y.unflatten(-1, (self.heads, self.head_dim)))
            out.append(tuple(qkv))
        return out

    def output(self, os_: List[Optional[torch.Tensor]], site: Optional[dict],
               quant: bool) -> torch.Tensor:
        """``out_proj`` of the shards' attention outputs ``(B, T,
        heads * head_dim)``: a row product, with the traced ``out_proj``
        site's delta."""
        out = _split_rows(os_, self.out, self.out_bias, self.home,
                          self.dtype, quant, span=self.span)
        return out if site is None else \
            out + _row_delta(os_, site, self.home, self.dtype, self.span)


class _Halves(sharding.Placement):
    """A TransformerBlock's GEGLU and ``ff_out`` over the ``tp`` devices:
    shard ``j`` holds its rows of both halves of ``proj`` (``a`` and the
    gelu gate), so its ``a * gelu(g)`` is whole, and multiplies its
    ``ff_out`` columns; the partials are summed on the home device. The
    ``proj`` halves are column products (a traced ``up`` splits into its
    ``a`` and ``g`` halves, each chunked by shard), ``ff_out`` a row
    product as ``_Heads``' ``out_proj``."""

    def __init__(self, block: TransformerBlock, devices,
                 home: torch.device, span: Optional[sharding.Span] = None):
        proj = block.geglu.proj
        self.half = proj.out_features // 2
        self.devices, self.home, self.span = devices, home, span
        self.dtype = block.ff_out.weight.dtype
        # each shard's rows of both halves (a, then the gelu gate)
        ws, bs = (self.take(proj.weight, devices, 0, 2),
                  self.take(proj.bias, devices, 0, 2))
        self.a, self.g = ([None if w is None else (w[h], b[h])
                           for w, b in zip(ws, bs)] for h in (0, 1))
        self.out = _one(self.take(block.ff_out.weight, devices, 1))
        self.out_bias = block.ff_out.bias
        self.release()

    def __call__(self, h: torch.Tensor, proj: Optional[dict],
                 ff_out: Optional[dict], quant: bool) -> torch.Tensor:
        return self.output(self.hidden(h, proj, quant), ff_out, quant)

    def hidden(self, h: torch.Tensor, proj: Optional[dict],
               quant: bool) -> List[Optional[torch.Tensor]]:
        """Each shard's ``a * gelu(g)`` on its device (None for a shard
        another process computes), with the traced ``proj`` site's
        delta."""
        dtype = self.dtype
        inp = _dense_input(h, quant, dtype)
        hu = _column_site(h, proj, dtype)
        rows = self.half // len(self.devices)
        ys = []
        for j, (d, ag, gg) in enumerate(zip(self.devices, self.a, self.g)):
            if d is None:
                ys.append(None)
                continue
            hd = _to(inp, d)
            a, g = _dense(hd, *ag, dtype), _dense(hd, *gg, dtype)
            if hu is not None:
                a = a + _column_delta(hu, slice(j * rows, (j + 1) * rows), d)
                g = g + _column_delta(hu, slice(self.half + j * rows,
                                                self.half + (j + 1) * rows),
                                      d)
            ys.append(a * F.gelu(g, approximate="tanh"))
        return ys

    def output(self, ys: List[Optional[torch.Tensor]], site: Optional[dict],
               quant: bool) -> torch.Tensor:
        """``ff_out`` of the shards' hidden states: a row product, with
        the traced ``ff_out`` site's delta."""
        out = _split_rows(ys, self.out, self.out_bias, self.home,
                          self.dtype, quant, span=self.span)
        return out if site is None else \
            out + _row_delta(ys, site, self.home, self.dtype, self.span)


def place_layers(module: nn.Module, layout) -> None:
    """Attach one replica's mesh placement to the layers of a model built
    on :class:`Dense` and :class:`Conv` (a UNet, a ControlNet, a CLIP text
    encoder, the VAE's decoder or encoder), or remove it (None).
    ``layout``: the replica's ``(tp, sp)`` devices
    (``parallel/sharding.py`` :func:`~..parallel.sharding.replica_layout`;
    across processes, the shards this process holds of it,
    :func:`~..parallel.sharding.placement`). Under ``sp > 1`` every UNet
    :class:`Attention` gets its ring (shard 0's where a layer is not split
    by heads). Under ``tp > 1`` a UNet attention whose heads divide it
    splits by heads, a GEGLU whose halves divide it by halves, and every
    other Dense or Conv layer by its class in JAX's rule
    (``sharding.shard_dim``): output features (a gather on the home
    device), input features (partials summed there), or none (it computes
    whole on the home device). So CLIP's and the VAE's attentions split as
    JAX splits them: the fused ``qkv`` by columns, gathered before the
    attention, and ``out_proj`` by rows. A placement across processes
    holds this process's shards alone and frees the layer's whole
    weights; removing or replacing it gathers them back from the replica's
    ranks first, so every rank of it places and removes together."""
    for m in module.modules():
        for p in (getattr(m, "tp", None), getattr(m, "ffn_tp", None)):
            if isinstance(p, sharding.Placement):
                p.restore()
    for m in module.modules():
        if isinstance(m, (Dense, Conv, Attention)):
            m.tp = None
        if isinstance(m, Attention):
            m.ring = None
        if isinstance(m, TransformerBlock):
            m.ffn_tp = None
    if layout is None:
        return
    home, devices, rings, span = sharding.placement(layout)
    tp = len(devices)
    done = set()
    for m in module.modules():
        if isinstance(m, Attention):
            m.ring = rings[0]
            if tp > 1 and m.num_heads % tp == 0:
                m.tp = _Heads(m, devices, rings, home, span)
                done.update(c for c in m.children())
        elif isinstance(m, TransformerBlock) and tp > 1 \
                and (m.geglu.proj.out_features // 2) % tp == 0:
            m.ffn_tp = _Halves(m, devices, home, span)
            done.update((m.geglu.proj, m.ff_out))
    for name, m in module.named_modules():
        if not isinstance(m, (Dense, Conv)) or m in done:
            continue
        dim = sharding.shard_dim(f"{name}.weight", m.weight, tp)
        if dim == 0:
            m.tp = _Column(m, devices, home, span)
        elif dim == 1 and isinstance(m, Dense):
            m.tp = _Row(m, devices, home, span)
