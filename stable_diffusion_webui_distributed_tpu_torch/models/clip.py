"""CLIP / OpenCLIP text encoders in PyTorch.

Port of the JAX package's ``models/clip.py``: fused QKV projection, pre-LN layers with f32 LayerNorm, an
additive causal mask of -1e9, webui's clip-skip rule (the final LayerNorm
re-applied to a skipped hidden state where ``layernorm_skipped``) and the
EOS-position pooled output. CLIP attention went through XLA's
``dot_product_attention`` in the JAX package, not a Pallas kernel, so here it
goes through ``scaled_dot_product_attention``. A traced LoRA tree
(``lora``: ``layer_{i}`` / ``attn`` / ``qkv``..., ``models/lora.py``) adds
its delta at the Dense sites it names. Textual inversion replaces the
token-embedding rows that ``inject_mask`` marks with ``inject_values``
(``models/embeddings.py``), before the position embedding.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from stable_diffusion_webui_distributed_tpu_torch.models.configs import (
    CLIPTextConfig,
)
from stable_diffusion_webui_distributed_tpu_torch.models.lora import (
    apply_site,
)
from stable_diffusion_webui_distributed_tpu_torch.models.unet import (
    Dense,
    LayerNorm32,
    reproducible_sdpa,
)


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return F.gelu(x, approximate="tanh")  # Flax nn.gelu
    raise ValueError(f"unknown activation {name}")


def tower_fingerprint(cfg: Optional[CLIPTextConfig]) -> tuple:
    """Architecture identity of one text tower for the embed cache's keys
    (JAX ``models/clip.py`` ``tower_fingerprint``): every field that
    changes the hidden states; no tower (None) gives the empty tuple, so
    SD1.x and SDXL keys cannot alias."""
    if cfg is None:
        return ()
    return (cfg.vocab_size, cfg.hidden_size, cfg.intermediate_size,
            cfg.num_layers, cfg.num_heads, cfg.max_length, cfg.hidden_act,
            cfg.projection_dim, cfg.default_skip, cfg.layernorm_skipped)


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.qkv = Dense(cfg.hidden_size, 3 * cfg.hidden_size)
        self.out_proj = Dense(cfg.hidden_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                lora: Optional[dict] = None) -> torch.Tensor:
        B, T, C = x.shape
        head_dim = C // self.num_heads
        qkv = apply_site(self.qkv(x), x, lora, "qkv")
        q, k, v = (t.unflatten(-1, (self.num_heads, head_dim)).transpose(1, 2)
                   for t in qkv.split(C, dim=-1))
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask.to(q.dtype),
            scale=1.0 / math.sqrt(head_dim))
        out = out.transpose(1, 2).reshape(B, T, C)
        return apply_site(self.out_proj(out), out, lora, "out_proj")


class CLIPLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.act = cfg.hidden_act
        self.ln1 = LayerNorm32(cfg.hidden_size)
        self.attn = CLIPAttention(cfg)
        self.ln2 = LayerNorm32(cfg.hidden_size)
        self.fc1 = Dense(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = Dense(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                lora: Optional[dict] = None) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), mask,
                          None if lora is None else lora.get("attn"))
        h = self.ln2(x)
        f = _act(self.act, apply_site(self.fc1(h), h, lora, "fc1"))
        return x + apply_site(self.fc2(f), f, lora, "fc2")


class CLIPTextModel(nn.Module):
    """Causal text transformer; ``forward(input_ids (B,T), skip)`` returns
    ``(context, pooled)``: the hidden states fed to cross-attention, taken
    ``skip`` layers before the end, and the final layer's EOS-position
    embedding (projected where ``projection_dim`` is set). ``lora`` is a
    traced adapter tree shared by every row. ``inject_values`` (B, T, H)
    and ``inject_mask`` (B, T, 1), 1 where a placeholder is, replace token
    rows with textual-inversion vectors: ``tok * (1 - m) + v * m`` in the
    encoder's dtype."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Parameter(
            torch.zeros(cfg.max_length, cfg.hidden_size))
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", CLIPLayer(cfg))
        self.final_ln = LayerNorm32(cfg.hidden_size)
        self.text_projection = (
            Dense(cfg.hidden_size, cfg.projection_dim, bias=False)
            if cfg.projection_dim else None)

    def forward(self, input_ids: torch.Tensor, skip: Optional[int] = None,
                lora: Optional[dict] = None,
                inject_values: Optional[torch.Tensor] = None,
                inject_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        with reproducible_sdpa():
            return self._forward(input_ids, skip,
                                 {} if lora is None else lora,
                                 inject_values, inject_mask)

    def _forward(self, input_ids: torch.Tensor, skip: Optional[int],
                 lora: dict, inject_values: Optional[torch.Tensor],
                 inject_mask: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        c = self.cfg
        skip = c.default_skip if skip is None else skip
        if not 0 <= skip < c.num_layers:
            raise ValueError(f"skip={skip} exceeds depth {c.num_layers}")
        B, T = input_ids.shape
        dtype = self.token_embedding.weight.dtype
        tok = self.token_embedding(input_ids)
        if inject_values is not None:
            m = inject_mask.to(dtype)
            tok = tok * (1.0 - m) + inject_values.to(dtype) * m
        x = tok + self.position_embedding[None, :T].to(dtype)
        causal = torch.triu(torch.full((T, T), -1e9, device=x.device),
                            diagonal=1)[None, None]
        hidden = None
        for i in range(c.num_layers):
            x = getattr(self, f"layer_{i}")(x, causal, lora.get(f"layer_{i}"))
            if i == c.num_layers - 1 - skip:
                hidden = x
        final = self.final_ln(x)
        if skip == 0:
            context = final
        elif c.layernorm_skipped:
            context = self.final_ln(hidden)
        else:
            context = hidden
        eos = input_ids.argmax(dim=-1)  # EOS has the largest token id
        pooled = final[torch.arange(B, device=x.device), eos]
        if self.text_projection is not None:
            pooled = self.text_projection(pooled)
        return context.to(dtype), pooled.to(dtype)


def pad_encoded_context(ctx: torch.Tensor, n_chunks: int,
                        tokens_per_chunk: int = 77) -> torch.Tensor:
    """Zero-pad an encoded ``(B, L, D)`` context along the sequence axis to
    ``n_chunks * tokens_per_chunk`` rows.

    Ragged conditioning encodes each prompt at its true chunk count and pads
    the encoded rows to the group's context length afterwards; cross-
    attention masks the padded rows by each row's ``ctx_true``, so their
    value never matters, and zeros keep them inert anywhere else."""
    want = n_chunks * tokens_per_chunk
    if ctx.shape[1] >= want:
        return ctx
    return F.pad(ctx, (0, 0, 0, want - ctx.shape[1]))
