#!/usr/bin/env python3
"""The port's state dicts in the ldm single-file layout: the inverse of the
port's ``models/convert.py`` ``convert_ldm``.

    python3 tools/torch_ldm_writer.py FAMILY SEED OUT.safetensors [--device D]

writes ``bridge.init_seeded(FAMILY, SEED)`` as an f16 ldm checkpoint. As a
module, :func:`to_ldm` maps ``{"text_encoder", "text_encoder_2", "unet",
"vae", "vae_encoder"}`` onto ldm keys (``model.diffusion_model.*``,
``first_stage_model.*``, ``cond_stage_model.*`` or
``conditioner.embedders.*``), splitting every fused ``qkv``/``kv`` back
into its projections and restoring SD1.x's 1x1-convolution ``proj_in`` /
``proj_out``; :func:`vae_to_ldm` gives a standalone VAE file's bare
``encoder.``/``decoder.`` keys and :func:`controlnet_to_ldm` a ControlNet's
``control_model.*``. ``chip_smoke.py``'s ``write_safetensors`` writes
such a dict one tensor at a time. Tensors are views of the inputs where
nothing is split.
The text-encoder layout follows the family: two encoders are SDXL base
(HF CLIP at ``conditioner.embedders.0.transformer``, OpenCLIP at
``conditioner.embedders.1.model``), one with added conditioning the SDXL
refiner (OpenCLIP at ``conditioner.embedders.0.model``), one with ``gelu``
SD2.x (OpenCLIP at ``cond_stage_model.model``), else SD1.x (HF CLIP at
``cond_stage_model.transformer``).

The JAX package has no such writer, so this lives beside the port, not in
it; ``tests/test_torch_convert.py`` holds its output to the JAX package's
reading of the layout.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, Sequence

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

Tensors = Dict[str, torch.Tensor]

class _Emitter:
    """Moves tensors of one port state dict to ldm keys; :meth:`finish`
    refuses a state dict with tensors no ldm key took."""

    def __init__(self, sd: Tensors, out: Tensors):
        self.sd = sd
        self.out = out
        self.used: set = set()

    def get(self, name: str) -> torch.Tensor:
        self.used.add(name)
        return self.sd[name]

    def put(self, key: str, name: str) -> None:
        self.out[key] = self.get(name)

    def linear(self, key: str, name: str, bias: bool = True,
               conv1x1: bool = False) -> None:
        w = self.get(f"{name}.weight")
        self.out[f"{key}.weight"] = w[:, :, None, None] if conv1x1 else w
        if bias:
            self.put(f"{key}.bias", f"{name}.bias")

    def conv(self, key: str, name: str) -> None:
        self.put(f"{key}.weight", f"{name}.weight")
        self.put(f"{key}.bias", f"{name}.bias")

    norm = conv

    def split(self, keys: Sequence[str], name: str, bias: bool,
              conv1x1: bool = False) -> None:
        """A fused Linear's rows back into one projection per key."""
        for key, w in zip(keys, self.get(f"{name}.weight").chunk(len(keys))):
            self.out[f"{key}.weight"] = w[:, :, None, None] if conv1x1 else w
        if bias:
            for key, b in zip(keys, self.get(f"{name}.bias").chunk(
                    len(keys))):
                self.out[f"{key}.bias"] = b

    def finish(self, scope: str) -> None:
        left = sorted(set(self.sd) - self.used)
        if left:
            raise KeyError(f"{scope}: {len(left)} tensors have no ldm key: "
                           f"{left[:10]}")


def _clip_hf(sd: Tensors, cfg, prefix: str, out: Tensors) -> None:
    e = _Emitter(sd, out)
    e.put(f"{prefix}.embeddings.token_embedding.weight",
          "token_embedding.weight")
    e.put(f"{prefix}.embeddings.position_embedding.weight",
          "position_embedding")
    e.norm(f"{prefix}.final_layer_norm", "final_ln")
    for i in range(cfg.num_layers):
        lp, n = f"{prefix}.encoder.layers.{i}", f"layer_{i}"
        e.norm(f"{lp}.layer_norm1", f"{n}.ln1")
        e.norm(f"{lp}.layer_norm2", f"{n}.ln2")
        e.split([f"{lp}.self_attn.{x}_proj" for x in "qkv"],
                f"{n}.attn.qkv", bias=True)
        e.linear(f"{lp}.self_attn.out_proj", f"{n}.attn.out_proj")
        e.linear(f"{lp}.mlp.fc1", f"{n}.fc1")
        e.linear(f"{lp}.mlp.fc2", f"{n}.fc2")
    if cfg.projection_dim:
        parent = prefix.rsplit(".text_model", 1)[0]
        e.put(f"{parent}.text_projection.weight", "text_projection.weight")
    e.finish(prefix)


def _clip_openai(sd: Tensors, cfg, prefix: str, out: Tensors) -> None:
    e = _Emitter(sd, out)
    e.put(f"{prefix}.token_embedding.weight", "token_embedding.weight")
    e.put(f"{prefix}.positional_embedding", "position_embedding")
    e.norm(f"{prefix}.ln_final", "final_ln")
    for i in range(cfg.num_layers):
        lp, n = f"{prefix}.transformer.resblocks.{i}", f"layer_{i}"
        e.norm(f"{lp}.ln_1", f"{n}.ln1")
        e.norm(f"{lp}.ln_2", f"{n}.ln2")
        e.put(f"{lp}.attn.in_proj_weight", f"{n}.attn.qkv.weight")
        e.put(f"{lp}.attn.in_proj_bias", f"{n}.attn.qkv.bias")
        e.linear(f"{lp}.attn.out_proj", f"{n}.attn.out_proj")
        e.linear(f"{lp}.mlp.c_fc", f"{n}.fc1")
        e.linear(f"{lp}.mlp.c_proj", f"{n}.fc2")
    if cfg.projection_dim:
        # open_clip's raw (width, embed_dim) matrix
        out[f"{prefix}.text_projection"] = \
            e.get("text_projection.weight").t().contiguous()
    e.finish(prefix)


def _res_block(e: _Emitter, key: str, name: str, has_skip: bool) -> None:
    e.norm(f"{key}.in_layers.0", f"{name}.norm1.gn")
    e.conv(f"{key}.in_layers.2", f"{name}.conv1")
    e.linear(f"{key}.emb_layers.1", f"{name}.time_proj")
    e.norm(f"{key}.out_layers.0", f"{name}.norm2.gn")
    e.conv(f"{key}.out_layers.3", f"{name}.conv2")
    if has_skip:
        e.conv(f"{key}.skip_connection", f"{name}.skip")


def _transformer(e: _Emitter, key: str, name: str, depth: int,
                 conv_proj: bool) -> None:
    e.norm(f"{key}.norm", f"{name}.norm.gn")
    e.linear(f"{key}.proj_in", f"{name}.proj_in", conv1x1=conv_proj)
    e.linear(f"{key}.proj_out", f"{name}.proj_out", conv1x1=conv_proj)
    for d in range(depth):
        bp, n = f"{key}.transformer_blocks.{d}", f"{name}.block_{d}"
        for i in (1, 2, 3):
            e.norm(f"{bp}.norm{i}", f"{n}.ln{i}")
        e.split([f"{bp}.attn1.to_{x}" for x in "qkv"], f"{n}.attn1.qkv",
                bias=False)
        e.linear(f"{bp}.attn1.to_out.0", f"{n}.attn1.out_proj")
        e.put(f"{bp}.attn2.to_q.weight", f"{n}.attn2.q.weight")
        e.split([f"{bp}.attn2.to_k", f"{bp}.attn2.to_v"], f"{n}.attn2.kv",
                bias=False)
        e.linear(f"{bp}.attn2.to_out.0", f"{n}.attn2.out_proj")
        e.linear(f"{bp}.ff.net.0.proj", f"{n}.geglu.proj")
        e.linear(f"{bp}.ff.net.2", f"{n}.ff_out")


def _unet(sd: Tensors, cfg, conv_proj: bool, out: Tensors,
          prefix: str = "model.diffusion_model") -> None:
    e = _Emitter(sd, out)
    e.linear(f"{prefix}.time_embed.0", "time_fc1")
    e.linear(f"{prefix}.time_embed.2", "time_fc2")
    e.conv(f"{prefix}.input_blocks.0.0", "conv_in")
    e.norm(f"{prefix}.out.0", "norm_out.gn")
    e.conv(f"{prefix}.out.2", "conv_out")
    if cfg.addition_embed_dim:
        e.linear(f"{prefix}.label_emb.0.0", "add_fc1")
        e.linear(f"{prefix}.label_emb.0.2", "add_fc2")
    levels = list(zip(cfg.block_out_channels, cfg.down_blocks))
    n, prev = 1, cfg.block_out_channels[0]
    for level, (ch, depth) in enumerate(levels):
        for i in range(cfg.layers_per_block):
            key = f"{prefix}.input_blocks.{n}"
            _res_block(e, f"{key}.0", f"down_{level}_res_{i}", prev != ch)
            if depth is not None:
                _transformer(e, f"{key}.1", f"down_{level}_attn_{i}", depth,
                             conv_proj)
            prev = ch
            n += 1
        if level < len(levels) - 1:
            e.conv(f"{prefix}.input_blocks.{n}.0.op",
                   f"down_{level}_ds.conv")
            n += 1
    _res_block(e, f"{prefix}.middle_block.0", "mid_res_0", False)
    mid = 1
    if cfg.mid_block_depth is not None:
        _transformer(e, f"{prefix}.middle_block.1", "mid_attn",
                     cfg.mid_block_depth, conv_proj)
        mid = 2
    _res_block(e, f"{prefix}.middle_block.{mid}", "mid_res_1", False)
    n = 0
    for level in reversed(range(len(levels))):
        ch, depth = levels[level]
        for i in range(cfg.layers_per_block + 1):
            key = f"{prefix}.output_blocks.{n}"
            _res_block(e, f"{key}.0", f"up_{level}_res_{i}", True)
            idx = 1
            if depth is not None:
                _transformer(e, f"{key}.1", f"up_{level}_attn_{i}", depth,
                             conv_proj)
                idx = 2
            if i == cfg.layers_per_block and level > 0:
                e.conv(f"{key}.{idx}.conv", f"up_{level}_us.conv")
            n += 1
    e.finish("unet")


def _vae_res(e: _Emitter, key: str, name: str, has_skip: bool) -> None:
    e.norm(f"{key}.norm1", f"{name}.norm1.gn")
    e.conv(f"{key}.conv1", f"{name}.conv1")
    e.norm(f"{key}.norm2", f"{name}.norm2.gn")
    e.conv(f"{key}.conv2", f"{name}.conv2")
    if has_skip:
        e.conv(f"{key}.nin_shortcut", f"{name}.skip")


def _vae_attn(e: _Emitter, key: str, name: str) -> None:
    e.norm(f"{key}.norm", f"{name}.norm.gn")
    e.split([f"{key}.{x}" for x in "qkv"], f"{name}.qkv", bias=True,
            conv1x1=True)
    e.linear(f"{key}.proj_out", f"{name}.out_proj", conv1x1=True)


def _vae(enc: Tensors, dec: Tensors, cfg, out: Tensors,
         prefix: str = "first_stage_model") -> None:
    pre = f"{prefix}." if prefix else ""
    chs = cfg.block_out_channels
    e = _Emitter(enc, out)
    e.conv(f"{pre}encoder.conv_in", "conv_in")
    prev = chs[0]
    for level, ch in enumerate(chs):
        for i in range(cfg.layers_per_block):
            _vae_res(e, f"{pre}encoder.down.{level}.block.{i}",
                     f"down_{level}_res_{i}", i == 0 and prev != ch)
        prev = ch
        if level < len(chs) - 1:
            e.conv(f"{pre}encoder.down.{level}.downsample.conv",
                   f"down_{level}_ds")
    _vae_res(e, f"{pre}encoder.mid.block_1", "mid_res_0", False)
    _vae_attn(e, f"{pre}encoder.mid.attn_1", "mid_attn")
    _vae_res(e, f"{pre}encoder.mid.block_2", "mid_res_1", False)
    e.norm(f"{pre}encoder.norm_out", "norm_out.gn")
    e.conv(f"{pre}encoder.conv_out", "conv_out")
    e.conv(f"{pre}quant_conv", "quant_conv")
    e.finish("vae_encoder")

    d = _Emitter(dec, out)
    d.conv(f"{pre}post_quant_conv", "post_quant_conv")
    d.conv(f"{pre}decoder.conv_in", "conv_in")
    _vae_res(d, f"{pre}decoder.mid.block_1", "mid_res_0", False)
    _vae_attn(d, f"{pre}decoder.mid.attn_1", "mid_attn")
    _vae_res(d, f"{pre}decoder.mid.block_2", "mid_res_1", False)
    prev = chs[-1]
    for level in reversed(range(len(chs))):
        ch = chs[level]
        for i in range(cfg.layers_per_block + 1):
            _vae_res(d, f"{pre}decoder.up.{level}.block.{i}",
                     f"up_{level}_res_{i}", i == 0 and prev != ch)
        prev = ch
        if level > 0:
            d.conv(f"{pre}decoder.up.{level}.upsample.conv",
                   f"up_{level}_us")
    d.norm(f"{pre}decoder.norm_out", "norm_out.gn")
    d.conv(f"{pre}decoder.conv_out", "conv_out")
    d.finish("vae")


def to_ldm(family, sds: Dict[str, Tensors]) -> Tensors:
    """The port's state dicts of ``family`` as one ldm state dict."""
    out: Tensors = {}
    sd1 = False
    if family.text_encoder_2 is not None:
        _clip_hf(sds["text_encoder"], family.text_encoder,
                 "conditioner.embedders.0.transformer.text_model", out)
        _clip_openai(sds["text_encoder_2"], family.text_encoder_2,
                     "conditioner.embedders.1.model", out)
    elif family.unet.addition_embed_dim:
        _clip_openai(sds["text_encoder"], family.text_encoder,
                     "conditioner.embedders.0.model", out)
    elif family.text_encoder.hidden_act == "gelu":
        _clip_openai(sds["text_encoder"], family.text_encoder,
                     "cond_stage_model.model", out)
    else:
        sd1 = True
        _clip_hf(sds["text_encoder"], family.text_encoder,
                 "cond_stage_model.transformer.text_model", out)
    # SD1.x's transformers project in and out with 1x1 convolutions
    _unet(sds["unet"], family.unet, sd1, out)
    _vae(sds["vae_encoder"], sds["vae"], family.vae, out)
    return out


def vae_to_ldm(family, sds: Dict[str, Tensors]) -> Tensors:
    """A standalone VAE file's state dict (bare ``encoder.``/``decoder.``,
    ``quant_conv``, ``post_quant_conv`` keys) from ``vae`` and
    ``vae_encoder``."""
    out: Tensors = {}
    _vae(sds["vae_encoder"], sds["vae"], family.vae, out, prefix="")
    return out


def controlnet_to_ldm(cfg, sd: Tensors, prefix: str = "control_model"
                      ) -> Tensors:
    """A ControlNet's state dict (``models.controlnet.ControlNet`` for a
    UNet of ``cfg``) in the ldm ``control_model.*`` layout."""
    from stable_diffusion_webui_distributed_tpu_torch.models.controlnet \
        import HINT_CHANNELS

    out: Tensors = {}
    e = _Emitter(sd, out)
    e.linear(f"{prefix}.time_embed.0", "time_fc1")
    e.linear(f"{prefix}.time_embed.2", "time_fc2")
    e.conv(f"{prefix}.input_blocks.0.0", "conv_in")
    e.conv(f"{prefix}.middle_block_out.0", "mid_out")
    if cfg.addition_embed_dim:
        e.linear(f"{prefix}.label_emb.0.0", "add_fc1")
        e.linear(f"{prefix}.label_emb.0.2", "add_fc2")
    for i in range(len(HINT_CHANNELS)):
        e.conv(f"{prefix}.input_hint_block.{2 * i}", f"hint.conv_{i}")
    e.conv(f"{prefix}.input_hint_block.{2 * len(HINT_CHANNELS)}",
           "hint.conv_out")
    e.conv(f"{prefix}.zero_convs.0.0", "zero_conv_0")
    levels = list(zip(cfg.block_out_channels, cfg.down_blocks))
    # an SD1.x ControlNet's transformers project with 1x1 convolutions
    sd1 = not cfg.addition_embed_dim
    n, prev = 1, cfg.block_out_channels[0]
    for level, (ch, depth) in enumerate(levels):
        for i in range(cfg.layers_per_block):
            key = f"{prefix}.input_blocks.{n}"
            _res_block(e, f"{key}.0", f"down_{level}_res_{i}", prev != ch)
            if depth is not None:
                _transformer(e, f"{key}.1", f"down_{level}_attn_{i}", depth,
                             sd1)
            e.conv(f"{prefix}.zero_convs.{n}.0", f"zero_conv_{n}")
            prev = ch
            n += 1
        if level < len(levels) - 1:
            e.conv(f"{prefix}.input_blocks.{n}.0.op", f"down_{level}_ds.conv")
            e.conv(f"{prefix}.zero_convs.{n}.0", f"zero_conv_{n}")
            n += 1
    _res_block(e, f"{prefix}.middle_block.0", "mid_res_0", False)
    idx = 1
    if cfg.mid_block_depth is not None:
        _transformer(e, f"{prefix}.middle_block.1", "mid_attn",
                     cfg.mid_block_depth, sd1)
        idx = 2
    _res_block(e, f"{prefix}.middle_block.{idx}", "mid_res_1", False)
    e.finish("controlnet")
    return out


def main(argv) -> int:
    import argparse

    sys.path.insert(0, ROOT)
    from chip_smoke import write_safetensors
    from stable_diffusion_webui_distributed_tpu_torch import bridge
    from stable_diffusion_webui_distributed_tpu_torch.models.configs import (
        FAMILIES,
    )

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("family", choices=sorted(FAMILIES))
    ap.add_argument("seed", type=int)
    ap.add_argument("out")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    family = FAMILIES[args.family]
    sds = bridge.init_seeded(family, args.seed, device=args.device)
    size = write_safetensors(args.out, to_ldm(family, sds), "F16")
    print(f"{args.out}: {family.name} seed {args.seed}, {size} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
