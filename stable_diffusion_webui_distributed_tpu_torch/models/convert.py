"""Checkpoint conversion: SD single-file (ldm) state dicts -> the port's.

Port of the JAX package's ``models/convert.py``. webui nodes load
``*.safetensors`` single-file checkpoints by name, and the reference syncs
that choice across its workers through ``/sdapi/v1/options``. This module
maps the ldm key layout (``model.diffusion_model.*`` for the UNet,
``first_stage_model.*`` for the VAE, ``cond_stage_model.*`` /
``conditioner.embedders.*`` for the text encoders) onto the state dicts of
``bridge.build_modules``: ``text_encoder``, ``text_encoder_2`` (SDXL
base), ``unet``, ``vae`` (the decoder) and ``vae_encoder``, which load
with ``strict=True``. Each function mirrors its JAX counterpart one for
one and replays ldm's module numbering from the config.

ldm weights are already in torch's layouts (Linear ``(out, in)``, Conv
OIHW), so conversion renames and reshapes: separate q/k/v projections fuse
into one ``qkv`` (or ``kv``) Linear by concatenating their rows, a 1x1
convolution used as a Linear (SD1.x's ``proj_in``/``proj_out``, the VAE's
attention) is squeezed to 2-D, and OpenCLIP's raw ``text_projection`` (in,
out) is transposed. Tensors keep the checkpoint's dtype and, where nothing
is fused or transposed, are views of its tensors (of the file's map, with
:class:`~.safetensors_io.SafetensorsFile`). A key the layout needs that
the checkpoint lacks is never filled in: the conversion raises
:class:`MissingKeys` with every absent key.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Sequence

import torch

from stable_diffusion_webui_distributed_tpu_torch.models.configs import (
    CLIPTextConfig,
    ModelFamily,
    UNetConfig,
    VAEConfig,
)
from stable_diffusion_webui_distributed_tpu_torch.models.safetensors_io import (
    SafetensorsFile,
)

StateDict = Mapping[str, torch.Tensor]
Tree = Dict[str, object]


class MissingKeys(KeyError):
    """A conversion found keys absent; ``missing`` lists every one."""

    def __init__(self, scope: str, missing: Sequence[str]):
        super().__init__(f"{scope}: {len(missing)} keys absent: "
                         f"{list(missing)}")
        self.missing = list(missing)


class _Puller:
    """Hands out checkpoint tensors by key and records the keys it took
    and those that were absent (an absent key gives None, which the
    helpers below pass through; :meth:`finish` then raises)."""

    def __init__(self, sd: StateDict):
        self.sd = sd
        self.used: set = set()
        self.missing: List[str] = []

    def take(self, key: str) -> Optional[torch.Tensor]:
        if key not in self.sd:
            self.missing.append(key)
            return None
        self.used.add(key)
        return self.sd[key]

    def finish(self, scope: str) -> None:
        if self.missing:
            raise MissingKeys(scope, self.missing)


def _apply(fn: Callable[[torch.Tensor], torch.Tensor],
           t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else fn(t)


def _squeeze(w: torch.Tensor) -> torch.Tensor:
    """A 1x1 convolution's weight as a Linear's ``(out, in)``."""
    return w[:, :, 0, 0] if w.dim() == 4 else w


def _linear(p: _Puller, key: str, bias: bool = True) -> Tree:
    out: Tree = {"weight": _apply(_squeeze, p.take(f"{key}.weight"))}
    if bias:
        out["bias"] = p.take(f"{key}.bias")
    return out


def _conv(p: _Puller, key: str) -> Tree:
    return {"weight": p.take(f"{key}.weight"), "bias": p.take(f"{key}.bias")}


def _norm(p: _Puller, key: str) -> Tree:
    return {"weight": p.take(f"{key}.weight"), "bias": p.take(f"{key}.bias")}


def _gn(p: _Puller, key: str) -> Tree:
    return {"gn": _norm(p, key)}


def _cat(parts: Sequence[Optional[torch.Tensor]]) -> Optional[torch.Tensor]:
    if any(t is None for t in parts):
        return None
    return torch.cat(list(parts))


def _fused(mats: Sequence[Optional[torch.Tensor]],
           biases: Optional[Sequence[Optional[torch.Tensor]]] = None) -> Tree:
    """Separate projections as one Linear: their rows stacked."""
    out: Tree = {"weight": _cat(mats)}
    if biases is not None:
        out["bias"] = _cat(biases)
    return out


def _flatten(tree: Tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flatten(value, f"{prefix}{key}."))
        else:
            out[prefix + key] = value
    return out


# --------------------------------------------------------------------------
# Text encoders
# --------------------------------------------------------------------------

def convert_clip_hf(sd: StateDict, cfg: CLIPTextConfig,
                    prefix: str) -> Dict[str, torch.Tensor]:
    """HF ``text_model`` layout (SD1.x ``cond_stage_model.transformer``,
    SDXL ``conditioner.embedders.0.transformer``)."""
    p = _Puller(sd)
    out: Tree = {
        "token_embedding": {
            "weight": p.take(f"{prefix}.embeddings.token_embedding.weight")},
        "position_embedding": p.take(
            f"{prefix}.embeddings.position_embedding.weight"),
        "final_ln": _norm(p, f"{prefix}.final_layer_norm"),
    }
    for i in range(cfg.num_layers):
        lp = f"{prefix}.encoder.layers.{i}"
        qw = p.take(f"{lp}.self_attn.q_proj.weight")
        kw = p.take(f"{lp}.self_attn.k_proj.weight")
        vw = p.take(f"{lp}.self_attn.v_proj.weight")
        qb = p.take(f"{lp}.self_attn.q_proj.bias")
        kb = p.take(f"{lp}.self_attn.k_proj.bias")
        vb = p.take(f"{lp}.self_attn.v_proj.bias")
        out[f"layer_{i}"] = {
            "ln1": _norm(p, f"{lp}.layer_norm1"),
            "ln2": _norm(p, f"{lp}.layer_norm2"),
            "attn": {
                "qkv": _fused([qw, kw, vw], [qb, kb, vb]),
                "out_proj": _linear(p, f"{lp}.self_attn.out_proj"),
            },
            "fc1": _linear(p, f"{lp}.mlp.fc1"),
            "fc2": _linear(p, f"{lp}.mlp.fc2"),
        }
    if cfg.projection_dim:
        # HF keeps text_projection outside text_model, on the wrapper
        parent = prefix.rsplit(".text_model", 1)[0]
        out["text_projection"] = {
            "weight": p.take(f"{parent}.text_projection.weight")}
    p.finish(f"clip[{prefix}]")
    return _flatten(out)


def convert_clip_openai(sd: StateDict, cfg: CLIPTextConfig,
                        prefix: str) -> Dict[str, torch.Tensor]:
    """OpenCLIP ``model`` layout (SDXL ``conditioner.embedders.1.model``,
    the refiner's ``conditioner.embedders.0.model``, SD2.x
    ``cond_stage_model.model``): a fused ``in_proj_weight`` already in the
    ``qkv`` layout, ``resblocks`` naming, a raw ``text_projection``."""
    p = _Puller(sd)
    out: Tree = {
        "token_embedding": {"weight": p.take(f"{prefix}.token_embedding.weight")},
        "position_embedding": p.take(f"{prefix}.positional_embedding"),
        "final_ln": _norm(p, f"{prefix}.ln_final"),
    }
    for i in range(cfg.num_layers):
        lp = f"{prefix}.transformer.resblocks.{i}"
        out[f"layer_{i}"] = {
            "ln1": _norm(p, f"{lp}.ln_1"),
            "ln2": _norm(p, f"{lp}.ln_2"),
            "attn": {
                "qkv": {"weight": p.take(f"{lp}.attn.in_proj_weight"),
                        "bias": p.take(f"{lp}.attn.in_proj_bias")},
                "out_proj": _linear(p, f"{lp}.attn.out_proj"),
            },
            "fc1": _linear(p, f"{lp}.mlp.c_fc"),
            "fc2": _linear(p, f"{lp}.mlp.c_proj"),
        }
    if cfg.projection_dim:
        # open_clip stores text_projection as (width, embed_dim) and
        # applies it as x @ proj: a Linear's weight is its transpose
        out["text_projection"] = {"weight": _apply(
            lambda t: t.t().contiguous(), p.take(f"{prefix}.text_projection"))}
    p.finish(f"openclip[{prefix}]")
    return _flatten(out)


# --------------------------------------------------------------------------
# UNet
# --------------------------------------------------------------------------

def _res_block(p: _Puller, key: str, has_skip: bool) -> Tree:
    out: Tree = {
        "norm1": _gn(p, f"{key}.in_layers.0"),
        "conv1": _conv(p, f"{key}.in_layers.2"),
        "time_proj": _linear(p, f"{key}.emb_layers.1"),
        "norm2": _gn(p, f"{key}.out_layers.0"),
        "conv2": _conv(p, f"{key}.out_layers.3"),
    }
    if has_skip:
        out["skip"] = _conv(p, f"{key}.skip_connection")
    return out


def _transformer(p: _Puller, key: str, depth: int) -> Tree:
    out: Tree = {
        "norm": _gn(p, f"{key}.norm"),
        "proj_in": _linear(p, f"{key}.proj_in"),
        "proj_out": _linear(p, f"{key}.proj_out"),
    }
    for d in range(depth):
        bp = f"{key}.transformer_blocks.{d}"
        qw = p.take(f"{bp}.attn1.to_q.weight")
        kw = p.take(f"{bp}.attn1.to_k.weight")
        vw = p.take(f"{bp}.attn1.to_v.weight")
        out[f"block_{d}"] = {
            "ln1": _norm(p, f"{bp}.norm1"),
            "ln2": _norm(p, f"{bp}.norm2"),
            "ln3": _norm(p, f"{bp}.norm3"),
            "attn1": {
                "qkv": _fused([qw, kw, vw]),
                "out_proj": _linear(p, f"{bp}.attn1.to_out.0"),
            },
            "attn2": {
                "q": {"weight": p.take(f"{bp}.attn2.to_q.weight")},
                "kv": _fused([
                    p.take(f"{bp}.attn2.to_k.weight"),
                    p.take(f"{bp}.attn2.to_v.weight"),
                ]),
                "out_proj": _linear(p, f"{bp}.attn2.to_out.0"),
            },
            "geglu": {"proj": _linear(p, f"{bp}.ff.net.0.proj")},
            "ff_out": _linear(p, f"{bp}.ff.net.2"),
        }
    return out


def convert_unet(sd: StateDict, cfg: UNetConfig,
                 prefix: str = "model.diffusion_model"
                 ) -> Dict[str, torch.Tensor]:
    """ldm UNet layout -> ``models.unet.UNet``'s state dict.

    Replays ldm's module numbering (``input_blocks`` gain an index per res
    or downsample entry, ``output_blocks`` append the upsample to a level's
    last block), so the mapping comes from the config."""
    p = _Puller(sd)
    out: Tree = {
        "time_fc1": _linear(p, f"{prefix}.time_embed.0"),
        "time_fc2": _linear(p, f"{prefix}.time_embed.2"),
        "conv_in": _conv(p, f"{prefix}.input_blocks.0.0"),
        "norm_out": _gn(p, f"{prefix}.out.0"),
        "conv_out": _conv(p, f"{prefix}.out.2"),
    }
    if cfg.addition_embed_dim:
        out["add_fc1"] = _linear(p, f"{prefix}.label_emb.0.0")
        out["add_fc2"] = _linear(p, f"{prefix}.label_emb.0.2")

    levels = list(zip(cfg.block_out_channels, cfg.down_blocks))
    n = 1
    prev_ch = cfg.block_out_channels[0]
    for level, (ch, depth) in enumerate(levels):
        for i in range(cfg.layers_per_block):
            key = f"{prefix}.input_blocks.{n}"
            out[f"down_{level}_res_{i}"] = _res_block(p, f"{key}.0",
                                                      has_skip=prev_ch != ch)
            if depth is not None:
                out[f"down_{level}_attn_{i}"] = _transformer(p, f"{key}.1",
                                                             depth)
            prev_ch = ch
            n += 1
        if level < len(levels) - 1:
            out[f"down_{level}_ds"] = {
                "conv": _conv(p, f"{prefix}.input_blocks.{n}.0.op")}
            n += 1

    out["mid_res_0"] = _res_block(p, f"{prefix}.middle_block.0",
                                  has_skip=False)
    mid_idx = 1
    if cfg.mid_block_depth is not None:
        out["mid_attn"] = _transformer(p, f"{prefix}.middle_block.1",
                                       cfg.mid_block_depth)
        mid_idx = 2
    out["mid_res_1"] = _res_block(p, f"{prefix}.middle_block.{mid_idx}",
                                  has_skip=False)

    n = 0
    for level in reversed(range(len(levels))):
        ch, depth = levels[level]
        for i in range(cfg.layers_per_block + 1):
            key = f"{prefix}.output_blocks.{n}"
            # the concatenated skip always changes the channel count
            out[f"up_{level}_res_{i}"] = _res_block(p, f"{key}.0",
                                                    has_skip=True)
            idx = 1
            if depth is not None:
                out[f"up_{level}_attn_{i}"] = _transformer(p, f"{key}.1",
                                                           depth)
                idx = 2
            if i == cfg.layers_per_block and level > 0:
                out[f"up_{level}_us"] = {"conv": _conv(p, f"{key}.{idx}.conv")}
            n += 1

    p.finish("unet")
    return _flatten(out)


# --------------------------------------------------------------------------
# VAE
# --------------------------------------------------------------------------

def _vae_res(p: _Puller, key: str, has_skip: bool) -> Tree:
    out: Tree = {
        "norm1": _gn(p, f"{key}.norm1"),
        "conv1": _conv(p, f"{key}.conv1"),
        "norm2": _gn(p, f"{key}.norm2"),
        "conv2": _conv(p, f"{key}.conv2"),
    }
    if has_skip:
        # a 1x1 convolution (a Linear's 2-D weight in some files)
        skip = _conv(p, f"{key}.nin_shortcut")
        skip["weight"] = _apply(
            lambda w: w if w.dim() == 4 else w[:, :, None, None],
            skip["weight"])
        out["skip"] = skip
    return out


def _vae_attn(p: _Puller, key: str) -> Tree:
    q, k, v = (_apply(_squeeze, p.take(f"{key}.{x}.weight"))
               for x in ("q", "k", "v"))
    return {
        "norm": _gn(p, f"{key}.norm"),
        "qkv": _fused([q, k, v], [p.take(f"{key}.q.bias"),
                                  p.take(f"{key}.k.bias"),
                                  p.take(f"{key}.v.bias")]),
        "out_proj": _linear(p, f"{key}.proj_out"),
    }


def convert_vae(sd: StateDict, cfg: VAEConfig,
                prefix: str = "first_stage_model"
                ) -> Dict[str, Dict[str, torch.Tensor]]:
    """ldm VAE layout -> ``{"encoder": ..., "decoder": ...}``, the state
    dicts of ``models.vae.Encoder`` and ``Decoder``."""
    p = _Puller(sd)
    enc: Tree = {
        "conv_in": _conv(p, f"{prefix}.encoder.conv_in"),
        "mid_res_0": _vae_res(p, f"{prefix}.encoder.mid.block_1", False),
        "mid_attn": _vae_attn(p, f"{prefix}.encoder.mid.attn_1"),
        "mid_res_1": _vae_res(p, f"{prefix}.encoder.mid.block_2", False),
        "norm_out": _gn(p, f"{prefix}.encoder.norm_out"),
        "conv_out": _conv(p, f"{prefix}.encoder.conv_out"),
        "quant_conv": _conv(p, f"{prefix}.quant_conv"),
    }
    prev = cfg.block_out_channels[0]
    for level, ch in enumerate(cfg.block_out_channels):
        for i in range(cfg.layers_per_block):
            enc[f"down_{level}_res_{i}"] = _vae_res(
                p, f"{prefix}.encoder.down.{level}.block.{i}",
                has_skip=(i == 0 and prev != ch))
        prev = ch
        if level < len(cfg.block_out_channels) - 1:
            enc[f"down_{level}_ds"] = _conv(
                p, f"{prefix}.encoder.down.{level}.downsample.conv")

    dec: Tree = {
        "post_quant_conv": _conv(p, f"{prefix}.post_quant_conv"),
        "conv_in": _conv(p, f"{prefix}.decoder.conv_in"),
        "mid_res_0": _vae_res(p, f"{prefix}.decoder.mid.block_1", False),
        "mid_attn": _vae_attn(p, f"{prefix}.decoder.mid.attn_1"),
        "mid_res_1": _vae_res(p, f"{prefix}.decoder.mid.block_2", False),
        "norm_out": _gn(p, f"{prefix}.decoder.norm_out"),
        "conv_out": _conv(p, f"{prefix}.decoder.conv_out"),
    }
    prev = cfg.block_out_channels[-1]
    for level in reversed(range(len(cfg.block_out_channels))):
        ch = cfg.block_out_channels[level]
        for i in range(cfg.layers_per_block + 1):
            dec[f"up_{level}_res_{i}"] = _vae_res(
                p, f"{prefix}.decoder.up.{level}.block.{i}",
                has_skip=(i == 0 and prev != ch))
        prev = ch
        if level > 0:
            dec[f"up_{level}_us"] = _conv(
                p, f"{prefix}.decoder.up.{level}.upsample.conv")

    p.finish("vae")
    return {"encoder": _flatten(enc), "decoder": _flatten(dec)}


# --------------------------------------------------------------------------
# Whole-checkpoint entry points
# --------------------------------------------------------------------------

def convert_ldm(sd: StateDict, family: ModelFamily
                ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Convert a whole single-file state dict for ``family`` into the state
    dicts of ``bridge.build_modules(family)``: ``text_encoder``,
    ``text_encoder_2`` (only for a family with a second encoder), ``unet``,
    ``vae`` (the decoder) and ``vae_encoder``."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    if family.text_encoder_2 is not None:
        out["text_encoder"] = convert_clip_hf(
            sd, family.text_encoder,
            "conditioner.embedders.0.transformer.text_model")
        out["text_encoder_2"] = convert_clip_openai(
            sd, family.text_encoder_2, "conditioner.embedders.1.model")
    elif any(k.startswith("conditioner.embedders.0.model.") for k in sd):
        # single-encoder layouts: the SDXL refiner (OpenCLIP) ...
        out["text_encoder"] = convert_clip_openai(
            sd, family.text_encoder, "conditioner.embedders.0.model")
    elif any(k.startswith("cond_stage_model.model.") for k in sd):
        # ... SD2.x (OpenCLIP) ...
        out["text_encoder"] = convert_clip_openai(
            sd, family.text_encoder, "cond_stage_model.model")
    else:
        # ... and SD1.x (HF text_model)
        out["text_encoder"] = convert_clip_hf(
            sd, family.text_encoder,
            "cond_stage_model.transformer.text_model")
    out["unet"] = convert_unet(sd, family.unet)
    vae = convert_vae(sd, family.vae)
    out["vae"], out["vae_encoder"] = vae["decoder"], vae["encoder"]
    return out


def read_state_dict(path: str) -> StateDict:
    """A single-file checkpoint's tensors: a ``.safetensors`` file mapped
    (:class:`~.safetensors_io.SafetensorsFile`); a ``.ckpt``/``.pt`` file
    through ``torch.load(weights_only=True)``, its ``state_dict`` when it
    has one. Tensors keep the file's dtype."""
    if path.lower().endswith(".safetensors"):
        return SafetensorsFile(path)
    raw = torch.load(path, map_location="cpu", weights_only=True)
    raw = raw.get("state_dict", raw)
    return {k: v for k, v in raw.items() if isinstance(v, torch.Tensor)}


def load_checkpoint(path: str, family: ModelFamily
                    ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Read and convert a single-file checkpoint (``.safetensors`` or a
    torch ``.ckpt``/``.pt``)."""
    return convert_ldm(read_state_dict(path), family)


def detect_family(sd: StateDict) -> str:
    """The model family a checkpoint's keys name (webui guesses the same
    way when a user drops in an arbitrary checkpoint). Inpainting
    checkpoints are told by their 9-channel ``conv_in``. SD2.x's
    v-prediction (768-v) and epsilon (512-base) models have the same keys:
    the default is the v-prediction model, which a ``<file>.json`` family
    sidecar overrides."""
    conv_in = sd.get("model.diffusion_model.input_blocks.0.0.weight")
    inpaint = conv_in is not None and conv_in.dim() == 4 \
        and conv_in.shape[1] == 9
    if "conditioner.embedders.1.model.text_projection" in sd or any(
            k.startswith("conditioner.embedders.1.") for k in sd):
        return "sdxl-inpaint" if inpaint else "sdxl-base"
    if any(k.startswith("conditioner.embedders.0.model.") for k in sd):
        return "sdxl-refiner"
    if any(k.startswith("cond_stage_model.model.") for k in sd):
        return "sd2-inpaint" if inpaint else "sd21"
    return "sd15-inpaint" if inpaint else "sd15"
