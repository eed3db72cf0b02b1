"""Weights across the two packages, and seeded weights for the card.

``flax_to_torch`` converts the Flax parameter tree the JAX package uses
(``{"text_encoder", "text_encoder_2", "unet", "vae"}``, names like
``down_0_res_0/norm1/gn/scale`` and ``attn1/qkv/kernel``) into the port's
state dicts (the VAE's decoder as ``vae``, its encoder as ``vae_encoder``): Dense kernels ``(in, out)`` become Linear weights
``(out, in)``, conv kernels HWIO become OIHW, norm scales and embeddings
become ``weight``. The results load with ``strict=True``.

``init_seeded`` makes weights with the same names and shapes from a seed,
drawn as Flax's default initialisers draw them (lecun-normal kernels, zero
biases, unit norm scales, ``Embed``'s fan-in normal, ``position_embedding``
at std 0.01), so full-width SD1.5 and SDXL base and refiner run on the card
with the statistics of the JAX package's random-weight runs. The draws are
torch's, not JAX's.

A ControlNet's weights travel on their own: ``controlnet_flax_to_torch``
converts the JAX package's ControlNet tree and ``init_seeded_controlnet``
seeds one, zero convolutions included (drawn like any other convolution,
where Flax starts them at zero, so a seeded unit has a visible effect).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from stable_diffusion_webui_distributed_tpu_torch.models.clip import (
    CLIPTextModel,
)
from stable_diffusion_webui_distributed_tpu_torch.models.configs import (
    ModelFamily,
)
from stable_diffusion_webui_distributed_tpu_torch.models.controlnet import (
    ControlNet,
)
from stable_diffusion_webui_distributed_tpu_torch.models.unet import UNet
from stable_diffusion_webui_distributed_tpu_torch.models.vae import (
    Decoder,
    Encoder,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.dtypes import (
    resolve_device,
)

StateDicts = Dict[str, Dict[str, torch.Tensor]]

# lecun_normal's truncated normal on [-2, 2] has this std per unit scale
_TRUNC_STD = 0.87962566103423978


def build_modules(family: ModelFamily) -> Dict[str, nn.Module]:
    """The port's modules for a family, keyed like the Flax tree (``vae``
    is the decoder, ``vae_encoder`` the encoder; ``text_encoder_2`` only
    for a family with a second encoder). Build under
    ``torch.device("meta")`` to skip allocation."""
    modules = {"text_encoder": CLIPTextModel(family.text_encoder)}
    if family.text_encoder_2 is not None:
        modules["text_encoder_2"] = CLIPTextModel(family.text_encoder_2)
    modules["unet"] = UNet(family.unet)
    modules["vae"] = Decoder(family.vae)
    # last: init_seeded draws the components in this order from one
    # generator, so the earlier components keep their seeded values
    modules["vae_encoder"] = Encoder(family.vae)
    return modules


def _flatten(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for key, value in tree.items():
        if hasattr(value, "items"):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _convert_leaf(path: Tuple[str, ...], value) -> Tuple[str, torch.Tensor]:
    arr = torch.from_numpy(np.array(value, dtype=np.float32))
    *mods, leaf = path
    if leaf == "kernel":
        if arr.dim() == 2:        # Dense (in, out) -> Linear (out, in)
            arr = arr.t()
        elif arr.dim() == 4:      # Conv HWIO -> OIHW
            arr = arr.permute(3, 2, 0, 1)
        else:
            raise ValueError(f"unexpected kernel rank at {'/'.join(path)}")
        leaf = "weight"
    elif leaf in ("scale", "embedding"):
        leaf = "weight"
    return ".".join(mods + [leaf]), arr.contiguous()


def _convert_tree(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    return dict(_convert_leaf(p, v) for p, v in _flatten(tree))


def flax_to_torch(family: ModelFamily, params: Dict[str, Any]) -> StateDicts:
    """Flax parameter tree -> the state dicts of :func:`build_modules`
    (f32, CPU): ``vae`` holds the decoder's weights, ``vae_encoder`` the
    encoder's."""
    trees = {"text_encoder": params["text_encoder"], "unet": params["unet"],
             "vae": params["vae"]["decoder"],
             "vae_encoder": params["vae"]["encoder"]}
    if family.text_encoder_2 is not None:
        trees["text_encoder_2"] = params["text_encoder_2"]
    return {name: _convert_tree(tree) for name, tree in trees.items()}


def controlnet_flax_to_torch(params: Dict[str, Any]
                             ) -> Dict[str, torch.Tensor]:
    """The JAX package's ControlNet parameter tree -> the state dict of
    ``models.controlnet.ControlNet`` (f32, CPU)."""
    return _convert_tree(params)


def _init_param(module: nn.Module, name: str, shape: torch.Size,
                gen: torch.Generator, device: torch.device) -> torch.Tensor:
    out = torch.empty(shape, dtype=torch.float32, device=device)
    if name == "bias":
        return out.zero_()
    if isinstance(module, (nn.LayerNorm, nn.GroupNorm)):
        return out.fill_(1.0)
    if isinstance(module, nn.Embedding):
        return out.normal_(0.0, 1.0 / math.sqrt(shape[1]), generator=gen)
    if name == "position_embedding":
        return out.normal_(0.0, 0.01, generator=gen)
    if isinstance(module, (nn.Linear, nn.Conv2d)):
        fan_in = math.prod(shape[1:])
        std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
        return nn.init.trunc_normal_(out, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=gen)
    raise ValueError(f"no initialiser for {type(module).__name__}.{name}")


def init_seeded(family: ModelFamily, seed: int = 0,
                device: Optional[Union[str, torch.device]] = None,
                dtype: torch.dtype = torch.float32) -> StateDicts:
    """Seeded random weights with :func:`flax_to_torch`'s names and shapes,
    drawn on ``device`` (``cuda`` unless named) and stored in ``dtype``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    with torch.device("meta"):
        modules = build_modules(family)
    return {comp: _seeded_state(root, gen, device, dtype)
            for comp, root in modules.items()}


def init_seeded_controlnet(family: ModelFamily, seed: int = 0,
                           device: Optional[Union[str, torch.device]] = None,
                           dtype: torch.dtype = torch.float32
                           ) -> Dict[str, torch.Tensor]:
    """Seeded random weights of a ControlNet for ``family``'s UNet, with
    :func:`controlnet_flax_to_torch`'s names and shapes, drawn as
    :func:`init_seeded` draws (the zero convolutions too) on ``device``
    (``cuda`` unless named) and stored in ``dtype``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    with torch.device("meta"):
        root = ControlNet(family.unet)
    return _seeded_state(root, gen, device, dtype)


def _seeded_state(root: nn.Module, gen: torch.Generator,
                  device: torch.device, dtype: torch.dtype
                  ) -> Dict[str, torch.Tensor]:
    sd = {}
    for mod_name, module in root.named_modules():
        for name, p in module.named_parameters(recurse=False):
            full = f"{mod_name}.{name}" if mod_name else name
            sd[full] = _init_param(module, name, p.shape, gen,
                                   device).to(dtype)
    return sd
