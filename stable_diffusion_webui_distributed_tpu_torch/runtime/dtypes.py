"""Device rule and dtype policy.

Port of the JAX package's ``runtime/dtypes.py``. The card policy stores
parameters in bf16 and computes in bf16; the numerically sensitive pieces
stay f32 whatever the policy says: GroupNorm/LayerNorm statistics, the
ResBlock residual add, the timestep embedding, the sampler math and the VAE
decoder (``VAEConfig.force_decoder_f32``).

``SDTPU_UNET_INT8`` and ``SDTPU_UNET_INT8_CONV`` (flags, off) set the card
policy's default serving precision (``int8`` / ``int8+conv``,
``pipeline/precision.py``); a request's own ``precision`` wins.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from stable_diffusion_webui_distributed_tpu_torch.runtime.config import (
    env_flag,
)


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32    # storage dtype of weights
    compute_dtype: torch.dtype = torch.bfloat16  # matmul/conv dtype
    sampler_dtype: torch.dtype = torch.float32   # latent/sigma math
    # the default serving precision: W8A8 int8 for the UNet's transformer
    # linears (``unet_int8``) and its ResBlock, Down and Up convs
    # (``unet_int8_conv``); a request's ``precision`` wins over both
    unet_int8: bool = False
    unet_int8_conv: bool = False


#: Default policy on the card: bf16 storage and compute.
CARD = Policy(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
              unet_int8=env_flag("SDTPU_UNET_INT8"),
              unet_int8_conv=env_flag("SDTPU_UNET_INT8_CONV"))
#: Full-f32 policy for numerics tests on the CPU.
F32 = Policy(compute_dtype=torch.float32)


def resolve_device(device: Optional[Union[str, torch.device]]
                   ) -> torch.device:
    """``cuda`` unless the caller names a device. With none named and no GPU
    present this raises: an entry point never carries on quietly on the
    CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly")
    return torch.device("cuda")


def to_device(t: torch.Tensor, device: Union[str, torch.device]
              ) -> torch.Tensor:
    """A host tensor on ``device`` without the host waiting for the
    device: on the card it is staged in pinned memory and copied
    asynchronously in stream order (a copy from pageable memory makes the
    host wait for the work already queued, which would stall a dispatch
    running ahead of the card)."""
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
