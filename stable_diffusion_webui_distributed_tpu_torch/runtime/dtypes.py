"""Device rule and dtype policy.

Port of the JAX package's ``runtime/dtypes.py``. The card policy stores
parameters in bf16 and computes in bf16; the numerically sensitive pieces
stay f32 whatever the policy says: GroupNorm/LayerNorm statistics, the
ResBlock residual add, the timestep embedding, the sampler math and the VAE
decoder (``VAEConfig.force_decoder_f32``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32    # storage dtype of weights
    compute_dtype: torch.dtype = torch.bfloat16  # matmul/conv dtype
    sampler_dtype: torch.dtype = torch.float32   # latent/sigma math


#: Default policy on the card: bf16 storage and compute.
CARD = Policy(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
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
