"""Ragged attention: per-row true lengths over bucket-padded tokens (K2).

Port of the JAX package's ``ops/ragged_attention.py``, whose Pallas kernel
this module's CUDA kernel replaces (``csrc/ragged_attention.cu``; the
source carries the note on what bounds it on the card). Under ragged
dispatch, requests of different heights share one bucket shape: each batch
row carries the length of its valid token prefix (latent rows are padded at
the bottom, so the valid tokens of a row-major flatten are a prefix), and
attention masks the padded tail in the kernel.

Same function as the JAX package's: keys at or past ``true_len[b]`` score
:data:`MASK_VALUE` (``exp`` of it underflows to exactly 0 in f32, without
the NaN of ``-inf - -inf``), and query rows at or past ``q_true_len[b]``
are written as 0. The UNet's self-attention masks its queries with the same
lengths; its cross-attention masks only the keys (the context past each
row's prompt), so one kernel serves both. Rows must have ``true_len >= 1``.

:func:`ragged_attention` launches the kernel for CUDA tensors and raises on
what the kernel does not take; the lengths stay a device tensor, read by
the kernel itself, so a launch never waits on the device. Only for tensors
on the CPU does it compute :func:`ragged_attention_reference`, the plain
PyTorch version the tests and ``chip_smoke.py`` hold the kernel against.
``ragged_attention.launches`` counts kernel launches and
``ragged_attention.path_launches`` counts them per path, as K1's wrapper
does (the same rule, in the same header, chooses the path).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from stable_diffusion_webui_distributed_tpu_torch.ops import nvcc
from stable_diffusion_webui_distributed_tpu_torch.ops.flash_attention import (
    DTYPES,
    bind_context,
    check_inputs,
    check_kernel_inputs,
    count_launch,
    current_stream,
    kernel_strides,
    on_device,
    reset_launches,
)

#: additive mask for padded key positions
MASK_VALUE = -1e30

_KERNEL = nvcc.KernelLibrary(
    "ragged_attention.cu", "sdt_ragged_attention_fwd",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 9
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def ragged_attention_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        true_len: torch.Tensor, scale: Optional[float] = None,
        q_true_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version: dense masked attention in f32, output in q's
    dtype. Keys at or past ``true_len[b]`` are masked out of the softmax;
    query rows at or past ``q_true_len[b]`` (when given) are zeroed."""
    t, s = q.shape[1], k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bthd,bshd->bhts", q.float() * scale, k.float())
    pos_k = torch.arange(s, dtype=torch.int32, device=q.device)
    kmask = pos_k[None, :] < true_len.to(q.device)[:, None]
    scores = torch.where(kmask[:, None, None, :], scores, MASK_VALUE)
    out = torch.einsum("bhts,bshd->bthd", torch.softmax(scores, dim=-1),
                       v.float())
    if q_true_len is not None:
        pos_q = torch.arange(t, dtype=torch.int32, device=q.device)
        qmask = pos_q[None, :] < q_true_len.to(q.device)[:, None]
        out = torch.where(qmask[:, :, None, None], out, 0.0)
    return out.to(q.dtype)


def build() -> Tuple:
    """Compile the kernel (see :func:`.nvcc.build`): the library's path and
    the compiler's output, empty when it was already built."""
    return _KERNEL.build()


def ragged_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     true_len: torch.Tensor, scale: Optional[float] = None,
                     mask_queries: bool = True) -> torch.Tensor:
    """Attention of ``(B, T, H, D)`` queries over the first ``true_len[b]``
    of ``(B, S, H, D)`` keys and values -> ``(B, T, H, D)`` in q's dtype.
    ``true_len`` is a ``(B,)`` integer tensor; with ``mask_queries`` query
    rows at or past it are written as 0 (self-attention), without it every
    query row is kept (cross-attention).

    CUDA tensors (f32 or bf16, last axis contiguous, D <= 256, the lengths
    on the same card) launch the kernel; anything it does not take raises.
    CPU tensors take the plain version, meta tensors its shape."""
    check_inputs(q, k, v)
    if true_len.shape != (q.shape[0],) or true_len.is_floating_point():
        raise ValueError(f"true_len must be a ({q.shape[0]},) integer "
                         f"tensor, not {true_len.dtype} "
                         f"{tuple(true_len.shape)}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type in ("cpu", "meta"):
        # a meta tensor computes nothing: the plain version's products
        # give its shape and let FlopCounterMode count them
        return ragged_attention_reference(
            q, k, v, true_len, scale,
            q_true_len=true_len if mask_queries else None)
    if q.device.type != "cuda":
        raise ValueError(f"no ragged_attention for device {q.device}")
    if true_len.device != q.device:
        raise ValueError(f"true_len lies on {true_len.device}, the inputs "
                         f"on {q.device}")
    check_kernel_inputs(q, k, v)
    fn = _KERNEL.function()
    lengths = true_len.to(torch.int32).contiguous()
    b, t, h, d = q.shape
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    with on_device(q):
        bind_context(q.device)
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  lengths.data_ptr(), b, t, k.shape[1], h, d,
                  *kernel_strides(q, k, v), float(scale), int(mask_queries),
                  DTYPES[q.dtype], current_stream(q))
    count_launch(ragged_attention, code)
    return out


reset_launches(ragged_attention)
