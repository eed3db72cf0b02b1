"""Flash attention for the UNet's latent self-attention (kernel K1).

Port of the JAX package's ``ops/flash_attention.py``, whose Pallas kernel
this module's CUDA kernel replaces (``csrc/flash_attention.cu``; the source
carries the note on what bounds it on the card). Same function: non-causal
``softmax(q . k^T * scale) . v`` over ``(B, T, H, D) x (B, S, H, D)``, q
scaled in f32, online softmax in f32, output in q's dtype. Unlike the
Pallas wrapper it takes any T and S, so there is no dense fallback.

:func:`flash_attention` launches the kernel for CUDA tensors and raises on
what the kernel does not take. Only for tensors on the CPU does it compute
:func:`flash_attention_reference`, the plain PyTorch version the tests and
``chip_smoke.py`` hold the kernel against; a meta tensor (the FLOP pricer,
``pipeline/stepcache.py``) gets that version's shape-only result. ``flash_attention.launches``
counts kernel launches, and ``flash_attention.path_launches`` counts them
per path, as the C entry point reports the path it launched: bf16 launches
go to the Hopper kernel (TMA + ``wgmma``) where TMA can address the
operands, else to the general ``mma.sync`` kernel, chosen in C from shape,
strides, alignment and the scale's sign before the launch (``sm90_path``
in ``csrc/attention_sm90.cuh``). A replayed CUDA graph launches its
kernels without this module's Python: the graph layer
(``runtime/graphs.py``) adds the launches it counted at capture to both
counts on every replay (:func:`add_launches`).

The kernel is built with ``nvcc`` from the repository's source at first use
(:func:`build`), into ``_build/`` beside this package's sources.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from stable_diffusion_webui_distributed_tpu_torch.ops import nvcc

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
#: the kernels' paths, numbered as the C entry points return them
PATHS = ("f32", "general", "hopper")

_KERNEL = nvcc.KernelLibrary(
    "flash_attention.cu", "sdt_flash_attention_fwd",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 9
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              scale: Optional[float] = None) -> torch.Tensor:
    """The plain version: ``softmax(q . k^T * scale) . v`` written out in f32,
    output in q's dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    qf = q.float() * scale
    s = torch.einsum("bthd,bshd->bhts", qf, k.float())
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhts,bshd->bthd", p, v.float()).to(q.dtype)


def build() -> Tuple:
    """Compile the kernel (see :func:`.nvcc.build`): the library's path and
    the compiler's output, empty when it was already built."""
    return _KERNEL.build()


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """``(B, T, H, D)`` queries over ``(B, S, H, D)`` keys and values of one
    dtype on one device, or ValueError."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("attention wants (B, T, H, D) tensors")
    b, t, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"dtype mismatch: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")


def check_kernel_inputs(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> None:
    """What the attention kernels (K1, K2) take on the card, or ValueError:
    f32 or bf16, head dims 1..256, B*H <= 65535 and a contiguous last
    axis."""
    if q.dtype not in DTYPES:
        raise ValueError(f"kernel takes f32 or bf16, not {q.dtype}")
    b, t, h, d = q.shape
    s = k.shape[1]
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"kernel takes head dims 1..{MAX_HEAD_DIM}, not {d}")
    if min(b, t, s, h) < 1 or b * h > 65535:
        raise ValueError(f"kernel cannot take B={b}, T={t}, S={s}, H={h}")
    if any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError("kernel needs a contiguous last (head-dim) axis")


def kernel_strides(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """The (b, t, h) element strides of q, k and v, as the kernels take
    them: column slices of a fused projection are read in place."""
    return (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])


def current_stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def on_device(x: torch.Tensor):
    """A context that makes x's card the current one: a no-op when it
    already is (the common case, which then costs no device switch)."""
    if x.device.index in (None, torch.cuda.current_device()):
        return contextlib.nullcontext()
    return torch.cuda.device(x.device)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention over ``(B, T, H, D)`` queries and ``(B, S, H, D)`` keys and
    values -> ``(B, T, H, D)`` in q's dtype.

    CUDA tensors (f32 or bf16, last axis contiguous, D <= 256) launch the
    kernel; anything it does not take raises. CPU tensors take the plain
    version, meta tensors its shape."""
    check_inputs(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type in ("cpu", "meta"):
        # a meta tensor computes nothing: the plain version's products
        # give its shape and let FlopCounterMode count them
        return flash_attention_reference(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention for device {q.device}")
    check_kernel_inputs(q, k, v)
    fn = _KERNEL.function()
    b, t, h, d = q.shape
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    with on_device(q):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  b, t, k.shape[1], h, d, *kernel_strides(q, k, v),
                  float(scale), DTYPES[q.dtype], current_stream(q))
    count_launch(flash_attention, code)
    return out


def count_launch(wrapper, code: int) -> None:
    """Counts a launch of ``wrapper``'s kernel by what its C entry point
    returned: the path it launched (an index into :data:`PATHS`), or a
    negated ``cudaError_t``, which raises and counts nothing."""
    if code < 0:
        raise RuntimeError(f"{wrapper.__name__} launch failed: cudaError "
                           f"{-code}")
    wrapper.launches += 1
    wrapper.path_launches[PATHS[code]] += 1


def reset_launches(fn) -> None:
    """Sets a kernel wrapper's launch counts (total and per path: its own
    paths, the attention kernels' by default) to 0."""
    fn.launches = 0
    fn.path_launches = dict.fromkeys(
        getattr(fn, "path_launches", None) or PATHS, 0)


def add_launches(fn, launches: int, path_launches: Dict[str, int]) -> None:
    """Adds launches that ran without passing through ``fn``'s Python: the
    kernels of a replayed CUDA graph (``runtime/graphs.py``), counted when
    the graph was captured."""
    fn.launches += launches
    for path, n in path_launches.items():
        fn.path_launches[path] += n


reset_launches(flash_attention)
