"""Dynamic W8A8 int8 products for the UNet's linears and convolutions.

Port of the JAX package's ``ops/quant.py``. Quantization happens at call
time from the layer's own weight, so one set of weights serves every
serving precision (``pipeline/precision.py``) and a merged LoRA or a
checkpoint switch is seen by each of them. It is symmetric and dynamic:

- a linear (:func:`int8_dot`) scales its activations per token (the abs
  max over the feature axis) and its weight per output channel;
- a convolution (:func:`int8_conv`) scales its activations per image (the
  abs max over C, H and W: one weight is slid over every pixel) and its
  weight per output channel.

The arithmetic is the JAX package's, in f32 and in its order: ``s = amax
/ 127 + eps``, codes ``round(x / s)`` (half to even) cast to int8, the
product accumulated in int32, then ``acc * s_x * s_w``. The codes lie in
[-127, 127] and, since 0 maps to 0, zero padding of the codes is exact.

The int8 product is :func:`int8_mm`: on the card ``torch._int_mm``
(cuBLASLt on the int8 tensor cores), its operands zero-padded to the
shapes it takes (more than 16 rows, inner and outer sizes multiples of
8) and the result sliced back; on the CPU :func:`int8_mm_reference`, the
plain version: the codes' exact integer products (in f64, which holds
every sum of int8 products these layers make exactly). The JAX package
left this product to XLA (``lax.dot_general`` with int32 accumulation),
so it stays a library call here; ``chip_smoke.py`` holds the card's
accumulators equal to the plain version's. A convolution's product runs
over patches of the int8 codes: ``F.unfold`` has no int8 kernel, so the
codes are padded and windowed with ``Tensor.unfold`` views, the patch
axis in the order of an OIHW weight reshaped to ``(O, I*kh*kw)``.

``int8_mm.launches`` counts the card's int8 products (a replayed CUDA
graph adds the ones it captured, as for the attention kernels), so a
request can show that it ran at int8.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

EPS = 1e-8
#: the shapes ``torch._int_mm`` takes on the card: more than this many
#: rows, inner and outer sizes multiples of :data:`INT_MM_ALIGN`
INT_MM_MIN_ROWS = 16
INT_MM_ALIGN = 8


def quantize(x: torch.Tensor, dims: Union[int, Sequence[int]],
             eps: float = EPS) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(codes, scale)``: ``x`` in f32 scaled by ``amax|x| / 127 + eps``
    over ``dims`` (kept), rounded half to even, as int8."""
    xf = x.float()
    s = xf.abs().amax(dim=dims, keepdim=True) / 127.0 + eps
    return torch.round(xf / s).to(torch.int8), s


def int8_mm_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version: ``(M, K) @ (K, N)`` int8 codes -> their exact
    int32 products."""
    return (a.double() @ b.double()).to(torch.int32)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(M, K) @ (K, N)`` int8 -> int32. CUDA tensors go to
    ``torch._int_mm``, zero-padded to the shapes it takes; CPU tensors
    take :func:`int8_mm_reference`."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise ValueError(f"int8_mm takes int8 codes, not {a.dtype}, "
                         f"{b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"int8_mm shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError("int8_mm operands must lie on one device")
    if a.device.type == "cpu":
        return int8_mm_reference(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"no int8_mm for device {a.device}")
    m, k = a.shape
    n = b.shape[1]
    mp = max(m, INT_MM_MIN_ROWS + 1)
    kp, np_ = _round_up(k, INT_MM_ALIGN), _round_up(n, INT_MM_ALIGN)
    if (mp, kp) != (m, k):
        a = torch.nn.functional.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        # padded as (N, K) and viewed back: column-major, as a weight's
        # transpose is
        b = torch.nn.functional.pad(b.t(), (0, kp - k, 0, np_ - n)).t()
    out = torch._int_mm(a, b)
    int8_mm.launches += 1
    int8_mm.path_launches["int_mm"] += 1
    if (mp, np_) != (m, n):
        out = out[:m, :n]
    return out


int8_mm.launches = 0
int8_mm.path_launches = {"int_mm": 0}


def int8_dot(x: torch.Tensor, weight: torch.Tensor, eps: float = EPS,
             accumulators: bool = False):
    """``x @ weight.T`` with int8 operands (JAX ``int8_dot``; the port's
    weight is ``(out, in)``): ``x`` ``(..., in)`` of any float dtype,
    per-token scales, per-output-channel weight scales. Returns f32
    ``(..., out)``; with ``accumulators`` also the int32 ``(M, out)``
    products."""
    xq, s_x = quantize(x, -1, eps)
    wq, s_w = quantize(weight, 1, eps)
    acc = int8_mm(xq.reshape(-1, xq.shape[-1]), wq.t())
    out = acc.reshape(*x.shape[:-1], -1).float() * s_x * s_w.reshape(-1)
    return (out, acc) if accumulators else out


def conv_patches(xq: torch.Tensor, kernel: Tuple[int, int],
                 stride: Tuple[int, int], padding: Tuple[int, int]
                 ) -> Tuple[torch.Tensor, int, int]:
    """``(patches (B*Ho*Wo, C*kh*kw), Ho, Wo)`` of NCHW codes (any dtype):
    zero-padded, windowed by ``Tensor.unfold``, the patch axis ordered as
    an OIHW weight reshaped to ``(O, C*kh*kw)``."""
    kh, kw = kernel
    sh, sw = stride
    ph, pw = padding
    if ph or pw:
        xq = torch.nn.functional.pad(xq, (pw, pw, ph, ph))
    win = xq.unfold(2, kh, sh).unfold(3, kw, sw)  # (B, C, Ho, Wo, kh, kw)
    b, c, ho, wo = win.shape[:4]
    return win.permute(0, 2, 3, 1, 4, 5).reshape(b * ho * wo,
                                                  c * kh * kw), ho, wo


def int8_conv(x: torch.Tensor, weight: torch.Tensor,
              stride: Tuple[int, int] = (1, 1),
              padding: Tuple[int, int] = (0, 0), eps: float = EPS,
              accumulators: bool = False):
    """A 2-D convolution of NCHW ``x`` by an OIHW ``weight`` with int8
    operands (JAX ``int8_conv``): per-image activation scales,
    per-output-channel weight scales, int32 accumulation over the
    patches. Returns f32 NCHW; with ``accumulators`` also the int32
    ``(B*Ho*Wo, O)`` products."""
    b = x.shape[0]
    o, _, kh, kw = weight.shape
    xq, s_x = quantize(x, (1, 2, 3), eps)
    wq, s_w = quantize(weight, (1, 2, 3), eps)
    patches, ho, wo = conv_patches(xq, (kh, kw), tuple(stride),
                                   tuple(padding))
    acc = int8_mm(patches, wq.reshape(o, -1).t())
    # NHWC as the JAX package computes it, then back to the port's NCHW
    out = (acc.reshape(b, ho, wo, o).float() * s_x.reshape(b, 1, 1, 1)
           * s_w.reshape(1, 1, 1, o)).permute(0, 3, 1, 2)
    return (out, acc) if accumulators else out
