"""Seed discipline: JAX's threefry2x32 noise, reproduced in torch.

Port of the JAX package's ``runtime/rng.py``. Image ``i`` of a request
depends only on ``seed + i``: its init noise is ``normal(key(seed + i))``
and its sampler noise at step ``s`` is ``normal(fold_in(key, s))``, where
``key(n) = fold_in(key(0), n)``. So any contiguous sub-batch
``[lo, hi)`` of a request reproduces the same rows of the whole batch.

To compare images with the JAX package, the noise must be JAX's own:

- threefry2x32 in integer ops, bit for bit (uint32 values carried in int64
  tensors, masked after every add and shift);
- random bits as ``jax_threefry_partitionable=True`` makes them: counts are
  the flat index split in (hi, lo) words, the bits are ``y1 ^ y2``;
- uniform on ``[nextafter(-1, 0), 1)`` from the top 23 bits, then
  ``sqrt(2) * erfinv(u)`` with XLA's f32 ``ErfInv`` polynomial (Giles' two
  9-term branches). ``torch.erfinv`` differs from it by up to 2e-5; this copy
  matches JAX's normals within 1e-6.

Noise is drawn in the JAX package's NHWC shape ``(h, w, C)``: the same bits
land on the same latent elements only in that order.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

# XLA's ErfInv32 coefficients, highest order first (w < 5, then w >= 5).
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
_SQRT2 = float(np.float32(np.sqrt(2)))
_UNIFORM_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))

IntLike = Union[int, torch.Tensor]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1: IntLike, k2: IntLike, x1: IntLike, x2: IntLike
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 hash of counts ``(x1, x2)`` under key ``(k1, k2)``:
    20 rounds, key injection every 4 — ``jax._src.prng`` word for word.
    Arguments broadcast; values are uint32 held in int64."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = x1 ^ _rotl(x2, r)
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x1, x2


def fold_in(keys: torch.Tensor, data: IntLike) -> torch.Tensor:
    """``jax.random.fold_in`` for a ``(..., 2)`` key tensor: the key hashed
    with the count pair ``(0, data)``."""
    data = data & _MASK if isinstance(data, int) else data
    y1, y2 = threefry2x32(keys[..., 0], keys[..., 1], 0, data)
    return torch.stack([y1, y2], dim=-1)


def key_for_seeds(seeds: torch.Tensor) -> torch.Tensor:
    """``fold_in(key(0), seed)`` for a tensor of uint32 seeds -> keys
    ``(..., 2)``."""
    zero = torch.zeros_like(seeds)
    return fold_in(torch.stack([zero, zero], dim=-1), seeds)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """32-bit random words ``(B, n)`` for keys ``(B, 2)``, as
    ``jax_threefry_partitionable`` draws them: counts ``(hi, lo)`` of the flat
    index, bits ``y1 ^ y2``."""
    iota = torch.arange(n, dtype=torch.int64, device=keys.device)[None]
    y1, y2 = threefry2x32(keys[:, :1], keys[:, 1:], 0, iota)
    return y1 ^ y2


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d f32 tensor of ``value`` on ``like``'s device, written by a fill
    kernel: ``torch.tensor(value, device=...)`` copies from host memory and
    makes the host wait for the device, once per draw of a sampler step."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def _erfinv_xla(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``ErfInv`` (``chlo.erf_inv``): one 9-term polynomial in
    ``w = -log1p(-x^2)`` on each side of ``w = 5``."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coeff(i):
        return torch.where(lt, _const(_ERFINV_LT5[i], x),
                           _const(_ERFINV_GE5[i], x))

    p = coeff(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = coeff(i) + p * w
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)`` for each of ``B`` keys ->
    ``(B, *shape)`` f32."""
    n = math.prod(shape)
    bits = random_bits(keys, n)
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = mant.view(torch.float32) - 1.0
    lo = _const(_UNIFORM_LO, floats)
    span = _const(1.0, floats) - lo
    u = torch.maximum(lo, floats * span + lo)
    out = _const(_SQRT2, floats) * _erfinv_xla(u)
    return out.reshape(keys.shape[0], *shape)


def _seeds(base: int, idx: torch.Tensor) -> torch.Tensor:
    return (int(base) + idx) & _MASK


def _indices(start: int, batch: int, pin_index: bool,
             device) -> torch.Tensor:
    if pin_index:
        return torch.zeros(batch, dtype=torch.int64, device=device)
    return torch.arange(batch, dtype=torch.int64, device=device) + int(start)


def slerp(t: float, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Spherical interpolation between ``a`` and ``b`` row by row (one image
    per leading index; webui semantics, f32 like the JAX package)."""
    shape = a.shape
    a = a.reshape(shape[0], -1)
    b = b.reshape(shape[0], -1)
    t = _const(t, a)
    a_norm = a / (torch.linalg.vector_norm(a, dim=1, keepdim=True) + 1e-12)
    b_norm = b / (torch.linalg.vector_norm(b, dim=1, keepdim=True) + 1e-12)
    dot = torch.clamp((a_norm * b_norm).sum(dim=1, keepdim=True), -1.0, 1.0)
    theta = torch.arccos(dot)
    sin_theta = torch.sin(theta)
    lerp = (1.0 - t) * a + t * b
    true_slerp = (torch.sin((1.0 - t) * theta) / sin_theta * a
                  + torch.sin(t * theta) / sin_theta * b)
    out = torch.where(sin_theta.abs() < 1e-6, lerp, true_slerp)
    return out.reshape(shape)


def _paste_centered(noise: torch.Tensor, target_shape: Sequence[int]
                    ) -> torch.Tensor:
    """Center-paste ``(B, fh, fw, C)`` noise into zeros of ``(B, H, W, C)``,
    cropping where the source is larger (webui create_random_tensors)."""
    _, fh, fw, _ = noise.shape
    _, H, W, _ = target_shape
    dy, dx = (H - fh) // 2, (W - fw) // 2
    ty, sy = max(0, dy), max(0, -dy)
    tx, sx = max(0, dx), max(0, -dx)
    h, w = min(fh, H), min(fw, W)
    out = torch.zeros(tuple(target_shape), dtype=noise.dtype,
                      device=noise.device)
    out[:, ty:ty + h, tx:tx + w] = noise[:, sy:sy + h, sx:sx + w]
    return out


def batch_noise(seed: int, subseed: int, subseed_strength: float,
                start_index: int, batch_size: int, shape: Sequence[int],
                seed_resize: Optional[Tuple[int, int]] = None,
                pin_index: bool = False,
                device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """Init noise ``(batch, h, w, C)`` f32 for images
    ``[start, start + batch)`` of a request.

    With ``subseed_strength > 0`` the base seed does not advance with the
    image index, only the subseed does, and the two draws are slerped.
    ``pin_index`` gives every image index-0 noise (same-seed batches).
    ``seed_resize=(from_h, from_w)`` draws at the "from" latent size and
    pastes it centered (webui seed resize)."""
    shape = tuple(shape)
    draw = shape if seed_resize is None else tuple(seed_resize) + shape[2:]
    idx = _indices(start_index, batch_size, pin_index, device)
    strength = float(np.float32(subseed_strength))
    main_idx = torch.zeros_like(idx) if strength > 0 else idx
    noise = normal(key_for_seeds(_seeds(seed, main_idx)), draw)
    if strength > 0:
        sub = normal(key_for_seeds(_seeds(subseed, idx)), draw)
        noise = slerp(strength, noise, sub)
    if seed_resize is not None:
        noise = _paste_centered(noise, (batch_size,) + shape)
    return noise


def batch_keys(seed: int, start_index: int, batch_size: int,
               pin_index: bool = False,
               device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """Per-image keys ``(batch, 2)`` for sampler noise, the companion of
    :func:`batch_noise`."""
    idx = _indices(start_index, batch_size, pin_index, device)
    return key_for_seeds(_seeds(seed, idx))


def step_noise_block(keys: torch.Tensor, first: int, count: int,
                     shape: Sequence[int]) -> torch.Tensor:
    """:func:`step_noise` of steps ``[first, first+count)`` at once ->
    ``(count, B, *shape)``: the same bits, since each draw depends on its
    key and its step alone."""
    steps = torch.arange(first, first + count, dtype=torch.int64,
                         device=keys.device)
    folded = fold_in(keys[None].expand(count, -1, -1), steps[:, None])
    return normal(folded.reshape(-1, 2), shape).reshape(
        count, keys.shape[0], *shape)


def step_noise(keys: torch.Tensor, step: int,
               shape: Sequence[int]) -> torch.Tensor:
    """Per-image, per-step sampler noise ``(B, *shape)``: the step index
    folded into each image's key (``samplers/kdiffusion.py:_step_noise``
    of the JAX package)."""
    return normal(fold_in(keys, int(step)), shape)
