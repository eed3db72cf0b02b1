"""Image and latent resizing, and the host-side helpers of img2img and
inpainting.

Port of the JAX package's ``_resize_image``, ``_box1d`` / ``_box_blur`` and
``_latent_resize_method`` (``pipeline/engine.py``) and of the
``jax.image.resize`` they and the hires fix rely on. That resize contracts
each axis whose size changes with a weight matrix (``compute_weight_mat`` in
``scale_and_translate``): the kernel (triangle, Keys cubic with a = -0.5,
lanczos3) is widened by the inverse scale when it shrinks the axis and the
weights of each output sample are normalised to sum to 1; ``nearest`` picks
the source index ``floor((i + 0.5) * in / out)``. ``F.interpolate`` matches
none of them in general (its bicubic has a = -0.75, its bilinear does not
renormalise, it has no lanczos), so the matrices are built here after JAX's
algorithm, in f32 as JAX computes them, and applied axis by axis: in numpy
on the host (:func:`resize`), or with ``torch.einsum`` in f32 on the
tensor's device (:func:`resize_device`), where they are plain products,
outside any kernel of the JAX package.
"""

from __future__ import annotations

import functools
import logging
from typing import Sequence

import numpy as np
import torch

log = logging.getLogger(__name__)

_EPS32 = float(np.finfo(np.float32).eps)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, np.float32(0.0), out)


def _lanczos3(x: np.ndarray) -> np.ndarray:
    radius = 3.0
    y = radius * np.sin(np.pi * x) * np.sin(np.pi * x / radius)
    out = np.where(x > 1e-3,
                   y / np.where(x != 0, np.pi ** 2 * x ** 2, np.float32(1.0)),
                   np.float32(1.0))
    return np.where(x > radius, np.float32(0.0), out)


_KERNELS = {"linear": _triangle, "cubic": _keys_cubic,
            "lanczos3": _lanczos3}


@functools.lru_cache(maxsize=64)
def weights(in_size: int, out_size: int, method: str = "linear"
            ) -> np.ndarray:
    """``(in_size, out_size)`` f32 weights of ``jax.image.resize`` along one
    axis: ``compute_weight_mat`` (no translation, antialiased) for the
    filters, a one-hot column per output sample for ``nearest``. Cached;
    the caller must not write to the array."""
    if method == "nearest":
        src = np.floor((np.arange(out_size, dtype=np.float32)
                        + np.float32(0.5)) * np.float32(in_size)
                       / np.float32(out_size)).astype(np.int64)
        w = np.zeros((in_size, out_size), np.float32)
        w[src, np.arange(out_size)] = 1.0
        return w
    kernel = _KERNELS[method]
    scale = out_size / in_size
    inv_scale = np.float32(1.0 / scale)
    kernel_scale = np.maximum(inv_scale, np.float32(1.0))
    sample = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5))
              * inv_scale - np.float32(0.5))
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None]
               ) / kernel_scale
    w = kernel(x.astype(np.float32)).astype(np.float32)
    total = w.sum(axis=0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000.0 * _EPS32,
                 w / np.where(total != 0, total, np.float32(1.0)),
                 np.float32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, np.float32(0.0)).astype(np.float32)


def resize(img: np.ndarray, shape: Sequence[int],
           method: str = "linear") -> np.ndarray:
    """``jax.image.resize(img, shape, method)`` for an f32 array on the
    host: each axis whose size changes is contracted with
    :func:`weights`, in axis order."""
    out = np.asarray(img, np.float32)
    for axis, n in enumerate(shape):
        m = out.shape[axis]
        if m == n:
            continue
        w = weights(m, n, method)
        out = np.moveaxis(np.tensordot(out, w, axes=([axis], [0])), -1, axis)
    return out.astype(np.float32)


def resize_bilinear(img: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """``jax.image.resize(img, shape, "bilinear")`` for an f32 array."""
    return resize(img, shape, "linear")


def resize_device(x: torch.Tensor, height: int, width: int,
                  method: str = "linear") -> torch.Tensor:
    """``jax.image.resize`` of an NHWC tensor ``(B, H, W, C)`` to ``(B,
    height, width, C)`` on its own device, in f32: each spatial axis whose
    size changes is contracted with :func:`weights` by ``torch.einsum``
    (the caller holds TF32 off, as the engine's ``_reproducible`` does)."""
    x = x.float()
    _, h, w, _ = x.shape
    if h != height:
        wh = torch.from_numpy(weights(h, height, method)).to(x.device)
        x = torch.einsum("bhwc,hy->bywc", x, wh)
    if w != width:
        ww = torch.from_numpy(weights(w, width, method)).to(x.device)
        x = torch.einsum("bhwc,wx->bhxc", x, ww)
    return x


def resize_image(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """(H, W, C) f32 image -> (height, width, C); the same array when the
    size already matches."""
    if img.shape[0] == height and img.shape[1] == width:
        return img
    return resize_bilinear(img, (height, width, img.shape[2]))


def latent_resize_method(hr_upscaler: str) -> str:
    """webui's latent upscaler names -> resize methods: a name holding
    "latent" is "nearest" or "cubic" by its own words, else "linear". Any
    other name reaches here only when no upscaler file matched it (the
    engine's ``upscaler_provider`` is asked first): it falls back to
    "linear", with a warning, as in the JAX package."""
    name = (hr_upscaler or "Latent").lower()
    if "latent" in name:
        if "nearest" in name:
            return "nearest"
        if "bicubic" in name:
            return "cubic"
        return "linear"
    log.warning("hires upscaler '%s' unavailable; using latent bilinear",
                hr_upscaler)
    return "linear"


def _box1d(a: np.ndarray, r: int, axis: int) -> np.ndarray:
    """Zero-padded box filter of width 2r+1 along ``axis``, by a cumulative
    sum's sliding window."""
    k = 2 * r + 1
    pad = [(0, 0)] * a.ndim
    pad[axis] = (r + 1, r)
    c = np.cumsum(np.pad(a, pad), axis=axis, dtype=np.float32)
    hi = [slice(None)] * a.ndim
    hi[axis] = slice(k, None)
    lo = [slice(None)] * a.ndim
    lo[axis] = slice(0, c.shape[axis] - k)
    return (c[tuple(hi)] - c[tuple(lo)]) / np.float32(k)


def box_blur(img: np.ndarray, radius: int) -> np.ndarray:
    """Three separable box passes, close to a gaussian blur of the given
    radius (webui blurs the inpainting mask by ``mask_blur``)."""
    r = max(1, int(radius))
    out = img.astype(np.float32)
    for _ in range(3):
        out = _box1d(out, r, 0)
        out = _box1d(out, r, 1)
    return out
