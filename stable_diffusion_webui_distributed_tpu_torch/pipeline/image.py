"""Host-side image helpers of img2img and inpainting, in numpy.

Port of the JAX package's ``_resize_image``, ``_box1d`` / ``_box_blur``
(``pipeline/engine.py``) and of the bilinear ``jax.image.resize`` they and
the mask path rely on. That resize antialiases when it shrinks an axis: its
triangle kernel is widened by the inverse scale and the weights of each
output sample are normalised to sum to 1 (``scale_and_translate``), which
``F.interpolate`` does not do with or without ``antialias=True``. So the
weight matrix is written here after JAX's algorithm, in f32 as JAX computes
it, and applied axis by axis.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

_EPS32 = float(np.finfo(np.float32).eps)


def bilinear_weights(in_size: int, out_size: int) -> np.ndarray:
    """``(in_size, out_size)`` f32 weights of ``jax.image.resize``'s
    antialiased linear kernel along one axis (``compute_weight_mat`` with
    no translation)."""
    scale = out_size / in_size
    inv_scale = np.float32(1.0 / scale)
    kernel_scale = np.maximum(inv_scale, np.float32(1.0))
    sample = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5))
              * inv_scale - np.float32(0.5))
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None]
               ) / kernel_scale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - x)
    total = w.sum(axis=0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000.0 * _EPS32,
                 w / np.where(total != 0, total, np.float32(1.0)),
                 np.float32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, np.float32(0.0)).astype(np.float32)


def resize_bilinear(img: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """``jax.image.resize(img, shape, "bilinear")`` for an f32 array: each
    axis whose size changes is contracted with :func:`bilinear_weights`,
    in axis order."""
    out = np.asarray(img, np.float32)
    for axis, n in enumerate(shape):
        m = out.shape[axis]
        if m == n:
            continue
        w = bilinear_weights(m, n)
        out = np.moveaxis(np.tensordot(out, w, axes=([axis], [0])), -1, axis)
    return out.astype(np.float32)


def resize_image(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """(H, W, C) f32 image -> (height, width, C); the same array when the
    size already matches."""
    if img.shape[0] == height and img.shape[1] == width:
        return img
    return resize_bilinear(img, (height, width, img.shape[2]))


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
