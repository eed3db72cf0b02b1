"""Ring attention: sequence parallelism over a mesh's ``sp`` axis.

Port of the JAX package's ``ops/ring_attention.py`` (which has no Pallas
kernel: its body is ``einsum`` and ``exp``). The tokens of Q, K and V are
split over the ring's devices; each device folds its query block against
the K/V blocks that rotate round the ring (``parallel/sharding.py``
:func:`~..parallel.sharding.ring_shift`, the ``lax.ppermute`` of the JAX
body), in the ``(m, l, acc)`` online softmax in f32. Device ``i`` folds the
blocks in the JAX order, ``i, i - 1, ...``, so the float sums run as JAX
runs them. Across processes (a ring whose positions belong to more than one
rank) each rank holds K and V whole, folds its own positions' query blocks
against their blocks in the same order without a shift, and only the final
gather crosses the ring's group.

Each block is folded in key chunks of at most ``SDTPU_RING_CHUNK`` (default
1024, at least 128): the score buffer is ``(b, h, t_loc, chunk)``, not
``(b, h, t_loc, t_loc)``. A chunk that does not divide the block pads it
and masks the padded keys to ``-inf``.

The fold is plain PyTorch on every device, the card included: kernel K1
returns no log-sum-exp, so a ring step cannot be K1 as it stands. A fold on
a kernel that returns one is ROADMAP item 14.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch

from stable_diffusion_webui_distributed_tpu_torch.parallel.sharding import (
    Span,
    gather,
    ring_shift,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.config import (
    env_int,
)

_RING_CHUNK_DEFAULT = 1024


def _ring_chunk() -> int:
    """Upper bound on the key chunk folded per inner step
    (``SDTPU_RING_CHUNK``, default 1024, at least 128)."""
    return max(128, env_int("SDTPU_RING_CHUNK", _RING_CHUNK_DEFAULT))


class _Fold:
    """One device's running ``(m, l, acc)`` over its query block, scaled
    in f32 (``_ring_body``'s carry)."""

    def __init__(self, q: torch.Tensor, scale: float):
        b, t, h, d = q.shape
        self.dtype = q.dtype
        self.qf = q.float() * scale
        self.m = torch.full((b, h, t, 1), -math.inf, dtype=torch.float32,
                            device=q.device)
        self.l = torch.zeros((b, h, t, 1), dtype=torch.float32,
                             device=q.device)
        self.acc = torch.zeros((b, h, t, d), dtype=torch.float32,
                               device=q.device)

    def fold(self, k: torch.Tensor, v: torch.Tensor) -> None:
        """Folds one K/V block ``(b, s, h, d)`` in key chunks."""
        s_loc = k.shape[1]
        chunk = min(_ring_chunk(), s_loc)
        n_chunks = -(-s_loc // chunk)
        pad = n_chunks * chunk - s_loc
        if pad:
            k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
            v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        valid = torch.arange(n_chunks * chunk, device=k.device) < s_loc
        for c in range(n_chunks):
            sl = slice(c * chunk, (c + 1) * chunk)
            s = torch.einsum("bthd,bshd->bhts", self.qf, k[:, sl].float())
            if pad:
                s = torch.where(valid[sl], s, -math.inf)
            m_new = torch.maximum(self.m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(self.m - m_new)
            self.l = self.l * alpha + p.sum(dim=-1, keepdim=True)
            self.acc = self.acc * alpha + torch.einsum(
                "bhts,bshd->bhtd", p, v[:, sl].float())
            self.m = m_new

    def result(self) -> torch.Tensor:
        return (self.acc / self.l).transpose(1, 2).to(self.dtype)


def ring_attention_over(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        devices: Sequence[torch.device],
                        scale: Optional[float] = None,
                        span: Optional[Span] = None) -> torch.Tensor:
    """Attention of ``(B, T, H, D)`` tensors with their tokens split over
    the ring ``devices`` (T must divide their count); the result
    ``(B, T, H, D)`` in q's dtype on q's device. ``span``: the ring's
    positions' ranks when they belong to more than one process: this
    process folds the query blocks of its own positions against the K/V
    blocks it holds, and the final gather fills in the other ranks'
    results over the ring's group, so every rank holds the whole
    result."""
    n = len(devices)
    if q.shape[1] % n or k.shape[1] % n:
        raise ValueError(f"{q.shape[1]} queries or {k.shape[1]} keys do not "
                         f"divide a ring of {n}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])

    if span is not None:
        # every rank holds K and V whole: its positions fold the blocks in
        # the ring's order from them, and only the results cross processes
        kb, vb = k.chunk(n, 1), v.chunk(n, 1)
        outs = []
        for i, (b, d) in enumerate(zip(q.chunk(n, 1), devices)):
            if not span.local(i):
                outs.append(None)
                continue
            f = _Fold(b.to(d, non_blocking=True), scale)
            for step in range(n):
                j = (i - step) % n
                f.fold(kb[j].to(d, non_blocking=True),
                       vb[j].to(d, non_blocking=True))
            outs.append(f.result())
        return gather(outs, 1, q.device, span)
    folds = [_Fold(b.to(d, non_blocking=True), scale)
             for b, d in zip(q.chunk(n, 1), devices)]
    ks: List[torch.Tensor] = [b.to(d, non_blocking=True)
                              for b, d in zip(k.chunk(n, 1), devices)]
    vs: List[torch.Tensor] = [b.to(d, non_blocking=True)
                              for b, d in zip(v.chunk(n, 1), devices)]
    for step in range(n):
        for f, kb, vb in zip(folds, ks, vs):
            f.fold(kb, vb)
        if step + 1 < n:
            ks, vs = ring_shift(ks, devices), ring_shift(vs, devices)
    return gather([f.result() for f in folds], 1, q.device)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh, axis_name: str = "sp",
                   scale: Optional[float] = None) -> torch.Tensor:
    """Sequence-parallel attention over ``mesh``'s ``sp`` ring on global
    ``(B, T, H, D)`` tensors, the batch split over ``dp`` when the mesh has
    one (it must divide), each replica's rows on its ring
    (``mesh.devices[r, 0, :]``); the result on q's device."""
    if axis_name != "sp":
        raise ValueError(f"the port's ring runs over sp, not {axis_name!r}")
    dp = mesh.shape["dp"]
    if q.shape[0] % dp:
        raise ValueError(f"batch {q.shape[0]} does not divide dp={dp}")
    rows = [ring_attention_over(qb, kb, vb, list(mesh.devices[r, 0, :]),
                                scale)
            for r, (qb, kb, vb) in enumerate(zip(q.chunk(dp), k.chunk(dp),
                                                 v.chunk(dp)))]
    return gather(rows, 0, q.device)
