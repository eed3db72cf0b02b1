"""Placement over a mesh: rows over ``dp``, Megatron-pattern weights over
``tp``, and the plain tensor collectives between a mesh's devices.

Port of the JAX package's ``parallel/sharding.py``. The JAX package annotates
its parameter tree and its batch with shardings and lets XLA's partitioner
insert the collectives. The port runs one process over a
:class:`~..runtime.mesh.Mesh` of ``torch.device`` objects, so its placement is
explicit:

- **dp.** Each replica (a ``dp`` index) holds the model on its home device
  (``Mesh.home``) and runs its block of rows; :func:`place_batch` splits
  rows (:func:`batch_block` takes a replica's rows of each half of an
  evaluation's ``[uncond; cond]`` batch, :func:`write_block` puts them
  back in order), :func:`replicate` puts a tensor on every replica's
  home, and :func:`replicas` gives each replica its module. Replicas whose
  devices agree share one module, so a virtual mesh holds the weights
  once.
- **tp.** :func:`tp_spec_for` classes each parameter by its name as JAX's
  rule classes the Flax path it came from: column-parallel (output
  features split), row-parallel (input features split) or replicated. The
  port's Linear weight is ``(out, in)`` and its conv weight OIHW, so a
  column split is on dim 0 and a row split on dim 1. :func:`shard_params`
  gives each parameter's shards on a replica's ``tp`` devices (views of
  the weight where a shard lands on its device, so a virtual mesh copies
  nothing), a dimension that does not divide by ``tp`` replicated, as in
  JAX. The layers of every model (the UNet, the ControlNets, the text
  encoders and both halves of the VAE) compute on their shards
  (``models/unet.py`` ``place_layers``).
- **Collectives**, with the JAX meaning: :func:`gather` (column slices to
  one device), :func:`reduce_sum` (partials summed onto one device),
  :func:`reduce_max` (an int8 row product's scales from its shards) and
  :func:`ring_shift` (each block one step along the ring). They are
  ``.to(device, non_blocking=True)`` copies and adds: the same code on one
  card and on several, where the copies go over NVLink. One process
  drives every device of a replica, so they need no collective library.
- **Across processes** (a mesh that ``runtime/mesh.py``'s ``build_mesh``
  spans over the ranks of a ``torch.distributed`` group): each process
  places and runs only the replicas it owns (:func:`replicas` gives None
  for the others), on its share of each group of rows
  (:func:`process_rows`: a block of ``dp`` replicas' rows, or every row
  on replica 0's process when the rows do not divide ``dp``). The one
  collective is :func:`gather_rows`: the uint8 pixels of each share, in
  host memory, gathered over the group (gloo) so that every process holds
  every row. A ``tp`` or ``sp`` group across processes, whose copies
  above would become NCCL collectives, is ROADMAP item 14e.

JAX's ``keystr_path`` has no counterpart (state-dict keys are strings).
``batch_concat`` and ``channel_concat`` work around an XLA partitioner
bug and have nothing to port.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

_COLUMN_ENDINGS = ("qkv", "q", "kv", "fc1", "proj", "time_fc1", "add_fc1",
                   "time_proj", "proj_in")
_ROW_ENDINGS = ("out_proj", "fc2", "ff_out", "time_fc2", "add_fc2",
                "proj_out")

#: a parameter's spec: per dimension of the port's tensor, "tp" or None
Spec = Tuple[Optional[str], ...]


def _leaf_kind(parts: Sequence[str], ndim: int) -> str:
    """The Flax leaf a port parameter came from (``bridge.py``: kernel,
    scale and embedding all became ``weight``)."""
    leaf = parts[-1]
    if leaf != "weight":
        return leaf
    if ndim == 1:
        return "scale"
    module = parts[-2] if len(parts) > 1 else ""
    return "embedding" if module.endswith("embedding") else "kernel"


def tp_spec_for(path: str, ndim: int) -> Spec:
    """The spec of one parameter from its state-dict name (joined with
    '.'): JAX's rule over the Flax path it came from, on the port's
    layout. Kernels of the row endings split their input features, of the
    column endings, a ``conv`` module or any other kernel their output
    features; a column module's bias splits with it; norms, embeddings and
    other biases are replicated."""
    parts = path.strip(".").split(".")
    kind = _leaf_kind(parts, ndim)
    module = parts[-2] if len(parts) > 1 else ""
    if kind == "kernel":
        if module in _ROW_ENDINGS:
            return (None, "tp") + (None,) * (ndim - 2)
        if ndim >= 2:
            # column endings, conv modules and any other kernel: column
            # parallel (JAX's default, safe: the output is gathered)
            return ("tp",) + (None,) * (ndim - 1)
    if kind == "bias" and module in _COLUMN_ENDINGS:
        return ("tp",)
    return (None,) * ndim


def shard_dim(path: str, t: torch.Tensor, tp: int) -> Optional[int]:
    """The dimension of ``t`` split over ``tp`` devices, or None when it
    is replicated: by its class, or because the dimension does not divide
    (JAX's rule)."""
    if tp <= 1:
        return None
    spec = tp_spec_for(path, t.dim())
    if "tp" not in spec:
        return None
    dim = spec.index("tp")
    return dim if t.shape[dim] % tp == 0 else None


def shard_params(params: Mapping[str, torch.Tensor], mesh,
                 replica: int = 0) -> Dict[str, List[torch.Tensor]]:
    """Each parameter's shards on replica ``replica``'s ``tp`` devices, in
    ``tp`` order: a split parameter's slices, a replicated one whole on
    each device. A shard on the device its parameter lies on is a view."""
    devs = list(mesh.devices[replica, :, 0])
    tp = len(devs)
    out = {}
    for name, t in params.items():
        dim = shard_dim(name, t, tp)
        parts = t.chunk(tp, dim) if dim is not None else [t] * tp
        out[name] = [p.to(d) for p, d in zip(parts, devs)]
    return out


def batch_block(x: torch.Tensor, r: int, dp: int,
                rows: int) -> torch.Tensor:
    """Replica ``r``'s block (of ``dp``) of a batch-major tensor whose
    first axis holds ``rows`` image rows or a multiple of them (an
    evaluation's ``[uncond; cond]`` doubling): its rows of each part, the
    parts kept in order, so every replica's block has the doubled layout
    of a batch of ``rows / dp``."""
    if dp == 1:
        return x
    return x.unflatten(0, (x.shape[0] // rows, dp, rows // dp))[:, r] \
        .flatten(0, 1)


def write_block(out: Optional[torch.Tensor], block: torch.Tensor, r: int,
                dp: int, rows: int, device: torch.device) -> torch.Tensor:
    """The inverse of :func:`batch_block`: writes replica ``r``'s block of
    an output of ``rows`` image rows (or a multiple) into ``out``, the
    whole output on ``device``, allocated at the first block written."""
    blk = rows // dp
    parts = block.shape[0] // blk
    if out is None:
        out = torch.empty((parts * rows, *block.shape[1:]),
                          dtype=block.dtype, device=device)
    out.unflatten(0, (parts, dp, blk))[:, r].copy_(
        block.unflatten(0, (parts, blk)), non_blocking=True)
    return out


def place_batch(x: torch.Tensor, mesh) -> List[torch.Tensor]:
    """Rows split over ``dp``: block ``r`` on replica ``r``'s home device.
    The rows must divide ``dp``."""
    dp = mesh.shape["dp"]
    if x.shape[0] % dp:
        raise ValueError(f"{x.shape[0]} rows do not divide dp={dp}")
    return [batch_block(x, r, dp, x.shape[0]).to(mesh.home(r),
                                                 non_blocking=True)
            for r in range(dp)]


def replicate(x: torch.Tensor, mesh) -> List[torch.Tensor]:
    """``x`` on every replica's home device."""
    return [x.to(mesh.home(r), non_blocking=True)
            for r in range(mesh.shape["dp"])]


def gather(parts: Sequence[torch.Tensor], dim: int,
           device: torch.device) -> torch.Tensor:
    """The concatenation of ``parts`` along ``dim`` on ``device``."""
    return torch.cat([p.to(device, non_blocking=True) for p in parts], dim)


def reduce_sum(parts: Sequence[torch.Tensor],
               device: torch.device) -> torch.Tensor:
    """The sum of ``parts`` on ``device``, added in order."""
    out = parts[0].to(device, non_blocking=True)
    for p in parts[1:]:
        out = out + p.to(device, non_blocking=True)
    return out


def reduce_max(parts: Sequence[torch.Tensor],
               device: torch.device) -> torch.Tensor:
    """The elementwise max of ``parts`` on ``device`` (``lax.pmax``)."""
    out = parts[0].to(device, non_blocking=True)
    for p in parts[1:]:
        out = torch.maximum(out, p.to(device, non_blocking=True))
    return out


def ring_shift(blocks: Sequence[torch.Tensor],
               devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """One step of the ring: the block of device ``i`` moves to device
    ``i + 1`` (``lax.ppermute`` with ``perm = [(i, (i + 1) % n)]``)."""
    n = len(blocks)
    return [blocks[(i - 1) % n].to(devices[i], non_blocking=True)
            for i in range(n)]


def replica_layout(mesh, replica: int) -> Tuple[Tuple[torch.device, ...],
                                               ...]:
    """Replica ``replica``'s ``(tp, sp)`` devices as nested tuples: two
    replicas with one layout can share one placed module."""
    return tuple(tuple(row) for row in mesh.devices[replica])


def one_device(layout) -> bool:
    """Whether every shard of the layout lies on one device: only then
    can an evaluation on it be one CUDA graph (a capture runs on one
    device)."""
    return len({d for row in layout for d in row}) == 1


def module_on(module: nn.Module, device: torch.device) -> nn.Module:
    """A copy of ``module`` whose parameters and buffers lie on
    ``device``: the same tensors where they already do (a second placement
    of one module on its own device copies no weight)."""
    memo = {}
    for t in list(module.parameters()) + list(module.buffers()):
        moved = t.detach().to(device)
        memo[id(t)] = (nn.Parameter(moved, requires_grad=False)
                       if isinstance(t, nn.Parameter) else moved)
    return copy.deepcopy(module, memo)


def replicas(module: nn.Module, mesh,
             place: Optional[Callable[[nn.Module, Optional[Tuple]], None]]
             = None, reuse: bool = True) -> List[Optional[nn.Module]]:
    """One module per ``dp`` replica, on the replica's home device, with
    ``place(module, layout)`` attaching the ``tp`` and ``sp`` placement of
    its layout (``place(module, None)`` removes one). Replicas of one
    layout share one module. With ``reuse`` the first layout on the
    module's own device takes the module itself; the others (and every
    one without ``reuse``) take copies (:func:`module_on`: the weights
    are shared where the copy lies on their device). A placement is never
    copied with a module (its ``__deepcopy__`` gives None). On a mesh
    across processes a replica that another process owns is None: it
    holds no weights here."""
    own = next(iter(module.parameters())).device
    by_layout: Dict[Tuple, nn.Module] = {}
    owned = set(mesh.local_replicas)
    for r in sorted(owned):
        layout = replica_layout(mesh, r)
        if layout not in by_layout:
            home = layout[0][0]
            mine = reuse and home == own and \
                not any(m is module for m in by_layout.values())
            by_layout[layout] = module if mine else module_on(module, home)
    if place is not None:
        for layout, m in by_layout.items():
            place(m, layout)
    return [by_layout[replica_layout(mesh, r)] if r in owned else None
            for r in range(mesh.shape["dp"])]


def process_rows(mesh, rows: int,
                 whole: bool = False) -> List[Tuple[int, int]]:
    """Each process's rows ``[lo, hi)`` of a group of ``rows`` image rows
    on ``mesh``, by rank: the rows of the replicas it owns when they
    divide ``dp`` (a process's replicas are consecutive, so are its
    rows), else, or with ``whole``, every row on replica 0's process and
    none on the others (the JAX package's odd-batch fallback, which a
    batch-wide controller such as DPM adaptive's takes too). One process
    takes every row."""
    count = max(mesh.replica_ranks) + 1
    dp = mesh.shape["dp"]
    if whole or rows % dp:
        return [(0, rows) if q == mesh.replica_ranks[0] else (0, 0)
                for q in range(count)]
    blk = rows // dp
    out = []
    for q in range(count):
        mine = [r for r, owner in enumerate(mesh.replica_ranks) if owner == q]
        out.append((mine[0] * blk, (mine[-1] + 1) * blk))
    return out


def gather_rows(local: torch.Tensor,
                shares: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """The rows of every process in row order, on every process, from this
    process's ``local`` rows (a host tensor; ``shares``: each rank's ``[lo,
    hi)`` of :func:`process_rows`, in which the ranks' rows follow one
    another). One gloo collective over the default group: an all-gather
    when every share has one size, else a broadcast from each rank that
    has rows."""
    sizes = [hi - lo for lo, hi in shares]
    shape = tuple(local.shape[1:])
    if len(set(sizes)) == 1:
        parts = [torch.empty((sizes[0], *shape), dtype=local.dtype)
                 for _ in sizes]
        dist.all_gather(parts, local.contiguous())
        return torch.cat(parts)
    out = torch.empty((sum(sizes), *shape), dtype=local.dtype)
    at = 0
    for q, n in enumerate(sizes):
        if n:
            part = out[at:at + n]
            if q == dist.get_rank():
                part.copy_(local)
            dist.broadcast(part, src=q)
        at += n
    return out


class Placement:
    """Base of a layer's placement on its shards (``models/unet.py``): it
    holds views of the layer's weights, so a copy of the module copies
    none of it (:func:`module_on` re-places the copy)."""

    def __deepcopy__(self, memo):
        return None
