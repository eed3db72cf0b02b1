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
  :func:`ring_shift` (each block one step along the ring). Between the
  devices of one process they are ``.to(device, non_blocking=True)``
  copies and adds: the same code on one card and on several, where the
  copies go over NVLink.
- **Across processes** (a mesh that ``runtime/mesh.py``'s ``build_mesh``
  spans over the ranks of a ``torch.distributed`` group): each process
  places and runs only the replicas in which it owns an entry
  (:func:`replicas` gives None for the others), on its share of each
  group of rows (:func:`process_rows`: the rows of those replicas, or
  every row on replica 0's processes when the rows do not divide ``dp``).
  A replica whose ``tp x sp`` entries span processes runs as GSPMD runs
  it: every rank of it computes the replicated layers on its own home
  device and the shards it owns, holding their weights alone
  (:class:`Placement`), and :func:`gather`, :func:`reduce_sum` and
  :func:`reduce_max` take a :class:`Span`, whose :meth:`Span.fill` brings
  the other ranks' parts over the replica's group (one gloo all-gather of
  host bytes) before the parts are concatenated, summed or maxed in shard
  order, so every rank holds the one-process value bit for bit (an ``sp``
  ring needs no shift there: every rank holds K and V whole, and only its
  folded blocks are gathered). :func:`gather_rows` then
  gives every process every image, each replica's rows from one of its
  ranks. gloo on host tensors, on the card too: two ranks may share one
  card, which NCCL refuses.

JAX's ``keystr_path`` has no counterpart (state-dict keys are strings).
``batch_concat`` and ``channel_concat`` work around an XLA partitioner
bug and have nothing to port.
"""

from __future__ import annotations

import copy
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, \
    Tuple

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


class Span:
    """The parts of one collective across the processes of a replica:
    ``owners[j]``, the rank that computes part ``j`` for the others;
    ``holders[j]``, every rank that computes it (its owner, and a rank
    that needs it itself, such as each rank of a ``tp`` shard's ``sp``
    ring); ``rank``, this process's; ``group``, the ``torch.distributed``
    group of every holder. ``calls`` and ``seconds`` count the exchanges
    of every span and their host seconds."""

    calls = 0
    seconds = 0.0

    def __init__(self, owners: Sequence[int],
                 holders: Sequence[Sequence[int]], rank: int, group: Any):
        self.owners = tuple(owners)
        self.holders = tuple(frozenset(h) for h in holders)
        self.rank = rank
        self.group = group
        self.ranks = sorted(set().union(*self.holders))
        # every rank computes every part: a collective has nothing to fill
        # (decided from the structure, which every rank sees alike, so the
        # ranks enter each exchange together)
        self.complete = all(h == set(self.ranks) for h in self.holders)

    def local(self, j: int) -> bool:
        """Whether this process computes part ``j``."""
        return self.rank in self.holders[j]

    def fill(self, parts: Sequence[Optional[torch.Tensor]]
             ) -> List[torch.Tensor]:
        """``parts`` with each absent entry (None: another rank's) filled
        in from its owner: one all-gather over the group of the bytes of
        each rank's owned parts, in host memory. Every part has one shape
        and dtype (shards of one split), so a rank's buffer is its owned
        parts' bytes, padded to the most parts a rank owns."""
        ref = next(p for p in parts if p is not None)
        size = ref.numel() * ref.element_size()
        slots = {q: [j for j, o in enumerate(self.owners) if o == q]
                 for q in self.ranks}
        # pinned on the card (the host allocator caches the blocks): one
        # copy each way, at the DMA engines' rate
        shape = (max(len(v) for v in slots.values()), size)
        send, *got = (torch.empty(shape, dtype=torch.uint8,
                                  pin_memory=ref.is_cuda)
                      for _ in range(1 + len(self.ranks)))
        for i, j in enumerate(slots[self.rank]):
            send[i].copy_(parts[j].detach().contiguous().reshape(-1)
                          .view(torch.uint8))
        t0 = time.perf_counter()
        dist.all_gather(got, send, group=self.group)
        Span.calls += 1
        Span.seconds += time.perf_counter() - t0
        out = list(parts)
        for j, q in enumerate(self.owners):
            if out[j] is None:
                row = got[self.ranks.index(q)][slots[q].index(j)]
                # on the local part's device, in its memory layout: the ops
                # that take the parts then run as they run on one process
                out[j] = torch.empty_like(ref).copy_(
                    row.view(ref.dtype).reshape(ref.shape))
        return out


def filled(parts: Sequence[Optional[torch.Tensor]],
           span: Optional[Span]) -> Sequence[Optional[torch.Tensor]]:
    """``parts``, under ``span`` with the other ranks' filled in
    (:meth:`Span.fill`) unless every rank computes every part. Every rank
    of the span calls it at the same point, whatever parts it holds."""
    return parts if span is None or span.complete else span.fill(parts)


def gather(parts: Sequence[Optional[torch.Tensor]], dim: int,
           device: torch.device, span: Optional[Span] = None
           ) -> torch.Tensor:
    """The concatenation of ``parts`` along ``dim`` on ``device`` (under
    ``span``, the absent ones filled in from their ranks)."""
    return torch.cat([p.to(device, non_blocking=True)
                      for p in filled(parts, span)], dim)


def reduce_sum(parts: Sequence[Optional[torch.Tensor]],
               device: torch.device,
               span: Optional[Span] = None) -> torch.Tensor:
    """The sum of ``parts`` on ``device``, added in order (under ``span``
    the absent ones are filled in from their ranks first, so every rank
    adds in shard order)."""
    parts = filled(parts, span)
    out = parts[0].to(device, non_blocking=True)
    for p in parts[1:]:
        out = out + p.to(device, non_blocking=True)
    return out


def reduce_max(parts: Sequence[Optional[torch.Tensor]],
               device: torch.device,
               span: Optional[Span] = None) -> torch.Tensor:
    """The elementwise max of ``parts`` on ``device`` (``lax.pmax``;
    ``span`` as for :func:`reduce_sum`)."""
    parts = filled(parts, span)
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


class Ring(list):
    """An ``sp`` ring's devices; ``span``: its positions' ranks when they
    belong to more than one process (each position is its owner's)."""

    span: Optional[Span] = None


class Layout(tuple):
    """A replica's ``(tp, sp)`` devices as nested tuples, whose entries
    belong to more than one process: ``owners``, the rank of each entry
    (nested likewise); ``rank``, this process's; ``groups``, the mesh's
    groups by their sorted ranks (``runtime/mesh.py`` ``build_mesh``)."""

    owners: Tuple[Tuple[int, ...], ...] = ()
    rank = 0
    groups: Dict[Tuple[int, ...], Any] = {}


def replica_layout(mesh, replica: int) -> Tuple[Tuple[torch.device, ...],
                                               ...]:
    """Replica ``replica``'s ``(tp, sp)`` devices as nested tuples: two
    replicas with one layout can share one placed module. A replica whose
    entries span processes gives a :class:`Layout`, which also names
    their ranks."""
    rows = tuple(tuple(row) for row in mesh.devices[replica])
    owners = tuple(tuple(int(q) for q in row) for row in mesh.ranks[replica])
    if len({q for row in owners for q in row}) == 1:
        return rows
    layout = Layout(rows)
    layout.owners, layout.rank, layout.groups = owners, mesh.rank, \
        mesh.groups
    return layout


def _owners(layout) -> Optional[Tuple[Tuple[int, ...], ...]]:
    return getattr(layout, "owners", None) or None


def layout_key(layout) -> Tuple:
    """What two replicas must share to share one placed module: the
    devices, and across processes the ranks that own them."""
    return (layout, _owners(layout))


def layout_home(layout) -> torch.device:
    """The layout's home device here: this process's first entry of it
    (the first entry on one process)."""
    owners = _owners(layout)
    if owners is None:
        return layout[0][0]
    return next(d for row, qs in zip(layout, owners)
                for d, q in zip(row, qs) if q == layout.rank)


def placement(layout) -> Tuple[torch.device, List[Optional[torch.device]],
                               List[Optional[Ring]], Optional[Span]]:
    """What this process computes of a replica's layout: ``(home,
    devices, rings, span)``. ``devices[j]``: where ``tp`` shard ``j``
    computes (its row's first entry; across processes this rank's first
    entry of the row, or None where it owns none); ``rings[j]``: the row's
    ``sp`` ring (None for one entry; a rank outside a row that spans
    ranks folds that row's ring whole on its home device); ``span``: the
    ``tp`` shards' ranks across processes (a shard's owner is the rank of
    its row's first entry, its holders every rank of the row), else
    None."""
    owners = _owners(layout)
    home = layout_home(layout)
    if owners is None:
        return home, [row[0] for row in layout], [
            Ring(row) if len(row) > 1 else None for row in layout], None
    rank, groups = layout.rank, layout.groups
    devices, rings = [], []
    for row, qs in zip(layout, owners):
        own = [d for d, q in zip(row, qs) if q == rank]
        devices.append(own[0] if own else None)
        ring = None
        if len(row) > 1:
            ranks = tuple(sorted(set(qs)))
            if rank not in ranks:
                ring = Ring([home] * len(row))
            else:
                ring = Ring(row)
                if len(ranks) > 1:
                    ring.span = Span(qs, [(q,) for q in qs], rank,
                                     groups[ranks])
        rings.append(ring)
    ranks = tuple(sorted({q for qs in owners for q in qs}))
    span = Span([qs[0] for qs in owners], owners, rank, groups[ranks])
    return home, devices, rings, span


def one_device(layout) -> bool:
    """Whether every shard of the layout lies on one device of this
    process: only then can an evaluation on it be one CUDA graph (a
    capture runs on one device, and never around a collective)."""
    return _owners(layout) is None and \
        len({d for row in layout for d in row}) == 1


def home_layout(mesh):
    """The layout of the modules that run on the home device over every
    row (the text encoders, the VAE encoder): this process's first
    replica's (replica 0's on one process). Across processes a replica's
    ranks compute them together only where it is the first replica of
    each of them; otherwise this process computes each of its shards
    itself, on its home device (the same values: a collective carries
    bits)."""
    first = mesh.local_replicas[0]
    ranks = mesh.replica_ranks[first]
    if all(min(r for r, qs in enumerate(mesh.replica_ranks) if q in qs)
           == first for q in ranks):
        return replica_layout(mesh, first)
    home = mesh.home(first)
    return tuple((home,) * len(row) for row in mesh.devices[first])


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
    across processes a replica in which this process owns no entry is
    None: it holds no weights here; one that spans processes is placed
    over this process's shards of it (:func:`placement`)."""
    own = next(iter(module.parameters())).device
    by_layout: Dict[Tuple, Tuple[Tuple, nn.Module]] = {}
    owned = set(mesh.local_replicas)
    for r in sorted(owned):
        layout = replica_layout(mesh, r)
        key = layout_key(layout)
        if key not in by_layout:
            home = layout_home(layout)
            mine = reuse and home == own and \
                not any(m is module for _, m in by_layout.values())
            by_layout[key] = (layout, module if mine else
                              module_on(module, home))
    if place is not None:
        for layout, m in by_layout.values():
            place(m, layout)
    return [by_layout[layout_key(replica_layout(mesh, r))][1]
            if r in owned else None for r in range(mesh.shape["dp"])]


def process_rows(mesh, rows: int,
                 whole: bool = False) -> List[Tuple[int, int]]:
    """Each process's rows ``[lo, hi)`` of a group of ``rows`` image rows
    on ``mesh``, by rank: the rows of the replicas in which it owns an
    entry when they divide ``dp`` (a process's replicas are consecutive,
    so are its rows; every rank of a replica that spans processes takes
    its rows), else, or with ``whole``, every row on replica 0's
    processes and none on the others (the JAX package's odd-batch
    fallback). One process takes every row."""
    count = int(mesh.ranks.max()) + 1
    dp = mesh.shape["dp"]
    if whole or rows % dp:
        return [(0, rows) if q in mesh.replica_ranks[0] else (0, 0)
                for q in range(count)]
    blk = rows // dp
    out = []
    for q in range(count):
        mine = [r for r, qs in enumerate(mesh.replica_ranks) if q in qs]
        out.append((mine[0] * blk, (mine[-1] + 1) * blk))
    return out


def _sources(shares: Sequence[Tuple[int, int]]) -> List[Tuple[int, int, int]]:
    """The rows of a group as runs ``(lo, hi, rank)``, in row order, each
    from the lowest rank whose share holds it."""
    cuts = sorted({b for s in shares for b in s})
    runs: List[Tuple[int, int, int]] = []
    for lo, hi in zip(cuts, cuts[1:]):
        src = min(q for q, (a, b) in enumerate(shares) if a <= lo and hi <= b)
        if runs and runs[-1][2] == src:
            runs[-1] = (runs[-1][0], hi, src)
        else:
            runs.append((lo, hi, src))
    return runs


def gather_rows(local: torch.Tensor,
                shares: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """The rows of every process in row order, on every process, from this
    process's ``local`` rows (a host tensor; ``shares``: each rank's ``[lo,
    hi)`` of :func:`process_rows`). Each run of rows comes from the lowest
    rank that holds it, over the default group (gloo): nothing when every
    process holds every row, an all-gather when each rank sends one run
    of one size, else a broadcast from each run's rank."""
    rank = dist.get_rank()
    lo = shares[rank][0]
    runs = _sources(shares)
    if len(runs) == 1 and all(s == (runs[0][0], runs[0][1])
                              for s in shares):
        return local
    shape = tuple(local.shape[1:])
    sizes = {hi - a for a, hi, _ in runs}
    if [q for _, _, q in runs] == list(range(len(shares))) and \
            len(sizes) == 1:
        a, hi, _ = runs[rank]
        parts = [torch.empty((hi - a, *shape), dtype=local.dtype)
                 for _ in runs]
        dist.all_gather(parts, local[a - lo:hi - lo].contiguous())
        return torch.cat(parts)
    out = torch.empty((runs[-1][1] - runs[0][0], *shape), dtype=local.dtype)
    for a, hi, q in runs:
        part = out[a:hi]
        if q == rank:
            part.copy_(local[a - lo:hi - lo])
        dist.broadcast(part, src=q)
    return out


def any_process(flag: bool) -> bool:
    """Whether ``flag`` holds on any process of the default group: a flag
    that the ranks which ran a group of rows carry to the others with its
    pixels."""
    t = torch.tensor([int(flag)], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def released(t: torch.Tensor) -> bool:
    """Whether ``t`` is a parameter a placement across processes released
    (:meth:`Placement.release`): its shape over one element."""
    return t.dim() > 0 and t.numel() > 1 and not any(t.stride())


class Placement:
    """Base of a layer's placement on its shards (``models/unet.py``).
    ``split``: each parameter it splits, ``(param, dim, pieces)``, the
    parameter being ``blocks`` equal blocks along ``dim`` and
    ``pieces[b][j]`` shard ``j``'s cut of block ``b`` (None where another
    process computes the shard). On one process the pieces are views of
    the layer's weights, so a copy of the module copies none of it
    (:func:`module_on` re-places the copy). Across processes (``span``)
    they are copies of this process's shards alone, and
    :meth:`release` then frees the layer's whole parameters: the process
    holds its own shards and the layers that are not split, nothing more.
    :meth:`restore` gathers them back before the placement goes."""

    span: Optional[Span] = None
    #: the split parameters are released (:meth:`release`)
    held_only = False

    def __deepcopy__(self, memo):
        return None

    def take(self, param: torch.Tensor, devices, dim: int,
             blocks: int = 1) -> List[Optional[Tuple[torch.Tensor, ...]]]:
        """Each shard's cuts of ``param``'s ``blocks`` (see ``split``) on
        its device, None where ``devices[j]`` is None."""
        n = len(devices)
        cuts = [b.chunk(n, dim) for b in param.chunk(blocks, dim)]
        pieces = [[None if d is None else
                   c[j].to(d, copy=self.span is not None)
                   for j, d in enumerate(devices)] for c in cuts]
        if not hasattr(self, "split"):
            self.split = []
        self.split.append((param, dim, pieces))
        return [None if d is None else tuple(p[j] for p in pieces)
                for j, d in enumerate(devices)]

    def release(self) -> None:
        """Across processes, free the split parameters' whole weights (a
        shape over one element stands in for each)."""
        if self.span is None:
            return
        self.held_only = True
        for param, _, _ in self.split:
            param.data = torch.empty((), dtype=param.dtype,
                                     device=param.device).expand(param.shape)

    def restore(self) -> None:
        """The split parameters' whole weights back from every rank's
        pieces (a collective over the span: every rank of it restores the
        same placements in the same order)."""
        if not self.held_only:
            return
        self.held_only = False
        for param, dim, pieces in self.split:
            param.data = torch.cat(
                [torch.cat([p.to(param.device) for p in
                            filled(block, self.span)], dim)
                 for block in pieces], dim)
