"""Device mesh construction: the axes the port places a model over.

Port of the JAX package's ``runtime/mesh.py``. The JAX package runs one
controller over a ``jax.sharding.Mesh`` of chips; the port's counterpart is
one process whose :class:`Mesh` is a numpy array of ``torch.device`` objects
under the axis names ``dp`` (batch rows), ``tp`` (tensor parallel inside
the UNet and the ControlNet) and ``sp`` (latent-token sequence parallel:
ring attention). ``--mesh "dp=4,tp=2"`` is parsed here (the flag is
registered in ``runtime/flags.py``). The placement itself is
``parallel/sharding.py``'s.

A device may appear more than once: a mesh whose entries are all
``cuda:0`` (or all ``cpu``) is a *virtual* mesh that runs every shard on
one device in turn, the port's counterpart of the JAX tests' virtual CPU
devices. On distinct cards the code is the same, and a tensor's move to
another shard's device is a copy over NVLink.

The JAX module's ``enable_compilation_cache`` has no counterpart: the port
compiles nothing per call signature (its kernels are ``nvcc`` libraries,
stored by ``serving/aot.py``).

**A mesh across processes.** :func:`init_multihost` joins a
``torch.distributed`` group (gloo, over TCP) when a coordinator is
configured, as the JAX function joins ``jax.distributed``: one process per
host drives that host's cards, and every process runs the same program.
:func:`build_mesh` then exchanges each process's device list and spans
their concatenation in rank order (JAX's order of ``jax.devices()``), so
``dp``, the outer axis, runs across the processes, and a replica's ``tp x
sp`` group may span them too, as GSPMD runs a global mesh (ROADMAP item
14e). :class:`Mesh` records the rank that owns each entry, each replica's
ranks and a group for each set of ranks that a collective runs over (a
replica's, and each ``tp`` row's ``sp`` ring); :meth:`Mesh.local` is this
process's share, the replicas in which it owns an entry. Every rank of a
replica computes its replicated layers and the shards it owns, and
``parallel/sharding.py``'s collectives fill in the other ranks' shards
over the replica's group. The group's backend is gloo on host tensors, on
the card too: two ranks may share one card, which NCCL refuses.
"""

from __future__ import annotations

import datetime
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from stable_diffusion_webui_distributed_tpu_torch.runtime.config import (
    env_int,
    env_str,
)

AXIS_ORDER = ("dp", "tp", "sp")

#: seconds a collective of the process group waits for a peer before it
#: raises, unless ``init_multihost`` is given another: torch.distributed's
#: own default for gloo. A rank that waits for another's pixels waits for
#: that rank's whole group of rows, so it must exceed the longest group's
#: time.
DEFAULT_TIMEOUT_S = 1800.0
#: the joined group's timeout, which the replicas' groups take too
_TIMEOUT = [DEFAULT_TIMEOUT_S]


class Mesh:
    """``devices``: a ``(dp, tp, sp)`` numpy array of ``torch.device``;
    ``shape``: ``{axis: size}`` in :data:`AXIS_ORDER`, as JAX's
    ``Mesh.shape``; ``ranks``: the process that owns each entry, an int
    array of ``devices``' shape (all 0 on one process); ``rank``: this
    process's; ``groups``: the ``torch.distributed`` group of each set of
    ranks (a sorted tuple) that a collective of a replica runs over
    (:func:`build_mesh` makes them). ``replica_ranks[r]`` is the sorted
    tuple of the processes that own an entry of replica ``r``, and
    ``local_replicas`` the replicas in which this process owns one."""

    axis_names = AXIS_ORDER

    def __init__(self, devices: np.ndarray, ranks: Optional[np.ndarray] = None,
                 rank: int = 0, groups: Optional[Dict[Tuple[int, ...],
                                                       Any]] = None):
        if devices.ndim != len(AXIS_ORDER):
            raise ValueError(f"a mesh is {len(AXIS_ORDER)}-D over "
                             f"{AXIS_ORDER}, not {devices.shape}")
        self.devices = devices
        self.shape: Dict[str, int] = dict(zip(AXIS_ORDER, devices.shape))
        self.ranks = (np.zeros(devices.shape, dtype=np.int64)
                      if ranks is None else ranks)
        self.rank = rank
        self.groups = {} if groups is None else groups
        self.replica_ranks: List[Tuple[int, ...]] = [
            tuple(sorted({int(q) for q in rep.flat})) for rep in self.ranks]
        self.local_replicas: List[int] = [
            r for r, qs in enumerate(self.replica_ranks) if rank in qs]
        self._local: Optional["Mesh"] = None

    @property
    def spans_processes(self) -> bool:
        """Whether the entries belong to more than one process."""
        return len(set(self.ranks.flat)) > 1

    def home(self, replica: Optional[int] = None) -> torch.device:
        """Replica ``replica``'s home device here: this process's first
        entry of it in ``(tp, sp)`` order (its ``tp`` and ``sp`` index 0
        on one process), where its rows enter and leave and where the
        layers the rule leaves replicated compute. None: this process's
        first replica (replica 0 on one process)."""
        if replica is None:
            replica = self.local_replicas[0]
        own = np.flatnonzero(self.ranks[replica].reshape(-1) == self.rank)
        flat = self.devices[replica].reshape(-1)
        return flat[own[0]] if len(own) else flat[0]

    def local(self) -> "Mesh":
        """The replicas in which this process owns an entry, as a mesh
        that keeps their ranks and groups (the mesh itself when it spans
        no other process)."""
        if not self.spans_processes:
            return self
        if self._local is None:
            self._local = Mesh(self.devices[self.local_replicas],
                               self.ranks[self.local_replicas], self.rank,
                               self.groups)
        return self._local

    def __repr__(self) -> str:
        devs = sorted({str(d) for d in self.devices.flat})
        if self.spans_processes:
            return (f"Mesh({self.shape}, devices={devs}, "
                    f"replica_ranks={self.replica_ranks}, rank={self.rank})")
        return f"Mesh({self.shape}, devices={devs})"


def across_processes(what: str, item: str = "14d") -> NotImplementedError:
    """The error of a path that does not run on a mesh across processes:
    it names the ROADMAP item that would port it."""
    return NotImplementedError(
        f"{what} does not run on a mesh across processes (ROADMAP item "
        f"{item}); it would compute unsplit rows on one rank")


def process_index() -> int:
    """This process's rank in the group (0 without one)."""
    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0


def process_count() -> int:
    """The processes of the group (1 without one)."""
    return dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1


def broadcast_object(obj: Any) -> Any:
    """Rank 0's ``obj`` on every rank (itself without a group): what every
    rank must agree on before it computes, such as a random seed."""
    if process_count() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def init_multihost(coordinator: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the processes of a mesh across hosts: False when no
    coordinator is configured (``SDTPU_COORDINATOR``), as in the JAX
    package, so a single host never pays it. With one, a gloo
    ``torch.distributed`` group over ``tcp://<coordinator>`` (process 0
    listens there) of ``num_processes`` (``SDTPU_NUM_PROCESSES``), this one
    ``process_id`` (``SDTPU_PROCESS_ID``); True once joined. torch has no
    cloud auto-detection, so both must be given. ``timeout_s``: how long
    a collective waits for a peer, so a dead or stuck rank makes the
    others raise instead of hang (the replicas' groups of
    :func:`build_mesh` wait as long). Joining twice is a no-op."""
    coordinator = coordinator or env_str("SDTPU_COORDINATOR") or None
    if not coordinator:
        return False
    n = num_processes if num_processes is not None else \
        env_int("SDTPU_NUM_PROCESSES")
    pid = process_id if process_id is not None else \
        env_int("SDTPU_PROCESS_ID")
    if n is None or pid is None:
        raise ValueError(
            f"coordinator {coordinator}: a process group needs its size and "
            f"this process's rank (SDTPU_NUM_PROCESSES, SDTPU_PROCESS_ID)")
    if not dist.is_initialized():
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator}", world_size=int(n),
            rank=int(pid), timeout=datetime.timedelta(seconds=timeout_s))
        _TIMEOUT[0] = timeout_s
    return True


def shutdown_multihost() -> None:
    """Leave the process group, if one was joined (JAX's
    ``jax.distributed.shutdown``)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def parse_mesh_spec(spec: Optional[str]) -> Dict[str, int]:
    """'dp=4,tp=2' -> {'dp': 4, 'tp': 2}. Empty/None -> {} (all devices on dp)."""
    if not spec:
        return {}
    out: Dict[str, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"bad mesh axis '{part}' (want name=size)")
        name, _, size = part.partition("=")
        name = name.strip()
        if name not in AXIS_ORDER:
            raise ValueError(f"unknown mesh axis '{name}' (known: {AXIS_ORDER})")
        out[name] = int(size)
        if out[name] <= 0:
            raise ValueError(f"mesh axis {name} must be positive")
    return out


def _visible_devices():
    """Every visible card; with none, this raises (a mesh never lands on
    the CPU unless its devices are named)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; name the mesh's devices (e.g. "
            "devices=['cpu'] * 8) to build one on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def build_mesh(spec: Optional[str] = None,
               devices: Optional[Sequence] = None) -> Mesh:
    """A :class:`Mesh` from a spec string over the given devices (names or
    ``torch.device`` objects; a device may repeat: a virtual mesh), or over
    every visible card.

    Under a group of processes (:func:`init_multihost`) ``devices`` names
    this process's devices: every rank's list is exchanged, and the mesh
    spans their concatenation in rank order. A replica's ``tp x sp`` group
    may span ranks (its collectives then run over a group of them, which
    every rank makes here in the same order); a spec that leaves a rank no
    entry raises (every rank raises alike).

    Unspecified axes get size 1; if no axes are given, every device lands
    on ``dp``. A spec that uses a subset whose size divides the device
    count takes the first devices; any other mismatch raises, with the JAX
    package's message."""
    devices = [torch.device(d) for d in (
        devices if devices is not None else _visible_devices())]
    rank, owners = process_index(), [0] * len(devices)
    if process_count() > 1:
        lists: List[Optional[List[str]]] = [None] * process_count()
        dist.all_gather_object(lists, [str(d) for d in devices])
        devices = [torch.device(d) for names in lists for d in names]
        owners = [q for q, names in enumerate(lists) for _ in names]
    axes = parse_mesh_spec(spec)
    if not axes:
        axes = {"dp": len(devices)}
    sizes = [axes.get(a, 1) for a in AXIS_ORDER]
    total = int(np.prod(sizes))
    if total != len(devices):
        # allow a spec that uses a subset (e.g. dp=4 of 8 devices)
        if total < len(devices) and len(devices) % total == 0:
            devices, owners = devices[:total], owners[:total]
        else:
            raise ValueError(
                f"mesh spec {axes} needs {total} devices, have {len(devices)}"
            )
    arr = np.empty(total, dtype=object)
    arr[:] = devices
    ranks = np.asarray(owners, dtype=np.int64).reshape(sizes)
    idle = sorted(set(range(process_count())) - set(ranks.flat))
    if idle:
        raise ValueError(f"mesh spec {axes}: processes {idle} would own no "
                         f"entry of the {total} devices it takes")
    return Mesh(arr.reshape(sizes), ranks, rank, _groups(ranks))


def _groups(ranks: np.ndarray) -> Dict[Tuple[int, ...], Any]:
    """A group for each set of ranks that a replica's collectives run
    over: each replica's and each of its ``tp`` rows' (an ``sp`` ring),
    where the set holds more than one rank. ``dist.new_group`` is a
    collective of every process, so every rank makes them in one order:
    the sets sorted; the whole group is the default one."""
    sets = set()
    for rep in ranks:
        sets.add(tuple(sorted({int(q) for q in rep.flat})))
        sets.update(tuple(sorted({int(q) for q in row})) for row in rep)
    world = tuple(range(process_count()))
    timeout = datetime.timedelta(seconds=_TIMEOUT[0])
    return {qs: (dist.group.WORLD if qs == world else
                 dist.new_group(list(qs), timeout=timeout))
            for qs in sorted(qs for qs in sets if len(qs) > 1)}


def pad_batch(n: int, mesh: Mesh) -> int:
    """Images to generate so the batch divides the dp axis: pad-and-drop,
    the replacement for the reference's remainder round-robin."""
    dp = mesh.shape["dp"]
    return ((n + dp - 1) // dp) * dp
