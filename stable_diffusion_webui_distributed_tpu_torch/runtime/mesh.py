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
stored by ``serving/aot.py``). A mesh across hosts (``init_multihost``
with a coordinator) would be ``torch.distributed`` with one process per
card; it is ROADMAP item 14 and raises here.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from stable_diffusion_webui_distributed_tpu_torch.runtime.config import (
    env_int,
    env_str,
)

AXIS_ORDER = ("dp", "tp", "sp")


class Mesh:
    """``devices``: a ``(dp, tp, sp)`` numpy array of ``torch.device``;
    ``shape``: ``{axis: size}`` in :data:`AXIS_ORDER`, as JAX's
    ``Mesh.shape``."""

    axis_names = AXIS_ORDER

    def __init__(self, devices: np.ndarray):
        if devices.ndim != len(AXIS_ORDER):
            raise ValueError(f"a mesh is {len(AXIS_ORDER)}-D over "
                             f"{AXIS_ORDER}, not {devices.shape}")
        self.devices = devices
        self.shape: Dict[str, int] = dict(zip(AXIS_ORDER, devices.shape))

    def home(self, replica: int = 0) -> torch.device:
        """Replica ``replica``'s home device (its ``tp`` and ``sp`` index
        0): where its rows enter and leave, and where the layers the rule
        leaves replicated compute."""
        return self.devices[replica, 0, 0]

    def __repr__(self) -> str:
        devs = sorted({str(d) for d in self.devices.flat})
        return f"Mesh({self.shape}, devices={devs})"


def init_multihost(coordinator: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None) -> bool:
    """Join a mesh across hosts: False when no coordinator is configured
    (``SDTPU_COORDINATOR``), as in the JAX package, so a single host never
    pays it. With one it raises: across hosts the port would run
    ``torch.distributed`` with one process per card, which is not ported
    (ROADMAP item 14)."""
    coordinator = coordinator or env_str("SDTPU_COORDINATOR") or None
    if not coordinator:
        return False
    n = num_processes if num_processes is not None else \
        env_int("SDTPU_NUM_PROCESSES")
    pid = process_id if process_id is not None else \
        env_int("SDTPU_PROCESS_ID")
    raise NotImplementedError(
        f"a mesh across hosts (coordinator {coordinator}, processes {n}, "
        f"process {pid}) is not ported: it needs torch.distributed with one "
        f"process per card (ROADMAP item 14)")


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

    Unspecified axes get size 1; if no axes are given, every device lands
    on ``dp``. A spec that uses a subset whose size divides the device
    count takes the first devices; any other mismatch raises, with the JAX
    package's message."""
    devices = [torch.device(d) for d in (
        devices if devices is not None else _visible_devices())]
    axes = parse_mesh_spec(spec)
    if not axes:
        axes = {"dp": len(devices)}
    sizes = [axes.get(a, 1) for a in AXIS_ORDER]
    total = int(np.prod(sizes))
    if total != len(devices):
        # allow a spec that uses a subset (e.g. dp=4 of 8 devices)
        if total < len(devices) and len(devices) % total == 0:
            devices = devices[:total]
        else:
            raise ValueError(
                f"mesh spec {axes} needs {total} devices, have {len(devices)}"
            )
    arr = np.empty(total, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(sizes))


def pad_batch(n: int, mesh: Mesh) -> int:
    """Images to generate so the batch divides the dp axis: pad-and-drop,
    the replacement for the reference's remainder round-robin."""
    dp = mesh.shape["dp"]
    return ((n + dp - 1) // dp) * dp
