"""CUDA graphs of the UNet evaluations: the CUDA form of the JAX jit cache.

The JAX package compiles its chunk of sampler steps once per bucket and
then dispatches it (JAX ``pipeline/engine.py`` ``_chunk_fn``; the warmup
sweep, ``serving/warmup.py``, builds them before traffic). The port runs a
UNet evaluation as a few thousand eager aten ops, and the host enqueueing
them leaves the card idle. A :class:`GraphCache`, one per engine, captures
each evaluation (the ControlNet units and the UNet) per input signature
into a ``torch.cuda.CUDAGraph`` and replays it after that.

**Key.** A call names its tensor inputs. The key is the caller's tag (the
kind, the serving precision's flags, the step cache's mode, and which
ControlNet modules run at which unit positions: a unit gated to 0 is not
in the graph) with the ``(name, shape, dtype, layout)``
of every input and the number of scalars. The names and shapes carry the
rest: ragged or not (``true_rows``), the inpainting channels, SDXL's added
conditioning and the traced-LoRA cell (the factor leaves' slot and rank
axes; a set broadcast to every row is a layout of its own).

**Kinds.** ``unet`` and ``ragged`` (an evaluation: the ControlNet units and
the UNet), the step cache's ``deep``, ``reuse`` and their ``-trunc``
forms, and the stage-graph executor's ControlNet: ``cnres`` (the active
units alone, a list of summed residuals) and ``cnstep`` (the UNet with
those residuals as per-call inputs). ``serving/metrics.py`` counts
captures and replays by kind. A capture (its eager first call included) is
a ``capture`` span on the request (``obs/spans.py``; the JAX package's
``compile`` span) and, with ``SDTPU_PERF``, a capture record of the perf
ledger (``obs/perf.py``).

**Inputs and outputs.** Each entry keeps static input buffers, allocated
outside the graphs' memory pool. ``per_run`` inputs (contexts, hints, the
LoRA factors) are copied in when the caller's binding changes, ``per_call``
inputs (the latent rows) on every call, and the scalars (the timestep and
the ControlNet gates) are written with ``fill_``, which takes a number from
the host without a copy from host memory. A row-broadcast input (stride 0
on its first axis) is stored once and read through the same broadcast.
The output lives in the pool, and the next replay of any entry may
overwrite it: a caller consumes or clones it before its next call. Under
these two rules every entry of a cache can share one pool
(``graph_pool_handle``) and replay in any order. A later capture may place
its intermediates or its output where an earlier entry's intermediates
were; only the earlier entry's own replay writes there again, and by then
the later output has been consumed. The static inputs are never in the
pool, so no replay writes over them.

**First call.** A new key runs eagerly on the capture stream, inside the
caller's inference mode and backend settings: that builds and loads the
kernels, and creates the cuBLAS and cuDNN handles and workspaces the
capture needs. Its result is returned, and the evaluation is then captured.
The calls after it replay. A capture that fails raises; nothing on the card
falls back to eager. Tensors on the CPU take the eager path, as the kernel
wrappers do.

**Launch counts.** A kernel wrapper counts its launches in Python, which a
replay skips. The capture notes the counts each wrapper added while it ran
and puts the counters back (a capture launches nothing); each replay adds
that delta (``ops/flash_attention.py`` :func:`add_launches`).

**Memory.** The static inputs are the cache's memory beside the pool; a
traced-LoRA set is one of them (1.2 GB for SDXL at rank 64 and 4 slots,
times the rows where each row has its own set). Past
:data:`STATIC_BUDGET` bytes of them, a capture drops the least recently
used entries (graph, buffers and output) until the cache fits, the new
entry always kept; a dropped signature captures again at its next call.
Dropping the cache (with its engine) drops every graph, static buffer and
output, and with the last graph the pool.

**Devices.** A capture runs on one device, so the cache keeps one backend
(its side stream and pool) per card its calls come from: the replicas of
a mesh over several cards (``runtime/mesh.py``) each capture on their own,
and their entries count against the one budget. The engine keys a
replica's evaluation by its replica and devices, and runs an evaluation
that spans several cards eagerly.

The bookkeeping (keys, bindings, deltas, captures by kind, the budget) is
plain Python apart from the capture backend, :class:`CudaCapture`, so the
tests run it on the CPU with a stand-in backend.
"""

from __future__ import annotations

import itertools
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from stable_diffusion_webui_distributed_tpu_torch.obs import (
    perf as obs_perf,
)
from stable_diffusion_webui_distributed_tpu_torch.obs import (
    spans as obs_spans,
)
from stable_diffusion_webui_distributed_tpu_torch.ops.flash_attention import (
    add_launches,
    flash_attention,
)
from stable_diffusion_webui_distributed_tpu_torch.ops.quant import int8_mm
from stable_diffusion_webui_distributed_tpu_torch.ops.ragged_attention import (
    ragged_attention,
)
from stable_diffusion_webui_distributed_tpu_torch.serving.metrics import (
    METRICS,
)

#: the wrappers whose launches a replay adds: the attention kernels and
#: the int8 products
COUNTED = (flash_attention, ragged_attention, int8_mm)
#: bytes of static inputs and outputs a cache keeps before a capture drops
#: its least recently used entries
STATIC_BUDGET = 4 * 2**30

Inputs = Dict[str, torch.Tensor]


def _broadcast(t: torch.Tensor) -> bool:
    return t.dim() > 0 and t.shape[0] > 1 and t.stride(0) == 0


def signature(inputs: Inputs) -> Tuple:
    """``(name, shape, dtype, broadcast)`` of every input, in order."""
    return tuple((name, tuple(t.shape), t.dtype, _broadcast(t))
                 for name, t in inputs.items())


def fill_scalars(buf: torch.Tensor, values: Sequence[float]) -> None:
    """Writes host numbers into a device vector, one ``fill_`` each: no
    copy from host memory, so the host does not wait for the device."""
    for i, v in enumerate(values):
        buf[i].fill_(v)


def scalar_tensor(values: Sequence[float], device) -> torch.Tensor:
    """An f32 vector of ``values`` on ``device`` (:func:`fill_scalars`)."""
    buf = torch.empty(len(values), dtype=torch.float32, device=device)
    fill_scalars(buf, values)
    return buf


def flatten(tree: Optional[Dict], prefix: str) -> Inputs:
    """The leaves of nested dicts as ``{"prefix/a/b": tensor}``."""
    out: Inputs = {}
    if tree is None:
        return out
    for key, node in tree.items():
        path = f"{prefix}/{key}"
        if isinstance(node, dict):
            out.update(flatten(node, path))
        else:
            out[path] = node
    return out


def unflatten(inputs: Inputs, prefix: str) -> Optional[Dict]:
    """The nested dicts :func:`flatten` made under ``prefix``; None when
    there is none."""
    tree: Dict = {}
    head = prefix + "/"
    for name, t in inputs.items():
        if not name.startswith(head):
            continue
        *parents, leaf = name[len(head):].split("/")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = t
    return tree or None


class _Static:
    """One input's static buffer: ``view`` is what the graph reads, ``base``
    what a copy writes (a row-broadcast input keeps one row)."""

    __slots__ = ("base", "view", "broadcast")

    def __init__(self, t: torch.Tensor):
        self.broadcast = _broadcast(t)
        self.base = torch.empty_like(t[0] if self.broadcast else t)
        self.view = self.base.expand(t.shape) if self.broadcast else self.base

    def load(self, t: torch.Tensor) -> None:
        self.base.copy_(t[0] if self.broadcast else t)


class Entry:
    """One captured evaluation: its graph, static inputs and output, the
    launches each replay adds, and the binding its per-run inputs hold."""

    __slots__ = ("graph", "run", "call", "scalars", "output", "delta",
                 "binding", "replays", "kind")

    def __init__(self, per_run: Inputs, per_call: Inputs, n_scalars: int,
                 device):
        self.graph = None
        self.run = {n: _Static(t) for n, t in per_run.items()}
        self.call = {n: _Static(t) for n, t in per_call.items()}
        self.scalars = torch.empty(n_scalars, dtype=torch.float32,
                                   device=device)
        self.output = None
        self.delta: List[Tuple[Callable, int, Dict[str, int]]] = []
        self.binding: Optional[int] = None
        self.replays = 0
        self.kind = ""

    def load(self, per_run: Optional[Inputs], per_call: Inputs,
             scalars: Sequence[float]) -> None:
        if per_run is not None:
            for name, t in per_run.items():
                self.run[name].load(t)
        for name, t in per_call.items():
            self.call[name].load(t)
        fill_scalars(self.scalars, scalars)

    def nbytes(self) -> int:
        """Bytes of its static inputs and output (the pool aside)."""
        tensors = [s.base for s in (*self.run.values(), *self.call.values())]
        tensors.append(self.scalars)
        # an evaluation returns a tensor, the ControlNet stage a list
        outs = self.output if isinstance(self.output, (list, tuple)) \
            else [self.output]
        tensors += [t for t in outs if isinstance(t, torch.Tensor)]
        return sum(t.numel() * t.element_size() for t in tensors)

    def args(self) -> Tuple[Inputs, Inputs, torch.Tensor]:
        return ({n: s.view for n, s in self.run.items()},
                {n: s.view for n, s in self.call.items()}, self.scalars)


class CudaCapture:
    """Eager first calls, captures and replays on one card: a side stream
    to capture on, and one memory pool for every graph of the cache."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()

    def eager(self, fn):
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            out = fn()
        current.wait_stream(self.stream)
        return out

    def capture(self, fn):
        """``(graph, output)``: ``fn`` captured on the side stream into the
        cache's pool. Other threads keep their CUDA calls during the capture
        (``thread_local``); an error inside it ends the capture and
        raises."""
        graph = torch.cuda.CUDAGraph()
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            graph.capture_begin(pool=self.pool,
                                capture_error_mode="thread_local")
            try:
                out = fn()
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass  # the capture was invalidated by the first error
                raise
            graph.capture_end()
        current.wait_stream(self.stream)
        return graph, out

    def replay(self, graph) -> None:
        graph.replay()


class GraphCache:
    """A cache of captured evaluations (see the module's docstring).

    ``capture`` is the backend of every device (when None, a
    :class:`CudaCapture` per card at its first call; the tests pass a
    stand-in, which then also takes CPU tensors through the bookkeeping).
    Used from one thread at a time: the engine's device thread."""

    def __init__(self, capture=None):
        self._capture = capture
        self._captures: Dict[torch.device, CudaCapture] = {}
        self._entries: "OrderedDict[Tuple, Entry]" = OrderedDict()
        self._bindings = itertools.count(1)

    def _backend(self, device: torch.device):
        """The capture backend of ``device``'s calls; None for tensors off
        the card without a stand-in (they run eagerly)."""
        if self._capture is not None:
            return self._capture
        if device.type != "cuda":
            return None
        backend = self._captures.get(device)
        if backend is None:
            backend = self._captures[device] = CudaCapture(device)
        return backend

    def __len__(self) -> int:
        return len(self._entries)

    def entries(self) -> List[Entry]:
        return list(self._entries.values())

    def keys(self) -> List[Tuple]:
        """Every entry's key: ``(tag, signature of the per-run inputs,
        signature of the per-call inputs, number of scalars)``."""
        return list(self._entries)

    def discard(self, stale: Callable[[Tuple], bool]) -> int:
        """Drop every entry whose key ``stale`` names (its graph reads
        tensors that were replaced); returns how many went. A dropped key
        captures again at its next call."""
        keys = [key for key in self._entries if stale(key)]
        for key in keys:
            del self._entries[key]
        return len(keys)

    def binding(self) -> int:
        """A new binding: one caller's per-run inputs, which stay the same
        tensors for every call that passes it."""
        return next(self._bindings)

    def run(self, tag: Tuple, kind: str,
            fn: Callable[[Inputs, Inputs, torch.Tensor], torch.Tensor],
            per_run: Inputs, per_call: Inputs, scalars: Sequence[float],
            binding: int) -> torch.Tensor:
        """``fn(run, call, scalars)`` for these inputs, ``scalars`` as an f32
        vector: eager for CPU tensors (without a stand-in backend), else the
        replay of the entry of ``(tag, signatures)``, captured at its first
        call. The result of a replay is the entry's output: consume it
        before the next call."""
        device = next(iter(per_call.values())).device
        backend = self._backend(device)
        if backend is None:
            return fn(per_run, per_call, scalar_tensor(scalars, device))
        key = (tag, signature(per_run), signature(per_call), len(scalars))
        entry = self._entries.get(key)
        if entry is None:
            return self._first(key, kind, fn, per_run, per_call, scalars,
                               binding, device, backend)
        self._entries.move_to_end(key)
        entry.load(per_run if entry.binding != binding else None, per_call,
                   scalars)
        entry.binding = binding
        backend.replay(entry.graph)
        entry.replays += 1
        METRICS.record_cache_hit(entry.kind)
        for wrapper, n, paths in entry.delta:
            add_launches(wrapper, n, paths)
        return entry.output

    def _first(self, key: Tuple, kind: str, fn, per_run: Inputs,
               per_call: Inputs, scalars: Sequence[float], binding: int,
               device, backend) -> torch.Tensor:
        entry = Entry(per_run, per_call, len(scalars), device)
        entry.kind = kind
        entry.load(per_run, per_call, scalars)
        entry.binding = binding
        args = entry.args()
        t0 = time.perf_counter()
        with obs_spans.span("capture", kind=str(kind), key=str(key)):
            out = backend.eager(lambda: fn(*args))
            before = [(w, w.launches, dict(w.path_launches))
                      for w in COUNTED]
            try:
                entry.graph, entry.output = backend.capture(
                    lambda: fn(*args))
            finally:
                for wrapper, n, paths in before:
                    if wrapper.launches != n:
                        entry.delta.append(
                            (wrapper, wrapper.launches - n,
                             {p: c - paths[p]
                              for p, c in wrapper.path_launches.items()}))
                    wrapper.launches = n
                    wrapper.path_launches.update(paths)
        self._entries[key] = entry
        METRICS.record_compile(kind)
        obs_perf.LEDGER.record_compile(kind, time.perf_counter() - t0)
        total = sum(e.nbytes() for e in self._entries.values())
        while total > STATIC_BUDGET and len(self._entries) > 1:
            _, dropped = self._entries.popitem(last=False)
            total -= dropped.nbytes()
        return out
