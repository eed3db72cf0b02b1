"""The port's mesh across two processes, and what refuses one, on the CPU.

The ranks are subprocesses of ``tests/torch_multihost_rank.py`` (it
imports only the port), joined in a gloo group on ``127.0.0.1`` at a free
port, each with a virtual local mesh of four ``cpu`` entries.

- ``build_mesh`` over the two ranks has the shape JAX ``build_mesh`` gives
  the same spec over the conftest's eight virtual devices, and its
  replicas belong to ranks ``[0, 0, 1, 1]`` over ``dp``; ``tp=8``, whose
  one replica spans both ranks, is built on both, its one replica's ranks
  ``(0, 1)`` and local on each, with this rank's first entry as its home;
  ``dp=2``, which takes rank 0's entries alone, raises on both;
- a rank that exits before the first collective makes the other raise
  within the ``timeout_s`` the test passes, instead of hanging;
- ``cli serve`` and the stage-graph executor under the group raise on
  both ranks, naming ROADMAP item 14d; so do the ControlNet tower on its
  own mesh, the base+refiner stage pipeline and the serving dispatcher on
  an engine over a mesh across processes (built by hand: they refuse it
  before any collective), where the other rank's replicas hold nothing;
  and so does a World with remote workers under a group.

``run_ranks`` and ``weights_file`` serve ``tests/test_torch_multihost.py``
and ``tests/test_torch_multihost_cli.py`` too.
"""

import json
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from stable_diffusion_webui_distributed_tpu.runtime import mesh as jmesh
from stable_diffusion_webui_distributed_tpu_torch import bridge, cli
from stable_diffusion_webui_distributed_tpu_torch.models.configs import TINY
from stable_diffusion_webui_distributed_tpu_torch.parallel import sharding
from stable_diffusion_webui_distributed_tpu_torch.parallel import (
    stage_pipeline,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline.engine import Engine
from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    GenerationPayload,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime import config
from stable_diffusion_webui_distributed_tpu_torch.runtime import (
    mesh as mesh_mod,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.interrupt import (
    GenerationState,
)
from stable_diffusion_webui_distributed_tpu_torch.serving.dispatcher import (
    ServingDispatcher,
)
from test_torch_parallel import BASE, gates_off, params  # noqa: F401

HELPER = Path(__file__).resolve().parent / "torch_multihost_rank.py"
SPEC = "dp=4,tp=2"
#: seconds a pair of ranks may take before the test kills them and fails
DEADLINE_S = 150


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def weights_file(params, tmp: Path) -> str:
    """The port's state dicts of the Flax tree ``params``, saved for the
    ranks."""
    path = str(tmp / "weights.pt")
    torch.save(bridge.flax_to_torch(TINY, params), path)
    return path


def master_config(path: Path) -> str:
    """A fleet config whose master is benchmarked (else ``cli`` would
    benchmark it at 512x512 first)."""
    config.save_config(config.ConfigModel(workers=[{"master": config.
                       WorkerModel(master=True, avg_ipm=60.0)}]), str(path))
    return str(path)


def run_ranks(tmp: Path, modes, timeout_s: float = 60.0, **job):
    """Run two ranks, rank ``r`` in mode ``modes[r]`` (one mode: both),
    with ``job``'s keys (``mesh`` defaults to :data:`SPEC`, ``local`` to
    4); per-rank values may be given as ``[rank 0's, rank 1's]`` under a
    ``per_rank`` dict. Returns each rank's output JSON (None for a rank
    that dies). A pair that outlives :data:`DEADLINE_S` is killed and
    fails the test."""
    modes = [modes] * 2 if isinstance(modes, str) else list(modes)
    per_rank = job.pop("per_rank", {})
    coordinator = f"127.0.0.1:{free_port()}"
    procs, outs = [], []
    t0 = time.monotonic()
    for r, mode in enumerate(modes):
        out = tmp / f"out{r}-{mode}.json"
        spec = {"coordinator": coordinator, "world": 2, "rank": r,
                "timeout_s": timeout_s, "mode": mode, "mesh": SPEC,
                "local": 4, "out": str(out), **job,
                **{k: v[r] for k, v in per_rank.items()}}
        path = tmp / f"job{r}-{mode}.json"
        path.write_text(json.dumps(spec))
        procs.append(subprocess.Popen(
            [sys.executable, str(HELPER), str(path)], cwd=str(tmp),
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True))
        outs.append(out)
    errs = []
    try:
        for p in procs:
            left = DEADLINE_S - (time.monotonic() - t0)
            errs.append(p.communicate(timeout=max(1.0, left))[1])
    except subprocess.TimeoutExpired:
        pytest.fail(f"the ranks outlived {DEADLINE_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for r, out in enumerate(outs):
        if modes[r] == "die":
            results.append(None)
            continue
        assert out.exists(), errs[r][-2000:]
        results.append(json.loads(out.read_text()))
    return results


def test_mesh_across_two_ranks_has_the_jax_shape_and_rank_order(tmp_path):
    outs = run_ranks(tmp_path, "mesh", specs=[SPEC, "tp=8", "", "dp=2"])
    jm = jmesh.build_mesh(SPEC)
    for rank, out in enumerate(outs):
        got = out[SPEC]
        assert got["shape"] == dict(jm.shape)
        assert list(np.asarray(got["ranks"]).shape) == list(jm.devices.shape)
        assert got["replica_ranks"] == [[0], [0], [1], [1]]
        assert got["spans"] is True
        assert got["local"] == [[0, 1], [2, 3]][rank]
        assert got["local_shape"] == {"dp": 2, "tp": 2, "sp": 1}
        # every entry of a replica on its replica's rank
        assert got["ranks"] == [[[q]] * 2 for q in (0, 0, 1, 1)]
        # tp=8: one replica over both ranks' four entries each, local to
        # both, with a group of the pair
        tp8 = out["tp=8"]
        assert "error" not in tp8, tp8
        assert tp8["replica_ranks"] == [[0, 1]] and tp8["local"] == [0]
        assert tp8["ranks"] == [[[0]] * 4 + [[1]] * 4]
        assert tp8["local_shape"] == {"dp": 1, "tp": 8, "sp": 1}
        assert tp8["groups"] == [[0, 1]]
        # no spec: all eight entries on dp, four a rank
        assert out[""]["replica_ranks"] == [[0]] * 4 + [[1]] * 4
        # a spec that leaves rank 1 no entry raises on both ranks
        assert "processes [1] would own no entry" in out["dp=2"]["error"]


def test_a_dead_rank_makes_the_other_raise_within_its_timeout(params,
                                                              tmp_path):
    timeout_s = 20.0
    t0 = time.monotonic()
    survivor, _ = run_ranks(
        tmp_path, ["engine", "die"], timeout_s=timeout_s,
        weights=weights_file(params, tmp_path),
        cases=[["batch 4", "txt2img", {**BASE, "batch_size": 4}]])
    assert time.monotonic() - t0 < timeout_s + 60
    assert "error" in survivor
    assert "RuntimeError" in survivor["error"]


def test_cli_serve_refuses_a_group_of_processes(tmp_path):
    outs = run_ranks(
        tmp_path, "cli", per_rank={"argv": [
            ["serve", "--family", "tiny", "--device", "cpu", "--port", "0",
             "--model-dir", str(tmp_path / "none"), "--distributed-config",
             master_config(tmp_path / f"cfg{r}.json")] for r in range(2)]})
    for out in outs:
        assert out["error"].startswith("NotImplementedError: cli serve")
        assert "ROADMAP item 14d" in out["error"]
        assert out["group_left"] is True


def test_stage_graph_executor_refuses_a_group_of_processes(params,
                                                          tmp_path):
    outs = run_ranks(tmp_path, "staged",
                     weights=weights_file(params, tmp_path),
                     cases=[["batch 4", "txt2img",
                             {**BASE, "batch_size": 4}]])
    for out in outs:
        assert "stage-graph executor" in out["error"]
        assert "ROADMAP item 14d" in out["error"]



def spanning_mesh(rank: int):
    """The two-rank ``dp=4,tp=2`` mesh as rank ``rank`` holds it, built by
    hand (no group: the refusals below come before any collective)."""
    devices = np.empty(8, dtype=object)
    devices[:] = [torch.device("cpu")] * 8
    ranks = np.repeat([0, 0, 1, 1], 2).reshape(4, 2, 1)
    return mesh_mod.Mesh(devices.reshape(4, 2, 1), ranks, rank)


def refused_tower(engine, monkeypatch):
    monkeypatch.setenv("SDTPU_STAGE_CN_DEVICES", "1")
    engine._stage_cn_mesh()


def refused_pipeline(engine, monkeypatch):
    stage_pipeline.pipelined_txt2img(engine, engine, GenerationPayload(
        **BASE, refiner_checkpoint="ref", refiner_switch_at=0.5))


def refused_dispatcher(engine, monkeypatch):
    ServingDispatcher(engine)


REFUSED = {"the ControlNet tower on its own mesh": refused_tower,
           "the base+refiner stage pipeline": refused_pipeline,
           "the serving dispatcher": refused_dispatcher}


@pytest.mark.parametrize("path", list(REFUSED))
def test_paths_that_do_not_split_rows_refuse_a_mesh_across_processes(
        path, params, monkeypatch):
    mesh = spanning_mesh(1)
    assert mesh.spans_processes and mesh.local_replicas == [2, 3]
    engine = Engine(TINY, bridge.flax_to_torch(TINY, params), chunk_size=3,
                    state=GenerationState(), mesh=mesh)
    # the other rank's replicas hold no weights here
    assert engine.local_mesh.shape == {"dp": 2, "tp": 2, "sp": 1}
    assert sharding.replicas(engine.unet, mesh)[:2] == [None, None]
    with pytest.raises(NotImplementedError, match="ROADMAP item 14d") as err:
        REFUSED[path](engine, monkeypatch)
    assert str(err.value).startswith(path)


def test_a_world_with_remote_workers_refuses_a_group_of_processes(
        tmp_path, monkeypatch):
    # each process would plan and send its own requests to the remotes
    monkeypatch.setattr(cli, "process_count", lambda: 2)
    cfg = str(tmp_path / "cfg.json")
    config.save_config(config.ConfigModel(workers=[
        {"master": config.WorkerModel(master=True, avg_ipm=60.0)},
        {"remote": config.WorkerModel(address="10.0.0.2", port=7860)}]), cfg)
    args = cli.build_parser().parse_args(
        ["generate", "--prompt", "x", "--device", "cpu", "--family", "tiny",
         "--model-dir", str(tmp_path / "none"), "--distributed-config", cfg])
    with pytest.raises(NotImplementedError, match="ROADMAP item 14d"):
        cli._build_world(args)
