"""The port stands alone: no JAX, no Flax, nothing of the JAX package,
and no ``safetensors`` package (the card's machine has none: the port reads
the format itself).

A fresh interpreter imports every module of the port; afterwards neither
``jax``, ``flax``, ``safetensors`` nor any module of
``stable_diffusion_webui_distributed_tpu`` may be loaded. A scan of the
sources (the port's, ``chip_smoke.py``, the fleet telemetry phase's
runners in ``tools/``, the artifact store's report and its phase's
runner, the mesh, scenario and multihost phases' runners, the multihost
tests' rank helper) asserts the same of every import statement, including imports
inside functions.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = "stable_diffusion_webui_distributed_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "safetensors",
             "stable_diffusion_webui_distributed_tpu")

PROBE = f"""
import importlib, json, pkgutil, sys
import {PORT} as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, "{PORT}.")]
for name in names:
    importlib.import_module(name)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in {FORBIDDEN!r})
print(json.dumps({{"imported": names, "forbidden": loaded}}))
"""


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def test_importing_every_port_module_loads_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    for name in ("pipeline.engine", "server.api", "serving.dispatcher",
                 "serving.bucketer", "serving.metrics", "runtime.config",
                 "ops.ragged_attention", "ops.nvcc", "scheduler.world",
                 "scheduler.worker", "scheduler.eta", "runtime.flags",
                 "runtime.daemon", "cli", "models.controlnet",
                 "pipeline.image", "models.convert", "models.safetensors_io",
                 "pipeline.registry", "fleet", "fleet.policy", "fleet.quotas",
                 "fleet.admission", "fleet.slices", "fleet.pool", "obs",
                 "obs.prometheus", "runtime.runner", "obs.journal",
                 "parallel", "parallel.stage_graph", "sim", "sim.chaos",
                 "runtime.logging", "runtime.trace", "obs.spans",
                 "obs.flightrec", "obs.watchdog", "obs.perf", "obs.tsdb",
                 "obs.alerts", "obs.notify", "obs.fleetlog", "obs.stitch",
                 "obs.federation", "obs.push", "server.panel",
                 "serving.aot", "runtime.mesh", "parallel.sharding",
                 "parallel.stage_pipeline", "ops.ring_attention",
                 "sim.workload", "sim.score", "sim.sweep", "sim.scenarios",
                 "sim.sched", "sim.harnesses", "runtime.locksan",
                 "runtime.native"):
        assert f"{PORT}.{name}" in out["imported"]
    assert len(out["imported"]) >= 70
    assert out["forbidden"] == []


def _sources():
    yield from sorted((ROOT / PORT).rglob("*.py"))
    yield ROOT / "chip_smoke.py"
    # the chip harness's runners of the fleet telemetry phase
    yield ROOT / "tools" / "torch_obs_fleet.py"
    yield ROOT / "tools" / "torch_obs_remote.py"
    # the artifact store's report and the chip runner of its phase
    yield ROOT / "tools" / "torch_aot_report.py"
    yield ROOT / "tools" / "torch_aot.py"
    # the chip runner of the mesh phase
    yield ROOT / "tools" / "torch_mesh.py"
    # the chip runner of the scenario phase
    yield ROOT / "tools" / "torch_scenarios.py"
    # the chip runner of the multihost phase, and the rank processes of
    # the multihost tests
    yield ROOT / "tools" / "torch_multihost.py"
    yield ROOT / "tests" / "torch_multihost_rank.py"


@pytest.mark.parametrize("path", list(_sources()),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_nothing_of_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"
