"""One rank of a CPU process group for ``tests/test_torch_multihost*.py``.

    python tests/torch_multihost_rank.py JOB.json

The job file names the group (``coordinator``, ``world``, ``rank``,
``timeout_s``) and what the rank does (``mode``):

- ``engine``: join the group, build ``mesh`` over ``local`` ``cpu``
  entries, make a TINY engine of the weights ``torch.save``d at
  ``weights`` and run each of ``cases`` (``[name, "txt2img" or
  "img2img", body]``); the images, seeds and infotexts go to ``out``
  as JSON;
- ``runs``: join, then for each of ``runs`` in turn build its ``mesh``
  over its ``local`` ``cpu`` entries (a count, or one per rank) and run
  its ``cases`` on an engine over it: of its ``weights`` (with its
  ``family``, TINY by default) or of checkpoint ``model`` of a
  ``ModelRegistry`` over ``registry`` (a directory, or one per rank),
  which then serves the ControlNets, LoRAs, upscalers and refiner
  engines the cases name (to a weights engine too). A run may set ``env`` for its cases and force
  DPM adaptive's attempt backstop to ``max_attempts``. ``out`` gets each
  run's results under its ``name``, with ``held``: for each of this
  rank's replicas (by global index), the distinct patterns of which
  ``tp`` shards its UNet's split layers hold weights for here, their
  weights' bytes and those of every weight the replica holds here, and
  ``collectives``, the exchanges of shards it made;
- ``mesh``: join, build each of ``specs`` and write its shape, ranks,
  local replicas and groups (or the error it raised);
- ``die``: join, build the engine as ``engine`` does and exit before the
  first gather, without leaving the group;
- ``cli``: run ``cli.main(argv)`` with ``local`` ``cpu`` entries as the
  visible cards; its error, if any, goes to ``out``;
- ``staged``: run the first case under ``SDTPU_STAGE_GRAPH=1``; its
  error goes to ``out``.

It imports only the port and torch, never JAX, and runs from any
directory.
"""

import functools
import json
import os
import sys
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from stable_diffusion_webui_distributed_tpu_torch.models.configs import (  # noqa: E402,E501
    TINY,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline.engine import (  # noqa: E402,E501
    Engine,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (  # noqa: E402,E501
    GenerationPayload,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime import (  # noqa: E402,E501
    mesh as mesh_mod,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.interrupt import (  # noqa: E402,E501
    GenerationState,
)


def engine(job):
    params = torch.load(job["weights"])
    mesh = mesh_mod.build_mesh(job["mesh"], ["cpu"] * job["local"])
    return Engine(TINY, params, chunk_size=3, state=GenerationState(),
                  mesh=mesh)


def held(eng):
    """For each replica this process computes, by its index in the global
    mesh: the distinct patterns of held shards over its UNet's split
    layers (True where a shard's weights lie here); ``shard_bytes``, the
    bytes of those shards' weights; and ``bytes``, of every weight the
    replica's module and its placements hold here (each storage once, a
    released whole weight not at all)."""
    from stable_diffusion_webui_distributed_tpu_torch.parallel import (
        sharding,
    )

    def nbytes(tensors):
        storages = {t.untyped_storage().data_ptr():
                    t.untyped_storage().nbytes()
                    for t in tensors if not sharding.released(t)}
        return sum(storages.values())

    out = {}
    for r, module in zip(eng.mesh.local_replicas,
                         eng._replicas(eng.unet, eng.local_mesh)):
        patterns, shards = set(), []
        for m in module.modules():
            for p in (getattr(m, "tp", None), getattr(m, "ffn_tp", None)):
                if isinstance(p, sharding.Placement):
                    for _, _, pieces in p.split:
                        patterns.add(tuple(c is not None
                                           for c in pieces[0]))
                        shards += [c for b in pieces for c in b
                                   if c is not None]
        own = list(module.parameters()) + list(module.buffers())
        out[str(r)] = {"patterns": sorted(patterns),
                       "shard_bytes": nbytes(shards),
                       "bytes": nbytes(own + shards)}
    return out


def run(job, spec, rank):
    """One of ``job["runs"]`` on this rank (see the module docstring)."""
    from stable_diffusion_webui_distributed_tpu_torch.models import configs
    from stable_diffusion_webui_distributed_tpu_torch.parallel import (
        sharding,
    )
    from stable_diffusion_webui_distributed_tpu_torch.pipeline.registry \
        import ModelRegistry
    from stable_diffusion_webui_distributed_tpu_torch.samplers import (
        kdiffusion,
    )

    def mine(v):
        return v[rank] if isinstance(v, list) else v

    mesh = mesh_mod.build_mesh(spec["mesh"], ["cpu"] * mine(spec["local"]))
    registry = providers = None
    if "registry" in spec:
        registry = ModelRegistry(mine(spec["registry"]), device="cpu",
                                 state=GenerationState(), mesh=mesh)
        providers = dict(engine_provider=registry.secondary_engine,
                         controlnet_provider=registry.controlnet_provider,
                         lora_provider=registry.lora_provider,
                         upscaler_provider=registry.upscaler_provider)
    if "model" in spec:
        eng = registry.activate(spec["model"])
    else:
        family = configs.FAMILIES[spec.get("family", "tiny")]
        eng = Engine(family, torch.load(spec["weights"]), chunk_size=3,
                     state=GenerationState(), mesh=mesh, **(providers or {}))
    saved_env = {k: os.environ.get(k) for k in spec.get("env", {})}
    adaptive = kdiffusion.sample_dpm_adaptive
    os.environ.update(spec.get("env", {}))
    if "max_attempts" in spec:
        kdiffusion.sample_dpm_adaptive = functools.partial(
            adaptive, max_attempts=spec["max_attempts"])
    calls = sharding.Span.calls
    try:
        out = run_cases({"cases": spec["cases"]}, eng)
    finally:
        kdiffusion.sample_dpm_adaptive = adaptive
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    out["held"] = held(eng)
    out["collectives"] = sharding.Span.calls - calls
    return out


def run_cases(job, eng):
    out = {}
    for name, kind, body in job["cases"]:
        payload = GenerationPayload(**body)
        result = (eng.img2img if kind == "img2img" else eng.txt2img)(payload)
        out[name] = {"images": result.images, "seeds": result.seeds,
                     "infotexts": result.infotexts}
    return out


def main(path):
    with open(path) as f:
        job = json.load(f)
    mode = job["mode"]
    if mode == "cli":
        from stable_diffusion_webui_distributed_tpu_torch import cli

        mesh_mod._visible_devices = lambda: ["cpu"] * job["local"]
        os.environ.update(SDTPU_COORDINATOR=job["coordinator"],
                          SDTPU_NUM_PROCESSES=str(job["world"]),
                          SDTPU_PROCESS_ID=str(job["rank"]))
        try:
            result = {"rc": cli.main(job["argv"])}
        except Exception as e:  # noqa: BLE001 — reported to the test
            result = {"error": f"{type(e).__name__}: {e}"}
        result["group_left"] = not torch.distributed.is_initialized()
        with open(job["out"], "w") as f:
            json.dump(result, f)
        return 0
    mesh_mod.init_multihost(job["coordinator"], job["world"], job["rank"],
                            timeout_s=job["timeout_s"])
    result = {}
    try:
        if mode == "mesh":
            for spec in job["specs"]:
                try:
                    m = mesh_mod.build_mesh(spec, ["cpu"] * job["local"])
                    result[spec] = {"shape": m.shape,
                                    "ranks": m.ranks.tolist(),
                                    "replica_ranks": m.replica_ranks,
                                    "local": m.local_replicas,
                                    "spans": m.spans_processes,
                                    "local_shape": m.local().shape,
                                    "groups": sorted(m.groups)}
                except ValueError as e:
                    result[spec] = {"error": str(e)}
        elif mode == "runs":
            for spec in job["runs"]:
                result[spec["name"]] = run(job, spec, job["rank"])
        elif mode == "die":
            engine(job)
            os._exit(0)
        elif mode == "staged":
            os.environ["SDTPU_STAGE_GRAPH"] = "1"
            try:
                run_cases(job, engine(job))
            except NotImplementedError as e:
                result = {"error": str(e)}
        else:
            result = run_cases(job, engine(job))
    except Exception:  # noqa: BLE001 — reported to the test
        result = {"error": traceback.format_exc()}
    with open(job["out"], "w") as f:
        json.dump(result, f)
    mesh_mod.shutdown_multihost()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
