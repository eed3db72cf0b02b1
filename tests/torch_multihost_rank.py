"""One rank of a CPU process group for ``tests/test_torch_multihost*.py``.

    python tests/torch_multihost_rank.py JOB.json

The job file names the group (``coordinator``, ``world``, ``rank``,
``timeout_s``) and what the rank does (``mode``):

- ``engine``: join the group, build ``mesh`` over ``local`` ``cpu``
  entries, make a TINY engine of the weights ``torch.save``d at
  ``weights`` and run each of ``cases`` (``[name, "txt2img" or
  "img2img", body]``); the images, seeds and infotexts go to ``out``
  as JSON;
- ``mesh``: join, build each of ``specs`` and write its shape, ranks
  and local replicas (or the error it raised);
- ``die``: join, build the engine as ``engine`` does and exit before the
  first gather, without leaving the group;
- ``cli``: run ``cli.main(argv)`` with ``local`` ``cpu`` entries as the
  visible cards; its error, if any, goes to ``out``;
- ``staged``: run the first case under ``SDTPU_STAGE_GRAPH=1``; its
  error goes to ``out``.

It imports only the port and torch, never JAX, and runs from any
directory.
"""

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
                                    "local_shape": m.local().shape}
                except ValueError as e:
                    result[spec] = {"error": str(e)}
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
