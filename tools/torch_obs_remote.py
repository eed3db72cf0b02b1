#!/usr/bin/env python3
"""A remote node of the port for the fleet telemetry phase of
``chip_smoke.py`` (``phase_fleet_obs``): a ``World`` over one engine of
the main path's seeded weights (seed 0), behind the port's ``ApiServer``,
in a process of its own. ``--family tiny --device cpu`` runs it on the CPU
(a rehearsal of the phase).

    python3 tools/torch_obs_remote.py --port PORT [--log PATH]
        [--family sd15] [--device cuda]

The process has its own journal, span tracer, TSDB and push buffer, as a
remote node on another host would. It prints one JSON line per event on
its log (``--log``, else standard output):

- ``{"ready": port, "epoch": s, "pid": n}`` once it serves, ``epoch`` the
  ``perf_counter`` base of its trace clock (``obs/spans.py``), which a
  caller on the same host compares with its own to check a stitched
  trace's clock offset;
- on ``SIGUSR1`` it stops its HTTP server, waits
  :data:`RESTART_GAP_S` (a caller sees the node gone) and starts a new
  one on the same port (the engine, the World and the plane's state stay), then
  prints ``{"restarted": port}``;
- on ``SIGUSR2`` it prints ``{"counts": n, "k1": launches, "k1_paths":
  {...}}``, K1's launch count and its launches by path;
- on ``SIGTERM`` it stops, prints its counts and exits 0.

The fleet telemetry gates (``SDTPU_TSDB``, ``SDTPU_PUSH``,
``SDTPU_JOURNAL``, ...) come from the environment the caller gives it.
"""

import argparse
import json
import os
import signal
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: seconds the node stays down on a restart
RESTART_GAP_S = 1.0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--port", type=int, required=True)
    parser.add_argument("--family", default="sd15")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--log", default="")
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from stable_diffusion_webui_distributed_tpu_torch import bridge
    from stable_diffusion_webui_distributed_tpu_torch.models.configs import (
        FAMILIES,
    )
    from stable_diffusion_webui_distributed_tpu_torch.obs import spans
    from stable_diffusion_webui_distributed_tpu_torch.ops import (
        flash_attention as fa,
    )
    from stable_diffusion_webui_distributed_tpu_torch.pipeline.engine import (
        Engine,
    )
    from stable_diffusion_webui_distributed_tpu_torch.runtime import dtypes
    from stable_diffusion_webui_distributed_tpu_torch.scheduler.worker import (
        LocalBackend,
        WorkerNode,
    )
    from stable_diffusion_webui_distributed_tpu_torch.scheduler.world import (
        World,
    )
    from stable_diffusion_webui_distributed_tpu_torch.server.api import (
        ApiServer,
    )

    out = open(args.log, "a", buffering=1) if args.log else sys.stdout
    lock = threading.Lock()

    def say(doc) -> None:
        with lock:
            out.write(json.dumps(doc) + "\n")
            out.flush()

    family = FAMILIES[args.family]
    device = torch.device(args.device)
    policy = dtypes.CARD if device.type == "cuda" else dtypes.F32
    params = bridge.init_seeded(family, 0, device,
                                policy.param_dtype)
    engine = Engine(family, params, policy=policy, device=device)
    del params
    world = World()
    world.add_worker(WorkerNode("master", LocalBackend(engine), master=True,
                                avg_ipm=60.0))
    server = ApiServer(world, port=args.port).start()
    say({"ready": server.port, "epoch": spans._EPOCH, "pid": os.getpid()})

    wanted = {"restart": False, "counts": 0, "stop": False}
    handled = {"counts": 0}

    def on_signal(signum, _frame) -> None:
        if signum == signal.SIGUSR1:
            wanted["restart"] = True
        elif signum == signal.SIGUSR2:
            wanted["counts"] += 1
        else:
            wanted["stop"] = True

    for sig in (signal.SIGUSR1, signal.SIGUSR2, signal.SIGTERM):
        signal.signal(sig, on_signal)

    def counts() -> None:
        handled["counts"] += 1
        say({"counts": handled["counts"],
             "k1": fa.flash_attention.launches,
             "k1_paths": dict(fa.flash_attention.path_launches)})

    while not wanted["stop"]:
        if wanted["restart"]:
            wanted["restart"] = False
            server.stop()
            time.sleep(RESTART_GAP_S)
            server = ApiServer(world, port=args.port).start()
            say({"restarted": server.port})
        while handled["counts"] < wanted["counts"]:
            counts()
        time.sleep(0.02)
    server.stop()
    counts()
    return 0


if __name__ == "__main__":
    sys.exit(main())
