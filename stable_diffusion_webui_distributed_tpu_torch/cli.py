"""Command line: the fleet's node server and its operations.

    python -m stable_diffusion_webui_distributed_tpu_torch.cli serve \\
        --family sd15 --port 7860 --distributed-config fleet.json

``serve`` serves a ``World`` whose master is the local engine, with the
remotes of the config file behind it, as the JAX package's ``cli serve``
does; under ``SDTPU_WARMUP`` it first sweeps the local engine's bucket
ladder (``serving/warmup.py``) and prints the report to stderr.
``generate`` runs one request through the same World (img2img with
``--init-image`` and ``--strength``, the hires fix with ``--hires``,
styles of the model directory's ``styles.csv`` with ``--style``, an X/Y/Z
plot with ``--xyz-x/--xyz-y/--xyz-z "AXIS: VALUES"``, one World request
per cell) and writes the PNGs; ``benchmark`` measures every worker's
images per minute; ``ping``,
``status``, ``interrupt`` and ``workers list|add|remove|set`` operate the
fleet.

The model directory (``--model-dir``, default: the config file's
``model_dir``) is served through the port's ``ModelRegistry``: when it
holds checkpoints (``.safetensors``, ``.ckpt``, ``.pt`` at its top, a
``<file>.json`` sidecar naming a family where the keys cannot), the
config's ``default_model`` is activated if it is one of them, else the
first, and ``POST /sdapi/v1/options`` switches among them; when it holds
none, the engine has seeded random weights of ``--family`` and
``--seed`` (``bridge.init_seeded``). Standalone VAEs come from its
``VAE`` directory, ControlNets from ``ControlNet``, LoRA adapters from
``Lora``, the hires fix's RRDBNet upscalers from ``ESRGAN``,
``RealESRGAN`` or ``upscalers``, and textual-inversion embeddings from
``embeddings`` (or ``embeddings/`` beside the directory); ``serve``
expands a request's ``styles`` from its ``styles.csv``; ``POST
/sdapi/v1/refresh-checkpoints`` and ``/refresh-loras`` rescan. The tokenizer is CLIP's BPE where the
directory holds ``vocab.json`` and ``merges.txt``, else a fallback. The
engine runs on ``cuda`` with the card policy (bf16) unless ``--device
cpu`` is given (f32 there); with no GPU and no ``--device`` the commands
that build it raise.

``--mesh "dp=2,tp=2"`` (else the config file's ``mesh_axes``) places the
engine over a device mesh (``runtime/mesh.py``) for ``serve``,
``generate`` and ``benchmark`` over every visible card
(``CUDA_VISIBLE_DEVICES`` picks them). Those commands first call
``init_multihost``: with a coordinator (``SDTPU_COORDINATOR``,
``SDTPU_NUM_PROCESSES``, ``SDTPU_PROCESS_ID``) the process joins a
``torch.distributed`` group, and the mesh spans every process's cards in
rank order (all of them on ``dp`` without a spec). ``generate`` and
``benchmark`` then run on every process with the same arguments: each
computes the rows of the replicas it owns, and every process writes every
image (the engine takes process 0's random ``--image-seed``). ``serve``
under a group of more than one process raises (ROADMAP item 14d), as does
a config file with remote workers there. Each process gives the group
back when its command ends.

    SDTPU_COORDINATOR=10.0.0.1:29500 SDTPU_NUM_PROCESSES=2 \\
    SDTPU_PROCESS_ID=0 \\
    python -m stable_diffusion_webui_distributed_tpu_torch.cli \\
        generate --prompt "a red barn" -n 4 --mesh dp=4,tp=2
"""

from __future__ import annotations

import argparse
import base64
import os
import sys
import urllib.request
from typing import Optional

from stable_diffusion_webui_distributed_tpu_torch.models.configs import (
    FAMILIES,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime import (
    config as config_mod,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime import dtypes
from stable_diffusion_webui_distributed_tpu_torch.runtime import (
    flags as flags_mod,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime import (
    logging as port_logging,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.mesh import (
    across_processes,
    build_mesh,
    init_multihost,
    process_count,
    shutdown_multihost,
)


def _build_world(args, require_local: bool = True):
    """The World of the config file and the registry of its model
    directory, with the master ``WorkerNode`` in front (carrying its
    persisted calibration), whose ``LocalBackend`` follows the registry's
    active engine: the config's ``default_model`` or the first checkpoint,
    or seeded weights when the directory holds none. With
    ``require_local`` False (``status``, ``ping``): no engine, no
    registry."""
    from stable_diffusion_webui_distributed_tpu_torch.pipeline.registry import (
        ModelRegistry,
    )
    from stable_diffusion_webui_distributed_tpu_torch.scheduler.worker import (
        LocalBackend,
        WorkerNode,
    )
    from stable_diffusion_webui_distributed_tpu_torch.scheduler.world import (
        World,
    )

    path = args.distributed_config or config_mod.default_config_path()
    cfg = config_mod.load_config(path)
    registry = None
    if require_local and process_count() > 1 and any(
            not wm.master and not wm.disabled
            for entry in cfg.workers for wm in entry.values()):
        # every process would send its own requests to the remotes
        raise across_processes("a World with remote workers")
    if require_local:
        registry = ModelRegistry(args.model_dir or cfg.model_dir,
                                 device=args.device,
                                 mesh=_build_mesh(args, cfg))
        names = list(registry.available())
        if names:
            registry.activate(cfg.default_model if cfg.default_model in names
                              else names[0])
        else:
            engine = _seeded_engine(args, registry)
            registry.register_engine(engine.model_name, engine)
    world = World.from_config(
        cfg, config_path=path,
        verify_tls=not args.distributed_skip_verify_remotes)
    world.thin_client_mode = bool(args.thin_client)
    if registry is not None:
        world.current_model = registry.current_name
        cal = world.master_calibration()
        world.add_worker(WorkerNode(
            "master", LocalBackend(registry=registry), master=True,
            benchmark_payload=cfg.benchmark_payload,
            avg_ipm=cal.avg_ipm if cal else None,
            eta_percent_error=cal.eta_percent_error if cal else None,
            pixel_cap=cal.pixel_cap if cal else 0,
        ), front=True)  # the master leads the gallery
    return world, registry


def _build_mesh(args, cfg):
    """The mesh of ``--mesh`` (else the config's ``mesh_axes``) over
    every visible card; None without a spec (the JAX ``cli.py`` builds it
    so). Under a group of processes it spans every process's cards, and
    without a spec puts them all on ``dp``."""
    spec = getattr(args, "mesh", None) or ",".join(
        f"{k}={v}" for k, v in cfg.mesh_axes.items())
    if not spec and process_count() == 1:
        return None
    return build_mesh(spec or None)


def _seeded_engine(args, registry):
    """An engine of seeded random weights of ``--family``, with the
    registry's providers, over the registry's mesh."""
    from stable_diffusion_webui_distributed_tpu_torch import bridge
    from stable_diffusion_webui_distributed_tpu_torch.pipeline.engine import (
        Engine,
    )

    device = dtypes.resolve_device(registry.device)
    policy = dtypes.CARD if device.type == "cuda" else dtypes.F32
    family = FAMILIES[args.family]
    params = bridge.init_seeded(family, args.seed, device,
                                policy.param_dtype)
    return Engine(family, params, policy=policy, device=device,
                  mesh=registry.mesh,
                  lora_provider=registry.lora_provider,
                  controlnet_provider=registry.controlnet_provider,
                  upscaler_provider=registry.upscaler_provider,
                  embedding_store=registry.embedding_store)


def cmd_serve(args) -> int:
    from stable_diffusion_webui_distributed_tpu_torch.server.api import (
        ApiServer,
    )

    if process_count() > 1:
        # process 0 would have to hand every request and coalesced
        # dispatch to the others
        raise across_processes("cli serve")
    world, registry = _build_world(args)
    server = ApiServer(world, registry=registry, host=args.listen,
                       port=args.port,
                       user=args.api_auth_user,
                       password=args.api_auth_password)
    if config_mod.env_flag("SDTPU_WARMUP"):
        # capture the ladder's UNet graphs on the local engine before the
        # first request (serving/warmup.py)
        from stable_diffusion_webui_distributed_tpu_torch.serving.bucketer import (
            ShapeBucketer,
        )
        from stable_diffusion_webui_distributed_tpu_torch.serving.warmup import (
            warmup_engine,
        )

        for w in world.workers:
            eng = getattr(w.backend, "engine", None)
            if eng is not None:
                report = warmup_engine(eng,
                                       ShapeBucketer.from_config(world.cfg))
                print(f"serve: warmup {report}", file=sys.stderr)
                break
    server.serve_forever()
    if server.restart_requested:
        # /sdapi/v1/server-restart relaunches the node
        os.execv(sys.executable, [
            sys.executable, "-m",
            "stable_diffusion_webui_distributed_tpu_torch.cli",
            *sys.argv[1:]])
    return 0


def cmd_generate(args) -> int:
    from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
        GenerationPayload,
        b64png_to_array,
    )

    world, registry = _build_world(args)
    w, h = (int(x) for x in args.size.split("x"))
    payload = GenerationPayload(
        prompt=args.prompt, negative_prompt=args.negative, steps=args.steps,
        width=w, height=h, batch_size=args.num, seed=args.image_seed,
        sampler_name=args.sampler, cfg_scale=args.cfg,
        enable_hr=args.hires, hr_scale=args.hires_scale,
        denoising_strength=args.strength, styles=args.style or [])
    if args.init_image:
        with open(args.init_image, "rb") as f:
            payload.init_images = [base64.b64encode(f.read()).decode()]
    if payload.styles:
        from stable_diffusion_webui_distributed_tpu_torch.pipeline.styles \
            import apply_styles, load_styles

        apply_styles(payload, load_styles(
            os.path.join(registry.model_dir, "styles.csv")))
    xyz_opts = {}
    for prefix, spec in (("x", args.xyz_x), ("y", args.xyz_y),
                         ("z", args.xyz_z)):
        if spec:
            axis, _, vals = spec.partition(":")
            xyz_opts[f"{prefix}_axis"] = axis.strip()
            xyz_opts[f"{prefix}_values"] = vals.strip()
    if xyz_opts:
        from stable_diffusion_webui_distributed_tpu_torch.pipeline.xyz import (
            run_xyz,
        )
        from stable_diffusion_webui_distributed_tpu_torch.samplers \
            .kdiffusion import SAMPLERS

        payload.script_name = "x/y/z plot"
        payload.script_args = [xyz_opts]
        result = run_xyz(payload, world.execute,
                         known_samplers=list(SAMPLERS))
    else:
        result = world.execute(payload)
    from PIL import Image

    os.makedirs(args.outdir, exist_ok=True)
    for i, (b64, info) in enumerate(zip(result.images, result.infotexts)):
        path = os.path.join(args.outdir, f"{result.seeds[i]}-{i:02d}.png")
        Image.fromarray(b64png_to_array(b64)).save(path)
        print(path)
        print("  " + info.replace("\n", " | "))
    return 0


def cmd_benchmark(args) -> int:
    world, _ = _build_world(args)
    speeds = world.benchmark_all(rebenchmark=args.rebenchmark)
    for label, ipm in sorted(speeds.items(), key=lambda kv: -kv[1]):
        print(f"{label:24s} {ipm:8.2f} ipm")
    if not speeds:
        print("no benchmarkable workers", file=sys.stderr)
        return 1
    return 0


def cmd_ping(args) -> int:
    world, _ = _build_world(args, require_local=False)
    results = world.ping_workers(indiscriminate=True)
    for label, ok in results.items():
        print(f"{label:24s} {'reachable' if ok else 'UNREACHABLE'}")
    world.save_config()
    return 0 if all(results.values()) else 1


def cmd_status(args) -> int:
    world, _ = _build_world(args, require_local=False)
    print(f"config: {world.config_path}")
    master = world.master_calibration()
    if master is not None:
        speed = (f"{master.avg_ipm:.2f} ipm" if master.avg_ipm
                 else "not benchmarked")
        print(f"  {'master':20s} {'(local)':12s} {speed}  [master]")
    for w in world.workers_snapshot():
        speed = (f"{w.cal.avg_ipm:.2f} ipm" if w.cal.benchmarked
                 else "not benchmarked")
        print(f"  {w.label:20s} {w.current_state().name:12s} {speed}")
    return 0


def cmd_interrupt(args) -> int:
    """Interrupt a running node over its own API."""
    url = f"http://{args.listen}:{args.port}/sdapi/v1/interrupt"
    urllib.request.urlopen(urllib.request.Request(url, method="POST"),
                           timeout=5)
    print("interrupt sent")
    return 0


def cmd_workers(args) -> int:
    path = args.distributed_config or config_mod.default_config_path()
    cfg = config_mod.load_config(path)
    if args.action == "list":
        for entry in cfg.workers:
            for label, wm in entry.items():
                print(f"{label:20s} {wm.address}:{wm.port} "
                      f"{'tls ' if wm.tls else ''}"
                      f"{'disabled ' if wm.disabled else ''}"
                      f"ipm={wm.avg_ipm}")
        return 0
    if not args.label:
        print("--label required", file=sys.stderr)
        return 2
    if args.action == "add":
        cfg.workers = [e for e in cfg.workers if args.label not in e]
        cfg.workers.append({args.label: config_mod.WorkerModel(
            address=args.address, port=args.api_port, tls=args.tls,
            user=args.user, password=args.password,
            pixel_cap=args.pixel_cap or 0)})
        config_mod.save_config(cfg, path)
        print(f"worker '{args.label}' saved to {path}")
        return 0
    if args.action == "remove":
        before = len(cfg.workers)
        cfg.workers = [e for e in cfg.workers if args.label not in e]
        config_mod.save_config(cfg, path)
        print(f"removed {before - len(cfg.workers)} worker(s)")
        return 0
    # set: checkpoint pin, pixel cap, enable or disable
    for entry in cfg.workers:
        if args.label in entry:
            wm = entry[args.label]
            if args.model_override is not None:
                wm.model_override = args.model_override or None
            if args.pixel_cap is not None:
                wm.pixel_cap = max(0, args.pixel_cap)
            if args.disable:
                wm.disabled = True
            if args.enable:
                wm.disabled = False
            config_mod.save_config(cfg, path)
            print(f"worker '{args.label}': "
                  f"model_override={wm.model_override} "
                  f"pixel_cap={wm.pixel_cap} disabled={wm.disabled}")
            return 0
    print(f"no worker '{args.label}' in {path}", file=sys.stderr)
    return 1


def build_parser() -> argparse.ArgumentParser:
    common = argparse.ArgumentParser(add_help=False)
    flags_mod.add_flags(common)
    engine = common.add_argument_group("engine")
    engine.add_argument("--family", default="sd15", choices=sorted(FAMILIES))
    engine.add_argument("--seed", type=int, default=0,
                        help="seed of the random weights")
    engine.add_argument("--device", default=None,
                        help="torch device (default: cuda; raises without "
                        "one)")

    ap = argparse.ArgumentParser(
        prog="stable_diffusion_webui_distributed_tpu_torch.cli")
    sub = ap.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("serve", parents=[common],
                       help="serve the sdapi-v1 node (a World)")
    s.add_argument("--api-auth-user", default=None)
    s.add_argument("--api-auth-password", default=None)
    s.set_defaults(fn=cmd_serve)

    g = sub.add_parser("generate", parents=[common],
                       help="one txt2img (or img2img) request through "
                            "the World")
    g.add_argument("--prompt", required=True)
    g.add_argument("--negative", default="")
    g.add_argument("--steps", type=int, default=20)
    g.add_argument("--size", default="512x512")
    g.add_argument("-n", "--num", type=int, default=1)
    g.add_argument("--image-seed", dest="image_seed", type=int, default=-1,
                   help="the request's seed (-1: random)")
    g.add_argument("--sampler", default="Euler a")
    g.add_argument("--cfg", type=float, default=7.0)
    g.add_argument("--init-image", default=None,
                   help="a PNG: run img2img from it")
    g.add_argument("--strength", type=float, default=0.75,
                   help="img2img (or hires second pass) denoising strength")
    g.add_argument("--hires", action="store_true",
                   help="hires fix: a second pass at --hires-scale")
    g.add_argument("--hires-scale", type=float, default=2.0)
    g.add_argument("--style", action="append", default=None,
                   help="a style of the model directory's styles.csv "
                        "(repeatable)")
    g.add_argument("--xyz-x", default=None, metavar='"AXIS: VALUES"',
                   help='X/Y/Z plot x axis, e.g. "Steps: 10,20,30"')
    g.add_argument("--xyz-y", default=None, metavar='"AXIS: VALUES"')
    g.add_argument("--xyz-z", default=None, metavar='"AXIS: VALUES"')
    g.add_argument("--outdir", default="outputs")
    g.set_defaults(fn=cmd_generate)

    b = sub.add_parser("benchmark", parents=[common],
                       help="2+3 ipm benchmark of every worker")
    b.add_argument("--rebenchmark", action="store_true")
    b.set_defaults(fn=cmd_benchmark)

    sub.add_parser("ping", parents=[common], help="health sweep"
                   ).set_defaults(fn=cmd_ping)
    sub.add_parser("status", parents=[common], help="worker status"
                   ).set_defaults(fn=cmd_status)
    sub.add_parser("interrupt", parents=[common],
                   help="interrupt a serving node").set_defaults(
                       fn=cmd_interrupt)

    wk = sub.add_parser("workers", parents=[common],
                        help="worker registry of the config file")
    wk.add_argument("action", choices=["list", "add", "remove", "set"])
    wk.add_argument("--label")
    wk.add_argument("--address", default="localhost")
    wk.add_argument("--api-port", type=int, default=7860)
    wk.add_argument("--tls", action="store_true")
    wk.add_argument("--user", default=None)
    wk.add_argument("--password", default=None)
    wk.add_argument("--pixel-cap", type=int, default=None)
    wk.add_argument("--model-override", default=None,
                    help="pin this worker to a checkpoint ('' clears)")
    wk.add_argument("--disable", action="store_true")
    wk.add_argument("--enable", action="store_true")
    wk.set_defaults(fn=cmd_workers)
    return ap


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    # the port's logger: console, distributed.log (SDTPU_LOG_DIR) and the
    # ring /internal/status serves, each line under its request's id
    port_logging.configure(debug=args.distributed_debug)
    if args.fn in (cmd_generate, cmd_serve, cmd_benchmark):
        # build the native PNG encoder off the request path
        from stable_diffusion_webui_distributed_tpu_torch.runtime import (
            native,
        )

        native.warm_up()
        # a mesh across hosts (SDTPU_COORDINATOR): join the process group
        if init_multihost():
            try:
                return args.fn(args)
            finally:
                shutdown_multihost()
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
