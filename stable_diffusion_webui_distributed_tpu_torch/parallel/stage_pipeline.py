"""Two-stage device pipeline: the base UNet and the refiner on two meshes.

Port of the JAX package's ``parallel/stage_pipeline.py``. BASELINE config
#2 runs its two models back to back, so the refiner of each dispatch group
waits behind its base half. With the two engines on two meshes (or two
cards) the stages overlap: while group ``i`` refines on the refiner's
devices, group ``i + 1``'s base half already runs on the base's. One host
thread drives both: each group is an encode -> denoise -> refine
:class:`~.stage_graph.StageGraph` whose denoise ranges dispatch without
waiting (the engines' ``sync=False``), and the
:class:`~.stage_graph.GraphRunner`'s depth window lets the decode of a group
trail behind the next group's stages. The latents move between the meshes
with ``.to(device, non_blocking=True)``.

The seed contract keys every draw by image index, and each group runs at
the request's group size (pad-and-drop, as the engine's serial loop
does), so the images are the sequential path's: byte for byte when both
engines share one device (every virtual mesh on one card), within a level
where they lie on different devices.

Scope, with the JAX package's refusals: txt2img without the hires fix, a
fixed-grid sampler, ``refiner_switch_at`` in (0, 1), one prompt for every
image, no ControlNet unit and no inpainting checkpoint; and a mesh of one
process (across processes it is ROADMAP item 14d). An interrupt during
a group's base half skips its refiner and decodes its partial latents, as
the sequential path's ``_split_denoise`` does.
"""

from __future__ import annotations

from typing import Optional

from stable_diffusion_webui_distributed_tpu_torch.parallel import stage_graph
from stable_diffusion_webui_distributed_tpu_torch.pipeline.engine import (
    parse_controlnet_units,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    GenerationResult,
    fix_seed,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.mesh import (
    across_processes,
)
from stable_diffusion_webui_distributed_tpu_torch.samplers import (
    kdiffusion as kd,
)


def pipelined_txt2img(base, refiner, payload, *,
                      group_size: Optional[int] = None) -> GenerationResult:
    """Generate ``payload`` with the base half on ``base``'s mesh and the
    refiner half on ``refiner``'s, pipelined across dispatch groups of
    ``group_size`` (default the batch size). Runs on the base engine's
    device thread, as the sequential path does (it calls the refiner from
    there too)."""
    for engine in (base, refiner):
        if engine.mesh is not None and engine.mesh.spans_processes:
            raise across_processes("the base+refiner stage pipeline")
    if payload.init_images or payload.enable_hr:
        raise ValueError("stage pipeline: txt2img without hires only")
    if kd.resolve_sampler(payload.sampler_name).adaptive:
        raise ValueError("stage pipeline: fixed-grid samplers only "
                         "(DPM adaptive's host loop is inherently serial)")
    if not (0.0 < payload.refiner_switch_at < 1.0):
        raise ValueError("stage pipeline: needs refiner_switch_at in (0,1)")
    if payload.all_prompts:
        raise ValueError("stage pipeline: per-image prompts (prompt "
                         "matrix / scheduler sub-ranges) take the "
                         "sequential path")
    if parse_controlnet_units(payload):
        raise ValueError("stage pipeline: ControlNet units take the "
                         "sequential path")
    if base.family.inpaint:
        raise ValueError("stage pipeline: inpainting checkpoints take "
                         "the sequential path")
    payload = payload.model_copy()
    payload.seed = fix_seed(payload.seed)
    payload.subseed = fix_seed(payload.subseed)
    base.state.begin_request()
    return base.run_on_device(_pipelined, base, refiner, payload,
                              max(1, group_size or payload.batch_size))


def _pipelined(base, refiner, payload, group: int) -> GenerationResult:
    base._adaptive_incomplete = False
    base._apply_prompt_loras(payload)
    width, height = payload.width, payload.height
    h, w = base._latent_hw(width, height)
    C = base.family.vae.latent_channels
    steps = payload.steps
    # the sequential path's clamp (Engine._split_denoise): the switch may
    # be 0, and then the refiner runs every step
    switch = max(0, min(steps - 1, int(steps * payload.refiner_switch_at)))
    conds, pooleds = base.encode_prompts(payload)
    ref_conds, ref_pooleds = refiner.encode_prompts(payload)
    spec = kd.resolve_sampler(payload.sampler_name)
    sigma0 = kd.build_sigmas(spec, base.schedule, steps)[0]

    out = GenerationResult(parameters=payload.model_dump())
    total = payload.total_images
    pending: list = []
    # depth 1: the newest group stays in flight, so base(g + 1) dispatches
    # ahead of decode(g) on the base's stream
    runner = stage_graph.GraphRunner(depth=stage_graph.depth(),
                                     clock=stage_graph.CLOCK)

    def make_flush(p0, n0):
        def flush(res):
            state, lat = res["refine"]
            # "partial": an interrupt skipped the refiner, and the base
            # half's latents decode as they are
            lat = lat.to(base.device, non_blocking=True)
            base._keep_one_decode(out, payload, pending, base._queue_decoded(
                lat, p0, n0, width, height))
        return flush

    pos = 0
    while pos < total and not base.state.flag.interrupted:
        n = min(group, total - pos)
        graph = stage_graph.StageGraph(
            label=f"base+refine[{pos}:{pos + n}]", group=pos,
            clock=stage_graph.CLOCK)

        def encode(p0=pos):
            # every group at the full group size (pad-and-drop)
            noise = base._init_noise(payload, p0, group, (h, w, C), h)
            return (base._place_batch(noise * sigma0),
                    base._image_keys(payload, p0, group))

        def denoise(enc):
            x, keys = enc
            if switch > 0:
                x = base._denoise(payload, x, keys, conds, pooleds,
                                  "txt2img", end_step=switch, sync=False)
            return x, keys

        def refine(den):
            lat, keys = den
            if base.state.flag.interrupted:
                return ("partial", lat)
            lat = refiner._place_batch(lat)
            keys = keys.to(refiner.device, non_blocking=True)
            return ("refined", refiner._denoise(
                payload, lat, keys, ref_conds, ref_pooleds,
                "txt2img+refiner", start_step=switch, sync=False))

        graph.add("encode", encode, kind="stage")
        graph.add("denoise", denoise, deps=("encode",), kind="denoise")
        graph.add("refine", refine, deps=("denoise",), kind="stage")
        runner.submit(graph, make_flush(pos, n))
        pos += n
        if graph.node("refine").result[0] == "partial":
            # the interrupted group is the newest: draining in submit
            # order keeps the gallery in image order
            break
    runner.drain()
    base._flush_decoded(out, payload, pending)
    base.state.finish()
    return out
