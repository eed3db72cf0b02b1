"""Continuous-batching dispatcher: coalesce compatible requests into one
device batch.

Port of the core of the JAX package's ``serving/dispatcher.py``. The HTTP
layer runs one thread per request; without this module an engine serves
them one whole request at a time. The dispatcher gives every request a
ticket and groups compatible concurrent tickets (same sampler, steps, CFG
scale, negative prompt, clip skip and shape BUCKET, see :mod:`.bucketer`)
into one denoise loop, then splits images, seeds and infotext back per
requester. The first ticket of a group is its *leader*: it sleeps one
coalesce window (``SDTPU_COALESCE_WINDOW``, seconds) so that followers can
join, runs the batch under the execution lock on the engine's device
thread, and wakes the followers with their share.

Seed-exactness: every draw is keyed by (request seed + image index), never
by batch position, and each request's conditioning rides as its own
context rows, so each requester's seeds, subseeds and infotext equal those
of a run alone. Pixels agree within the rounding of another batch size:
on the card a row's bf16 numbers depend on the batch size.

Ragged dispatch (``SDTPU_RAGGED``): requests of one width class and any
height up to the class's tallest bucket share one group. Each row carries
its true latent rows and context length as device vectors, the attention
kernel masks the padded tail (kernel K2), and each image is cropped back
to its top-aligned true size.

LoRA: a request whose adapters are merged into the weights runs solo (a
merge changes the weights under every row). Under ``SDTPU_LORA_TRACED``
a request's adapters resolve to a traced set, and its (rank bucket, slot
count) cell joins the group key: requests with different adapters in one
cell share a batch, each member's set installed before its prompts are
encoded and its rows carrying its own factors into the UNet
(``models/lora.py`` ``stack_row_sets``).

Per-request cancellation: ``cancel(request_id)`` marks one ticket; the
batch keeps running, the cancelled requester's images are dropped at split
time and no other requester is affected.

Requests that cannot merge (more images than the largest batch bucket)
run solo under the same execution lock, still shape-bucketed.

Not ported yet (ROADMAP item 17): the fleet gate with quotas and
admission, the result, embed and prefix caches, the journal, Prometheus,
spans, perf ledger, TSDB and watchdog, the warm pool, the stage-graph
executor and the chaos hook.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Dict, List, Optional

import numpy as np
import torch

from stable_diffusion_webui_distributed_tpu_torch.models import (
    lora as lora_mod,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline import (
    precision as precision_mod,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline import stepcache
from stable_diffusion_webui_distributed_tpu_torch.pipeline.engine import (
    parse_controlnet_units,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    GenerationResult,
    apply_scripts,
    array_to_b64png,
    b64png_to_array,
    build_infotext,
    fix_seed,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.config import (
    env_float,
)
from stable_diffusion_webui_distributed_tpu_torch.samplers import (
    kdiffusion as kd,
)
from stable_diffusion_webui_distributed_tpu_torch.serving.bucketer import (
    ShapeBucketer,
    ragged_enabled,
)
from stable_diffusion_webui_distributed_tpu_torch.serving.metrics import (
    METRICS,
)

DEFAULT_COALESCE_WINDOW = 0.05


def _coalesce_window() -> float:
    return max(0.0, env_float("SDTPU_COALESCE_WINDOW",
                              DEFAULT_COALESCE_WINDOW))


class Ticket:
    """One queued request: original payload + bucketed execution copy."""

    def __init__(self, payload, run, job: str, bucketed: bool,
                 request_id: str) -> None:
        self.payload = payload          # user-visible metadata source
        self.run = run                  # execution payload (bucket dims)
        self.job = job
        self.bucketed = bucketed
        self.request_id = request_id
        self.enqueued = time.monotonic()
        self.done = threading.Event()
        self.cancelled = threading.Event()
        self.result: Optional[GenerationResult] = None
        self.error: Optional[BaseException] = None


class _Group:
    def __init__(self, key) -> None:
        self.key = key
        self.tickets: List[Ticket] = []
        self.images = 0
        self.closed = False


class ServingDispatcher:
    """Leader/follower coalescer in front of a single engine."""

    def __init__(self, engine, bucketer: Optional[ShapeBucketer] = None,
                 window: Optional[float] = None) -> None:
        self.engine = engine
        self.bucketer = bucketer or ShapeBucketer()
        self.window = _coalesce_window() if window is None \
            else max(0.0, float(window))
        self.max_batch = max(self.bucketer.batches)
        # _lock guards the grouping tables; _exec_lock serializes engine
        # execution. _exec_lock may be taken first and _lock nested inside
        # it, never the reverse.
        self._lock = threading.Lock()
        self._exec_lock = threading.Lock()
        self._groups: Dict[tuple, _Group] = {}  # guarded-by: _lock
        self._tickets: Dict[str, Ticket] = {}  # guarded-by: _lock

    # -- public API --------------------------------------------------------

    def submit(self, payload, job: str = "txt2img") -> GenerationResult:
        """Execute ``payload`` (blocking) and return its result.

        Called concurrently from HTTP handler threads; compatible callers
        arriving within one coalesce window share a device batch. What the
        engine does not run raises here, before the request can join a
        group."""
        payload = apply_scripts(payload.model_copy())
        payload.seed = fix_seed(payload.seed)
        payload.subseed = fix_seed(payload.subseed)
        rid = str(getattr(payload, "request_id", "") or uuid.uuid4().hex)

        bypass = bool(payload.init_images or payload.enable_hr)
        if bypass:
            run, bucketed = payload.model_copy(), False
            METRICS.record_request(False, bypassed=True)
        else:
            ragged = ragged_enabled() and self._ragged_eligible(payload)
            run, bucketed = self.bucketer.bucket_payload(payload,
                                                         ragged=ragged)
            # batch-ladder padding folds into the ratio only for work that
            # pads ALONE up the ladder; coalescable rows fill via merging
            solo_batch = None if self._coalescable(run) \
                else payload.total_images
            METRICS.record_request(
                bucketed, padding_ratio=self.bucketer.padding_ratio(
                    payload.width, payload.height, batch=solo_batch))
        self.engine.check_supported(run)

        ticket = Ticket(payload, run, job, bucketed, rid)
        with self._lock:
            self._tickets[rid] = ticket
        try:
            if self._coalescable(run):
                self._run_grouped(ticket)
            else:
                self._run_solo(ticket)
        finally:
            with self._lock:
                self._tickets.pop(rid, None)
        if ticket.error is not None:
            raise ticket.error
        return ticket.result

    def cancel(self, request_id: str) -> bool:
        """Cancel ONE queued or running request; its images are dropped at
        split time and co-batched requests are untouched."""
        with self._lock:
            t = self._tickets.get(str(request_id))
        if t is None:
            return False
        t.cancelled.set()
        return True

    # -- grouping ----------------------------------------------------------

    def _traced_rowspec(self, p):
        """The traced-LoRA cell of a payload: ``(0, 0)`` without tags, the
        ``(rank_bucket, slots)`` of its traced set when
        ``SDTPU_LORA_TRACED`` serves its tags, None when they take the
        merged path (the gate off, DPM adaptive, a set past the
        ladders)."""
        if "<lora:" not in (p.prompt or ""):
            return (0, 0)
        if not lora_mod.traced_enabled():
            return None
        _, tags = lora_mod.extract_lora_tags(p.prompt or "")
        if not tags:
            return (0, 0)
        if kd.resolve_sampler(p.sampler_name).adaptive:
            return None
        ts = self.engine._traced_set_for(tuple(tags))
        return None if ts is None else (ts.rank_bucket, ts.slots)

    def _coalescable(self, p) -> bool:
        """May this payload share a batch, and run ragged under
        SDTPU_RAGGED? DPM adaptive runs solo: its step controller reads one
        error over the whole batch, so a batch mate would change its
        image. Merged LoRA adapters, ControlNet units and an inpainting
        family's extra channels ride no coalesced batch, as in the JAX
        package."""
        if p.init_images or p.enable_hr or p.all_prompts:
            return False
        if p.refiner_checkpoint and p.refiner_switch_at < 1.0:
            return False
        if "<lora:" in (p.prompt or "") and self._traced_rowspec(p) is None:
            return False
        if kd.resolve_sampler(p.sampler_name).adaptive:
            return False
        if parse_controlnet_units(p):
            return False
        if self.engine.family.inpaint:
            return False
        return p.total_images <= self.max_batch

    def _ragged_eligible(self, p) -> bool:
        """May this payload run ragged (SDTPU_RAGGED)? A coalescable one
        without an active step cache: the deep feature's rows assume the
        dense layout, so a request with a cadence or a cutoff keeps its
        classic bucket."""
        if stepcache.resolve(p).active:
            return False
        return self._coalescable(p)

    def _precision_name(self, run) -> str:
        """A request's resolved serving precision: the group key's last
        axis and the dispatch mix's label."""
        # self may be None (the tests call _group_key unbound) or hold no
        # engine: the bf16 default either way
        policy = getattr(getattr(self, "engine", None), "policy", None)
        return precision_mod.resolve(run, policy).name

    def _group_key(self, run) -> tuple:
        # The JAX package's axes in its order. The step cache's cadence
        # and cutoff join: a group runs one denoise loop. The ragged
        # marker joins as a bool, NOT the true shape: shapes of one bucket
        # coalescing is the point, but a ragged and a classic request at
        # the same bucket run different denoise loops. The traced-LoRA
        # cell is key[-3:-1] ((0, 0) without tags; the adapter names never
        # enter the key) and the resolved precision the last axis: int8
        # and bf16 requests never share a batch.
        sc = stepcache.resolve(run)
        rs = ServingDispatcher._traced_rowspec(self, run) or (0, 0)
        return ("txt2img", run.sampler_name, int(run.steps),
                int(run.width), int(run.height), float(run.cfg_scale),
                run.negative_prompt or "", int(run.clip_skip or 0),
                sc.cadence, sc.cutoff_sigma,
                bool((run.override_settings or {}).get("ragged_true_wh")),
                int(rs[0]), int(rs[1]),
                ServingDispatcher._precision_name(self, run))

    def _run_grouped(self, ticket: Ticket) -> None:
        key = self._group_key(ticket.run)
        n = ticket.run.total_images
        with self._lock:
            g = self._groups.get(key)
            if g is None or g.closed or g.images + n > self.max_batch:
                g = _Group(key)
                self._groups[key] = g
                leader = True
            else:
                leader = False
            g.tickets.append(ticket)
            g.images += n
        if not leader:
            ticket.done.wait()
            return
        if self.window > 0:
            time.sleep(self.window)
        self._run_grouped_leader(g, key)

    def _run_grouped_leader(self, g: _Group, key) -> None:
        with self._exec_lock:
            # close AFTER taking the engine: followers kept joining while a
            # previous batch held the device (continuous batching)
            with self._lock:
                g.closed = True
                if self._groups.get(key) is g:
                    self._groups.pop(key)
            start = time.monotonic()
            for t in g.tickets:
                if not t.cancelled.is_set():
                    METRICS.record_queue_wait(start - t.enqueued)
            try:
                # the engine's own thread: cuBLAS and cuDNN state is per
                # thread, and a fresh thread may give other bits
                self.engine.run_on_device(self._execute_group, g)
            except BaseException as e:  # noqa: BLE001 — delivered per ticket
                for t in g.tickets:
                    if t.error is None and t.result is None:
                        t.error = e
            finally:
                for t in g.tickets:
                    t.done.set()

    def _run_solo(self, ticket: Ticket) -> None:
        engine = self.engine
        with self._exec_lock:
            try:
                engine.state.begin_request()
                if ticket.cancelled.is_set():
                    ticket.result = self._empty_result(ticket)
                    return
                METRICS.record_queue_wait(time.monotonic() - ticket.enqueued)
                METRICS.record_dispatch(
                    1, precision=self._precision_name(ticket.run))
                result = engine.generate_range(ticket.run, 0, None,
                                               ticket.job)
                if ticket.bucketed:
                    result = self._restore_solo(result, ticket)
                ticket.result = result
            except BaseException as e:  # noqa: BLE001 — raised by submit
                ticket.error = e
            finally:
                ticket.done.set()

    # -- merged execution (on the engine's device thread) --------------------

    def _execute_group(self, g: _Group) -> None:
        built = self._group_build_inputs(g)
        if built is None:
            return
        latents = self.engine._denoise(built["rp"], built["x"],
                                       built["keys"], built["ctx"],
                                       built["pooled"], "txt2img",
                                       ragged=built["ragged"],
                                       lora=built["lora"])
        imgs = self.engine._decode_u8(latents, built["width"],
                                      built["height"])[:built["b_raw"]]
        self._group_merge(built, imgs)

    def _group_build_inputs(self, g: _Group) -> Optional[Dict]:
        """Cancellation filter, per-ticket prompt encodes and noise draws,
        batch concat and pad-and-drop. Returns the denoise and merge
        inputs, or None when no ticket is still live."""
        engine = self.engine
        live = [t for t in g.tickets if not t.cancelled.is_set()]
        for t in g.tickets:
            if t not in live:
                t.result = self._empty_result(t)
        if not live:
            return None
        METRICS.record_dispatch(len(live), precision=g.key[-1])

        rp = live[0].run.model_copy()
        width, height = rp.width, rp.height
        h, w = engine._latent_hw(width, height)
        C = engine.family.vae.latent_channels
        spec = kd.resolve_sampler(rp.sampler_name)
        sigma0 = kd.build_sigmas(spec, engine.schedule, rp.steps)[0]
        engine.state.begin_request()
        # undoes any merge; a traced group's sets are installed per member
        engine._apply_prompt_loras(rp)
        traced = g.key[-3:-1] != (0, 0)
        row_sets: List[lora_mod.TracedSet] = []

        # context length pinned to the group max so every merged request
        # pads its conditioning identically
        chunks = max(engine.request_context_chunks(t.run) for t in live)
        # ragged group (a _group_key axis, uniform across the group): noise
        # is drawn at each request's TRUE latent rows and zero-padded to the
        # bucket, and the per-row lengths ride into the denoise as vectors
        ragged_mode = engine._ragged_plan(rp) is not None
        counts, noise_parts, key_parts, ctx_rows = [], [], [], []
        pooled_rows = []
        uncond = []  # each member's (ctx_u, pooled_u, images)
        lengths: List[List[int]] = [[], [], []]  # rows, ctx_true_u, _c
        for t in live:
            p = t.run.model_copy()
            p.context_chunks = chunks
            n_p = p.total_images
            counts.append(n_p)
            if traced:
                # this member's set, before its encode: its text-encoder
                # factors apply to its own conditioning
                _, tags = lora_mod.extract_lora_tags(p.prompt or "")
                ts = engine._traced_set_for(tuple(tags))
                if ts is None:
                    raise RuntimeError(f"traced LoRA set for {tags!r} no "
                                       f"longer resolvable at dispatch")
                engine._traced_lora = ts
                row_sets += [ts] * n_p
            rows = h
            if ragged_mode:
                rows = engine._true_latent_rows(h, engine._ragged_plan(p)[1])
                (cu, cc), (pu, pc), ctx_true = engine.encode_prompts(
                    p, ragged=True)
                for vec, n in zip(lengths, (rows, *ctx_true)):
                    vec += [n] * n_p
            else:
                (cu, cc), (pu, pc) = engine.encode_prompts(p)
            noise_parts.append(engine._init_noise(p, 0, n_p, (h, w, C),
                                                  rows))
            key_parts.append(engine._image_keys(p, 0, n_p))
            ctx_rows.append(cc.expand(n_p, -1, -1))
            pooled_rows.append(pc.expand(n_p, -1))
            uncond.append((cu, pu, n_p))

        b_raw = sum(counts)
        b_run = self.bucketer.bucket_batch(b_raw)
        noise = torch.cat(noise_parts)
        keys = torch.cat(key_parts)
        ctx_c = torch.cat(ctx_rows)
        pooled_c = torch.cat(pooled_rows)
        # the negative prompt is a group-key axis, so one encode serves
        # every row; but each traced member encoded it through its own
        # text-encoder factors, so there each row keeps its member's
        ctx_u, pooled_u = uncond[0][:2]
        if traced:
            ctx_u = torch.cat([u.expand(n, -1, -1) for u, _, n in uncond])
            pooled_u = torch.cat([p.expand(n, -1) for _, p, n in uncond])
        if b_run > b_raw:
            # pad-and-drop up to the batch bucket: the extra rows repeat
            # the last image and are discarded after decode
            pad = b_run - b_raw

            def _pad(a):
                return torch.cat([a, a[-1:].expand(pad, *a.shape[1:])])

            noise, keys, ctx_c = _pad(noise), _pad(keys), _pad(ctx_c)
            pooled_c = _pad(pooled_c)
            if traced:
                ctx_u, pooled_u = _pad(ctx_u), _pad(pooled_u)
        ragged = None
        if ragged_mode:
            ragged = tuple(torch.tensor(vec, dtype=torch.int32,
                                        device=engine.device)
                           for vec in lengths)
            if b_run > b_raw:
                ragged = tuple(_pad(vec) for vec in ragged)
        # each row's factors; the pad rows repeat the last member's set
        lora = (lora_mod.stack_row_sets(row_sets, b_run)["unet"]
                if traced else None)
        return {"live": live, "counts": counts, "rp": rp, "width": width,
                "height": height, "x": noise * sigma0, "keys": keys,
                "ctx": (ctx_u, ctx_c), "pooled": (pooled_u, pooled_c),
                "ragged": ragged, "lora": lora,
                "ragged_mode": ragged_mode, "b_raw": b_raw}

    def _group_merge(self, built: Dict, imgs: np.ndarray) -> None:
        """Split the batch's images back into per-ticket results: bucket
        crops (top-aligned for ragged rows) and per-image seeds and
        infotext of each original payload."""
        crop = self.bucketer.crop_ragged if built["ragged_mode"] \
            else self.bucketer.crop
        off = 0
        for t, n_p in zip(built["live"], built["counts"]):
            rows = imgs[off:off + n_p]
            off += n_p
            if t.cancelled.is_set():
                t.result = self._empty_result(t)
                continue
            out = GenerationResult(parameters=t.payload.model_dump())
            ow, oh = t.payload.width, t.payload.height
            if t.bucketed:
                rows = np.stack([crop(im, ow, oh) for im in rows])
            self.engine._append_images(out, t.payload, rows, 0, ow, oh)
            t.result = out

    # -- result fix-up -----------------------------------------------------

    @staticmethod
    def _empty_result(ticket: Ticket) -> GenerationResult:
        params = ticket.payload.model_dump()
        params["cancelled"] = True
        return GenerationResult(parameters=params)

    def _restore_solo(self, result: GenerationResult,
                      ticket: Ticket) -> GenerationResult:
        """Crop a bucketed solo run back to the requested size and rebuild
        infotext from the ORIGINAL payload so user-visible metadata shows
        the requested dimensions."""
        orig = ticket.payload
        bw, bh = ticket.run.width, ticket.run.height
        crop = self.bucketer.crop_ragged \
            if self.engine._ragged_plan(ticket.run) is not None \
            else self.bucketer.crop
        for i, b64 in enumerate(result.images):
            arr = b64png_to_array(b64)
            if arr.shape[:2] != (bh, bw):
                continue
            result.images[i] = array_to_b64png(
                crop(arr, orig.width, orig.height))
            result.infotexts[i] = build_infotext(
                orig, int(result.seeds[i]), int(result.subseeds[i]),
                self.engine.model_name, orig.width, orig.height)
        return result
