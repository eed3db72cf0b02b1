"""The generation engine: txt2img, img2img and inpainting in PyTorch.

Port of the JAX package's ``pipeline/engine.py``: encode the prompts
(CLIP, clip skip, emphasis with the chunk mean restored, 77-token chunks
joined; SDXL's two encoders joined on the channel axis, the pooled output
from the second), draw each image's init
noise from its seed, denoise with classifier-free guidance over two rows in
a chunked loop that polls the interrupt between chunks (DPM adaptive: a
host PID loop that polls it between attempts), decode to uint8 pixels, and
return base64 PNGs with per-image seeds and infotext.

SDXL: the UNet takes the added conditioning (pooled text and the
micro-conditioning time ids, :meth:`Engine._added_cond`) per row. A request
that names a refiner (``refiner_checkpoint``, ``refiner_switch_at < 1``)
hands its latents, at the switch step, to the engine that
``engine_provider`` returns for that name, which finishes the sigma ladder
with its own conditioning; an unknown name runs the base model alone, as in
the JAX package.

img2img (``init_images``): the init image is VAE-encoded once and noised to
the sigma of step ``steps - int(min(strength, 0.999) * steps)``, where the
ladder is entered. With a ``mask`` (white = repaint), blurred by
``mask_blur`` and taken down to latent size, the region outside it is
pinned after every step to the init latent noised to the next sigma;
``inpainting_fill`` chooses what the masked region starts from. An
inpainting family (9 UNet input channels) gets the mask and the encoded
masked image as extra channels, a blank conditioning when there is no
mask. A masked request runs the base model alone.

ControlNet (``alwayson_scripts["controlnet"]``): each enabled unit's image
goes through its preprocessor on the host; its ControlNet, loaded once per
name from ``controlnet_provider``, sees the bare 4-channel latent and the
hint at every step whose ``(step + 0.5) / steps`` lies in the unit's
guidance window; the residuals, scaled by the unit's weight and summed over
units in f32, are added to the UNet's skips. A step outside every window
runs no ControlNet. A unit whose model the provider lacks is skipped with a
warning, as in the JAX package.

Seed-exact sub-ranges carry over: ``generate_range(payload, start, count)``
produces images ``[start, start+count)`` of the request, equal to the same
rows of the whole-batch run, because every draw is keyed by
``seed + image index`` and never by batch position.

Ragged dispatch: a payload that carries the serving bucketer's
``ragged_true_wh`` marker runs at its bucket's shape with its true latent
rows as data. Each prompt is encoded at its own chunk count and padded,
the init noise is drawn at the true rows and zero-padded, the UNet masks
attention past each row's valid prefix (kernel K2), and the rows past it
are re-zeroed after every sampler step. The serving dispatcher builds such
batches from several requests and hands them to :meth:`Engine._denoise`
with per-row contexts and lengths. Lengths stay device tensors, never read
back to the host. ControlNet, inpainting families, the hires fix and refiner
handoffs never run ragged. SDXL's added conditioning rides on every row;
its time ids are the bucket's size, which the bucketer wrote into the
payload, not the request's true size (as in the JAX package).

LoRA (``<lora:name:w[:te_w]>`` tags, adapters from ``lora_provider``): the
tags are stripped before tokenizing and kept in the infotext. By default the
adapters are merged into the weights (:meth:`Engine.set_loras`): each leaf
they touch is kept pristine and rewritten as ``(pristine.float() + w *
delta).to(dtype)``, so removing them restores the pristine bytes. Under
``SDTPU_LORA_TRACED=1`` they resolve to a traced set (``models/lora.py``)
whose factors ride into the text encoders and the UNet with the weights
left pristine; a set past the rank or slot ladder, or a DPM adaptive
request, takes the merged path instead, as in the JAX package.

Hires fix (``enable_hr``, the JAX package's ``_hires_pass``): after each
group's denoise, the latents go to the target size (``hr_resize_x/y``, else
``hr_scale`` times the request's, floored to the VAE factor) and get a
second denoise of ``hr_second_pass_steps`` (default ``steps``) from step
``steps2 - int(min(strength, 0.999) * steps2)``, re-noised there with
noise keyed ``fold_in(k, 2_000_000)`` per image. A latent upscaler name
resizes the latents on the device (:func:`~.image.resize_device`); a name
that ``upscaler_provider`` resolves to an RRDBNet decodes to f32 pixels,
upscales them (``models/esrgan.py``) and encodes them again; any other name
falls back to latent bilinear with a warning. ControlNet hints, an
inpainting family's blank conditioning and the refiner switch apply inside
the second pass as well.

A standalone VAE (webui's ``sd_vae``, :meth:`Engine.set_vae`) replaces the
checkpoint's decoder and encoder, which are kept aside and come back
exactly with ``set_vae(None)``.

Per-image prompts (``all_prompts``, which the prompt-matrix and
prompts-from-file scripts fill, ``payload.apply_scripts``): each group's
rows get their own prompts' conditioning (:meth:`Engine._group_conds`),
every distinct prompt encoded once and padded to the request-wide chunk
count (``context_chunks``, pinned over every row before a fleet slices
the request), and each image carries its own prompt in ``prompts`` and
its infotext. Such a request never runs ragged.

Textual inversion (``embedding_store``, ``models/embeddings.py``): a
prompt's embedding names become placeholder tokens whose token-embedding
rows the text encoders replace with the learned vectors; the conditioning
cache keys on the store's generation, so a rescan serves nothing stale.

On the card every UNet evaluation (the ControlNet units and the UNet)
replays a CUDA graph per input signature (``runtime/graphs.py``), captured
at the signature's first call or by the warmup sweep
(``serving/warmup.py``); the samplers' step math, the interrupt and
progress loop and DPM adaptive's host loop stay eager.

Serving precision (``precision`` or ``override_settings.precision``,
``pipeline/precision.py``): resolved once per range and passed to every
UNet and ControlNet evaluation, DPM adaptive's attempts, img2img,
inpainting, hires and the refiner included; ``int8`` runs the transformer
linears as W8A8 products of the same weights, ``int8+conv`` the convs too.

Step cache (``override_settings.deepcache`` / ``cfg_cutoff``,
``pipeline/stepcache.py``): the deep UNet part is refreshed every
``cadence`` steps and reused in between, and past the CFG cutoff only the
cond rows run (:meth:`Engine._denoise`). Ragged dispatch and DPM adaptive
take no cache; a chunk with an active ControlNet unit runs the plain
evaluation.

The caching tier (``SDTPU_CACHE=1``, ``cache/``): the process-wide embed
store replaces the engine's conditioning cache (:meth:`Engine.
encode_prompts`), and a plain txt2img range of a single-group request
captures its sampler carry at a chunk boundary for a later request with the
same prefix key to resume from (``cache/prefix.py``, :meth:`Engine.
_denoise`). ``_model_epoch`` (bumped by a LoRA merge or a VAE swap) and
``_cond_epoch`` (a LoRA merge) enter the keys, so an entry computed under
older weights is never served.

The stage-graph executor (``SDTPU_STAGE_GRAPH``, ``parallel/
stage_graph.py``): txt2img without a refiner, hires fix or adaptive sampler
runs each group as an encode -> denoise -> decode graph whose stages
dispatch without waiting (:meth:`Engine._run_txt2img_staged`); a
qualifying ControlNet request runs its tower a step ahead of the UNet in
graphs of its own (:meth:`Engine._denoise_staged_cn`). The decode of every
path goes into pinned host memory behind a CUDA event (:meth:`Engine.
_queue_decoded`), and the serial loops keep one group's decode in flight
while they encode the previous group's PNGs, as the JAX package's do. The
denoise loop reads no device value back: it paces on one CUDA event per
chunk.

A mesh (``mesh``, ``runtime/mesh.py``; one process over a grid of
``torch.device`` objects, the JAX engine's ``mesh`` argument): the engine lives
on the mesh's home device, where the sampler math, the text encoders, the
VAE encoder and the conditioning stay. Each ``dp`` replica holds the UNet,
the ControlNets and the VAE decoder on its home device (one copy per
device: a virtual mesh over one card holds them once) and runs its block
of rows of every UNet evaluation and every decode when the batch divides
``dp``; otherwise replica 0 runs the whole batch, the JAX package's
odd-batch fallback. The rows come back in global order. Under ``tp`` every
model computes the layers that JAX's rule splits on their shards, as the
JAX engine shards its whole parameter tree: the UNet, the ControlNets and
the VAE decoder on each replica's devices, the text encoders and the VAE
encoder on replica 0's (they take every row, as the JAX engine runs them
replicated over ``dp``). Under ``sp`` the UNet's and the ControlNets'
self-attention runs on the ring (``models/unet.py``
:func:`~..models.unet.place_layers`). The placement is made at
construction and again after a VAE swap or a LoRA merge, from the full
weights (:meth:`Engine.set_mesh`). An evaluation whose replica lies on one
device replays one CUDA graph per replica; a ``tp`` or ``sp`` replica over
several cards runs eagerly. The text encoders and the VAE run eagerly, on
a mesh as without one.
Every precision and traced LoRA run under ``tp`` too: a split int8 product
gives the meshless layer's values, and a traced site adds each shard's
share of its delta (``models/unet.py``).

Chunk-boundary preemption (the fleet tier, ``fleet/policy.py``): while a
preemptible job runs, the dispatcher installs a hook as ``preempt_hook``;
the chunked loop polls it between chunks and, when an entitled waiter is
queued, yields the device there. Every generation runs on the engine's one
device thread (``runtime/runner.py``), so the yield serves the
interloper's work nested on that thread while the yielding frame keeps its
carry, position, step cache and prefix plan: the resumed job gives the
bytes of an unpreempted run. DPM adaptive takes no hook, as in the JAX
package.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import threading
import time
import weakref
from collections import OrderedDict, deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from stable_diffusion_webui_distributed_tpu_torch.bridge import (
    StateDicts,
    build_modules,
)
from stable_diffusion_webui_distributed_tpu_torch.cache import (
    embed as embed_cache,
)
from stable_diffusion_webui_distributed_tpu_torch.cache import (
    keys as cache_keys,
)
from stable_diffusion_webui_distributed_tpu_torch.cache import (
    prefix as cache_prefix,
)
from stable_diffusion_webui_distributed_tpu_torch.models.clip import (
    pad_encoded_context,
)
from stable_diffusion_webui_distributed_tpu_torch.parallel import sharding
from stable_diffusion_webui_distributed_tpu_torch.parallel import stage_graph
from stable_diffusion_webui_distributed_tpu_torch.models.configs import (
    ModelFamily,
)
from stable_diffusion_webui_distributed_tpu_torch.models import (
    lora as lora_mod,
)
from stable_diffusion_webui_distributed_tpu_torch.models.controlnet import (
    ControlNet,
    run_preprocessor,
)
from stable_diffusion_webui_distributed_tpu_torch.models.embeddings import (
    EmbeddingStore,
    build_injection_arrays,
)
from stable_diffusion_webui_distributed_tpu_torch.models.prompt import (
    CHUNK_CONTENT,
    pad_chunks,
    tokenize_with_embeddings,
    true_token_count,
)
from stable_diffusion_webui_distributed_tpu_torch.models.tokenizer import (
    load_tokenizer,
)
from stable_diffusion_webui_distributed_tpu_torch.models import (
    unet as unet_mod,
)
from stable_diffusion_webui_distributed_tpu_torch.models.unet import (
    cache_supported,
    deep_cache_shape,
    make_added_cond,
    norms_to_f32,
)
from stable_diffusion_webui_distributed_tpu_torch.models.vae import (
    Decoder,
    Encoder,
    encode,
)
from stable_diffusion_webui_distributed_tpu_torch.obs import (
    prometheus as obs_prom,
)
from stable_diffusion_webui_distributed_tpu_torch.obs import (
    spans as obs_spans,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline.image import (
    box_blur,
    latent_resize_method,
    resize_bilinear,
    resize_device,
    resize_image,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline import (
    precision as precision_mod,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline import stepcache
from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    GenerationPayload,
    GenerationResult,
    apply_scripts,
    array_to_b64png,
    b64png_to_array,
    build_infotext,
    fix_seed,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime import dtypes, rng
from stable_diffusion_webui_distributed_tpu_torch.runtime import (
    graphs as graphs_mod,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime import trace
from stable_diffusion_webui_distributed_tpu_torch.runtime.mesh import (
    Mesh,
    build_mesh,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.config import (
    env_int,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime import (
    interrupt as interrupt_mod,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.runner import (
    DeviceRunner,
)
from stable_diffusion_webui_distributed_tpu_torch.samplers import (
    kdiffusion as kd,
)
from stable_diffusion_webui_distributed_tpu_torch.samplers import (
    schedules as sched,
)
from stable_diffusion_webui_distributed_tpu_torch.serving.metrics import (
    METRICS,
)

log = logging.getLogger(__name__)

#: one ControlNet unit as the denoiser takes it: (module, hint (1,H,W,3) f32
#: on the device, weight, guidance start, guidance end)
Control = Tuple[torch.nn.Module, torch.Tensor, float, float, float]


def _load(module: torch.nn.Module, state_dict, device,
          dtype: torch.dtype) -> torch.nn.Module:
    """A module built on the meta device, its weights copied from
    ``state_dict`` (any dtype, any device) into ``dtype`` on ``device``
    one tensor at a time: no copy of the whole model in another dtype
    exists on the way."""
    module = module.to(dtype).to_empty(device=device)
    module.load_state_dict(state_dict, strict=True)
    return module.requires_grad_(False).eval()


class Engine:
    """One loaded model family on one device.

    ``params`` are the port's state dicts (``bridge.flax_to_torch`` or
    ``bridge.init_seeded``). ``device`` is ``cuda`` unless named; with none
    named and no GPU present the constructor raises. ``engine_provider``
    maps a refiner name to the engine that finishes a request's sigma
    ladder (None: no refiner); ``controlnet_provider`` maps a unit's model
    name to a ControlNet state dict (``bridge.controlnet_flax_to_torch`` or
    ``bridge.init_seeded_controlnet``; None: unknown); ``lora_provider``
    maps an adapter name to its kohya state dict (``ModelRegistry.
    lora_provider``; None: no adapters); ``upscaler_provider`` maps a
    hires upscaler name to ``upscale(imgs, target_w, target_h)`` on the
    engine's device (``ModelRegistry.upscaler_provider``; None: latent
    upscalers only); ``embedding_store`` resolves the textual-inversion
    names prompts mention (``ModelRegistry.embedding_store``; None:
    none). ``cuda_graphs``: on the card, each UNet evaluation replays a
    CUDA graph captured at its shape's first call (``runtime/graphs.py``;
    the attribute may be switched between requests to time the eager path
    beside it). CPU tensors always run eagerly. ``mesh``: a
    :class:`~..runtime.mesh.Mesh` to place the model over (see the
    module's docstring); its home device is the engine's device, and a
    ``device`` named beside it must be that one."""

    def __init__(
        self,
        family: ModelFamily,
        params: StateDicts,
        tokenizer=None,
        policy: dtypes.Policy = dtypes.F32,
        model_name: str = "",
        state: Optional[interrupt_mod.GenerationState] = None,
        chunk_size: int = 10,
        schedule: Optional[sched.NoiseSchedule] = None,
        device=None,
        engine_provider: Optional[Callable[[str], Optional["Engine"]]] = None,
        controlnet_provider: Optional[
            Callable[[str], Optional[Dict[str, torch.Tensor]]]] = None,
        lora_provider: Optional[Callable[[str], Optional[Dict]]] = None,
        upscaler_provider: Optional[
            Callable[[str], Optional[Callable]]] = None,
        embedding_store: Optional[EmbeddingStore] = None,
        cuda_graphs: bool = True,
        mesh: Optional[Mesh] = None,
    ):
        if mesh is not None:
            if device is not None and not _same_device(torch.device(device),
                                                       mesh.home()):
                raise ValueError(f"device {device} is not the home device "
                                 f"{mesh.home()} of {mesh}")
            device = mesh.home()
        self.device = dtypes.resolve_device(device)
        self.family = family
        self.policy = policy
        self.model_name = model_name or family.name
        self.state = state or interrupt_mod.STATE
        # the caching tier's weight epochs (cache/keys.py
        # model_fingerprint): a LoRA merge bumps both, a VAE swap the model
        # epoch, so content-addressed entries of older weights retire
        self._model_epoch = 0
        self._cond_epoch = 0
        self.chunk_size = max(1, chunk_size)
        self.schedule = schedule or sched.sd_schedule(
            prediction_type=family.prediction_type)
        self.tokenizer = tokenizer or load_tokenizer(
            None, family.text_encoder.vocab_size)

        with torch.device("meta"):
            modules = build_modules(family)
        pd, cd = policy.param_dtype, policy.compute_dtype
        loaded = {name: _load(m, params[name], self.device, pd)
                  for name, m in modules.items()}
        # weights are stored in param_dtype and computed in compute_dtype;
        # the norms, the UNet's conv_out and the whole VAE decoder compute
        # in f32; the VAE encoder computes in compute_dtype
        self.text_encoder = norms_to_f32(loaded["text_encoder"].to(cd))
        # SDXL's second (OpenCLIP bigG) encoder
        self.text_encoder_2 = (
            norms_to_f32(loaded["text_encoder_2"].to(cd))
            if "text_encoder_2" in loaded else None)
        self.unet = norms_to_f32(loaded["unet"].to(cd))
        self.unet.conv_out.float()
        self.vae, self.vae_encoder = self._vae_policy(loaded["vae"],
                                                      loaded["vae_encoder"])
        # the checkpoint's own VAE while set_vae's override is applied
        self._checkpoint_vae: Optional[Tuple[torch.nn.Module,
                                             torch.nn.Module]] = None
        # the serving precision of a request that names none: the policy's
        # own flags (pipeline/precision.py)
        self._default_precision = precision_mod.policy_default(policy)
        #: evaluations by kind of the last denoise range that ran the step
        #: cache (``stepcache.plan_schedule``'s keys), None when it ran
        #: without it
        self.last_step_evals: Optional[Dict[str, int]] = None
        self.engine_provider = engine_provider
        self.controlnet_provider = controlnet_provider
        self.upscaler_provider = upscaler_provider
        self.embedding_store = embedding_store
        # ControlNets by unit model name, each loaded to the device once
        self._controlnets: Dict[str, torch.nn.Module] = {}
        # an inpainting family's blank conditioning per (batch, w, h)
        self._blank_cond_cache: Dict[Tuple[int, int, int], torch.Tensor] = {}
        #: UNet-call attempts of the last DPM adaptive run (3 evaluations
        #: each), and whether that run stopped at its attempt backstop
        self.last_adaptive_attempts = 0
        self._adaptive_incomplete = False
        # the captured UNet evaluations, dropped with the engine
        self.cuda_graphs = cuda_graphs
        self._graphs = graphs_mod.GraphCache()
        # Cooperative chunk-boundary preemption (fleet/policy.py): while a
        # preemptible job runs, the fleet gate installs an object with
        # should_yield()/yield_device() here and the denoise loop polls it
        # between chunks. Work that runs nested during a yield sees the
        # same attribute: the hook answers only its owning execution.
        self.preempt_hook = None

        # LoRA. _active_loras latches () (pristine) or the (specs,
        # provider generation) pair the last merge ran for, missing names
        # included, so an identical repeat is a no-op until a rescan bumps
        # the generation. _pristine holds each merged leaf's pristine
        # weight; _traced_lora is the active traced set (None: none), with
        # an LRU of built sets by (specs, generation).
        self.lora_provider = lora_provider
        self._lora_leaves = {
            name: dict(module.named_parameters())
            for name, module in (("unet", self.unet),
                                 ("text_encoder", self.text_encoder),
                                 ("text_encoder_2", self.text_encoder_2))
            if module is not None}
        self._active_loras: Tuple = ()
        self._pristine: Dict[Tuple[str, str], torch.Tensor] = {}
        self._traced_lora: Optional[lora_mod.TracedSet] = None
        # the dispatcher asks for sets from its request threads
        self._traced_lock = threading.Lock()
        self._traced_cache: "OrderedDict[Tuple, lora_mod.TracedSet]" = \
            OrderedDict()  # guarded-by: _traced_lock
        self._TRACED_CACHE_MAX = 8
        #: merges run (one per adapter), their seconds, and the modules
        #: the last merge applied and skipped
        self._lora_merge_total = 0
        self._lora_merge_seconds = 0.0
        self.last_lora_counts = (0, 0)
        self.last_traced_build_seconds = 0.0
        #: the warmup sweep's traced-LoRA ladder cell (rank bucket, slots),
        #: served by an all-zero stand-in set (``serving/warmup.py``)
        self._warmup_lora: Optional[Tuple[int, int]] = None

        # cross-request conditioning cache (webui's cached_c/cached_uc),
        # keyed on prompt text + clip skip + chunk count + the embedding
        # store's generation
        self._cond_cache: "OrderedDict[Tuple, Tuple]" = OrderedDict()
        self._COND_CACHE_MAX = 64
        #: UNet-evaluation prices (meta-tensor FLOP counts) for
        #: ``METRICS``'s FLOPs per image and the perf ledger
        self._flops = stepcache.FlopsAccountant(self)
        # Every generation runs on this one thread, whichever thread asks.
        # PyTorch keeps cuBLAS and cuDNN handles and cuDNN's plan cache per
        # thread, and on the card the same UNet call made from a fresh
        # thread can give other bits; a repeated request must give the same
        # image bytes. One thread also serialises the engine's requests; a
        # preempted job serves the interloper's tasks on it
        # (runtime/runner.py). The thread ends when the engine is freed.
        #: the fleet's preempt hook serves a yield on it
        self.device_runner = DeviceRunner("engine")
        weakref.finalize(self, self.device_runner.close)
        #: the mesh the model is placed over (None: the engine's device),
        #: and each placed module's replicas by (module, mesh)
        self.mesh: Optional[Mesh] = None
        self._placed: Dict[Tuple[int, int], Tuple] = {}
        # the stage-ahead ControlNet tower's mesh, by its device count
        self._stage_cn_mesh_cache: Optional[Tuple[int, Optional[Mesh]]] = None
        self.set_mesh(mesh)

    # -- text conditioning -------------------------------------------------

    def _encode(self, ids: np.ndarray, weights: np.ndarray, skip: int,
                inject=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(n_chunks, 77) ids/weights -> (context (1, n*77, D) f32, pooled
        (1, D') f32): emphasis scales the tokens, the chunk mean is
        restored, the chunks join along the sequence axis. With a second
        encoder (SDXL) the two contexts join on the channel axis and the
        pooled output is the second's, from the first chunk. An active
        traced set whose factors touch a text encoder adds its deltas.
        ``inject``: ``(mask, values_l, values_g)`` device tensors of
        :meth:`_injection`, the textual-inversion rows of each encoder."""
        with obs_spans.device_interval(self.device):
            return self._encode_on_device(ids, weights, skip, inject)

    def _encode_on_device(self, ids, weights, skip, inject):
        ids_t = dtypes.to_device(torch.from_numpy(ids).long(), self.device)
        skip_arg = skip if skip else None
        ts = self._traced_lora
        te = ts.tree if ts is not None and ts.te_content else {}
        mask, val_l, val_g = inject if inject is not None else (None,) * 3
        ctx, pooled = self.text_encoder(ids_t, skip=skip_arg,
                                        lora=te.get("text_encoder"),
                                        inject_values=val_l,
                                        inject_mask=mask)
        if self.text_encoder_2 is not None:
            ctx2, pooled = self.text_encoder_2(
                ids_t, skip=skip_arg, lora=te.get("text_encoder_2"),
                inject_values=val_g, inject_mask=mask)
            ctx = torch.cat([ctx.float(), ctx2.float()], dim=-1)
        ctx = ctx.float()
        w = dtypes.to_device(torch.from_numpy(weights), self.device)
        orig_mean = ctx.mean(dim=(1, 2), keepdim=True)
        ctx = ctx * w[:, :, None]
        new_mean = ctx.mean(dim=(1, 2), keepdim=True)
        ratio = torch.where(new_mean.abs() > 1e-7, orig_mean / new_mean,
                            torch.ones_like(new_mean))
        ctx = ctx * ratio
        return ctx.reshape(1, -1, ctx.shape[-1]), pooled[:1].float()

    def _embedding_counts(self):
        """``{name: n_vectors}`` for the tokenizer, or None with no store
        or an empty directory."""
        if self.embedding_store is None:
            return None
        counts = self.embedding_store.vector_counts()
        return counts or None

    def _injection(self, injections, n_chunks: int):
        """A prompt's placeholders -> ``(mask, values_l, values_g)`` on the
        device for :meth:`_encode`, or None when none is injected (an
        all-zero mask would give the same conditioning)."""
        if not injections:
            return None
        enc2 = self.family.text_encoder_2
        mask, val_l, val_g = build_injection_arrays(
            injections, n_chunks, CHUNK_CONTENT + 2, self.embedding_store,
            self.family.text_encoder.hidden_size,
            enc2.hidden_size if enc2 is not None else 0)
        if not mask.any():
            return None
        return tuple(dtypes.to_device(torch.from_numpy(a), self.device)
                     for a in (mask, val_l, val_g))

    def encode_prompts(self, payload: GenerationPayload, prompts=None,
                       ragged: bool = False):
        """``((ctx_u, ctx_c), (pooled_u, pooled_c))`` for the request's
        prompt and its negative prompt, padded to one chunk count: the
        longest of them, and at least ``payload.context_chunks``.

        ``prompts``: one prompt per image (per-image prompts); ``ctx_c``
        and ``pooled_c`` then have a row each, every distinct prompt
        encoded once. Textual-inversion names resolve against the
        embedding store.

        ``ragged``: each prompt is encoded at its own chunk count (so one
        cache entry serves it in any group) and the encoded rows are
        zero-padded to the request's; a third item ``(ctx_true_u,
        ctx_true_c)`` gives the valid context tokens of each half, which
        the UNet's cross-attention masks the padding by (one prompt
        only)."""
        tok = self.tokenizer
        counts = self._embedding_counts()
        prompt_list = [payload.prompt] if prompts is None else list(prompts)
        cleaned = [lora_mod.extract_lora_tags(p)[0] for p in prompt_list]
        toks = {c: tokenize_with_embeddings(tok, c, counts)
                for c in dict.fromkeys(cleaned)}
        ids_u, w_u, inj_u = tokenize_with_embeddings(
            tok, payload.negative_prompt, counts)
        # cond and uncond agree on the context length; context_chunks
        # floors it at the request-wide maximum, so an image's
        # conditioning does not depend on its group or its worker's range
        n = max([t[0].shape[0] for t in toks.values()] + [ids_u.shape[0]]
                + ([payload.context_chunks] if payload.context_chunks
                   else []))
        depth = self.family.text_encoder.num_layers
        if self.family.text_encoder_2 is not None:
            depth = min(depth, self.family.text_encoder_2.num_layers)
        skip = min(12, depth - 1, max(0, int(payload.clip_skip or 0)))
        store_gen = (self.embedding_store.generation
                     if self.embedding_store is not None else 0)
        shared = cache_keys.enabled()

        def cached(raw, ids, w, inj, negative=False):
            # merges clear the cache; a traced set's text-encoder factors
            # key it by their content, a rescan of the embeddings by the
            # store's generation. With SDTPU_CACHE the process-wide store
            # replaces it, its keys holding the same facts.
            n_enc = ids.shape[0] if ragged else n

            def fresh():
                return self._encode(
                    *pad_chunks(ids, w, n_enc, tok.eos, tok.bos), skip,
                    self._injection(inj, n_enc))

            if shared:
                return embed_cache.lookup_or_encode(self, raw, skip, n_enc,
                                                    negative, fresh)
            key = (raw, skip, n_enc, store_gen, self.traced_te_content())
            hit = self._cond_cache.get(key)
            if hit is not None:
                self._cond_cache.move_to_end(key)
                return hit
            out = fresh()
            self._cond_cache[key] = out
            if len(self._cond_cache) > self._COND_CACHE_MAX:
                self._cond_cache.popitem(last=False)
            return out

        with trace.STATS.timer("text_encode"):
            encoded = {c: cached(c, *t) for c, t in toks.items()}
            ctx_c, pooled_c = encoded[cleaned[0]]
            if len(cleaned) > 1:
                ctx_c = torch.cat([encoded[c][0] for c in cleaned])
                pooled_c = torch.cat([encoded[c][1] for c in cleaned])
            ctx_u, pooled_u = cached(payload.negative_prompt, ids_u, w_u,
                                     inj_u, negative=True)
        if not ragged:
            return (ctx_u, ctx_c), (pooled_u, pooled_c)
        width = ids_u.shape[1]
        ctx_true = (ids_u.shape[0] * width,
                    toks[cleaned[0]][0].shape[0] * width)
        return ((pad_encoded_context(ctx_u, n, width),
                 pad_encoded_context(ctx_c, n, width)),
                (pooled_u, pooled_c), ctx_true)

    def request_context_chunks(self, payload: GenerationPayload) -> int:
        """The request's context length in 77-token chunks: the longest of
        every ``all_prompts`` row (else its prompt) and its negative
        prompt, embeddings counted. A fleet pins it into
        ``payload.context_chunks`` before slicing the request, and a
        coalesced group pads every member's conditioning to the group's
        largest."""
        tok = self.tokenizer
        counts = self._embedding_counts()
        prompts = list(payload.all_prompts or [payload.prompt])
        lengths = [tokenize_with_embeddings(
            tok, lora_mod.extract_lora_tags(p)[0], counts)[0].shape[0]
            for p in prompts]
        lengths.append(tokenize_with_embeddings(
            tok, payload.negative_prompt, counts)[0].shape[0])
        return int(max(lengths))

    def request_token_stats(self, payload: GenerationPayload,
                            chunks: Optional[int] = None) -> Tuple[int, int]:
        """``(true_tokens, padded_tokens)`` of the request's conditioning,
        the perf ledger's ``token_padding_ratio``: BOS, content and the
        closing EOS of each chunk of the prompt and the negative prompt
        (``models/prompt.py`` ``true_token_count``), against both halves
        padded to ``chunks`` (default the longer) 77-token windows.
        Tokenizes again: callers gate on ``SDTPU_PERF``."""
        counts = self._embedding_counts()
        eos = self.tokenizer.eos
        ids_c = tokenize_with_embeddings(
            self.tokenizer, lora_mod.extract_lora_tags(payload.prompt)[0],
            counts)[0]
        ids_u = tokenize_with_embeddings(
            self.tokenizer, payload.negative_prompt, counts)[0]
        if chunks is None:
            chunks = max(ids_c.shape[0], ids_u.shape[0],
                         int(payload.context_chunks or 0))
        true = true_token_count(ids_c, eos) + true_token_count(ids_u, eos)
        return int(true), int(2 * chunks * (CHUNK_CONTENT + 2))

    def _group_conds(self, payload: GenerationPayload, pos: int, n: int,
                     refiner: Optional["Engine"]):
        """Per-row conditioning of images ``[pos, pos+n)`` of a request
        with ``all_prompts``, and the refiner's; pad-and-drop rows past
        the list repeat its last prompt (their images are dropped)."""
        prompts = list(payload.all_prompts[pos:pos + n]) or [payload.prompt]
        while len(prompts) < n:
            prompts.append(prompts[-1])
        conds, pooleds = self.encode_prompts(payload, prompts=prompts)
        ref_cond = (refiner.encode_prompts(payload, prompts=prompts)
                    if refiner is not None else None)
        return conds, pooleds, ref_cond

    @staticmethod
    def _ragged_plan(payload: GenerationPayload) -> Optional[Tuple[int, int]]:
        """``(true_w, true_h)`` when the payload carries the serving
        bucketer's ragged marker, else None."""
        wh = (payload.override_settings or {}).get("ragged_true_wh")
        if not wh:
            return None
        return int(wh[0]), int(wh[1])

    def _latent_hw(self, width: int, height: int) -> Tuple[int, int]:
        f = self.family.vae_scale_factor
        return height // f, width // f

    def _true_latent_rows(self, lat_h: int, true_h: int) -> int:
        """Latent rows that hold a ``true_h``-pixel image in a bucket of
        ``lat_h`` rows (a partial row still needs its pixels)."""
        return min(lat_h, -(-true_h // self.family.vae_scale_factor))

    # -- denoise -------------------------------------------------------------

    def _added_cond(self, pooleds, width: int, height: int,
                    aesthetic_score: float = 6.0):
        """SDXL micro-conditioning ``(added_u, added_c)``, one row per
        pooled row, or None for a family without it. The id count follows
        from the projection width: 6 for the base model (original, crop and
        target sizes), 5 for the refiner (sizes and an aesthetic score, 6.0
        on the positive row and 2.5 on the negative)."""
        ucfg = self.family.unet
        if not ucfg.addition_embed_dim:
            return None
        pooled_u, pooled_c = pooleds
        n_ids = (ucfg.projection_input_dim - ucfg.addition_embed_dim) \
            // ucfg.addition_time_embed_dim
        if n_ids == 5:
            ids_c = [height, width, 0, 0, aesthetic_score]
            ids_u = [height, width, 0, 0, 2.5]
        else:
            ids_c = [height, width, 0, 0, height, width][:n_ids]
            ids_u = ids_c

        def added(pooled, ids):
            tid = dtypes.to_device(
                torch.tensor([ids], dtype=torch.float32), pooled.device)
            return make_added_cond(pooled, tid.expand(pooled.shape[0], -1),
                                   ucfg.addition_time_embed_dim)

        return added(pooled_u, ids_u), added(pooled_c, ids_c)

    def _make_denoise_fn(self, ctx_u, ctx_c, cfg_scale: float, batch: int,
                         ragged=None, added=None,
                         controls: Sequence[Control] = (), gates=None,
                         inpaint_cond: Optional[torch.Tensor] = None,
                         lora: Optional[Dict] = None,
                         precision: Optional[
                             precision_mod.PrecisionSpec] = None,
                         cache: Optional["_StepCache"] = None,
                         stage_ahead: bool = False,
                         tower: Optional[Mesh] = None):
        """x0-prediction denoiser with classifier-free guidance: one UNet
        call on ``[uncond; cond]`` rows per evaluation. ``ctx_c`` is one
        ``(1, L, D)`` context or one per row; so is ``added``'s second
        item (SDXL's added conditioning ``(added_u, added_c)``).

        ``ragged``: ``(true_rows, ctx_true_u, ctx_true_c)``, ``(batch,)``
        int device tensors. The CFG doubling repeats ``true_rows`` and puts
        the two context lengths in the order of the rows.

        ``controls``: ControlNet units; each runs on the bare latent rows
        with its hint over both CFG halves, and its residuals, cast to f32
        and multiplied by its gate, are summed over units. A unit's gate
        is ``gates(step)[k]`` (:func:`window_gates` on the fixed grid,
        :func:`adaptive_gates` under DPM adaptive); a unit gated to 0 is
        not run. ``inpaint_cond``:
        an inpainting family's ``(batch, h, w, 1 + C)`` extra UNet input
        channels, the same for both CFG halves. ``lora``: a traced adapter
        tree with ``[batch, S, ...]`` leaves for the UNet, doubled for the
        two CFG halves (the ControlNet runs without it, as in the JAX
        package). ``precision``: the serving precision of the UNet and the
        units (None: the policy's default).

        Each evaluation (the units that run and the UNet) goes through the
        engine's graph cache (``runtime/graphs.py``) while ``cuda_graphs``
        is on: on the card it replays the graph of its inputs' signature,
        captured at the first call. The timestep and the gates are scalars
        of the graph, the conditioning its per-run inputs, the latent rows
        its per-call input. The graph's tag holds the precision's flags
        and the cache mode, which the inputs' signatures do not tell
        apart. The sampler's step math stays eager.

        ``cache`` (a :class:`_StepCache`): the result is ``(denoise,
        refresh, reuse)``. ``refresh(x, sigma, step)`` runs the deep
        evaluation at the step's entry latent and copies it into the
        cache (its output lives in the graphs' pool, which the next replay
        may overwrite); ``reuse`` is ``denoise`` over the shallow levels
        from the cache. From ``cache.cfg_stop`` on both run the cond rows
        only (the refresh mirrors them into both halves of the cache).

        ``stage_ahead`` (the stage-graph executor's ControlNet, :meth:`
        _denoise_staged_cn`): the result is ``(denoise, ahead)``. ``ahead(x,
        sigma, step)`` runs the active units of ``step`` alone (graph kind
        ``cnres``) and holds their summed residuals; the next ``denoise``
        at that step hands them to the UNet as a per-call input (kind
        ``cnstep``). The units are gated, scaled and summed in the same
        order as in the single evaluation, so the bytes are its bytes. A
        step with no active unit runs the plain UNet evaluation. ``tower``:
        the mesh the units run on there (``SDTPU_STAGE_CN_DEVICES``,
        :meth:`_stage_cn_mesh`; None: the engine's); their residuals come
        back to the engine's device behind an event.

        On a mesh every evaluation runs per ``dp`` replica on its block of
        rows when the batch divides ``dp`` (:meth:`_split_run`), each
        replica's a graph of its own where its devices are one, and the
        outputs come back in global row order."""
        prec = precision if precision is not None \
            else self._default_precision
        run = {"ctx": torch.cat([ctx_u.expand(batch, -1, -1),
                                 ctx_c.expand(batch, -1, -1)])}
        if added is not None:
            run["added_cond"] = torch.cat([added[0].expand(batch, -1),
                                           added[1].expand(batch, -1)])
        if ragged is not None:
            true_rows, ctx_true_u, ctx_true_c = ragged
            run["true_rows"] = torch.cat([true_rows, true_rows])
            run["ctx_true"] = torch.cat([ctx_true_u, ctx_true_c])
        for k, (_, hint, *_) in enumerate(controls):
            run[f"hint_{k}"] = torch.cat([hint.expand(batch, -1, -1, -1)] * 2)
        if inpaint_cond is not None:
            run["inpaint"] = torch.cat([inpaint_cond, inpaint_cond])
        if lora is not None:
            run.update(graphs_mod.flatten(lora_mod.double_rows(lora), "lora"))
        modules = [module for module, *_ in controls]
        kind = "unet" if ragged is None else "ragged"
        mesh = self.mesh
        parts = self._split_run(run, batch, mesh)
        cn_mesh = mesh if tower is None else tower
        cn_parts = parts if tower is None else self._split_run(run, batch,
                                                                tower)
        for module in modules if tower is not None else ():
            # the tower's copies before any evaluation: making them drops
            # the graphs of the copies they replace
            self._replicas(module, tower)
        cfg = torch.tensor(cfg_scale, dtype=torch.float32)
        v_pred = self.schedule.prediction_type == "v_prediction"

        def unet_of(r):
            return self._replicas(self.unet, mesh)[r]

        def unit_residuals(active, on, r, run, call, scalars):
            # the summed f32 residuals of the units in ``active`` at
            # timestep scalars[0] over [uncond; cond] rows, unit
            # active[j]'s scaled by scalars[1 + j], on mesh ``on``'s
            # replica r
            tb = scalars[:1].expand(2 * call["x"].shape[0])
            both = torch.cat([call["x"], call["x"]])
            residuals = None
            for j, k in enumerate(active):
                unit = self._replicas(modules[k], on)[r]
                rs = unit(both, tb, run["ctx"], run[f"hint_{k}"],
                          run.get("added_cond"), precision=prec)
                rs = [r.float() * scalars[1 + j] for r in rs]
                residuals = rs if residuals is None else [
                    a + b for a, b in zip(residuals, rs)]
            return residuals

        def unet_eval(r, run, call, scalars, residuals):
            # the UNet at timestep scalars[0] over [uncond; cond] rows
            tb = scalars[:1].expand(2 * call["x"].shape[0])
            both = torch.cat([call["x"], call["x"]])
            unet_in = both if "inpaint" not in run else torch.cat(
                [both, run["inpaint"].to(both.dtype)], dim=-1)
            return unet_of(r)(unet_in, tb, run["ctx"],
                             added_cond=run.get("added_cond"),
                             true_rows=run.get("true_rows"),
                             ctx_true=run.get("ctx_true"),
                             control_residuals=residuals,
                             lora=graphs_mod.unflatten(run, "lora"),
                             precision=prec)

        def evaluate(active, r, run, call, scalars):
            return unet_eval(r, run, call, scalars, unit_residuals(
                active, mesh, r, run, call, scalars))

        def one(tag, kind, fn, run, call, scalars, binding, graph_ok):
            if self.cuda_graphs and graph_ok:
                return self._graphs.run(tag, kind, fn, run, call, scalars,
                                        binding)
            return fn(run, call,
                      graphs_mod.scalar_tensor(scalars, call["x"].device))

        def graphed(tag, kind, fn, parts, call, scalars, on):
            # fn(r, run, call, scalars) on each replica of mesh ``on`` that
            # ``parts`` (its rows' per-run inputs and bindings) names
            if on is None:
                (run_0, binding_0), = parts
                return one(tag, kind, functools.partial(fn, 0), run_0, call,
                           scalars, binding_0, True)
            n, out = len(parts), None
            for r, (run_r, binding_r) in enumerate(parts):
                layout = sharding.replica_layout(on, r)
                call_r = {k: sharding.batch_block(v, r, n, batch).to(
                    on.home(r), non_blocking=True) for k, v in call.items()}
                got = one(tag + (("mesh", tuple(on.shape.values()), r,
                                  layout),), kind, functools.partial(fn, r),
                          run_r, call_r, scalars, binding_r,
                          sharding.one_device(layout))
                if n == 1:
                    return got
                # copied out at once: the next replica's replay may reuse
                # the graphs' pool
                out = _write_blocks(out, got, r, n, batch, on.home())
            return out

        def x0(x, sigma, guided):
            if v_pred:
                c_skip = 1.0 / (sigma**2 + 1.0)
                c_out = sigma / torch.sqrt(sigma**2 + 1.0)
                return x * c_skip - guided * c_out
            return x - sigma * guided

        def prep(x, sigma):
            c_in = 1.0 / torch.sqrt(sigma**2 + 1.0)
            return x * c_in, float(self.schedule.sigma_to_t(sigma))

        def active_units(step):
            unit_gates = gates(step) if controls else ()
            active = tuple(k for k, g in enumerate(unit_gates) if g != 0.0)
            return active, [unit_gates[k] for k in active]

        def guided(x, sigma, out):
            out_u, out_c = out.float().chunk(2)
            return x0(x, sigma, out_u + cfg * (out_c - out_u))

        def denoise(x, sigma, step):
            xin, t = prep(x, sigma)
            active, unit_gates = active_units(step)
            tag = (kind, prec.flags, tuple((k, id(modules[k]))
                                           for k in active))
            out = graphed(tag, kind, functools.partial(evaluate, active),
                          parts, {"x": xin}, [t] + unit_gates, mesh)
            if cache is not None:
                cache.count("full_evals")
            return guided(x, sigma, out)

        if stage_ahead:
            held = {}

            def ahead(x, sigma, step):
                active, unit_gates = active_units(step)
                held.clear()
                if not active:
                    return
                xin, t = prep(x, sigma)
                tag = ("cnres", prec.flags, tuple((k, id(modules[k]))
                                                  for k in active))
                rs = graphed(tag, "cnres",
                             functools.partial(unit_residuals, active,
                                               cn_mesh),
                             cn_parts, {"x": xin}, [t] + unit_gates, cn_mesh)
                if tower is not None:
                    rs = self._from_tower(rs, tower)
                # the residuals may lie in the graphs' pool: the UNet's
                # graph copies them into its own inputs before any other
                # replay
                held[step] = rs

            def denoise_ahead(x, sigma, step):
                rs = held.pop(step, None)
                if rs is None:
                    return denoise(x, sigma, step)
                xin, t = prep(x, sigma)
                call = {"x": xin, **{f"res/{i}": r for i, r in enumerate(rs)}}
                out = graphed(("cnstep", prec.flags), "cnstep", lambda r, run,
                              call, scalars: unet_eval(
                                  r, run, call, scalars,
                                  [v for n, v in call.items()
                                   if n.startswith("res/")]),
                              parts, call, [t], mesh)
                return guided(x, sigma, out)

            return denoise_ahead, ahead

        if cache is None:
            return denoise

        # the cond rows alone, for the evaluations past the CFG cutoff
        run_c = {"ctx": ctx_c.expand(batch, -1, -1)}
        if added is not None:
            run_c["added_cond"] = added[1].expand(batch, -1)
        if inpaint_cond is not None:
            run_c["inpaint"] = inpaint_cond
        if lora is not None:
            run_c.update(graphs_mod.flatten(lora, "lora"))
        parts_c = self._split_run(run_c, batch, mesh)

        def evaluate_cached(mode, full, r, run, call, scalars):
            # the UNet in cache mode ``mode`` over [uncond; cond] rows
            # (``full``) or the cond rows, the reuse mode from call["cache"]
            x = call["x"]
            if full:
                x = torch.cat([x, x])
            tb = scalars[:1].expand(x.shape[0])
            if "inpaint" in run:
                x = torch.cat([x, run["inpaint"].to(x.dtype)], dim=-1)
            return unet_of(r)(x, tb, run["ctx"],
                             added_cond=run.get("added_cond"),
                             lora=graphs_mod.unflatten(run, "lora"),
                             precision=prec, cache=call.get("cache"),
                             cache_mode=mode)

        def cached_eval(mode, trunc, call, t):
            name = mode + ("-trunc" if trunc else "")
            return graphed((name, prec.flags), name,
                           functools.partial(evaluate_cached, mode,
                                             not trunc),
                           parts_c if trunc else parts, call, [t], mesh)

        def refresh(x, sigma, step):
            xin, t = prep(x, sigma)
            trunc = step >= cache.cfg_stop
            deep = cached_eval("deep", trunc, {"x": xin}, t)
            if trunc:
                cache.buf[:batch].copy_(deep)
                cache.buf[batch:].copy_(deep)
            else:
                cache.buf.copy_(deep)
            cache.valid = True
            cache.count("refreshes")
            cache.count("deep_trunc" if trunc else "deep_full")

        def reuse(x, sigma, step):
            xin, t = prep(x, sigma)
            trunc = step >= cache.cfg_stop
            call = {"x": xin,
                    "cache": cache.buf[batch:] if trunc else cache.buf}
            out = cached_eval("reuse", trunc, call, t).float()
            if trunc:
                cache.count("reuse_trunc_evals")
                return x0(x, sigma, out)
            cache.count("reuse_full_evals")
            out_u, out_c = out.chunk(2)
            return x0(x, sigma, out_u + cfg * (out_c - out_u))

        return denoise, refresh, reuse

    def _precision_for(self, payload: GenerationPayload
                       ) -> precision_mod.PrecisionSpec:
        """The request's serving precision, resolved once per range; the
        policy's default rung keeps the policy's own flags."""
        prec = precision_mod.resolve(payload, self.policy)
        if prec.name == self._default_precision.name:
            return self._default_precision
        return prec

    def _denoise(self, payload: GenerationPayload, x: torch.Tensor,
                 image_keys: torch.Tensor, conds, pooleds, job: str,
                 ragged=None, start_step: int = 0,
                 end_step: Optional[int] = None,
                 controls: Sequence[Control] = (), mask=None,
                 inpaint_cond: Optional[torch.Tensor] = None,
                 lora: Optional[Dict] = None,
                 sync: bool = True) -> torch.Tensor:
        """Chunked sampler loop over steps ``[start_step, end_step or
        steps)`` of the request's sigma ladder: ``chunk_size`` steps at a
        time, the interrupt flag and progress checked between chunks.
        Nothing in the loop reads a device value back: the host paces on
        a CUDA event recorded after each chunk, letting one chunk run
        ahead of it and waiting for the last before it returns, as the
        JAX package's fences do. With a preempt hook installed it waits
        for each chunk, so that the hook is polled when the card, not the
        host, reaches the chunk boundary.

        ``sync=False`` (the stage-graph executor, ``parallel/
        stage_graph.py``): two chunks may run ahead, and the range returns
        with its tail still running, so the caller's decode dispatch and
        the next group's stages queue behind it; an interrupt still lands
        within two chunks. Such a range takes no preempt hook (the
        executor yields at group boundaries) and no prefix plan (a capture
        reads the carry back), as in the JAX package.
        ``conds`` is ``(ctx_u, ctx_c)``, ``pooleds`` ``(pooled_u,
        pooled_c)`` (SDXL's added conditioning is made from them at the
        payload's size); ``ragged``, ``controls`` and ``inpaint_cond`` as
        for :meth:`_make_denoise_fn`, the ControlNet windows over the
        request's ``steps``. ``mask``: ``(mask_lat (1,h,w,1), init_lat)``,
        whose unmasked region is pinned after every step to ``init_lat``
        noised to the next sigma. ``lora``: a per-row traced UNet tree
        (the dispatcher's :func:`~..models.lora.stack_row_sets`); None
        takes the engine's active traced set, if any, for every row. DPM
        adaptive runs :meth:`_denoise_adaptive` instead (never with a
        traced set: such requests take the merged path).

        The request's serving precision applies to every evaluation. Its
        step cache (``pipeline/stepcache.py``; not under ragged dispatch,
        not on a family without a level below the split) runs as the JAX
        package's step-cache chunks, as host decisions around the
        evaluations: the range starts with an invalid cache; before a
        step that finds it invalid or whose index the cadence divides,
        the deep part is refreshed from the step's entry latent, and every
        evaluation of the step (Heun's midpoint too) reuses it. A chunk
        in which a ControlNet unit is active runs the plain evaluation and
        invalidates the cache. The cadence and the cutoff are host data:
        a new value captures no graph.

        Prefix sharing (``SDTPU_CACHE``, ``cache/prefix.py``), under the
        JAX package's conditions: a txt2img range from step 0 with no
        mask, inpainting channels, ControlNet unit or ragged rows, of a
        request whose images form one group. It resumes from a stored
        carry of its prefix key (the loop entering at that step with the
        step cache invalid, so it refreshes there as the continuous run
        does), else captures its carry at the first chunk boundary that
        ``stepcache.prefix_boundary`` allows.

        The range is one ``denoise_range`` span (``obs/spans.py``) with a
        ``denoise_chunk`` leaf per chunk (``runtime/trace.py``); the CUDA
        events around its loop give the span's ``device_ms``. The
        evaluations it dispatched are priced into ``METRICS``'s UNet
        FLOPs (:meth:`_record_unet_flops`)."""
        with obs_spans.span("denoise_range", device=True,
                            sampler=payload.sampler_name,
                            steps=int(payload.steps),
                            start_step=int(start_step),
                            batch=int(x.shape[0]),
                            size=f"{payload.width}x{payload.height}"):
            return self._denoise_range(
                payload, x, image_keys, conds, pooleds, job, ragged,
                start_step, end_step, controls, mask, inpaint_cond, lora,
                sync)

    def _denoise_range(self, payload: GenerationPayload, x: torch.Tensor,
                       image_keys: torch.Tensor, conds, pooleds, job: str,
                       ragged, start_step: int, end_step: Optional[int],
                       controls: Sequence[Control], mask,
                       inpaint_cond: Optional[torch.Tensor],
                       lora: Optional[Dict], sync: bool) -> torch.Tensor:
        """The body of :meth:`_denoise`."""
        spec = kd.resolve_sampler(payload.sampler_name)
        added = self._added_cond(pooleds, payload.width, payload.height)
        prec = self._precision_for(payload)
        self.last_step_evals = None
        if lora is None and self._traced_lora is not None:
            lora = lora_mod.broadcast_set(self._traced_lora,
                                          x.shape[0])["unet"]
        if spec.adaptive:
            return self._denoise_adaptive(payload, x, image_keys, conds,
                                          added, job, start_step, end_step,
                                          controls, mask, inpaint_cond, prec)
        steps = payload.steps
        end = steps if end_step is None else min(end_step, steps)
        sigmas = kd.build_sigmas(spec, self.schedule, steps)
        sc = stepcache.resolve(payload)
        cfg_stop = stepcache.cutoff_step(sigmas.numpy(), sc.cutoff_sigma)
        cache = None
        if sc.active and ragged is None and \
                cache_supported(self.family.unet):
            # [uncond; cond] deep rows in the compute dtype
            cache = _StepCache(
                torch.zeros(deep_cache_shape(self.family.unet,
                                             2 * x.shape[0], x.shape[1],
                                             x.shape[2]),
                            dtype=self.policy.compute_dtype,
                            device=x.device),
                sc.cadence, cfg_stop)
        fns = self._make_denoise_fn(
            *conds, payload.cfg_scale, x.shape[0], ragged, added, controls,
            lambda i: window_gates(controls, i, steps), inpaint_cond, lora,
            prec, cache)
        denoise = fns if cache is None else fns[0]
        step = kd.make_sampler_step(spec, denoise, sigmas, image_keys)
        cached_step = None
        if cache is not None:
            _, refresh, reuse = fns
            reuse_step = kd.make_sampler_step(spec, reuse, sigmas,
                                              image_keys)

            def cached_step(carry, i):
                if not cache.valid or i % cache.cadence == 0:
                    refresh(carry.x, sigmas[i], i)
                return reuse_step(carry, i)

        if ragged is not None:
            step = _zero_tail_rows(step, ragged[0], x.shape[1])
        if mask is not None:
            # the same pinning noise on either path: the cadence must not
            # move an inpaint request's draws
            step = _pin_unmasked(step, sigmas, image_keys, *mask)
            if cached_step is not None:
                cached_step = _pin_unmasked(cached_step, sigmas, image_keys,
                                            *mask)
        carry = kd.init_carry(x)
        prefix = None
        if (sync and job == "txt2img" and start_step == 0 and mask is None
                and inpaint_cond is None and not controls and end > 0
                and ragged is None and cache_keys.enabled()):
            ts = self._traced_lora
            prefix = cache_prefix.plan(
                self, payload, batch=x.shape[0], width=payload.width,
                height=payload.height, steps=steps, end=end,
                cadence=sc.cadence if cache is not None else 1,
                sc_active=cache is not None, precision=prec.name,
                cfg_stop=cfg_stop, lora=ts.content if ts is not None else "")
        self.state.begin(job, end - start_step)
        pos = start_step
        if prefix is not None and prefix.resume is not None:
            # the stored carry, copied back to the device: the loop enters
            # at step k with the step cache invalid
            pos, leaves = prefix.resume
            carry = kd.Carry(*(
                torch.tensor(a, device=x.device) if a.ndim else a.item()
                for a in leaves))
            self.state.step(pos)
        fences = _Fences(x.device)
        dispatched: List[Tuple[int, int, bool]] = []
        # the CUDA events around the loop: the span's device time
        with obs_spans.device_interval(x.device) as interval:
            while pos < end and not self.state.flag.interrupted:
                hook = self.preempt_hook if sync else None
                if hook is not None and hook.should_yield():
                    # chunk-boundary yield: the gate runs the interloper
                    # nested on this thread and returns when it hands the
                    # device back. The carry, position, step cache and
                    # prefix plan stay in this frame; the graphs' per-run
                    # inputs are copied back at the next call (a new
                    # binding). The interloper's device time is its own.
                    fences.wait(0)
                    interrupted_before_yield = self.state.flag.interrupted
                    interval.pause()
                    hook.yield_device()
                    interval.resume()
                    # an interloper with <lora:...> tags merged into the
                    # live weights: this payload's adapters again
                    # (tagless: the pristine weights)
                    self._apply_prompt_loras(payload)
                    # the interloper drove the shared progress record and
                    # the interrupt latch (its begin_request cleared it;
                    # an interrupt aimed at it may still be latched): this
                    # range's view of both
                    self.state.begin(job, end - start_step)
                    if pos - start_step:
                        self.state.step(pos - start_step)
                    self.state.restore_interrupt(interrupted_before_yield)
                    continue  # the restored latch is read at the loop top
                chunk_end = min(pos + self.chunk_size, end)
                run_step = step
                if cache is not None:
                    # a unit active anywhere in the chunk feeds the deep
                    # blocks: the plain evaluation runs, and the cache is
                    # stale
                    lo = (pos + 0.5) / steps
                    hi = (chunk_end - 0.5) / steps
                    if any(c[3] <= hi and c[4] >= lo for c in controls):
                        cache.valid = False
                    else:
                        run_step = cached_step
                with trace.STATS.timer("denoise_chunk"), \
                        trace.annotate(f"denoise[{pos}:{chunk_end}]"):
                    for i in range(pos, chunk_end):
                        carry = run_step(carry, i)
                    fences.record()
                    # a preemptible job polls its hook when the card
                    # reaches the boundary, not when the host does
                    fences.wait(2 if not sync else
                                0 if self.preempt_hook is not None else 1)
                dispatched.append((pos, chunk_end - pos,
                                   run_step is cached_step))
                pos = chunk_end
                self.state.step(pos - start_step)
                if prefix is not None:
                    cache_prefix.maybe_capture(prefix, pos, carry)
            if sync:
                fences.wait(0)
        self.state.finish()
        if cache is not None:
            self.last_step_evals = cache.counts
        self._record_unet_flops(
            dispatched, sc.cadence if cache is not None else 1, cfg_stop,
            spec.evals_per_step, steps, x.shape[0], x.shape[1], x.shape[2],
            conds[1].shape[1], precision=prec.name)
        return carry.x

    def _record_unet_flops(self, dispatched, cadence: int, cfg_stop: int,
                           evals_per_step: int, steps: int, batch: int,
                           lat_h: int, lat_w: int, ctx_len: int,
                           precision: str = "") -> None:
        """Price a range's dispatched chunks (``stepcache.plan_schedule``
        over ``FlopsAccountant``, whose prices are cached per shape) into
        ``METRICS``'s UNet FLOPs, the numerator of ``unet_flops_per_image``
        and of the perf ledger's MFU; pricing never breaks generation."""
        if not dispatched:
            return
        try:
            counts = stepcache.plan_schedule(
                dispatched, cadence, cfg_stop, evals_per_step, steps)
            total = self._flops.request_flops(
                counts, batch, lat_h, lat_w, ctx_len, precision=precision)
            if total is not None:
                METRICS.record_unet_flops(total)
        except Exception:  # noqa: BLE001 — pricing never breaks generation
            pass

    def _denoise_adaptive(self, payload: GenerationPayload, x: torch.Tensor,
                          image_keys: torch.Tensor, conds, added, job: str,
                          start_step: int, end_step: Optional[int],
                          controls: Sequence[Control] = (), mask=None,
                          inpaint_cond: Optional[torch.Tensor] = None,
                          precision: Optional[
                              precision_mod.PrecisionSpec] = None
                          ) -> torch.Tensor:
        """DPM adaptive: the host PID loop over one attempt of 3 UNet
        evaluations (k-diffusion ``sample_dpm_adaptive``): the step count
        only sizes the sigma ladder's ends, the controller picks the
        steps. The interrupt is polled between attempts; progress counts
        accepted steps against the step count, as webui's bar does.

        ControlNet units are gated per attempt on the host, as the JAX
        package gates them (:func:`adaptive_gates`). With a ``mask`` the
        unmasked region is pinned after each accepted step, its noise
        keyed ``fold_in(fold_in(k, 2_000_000), n)``, and once more at
        sigma 0 when the run completes the ladder. Every attempt runs at
        the request's ``precision``; the step cache does not apply (as in
        the JAX package, whose attempt executable takes none)."""
        spec = kd.resolve_sampler(payload.sampler_name)
        steps = payload.steps
        sigmas = kd.build_sigmas(spec, self.schedule, steps)
        end = steps if end_step is None else min(end_step, steps)
        self.last_adaptive_attempts = 0
        if start_step >= end:
            return x
        sigma_max = float(sigmas[start_step])
        sig_end = float(sigmas[end])
        # steps=1 gives [sigma_max, 0]: integrate the schedule's whole range
        sigma_min = sig_end if sig_end > 0 else max(
            float(self.schedule.sigma_min),
            float(sigmas[end - 1]) if end - 1 > start_step else 0.0)
        if sigma_max <= sigma_min:
            return x
        gates_now: List[float] = []
        denoise = self._make_denoise_fn(
            *conds, payload.cfg_scale, x.shape[0], added=added,
            controls=controls, gates=lambda step: gates_now,
            inpaint_cond=inpaint_cond, precision=precision)
        attempt = kd.make_adaptive_attempt(denoise)

        def attempt_fn(xx, x_prev, s, h, rtol, atol):
            gates_now[:] = adaptive_gates(controls, sigmas, float(s))
            with trace.STATS.timer("denoise_chunk"), \
                    trace.annotate("dpm-adaptive-attempt"):
                return attempt(xx, x_prev, s, h, rtol, atol)

        total = end - start_step
        self.state.begin(job, total)

        def on_accept(xx, sigma, n):
            self.state.step(min(n, total))
            if mask is not None:
                xx = _adaptive_pin(xx, image_keys, *mask, sigma, n)
            return xx

        with obs_spans.device_interval(x.device):
            x_out, info = kd.sample_dpm_adaptive(
                attempt_fn, x, sigma_max, sigma_min,
                should_stop=lambda: self.state.flag.interrupted,
                on_accept=on_accept)
        if mask is not None and info["completed"] and end == steps:
            # the last pin at sigma 0: the protected region comes back as
            # the clean init latent, as the fixed-grid loop's last step
            x_out = _adaptive_pin(x_out, image_keys, *mask, 0.0, 0)
        self.last_adaptive_attempts = info["steps"]
        log.debug("dpm adaptive: %d accepted / %d rejected steps, %d UNet "
                  "evaluations", info["n_accept"], info["n_reject"],
                  info["nfe"])
        if not info["completed"] and not self.state.flag.interrupted:
            # the attempt backstop: the latent is partly denoised, and the
            # image's infotext says so
            log.warning("dpm adaptive stopped incomplete after %d attempts "
                        "(%d accepted)", info["steps"], info["n_accept"])
            self._adaptive_incomplete = True
        self.state.finish()
        return x_out

    def _refiner_engine(self, payload: GenerationPayload
                        ) -> Optional["Engine"]:
        if not payload.refiner_checkpoint or payload.refiner_switch_at >= 1.0:
            return None
        if self.engine_provider is None:
            return None
        return self.engine_provider(payload.refiner_checkpoint)

    def _split_denoise(self, payload: GenerationPayload, x: torch.Tensor,
                       keys: torch.Tensor, conds, pooleds, job: str,
                       refiner: Optional["Engine"], ref_cond,
                       ragged=None, start_step: int = 0,
                       controls: Sequence[Control] = (),
                       inpaint_cond: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
        """Denoise steps ``[start_step, steps)``, handing over to
        ``refiner`` (with its own conditioning ``ref_cond``, and no
        ControlNet or inpainting channels) at step ``int(steps *
        refiner_switch_at)``, clamped to ``[start_step, steps - 1]``. The
        sampler's history starts afresh at the switch; an interrupt during
        the base phase skips the refiner."""
        if refiner is None:
            return self._denoise(payload, x, keys, conds, pooleds, job,
                                 ragged, start_step=start_step,
                                 controls=controls,
                                 inpaint_cond=inpaint_cond)
        steps = payload.steps
        switch = max(start_step, min(steps - 1,
                                     int(steps * payload.refiner_switch_at)))
        if switch > start_step:
            x = self._denoise(payload, x, keys, conds, pooleds, job,
                              start_step=start_step, end_step=switch,
                              controls=controls, inpaint_cond=inpaint_cond)
        if self.state.flag.interrupted:
            return x
        ref_conds, ref_pooleds = ref_cond
        return refiner._denoise(payload, x, keys, ref_conds, ref_pooleds,
                                job + "+refiner", start_step=switch)

    # -- decode --------------------------------------------------------------

    #: images decoded per call = max(1, budget // (width*height)), bounding
    #: the f32 decoder's scratch (the JAX package's _DECODE_PIXEL_BUDGET)
    _DECODE_PIXEL_BUDGET = 1024 * 1024

    def _decode(self, latents: torch.Tensor,
                vae: Optional[torch.nn.Module] = None) -> torch.Tensor:
        """Latents (B,h,w,C) -> f32 pixels (B,H,W,3) in [0, 1] on the
        device (``vae``: a replica's decoder, else the engine's)."""
        vae = self.vae if vae is None else vae
        imgs = vae(latents / self.family.vae.scaling_factor)
        return torch.clamp(imgs * 0.5 + 0.5, 0.0, 1.0)

    def _decode_u8(self, latents: torch.Tensor, width: int,
                   height: int) -> torch.Tensor:
        """Latents (B,h,w,C) -> uint8 pixels (B,H,W,3) in host memory
        (pinned on the card), dispatched without waiting: each
        micro-batch's pixels are copied in stream order, so the buffer
        holds them once the work queued so far has run (an event recorded
        after this call says when, :meth:`_queue_decoded`)."""
        per = max(1, self._DECODE_PIXEL_BUDGET // max(1, width * height))
        f = self.family.vae_scale_factor
        b, lat_h, lat_w = latents.shape[:3]
        host = torch.empty((b, lat_h * f, lat_w * f, 3), dtype=torch.uint8,
                           pin_memory=self.device.type == "cuda")
        # each dp replica decodes its block of rows on its own VAE
        n = self._dp_split(self.mesh, b)
        blk = b // n
        vaes = self._replicas(self.vae, self.mesh) if n > 1 \
            else [self.vae]
        with trace.STATS.timer("vae_decode_dispatch"), \
                obs_spans.device_interval(latents.device):
            for r in range(n):
                rows = latents[r * blk:(r + 1) * blk]
                if n > 1:
                    rows = rows.to(self.mesh.home(r), non_blocking=True)
                for s in range(0, blk, per):
                    px = self._decode(rows[s:s + per], vaes[r]) * 255.0 + 0.5
                    at = r * blk + s
                    host[at:at + per].copy_(px.to(torch.uint8),
                                            non_blocking=True)
        return host

    def _queue_decoded(self, latents: torch.Tensor, pos: int, n: int,
                       width: int, height: int) -> "_Decoded":
        """Dispatch the decode of a group's latents (:meth:`_decode_u8`)
        and record the event :meth:`_flush_decoded` waits on. ``n`` is how
        many of the images to keep: the pad-and-drop rows are decoded with
        the others, so every decoder call has the group's batch size. The
        adaptive backstop's mark is taken here, where the denoise that
        produced these images is known."""
        incomplete, self._adaptive_incomplete = \
            self._adaptive_incomplete, False
        # every kept row is one output image: the FLOPs-per-image
        # denominator, counted where every decode path passes
        METRICS.record_unet_images(min(n, latents.shape[0]))
        host = self._decode_u8(latents, width, height)
        events = []
        if self.device.type == "cuda":
            # an event on each device whose replica copied pixels
            devices = {self.device} if self.mesh is None else {
                self.mesh.home(r) for r in range(self._dp_split(
                    self.mesh, latents.shape[0]))} | {self.device}
            for d in devices:
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(d))
                events.append(event)
        return _Decoded(host, events, pos, n, width, height, incomplete)

    def _flush_decoded(self, out: GenerationResult,
                       payload: GenerationPayload,
                       pending: Sequence["_Decoded"]) -> None:
        """Wait for each queued decode's pixels, then encode its kept
        images as PNGs into ``out``, in order. Needs nothing of the device
        thread: the serving dispatcher runs it on its leader's thread."""
        for d in pending:
            with trace.STATS.timer("vae_decode_fetch"):
                imgs = d.pixels()
            self._append_images(out, payload, imgs, d.pos, d.width,
                                d.height, d.incomplete)

    # -- hires fix -----------------------------------------------------------

    def _hires_target(self, payload: GenerationPayload) -> Tuple[int, int]:
        """The second pass's ``(width, height)``: ``hr_resize_x/y`` when
        both are set, else ``hr_scale`` times the request's size, floored
        to the VAE factor."""
        if payload.hr_resize_x and payload.hr_resize_y:
            tw, th = payload.hr_resize_x, payload.hr_resize_y
        else:
            tw = int(payload.width * payload.hr_scale)
            th = int(payload.height * payload.hr_scale)
        f = self.family.vae_scale_factor
        return (tw // f) * f, (th // f) * f

    def _upscale_latents(self, payload: GenerationPayload,
                         latents: torch.Tensor, tw: int,
                         th: int) -> torch.Tensor:
        """The first pass's latents at the target size. An upscaler name
        without "latent" that ``upscaler_provider`` resolves goes through
        pixels: decoded in f32, upscaled, encoded again, in micro-batches
        of ``min(budget // (w*h), budget // (tw*th))`` rows under
        ``SDTPU_DECODE_PIXELS``. Else the latents are resized on the
        device by :func:`~.image.latent_resize_method`'s kernel."""
        name = payload.hr_upscaler or "Latent"
        upscale = None
        if "latent" not in name.lower() and self.upscaler_provider:
            upscale = self.upscaler_provider(name)
        if upscale is None:
            f = self.family.vae_scale_factor
            return resize_device(latents, th // f, tw // f,
                                 latent_resize_method(payload.hr_upscaler))
        budget = env_int("SDTPU_DECODE_PIXELS", self._DECODE_PIXEL_BUDGET)
        per = min(max(1, budget // max(1, payload.width * payload.height)),
                  max(1, budget // max(1, tw * th)))
        with trace.STATS.timer("hires_upscale"):
            return torch.cat([
                self._encode_images(upscale(self._decode(latents[s:s + per]),
                                            tw, th))
                for s in range(0, latents.shape[0], per)])

    def _hires_pass(self, payload: GenerationPayload, latents: torch.Tensor,
                    keys: torch.Tensor, conds, pooleds, job: str,
                    refiner: Optional["Engine"], ref_cond
                    ) -> Tuple[torch.Tensor, int, int]:
        """The hires fix's second pass over a group's latents (JAX
        ``Engine._hires_pass``): upscaled (:meth:`_upscale_latents`),
        noised with fresh per-image noise keyed ``fold_in(k, 2_000_000)``
        (apart from the init and ancestral streams) to the sigma of step
        ``start2 = steps2 - int(min(strength, 0.999) * steps2)``, and
        denoised from there at the target size, the ControlNet hints and an
        inpainting family's blank conditioning made at that size, the
        refiner switching at ``int(steps2 * refiner_switch_at)``. Returns
        ``(latents, target width, target height)``."""
        tw, th = self._hires_target(payload)
        steps2 = payload.hr_second_pass_steps or payload.steps
        spec = kd.resolve_sampler(payload.sampler_name)
        sigmas2 = kd.build_sigmas(spec, self.schedule, steps2)
        t_enc = int(min(payload.denoising_strength, 0.999) * steps2)
        start2 = steps2 - t_enc
        up = self._upscale_latents(payload, latents, tw, th)
        noise = rng.normal(rng.fold_in(keys, 2_000_000), up.shape[1:])
        x = up + noise * sigmas2[start2]
        # the second pass's own steps and size: the sampler ladder, the
        # ControlNet windows and SDXL's added conditioning read them
        hires = payload.model_copy(update={"steps": steps2, "width": tw,
                                           "height": th})
        controls = self._prepare_controls(payload, tw, th)
        inp = (self._blank_inpaint_cond(x.shape[0], tw, th)
               if self.family.inpaint else None)
        latents = self._split_denoise(hires, x, keys, conds, pooleds,
                                      job + "+hr", refiner, ref_cond,
                                      start_step=start2, controls=controls,
                                      inpaint_cond=inp)
        return latents, tw, th

    # -- VAE override --------------------------------------------------------

    def _vae_policy(self, decoder: torch.nn.Module, encoder: torch.nn.Module
                    ) -> Tuple[torch.nn.Module, torch.nn.Module]:
        """Loaded VAE modules under the policy: the decoder computes in f32,
        the encoder in the compute dtype with f32 norms."""
        return (decoder.float(),
                norms_to_f32(encoder.to(self.policy.compute_dtype)))

    def set_vae(self, params: Optional[StateDicts]) -> None:
        """Apply a standalone VAE (webui's ``sd_vae``; ``params`` holds
        ``vae`` and ``vae_encoder`` state dicts, ``models/convert.py``
        ``convert_vae``), or restore the checkpoint's own with None: its
        modules are kept aside while an override is applied, so restoring
        gives its bytes back exactly. The swap runs on the device thread,
        so a request in flight finishes with the VAE it started with.
        Clears the inpainting conditioning cache, which the VAE makes, and
        bumps ``_model_epoch``."""
        if params is None:
            new = self._checkpoint_vae
            if new is None:
                return
        else:
            with torch.device("meta"):
                dec, enc = Decoder(self.family.vae), Encoder(self.family.vae)
            pd = self.policy.param_dtype
            new = self._vae_policy(_load(dec, params["vae"], self.device, pd),
                                   _load(enc, params["vae_encoder"],
                                         self.device, pd))

        def swap():
            # the outgoing modules keep no placement: one kept aside comes
            # back to whatever mesh the engine has then
            for module in (self.vae, self.vae_encoder):
                unet_mod.place_layers(module, None)
            if self._checkpoint_vae is None:
                self._checkpoint_vae = (self.vae, self.vae_encoder)
            self.vae, self.vae_encoder = new
            if params is None:
                self._checkpoint_vae = None
            if self.mesh is not None:
                self.set_mesh(self.mesh)
            self._blank_cond_cache.clear()
            # the decoded bytes change: retire the cached results
            self._model_epoch += 1

        self.device_runner.run(swap)

    # -- ControlNet ----------------------------------------------------------

    def _controlnet(self, name: str) -> Optional[torch.nn.Module]:
        """The ControlNet named ``name``, loaded to the device on first use
        from ``controlnet_provider`` (stored in the policy's param dtype,
        computing in its compute dtype with f32 norms); None when the
        provider has no such model."""
        module = self._controlnets.get(name)
        if module is not None:
            return module
        sd = (self.controlnet_provider(name) if self.controlnet_provider
              else None)
        if sd is None:
            return None
        with torch.device("meta"):
            module = ControlNet(self.family.unet)
        module = _load(module, sd, self.device, self.policy.param_dtype)
        module = norms_to_f32(module.to(self.policy.compute_dtype))
        self._controlnets[name] = module
        self._replicas(module, self.mesh)
        return module

    def _prepare_controls(self, payload: GenerationPayload, width: int,
                          height: int) -> Tuple[Control, ...]:
        """The request's units for the denoiser: each unit's image through
        its preprocessor and resized to 8x the latent size, on the device.
        A unit whose model the provider lacks is skipped with a
        warning."""
        controls = []
        lat_h, lat_w = self._latent_hw(width, height)
        for u in parse_controlnet_units(payload):
            name = u.get("model", "")
            module = self._controlnet(name)
            if module is None:
                log.warning("controlnet model '%s' not found; unit skipped",
                            name)
                continue
            mask = b64png_to_array(u["mask"]) if u.get("mask") else None
            processed = run_preprocessor(u.get("module", "none"),
                                         b64png_to_array(u["image"]),
                                         mask=mask)
            processed = resize_image(np.asarray(processed, np.float32),
                                     lat_w * 8, lat_h * 8)
            hint = torch.from_numpy(np.ascontiguousarray(processed))
            controls.append((module, hint[None].to(self.device),
                             float(u.get("weight", 1.0)),
                             float(u.get("guidance_start", 0.0)),
                             float(u.get("guidance_end", 1.0))))
        return tuple(controls)

    # -- image conditioning --------------------------------------------------

    def _encode_images(self, images: torch.Tensor) -> torch.Tensor:
        """Images (B,H,W,3) f32 in [0, 1] -> the latent mean (B,h,w,C) f32,
        scaled by the VAE's scaling factor."""
        mean, _ = encode(self.vae_encoder, images * 2.0 - 1.0)
        return mean.float() * self.family.vae.scaling_factor

    def _blank_inpaint_cond(self, batch: int, width: int,
                            height: int) -> torch.Tensor:
        """An inpainting family's conditioning without a mask: a
        repaint-everything mask and the encoded mid-gray image, (batch, h,
        w, 1 + C), cached per ``(batch, width, height)``."""
        key = (batch, width, height)
        cached = self._blank_cond_cache.get(key)
        if cached is not None:
            return cached
        h, w = self._latent_hw(width, height)
        gray = torch.full((1, height, width, 3), 0.5, device=self.device)
        lat = self._encode_images(gray)
        mask = torch.ones((1, h, w, 1), device=self.device)
        cond = torch.cat([mask, lat], dim=-1).repeat(batch, 1, 1, 1)
        self._blank_cond_cache[key] = cond
        return cond

    def _masked_inpaint_cond(self, batch: int, width: int, height: int,
                             init: np.ndarray, mask_pixels: np.ndarray
                             ) -> torch.Tensor:
        """An inpainting family's conditioning for a mask: the rounded
        mask at latent size and the encoded init image with the masked
        region mid-gray."""
        h, w = self._latent_hw(width, height)
        m = np.round(np.clip(mask_pixels, 0.0, 1.0))
        masked = init * (1.0 - m) + 0.5 * m
        lat = self._encode_images(
            torch.from_numpy(np.ascontiguousarray(masked))[None]
            .to(self.device)).repeat(batch, 1, 1, 1)
        mask_lat = np.round(resize_bilinear(m, (h, w, 1)))
        mask_lat = torch.from_numpy(mask_lat)[None].to(self.device)
        return torch.cat([mask_lat.repeat(batch, 1, 1, 1), lat], dim=-1)

    def _inpaint_mask(self, payload: GenerationPayload, width: int,
                      height: int) -> Tuple[torch.Tensor, np.ndarray]:
        """``(mask_lat (1,h,w,1) on the device, mask_pixels (H,W,1))``:
        the payload's mask at the request's size, blurred by ``mask_blur``
        for the latent mask (``clip(m * 1.02, 0, 1)`` keeps its core at 1)
        and kept sharp for an inpainting family's conditioning."""
        h, w = self._latent_hw(width, height)
        m = b64png_to_array(payload.mask).astype(np.float32) / 255.0
        m = resize_image(m, width, height)[..., :1]
        mask_pixels = m
        if payload.mask_blur > 0:
            m = box_blur(m, payload.mask_blur)
        mask_lat = torch.from_numpy(resize_bilinear(m, (h, w, 1)))
        mask_lat = torch.clamp(mask_lat[None].to(self.device) * 1.02,
                               0.0, 1.0)
        return mask_lat, mask_pixels

    def _apply_inpaint_fill(self, payload: GenerationPayload,
                            init_lat: torch.Tensor,
                            mask_lat: Optional[torch.Tensor],
                            keys: torch.Tensor) -> torch.Tensor:
        """webui's ``inpainting_fill`` for the masked region: 1 keeps the
        original (the default), 0 fills it with the unmasked region's mean,
        2 with unit-variance latent noise keyed ``fold_in(k, 3_000_000)``,
        3 with zeros."""
        fill = payload.inpainting_fill
        if mask_lat is None or fill == 1:
            return init_lat
        m = mask_lat
        if fill == 3:
            return init_lat * (1.0 - m)
        if fill == 2:
            extra = rng.normal(rng.fold_in(keys, 3_000_000),
                               init_lat.shape[1:])
            return init_lat * (1.0 - m) + m * extra
        if fill == 0:
            keep = torch.clamp((1.0 - m).sum(dim=(1, 2), keepdim=True),
                               min=1e-6)
            mean = (init_lat * (1.0 - m)).sum(dim=(1, 2),
                                              keepdim=True) / keep
            return init_lat * (1.0 - m) + m * mean
        return init_lat

    # -- requests ------------------------------------------------------------

    def _image_keys(self, payload: GenerationPayload, start: int,
                    batch: int) -> torch.Tensor:
        # ENSD offsets the sampler noise seed only (webui semantics)
        ensd = int((payload.override_settings or {})
                   .get("eta_noise_seed_delta", 0) or 0)
        seed = (payload.seed + ensd) % (2 ** 32)
        pin = payload.subseed_strength > 0 or payload.same_seed
        return rng.batch_keys(seed, start, batch, pin_index=pin,
                              device=self.device)

    def _seed_resize_latent(self, payload: GenerationPayload):
        if payload.seed_resize_from_w > 0 and payload.seed_resize_from_h > 0:
            f = self.family.vae_scale_factor
            return (payload.seed_resize_from_h // f,
                    payload.seed_resize_from_w // f)
        return None

    def _init_noise(self, payload: GenerationPayload, start: int,
                    batch: int, shape: Tuple[int, int, int],
                    rows: int) -> torch.Tensor:
        """Init noise ``(batch, h, w, C)`` of images ``[start,
        start+batch)``. Under ragged dispatch (``rows < h``) it is drawn
        at the true rows and zero-padded, so the masked tail starts at
        exactly 0 and a row's noise does not depend on the bucket its
        request landed in."""
        h, w, C = shape
        noise = rng.batch_noise(
            payload.seed, payload.subseed, payload.subseed_strength, start,
            batch, (rows, w, C), seed_resize=self._seed_resize_latent(payload),
            pin_index=payload.same_seed, device=self.device)
        return noise if rows == h else F.pad(noise, (0, 0, 0, 0, 0, h - rows))

    def _run_txt2img(self, payload: GenerationPayload, start: int,
                     count: int, job: str) -> GenerationResult:
        width, height = payload.width, payload.height
        h, w = self._latent_hw(width, height)
        C = self.family.vae.latent_channels
        spec = kd.resolve_sampler(payload.sampler_name)
        sigma0 = kd.build_sigmas(spec, self.schedule, payload.steps)[0]
        # groups of batch_size keep the batch dim stable across n_iter
        group = max(1, payload.group_size or payload.batch_size)
        controls = self._prepare_controls(payload, width, height)
        refiner = self._refiner_engine(payload)
        if (stage_graph.enabled() and refiner is None
                and not payload.enable_hr and not spec.adaptive):
            # the stage-graph executor (the JAX package's gate): the same
            # bytes, with the host's work of one group overlapping the
            # device's of the next. The hires fix, a refiner and DPM
            # adaptive keep the serial loop.
            return self._run_txt2img_staged(payload, start, count, job,
                                            controls)
        # ragged solo run: the bucket's shape, the true rows as data (the
        # dispatcher never marks per-image prompts, the hires fix, a
        # refiner handoff, ControlNet or an inpainting family ragged; a
        # hand-made marker on such work runs the classic path, as in the
        # JAX package)
        per_image = bool(payload.all_prompts)
        ragged_wh = None if (per_image or payload.enable_hr
                             or refiner is not None or controls
                             or self.family.inpaint) else \
            self._ragged_plan(payload)
        ragged = None
        conds = pooleds = ref_cond = None
        if ragged_wh is None:
            if not per_image:
                conds, pooleds = self.encode_prompts(payload)
            rows = h
        else:
            conds, pooleds, ctx_true = self.encode_prompts(payload,
                                                           ragged=True)
            rows = self._true_latent_rows(h, ragged_wh[1])
            ragged = tuple(torch.full((group,), length, dtype=torch.int32,
                                      device=self.device)
                           for length in (rows, *ctx_true))
        if refiner is not None and not per_image:
            ref_cond = refiner.encode_prompts(payload)
        inp = (self._blank_inpaint_cond(group, width, height)
               if self.family.inpaint else None)
        out = GenerationResult(parameters=payload.model_dump())
        pending: List[_Decoded] = []
        pos, remaining = start, count
        while remaining > 0 and not self.state.flag.interrupted:
            n = min(group, remaining)
            # pad-and-drop: a short group runs at the full group size and
            # its extra rows are dropped after decoding, so every UNet and
            # decoder call has the batch size of the whole-batch run. A
            # row's numbers depend on the batch size (GEMM and convolution
            # algorithms do), not on its position, so a sub-range then
            # reproduces the whole-batch rows exactly.
            noise = self._init_noise(payload, pos, group, (h, w, C), rows)
            keys = self._image_keys(payload, pos, group)
            if per_image:
                conds, pooleds, ref_cond = self._group_conds(
                    payload, pos, group, refiner)
            latents = self._split_denoise(
                payload, self._place_batch(noise * sigma0), keys, conds,
                pooleds, job, refiner, ref_cond, ragged, controls=controls,
                inpaint_cond=inp)
            out_w, out_h = width, height
            if payload.enable_hr and not self.state.flag.interrupted:
                # the whole group's rows, pad-and-drop as above
                latents, out_w, out_h = self._hires_pass(
                    payload, latents, keys, conds, pooleds, job, refiner,
                    ref_cond)
            self._keep_one_decode(out, payload, pending, self._queue_decoded(
                latents, pos, n, out_w, out_h))
            pos += n
            remaining -= n
        self._flush_decoded(out, payload, pending)
        return out

    def _run_txt2img_staged(self, payload: GenerationPayload, start: int,
                            count: int, job: str,
                            controls: Sequence[Control]
                            ) -> GenerationResult:
        """txt2img through the stage-graph executor (``SDTPU_STAGE_GRAPH``,
        the JAX package's ``_run_txt2img_staged``): each group is an
        encode -> denoise -> decode graph whose stages dispatch without
        waiting (``_denoise(sync=False)``, the decode into pinned memory
        behind an event), and a :class:`~..parallel.stage_graph.
        GraphRunner` defers each group's flush (the PNG encode) until more
        than ``SDTPU_STAGE_DEPTH`` groups are in flight: group *i*'s fetch
        and PNGs, and group *i+1*'s prompt encode, overlap group *i+1*'s
        denoise on the card. A ControlNet request that qualifies runs its
        tower a step ahead of the UNet (:meth:`_denoise_staged_cn`).

        The bytes are the serial loop's: the noise and keys are keyed by
        image index, pad-and-drop runs every group at the full group size,
        a ragged marker runs ragged, and the flushes are FIFO. The preempt
        hook is polled at group boundaries (the async denoise never polls
        it): the runner drains every group in flight, the device is
        yielded, and this request's adapters and interrupt latch come
        back."""
        width, height = payload.width, payload.height
        h, w = self._latent_hw(width, height)
        C = self.family.vae.latent_channels
        spec = kd.resolve_sampler(payload.sampler_name)
        sigma0 = kd.build_sigmas(spec, self.schedule, payload.steps)[0]
        group = max(1, payload.group_size or payload.batch_size)
        per_image = bool(payload.all_prompts)
        ragged_wh = None if (per_image or controls or self.family.inpaint) \
            else self._ragged_plan(payload)
        conds = pooleds = ragged = None
        rows = h
        if ragged_wh is not None:
            conds, pooleds, ctx_true = self.encode_prompts(payload,
                                                           ragged=True)
            rows = self._true_latent_rows(h, ragged_wh[1])
            ragged = tuple(torch.full((group,), length, dtype=torch.int32,
                                      device=self.device)
                           for length in (rows, *ctx_true))
        elif not per_image:
            conds, pooleds = self.encode_prompts(payload)
        inp = (self._blank_inpaint_cond(group, width, height)
               if self.family.inpaint else None)
        # the stage-ahead tower reproduces the evaluation's residuals only
        # for one evaluation per step at (x_i, sigma_i), without the step
        # cache, traced adapters or an inpainting family; anything else
        # keeps the ControlNet inside the evaluation, still asynchronous
        cn_staged = (bool(controls) and spec.evals_per_step == 1
                     and not stepcache.resolve(payload).active
                     and self._traced_lora is None
                     and not self.family.inpaint)
        out = GenerationResult(parameters=payload.model_dump())
        runner = stage_graph.GraphRunner(depth=stage_graph.depth(),
                                         clock=stage_graph.CLOCK)
        pos, remaining = start, count
        while remaining > 0 and not self.state.flag.interrupted:
            hook = self.preempt_hook
            if hook is not None and hook.should_yield():
                # group-boundary yield: every graph in flight flushed in
                # order, the device handed over, this request's view back
                runner.drain()
                interrupted_before_yield = self.state.flag.interrupted
                hook.yield_device()
                self._apply_prompt_loras(payload)
                self.state.restore_interrupt(interrupted_before_yield)
                continue
            n = min(group, remaining)
            graph = stage_graph.StageGraph(
                label=f"txt2img[{pos}:{pos + n}]", group=pos,
                clock=stage_graph.CLOCK)

            def encode_stage(p0=pos):
                if per_image:
                    c, pl, _ = self._group_conds(payload, p0, group, None)
                    return c, pl
                return conds, pooleds

            def denoise_stage(cp, p0=pos):
                c, pl = cp
                x = self._place_batch(self._init_noise(
                    payload, p0, group, (h, w, C), rows) * sigma0)
                keys = self._image_keys(payload, p0, group)
                if cn_staged:
                    return self._denoise_staged_cn(payload, x, keys, c, pl,
                                                   job, controls)
                return self._denoise(payload, x, keys, c, pl, job, ragged,
                                     controls=controls, inpaint_cond=inp,
                                     sync=False)

            def decode_stage(latents, p0=pos, keep=n):
                return self._queue_decoded(latents, p0, keep, width, height)

            graph.add("encode", encode_stage, kind="stage")
            graph.add("denoise", denoise_stage, deps=("encode",),
                      kind="denoise")
            graph.add("decode", decode_stage, deps=("denoise",),
                      kind="stage")
            runner.submit(graph, flush=lambda res: self._flush_decoded(
                out, payload, [res["decode"]]))
            pos += n
            remaining -= n
        runner.drain()
        return out

    def _denoise_staged_cn(self, payload: GenerationPayload, x: torch.Tensor,
                           image_keys: torch.Tensor, conds, pooleds,
                           job: str, controls: Sequence[Control]
                           ) -> torch.Tensor:
        """Denoise ``[0, steps)`` with the ControlNet tower evaluated one
        sigma step AHEAD of the UNet, in graphs of its own (the JAX
        package's ``_denoise_range_staged_cn``): right after step *i*'s
        UNet and sampler math are dispatched, the residuals of step *i+1*
        are dispatched from step *i+1*'s entry latent (graph kind
        ``cnres``), and step *i+1*'s UNet takes them through its
        ``control_residuals`` input (kind ``cnstep``). The residuals are
        step *i+1*'s own, computed from the inputs the single evaluation
        uses, with the units gated, scaled and summed in its order, so
        the bytes are its bytes. The port's evaluation runs a unit only at
        the steps its window gates on (a unit gated to 0 is absent, never
        zero-gated: a zero row could flip -0.0 to +0.0 in the skip adds),
        and so do these residuals. The host paces on one CUDA event per
        step at depth 2 and returns with the tail running.

        Without ``SDTPU_STAGE_CN_DEVICES`` the tower shares the engine's
        devices and stream. With it, :meth:`_stage_cn_mesh` gives the
        tower a mesh of its own: the ``cnres`` graphs run there on copies
        of the units (split over its ``dp`` as the UNet's rows are), and
        the residuals come back to the UNet's device behind an event
        (:meth:`_from_tower`)."""
        spec = kd.resolve_sampler(payload.sampler_name)
        steps = payload.steps
        sigmas = kd.build_sigmas(spec, self.schedule, steps)
        added = self._added_cond(pooleds, payload.width, payload.height)
        denoise, ahead = self._make_denoise_fn(
            *conds, payload.cfg_scale, x.shape[0], added=added,
            controls=controls,
            gates=lambda i: window_gates(controls, i, steps),
            precision=self._precision_for(payload), stage_ahead=True,
            tower=self._stage_cn_mesh())
        step = kd.make_sampler_step(spec, denoise, sigmas, image_keys)
        self.last_step_evals = None
        carry = kd.init_carry(x)
        fences = _Fences(x.device)
        self.state.begin(job, steps)
        dispatched = []
        with obs_spans.device_interval(x.device):
            ahead(carry.x, sigmas[0], 0)
            i = 0
            while i < steps and not self.state.flag.interrupted:
                with trace.STATS.timer("denoise_chunk"), \
                        trace.annotate(f"denoise[{i}:{i + 1}]"):
                    carry = step(carry, i)
                    fences.record()
                dispatched.append((i, 1, False))
                i += 1
                if i < steps:
                    # step i's tower queues behind step i-1's UNet
                    ahead(carry.x, sigmas[i], i)
                fences.wait(2)
                self.state.step(i)
        # no final wait: the decode and the next group's stages queue
        # behind the tail
        self.state.finish()
        self._record_unet_flops(dispatched, 1, 0, spec.evals_per_step, steps,
                                x.shape[0], x.shape[1], x.shape[2],
                                conds[1].shape[1],
                                precision=self._precision_for(payload).name)
        return carry.x

    def _stage_cn_mesh(self) -> Optional[Mesh]:
        """The stage-ahead ControlNet tower's mesh
        (``SDTPU_STAGE_CN_DEVICES=N``), by the JAX package's rule: ``dp=N``
        over the last N visible cards outside the engine's when that many
        are free, else over the trailing N of all, built by
        ``build_mesh``. None when the knob is 0 or the slice would take
        every device (the tower then shares the engine's card and
        stream), and off the card. Cached per N until the engine's mesh
        changes."""
        n = stage_graph.cn_slice_devices()
        if n <= 0 or self.device.type != "cuda":
            return None
        cached = self._stage_cn_mesh_cache
        if cached is not None and cached[0] == n:
            return cached[1]
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
        used = ({d for d in self.mesh.devices.flat} if self.mesh is not None
                else {self.device})
        free = [d for d in devs
                if not any(_same_device(d, u) for u in used)]
        pool = free if len(free) >= n else devs
        mesh = None
        if len(pool) >= n and not (pool is devs and len(devs) <= n):
            mesh = build_mesh(f"dp={n}", devices=pool[-n:])
        self._stage_cn_mesh_cache = (n, mesh)
        return mesh

    def _run_img2img(self, payload: GenerationPayload, start: int,
                     count: int, job: str) -> GenerationResult:
        """img2img and inpainting (the JAX package's ``_run_img2img``):
        the init image encoded once at batch 1, each group's rows entering
        the sigma ladder at step ``steps - t_enc`` from it; a masked
        request runs the base model alone, pinned outside its mask."""
        width, height = payload.width, payload.height
        h, w = self._latent_hw(width, height)
        C = self.family.vae.latent_channels
        spec = kd.resolve_sampler(payload.sampler_name)
        sigmas = kd.build_sigmas(spec, self.schedule, payload.steps)
        # webui: t_enc = int(min(strength, 0.999) * steps)
        t_enc = int(min(payload.denoising_strength, 0.999) * payload.steps)
        start_step = payload.steps - t_enc
        init = b64png_to_array(payload.init_images[0]).astype(
            np.float32) / 255.0
        init = resize_image(init, width, height)
        controls = self._prepare_controls(payload, width, height)
        masked = payload.mask is not None
        refiner = None if masked else self._refiner_engine(payload)
        per_image = bool(payload.all_prompts)
        conds = pooleds = ref_cond = None
        if not per_image:
            conds, pooleds = self.encode_prompts(payload)
            ref_cond = (refiner.encode_prompts(payload)
                        if refiner is not None else None)
        mask_lat = mask_pixels = None
        if masked:
            mask_lat, mask_pixels = self._inpaint_mask(payload, width,
                                                       height)
        group = max(1, payload.group_size or payload.batch_size)
        inp = None
        if self.family.inpaint:
            inp = (self._masked_inpaint_cond(group, width, height, init,
                                             mask_pixels) if masked
                   else self._blank_inpaint_cond(group, width, height))
        # one frame for every row: encoded once, at batch 1
        init_lat1 = self._encode_images(
            torch.from_numpy(np.ascontiguousarray(init))[None]
            .to(self.device))
        out = GenerationResult(parameters=payload.model_dump())
        pending: List[_Decoded] = []
        pos, remaining = start, count
        while remaining > 0 and not self.state.flag.interrupted:
            n = min(group, remaining)
            # pad-and-drop, as in txt2img
            keys = self._image_keys(payload, pos, group)
            init_lat = self._apply_inpaint_fill(
                payload, init_lat1.repeat(group, 1, 1, 1), mask_lat, keys)
            noise = self._init_noise(payload, pos, group, (h, w, C), h)
            x = self._place_batch(init_lat + noise * sigmas[start_step])
            if per_image:
                conds, pooleds, ref_cond = self._group_conds(
                    payload, pos, group, refiner)
            if masked:
                latents = self._denoise(
                    payload, x, keys, conds, pooleds, job,
                    start_step=start_step, controls=controls,
                    mask=(mask_lat, init_lat), inpaint_cond=inp)
            else:
                latents = self._split_denoise(
                    payload, x, keys, conds, pooleds, job, refiner,
                    ref_cond, start_step=start_step, controls=controls,
                    inpaint_cond=inp)
            self._keep_one_decode(out, payload, pending, self._queue_decoded(
                latents, pos, n, width, height))
            pos += n
            remaining -= n
        self._flush_decoded(out, payload, pending)
        return out

    def _keep_one_decode(self, out: GenerationResult,
                         payload: GenerationPayload, pending: list,
                         decoded: "_Decoded") -> None:
        """The serial loops' decode pipeline (the JAX package's): queue
        this group's decode and flush the one before it, so one decode is
        in flight while the host encodes the previous group's PNGs and
        dispatches the next group."""
        pending.append(decoded)
        if len(pending) > 1:
            self._flush_decoded(out, payload, pending[:-1])
            del pending[:-1]

    def _append_images(self, out: GenerationResult,
                       payload: GenerationPayload, imgs: np.ndarray,
                       pos: int, width: int, height: int,
                       incomplete: bool = False) -> None:
        pinned = payload.subseed_strength > 0 or payload.same_seed
        for j, img in enumerate(imgs):
            i = pos + j
            seed_i = payload.seed + (0 if pinned else i)
            sub_i = payload.subseed + (0 if payload.same_seed else i)
            out.images.append(array_to_b64png(img))
            out.seeds.append(int(seed_i))
            out.subseeds.append(int(sub_i))
            prompt_i = payload.prompt
            if payload.all_prompts and i < len(payload.all_prompts):
                prompt_i = payload.all_prompts[i]
            out.prompts.append(prompt_i)
            out.negative_prompts.append(payload.negative_prompt)
            text = build_infotext(payload, int(seed_i), int(sub_i),
                                  self.model_name, width, height,
                                  prompt_override=prompt_i)
            if incomplete:
                # DPM adaptive hit its attempt backstop before sigma_min
                text += ", DPM adaptive: incomplete"
            out.infotexts.append(text)
            out.worker_labels.append("")

    def generate_range(self, payload: GenerationPayload,
                       start_index: int = 0, count: Optional[int] = None,
                       job: str = "txt2img") -> GenerationResult:
        """Produce images ``[start_index, start_index+count)`` of the
        request (the unit of a seed-exact batch split): img2img when it
        carries ``init_images``, else txt2img."""
        payload = payload.model_copy()
        payload.seed = fix_seed(payload.seed)
        payload.subseed = fix_seed(payload.subseed)
        self._adaptive_incomplete = False
        if payload.all_prompts and payload.context_chunks is None:
            # a whole request (a range from a fleet arrives with its
            # master's pin): the request-wide context length, so that an
            # image's conditioning does not depend on its group
            payload.context_chunks = self.request_context_chunks(payload)
        count = payload.total_images if count is None else count
        with obs_spans.span("generate_range", job=job,
                            start=int(start_index), count=int(count),
                            size=f"{payload.width}x{payload.height}"):
            return self.run_on_device(self._generate, payload, start_index,
                                      count, job)

    def _generate(self, payload: GenerationPayload, start: int, count: int,
                  job: str) -> GenerationResult:
        self._apply_prompt_loras(payload)
        run = self._run_img2img if payload.init_images else self._run_txt2img
        return run(payload, start, count, job)

    def run_on_device(self, fn, *args):
        """``fn(*args)`` on the engine's device thread, in inference mode
        with the reproducible backend settings; returns its result. The
        serving dispatcher runs its coalesced groups through here. Called
        on the device thread (an interloper run during a yield), it runs
        inline."""
        return self.device_runner.run(self._on_device, fn, args)

    def executable_keys(self) -> list:
        """``(model, graph key)`` of every captured evaluation: the input
        of the ``/internal/executables`` census (``obs/perf.py``)."""
        return [(self.model_name, key) for key in self._graphs.keys()]

    def close(self) -> None:
        """Drop the captured graphs and end the device thread; the
        weights go with the last reference to the engine (the warm pool
        closes a retired resident, ``fleet/pool.py``)."""
        self._graphs = graphs_mod.GraphCache()
        self.device_runner.close()

    def _on_device(self, fn, args):
        with torch.inference_mode(), _reproducible(self.device):
            return fn(*args)

    # -- mesh ----------------------------------------------------------------

    def set_mesh(self, mesh: Optional[Mesh]) -> None:
        """Place the model over ``mesh`` (None: the engine's device alone),
        from the full weights (the JAX engine's ``shard_params`` over its
        whole parameter tree, at construction, after ``set_vae`` and after
        a LoRA merge): each ``dp`` replica's UNet, ControlNets and VAE
        decoder on its home device with their ``tp`` and ``sp``
        placement, and the text encoders and the VAE encoder, which run on
        the home device, with replica 0's. The mesh's home device must be
        the engine's. Call it between requests (or on the device thread,
        as a VAE swap does)."""
        if mesh is not None and not _same_device(mesh.home(), self.device):
            raise ValueError(f"the home device {mesh.home()} of {mesh} is "
                             f"not the engine's device {self.device}")
        self.mesh = mesh
        self._placed.clear()
        self._stage_cn_mesh_cache = None
        replicated = (self.unet, *self._controlnets.values(), self.vae)
        for module in (*replicated, *self._home_modules()):
            unet_mod.place_layers(module, None)
        if mesh is None:
            return
        for module in replicated:
            self._replicas(module, mesh)
        layout = sharding.replica_layout(mesh, 0)
        for module in self._home_modules():
            unet_mod.place_layers(module, layout)

    def _home_modules(self) -> List[torch.nn.Module]:
        """The modules that run on the home device alone, over every
        row: the text encoders and the VAE encoder."""
        return [m for m in (self.text_encoder, self.text_encoder_2,
                            self.vae_encoder) if m is not None]

    def _mesh_axis(self, axis: str) -> int:
        return self.mesh.shape[axis] if self.mesh is not None else 1

    def _replicas(self, module: torch.nn.Module,
                  mesh: Optional[Mesh]) -> List[torch.nn.Module]:
        """``module`` (the UNet, a ControlNet or the VAE decoder) for each
        ``dp`` replica of ``mesh`` (``[module]`` without one), its layers
        placed once per (module, mesh) over the replica's ``tp`` and
        ``sp`` devices (``models/unet.py`` :func:`~..models.unet.
        place_layers`). On a mesh other than the engine's (the ControlNet
        tower's) the replicas are copies, so the engine's placement of the
        same module stands.

        A replica on a copy (another card's, made anew after every
        :meth:`set_mesh`, VAE swap and LoRA merge) drops the graphs keyed
        by its replica and devices: they were captured against the old
        copy, whose memory is freed or holds the old weights."""
        if mesh is None:
            return [module]
        key = (id(module), id(mesh))
        hit = self._placed.get(key)
        if hit is None or hit[0] is not module or hit[1] is not mesh:
            reps = sharding.replicas(module, mesh, unet_mod.place_layers,
                                     reuse=mesh is self.mesh)
            hit = self._placed[key] = (module, mesh, reps)
            shape = tuple(mesh.shape.values())
            stale = {(shape, r, sharding.replica_layout(mesh, r))
                     for r, m in enumerate(reps) if m is not module}
            if stale:
                self._graphs.discard(
                    lambda k: _mesh_tag(k[0]) in stale)
        return hit[2]

    @staticmethod
    def _dp_split(mesh: Optional[Mesh], rows: int) -> int:
        """Replicas a batch of ``rows`` images splits over on ``mesh``:
        its ``dp`` when the rows divide it, else 1 (replica 0 runs the
        whole batch: JAX's odd-batch fallback)."""
        if mesh is None:
            return 1
        dp = mesh.shape["dp"]
        return dp if dp > 1 and rows % dp == 0 else 1

    def _split_run(self, run: Dict[str, torch.Tensor], batch: int,
                   mesh: Optional[Mesh]) -> List[Tuple[Dict, int]]:
        """An evaluation's per-run inputs (batch-major, ``batch`` image
        rows or their CFG doubling) and a graph binding, for each replica
        of ``mesh`` that a batch of ``batch`` splits over: replica ``r``'s
        rows of every input on its home device, in the doubled layout
        ``[uncond_r; cond_r]`` (``sharding.batch_block``). One entry
        without a mesh."""
        if mesh is None:
            return [(run, self._graphs.binding())]
        n = self._dp_split(mesh, batch)
        return [({k: sharding.batch_block(v, r, n, batch).to(
            mesh.home(r), non_blocking=True) for k, v in run.items()},
            self._graphs.binding()) for r in range(n)]

    def _place_batch(self, x: torch.Tensor) -> torch.Tensor:
        """A range's rows on the engine's home device, where the sampler
        runs (the JAX engine's ``_place_batch``): each UNet evaluation and
        each decode then runs replica ``r``'s block of them on its
        device when they divide ``dp`` (:meth:`_dp_split`), else the whole
        batch on replica 0."""
        return x.to(self.device, non_blocking=True)

    def _from_tower(self, residuals: Sequence[torch.Tensor],
                    tower: Mesh) -> List[torch.Tensor]:
        """The tower's residuals on the engine's device: its stream waits
        on an event recorded after them on the tower's, then copies."""
        src = tower.home()
        if src.type == "cuda" and not _same_device(src, self.device):
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(src))
            torch.cuda.current_stream(self.device).wait_event(event)
        return [r.to(self.device, non_blocking=True) for r in residuals]

    # -- LoRA ---------------------------------------------------------------

    def _lora_provider_gen(self) -> int:
        """The provider's reload generation (``ModelRegistry.
        lora_generation``, bumped by ``/refresh-loras``); 0 for a plain
        callable."""
        owner = getattr(self.lora_provider, "__self__", None)
        return int(getattr(owner, "lora_generation", 0) or 0)

    def set_loras(self, specs) -> None:
        """Merge a stack of ``(name, unet_weight, te_weight)`` adapters into
        the weights, from the pristine ones. Each touched leaf becomes
        ``(pristine.float() + sum of w * delta).to(dtype)``, the adapters
        added in order in f32; a leaf the new stack leaves alone gets its
        pristine bytes back. The resolved outcome is latched, skipped names
        included, with the provider's generation: an identical repeat is a
        no-op, and a rescan retries. Clears the conditioning cache and
        bumps both epochs."""
        key = tuple(specs)
        gen = self._lora_provider_gen()
        if self._active_loras == () and not key:
            return  # pristine engine, empty request: nothing to undo
        if self._active_loras == (key, gen):
            return
        if not key and self._active_loras[0] == ():
            # already pristine, older generation: a rescan cannot change
            # "no adapters"
            self._active_loras = ((), gen)
            return
        t0 = time.perf_counter()
        by_leaf: Dict[Tuple[str, str], list] = {}
        merged = applied = skipped = 0
        for name, weight, te_weight in specs:
            sd = self.lora_provider(name) if self.lora_provider else None
            if sd is None:
                log.warning("lora '%s' not found; skipping", name)
                continue
            patches, a, sk = lora_mod.resolve_lora(
                sd, self.family, lora_mod.shape_getter(self._lora_leaves))
            for p in patches:
                w = te_weight if p.component.startswith("text_encoder") \
                    else weight
                by_leaf.setdefault((p.component, p.key), []).append((p, w))
            merged += 1
            applied += a
            skipped += sk
        with torch.no_grad():
            for leaf in [k for k in self._pristine if k not in by_leaf]:
                comp, name = leaf
                self._lora_leaves[comp][name].copy_(self._pristine.pop(leaf))
            for (comp, name), patches in by_leaf.items():
                param = self._lora_leaves[comp][name]
                pristine = self._pristine.get((comp, name))
                if pristine is None:
                    pristine = param.detach().clone()
                    self._pristine[(comp, name)] = pristine
                param.copy_(lora_mod.merge_leaf(pristine, patches))
        self._active_loras = (key, gen)
        self.last_lora_counts = (applied, skipped)
        if self.mesh is not None:
            # a replica on another device holds a copy: the new weights
            self.set_mesh(self.mesh)
        if merged:
            if self.device.type == "cuda":
                # the merge's time is the device's, not its enqueue
                torch.cuda.synchronize(self.device)
            self._lora_merge_total += merged
            obs_prom.count_lora_switch("merged")
            self._lora_merge_seconds += time.perf_counter() - t0
            log.debug("lora: %d adapter(s) merged, %d module(s) applied, "
                      "%d skipped", merged, applied, skipped)
        # the text encoders' weights changed: conditioning computed under
        # the old merge is stale, and so is every content-addressed entry
        self._cond_cache.clear()
        self._cond_epoch += 1
        self._model_epoch += 1

    def _traced_set_for(self, specs: Tuple) -> Optional[lora_mod.TracedSet]:
        """The traced set for a spec tuple, or None when it cannot ride the
        ladders (the caller then takes the merged path). Cached by (specs,
        provider generation); a hit is served only while each adapter's
        state dict is still the provider's own, so a file edited on disk
        (reloaded to a new dict) rebuilds it. A build is timed to the end
        of its device work, waited for after the lock is released."""
        with self._traced_lock:
            ts, t0 = self._traced_set_locked(tuple(specs))
        if t0 is not None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.last_traced_build_seconds = time.perf_counter() - t0
            obs_prom.observe_lora_apply(self.last_traced_build_seconds)
        return ts

    def _traced_set_locked(self, specs: Tuple
                           ) -> Tuple[Optional[lora_mod.TracedSet],
                                      Optional[float]]:
        """The set (or None) and, when it was built now, the build's
        start on the host clock."""
        key = (specs, self._lora_provider_gen())
        ts = self._traced_cache.get(key)
        if ts is not None:
            if self.lora_provider is not None and all(
                    self.lora_provider(name) is src
                    for (name, _w, _tw), src in zip(ts.specs, ts.srcs)):
                self._traced_cache.move_to_end(key)
                return ts, None
            del self._traced_cache[key]
        t0 = time.perf_counter()
        ts = lora_mod.build_traced_set(specs, self.lora_provider,
                                       self.family, self._lora_leaves,
                                       self.device,
                                       self.policy.compute_dtype)
        if ts is None:
            return None, t0
        self._traced_cache[key] = ts
        if len(self._traced_cache) > self._TRACED_CACHE_MAX:
            self._traced_cache.popitem(last=False)
        return ts, t0

    def traced_te_content(self) -> str:
        """Content address of the active traced set's text-encoder
        factors; "" when none is active or it touches no text encoder (the
        conditioning is then the adapterless one)."""
        ts = self._traced_lora
        return ts.te_content if ts is not None and ts.te_content else ""

    def traced_content_for_payload(self, payload: GenerationPayload) -> str:
        """Content address of the traced set this payload would run under;
        "" on the merged path."""
        if not lora_mod.traced_enabled():
            return ""
        _, tags = lora_mod.extract_lora_tags(payload.prompt)
        if not tags or kd.resolve_sampler(payload.sampler_name).adaptive:
            return ""
        ts = self._traced_set_for(tuple(tags))
        return ts.content if ts is not None else ""

    def _apply_prompt_loras(self, payload: GenerationPayload) -> None:
        """Activate the adapters the prompt names (the payload keeps its
        tags for the infotext). Under ``SDTPU_LORA_TRACED`` they resolve to
        a traced set and any merge is undone first; a set the ladders
        cannot hold, and a DPM adaptive request (whose attempt takes no
        factors), take the merged path, as in the JAX package."""
        _, tags = lora_mod.extract_lora_tags(payload.prompt)
        if lora_mod.traced_enabled() and not kd.resolve_sampler(
                payload.sampler_name).adaptive:
            ts = self._traced_set_for(tuple(tags)) if tags else None
            if ts is None and not tags and self._warmup_lora is not None:
                # the warmup sweep: an all-zero stand-in set at an explicit
                # ladder cell captures the graphs every set of that cell
                # replays (its factors are per-run graph inputs)
                ts = lora_mod.zero_set(self._lora_leaves, self.family,
                                       *self._warmup_lora, self.device,
                                       self.policy.compute_dtype)
            if ts is not None or not tags:
                if self._active_loras:
                    # the traced deltas assume the pristine weights
                    self.set_loras(())
                prev = self._traced_lora
                self._traced_lora = ts
                if ts is not None and (prev is None
                                       or prev.content != ts.content):
                    obs_prom.count_lora_switch("traced")
                return
        self._traced_lora = None
        if tags or self._active_loras:
            self.set_loras(tags)

    def txt2img(self, payload: GenerationPayload) -> GenerationResult:
        # top-level request: reset the interrupt latch, expand scripts
        self.state.begin_request()
        return self.generate_range(apply_scripts(payload), 0, None,
                                   "txt2img")

    def img2img(self, payload: GenerationPayload) -> GenerationResult:
        self.state.begin_request()
        return self.generate_range(apply_scripts(payload), 0, None,
                                   "img2img")


class _Decoded:
    """One queued decode: the pinned host buffer its pixels land in, the
    events recorded after its copies on each device that made them (none
    on the CPU, where the copy has happened), and where its kept images
    go."""

    __slots__ = ("host", "events", "pos", "n", "width", "height",
                 "incomplete")

    def __init__(self, host: torch.Tensor, events, pos: int, n: int,
                 width: int, height: int, incomplete: bool):
        self.host = host
        self.events = events
        self.pos = pos
        self.n = n
        self.width = width
        self.height = height
        self.incomplete = incomplete

    def pixels(self) -> np.ndarray:
        """The kept images (n, H, W, 3) uint8, once the device wrote
        them."""
        for event in self.events:
            event.synchronize()
        return self.host[:self.n].numpy()


class _Fences:
    """CUDA events recorded after each dispatched chunk (or step), so the
    host can let at most ``depth`` of them run ahead of it: the JAX
    package's fences. The host waits on an event, never on a copy of a
    device value. On the CPU every dispatch has run when it returns, and
    nothing is recorded."""

    def __init__(self, device: torch.device):
        self._cuda = device.type == "cuda"
        self._events: "deque[torch.cuda.Event]" = deque()

    def record(self) -> None:
        if self._cuda:
            event = torch.cuda.Event()
            event.record()
            self._events.append(event)

    def wait(self, depth: int) -> None:
        """Until at most ``depth`` recorded dispatches are unfinished."""
        while len(self._events) > depth:
            self._events.popleft().synchronize()


class _StepCache:
    """One denoise range's deep-feature cache: the ``[uncond; cond]``
    rows of the deep feature (``buf``, outside the graphs' pool), whether
    they are valid, the refresh cadence, the first CFG-truncated step and
    the range's evaluations by kind (``stepcache.plan_schedule``'s
    keys)."""

    def __init__(self, buf: torch.Tensor, cadence: int, cfg_stop: int):
        self.buf = buf
        self.valid = False
        self.cadence = cadence
        self.cfg_stop = cfg_stop
        self.counts = dict.fromkeys(
            ("full_evals", "reuse_full_evals", "reuse_trunc_evals",
             "deep_full", "deep_trunc", "refreshes"), 0)

    def count(self, kind: str) -> None:
        self.counts[kind] += 1


_REPRO_FLAGS = ((torch.backends.cudnn, "deterministic", True),
                (torch.backends.cudnn, "allow_tf32", False),
                (torch.backends.cuda.matmul, "allow_tf32", False))
_repro_lock = threading.Lock()
_repro_users = 0  # guarded-by: _repro_lock
_repro_prev: List = []  # guarded-by: _repro_lock


@contextlib.contextmanager
def _reproducible(device: torch.device):
    """cuDNN may otherwise pick convolution algorithms whose sums run in a
    different order from one call to the next; a repeated request must give
    the same image bytes. TF32 is held off for the f32 islands (the VAE
    decoder, conv_out): the flags are process-wide, and a process whose
    other code left cuDNN's TF32 on would otherwise give other bytes than
    the fleet node beside it. The flags are set while ANY engine of the
    process generates and put back when the last one leaves: each engine
    restoring its own entry's view would switch them off under another
    engine still running on its own device thread (a fleet's local remote,
    the warm pool's residents)."""
    if device.type != "cuda":
        yield
        return
    global _repro_users, _repro_prev
    with _repro_lock:
        if _repro_users == 0:
            _repro_prev = [getattr(obj, name) for obj, name, _ in _REPRO_FLAGS]
            for obj, name, value in _REPRO_FLAGS:
                setattr(obj, name, value)
        _repro_users += 1
    try:
        yield
    finally:
        with _repro_lock:
            _repro_users -= 1
            if _repro_users == 0:
                for (obj, name, _), value in zip(_REPRO_FLAGS, _repro_prev):
                    setattr(obj, name, value)


def _same_device(a: torch.device, b: torch.device) -> bool:
    """``cuda`` and ``cuda:<current>`` are one device."""
    if a.type != b.type:
        return False
    if a.type != "cuda" or a.index == b.index:
        return True
    current = torch.cuda.current_device()
    return (a.index if a.index is not None else current) == \
        (b.index if b.index is not None else current)


def _mesh_tag(tag: Tuple) -> Optional[Tuple]:
    """``(mesh shape, replica, devices)`` of a graph tag that ends with
    one (a replica's evaluation on a mesh, ``_make_denoise_fn``), else
    None."""
    last = tag[-1] if tag else None
    if isinstance(last, tuple) and len(last) == 4 and last[0] == "mesh":
        return last[1:]
    return None


def _write_blocks(out, got, r: int, n: int, batch: int,
                  home: torch.device):
    """Writes replica ``r``'s evaluation output (a tensor, or the tower's
    list of them) into ``out``, the whole output in row order on
    ``home`` (``sharding.write_block``)."""
    if isinstance(got, (list, tuple)):
        out = [None] * len(got) if out is None else out
        return [sharding.write_block(o, g, r, n, batch, home)
                for o, g in zip(out, got)]
    return sharding.write_block(out, got, r, n, batch, home)


def _zero_tail_rows(step, true_rows: torch.Tensor, lat_h: int):
    """``step`` followed by zeroing the latent rows at or past
    ``true_rows``: ancestral samplers add fresh noise everywhere, and the
    padded rows must stay exactly 0 into every convolution of the next
    step."""
    keep = (torch.arange(lat_h, device=true_rows.device)[None, :]
            < true_rows[:, None])[:, :, None, None]

    def masked_step(carry, i):
        carry = step(carry, i)
        return carry._replace(x=torch.where(keep, carry.x, 0.0))

    return masked_step


def parse_controlnet_units(payload: GenerationPayload) -> List[Dict]:
    """The enabled units of ``alwayson_scripts`` (key ``controlnet`` or
    ``ControlNet``), each with its ``image`` and ``mask`` resolved: the
    flat ``image`` / ``input_image`` fields, or the Mikubill dict form
    ``{"image": ..., "mask": ...}``, whose mask feeds the inpaint
    preprocessor. A unit without an image is left out."""
    scripts = payload.alwayson_scripts or {}
    for key in ("controlnet", "ControlNet"):
        if key not in scripts:
            continue
        units = []
        for u in scripts[key].get("args", []):
            if not isinstance(u, dict) or not u.get("enabled", True):
                continue
            image = u.get("image") or u.get("input_image")
            mask = u.get("mask")
            if isinstance(image, dict):
                mask = image.get("mask") or mask
                image = image.get("image")
            if not image:
                continue
            units.append({**u, "image": image, "mask": mask})
        return units
    return []


def _pin_unmasked(step, sigmas: torch.Tensor, keys: torch.Tensor,
                  mask_lat: torch.Tensor, init_lat: torch.Tensor):
    """``step`` followed by pinning the region outside the mask to the init
    latent noised to the next sigma: ``mask * x + (1 - mask) * (init +
    n * sigmas[i + 1])``, ``n`` keyed ``fold_in(k, 1_000_000 + i)`` per
    image."""
    def masked_step(carry, i):
        carry = step(carry, i)
        noise = rng.normal(rng.fold_in(keys, 1_000_000 + i),
                           init_lat.shape[1:])
        return carry._replace(
            x=_pin(carry.x, mask_lat, init_lat, noise, sigmas[i + 1]))

    return masked_step


def _adaptive_pin(x: torch.Tensor, keys: torch.Tensor,
                  mask_lat: torch.Tensor, init_lat: torch.Tensor,
                  sigma: float, n: int) -> torch.Tensor:
    """DPM adaptive's pin after accepted step ``n`` at ``sigma``: as
    :func:`_pin_unmasked`, the noise keyed ``fold_in(fold_in(k,
    2_000_000), n)``, apart from the fixed-grid loop's keys."""
    noise = rng.normal(rng.fold_in(rng.fold_in(keys, 2_000_000), n),
                       init_lat.shape[1:])
    return _pin(x, mask_lat, init_lat, noise,
                torch.tensor(sigma, dtype=torch.float32))


def _pin(x: torch.Tensor, mask_lat: torch.Tensor, init_lat: torch.Tensor,
         noise: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """``x`` inside the mask, ``init_lat`` noised to ``sigma`` outside."""
    return mask_lat * x + (1 - mask_lat) * (init_lat + noise * sigma)


def window_gates(controls: Sequence[Control], step: int,
                 total_steps: int) -> List[float]:
    """Each unit's gate at sampler step ``step``: its weight where ``(step
    + 0.5) / total_steps`` lies in its guidance window, else 0, in f32 as
    the JAX package computes it in the graph."""
    frac = (np.float32(step) + np.float32(0.5)) / np.float32(total_steps)
    return [float(np.float32(w)) if np.float32(lo) <= frac <= np.float32(hi)
            else 0.0 for _, _, w, lo, hi in controls]


def adaptive_gates(controls: Sequence[Control], sigmas: torch.Tensor,
                   s: float) -> List[float]:
    """Each unit's gate for a DPM adaptive attempt from position ``s``,
    as the JAX package gates them on the host: ``s`` (the attempt's
    ``-log(sigma)``) is located on the ascending sigma ladder
    (``searchsorted``), the index turned into ``(i + 0.5) / steps`` and
    the unit's weight kept where that lies in its window."""
    ladder = sigmas.numpy().astype(np.float64)[::-1].copy()
    n = len(sigmas) - 1
    j = int(np.searchsorted(ladder, s, side="left"))
    idx = min(max(n - j, 0), max(n - 1, 0))
    frac = (idx + 0.5) / max(n, 1)
    return [float(np.float32(w)) if lo <= frac <= hi else 0.0
            for _, _, w, lo, hi in controls]
