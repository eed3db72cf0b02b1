"""The generation engine: the txt2img slice in PyTorch.

Port of the JAX package's ``pipeline/engine.py`` for the single-prompt
txt2img path: encode the prompts (CLIP, clip skip, emphasis with the chunk
mean restored, 77-token chunks joined), draw each image's init noise from
its seed, denoise with classifier-free guidance over two rows in a chunked
loop that polls the interrupt between chunks, decode to uint8 pixels, and
return base64 PNGs with per-image seeds and infotext.

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
back to the host.

What this slice does not run raises :class:`~.payload.Unsupported` (HTTP
422): img2img, hires fix, the refiner, ControlNet, LoRA tags, per-image
prompts and scripts, the step cache, other serving precisions, and the
samplers other than Euler and Euler a.
"""

from __future__ import annotations

import contextlib
import re
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from stable_diffusion_webui_distributed_tpu_torch.bridge import (
    StateDicts,
    build_modules,
)
from stable_diffusion_webui_distributed_tpu_torch.models.clip import (
    pad_encoded_context,
)
from stable_diffusion_webui_distributed_tpu_torch.models.configs import (
    ModelFamily,
)
from stable_diffusion_webui_distributed_tpu_torch.models.prompt import (
    pad_chunks,
    tokenize_weighted,
)
from stable_diffusion_webui_distributed_tpu_torch.models.tokenizer import (
    load_tokenizer,
)
from stable_diffusion_webui_distributed_tpu_torch.models.unet import (
    norms_to_f32,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    GenerationPayload,
    GenerationResult,
    Unsupported,
    apply_scripts,
    array_to_b64png,
    build_infotext,
    fix_seed,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime import dtypes, rng
from stable_diffusion_webui_distributed_tpu_torch.runtime import (
    interrupt as interrupt_mod,
)
from stable_diffusion_webui_distributed_tpu_torch.samplers import (
    kdiffusion as kd,
)
from stable_diffusion_webui_distributed_tpu_torch.samplers import (
    schedules as sched,
)

_LORA_TAG = re.compile(r"<lora:([^:>]+)(?::([0-9.+-]+))?(?::([0-9.+-]+))?>")


def _load(module: torch.nn.Module, state_dict, device) -> torch.nn.Module:
    module = module.to_empty(device=device)
    module.load_state_dict(state_dict, strict=True)
    return module.requires_grad_(False).eval()


class Engine:
    """One loaded model family on one device.

    ``params`` are the port's state dicts (``bridge.flax_to_torch`` or
    ``bridge.init_seeded``). ``device`` is ``cuda`` unless named; with none
    named and no GPU present the constructor raises."""

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
    ):
        self.device = dtypes.resolve_device(device)
        self.family = family
        self.policy = policy
        self.model_name = model_name or family.name
        self.state = state or interrupt_mod.STATE
        self.chunk_size = max(1, chunk_size)
        self.schedule = schedule or sched.sd_schedule(
            prediction_type=family.prediction_type)
        self.tokenizer = tokenizer or load_tokenizer(
            None, family.text_encoder.vocab_size)

        with torch.device("meta"):
            modules = build_modules(family)
        loaded = {name: _load(m, params[name], self.device)
                  for name, m in modules.items()}
        pd, cd = policy.param_dtype, policy.compute_dtype
        # weights are stored in param_dtype and computed in compute_dtype;
        # the norms, the UNet's conv_out and the whole VAE decoder compute
        # in f32
        self.text_encoder = norms_to_f32(loaded["text_encoder"].to(pd).to(cd))
        self.unet = norms_to_f32(loaded["unet"].to(pd).to(cd))
        self.unet.conv_out.float()
        self.vae = loaded["vae"].to(pd).float()

        # cross-request conditioning cache (webui's cached_c/cached_uc),
        # keyed on prompt text + clip skip + chunk count
        self._cond_cache: "OrderedDict[Tuple, Tuple]" = OrderedDict()
        self._COND_CACHE_MAX = 64
        # Every generation runs on this one thread, whichever thread asks.
        # PyTorch keeps cuBLAS and cuDNN handles and cuDNN's plan cache per
        # thread, and on the card the same UNet call made from a fresh
        # thread can give other bits; a repeated request must give the same
        # image bytes. One thread also serialises the engine's requests.
        self._device_thread = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="engine")

    # -- text conditioning -------------------------------------------------

    def _encode(self, ids: np.ndarray, weights: np.ndarray, skip: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(n_chunks, 77) ids/weights -> (context (1, n*77, D) f32, pooled
        (1, D) f32): emphasis scales the tokens, the chunk mean is
        restored, the chunks join along the sequence axis."""
        ctx, pooled = self.text_encoder(
            torch.from_numpy(ids).long().to(self.device),
            skip=skip if skip else None)
        ctx = ctx.float()
        w = torch.from_numpy(weights).to(self.device)
        orig_mean = ctx.mean(dim=(1, 2), keepdim=True)
        ctx = ctx * w[:, :, None]
        new_mean = ctx.mean(dim=(1, 2), keepdim=True)
        ratio = torch.where(new_mean.abs() > 1e-7, orig_mean / new_mean,
                            torch.ones_like(new_mean))
        ctx = ctx * ratio
        return ctx.reshape(1, -1, ctx.shape[-1]), pooled[:1].float()

    def encode_prompts(self, payload: GenerationPayload, ragged: bool = False):
        """``((ctx_u, ctx_c), (pooled_u, pooled_c))`` for the request's one
        prompt and its negative prompt, padded to one chunk count.

        ``ragged``: each prompt is encoded at its own chunk count (so one
        cache entry serves it in any group) and the encoded rows are
        zero-padded to the request's; a third item ``(ctx_true_u,
        ctx_true_c)`` gives the valid context tokens of each half, which
        the UNet's cross-attention masks the padding by."""
        tok = self.tokenizer
        prompt = _strip_prompt(payload.prompt)
        ids_c, w_c = tokenize_weighted(tok, prompt)
        ids_u, w_u = tokenize_weighted(tok, payload.negative_prompt)
        n = max([ids_c.shape[0], ids_u.shape[0]]
                + ([payload.context_chunks] if payload.context_chunks
                   else []))
        depth = self.family.text_encoder.num_layers
        skip = min(12, depth - 1, max(0, int(payload.clip_skip or 0)))

        def cached(raw, ids, w):
            n_enc = ids.shape[0] if ragged else n
            key = (raw, skip, n_enc)
            hit = self._cond_cache.get(key)
            if hit is not None:
                self._cond_cache.move_to_end(key)
                return hit
            out = self._encode(*pad_chunks(ids, w, n_enc, tok.eos, tok.bos),
                               skip)
            self._cond_cache[key] = out
            if len(self._cond_cache) > self._COND_CACHE_MAX:
                self._cond_cache.popitem(last=False)
            return out

        ctx_c, pooled_c = cached(prompt, ids_c, w_c)
        ctx_u, pooled_u = cached(payload.negative_prompt, ids_u, w_u)
        if not ragged:
            return (ctx_u, ctx_c), (pooled_u, pooled_c)
        width = ids_c.shape[1]
        ctx_true = (ids_u.shape[0] * width, ids_c.shape[0] * width)
        return ((pad_encoded_context(ctx_u, n, width),
                 pad_encoded_context(ctx_c, n, width)),
                (pooled_u, pooled_c), ctx_true)

    def request_context_chunks(self, payload: GenerationPayload) -> int:
        """The request's context length in 77-token chunks: the longer of
        its prompt and its negative prompt. A coalesced group pads every
        member's conditioning to the group's largest."""
        tok = self.tokenizer
        return int(max(
            tokenize_weighted(tok, _strip_prompt(payload.prompt))[0].shape[0],
            tokenize_weighted(tok, payload.negative_prompt)[0].shape[0]))

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

    def _make_denoise_fn(self, ctx_u, ctx_c, cfg_scale: float, batch: int,
                         ragged=None):
        """x0-prediction denoiser with classifier-free guidance: one UNet
        call on ``[uncond; cond]`` rows per evaluation. ``ctx_c`` is one
        ``(1, L, D)`` context or one per row.

        ``ragged``: ``(true_rows, ctx_true_u, ctx_true_c)``, ``(batch,)``
        int device tensors. The CFG doubling repeats ``true_rows`` and puts
        the two context lengths in the order of the rows."""
        ctx = torch.cat([ctx_u.expand(batch, -1, -1),
                         ctx_c.expand(batch, -1, -1)])
        ragged_kw = {}
        if ragged is not None:
            true_rows, ctx_true_u, ctx_true_c = ragged
            ragged_kw = {"true_rows": torch.cat([true_rows, true_rows]),
                         "ctx_true": torch.cat([ctx_true_u, ctx_true_c])}
        cfg = torch.tensor(cfg_scale, dtype=torch.float32)
        v_pred = self.schedule.prediction_type == "v_prediction"

        def denoise(x, sigma, step):
            c_in = 1.0 / torch.sqrt(sigma**2 + 1.0)
            t = self.schedule.sigma_to_t(sigma)
            xin = x * c_in
            tb = torch.full((2 * batch,), float(t), dtype=torch.float32,
                            device=x.device)
            out = self.unet(torch.cat([xin, xin]), tb, ctx, **ragged_kw)
            out_u, out_c = out.float().chunk(2)
            guided = out_u + cfg * (out_c - out_u)
            if v_pred:
                c_skip = 1.0 / (sigma**2 + 1.0)
                c_out = sigma / torch.sqrt(sigma**2 + 1.0)
                return x * c_skip - guided * c_out
            return x - sigma * guided

        return denoise

    def _denoise(self, payload: GenerationPayload, x: torch.Tensor,
                 image_keys: torch.Tensor, conds, job: str,
                 ragged=None) -> torch.Tensor:
        """Chunked sampler loop: ``chunk_size`` steps at a time, the
        interrupt flag and progress checked between chunks. ``conds`` is
        ``(ctx_u, ctx_c)``; ``ragged`` as for :meth:`_make_denoise_fn`."""
        spec = kd.resolve_sampler(payload.sampler_name)
        steps = payload.steps
        sigmas = kd.build_sigmas(spec, self.schedule, steps)
        denoise = self._make_denoise_fn(*conds, payload.cfg_scale,
                                        x.shape[0], ragged)
        step = kd.make_sampler_step(spec, denoise, sigmas, image_keys)
        if ragged is not None:
            step = _zero_tail_rows(step, ragged[0], x.shape[1])
        carry = kd.init_carry(x)
        self.state.begin(job, steps)
        pos = 0
        while pos < steps and not self.state.flag.interrupted:
            end = min(pos + self.chunk_size, steps)
            for i in range(pos, end):
                carry = step(carry, i)
            pos = end
            self.state.step(pos)
        self.state.finish()
        return carry.x

    # -- decode --------------------------------------------------------------

    #: images decoded per call = max(1, budget // (width*height)), bounding
    #: the f32 decoder's scratch (the JAX package's _DECODE_PIXEL_BUDGET)
    _DECODE_PIXEL_BUDGET = 1024 * 1024

    def _decode_u8(self, latents: torch.Tensor, width: int,
                   height: int) -> np.ndarray:
        """Latents (B,h,w,C) -> uint8 pixels (B,H,W,3) on the host."""
        per = max(1, self._DECODE_PIXEL_BUDGET // max(1, width * height))
        scale = self.family.vae.scaling_factor
        out = []
        for s in range(0, latents.shape[0], per):
            imgs = self.vae(latents[s:s + per] / scale)
            px = torch.clamp(imgs * 0.5 + 0.5, 0.0, 1.0) * 255.0 + 0.5
            out.append(px.to(torch.uint8).cpu().numpy())
        return np.concatenate(out)

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
        # ragged solo run: the bucket's shape, the true rows as data
        ragged_wh = self._ragged_plan(payload)
        ragged = None
        if ragged_wh is None:
            conds, _ = self.encode_prompts(payload)
            rows = h
        else:
            conds, _, ctx_true = self.encode_prompts(payload, ragged=True)
            rows = self._true_latent_rows(h, ragged_wh[1])
            ragged = tuple(torch.full((group,), length, dtype=torch.int32,
                                      device=self.device)
                           for length in (rows, *ctx_true))
        out = GenerationResult(parameters=payload.model_dump())
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
            latents = self._denoise(payload, noise * sigma0,
                                    self._image_keys(payload, pos, group),
                                    conds, job, ragged)
            imgs = self._decode_u8(latents, width, height)[:n]
            self._append_images(out, payload, imgs, pos, width, height)
            pos += n
            remaining -= n
        return out

    def _append_images(self, out: GenerationResult,
                       payload: GenerationPayload, imgs: np.ndarray,
                       pos: int, width: int, height: int) -> None:
        pinned = payload.subseed_strength > 0 or payload.same_seed
        for j, img in enumerate(imgs):
            i = pos + j
            seed_i = payload.seed + (0 if pinned else i)
            sub_i = payload.subseed + (0 if payload.same_seed else i)
            out.images.append(array_to_b64png(img))
            out.seeds.append(int(seed_i))
            out.subseeds.append(int(sub_i))
            out.prompts.append(payload.prompt)
            out.negative_prompts.append(payload.negative_prompt)
            out.infotexts.append(build_infotext(
                payload, int(seed_i), int(sub_i), self.model_name,
                width, height))
            out.worker_labels.append("")

    def generate_range(self, payload: GenerationPayload,
                       start_index: int = 0, count: Optional[int] = None,
                       job: str = "txt2img") -> GenerationResult:
        """Produce images ``[start_index, start_index+count)`` of the
        request (the unit of a seed-exact batch split)."""
        payload = payload.model_copy()
        payload.seed = fix_seed(payload.seed)
        payload.subseed = fix_seed(payload.subseed)
        check_supported(payload)
        count = payload.total_images if count is None else count
        return self.run_on_device(self._run_txt2img, payload, start_index,
                                  count, job)

    def run_on_device(self, fn, *args):
        """``fn(*args)`` on the engine's device thread, in inference mode
        with the reproducible backend settings; returns its result. The
        serving dispatcher runs its coalesced groups through here."""
        return self._device_thread.submit(self._on_device, fn, args).result()

    def _on_device(self, fn, args):
        with torch.inference_mode(), _reproducible(self.device):
            return fn(*args)

    def txt2img(self, payload: GenerationPayload) -> GenerationResult:
        # top-level request: reset the interrupt latch, expand scripts
        self.state.begin_request()
        return self.generate_range(apply_scripts(payload), 0, None,
                                   "txt2img")


@contextlib.contextmanager
def _reproducible(device: torch.device):
    """cuDNN may otherwise pick convolution algorithms whose sums run in a
    different order from one call to the next; a repeated request must give
    the same image bytes. TF32 is held off for the f32 islands (the VAE
    decoder, conv_out): the flags are process-wide, and a process whose
    other code left cuDNN's TF32 on would otherwise give other bytes than
    the fleet node beside it."""
    if device.type != "cuda":
        yield
        return
    flags = (torch.backends.cudnn, "deterministic", True), \
        (torch.backends.cudnn, "allow_tf32", False), \
        (torch.backends.cuda.matmul, "allow_tf32", False)
    prev = [getattr(obj, name) for obj, name, _ in flags]
    for obj, name, value in flags:
        setattr(obj, name, value)
    try:
        yield
    finally:
        for (obj, name, _), value in zip(flags, prev):
            setattr(obj, name, value)


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


def _strip_prompt(prompt: str) -> str:
    """The JAX package strips ``<lora:...>`` tags before tokenizing and
    collapses the whitespace they leave; the port has no LoRA, so a tag
    raises."""
    if _LORA_TAG.search(prompt):
        raise Unsupported("LoRA tags are not ported to the PyTorch engine "
                          "yet")
    return re.sub(r"\s{2,}", " ", prompt).strip()


def check_supported(payload: GenerationPayload) -> None:
    """Raise :class:`Unsupported` for what this slice does not run, rather
    than answer with an image the JAX package would not make."""
    ov: Dict = payload.override_settings or {}
    scripts = payload.alwayson_scripts or {}
    unsupported = {
        "img2img (init_images)": bool(payload.init_images),
        "hires fix (enable_hr)": payload.enable_hr,
        "the refiner": bool(payload.refiner_checkpoint)
        and payload.refiner_switch_at < 1.0,
        "per-image prompts (all_prompts)": bool(payload.all_prompts),
        "ControlNet": "controlnet" in scripts or "ControlNet" in scripts,
        "serving precisions other than bf16": str(
            payload.precision or ov.get("precision") or "bf16") != "bf16",
        "the step cache (deepcache)": int(ov.get("deepcache", 1) or 1) > 1,
        "CFG truncation (cfg_cutoff)": float(ov.get("cfg_cutoff", 0)
                                             or 0) > 0,
    }
    asked = [name for name, on in unsupported.items() if on]
    if asked:
        raise Unsupported(f"not ported to the PyTorch engine yet: "
                          f"{', '.join(asked)}")
    kd.resolve_sampler(payload.sampler_name)
    _strip_prompt(payload.prompt)
