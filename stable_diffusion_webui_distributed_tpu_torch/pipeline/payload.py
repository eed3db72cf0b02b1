"""Request/response schema, sdapi-v1 compatible.

Port of the JAX package's ``pipeline/payload.py``: the same payload and
result models (a webui client hits either package unchanged), seeds,
infotext, PNG encode/decode with PIL, and the expansion of webui's prompt
matrix and prompts-from-file scripts into per-image prompts
(:func:`apply_scripts`).
"""

from __future__ import annotations

import base64
import io
from typing import Any, Dict, List, Optional

import numpy as np
from pydantic import BaseModel, Field


class Unsupported(ValueError):
    """A request asks for something this slice of the port does not run
    (HTTP 422): never answered with a different image."""


class GenerationPayload(BaseModel):
    """txt2img/img2img request (sdapi superset; unknown fields preserved)."""

    prompt: str = ""
    negative_prompt: str = ""
    seed: int = -1
    subseed: int = -1
    subseed_strength: float = 0.0
    steps: int = 20
    width: int = 512
    height: int = 512
    batch_size: int = 1
    n_iter: int = 1
    cfg_scale: float = 7.0
    sampler_name: str = "Euler a"
    clip_skip: int = 0  # 0 = model default; webui's setting is clip_skip-1
    # Seed-resize (webui): initial noise is drawn at THIS resolution and
    # pasted centered into the target latent, so one seed keeps its
    # composition across aspect ratios. <=0 disables.
    seed_resize_from_w: int = 0
    seed_resize_from_h: int = 0

    # img2img
    init_images: List[str] = Field(default_factory=list)  # base64 PNG
    denoising_strength: float = 0.75
    mask: Optional[str] = None          # base64 PNG, white = repaint
    inpainting_fill: int = 1            # 0 fill, 1 original (webui enum)
    mask_blur: int = 4

    # hires fix (txt2img two-pass; reference ETA models it at worker.py:205-228)
    enable_hr: bool = False
    hr_scale: float = 2.0
    hr_second_pass_steps: int = 0       # 0 = same as steps
    hr_upscaler: str = "Latent"
    hr_resize_x: int = 0
    hr_resize_y: int = 0

    # SDXL base+refiner two-model pass (webui sdapi field names)
    refiner_checkpoint: str = ""
    refiner_switch_at: float = 1.0   # fraction of steps where refiner takes over

    # per-image prompt variation: when set, image i (GLOBAL index for the
    # local backend; backends receiving a sub-range over HTTP get the
    # pre-sliced list) is conditioned on all_prompts[i]. Populated by the
    # prompt-matrix script expansion (apply_scripts) or directly by callers.
    all_prompts: Optional[List[str]] = None
    # webui script selector ("prompt matrix" is implemented natively;
    # self-looping scripts bypass distribution, scheduler/world.py)
    script_name: str = ""
    script_args: List[Any] = Field(default_factory=list)
    # every image reuses the request seed verbatim (prompt-matrix grids
    # compare prompts at a FIXED seed; webui pins all_seeds the same way)
    same_seed: bool = False
    # compiled-batch cap: engines generate in groups of this many images
    # (0 = batch_size). Script expansions set it to the user's original
    # batch_size so a 32-combination matrix doesn't become one 32-wide
    # (64 after CFG) UNet dispatch.
    group_size: int = 0
    # request-wide context length floor (in 77-token chunks) for
    # per-image prompts: conditioning must be padded to the SAME number
    # of chunks for an image regardless of which dispatch group or
    # worker slice it lands in, or the distributed gallery stops being
    # bitwise-identical to the single-host run. The planning master
    # computes it over the FULL all_prompts list and it travels with
    # every HTTP sub-range (slices can't reconstruct it).
    context_chunks: Optional[int] = None

    # fleet tier (fleet/ package): multi-tenant scheduling identity.
    # tenant keys the per-tenant quota bucket; priority_class selects the
    # scheduling class ("interactive" / "batch" / "best_effort"; empty =
    # interactive, the pre-fleet behavior for every request). slo_s, when
    # > 0, overrides the class completion SLO for THIS request (capped
    # admission still applies). All three are inert at SDTPU_FLEET=0.
    tenant: str = "default"
    priority_class: str = ""
    slo_s: float = 0.0

    # serving precision (pipeline/precision.py): "bf16" | "int8" |
    # "int8+conv"; also accepted as override_settings["precision"] (the
    # field wins). Empty = the engine policy's env default
    # (SDTPU_UNET_INT8[_CONV]) — so a request that says nothing is
    # byte-identical to pre-precision behavior. Unknown values bucket to
    # the default host-side rather than failing the request.
    precision: str = ""

    # model / misc
    override_settings: Dict[str, Any] = Field(default_factory=dict)
    styles: List[str] = Field(default_factory=list)
    # alwayson scripts payload (ControlNet etc.), keyed by script title —
    # same shape the reference packs at distributed.py:199-234.
    alwayson_scripts: Dict[str, Any] = Field(default_factory=dict)

    model_config = {"extra": "allow"}

    @property
    def total_images(self) -> int:
        return self.batch_size * self.n_iter


class GenerationResult(BaseModel):
    """Mirrors webui's ``Processed``/sdapi response: images as base64 PNG,
    per-image seeds and infotexts (the reference merges these into its
    gallery at distributed.py:110-181)."""

    images: List[str] = Field(default_factory=list)   # base64 PNG
    seeds: List[int] = Field(default_factory=list)
    subseeds: List[int] = Field(default_factory=list)
    prompts: List[str] = Field(default_factory=list)
    negative_prompts: List[str] = Field(default_factory=list)
    infotexts: List[str] = Field(default_factory=list)
    parameters: Dict[str, Any] = Field(default_factory=dict)
    # which generation backend produced each image (reference appends
    # ", Worker Label: x" to infotext at distributed.py:343-349)
    worker_labels: List[str] = Field(default_factory=list)

    def extend(self, other: "GenerationResult") -> None:
        """Append ``other``'s images and their per-image fields (the
        World's gallery merge)."""
        self.images.extend(other.images)
        self.seeds.extend(other.seeds)
        self.subseeds.extend(other.subseeds)
        self.prompts.extend(other.prompts)
        self.negative_prompts.extend(other.negative_prompts)
        self.infotexts.extend(other.infotexts)
        self.worker_labels.extend(other.worker_labels)


def expand_prompt_matrix(prompt: str) -> List[str]:
    """webui's prompt-matrix grammar: ``base|opt1|opt2`` -> one prompt per
    subset of the options, in binary-counter order (index i holds option
    j when bit j of i is set): 2^n prompts. More than 10 options raise
    ``ValueError`` (1024 images already)."""
    parts = [p.strip() for p in prompt.split("|")]
    base, options = parts[0], parts[1:]
    if len(options) > 10:
        raise ValueError(
            f"prompt matrix with {len(options)} options would generate "
            f"2^{len(options)} images; the limit is 10 options (1024)")
    out = []
    for i in range(1 << len(options)):
        chosen = [options[j] for j in range(len(options)) if i & (1 << j)]
        out.append(", ".join([base] + chosen) if chosen else base)
    return out


def apply_scripts(payload: "GenerationPayload") -> "GenerationPayload":
    """Expand webui's selectable scripts into the payload; idempotent, so
    every entry point (World, server, engine) may call it.

    ``prompt matrix``: the prompt's ``|`` options expand into
    ``all_prompts``, one image per combination at one seed
    (``same_seed``); the user's ``batch_size`` becomes the group size.

    ``prompts from file or textbox``: one image per non-empty line of the
    script's text (the last non-empty string of ``script_args``; lines
    starting with ``#`` are comments); every line at the request's seed
    unless ``checkbox_iterate`` (the first boolean argument) advances it
    per line.

    Any other script passes through unchanged, as in the JAX package."""
    if payload.all_prompts:
        return payload  # already expanded
    script = payload.script_name.strip().lower()
    if script == "prompt matrix" and "|" in payload.prompt:
        payload = payload.model_copy()
        payload.all_prompts = expand_prompt_matrix(payload.prompt)
        payload.group_size = max(1, payload.batch_size)
        payload.batch_size = len(payload.all_prompts)
        payload.n_iter = 1
        payload.same_seed = True
    elif script == "prompts from file or textbox":
        # webui's run(checkbox_iterate, checkbox_iterate_batches,
        # prompt_txt): the text rides last
        args = payload.script_args or []
        text = next((a for a in reversed(args)
                     if isinstance(a, str) and a.strip()), "")
        iterate = bool(next((a for a in args if isinstance(a, bool)), False))
        lines = [ln.strip() for ln in text.splitlines()]
        lines = [ln for ln in lines if ln and not ln.startswith("#")]
        if lines:
            payload = payload.model_copy()
            payload.all_prompts = lines
            payload.group_size = max(1, payload.batch_size)
            payload.batch_size = len(lines)
            payload.n_iter = 1
            payload.same_seed = not iterate
    return payload


def fix_seed(seed: Optional[int]) -> int:
    """-1 -> fresh random seed (webui fix_seed semantics; the reference
    records the fixed value before fan-out so every worker agrees on the
    seed base, distributed.py:252-254)."""
    if seed is None or int(seed) == -1:
        import secrets

        return secrets.randbelow(2**32)
    return int(seed) % 2**32


def canonical_dump(payload: "GenerationPayload") -> Dict[str, Any]:
    """The payload as a fingerprint-stable dict, which the cache keys hash
    (JAX ``pipeline/payload.py`` ``canonical_dump``): the pydantic dump
    gives every declared field (an omitted default equals a spelled-out
    one) in declaration order, and the ``extra="allow"`` fields ride
    along, since an unknown field might change what runs. Hashed only
    after ``fix_seed`` and ``apply_scripts``."""
    return payload.model_dump()


def array_to_b64png(img: np.ndarray) -> str:
    """(H,W,3) uint8 -> base64 PNG string, through the native encoder
    (``runtime/native.py``, as the JAX package's payload does), or PIL
    where it cannot be built."""
    from stable_diffusion_webui_distributed_tpu_torch.runtime import native

    img = np.asarray(img)
    data = native.encode_png(img)
    if data is None:
        from PIL import Image

        native.record_fallback()
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")
        data = buf.getvalue()
    return base64.b64encode(data).decode("ascii")


def b64png_to_array(data: str) -> np.ndarray:
    """base64 PNG (optionally data-URL prefixed) -> (H,W,3) uint8."""
    from PIL import Image

    if "," in data and data.strip().startswith("data:"):
        data = data.split(",", 1)[1]
    img = Image.open(io.BytesIO(base64.b64decode(data)))
    return np.asarray(img.convert("RGB"))


def build_infotext(payload: GenerationPayload, seed: int, subseed: int,
                   model_name: str = "", width: int = 0, height: int = 0,
                   prompt_override: Optional[str] = None) -> str:
    """webui-format generation parameters text (the string the reference
    rewrites per gallery image at distributed.py:343-349).
    ``prompt_override``: this image's own prompt (per-image prompts)."""
    lines = [payload.prompt if prompt_override is None else prompt_override]
    if payload.negative_prompt:
        lines.append(f"Negative prompt: {payload.negative_prompt}")
    fields = [
        f"Steps: {payload.steps}",
        f"Sampler: {payload.sampler_name}",
        f"CFG scale: {payload.cfg_scale}",
        f"Seed: {seed}",
        f"Size: {width or payload.width}x{height or payload.height}",
    ]
    if model_name:
        fields.append(f"Model: {model_name}")
    if payload.subseed_strength > 0:
        fields.append(f"Variation seed: {subseed}")
        fields.append(f"Variation seed strength: {payload.subseed_strength}")
    if payload.seed_resize_from_w > 0 and payload.seed_resize_from_h > 0:
        fields.append(f"Seed resize from: "
                      f"{payload.seed_resize_from_w}x"
                      f"{payload.seed_resize_from_h}")
    ensd = (payload.override_settings or {}).get("eta_noise_seed_delta", 0)
    if ensd:
        fields.append(f"ENSD: {ensd}")
    if payload.denoising_strength != 0.75 and (
        payload.init_images or payload.enable_hr
    ):
        fields.append(f"Denoising strength: {payload.denoising_strength}")
    lines.append(", ".join(fields))
    return "\n".join(lines)
