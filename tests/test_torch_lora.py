"""LoRA's merged path in the port against the JAX package, on the CPU.

- The port's safetensors reader gives ``safetensors.numpy.load_file``'s
  arrays exactly (F16 upcast to f32, as the JAX loader does) and refuses
  BF16 with a clear error.
- A full-coverage kohya adapter (every resolvable UNet and text-encoder
  module, plus a 1x1-conv proj_in, a 3x3 LoCon, an unknown module and a
  factor of the wrong width) resolves onto the same weights with the same
  ``(applied, skipped)`` counts as the JAX ``merge_lora`` on TINY, TINY_XL,
  SD1.5 and SDXL. The full-width configs need no weights: the port merges
  meta tensors, and the JAX merge runs on stand-in kernels that carry only
  a shape.
- ``merge_lora`` gives ``bridge.flax_to_torch`` of the JAX merge within
  1e-6, fused q/k/v row blocks, te1/te2 and a dual weight included.
- Engine requests with ``<lora:...>`` tags give the JAX engine's seeds and
  infotext and pixels within 1 uint8 level: one tag, three stacked tags, a
  dual-weight tag on TINY_XL, a missing name (skipped and logged). The
  merge latch: an identical repeat merges nothing; a provider generation
  bump retries; a tagless request after a LoRA request gives the bytes of
  an engine that never merged.
"""

import logging

import numpy as np
import pytest
import torch

import jax

from stable_diffusion_webui_distributed_tpu.models import lora as jlora
from stable_diffusion_webui_distributed_tpu.models.configs import (
    FAMILIES as JFAMILIES,
)
from stable_diffusion_webui_distributed_tpu.models.configs import TINY as JTINY
from stable_diffusion_webui_distributed_tpu.models.configs import (
    TINY_XL as JTINY_XL,
)
from stable_diffusion_webui_distributed_tpu.pipeline.engine import (
    Engine as JaxEngine,
)
from stable_diffusion_webui_distributed_tpu.pipeline.payload import (
    GenerationPayload as JaxPayload,
)
from stable_diffusion_webui_distributed_tpu.runtime.interrupt import (
    GenerationState as JaxState,
)
from stable_diffusion_webui_distributed_tpu_torch import bridge
from stable_diffusion_webui_distributed_tpu_torch.bridge import build_modules
from stable_diffusion_webui_distributed_tpu_torch.models import lora
from stable_diffusion_webui_distributed_tpu_torch.models.configs import (
    FAMILIES,
    TINY,
    TINY_XL,
)
from stable_diffusion_webui_distributed_tpu_torch.models.safetensors_io import (
    load_safetensors,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline.engine import Engine
from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    GenerationPayload,
    b64png_to_array,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.interrupt import (
    GenerationState,
)
from test_pipeline import init_params

# --------------------------------------------------------------------------
# adapters in kohya's layout, built from a config in ldm's block numbering
# --------------------------------------------------------------------------


def ldm_attention_blocks(cfg):
    """``[(kohya block name, channels, depth)]`` of a UNet config, in
    ldm's numbering (input blocks from 1, a downsample block after each
    level but the last; output blocks from 0)."""
    levels = list(zip(cfg.block_out_channels, cfg.down_blocks))
    out, n = [], 1
    for level, (ch, depth) in enumerate(levels):
        for _ in range(cfg.layers_per_block):
            if depth is not None:
                out.append((f"input_blocks_{n}_1", ch, depth))
            n += 1
        n += level < len(levels) - 1
    if cfg.mid_block_depth is not None:
        out.append(("middle_block_1", levels[-1][0], cfg.mid_block_depth))
    n = 0
    for level in reversed(range(len(levels))):
        ch, depth = levels[level]
        for _ in range(cfg.layers_per_block + 1):
            if depth is not None:
                out.append((f"output_blocks_{n}_1", ch, depth))
            n += 1
    return out


def adapter_modules(family):
    """Every module a kohya adapter for ``family`` can carry, as
    ``(module key, in_dim, out_dim)``."""
    cfg = family.unet
    ctx = cfg.cross_attention_dim
    mods = []
    for block, c, depth in ldm_attention_blocks(cfg):
        base = f"lora_unet_{block}_"
        mods += [(base + "proj_in", c, c), (base + "proj_out", c, c)]
        for j in range(depth):
            t = f"{base}transformer_blocks_{j}_"
            mods += [(t + f"attn1_to_{x}", c, c) for x in ("q", "k", "v")]
            mods += [(t + "attn1_to_out_0", c, c), (t + "attn2_to_q", c, c),
                     (t + "attn2_to_k", ctx, c), (t + "attn2_to_v", ctx, c),
                     (t + "attn2_to_out_0", c, c),
                     (t + "ff_net_0_proj", c, 8 * c),
                     (t + "ff_net_2", 4 * c, c)]
    encoders = [("lora_te", family.text_encoder)]
    if family.text_encoder_2 is not None:
        encoders = [("lora_te1", family.text_encoder),
                    ("lora_te2", family.text_encoder_2)]
    for prefix, te in encoders:
        h, i_dim = te.hidden_size, te.intermediate_size
        for layer in range(te.num_layers):
            t = f"{prefix}_text_model_encoder_layers_{layer}_"
            mods += [(t + f"self_attn_{x}_proj", h, h)
                     for x in ("q", "k", "v", "out")]
            mods += [(t + "mlp_fc1", h, i_dim), (t + "mlp_fc2", i_dim, h)]
    return mods


def make_adapter(family, rank=4, seed=0, scale=0.3, extras=False,
                 only=None):
    """A kohya state dict with a (rank, in) ``lora_down`` and an (out, rank)
    ``lora_up`` per module, alpha = rank; ``only`` keeps the modules whose
    key contains one of its strings. ``extras`` adds a 1x1-conv form of
    the first proj_in, a 3x3 LoCon, an unknown module and a k projection
    of the wrong width."""
    rng = np.random.default_rng(seed)
    sd = {}
    for module, i_dim, o_dim in adapter_modules(family):
        if only is not None and not any(s in module for s in only):
            continue
        sd[f"{module}.lora_down.weight"] = (
            rng.standard_normal((rank, i_dim)) * scale).astype(np.float32)
        sd[f"{module}.lora_up.weight"] = (
            rng.standard_normal((o_dim, rank)) * scale).astype(np.float32)
        sd[f"{module}.alpha"] = np.asarray(rank, np.float32)
    if extras:
        block, c, _ = ldm_attention_blocks(family.unet)[0]
        conv = f"lora_unet_{block}_proj_in"
        sd[f"{conv}.lora_down.weight"] = sd[f"{conv}.lora_down.weight"][
            :, :, None, None]
        sd[f"{conv}.lora_up.weight"] = sd[f"{conv}.lora_up.weight"][
            :, :, None, None]
        locon = "lora_unet_input_blocks_1_0_in_layers_2"
        sd[f"{locon}.lora_down.weight"] = rng.standard_normal(
            (rank, 4, 3, 3)).astype(np.float32)
        sd[f"{locon}.lora_up.weight"] = rng.standard_normal(
            (c, rank, 1, 1)).astype(np.float32)
        sd["lora_unet_time_embed_0.lora_down.weight"] = np.ones(
            (rank, c), np.float32)
        sd["lora_unet_time_embed_0.lora_up.weight"] = np.ones(
            (c, rank), np.float32)
        wrong = f"lora_unet_{block}_transformer_blocks_0_attn2_to_k"
        sd[f"{wrong}.lora_down.weight"] = np.ones(
            (rank, family.unet.cross_attention_dim + 1), np.float32)
    return sd


def pixels(b64):
    return b64png_to_array(b64).astype(np.int32)


def assert_images_match(got, want, levels=1):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        pa, pb = pixels(a), pixels(b)
        assert pa.shape == pb.shape
        assert np.abs(pa - pb).max() <= levels
        assert pa.std() > 1.0


# --------------------------------------------------------------------------
# the reader
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float16, np.int64,
                                   np.uint8])
def test_reader_matches_safetensors(tmp_path, dtype):
    from safetensors.numpy import load_file, save_file

    rng = np.random.default_rng(1)
    tensors = {"a.lora_down.weight": (rng.standard_normal((4, 7)) * 100)
               .astype(dtype),
               "b": (rng.standard_normal((2, 3, 1, 1)) * 100).astype(dtype),
               "alpha": np.asarray(3, dtype)}
    path = str(tmp_path / "x.safetensors")
    save_file(tensors, path, metadata={"ss_network_dim": "4"})
    want = load_file(path)
    got = load_safetensors(path)
    assert set(got) == set(want)
    for k, v in want.items():
        v = v.astype(np.float32) if v.dtype == np.float16 else v
        assert got[k].dtype == v.dtype and got[k].shape == v.shape
        np.testing.assert_array_equal(got[k], v)
        assert got[k].flags.writeable


def test_reader_refuses_bf16(tmp_path):
    import json
    import struct

    header = json.dumps({"w": {"dtype": "BF16", "shape": [2],
                               "data_offsets": [0, 4]}}).encode()
    path = tmp_path / "bf16.safetensors"
    path.write_bytes(struct.pack("<Q", len(header)) + header + b"\0" * 4)
    with pytest.raises(ValueError, match="BF16"):
        load_safetensors(str(path))


# --------------------------------------------------------------------------
# key resolution and counts
# --------------------------------------------------------------------------


class _ShapeKernel:
    """A kernel with only a shape, for the JAX merge's own logic on a
    full-width config: ``+`` and ``.at[...].add`` give a new one."""

    def __init__(self, shape, dtype):
        self.shape, self.dtype = tuple(shape), dtype

    @property
    def at(self):
        return self

    def __getitem__(self, _):
        return self

    def add(self, _):
        return _ShapeKernel(self.shape, self.dtype)

    __add__ = add


def _jax_merge_shapes(family, sd, weight, te_weight):
    """(touched Flax paths, applied, skipped) of the JAX merge on
    shape-only kernels."""
    shapes = jax.eval_shape(lambda: init_params(family))
    params = jax.tree_util.tree_map(
        lambda s: _ShapeKernel(s.shape, s.dtype), shapes)
    merged, applied, skipped = jlora.merge_lora(params, sd, weight, family,
                                                te_weight=te_weight)
    touched = set()

    def walk(a, b, path):
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k], path + (k,))
        elif a is not b:
            touched.add(path)

    walk(params, merged, ())
    return touched, applied, skipped


def _port_key(path):
    """A touched Flax path (``(component, ..., "kernel")``) as the port's
    ``(component, state-dict key)``."""
    assert path[-1] == "kernel"
    return path[0], ".".join(path[1:-1]) + ".weight"


@pytest.mark.parametrize("name", ["tiny", "tiny-xl", "sd15", "sdxl-base"])
def test_counts_and_resolution_match_jax(name):
    family, jfamily = FAMILIES[name], JFAMILIES[name]
    sd = make_adapter(family, rank=2, extras=True)
    touched, applied, skipped = _jax_merge_shapes(jfamily, sd, 0.8, 0.5)
    with torch.device("meta"):
        modules = build_modules(family)
    leaves = {c: dict(m.named_parameters()) for c, m in modules.items()
              if c in ("unet", "text_encoder", "text_encoder_2")}
    merged, p_applied, p_skipped = lora.merge_lora(leaves, sd, 0.8, family,
                                                   te_weight=0.5)
    assert (p_applied, p_skipped) == (applied, skipped)
    # every regular module applies but the k given the wrong width; it,
    # the LoCon and the unknown module are skipped (the 1x1-conv proj_in
    # applies)
    assert applied == len(adapter_modules(family)) - 1
    assert skipped == 3
    port_touched = {(c, k) for c, sd_ in merged.items()
                    for k, v in sd_.items() if v is not leaves[c][k]}
    assert port_touched == {_port_key(p) for p in touched}


def test_fused_slots_are_row_blocks(params):
    """q, k and v of a fused projection land in the weight's row blocks
    0, 1 and 2 (the JAX package's column blocks of its (in, out)
    kernel)."""
    params = bridge.flax_to_torch(TINY, params)
    key = "down_0_attn_0.block_0.attn1.qkv.weight"
    base = params["unet"][key]
    c = base.shape[1]
    for idx, x in enumerate(("q", "k", "v")):
        sd = make_adapter(TINY, seed=idx,
                          only=[f"input_blocks_1_1_transformer_blocks_0_"
                                f"attn1_to_{x}"])
        merged, applied, _ = lora.merge_lora(params, sd, 1.0, TINY)
        assert applied == 1
        diff = (merged["unet"][key] - base).abs().sum(dim=1)
        rows = torch.arange(3 * c) // c
        assert bool((diff[rows == idx] > 0).all())
        assert bool((diff[rows != idx] == 0).all())


# --------------------------------------------------------------------------
# merge_lora against the JAX merge
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["tiny", "tiny-xl"])
def test_merge_matches_jax(name):
    family, jfamily = FAMILIES[name], JFAMILIES[name]
    jparams = jax.jit(init_params, static_argnums=0)(jfamily)
    sd = make_adapter(family, rank=4, seed=3)
    jmerged, j_applied, j_skipped = jlora.merge_lora(jparams, sd, 0.7,
                                                     jfamily, te_weight=0.4)
    want = bridge.flax_to_torch(family, jax.device_get(jmerged))
    params = bridge.flax_to_torch(family, jax.device_get(jparams))
    got, applied, skipped = lora.merge_lora(params, sd, 0.7, family,
                                            te_weight=0.4)
    assert (applied, skipped) == (j_applied, j_skipped) == (
        len(adapter_modules(family)), 0)
    new = {(c, k) for c in got for k, t in got[c].items()
           if t is not params[c][k]}
    moved = {(c, k) for c in want for k, t in want[c].items()
             if not torch.equal(t, params[c][k])}
    assert new == moved and new
    for comp in got:
        for key, t in got[comp].items():
            assert (t - want[comp][key]).abs().max().item() <= 1e-6, key


def test_merge_leaf_rounds_once_in_f32():
    """On bf16 weights the adapters add in f32 and the sum rounds once."""
    torch.manual_seed(0)
    base = torch.randn(6, 5).bfloat16()
    rng = np.random.default_rng(0)
    p = [lora.Patch("unet", "w", None,
                    rng.standard_normal((6, 2)).astype(np.float32),
                    rng.standard_normal((2, 5)).astype(np.float32), 0.5)
         for _ in range(3)]
    got = lora.merge_leaf(base, [(q, 0.3) for q in p])
    want = base.float()
    for q in p:
        want = want + torch.from_numpy(q.up @ q.down) * 0.5 * 0.3
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.bfloat16())
    zero = lora.merge_leaf(base, [(q, 0.0) for q in p])
    assert torch.equal(zero, base)


# --------------------------------------------------------------------------
# engine requests against the JAX engine
# --------------------------------------------------------------------------

ADAPTERS = {f"a{i}": make_adapter(TINY, rank=4, seed=10 + i, scale=0.3)
            for i in range(3)}
REQUEST = dict(prompt="a cow", negative_prompt="blurry", steps=3, width=32,
               height=32, batch_size=2, seed=11)
PROMPTS = {
    "one": "a cow <lora:a0:0.8>",
    "stacked": "<lora:a0:0.8> a cow <lora:a1:0.5>  <lora:a2:1>",
    "missing": "a cow <lora:nope:1> <lora:a1:0.6>",
}


@pytest.fixture(scope="module")
def jparams():
    # device arrays: the JAX merge updates kernels with ``.at``
    return jax.jit(init_params, static_argnums=0)(JTINY)


@pytest.fixture(scope="module")
def params(jparams):
    return jax.device_get(jparams)


@pytest.fixture(scope="module")
def jax_engine(jparams):
    return JaxEngine(JTINY, jparams, state=JaxState(),
                     lora_provider=ADAPTERS.get)


def port_engine(params, provider=ADAPTERS.get):
    return Engine(TINY, bridge.flax_to_torch(TINY, params), chunk_size=2,
                  state=GenerationState(), device="cpu",
                  lora_provider=provider)


@pytest.fixture(scope="module")
def port(params):
    return port_engine(params)


@pytest.fixture(scope="module")
def tagless(port):
    return port.txt2img(GenerationPayload(**REQUEST))


@pytest.mark.parametrize("kind", sorted(PROMPTS))
def test_lora_requests_match_jax(jax_engine, port, kind, caplog):
    body = {**REQUEST, "prompt": PROMPTS[kind]}
    want = jax_engine.txt2img(JaxPayload(**body))
    with caplog.at_level(logging.WARNING):
        got = port.txt2img(GenerationPayload(**body))
    assert got.seeds == want.seeds
    assert got.infotexts == want.infotexts
    assert PROMPTS[kind] in got.infotexts[0]  # the tags stay in the infotext
    assert_images_match(got.images, want.images)
    assert ("lora 'nope' not found" in caplog.text) == (kind == "missing")


def test_lora_changes_the_image(port, tagless):
    got = port.txt2img(GenerationPayload(**{**REQUEST,
                                            "prompt": PROMPTS["one"]}))
    assert got.images != tagless.images
    assert port.last_lora_counts[0] > 0


def test_dual_weight_tag_matches_jax_on_tiny_xl():
    """``<lora:n:w:te_w>``: te_w scales both of SDXL's text encoders."""
    jparams = jax.jit(init_params, static_argnums=0)(JTINY_XL)
    sd = {"x": make_adapter(TINY_XL, rank=4, seed=5)}
    jeng = JaxEngine(JTINY_XL, jparams, state=JaxState(),
                     lora_provider=sd.get)
    peng = Engine(TINY_XL, bridge.flax_to_torch(TINY_XL,
                                                jax.device_get(jparams)),
                  state=GenerationState(), device="cpu",
                  lora_provider=sd.get)
    body = {**REQUEST, "batch_size": 1, "prompt": "a cow <lora:x:0.9:0.3>"}
    want = jeng.txt2img(JaxPayload(**body))
    got = peng.txt2img(GenerationPayload(**body))
    assert got.infotexts == want.infotexts
    assert_images_match(got.images, want.images)
    applied, skipped = peng.last_lora_counts
    assert skipped == 0 and applied == len(adapter_modules(TINY_XL))


class _Provider:
    """A registry stand-in: counts lookups and carries the generation the
    engine's latch keys on."""

    def __init__(self, loras):
        self.loras = dict(loras)
        self.lora_generation = 0
        self.calls = 0

    def provider(self, name):
        self.calls += 1
        return self.loras.get(name)


def test_identical_repeat_merges_nothing(params):
    src = _Provider({"good": ADAPTERS["a0"]})
    eng = port_engine(params, src.provider)
    specs = (("good", 1.0, 1.0), ("nope", 1.0, 1.0))
    eng.set_loras(specs)
    assert eng._lora_merge_total == 1
    calls = src.calls
    weights = {k: v.clone() for k, v in eng.unet.state_dict().items()}
    eng.set_loras(specs)
    assert eng._lora_merge_total == 1 and src.calls == calls
    for k, v in eng.unet.state_dict().items():
        assert torch.equal(v, weights[k])


def test_generation_bump_retries(params):
    src = _Provider({"good": ADAPTERS["a0"]})
    eng = port_engine(params, src.provider)
    specs = (("good", 1.0, 1.0), ("late", 1.0, 1.0))
    eng.set_loras(specs)
    assert eng._lora_merge_total == 1
    src.loras["late"] = ADAPTERS["a1"]
    eng.set_loras(specs)  # same generation: still latched
    assert eng._lora_merge_total == 1
    src.lora_generation += 1
    eng.set_loras(specs)  # the rescan: both resolve now
    assert eng._lora_merge_total == 3


def test_tagless_after_lora_gives_a_fresh_engines_bytes(params, port,
                                                        tagless):
    port.txt2img(GenerationPayload(**{**REQUEST,
                                      "prompt": PROMPTS["stacked"]}))
    assert port._pristine
    again = port.txt2img(GenerationPayload(**REQUEST))
    assert not port._pristine
    assert again.images == tagless.images
    fresh = port_engine(params).txt2img(GenerationPayload(**REQUEST))
    assert fresh.images == tagless.images
    for k, v in port.unet.state_dict().items():
        assert torch.equal(v, bridge.flax_to_torch(TINY, params)["unet"][k])


def test_weight_zero_gives_the_tagless_bytes(port, tagless):
    body = {**REQUEST, "prompt": "a cow <lora:a0:0> <lora:a1:0>"}
    got = port.txt2img(GenerationPayload(**body))
    assert got.images == tagless.images
    assert got.infotexts != tagless.infotexts


def test_context_chunks_ignore_the_tags(port):
    tags = " ".join(f"<lora:a{i % 3}:0.{i}>" for i in range(40))
    p = GenerationPayload(**{**REQUEST, "prompt": f"a cow {tags}"})
    assert port.request_context_chunks(p) == 1
