"""The text encoders and both halves of the VAE placed over ``tp``, against
the meshless modules and the JAX package's, on the CPU.

Each module is placed with ``unet.place_layers`` on a virtual ``tp=2`` and
``tp=4`` mesh of ``cpu`` entries (JAX's rule: CLIP's ``qkv``, ``fc1`` and
``text_projection`` and every VAE convolution split by output features,
``out_proj`` and ``fc2`` by input features):

- CLIP-L (TINY's ``text_encoder``) and CLIP-G with its projection
  (TINY_XL's ``text_encoder_2``) at clip skip 1 and 2 (the model's
  ``skip`` 0 and 1), with a textual-inversion injection, and with a traced
  adapter's text-encoder sites: the context and the pooled output within
  1e-5 of the meshless module (1e-6 with the adapter, whose sites add
  ``apply_site``'s delta to the gathered output on the home device), and
  within 2e-5 of the JAX module's ``apply`` on the same parameters (the
  tolerance of ``tests/test_torch_models.py``);
- the decoder (TINY, and TINY_XL's f32 decoder) within 1e-5 of meshless
  and 2e-5 of JAX ``VAE.decode``; the encoder's latent mean within 1e-5
  of meshless and within 1e-5 of JAX ``VAE.encode``'s largest value (the
  tolerance of ``tests/test_torch_controlnet.py``);
- the encoder's ``AsymmetricDownsample`` pads and then convolves at padding
  0 and stride 2: its column shards see the padded input;
- a virtual mesh copies no weight (every shard's ``data_ptr`` lies inside
  its weight's storage), and ``place_layers(module, None)`` leaves no
  placement;
- the stage pipeline's refiner engine places its CLIP-G on its own mesh,
  and the pipelined images are the meshless sequential ones within 1
  uint8 level (port only, on ``bridge.init_seeded`` weights).

The parameter trees' shapes come from ``jax.eval_shape`` and their values
from a seeded numpy stream; no JAX engine is compiled. The engine-level
checks against JAX are in ``tests/test_torch_parallel_xl.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stable_diffusion_webui_distributed_tpu.models.clip import (
    CLIPTextModel as JaxCLIP,
)
from stable_diffusion_webui_distributed_tpu.models.configs import (
    TINY as JTINY,
)
from stable_diffusion_webui_distributed_tpu.models.configs import (
    TINY_XL as JTINY_XL,
)
from stable_diffusion_webui_distributed_tpu.models.vae import VAE as JaxVAE
from stable_diffusion_webui_distributed_tpu_torch import bridge
from stable_diffusion_webui_distributed_tpu_torch.models import lora
from stable_diffusion_webui_distributed_tpu_torch.models import unet as unet_mod
from stable_diffusion_webui_distributed_tpu_torch.models.configs import (
    TINY,
    TINY_REFINER,
    TINY_XL,
)
from stable_diffusion_webui_distributed_tpu_torch.models.vae import encode
from stable_diffusion_webui_distributed_tpu_torch.parallel import sharding
from stable_diffusion_webui_distributed_tpu_torch.parallel.stage_pipeline import (
    pipelined_txt2img,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline.engine import Engine
from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    GenerationPayload,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.interrupt import (
    GenerationState,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.mesh import (
    build_mesh,
)
from test_torch_lora import make_adapter
from test_torch_parallel import assert_within_one, cpus, seeded

MESHLESS = 1e-5  # f32, a placed module against itself meshless
TRACED = 1e-6  # a traced site against apply_site meshless
JAX_ATOL = 2e-5  # tests/test_torch_models.py
JAX_RTOL = 1e-5  # tests/test_torch_controlnet.py, of the largest value
RNG = np.random.default_rng(24)
FAMILIES = {"tiny": (JTINY, TINY), "tiny-xl": (JTINY_XL, TINY_XL)}
#: (family, component) of each text encoder: CLIP-L, CLIP-G projected
ENCODERS = {"clip-l": ("tiny", "text_encoder"),
            "clip-g": ("tiny-xl", "text_encoder_2")}


@pytest.fixture(scope="module")
def trees():
    """Each family's Flax tree (seeded values on ``eval_shape`` shapes)
    and the port's modules loaded from it, in f32."""
    out = {}
    for name, (jfam, fam) in FAMILIES.items():
        tree = seeded(jfam, {"tiny": 30, "tiny-xl": 31}[name])
        sds = bridge.flax_to_torch(fam, tree)
        mods = bridge.build_modules(fam)
        for comp, module in mods.items():
            module.load_state_dict(sds[comp], strict=True)
            module.eval()
        out[name] = (tree, sds, mods)
    return out


def layout(tp):
    return sharding.replica_layout(build_mesh(f"tp={tp}", ["cpu"] * tp), 0)


def placements(module):
    """Each placed layer with its placement."""
    return [(m, m.tp) for m in module.modules()
            if isinstance(m, (unet_mod.Dense, unet_mod.Conv))
            and m.tp is not None]


def run_placed(module, tp, fn):
    """``fn()`` with ``module`` placed on a virtual ``tp`` mesh; the
    placement is removed after."""
    unet_mod.place_layers(module, layout(tp))
    try:
        assert placements(module)
        return fn()
    finally:
        unet_mod.place_layers(module, None)


def close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def ids_for(cfg, batch=2):
    ids = RNG.integers(0, cfg.vocab_size - 1, (batch, 77))
    ids[:, 20:] = cfg.vocab_size - 1  # EOS (the largest id) and padding
    return ids


# -- the text encoders -----------------------------------------------------------

@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("skip", [0, 1])
@pytest.mark.parametrize("encoder", list(ENCODERS))
def test_placed_text_encoder_matches_meshless_and_jax(trees, encoder, skip,
                                                      tp):
    family, comp = ENCODERS[encoder]
    tree, _, mods = trees[family]
    clip = mods[comp]
    cfg = clip.cfg
    ids = ids_for(cfg)
    with torch.no_grad():
        want = clip(torch.from_numpy(ids), skip=skip)
        got = run_placed(clip, tp, lambda: clip(torch.from_numpy(ids),
                                                skip=skip))
    jctx, jpooled = JaxCLIP(getattr(FAMILIES[family][0], comp)).apply(
        {"params": tree[comp]}, jnp.asarray(ids, jnp.int32), skip=skip)
    assert got[1].shape == (2, cfg.projection_dim or cfg.hidden_size)
    for g, w, j in zip(got, want, (jctx, jpooled)):
        close(g, w, MESHLESS)
        close(g, j, JAX_ATOL)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("encoder", list(ENCODERS))
def test_placed_text_encoder_takes_the_injection(trees, encoder, tp):
    """Textual inversion replaces token rows before the position
    embedding, which stays replicated: the placed encoder gives the
    meshless context and JAX's."""
    family, comp = ENCODERS[encoder]
    tree, _, mods = trees[family]
    clip = mods[comp]
    cfg = clip.cfg
    ids = ids_for(cfg)
    mask = np.zeros((2, 77, 1), np.float32)
    mask[:, 3:6] = 1.0
    values = (RNG.standard_normal((2, 77, cfg.hidden_size)) * 0.5).astype(
        np.float32)
    args = dict(inject_values=torch.from_numpy(values),
                inject_mask=torch.from_numpy(mask))
    with torch.no_grad():
        plain = clip(torch.from_numpy(ids))
        want = clip(torch.from_numpy(ids), **args)
        got = run_placed(clip, tp, lambda: clip(torch.from_numpy(ids),
                                                **args))
    jgot = JaxCLIP(getattr(FAMILIES[family][0], comp)).apply(
        {"params": tree[comp]}, jnp.asarray(ids, jnp.int32),
        inject_values=jnp.asarray(values), inject_mask=jnp.asarray(mask))
    assert not torch.allclose(want[0], plain[0])  # the rows were replaced
    for g, w, j in zip(got, want, jgot):
        close(g, w, MESHLESS)
        close(g, j, JAX_ATOL)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("encoder", list(ENCODERS))
def test_placed_text_encoder_adds_traced_sites(trees, encoder, tp):
    """A traced adapter's text-encoder sites add their delta to the placed
    layer's gathered (or summed) output on the home device, as
    ``apply_site`` adds it meshless."""
    family, comp = ENCODERS[encoder]
    _, sds, mods = trees[family]
    fam = FAMILIES[family][1]
    adapter = make_adapter(fam, rank=4, seed=7)
    ts = lora.build_traced_set((("a", 0.8, 0.9),), {"a": adapter}.get, fam,
                               sds)
    site = ts.tree[comp]
    assert ts.te_content and site
    clip = mods[comp]
    ids = ids_for(clip.cfg)
    with torch.no_grad():
        plain = clip(torch.from_numpy(ids))
        want = clip(torch.from_numpy(ids), lora=site)
        got = run_placed(clip, tp, lambda: clip(torch.from_numpy(ids),
                                                lora=site))
    assert (want[0] - plain[0]).abs().max() > 1e-3  # the sites took part
    for g, w in zip(got, want):
        close(g, w, TRACED)


# -- the VAE ---------------------------------------------------------------------

@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_placed_decoder_matches_meshless_and_jax(trees, family, tp):
    tree, _, mods = trees[family]
    vae = mods["vae"]
    assert vae.conv_in.weight.dtype == torch.float32
    lat = RNG.standard_normal((2, 8, 8, 4)).astype(np.float32)
    with torch.no_grad():
        want = vae(torch.from_numpy(lat))
        got = run_placed(vae, tp, lambda: vae(torch.from_numpy(lat)))
    jwant = JaxVAE(FAMILIES[family][0].vae).apply(
        {"params": tree["vae"]}, jnp.asarray(lat), method=JaxVAE.decode)
    assert got.shape == (2, 16, 16, 3)
    close(got, want, MESHLESS)
    close(got, jwant, JAX_ATOL)


@pytest.mark.parametrize("tp", [2, 4])
def test_placed_encoder_matches_meshless_and_jax(trees, tp):
    tree, _, mods = trees["tiny"]
    enc = mods["vae_encoder"]
    img = RNG.uniform(-1, 1, (2, 24, 24, 3)).astype(np.float32)
    with torch.no_grad():
        want = encode(enc, torch.from_numpy(img))
        got = run_placed(enc, tp, lambda: encode(enc, torch.from_numpy(img)))
    jmean, _ = JaxVAE(JTINY.vae).apply(
        {"params": tree["vae"]}, jnp.asarray(img), method=JaxVAE.encode)
    assert got[0].shape == (2, 12, 12, 4)
    for g, w in zip(got, want):
        close(g, w, MESHLESS)
    scale = float(np.abs(np.asarray(jmean)).max())
    close(got[0], jmean, JAX_RTOL * scale)


@pytest.mark.parametrize("tp", [2, 4])
def test_asymmetric_downsample_shards_see_the_padded_input(trees, tp):
    """``AsymmetricDownsample`` pads one row and one column, then calls
    ``Conv.forward`` at padding 0: its ``_Column`` keeps stride 2 and
    padding 0 and convolves the padded input on each shard."""
    ds = trees["tiny"][2]["vae_encoder"].down_0_ds
    x = torch.from_numpy(RNG.standard_normal((2, 32, 9, 7)).astype(
        np.float32))
    with torch.no_grad():
        want = ds(x)

        def placed():
            plan = ds.tp
            assert isinstance(plan, unet_mod._Column) and plan.layer_conv
            assert plan.stride == (2, 2) and plan.padding == (0, 0)
            assert [w.shape[0] for w in plan.weights] == [32 // tp] * tp
            return ds(x)

        got = run_placed(ds, tp, placed)
    assert got.shape == want.shape == (2, 32, 4, 3)  # 10x8 padded
    close(got, want, MESHLESS)


# -- no copy, and unplaced -------------------------------------------------------

def inside(t, owner):
    """Whether ``t``'s memory lies inside ``owner``'s storage."""
    base = owner.untyped_storage().data_ptr()
    end = base + owner.untyped_storage().nbytes()
    return base <= t.data_ptr() and \
        t.data_ptr() + t.numel() * t.element_size() <= end


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("family,comp", [
    ("tiny", "text_encoder"), ("tiny-xl", "text_encoder_2"),
    ("tiny", "vae"), ("tiny-xl", "vae"), ("tiny", "vae_encoder")])
def test_a_virtual_mesh_copies_no_weight_and_unplaces(trees, family, comp,
                                                      tp):
    module = trees[family][2][comp]
    unet_mod.place_layers(module, layout(tp))
    placed = placements(module)
    kinds = {type(p).__name__ for _, p in placed}
    assert kinds == {"_Column", "_Row"}  # out_proj (and fc2) by rows
    for layer, plan in placed:
        assert len(plan.weights) == tp
        for w in plan.weights:
            assert inside(w, layer.weight), layer
        for b in getattr(plan, "biases", []):
            assert b is None or inside(b, layer.bias), layer
    unet_mod.place_layers(module, None)
    assert all(getattr(m, "tp", None) is None for m in module.modules())


# -- the stage pipeline's refiner --------------------------------------------------

def test_stage_pipeline_refiner_places_its_clip_on_its_mesh():
    """The refiner is an engine of its own: its mesh places its CLIP-G
    (and its VAE), whatever the base's mesh does."""
    body = dict(prompt="staged cow", steps=4, width=32, height=32, seed=25,
                batch_size=2, refiner_checkpoint="tiny-ref",
                refiner_switch_at=0.5)

    def pair(base_mesh=None, ref_mesh=None):
        def where(mesh):
            return {"device": "cpu"} if mesh is None else {"mesh": mesh}

        ref = Engine(TINY_REFINER, bridge.init_seeded(TINY_REFINER, seed=44,
                                                      device="cpu"),
                     chunk_size=4, state=GenerationState(),
                     model_name="tiny-ref", **where(ref_mesh))
        base = Engine(TINY_XL, bridge.init_seeded(TINY_XL, seed=43,
                                                  device="cpu"),
                      chunk_size=4, state=GenerationState(),
                      engine_provider=lambda n: ref if n == "tiny-ref"
                      else None, **where(base_mesh))
        return base, ref

    base, ref = pair(build_mesh("dp=2", cpus(2)),
                     build_mesh("tp=2", cpus(2)))
    # dp=2 splits no layer; the refiner's tp=2 splits its CLIP-G and VAE
    assert not placements(base.text_encoder_2)
    for module in (ref.text_encoder, ref.vae, ref.vae_encoder):
        assert {type(p).__name__ for _, p in placements(module)} == \
            {"_Column", "_Row"}
    got = pipelined_txt2img(base, ref, GenerationPayload(**body))
    want = pair()[0].txt2img(GenerationPayload(**body))
    assert len(got.images) == 2
    assert_within_one(got, want)
