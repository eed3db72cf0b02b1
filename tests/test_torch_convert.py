"""The port's ldm converter against the JAX package's, exactly.

Synthetic ldm checkpoints (``tests/test_models.py``'s ``make_ldm_*``,
``tests/test_adapters.py``'s ``make_ldm_controlnet``) go through the JAX
package's ``convert_ldm`` / ``convert_controlnet`` / ``convert_vae`` and
``bridge.flax_to_torch``, and through the port's converter; the key sets
must be the same, every tensor ``torch.equal`` (tolerance 0), and the
result must load into the port's modules with ``strict=True``. Families:
TINY (HF CLIP), TINY_XL (HF + OpenCLIP, ``label_emb``), TINY_REFINER
(OpenCLIP at ``conditioner.embedders.0.model``), TINY_INPAINT (9-channel
``conv_in``) and the SD2.x layout (OpenCLIP at ``cond_stage_model.model``).
``detect_family`` must agree with the JAX package's on each.

Also: the mapped reader (no copy of an unfused tensor, a lying header
refused, F16 upcast by ``load_safetensors``), f16 ``.safetensors`` and
``.ckpt`` files against the f32 dict, ``MissingKeys`` with every absent
key, and ``tools/torch_ldm_writer.py``'s output read back by the JAX
package's converter.
"""

import dataclasses
import json
import os
import struct
import sys

import numpy as np
import pytest
import torch

from stable_diffusion_webui_distributed_tpu.models import convert as jconvert
from stable_diffusion_webui_distributed_tpu.models import configs as jconfigs
from stable_diffusion_webui_distributed_tpu.models.controlnet import (
    convert_controlnet as jax_convert_controlnet,
)
from stable_diffusion_webui_distributed_tpu_torch import bridge
from stable_diffusion_webui_distributed_tpu_torch.models import configs
from stable_diffusion_webui_distributed_tpu_torch.models import convert
from stable_diffusion_webui_distributed_tpu_torch.models.controlnet import (
    ControlNet,
    convert_controlnet,
)
from stable_diffusion_webui_distributed_tpu_torch.models.safetensors_io import (
    SafetensorsFile,
    load_safetensors,
)
from test_adapters import make_ldm_controlnet
from test_models import (
    _lin,
    make_ldm_clip_hf,
    make_ldm_clip_openai,
    make_ldm_unet,
    make_ldm_vae,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tools")]
import torch_ldm_writer  # noqa: E402
from chip_smoke import write_safetensors  # noqa: E402

FAMILIES = ("tiny", "tiny-xl", "tiny-refiner", "tiny-inpaint", "tiny-sd2")
# the SD2.x layout as tests/test_models.py's test_conversion_sd2_layout
# builds it: TINY with a gelu OpenCLIP encoder under cond_stage_model.model
_SD2 = dict(name="tiny-sd2", prediction_type="v_prediction")


def families(name):
    """(JAX family, port family) of ``name``."""
    if name != "tiny-sd2":
        return jconfigs.FAMILIES[name], configs.FAMILIES[name]
    pair = []
    for mod in (jconfigs, configs):
        te = dataclasses.replace(mod.TINY.text_encoder, hidden_act="gelu",
                                 default_skip=1)
        pair.append(mod.ModelFamily(text_encoder=te, unet=mod.TINY.unet,
                                    vae=mod.TINY.vae, **_SD2))
    return tuple(pair)


def make_ldm(name):
    """A synthetic ldm checkpoint of family ``name`` (f32 numpy)."""
    fam, _ = families(name)
    sd = {}
    if fam.text_encoder_2 is not None:
        sd.update(make_ldm_clip_hf(
            fam.text_encoder,
            prefix="conditioner.embedders.0.transformer.text_model"))
        sd.update(make_ldm_clip_openai(fam.text_encoder_2))
    elif name == "tiny-refiner":
        sd.update(make_ldm_clip_openai(
            fam.text_encoder, prefix="conditioner.embedders.0.model"))
    elif name == "tiny-sd2":
        sd.update(make_ldm_clip_openai(fam.text_encoder,
                                       prefix="cond_stage_model.model"))
    else:
        sd.update(make_ldm_clip_hf(fam.text_encoder))
    sd.update(make_ldm_unet(fam.unet))
    sd.update(make_ldm_vae(fam.vae))
    return sd


def torch_dict(sd):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def assert_same(got, want):
    assert set(got) == set(want), (sorted(set(got) ^ set(want))[:10])
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def load_strict(family, sds):
    with torch.device("meta"):
        modules = bridge.build_modules(family)
    assert set(modules) == set(sds)
    for name, module in modules.items():
        module.load_state_dict(sds[name], strict=True, assign=True)


@pytest.fixture(scope="module", params=FAMILIES)
def ldm(request):
    return request.param, make_ldm(request.param)


def test_convert_ldm_equals_jax(ldm):
    name, sd = ldm
    jfam, fam = families(name)
    want = bridge.flax_to_torch(fam, jconvert.convert_ldm(sd, jfam))
    got = convert.convert_ldm(torch_dict(sd), fam)
    assert set(got) == set(want)
    for comp in want:
        assert_same(got[comp], want[comp])
    load_strict(fam, got)


def test_detect_family_equals_jax(ldm):
    name, sd = ldm
    want = jconvert.detect_family(sd)
    assert convert.detect_family(torch_dict(sd)) == want
    expect = {"tiny": "sd15", "tiny-xl": "sdxl-base",
              "tiny-refiner": "sdxl-refiner", "tiny-inpaint": "sd15-inpaint",
              "tiny-sd2": "sd21"}[name]
    assert want == expect


def make_controlnet(name):
    """A synthetic ldm ControlNet for ``name``'s UNet; the SDXL one has
    ``label_emb``."""
    cfg = families(name)[0].unet
    sd = make_ldm_controlnet(cfg)
    if cfg.addition_embed_dim:
        tdim = 4 * cfg.block_out_channels[0]
        _lin(sd, "control_model.label_emb.0.0", tdim,
             cfg.projection_input_dim)
        _lin(sd, "control_model.label_emb.0.2", tdim, tdim)
    return sd


@pytest.mark.parametrize("name", ["tiny", "tiny-xl"])
def test_convert_controlnet_equals_jax(name):
    jfam, fam = families(name)
    sd = make_controlnet(name)
    want = bridge.controlnet_flax_to_torch(
        jax_convert_controlnet(sd, jfam.unet))
    got = convert_controlnet(torch_dict(sd), fam.unet)
    assert_same(got, want)
    with torch.device("meta"):
        module = ControlNet(fam.unet)
    module.load_state_dict(got, strict=True, assign=True)


def test_bare_vae_equals_jax():
    """A standalone VAE file (bare ``encoder.``/``decoder.`` keys), given
    the ``first_stage_model.`` prefix as the registries give it."""
    jfam, fam = families("tiny")
    bare = {k[len("first_stage_model."):]: v
            for k, v in make_ldm_vae(jfam.vae).items()}
    prefixed = {f"first_stage_model.{k}": v for k, v in bare.items()}
    jvae = jconvert.convert_vae(prefixed, jfam.vae)
    want = bridge.flax_to_torch(fam, {"text_encoder": {}, "unet": {},
                                      "vae": jvae})
    got = convert.convert_vae(torch_dict(prefixed), fam.vae)
    assert_same(got["decoder"], want["vae"])
    assert_same(got["encoder"], want["vae_encoder"])


def test_missing_keys_lists_every_absent_key():
    sd = torch_dict(make_ldm("tiny"))
    dropped = ["model.diffusion_model.input_blocks.1.1.transformer_blocks.0."
               "attn1.to_k.weight", "model.diffusion_model.out.2.bias"]
    for k in dropped:
        del sd[k]
    with pytest.raises(convert.MissingKeys) as err:
        convert.convert_ldm(sd, configs.TINY)
    assert sorted(err.value.missing) == sorted(dropped)
    assert all(k in str(err.value) for k in dropped)


@pytest.mark.parametrize("suffix", [".safetensors", ".ckpt"])
def test_files_equal_the_dict(tmp_path, suffix):
    """An f16 ``.safetensors`` file gives the f32 dict rounded through f16,
    in f16; a ``.ckpt`` (``state_dict`` nested, as webui's) the f32 dict;
    both through ``load_checkpoint`` as through ``convert_ldm``."""
    from safetensors.numpy import save_file

    sd = make_ldm("tiny")
    path = str(tmp_path / f"m{suffix}")
    if suffix == ".safetensors":
        save_file({k: v.astype(np.float16) for k, v in sd.items()}, path)
        ref = {k: v.half() for k, v in torch_dict(sd).items()}
    else:
        torch.save({"state_dict": torch_dict(sd), "global_step": 3}, path)
        ref = torch_dict(sd)
    got = convert.load_checkpoint(path, configs.TINY)
    want = convert.convert_ldm(ref, configs.TINY)
    for comp in want:
        assert_same(got[comp], want[comp])
    f32 = convert.convert_ldm(torch_dict(sd), configs.TINY)
    for comp in f32:
        for k, v in got[comp].items():
            want = f32[comp][k]
            if suffix == ".safetensors":
                want = want.half()
            assert torch.equal(v, want)


def test_mapped_reader_does_not_copy(tmp_path):
    """An unfused tensor of a converted ``.safetensors`` checkpoint is a
    view of the file's map: the same memory as the reader's tensor."""
    from safetensors.numpy import save_file

    path = str(tmp_path / "m.safetensors")
    save_file(make_ldm("tiny"), path)
    f = SafetensorsFile(path)
    got = convert.convert_ldm(f, configs.TINY)
    key = "model.diffusion_model.input_blocks.0.0.weight"
    assert got["unet"]["conv_in.weight"].data_ptr() == f[key].data_ptr()
    assert got["unet"]["conv_in.weight"].dtype == torch.float32


def test_reader_refuses_a_lying_header(tmp_path):
    header = json.dumps({"w": {"dtype": "F32", "shape": [4],
                               "data_offsets": [0, 8]}}).encode()
    path = tmp_path / "lie.safetensors"
    path.write_bytes(struct.pack("<Q", len(header)) + header + b"\0" * 16)
    with pytest.raises(ValueError, match="offsets"):
        SafetensorsFile(str(path))
    with pytest.raises(ValueError, match="offsets"):
        load_safetensors(str(path))
    path.write_bytes(struct.pack("<Q", 1 << 40) + header)
    with pytest.raises(ValueError, match="header length"):
        SafetensorsFile(str(path))


def test_load_safetensors_upcasts_f16(tmp_path):
    from safetensors.numpy import save_file

    path = str(tmp_path / "h.safetensors")
    w = np.arange(6, dtype=np.float16).reshape(2, 3)
    save_file({"w": w}, path)
    got = load_safetensors(path)["w"]
    assert got.dtype == np.float32 and got.flags.writeable
    np.testing.assert_array_equal(got, w.astype(np.float32))
    assert SafetensorsFile(path)["w"].dtype == torch.float16


@pytest.mark.parametrize("name", FAMILIES)
def test_ldm_writer_is_read_back_by_jax(name):
    """``tools/torch_ldm_writer.py``'s layout, converted by the JAX
    package and bridged, gives the port's state dicts back exactly."""
    jfam, fam = families(name)
    sds = bridge.init_seeded(fam, 3, device="cpu")
    ldm = torch_ldm_writer.to_ldm(fam, sds)
    assert jconvert.detect_family({k: v.numpy() for k, v in ldm.items()}) \
        == convert.detect_family(ldm)
    back = bridge.flax_to_torch(
        fam, jconvert.convert_ldm({k: v.numpy() for k, v in ldm.items()},
                                  jfam))
    assert set(back) == set(sds)
    for comp in sds:
        assert_same(back[comp], sds[comp])


def test_ldm_writer_vae_and_controlnet_round_trip(tmp_path):
    jfam, fam = families("tiny-xl")
    sds = bridge.init_seeded(fam, 4, device="cpu")
    bare = torch_ldm_writer.vae_to_ldm(fam, sds)
    assert all(k.split(".")[0] in ("encoder", "decoder", "quant_conv",
                                   "post_quant_conv") for k in bare)
    path = str(tmp_path / "vae.safetensors")
    write_safetensors(path, bare)
    jvae = jconvert.convert_vae(
        {f"first_stage_model.{k}": v
         for k, v in load_safetensors(path).items()}, jfam.vae)
    back = bridge.flax_to_torch(fam, {"text_encoder": {}, "unet": {},
                                      "text_encoder_2": {}, "vae": jvae})
    assert_same(back["vae"], sds["vae"])
    assert_same(back["vae_encoder"], sds["vae_encoder"])

    cn = bridge.init_seeded_controlnet(fam, 5, device="cpu")
    ldm = torch_ldm_writer.controlnet_to_ldm(fam.unet, cn)
    want = bridge.controlnet_flax_to_torch(jax_convert_controlnet(
        {k: v.numpy() for k, v in ldm.items()}, jfam.unet))
    assert_same(want, cn)


@pytest.mark.parametrize("dtype", ["F32", "F16"])
def test_chip_smoke_writer_reads_back(tmp_path, dtype):
    """``chip_smoke.write_safetensors`` (numpy arrays and torch tensors,
    0-d ones included) as the ``safetensors`` package and the port's
    reader read it."""
    from safetensors.numpy import load_file

    rng = np.random.default_rng(5)
    tensors = {"a": rng.standard_normal((3, 4)).astype(np.float32),
               "b": torch.from_numpy(rng.standard_normal((2, 1, 1, 5))
                                     .astype(np.float32)),
               "alpha": np.asarray(4.0, np.float32),
               "empty": np.zeros((0, 3), np.float32)}
    path = str(tmp_path / "w.safetensors")
    size = write_safetensors(path, tensors, dtype)
    assert size == os.path.getsize(path)
    np_dtype = np.float16 if dtype == "F16" else np.float32
    got = load_file(path)
    mapped = SafetensorsFile(path)
    for k, v in tensors.items():
        want = np.asarray(v, np.float32).astype(np_dtype)
        assert got[k].dtype == np_dtype
        np.testing.assert_array_equal(got[k], want)
        np.testing.assert_array_equal(mapped[k].numpy(), want)
