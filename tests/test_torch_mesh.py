"""The port's mesh, its sharding rule and its ring attention against the
JAX package's, on the CPU.

- ``parse_mesh_spec`` and ``build_mesh`` accept and refuse the same specs
  as JAX's (JAX over the conftest's eight virtual CPU devices, the port
  over eight ``cpu`` entries: a virtual mesh), with the same messages;
  ``init_multihost`` and ``pad_batch``;
- ``tp_spec_for`` gives every TINY and SD1.5 parameter (text encoder, UNet,
  VAE) the class JAX's gives the Flax path it came from, column, row or
  replicated, with the same split or replicated outcome at ``tp`` 2 and 4;
  a placed UNet, text encoder or VAE half computes each layer by its
  class;
- ``ring_attention`` on a virtual mesh matches JAX ``ring_attention``
  within 1e-5 (f32) for ``sp=8``, ``dp x sp``, a ``SDTPU_RING_CHUNK`` that
  pads the block, and ``sp=4`` of 8 devices;
- the collectives, and a UNet placed under ``tp`` and ``sp`` against the
  plain UNet, at f32 and, under ``tp``, at int8 and int8+conv.

Inputs come from numpy with a seed; the parameter trees' shapes from
``jax.eval_shape`` (no JAX parameter is drawn).
"""

import importlib

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh as JaxMesh

from stable_diffusion_webui_distributed_tpu.models.configs import (
    SD15 as JSD15,
    TINY as JTINY,
)
from stable_diffusion_webui_distributed_tpu.parallel import sharding as jsh
from stable_diffusion_webui_distributed_tpu.runtime import mesh as jmesh
from stable_diffusion_webui_distributed_tpu_torch import bridge
from stable_diffusion_webui_distributed_tpu_torch.models import unet as unet_mod
from stable_diffusion_webui_distributed_tpu_torch.models.configs import (
    TINY_XL,
)
from stable_diffusion_webui_distributed_tpu_torch.ops import ring_attention
from stable_diffusion_webui_distributed_tpu_torch.parallel import sharding
from stable_diffusion_webui_distributed_tpu_torch.pipeline.precision import (
    PrecisionSpec,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime import mesh
from test_pipeline import init_params

CPU8 = ["cpu"] * 8
# the JAX ops package re-exports the function under the module's name
jring = importlib.import_module(
    "stable_diffusion_webui_distributed_tpu.ops.ring_attention")


def outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:  # noqa: BLE001 — compared across packages
        return (type(e).__name__, str(e))


# -- mesh specs ------------------------------------------------------------------

SPECS = ["", None, "dp=4,tp=2", "sp=8", "dp=2, sp=4", "tp=2,dp=4", "dp=4",
         "tp=2", "dp=8,sp=1", "tp=3", "dp=16", "xx=2", "dp", "dp=0",
         "dp=-1", "dp=a", "dp=2,,tp=4"]


@pytest.mark.parametrize("spec", SPECS)
def test_specs_parse_and_build_as_jax(spec):
    assert outcome(mesh.parse_mesh_spec, spec) == \
        outcome(jmesh.parse_mesh_spec, spec)

    def port(s):
        m = mesh.build_mesh(s, CPU8)
        return m.shape, m.devices.shape, m.axis_names

    def jax_(s):
        m = jmesh.build_mesh(s)
        return dict(m.shape), m.devices.shape, m.axis_names

    assert outcome(port, spec) == outcome(jax_, spec)


def test_mesh_helpers_match_jax(monkeypatch):
    m, jm = mesh.build_mesh("dp=4,tp=2", CPU8), jmesh.build_mesh("dp=4,tp=2")
    for n in range(1, 10):
        assert mesh.pad_batch(n, m) == jmesh.pad_batch(n, jm)
    assert mesh.AXIS_ORDER == jmesh.AXIS_ORDER
    monkeypatch.delenv("SDTPU_COORDINATOR", raising=False)
    assert mesh.init_multihost() is False and jmesh.init_multihost() is False
    with pytest.raises(NotImplementedError, match="ROADMAP item 14"):
        mesh.init_multihost("10.0.0.1:1234", 2, 0)
    assert m.home(3) == torch.device("cpu")
    assert m.devices.shape == (4, 2, 1) and {*m.devices.flat} == {m.home()}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.build_mesh("dp=1")


# -- the rule --------------------------------------------------------------------

def port_name(path: str) -> str:
    """The port's state-dict name of a Flax path (``bridge.py``), without
    its component (text_encoder, unet, vae/decoder, vae/encoder)."""
    parts = path.split("/")
    parts = parts[2:] if parts[0] == "vae" else parts[1:]
    if parts[-1] in ("kernel", "scale", "embedding"):
        parts[-1] = "weight"
    return ".".join(parts)


def port_class(spec):
    """The class of a spec over the port's layout: the output features
    (dim 0) split, the input features (dim 1) split, or neither."""
    if "tp" not in spec:
        return "replicated"
    return "column" if spec.index("tp") == 0 else "row"


def jax_class(spec, ndim):
    spec = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    if "tp" not in spec:
        return "replicated"
    return "column" if spec.index("tp") == ndim - 1 or ndim == 1 else "row"


@pytest.mark.parametrize("family", [JTINY, JSD15], ids=["tiny", "sd15"])
def test_rule_classes_every_parameter_as_jax(family):
    shapes = jax.eval_shape(lambda: init_params(family))
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    assert len(leaves) > 400
    seen = {"column": 0, "row": 0, "replicated": 0}
    for keypath, leaf in leaves:
        path = jsh.keystr_path(keypath)
        want = jax_class(jsh.tp_spec_for(path, leaf.ndim), leaf.ndim)
        spec = sharding.tp_spec_for(port_name(path), leaf.ndim)
        got = port_class(spec)
        assert got == want, (path, spec)
        seen[got] += 1
        # the split dimension is the same one in either layout, and both
        # packages replicate the same non-dividing ones
        port_shape = (leaf.shape if leaf.ndim < 2 else
                      leaf.shape[::-1] if leaf.ndim == 2 else
                      (leaf.shape[3], leaf.shape[2], *leaf.shape[:2]))
        for tp in (2, 4):
            jspec = tuple(jsh.tp_spec_for(path, leaf.ndim))
            j_split = "tp" in jspec and \
                leaf.shape[jspec.index("tp")] % tp == 0
            dim = sharding.shard_dim(
                port_name(path), torch.empty(port_shape, device="meta"), tp)
            assert (dim is not None) == j_split, (path, tp)
    assert min(seen.values()) > 0


def placed_roles(module):
    """Each Dense/Conv's role in a placed module: split by output
    features, by input features, or computed whole on the home device."""
    roles = {}
    for m in module.modules():
        plan = getattr(m, "tp", None)
        if isinstance(m, unet_mod.Attention) and plan is not None:
            for name, child in m.named_children():
                roles[child] = "row" if name == "out_proj" else "column"
        if getattr(m, "ffn_tp", None) is not None:
            roles[m.geglu.proj], roles[m.ff_out] = "column", "row"
    for name, m in module.named_modules():
        if isinstance(m, (unet_mod.Dense, unet_mod.Conv)) and m not in roles:
            roles[m] = ("column" if isinstance(m.tp, unet_mod._Column) else
                        "row" if isinstance(m.tp, unet_mod._Row) else
                        "replicated")
    return {name: roles[m] for name, m in module.named_modules()
            if m in roles}


#: (component, tp) of TINY_XL: the UNet keeps its first ids, ``[2]`` and
#: ``[4]``; both text encoders and both VAE halves are placed by the same
#: function
PLACED = [(c, tp) for c in ("unet", "text_encoder", "text_encoder_2", "vae",
                            "vae_encoder") for tp in (2, 4)]


@pytest.mark.parametrize(
    "component,tp", PLACED,
    ids=[str(tp) if c == "unet" else f"{c}-{tp}" for c, tp in PLACED])
def test_placed_unet_computes_each_layer_by_its_class(component, tp):
    module = bridge.build_modules(TINY_XL)[component]
    unet_mod.place_layers(module, sharding.replica_layout(
        mesh.build_mesh(f"tp={tp}", ["cpu"] * tp), 0))
    roles = placed_roles(module)
    params = dict(module.named_parameters())
    for name, role in roles.items():
        dim = sharding.shard_dim(f"{name}.weight", params[f"{name}.weight"],
                                 tp)
        assert role == {0: "column", 1: "row", None: "replicated"}[dim], name
    # the UNet splits every layer; a VAE's 3-channel conv and a text
    # encoder's nothing-dividing layers would stay whole
    assert {"column", "row"} <= set(roles.values())
    if component == "unet":
        assert set(roles.values()) == {"column", "row"}
    unet_mod.place_layers(module, None)
    assert all(getattr(m, "tp", None) is None and
               getattr(m, "ffn_tp", None) is None for m in module.modules())


# -- the ring --------------------------------------------------------------------

def qkv(b, t, h, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, d)).astype(np.float32)
            for _ in range(3)]


RING_CASES = {
    "sp=8": ("sp=8", (2, 8 * 16, 4, 32), None),
    "dp x sp": ("dp=2,sp=4", (4, 64, 2, 16), None),
    "chunk pad": ("sp=2", (1, 2 * 200, 2, 16), "128"),
    "sp=4 of 8": ("sp=4", (2, 64, 2, 16), None),
}


@pytest.mark.parametrize("case", list(RING_CASES))
def test_ring_matches_jax(case, monkeypatch):
    spec, shape, chunk = RING_CASES[case]
    if chunk is None:
        monkeypatch.delenv("SDTPU_RING_CHUNK", raising=False)
    else:
        monkeypatch.setenv("SDTPU_RING_CHUNK", chunk)
    q, k, v = qkv(*shape)
    if spec == "dp=2,sp=4":
        jm = JaxMesh(np.array(jax.devices()).reshape(2, 1, 4),
                     ("dp", "tp", "sp"))
    else:
        jm = jmesh.build_mesh(spec)
    want = np.asarray(jring.ring_attention(q, k, v, jm))
    m = mesh.build_mesh(spec, CPU8)
    got = ring_attention.ring_attention(*map(torch.from_numpy, (q, k, v)), m)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    plain = torch.softmax(torch.einsum(
        "bthd,bshd->bhts", torch.from_numpy(q), torch.from_numpy(k))
        / np.sqrt(shape[-1]), -1)
    plain = torch.einsum("bhts,bshd->bthd", plain, torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_ring_refuses_what_it_cannot_split():
    q = torch.zeros(3, 10, 1, 8)
    with pytest.raises(ValueError, match="do not divide a ring"):
        ring_attention.ring_attention_over(q, q, q, ["cpu"] * 4)
    with pytest.raises(ValueError, match="does not divide dp=2"):
        ring_attention.ring_attention(q, q, q,
                                      mesh.build_mesh("dp=2", ["cpu"] * 2))


# -- collectives and placement ---------------------------------------------------

def test_collectives():
    m = mesh.build_mesh("dp=2,sp=2", ["cpu"] * 4)
    x = torch.arange(24.0).reshape(4, 6)
    blocks = sharding.place_batch(x, m)
    assert [b.tolist() for b in blocks] == [x[:2].tolist(), x[2:].tolist()]
    assert all(r is x or torch.equal(r, x)
               for r in sharding.replicate(x, m))
    assert torch.equal(sharding.gather(list(x.chunk(3, 1)), 1, "cpu"), x)
    assert torch.equal(sharding.reduce_sum(list(x.chunk(2)), "cpu"),
                       x[:2] + x[2:])
    shifted = sharding.ring_shift(list(x.chunk(4)), ["cpu"] * 4)
    assert torch.equal(torch.cat(shifted), torch.cat([x[3:], x[:3]]))
    with pytest.raises(ValueError, match="do not divide dp=2"):
        sharding.place_batch(x[:3], m)
    # an evaluation's [uncond; cond] rows: each replica takes its rows of
    # both halves, and writing the blocks back gives the rows in order
    rows = torch.arange(8.0)[:, None] * torch.ones(1, 3)
    blocks = [sharding.batch_block(rows, r, 2, 4) for r in range(2)]
    assert [b[:, 0].tolist() for b in blocks] == [[0, 1, 4, 5], [2, 3, 6, 7]]
    out = None
    for r, b in enumerate(blocks):
        out = sharding.write_block(out, b, r, 2, 4, "cpu")
    assert torch.equal(out, rows)
    shards = sharding.shard_params(
        {"a.qkv.weight": torch.ones(6, 4), "a.norm.weight": torch.ones(4),
         "a.out_proj.weight": torch.ones(4, 6)},
        mesh.build_mesh("tp=2", ["cpu"] * 2))
    assert [tuple(s.shape) for s in shards["a.qkv.weight"]] == [(3, 4)] * 2
    assert [tuple(s.shape) for s in shards["a.out_proj.weight"]] == \
        [(4, 3)] * 2
    assert all(s.shape == (4,) for s in shards["a.norm.weight"])


@pytest.mark.parametrize("spec", ["tp=2", "sp=2", "tp=2,sp=2", "tp=4",
                                  "dp=2,tp=2"])
def test_placed_unet_matches_the_plain_unet(spec):
    torch.manual_seed(0)
    sd = bridge.init_seeded(TINY_XL, 0, device="cpu", dtype=torch.float32)
    unet = bridge.build_modules(TINY_XL)["unet"]
    unet.load_state_dict(sd["unet"])
    cfg = TINY_XL.unet
    x, t = torch.randn(2, 8, 8, 4), torch.tensor([10.0, 700.0])
    ctx = torch.randn(2, 77, cfg.cross_attention_dim)
    added = torch.randn(2, cfg.projection_input_dim)
    with torch.no_grad():
        want = unet(x, t, ctx, added_cond=added)
        reps = sharding.replicas(unet, mesh.build_mesh(spec, CPU8),
                                 unet_mod.place_layers)
        assert all(r is unet for r in reps)  # one device: one module
        got = [r(x, t, ctx, added_cond=added) for r in reps]
        for g in got:
            np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=1e-5,
                                       atol=1e-5)
        if "tp" in spec:
            # int8 on the shards: the split products give the plain
            # layers' values, so the UNet is the plain int8 UNet's
            for prec in (PrecisionSpec("int8", quant_linears=True),
                         PrecisionSpec("int8+conv", quant_linears=True,
                                       quant_convs=True)):
                unet_mod.place_layers(unet, None)
                want = unet(x, t, ctx, added_cond=added, precision=prec)
                reps = sharding.replicas(unet, mesh.build_mesh(spec, CPU8),
                                         unet_mod.place_layers)
                got = reps[0](x, t, ctx, added_cond=added, precision=prec)
                np.testing.assert_allclose(got.numpy(), want.numpy(),
                                           rtol=1e-5, atol=1e-5)
