"""The int8 precisions under ``tp``: every split product against the meshless
int8 layer bit for bit, and the engine at ``int8`` on ``dp=4,tp=2`` against
the JAX engine, on TINY on the CPU.

- **Layers** (``models/unet.py`` placements, virtual ``cpu`` meshes with
  ``tp`` 2 and 4, at ``int8`` and ``int8+conv``): a column split quantizes
  its whole input once and each shard owns whole output channels; a row
  split takes each token's and each channel's scale as the max of its
  shards' maxima and sums the shards' int32 accumulators before one
  dequantize. Integer sums are exact, so ``_Column`` (Dense), ``_Row``,
  ``_Heads``' q, k and v projections and its ``out_proj`` row product,
  and ``_Halves``' GEGLU halves and its ``ff_out`` row product equal the
  meshless layer with ``torch.equal``, and the summed accumulators equal
  the meshless ones. The inputs carry ``tests/test_torch_quant.py``'s
  zero row and row of exact ties. ``_Column`` on a Conv is in
  ``tests/test_torch_parallel_int8_conv.py``.
- **The engine**: ``dp=4,tp=2`` at batch 4 served through ``POST
  /sdapi/v1/txt2img`` at ``int8``, against the JAX engine on the same mesh
  spec and the port's meshless engine, within ``tests/test_torch_quant.py``'s
  ``PIXELS`` bound (``SERVED`` in ``tests/test_torch_parallel.py``). A JAX
  engine at int8 on a mesh compiles for some 28 s on a CPU, so int8+conv and
  traced LoRA have files of their own.
"""

import numpy as np
import pytest
import torch

from stable_diffusion_webui_distributed_tpu.models.configs import (
    TINY as JTINY,
)
from stable_diffusion_webui_distributed_tpu.pipeline.engine import (
    Engine as JaxEngine,
)
from stable_diffusion_webui_distributed_tpu.pipeline.payload import (
    GenerationPayload as JaxPayload,
)
from stable_diffusion_webui_distributed_tpu.runtime import mesh as jmesh
from stable_diffusion_webui_distributed_tpu.runtime.interrupt import (
    GenerationState as JaxState,
)
from stable_diffusion_webui_distributed_tpu_torch.models import unet
from stable_diffusion_webui_distributed_tpu_torch.ops import quant
from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    GenerationPayload,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline.precision import (
    PrecisionSpec,
)
from test_torch_parallel import (  # noqa: F401 — fixtures
    BASE,
    SERVED,
    gates_off,
    params,
    plain,
    port_engine,
    providers,
    served_case,
)

TPS = [2, 4]
PRECISIONS = {"int8": PrecisionSpec("int8", quant_linears=True),
              "int8+conv": PrecisionSpec("int8+conv", quant_linears=True,
                                         quant_convs=True)}
C, HEADS, CTX = 32, 4, 24  # TINY's level-0 width, heads and a context width


def tokens(seed, b, t, k):
    """``(b, t, k)`` f32 activations with a zero token and a token of exact
    ties (its abs max is 127, so its scale is 1.0 and the halves round to
    even), as ``tests/test_torch_quant.py``'s ``dot_inputs``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, k)).astype(np.float32) * 3.0
    x[0, 0] = 0.0
    x[0, 1] = np.resize(np.array([127.0, 2.5, -0.5, 3.5, -6.5, 0.5],
                                 np.float32), k)
    return torch.from_numpy(x)


def layer(cls, *args, seed=0):
    torch.manual_seed(seed)
    m = cls(*args)
    for p in m.parameters():
        # nonzero biases, so their add is held too
        torch.nn.init.normal_(p, std=0.2)
    return m


def cpus(tp):
    return ["cpu"] * tp


@pytest.mark.parametrize("prec", list(PRECISIONS))
@pytest.mark.parametrize("tp", TPS)
def test_column_dense_is_the_meshless_layer(tp, prec):
    ql = PRECISIONS[prec].quant_linears
    dense = layer(unet.Dense, C, 3 * C)
    x = tokens(1, 2, 7, C)
    want = dense(x, ql)
    dense.tp = unet._Column(dense, cpus(tp), torch.device("cpu"))
    assert torch.equal(dense(x, ql), want)


@pytest.mark.parametrize("prec", list(PRECISIONS))
@pytest.mark.parametrize("tp", TPS)
def test_row_is_the_meshless_layer_and_sums_its_accumulators(tp, prec):
    ql = PRECISIONS[prec].quant_linears
    dense = layer(unet.Dense, 4 * C, C)
    x = tokens(2, 2, 7, 4 * C)
    want = dense(x, ql)
    row = unet._Row(dense, cpus(tp), torch.device("cpu"))
    dense.tp = row
    assert torch.equal(dense(x, ql), want)
    # the shards' int32 accumulators, summed, are the meshless ones
    xq, s_x = quant.quantize(x, -1)
    acc, _, s_w = unet._int8_rows(list(xq.chunk(tp, -1)), row.weights,
                                   torch.device("cpu"), s_x)
    _, want_acc = quant.int8_dot(x, dense.weight, accumulators=True)
    assert torch.equal(acc.reshape(-1, C), want_acc)
    assert torch.equal(s_w, quant.quantize(dense.weight, 1)[1])


@pytest.mark.parametrize("prec", list(PRECISIONS))
@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("kind", ["self", "cross"])
def test_head_products_are_the_meshless_layers(kind, tp, prec):
    """``_Heads``' q, k and v (per-head rows of the fused ``qkv`` / ``kv``
    keep their own scales) and its ``out_proj`` row product, whose token
    scales are the max over the shards of each token's abs max."""
    ql = PRECISIONS[prec].quant_linears
    attn = layer(unet.Attention, C, HEADS, *(() if kind == "self" else
                                             (CTX,)))
    x = tokens(3, 2, 6, C)
    ctx = None if kind == "self" else tokens(4, 2, 5, CTX)
    heads = unet._Heads(attn, cpus(tp), [None] * tp, torch.device("cpu"))
    got = heads.project(x, ctx, {}, ql)
    if kind == "self":
        want = attn.qkv(x, ql).split(C, -1)
    else:
        want = (attn.q(x, ql), *attn.kv(ctx, ql).split(C, -1))
    for i in range(3):
        whole = torch.cat([g[i] for g in got], dim=-2).flatten(-2)
        assert torch.equal(whole, want[i])
    # the row product over a head-split input
    o = tokens(5, 2, 6, C)
    assert torch.equal(heads.output(list(o.chunk(tp, -1)), None, ql),
                       attn.out_proj(o, ql))
    acc, s_x, _ = unet._int8_rows(list(o.chunk(tp, -1)), heads.out,
                                  torch.device("cpu"))
    _, want_acc = quant.int8_dot(o, attn.out_proj.weight, accumulators=True)
    assert torch.equal(acc.reshape(-1, C), want_acc)
    assert torch.equal(s_x, quant.quantize(o, -1)[1])


@pytest.mark.parametrize("prec", list(PRECISIONS))
@pytest.mark.parametrize("tp", TPS)
def test_halves_products_are_the_meshless_layers(tp, prec):
    """``_Halves``: each shard's ``a * gelu(g)`` is its slice of the
    meshless GEGLU's, and ``ff_out`` is a row product."""
    ql = PRECISIONS[prec].quant_linears
    block = layer(unet.TransformerBlock, C, HEADS, CTX)
    h = tokens(6, 2, 6, C)
    halves = unet._Halves(block, cpus(tp), torch.device("cpu"))
    ys = halves.hidden(h, None, ql)
    want = block.geglu(h, ql=ql)
    assert torch.equal(torch.cat(ys, -1), want)
    assert torch.equal(halves.output(ys, None, ql), block.ff_out(want, ql))
    acc, _, _ = unet._int8_rows(ys, halves.out, torch.device("cpu"))
    _, want_acc = quant.int8_dot(want, block.ff_out.weight,
                                 accumulators=True)
    assert torch.equal(acc.reshape(-1, C), want_acc)


@pytest.fixture(scope="module")
def jax_mesh_engine(params):
    return JaxEngine(JTINY, params, chunk_size=3, state=JaxState(),
                     mesh=jmesh.build_mesh("dp=4,tp=2"))


def test_engine_at_int8_on_a_mesh_matches_jax_and_the_meshless_port(
        params, providers, plain, jax_mesh_engine, monkeypatch):
    extra, _ = SERVED["int8"]
    body = {**BASE, **extra, "batch_size": 4}
    wants = [jax_mesh_engine.txt2img(JaxPayload(**body)),
             plain.txt2img(GenerationPayload(**body))]
    assert wants[0].seeds == wants[1].seeds
    served_case("int8", port_engine(params, providers, "dp=4,tp=2"), wants,
                monkeypatch, batch=4)
