"""``int8+conv`` under ``tp``: a split convolution against the meshless int8
convolution bit for bit, and the engine at ``int8+conv`` on ``dp=4,tp=2``
against the JAX engine, on TINY on the CPU.

- **The layer**: ``_Column`` on a Conv (virtual ``cpu`` meshes with ``tp``
  2 and 4) takes the activation scale per image over C, H and W of the
  whole input, and each shard runs ``conv_patches`` and the product on
  its own output channels, so it equals the meshless int8 convolution
  with ``torch.equal``, accumulators included (3x3, stride 2, 1x1; a zero
  image, as ``tests/test_torch_quant.py``'s inputs have).
- **The engine**: ``dp=4,tp=2`` at batch 4 served through ``POST
  /sdapi/v1/txt2img`` at ``int8+conv``, against the JAX engine on the
  same mesh spec and the port's meshless engine, within
  ``tests/test_torch_quant.py``'s ``PIXELS`` bound. The JAX engine at
  int8+conv on a mesh compiles for some 24 s on a CPU: a file of its own.
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


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("kernel,stride,pad,channels", [
    (3, 1, 1, (12, 8)), (3, 2, 1, (8, 16)), (1, 1, 0, (10, 4))])
@pytest.mark.parametrize("quant_convs", [False, True])
def test_column_conv_is_the_meshless_layer(kernel, stride, pad, channels,
                                           tp, quant_convs):
    cin, cout = channels
    torch.manual_seed(7)
    conv = unet.Conv(cin, cout, kernel, stride=stride, padding=pad)
    torch.nn.init.normal_(conv.bias, std=0.2)
    rng = np.random.default_rng(kernel * 10 + stride)
    x = torch.from_numpy(
        rng.standard_normal((3, cin, 9, 11)).astype(np.float32) * 2.0)
    x[2] = 0.0  # a zero image: its scale is eps, its codes 0
    want = conv(x, quant_convs)
    col = unet._Column(conv, ["cpu"] * tp, torch.device("cpu"))
    conv.tp = col
    assert torch.equal(conv(x, quant_convs), want)
    if quant_convs:
        xq, s_x = quant.quantize(x, (1, 2, 3))
        accs = [quant.int8_conv_codes(xq, s_x, w, conv.stride, conv.padding,
                                      accumulators=True)[1]
                for w in col.weights]
        _, want_acc = quant.int8_conv(x, conv.weight, conv.stride,
                                      conv.padding, accumulators=True)
        assert torch.equal(torch.cat(accs, -1), want_acc)


@pytest.fixture(scope="module")
def jax_mesh_engine(params):
    return JaxEngine(JTINY, params, chunk_size=3, state=JaxState(),
                     mesh=jmesh.build_mesh("dp=4,tp=2"))


def test_engine_at_int8_conv_on_a_mesh_matches_jax_and_the_meshless_port(
        params, providers, plain, jax_mesh_engine, monkeypatch):
    extra, _ = SERVED["int8+conv"]
    body = {**BASE, **extra, "batch_size": 4}
    wants = [jax_mesh_engine.txt2img(JaxPayload(**body)),
             plain.txt2img(GenerationPayload(**body))]
    assert wants[0].seeds == wants[1].seeds
    served_case("int8+conv", port_engine(params, providers, "dp=4,tp=2"),
                wants, monkeypatch, batch=4)
