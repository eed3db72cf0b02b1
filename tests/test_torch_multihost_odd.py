"""The odd batch 3 on ``dp=4,tp=2`` over two processes against the JAX
engine on the same spec, on TINY on the CPU.

The batch does not divide ``dp``, so rank 0 runs every row on replica 0
(the JAX package's odd-batch fallback) and rank 1 receives the pixels:
both ranks' images within 1 uint8 level of the JAX engine's
(``tests/test_torch_parallel.py``'s tolerance). A file of its own: the
JAX engine compiles for some 15 s here. The same ranks against the
one-process port, byte for byte, are in ``tests/test_torch_multihost.py``.
"""

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
from test_torch_multihost import CASES, as_result
from test_torch_multihost_mesh import SPEC, run_ranks, weights_file
from test_torch_parallel import assert_within_one, gates_off, params  # noqa: F401,E501


def test_odd_batch_across_ranks_matches_the_jax_engine(params, tmp_path):
    kind, body = CASES["odd batch 3"]
    outs = run_ranks(tmp_path, "engine",
                     weights=weights_file(params, tmp_path),
                     cases=[["odd batch 3", kind, body]])
    jax_engine = JaxEngine(JTINY, params, chunk_size=3, state=JaxState(),
                           mesh=jmesh.build_mesh(SPEC))
    want = jax_engine.txt2img(JaxPayload(**body))
    for out in outs:
        assert "error" not in out, out.get("error")
        got = as_result(out["odd batch 3"])
        assert len(got.images) == 3
        assert_within_one(got, want)
