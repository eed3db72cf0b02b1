"""The port's engine on ``dp=4,tp=2`` at the odd batch 3, against the JAX
package's on the same mesh spec and the port's meshless engine, within 1
uint8 level, on TINY on the CPU (JAX ``tests/test_pipeline.py``
``TestMeshEngine``). The batch does not divide ``dp``, so replica 0 runs
every row: JAX's odd-batch fallback. A file of its own: the JAX engine
compiles for some 15 s here, and ``tests/test_torch_parallel.py`` holds
the shared fixtures and the batch-4 case.
"""

from test_torch_parallel import (  # noqa: F401 — fixtures
    engine_case,
    gates_off,
    mesh_engines,
    params,
    plain,
    providers,
)


def test_odd_batch_on_a_mesh_falls_back_to_replica_0_and_matches_jax(
        plain, mesh_engines):
    engine_case("odd batch 3 on dp=4,tp=2", plain, mesh_engines)
