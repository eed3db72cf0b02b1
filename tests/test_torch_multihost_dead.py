"""A dead rank of a replica whose ``tp`` shards span two processes, on TINY
on the CPU.

The survivor's first shard collective (CLIP's first split layer, over the
replica's group that ``build_mesh`` made) raises within the ``timeout_s``
that ``init_multihost`` was given, instead of hanging: the replicas'
groups wait as long as the joined group. The same for a ``dp`` mesh,
whose pixel gather is the first collective, is
``tests/test_torch_multihost_mesh.py``'s.
"""

import time

from test_torch_multihost_mesh import run_ranks, weights_file
from test_torch_parallel import BASE, gates_off, params  # noqa: F401


def test_a_dead_rank_of_a_spanning_replica_makes_the_other_raise(
        params, tmp_path):
    timeout_s = 10.0
    t0 = time.monotonic()
    survivor, _ = run_ranks(
        tmp_path, ["engine", "die"], timeout_s=timeout_s, mesh="dp=1,tp=2",
        local=1, weights=weights_file(params, tmp_path),
        cases=[["tp=2", "txt2img", {**BASE, "batch_size": 1}]])
    assert time.monotonic() - t0 < timeout_s + 60
    assert "error" in survivor
    assert "RuntimeError" in survivor["error"]
