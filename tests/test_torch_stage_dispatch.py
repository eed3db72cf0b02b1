"""The serving dispatcher's stage-graph groups (``SDTPU_STAGE_GRAPH``)
against its serial groups and the JAX package's staged dispatcher, on TINY
on the CPU.

Coalesced groups, dense (four requests on a batch-2 ladder: two groups of
two, back to back, each group's merge on its leader's thread while the
next group's stages run) and ragged (three heights on one bucket), give
the serial groups' bytes, with equal seeds and infotexts, and the JAX
staged dispatcher's pixels within 1 uint8 level (the tolerance of
``tests/test_torch_engine.py``); every ticket hears each of its group's
four stages through ``on_stage``. The engines and weights are
``tests/test_torch_stage_graph.py``'s.
"""

import threading
import time

import pytest

from stable_diffusion_webui_distributed_tpu.serving.bucketer import (
    ShapeBucketer as JaxBucketer,
)
from stable_diffusion_webui_distributed_tpu.serving.dispatcher import (
    ServingDispatcher as JaxDispatcher,
)
from stable_diffusion_webui_distributed_tpu_torch.serving.bucketer import (
    ShapeBucketer,
)
from stable_diffusion_webui_distributed_tpu_torch.serving.dispatcher import (
    ServingDispatcher,
)
from stable_diffusion_webui_distributed_tpu_torch.serving.metrics import (
    METRICS,
)
from test_torch_stage_graph import (  # noqa: F401 — fixtures
    DEFAULTS,
    THREAD_LIMIT,
    assert_near_jax,
    cn_tree,
    engine,
    gates_off,
    jax_engine,
    jax_payload,
    params,
    payload,
    staged,
)


def concurrent(disp, bodies, on_stage=None):
    """``bodies`` submitted 50 ms apart inside one coalesce window; each
    ticket's stage callbacks recorded when ``on_stage`` is a dict."""
    if on_stage is not None:
        run_grouped = disp._run_grouped

        def hooked(ticket):
            ticket.on_stage = lambda rid, stage, secs: on_stage.setdefault(
                rid, []).append(stage)
            return run_grouped(ticket)

        disp._run_grouped = hooked
    results, threads, errors = [None] * len(bodies), [], []
    for i, p in enumerate(bodies):
        def run(i=i, p=p):
            try:
                results[i] = disp.submit(p)
            except Exception as e:  # noqa: BLE001 — surfaced below
                errors.append(e)
        threads.append(threading.Thread(target=run))
        threads[-1].start()
        time.sleep(0.05)
    for t in threads:
        t.join(THREAD_LIMIT)
        assert not t.is_alive(), "a request outlived its limit"
    assert not errors, errors
    return results


GROUPS = {
    # four requests on a batch-2 ladder: two groups of two, back to back
    "dense": (dict(), [(32, 32)] * 4, [(32, 32)]),
    # three heights on one ragged bucket
    "ragged": (dict(SDTPU_RAGGED="1"), [(32, 32), (32, 24), (32, 16)],
               [(32, 32)]),
}


@pytest.mark.parametrize("name", sorted(GROUPS))
def test_dispatcher_staged_groups_match_serial_and_jax(
        engine, jax_engine, staged, name):
    env, sizes, ladder = GROUPS[name]
    for k, v in env.items():
        staged.setenv(k, v)
    batches = [2] if name == "dense" else [4]
    bodies = [dict(DEFAULTS, prompt=f"stage cow {i % 2}", seed=200 + i,
                   width=w, height=h, request_id=f"{name}-{i}")
              for i, (w, h) in enumerate(sizes)]
    staged.delenv("SDTPU_STAGE_GRAPH")
    serial = concurrent(ServingDispatcher(
        engine, bucketer=ShapeBucketer(shapes=ladder, batches=batches),
        window=0.6), [payload(**b) for b in bodies])
    staged.setenv("SDTPU_STAGE_GRAPH", "1")
    stages = {}
    disp = ServingDispatcher(
        engine, bucketer=ShapeBucketer(shapes=ladder, batches=batches),
        window=0.6)
    got = concurrent(disp, [payload(**b) for b in bodies], stages)
    assert METRICS.summary()["dispatches"] >= 1
    for a, b in zip(got, serial):
        assert a.images == b.images
        assert a.seeds == b.seeds and a.infotexts == b.infotexts
    assert stages == {b["request_id"]: ["encode", "denoise", "decode",
                                        "merge"] for b in bodies}
    want = concurrent(JaxDispatcher(
        jax_engine, bucketer=JaxBucketer(shapes=ladder, batches=batches),
        window=0.6), [jax_payload(**b) for b in bodies])
    for a, b in zip(got, want):
        assert_near_jax(a, b)
