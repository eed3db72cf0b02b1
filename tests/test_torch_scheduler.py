"""The port's fleet scheduler against the JAX package's, on the CPU.

Both packages get the same inputs: the ETA model and its MPE feedback over a
grid of payloads, samplers, hires settings and error histories (within
1e-12); the worker state machine and the pixel cap of ``Job.add_work``;
``World.plan`` on 240 seeded random fleets of stub workers (speeds, pixel
caps, masters, states, thin-client mode, ``job_timeout``,
``complement_production``, ``step_scaling``), which must give the same list
of (label, batch, start, complementary, step_override); ``World.execute``
over stubs with injected failures (merged seeds, images, infotexts, worker
labels and where each range was requeued); the World's cluster operations;
and the config file, which each package must load as the other wrote it.
The port's own daemons (the in-flight interrupt watch, the heartbeat) are
checked on their own.
"""

import json
import random
import threading
import time

import pytest

from stable_diffusion_webui_distributed_tpu.pipeline.payload import (
    GenerationPayload as JPayload,
)
from stable_diffusion_webui_distributed_tpu.runtime import config as jconfig
from stable_diffusion_webui_distributed_tpu.samplers import kdiffusion as jkd
from stable_diffusion_webui_distributed_tpu.scheduler import eta as jeta
from stable_diffusion_webui_distributed_tpu.scheduler import worker as jworker
from stable_diffusion_webui_distributed_tpu.scheduler import world as jworld
from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    GenerationPayload as PPayload,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime import (
    config as pconfig,
)
from stable_diffusion_webui_distributed_tpu_torch.scheduler import eta as peta
from stable_diffusion_webui_distributed_tpu_torch.scheduler import (
    worker as pworker,
)
from stable_diffusion_webui_distributed_tpu_torch.scheduler import (
    world as pworld,
)

PACKAGES = {
    "jax": (JPayload, jconfig, jeta, jworker, jworld),
    "port": (PPayload, pconfig, peta, pworker, pworld),
}
TOL = 1e-12


def close(a, b):
    return abs(a - b) <= TOL * max(1.0, abs(a))


# -- ETA ---------------------------------------------------------------------

SAMPLERS = ["Euler a", "Euler", "DDIM", "DPM++ 2M Karras", "Heun",
            "LMS Karras", "DPM adaptive", "Mystery Sampler"]


def eta_payloads(hires: bool):
    for w, h in [(512, 512), (768, 512), (64, 48)]:
        for steps in (1, 20, 37):
            for batch in (1, 3):
                kw = dict(width=w, height=h, steps=steps, batch_size=batch)
                if hires:
                    for scale, steps2 in [(2.0, 0), (1.25, 3)]:
                        yield dict(kw, enable_hr=True, hr_scale=scale,
                                   hr_second_pass_steps=steps2)
                else:
                    yield kw


def error_history(seed: int):
    """(predicted, actual) pairs: some rejected (|e| >= 500%), some not
    positive, enough to roll the window."""
    rng = random.Random(seed)
    pairs = []
    for _ in range(9):
        actual = rng.uniform(0.5, 30.0)
        pairs.append((actual * rng.choice([0.5, 0.9, 1.1, 1.7, 7.0]),
                      actual))
    return pairs + [(0.0, 1.0), (1.0, 0.0), (3.0, 0.4)]


@pytest.mark.parametrize("hires", [False, True])
@pytest.mark.parametrize("sampler", SAMPLERS)
def test_predict_eta_and_mpe_feedback_match_jax(sampler, hires):
    bench = {"jax": jconfig.BenchmarkPayload(steps=25, width=640,
                                             height=512),
             "port": pconfig.BenchmarkPayload(steps=25, width=640,
                                              height=512)}
    checked = 0
    for seed, ipm in enumerate([0.7, 6.0, 83.5]):
        cals = {name: pkg[2].EtaCalibration(avg_ipm=ipm)
                for name, pkg in PACKAGES.items()}
        history = error_history(seed)
        for n_samples in range(len(history) + 1):
            if n_samples:
                pred, actual = history[n_samples - 1]
                for name, pkg in PACKAGES.items():
                    pkg[2].record_eta_error(cals[name], pred, actual)
                assert all(close(a, b) for a, b in zip(
                    cals["jax"].eta_percent_error,
                    cals["port"].eta_percent_error))
                assert len(cals["jax"].eta_percent_error) \
                    == len(cals["port"].eta_percent_error)
            if n_samples % 4:
                continue
            for kw in eta_payloads(hires):
                for override in [{}, {"batch_size": 2}, {"steps": 1}]:
                    out = {}
                    for name, pkg in PACKAGES.items():
                        payload = pkg[0](sampler_name=sampler, **kw)
                        out[name] = pkg[2].predict_eta(
                            cals[name], payload, bench[name], **override)
                    assert close(out["jax"], out["port"]), (kw, override)
                    checked += 1
    assert checked >= 600
    for name, pkg in PACKAGES.items():
        with pytest.raises(ValueError):
            pkg[2].predict_eta(pkg[2].EtaCalibration(), pkg[0]())


# -- state machine and pixel cap ---------------------------------------------

STATES = ["IDLE", "WORKING", "INTERRUPTED", "UNAVAILABLE", "DISABLED"]


@pytest.mark.parametrize("start", STATES)
def test_state_machine_matches_jax(start):
    for target in STATES:
        for cycle in (False, True):
            seen = {}
            for name, pkg in PACKAGES.items():
                wmod = pkg[3]
                node = wmod.WorkerNode("w", wmod.StubBackend(), avg_ipm=1.0)
                node.state = wmod.State[start]
                node.loaded_model, node.loaded_vae = "m", "v"
                ok = node.set_state(wmod.State[target], expect_cycle=cycle)
                seen[name] = (ok, node.state.name, node.loaded_model,
                              node.available,
                              [t["to"] for t in
                               node.health.summary()["transitions"]])
            assert seen["jax"] == seen["port"], (start, target, cycle)
    assert {s.name for s in pworker.TRANSITIONS} == set(STATES)
    assert {k.name: sorted(v.name for v in vs)
            for k, vs in pworker.TRANSITIONS.items()} == \
        {k.name: sorted(v.name for v in vs)
         for k, vs in jworker.TRANSITIONS.items()}


@pytest.mark.parametrize("cap_images", [0, 1, 2, 5])
def test_job_add_work_pixel_cap_matches_jax(cap_images):
    for w, h in [(512, 512), (640, 512), (64, 64)]:
        for start in range(0, 4):
            for add in (1, 2, 3):
                out = {}
                for name, pkg in PACKAGES.items():
                    node = pkg[3].WorkerNode(
                        "w", pkg[3].StubBackend(), avg_ipm=1.0,
                        pixel_cap=cap_images * 512 * 512)
                    job = pkg[4].Job(node, start)
                    ok = job.add_work(pkg[0](width=w, height=h), add)
                    out[name] = (ok, job.batch_size)
                assert out["jax"] == out["port"], (w, h, start, add)


# -- World.plan --------------------------------------------------------------

def make_world(pkg, spec):
    payload_cls, config_mod, _, wmod, world_mod = pkg
    world = world_mod.World(config_mod.ConfigModel())
    world.job_timeout = spec["job_timeout"]
    world.complement_production = spec["complement_production"]
    world.step_scaling = spec["step_scaling"]
    world.thin_client_mode = spec["thin_client"]
    stubs = {}
    for w in spec["workers"]:
        stub = wmod.StubBackend(wmod.StubBehavior(**w["behavior"]))
        node = wmod.WorkerNode(w["label"], stub, master=w["master"],
                               pixel_cap=w["cap"], avg_ipm=w["ipm"])
        node.set_state(wmod.State[w["state"]])
        world.add_worker(node)
        stubs[w["label"]] = stub
    return world, stubs, payload_cls(**spec["payload"])


# every name of the sampler table: DPM adaptive plans whole on one backend
ALL_SAMPLERS = list(jkd.SAMPLERS)


def random_spec(rng: random.Random):
    n = rng.randint(1, 6)
    workers = []
    for i in range(n):
        workers.append({
            "label": rng.choice(["a", "b", "c"]) + str(i),
            "ipm": round(rng.uniform(0.5, 60.0), 3),
            "master": i == 0 if rng.random() < 0.8 else rng.random() < 0.3,
            "cap": rng.choice([0, 0, 0, 512 * 512, 2 * 512 * 512,
                               6 * 512 * 512]),
            "state": rng.choice(["IDLE"] * 6 + ["UNAVAILABLE", "DISABLED"]),
            "behavior": {},
        })
    w, h = rng.choice([(512, 512), (768, 512), (512, 640), (1024, 1024)])
    return {
        "workers": workers,
        "job_timeout": rng.choice([1, 3, 10]),
        "complement_production": rng.random() < 0.7,
        "step_scaling": rng.random() < 0.3,
        "thin_client": rng.random() < 0.1,
        "payload": dict(prompt="p", seed=10, width=w, height=h,
                        batch_size=rng.randint(1, 24),
                        steps=rng.choice([10, 20, 40]),
                        sampler_name=rng.choice(ALL_SAMPLERS)),
    }


def planned(pkg, spec):
    world, _, payload = make_world(pkg, spec)
    try:
        jobs = world.plan(payload)
    except RuntimeError as e:
        return ("raised", str(e))
    return [(j.worker.label, j.batch_size, j.start_index, j.complementary,
             j.step_override) for j in jobs]


@pytest.mark.parametrize("chunk", range(8))
def test_plan_matches_jax_on_random_fleets(chunk):
    rng = random.Random(1000 + chunk)
    kinds = set()
    for trial in range(30):
        spec = random_spec(rng)
        want = planned(PACKAGES["jax"], spec)
        got = planned(PACKAGES["port"], spec)
        assert got == want, f"trial {trial}: {json.dumps(spec)}"
        kinds.add("raised" if want and want[0] == "raised" else "planned")
        if isinstance(want, list):
            kinds.update("complementary" for j in want if j[3])
            kinds.update("step_override" for j in want if j[4])
    assert "planned" in kinds


def test_plan_scenarios_reach_every_phase():
    """The random fleets above exercise deferral, complementary work, step
    scaling and unplaceable requests, not only the equal split."""
    rng_kinds = set()
    for chunk in range(8):
        rng = random.Random(1000 + chunk)
        for _ in range(30):
            want = planned(PACKAGES["jax"], random_spec(rng))
            if want and want[0] == "raised":
                rng_kinds.add("raised")
                continue
            rng_kinds.update("complementary" for j in want if j[3])
            rng_kinds.update("step_override" for j in want if j[4])
            if len({j[1] for j in want}) > 1:
                rng_kinds.add("uneven")
    assert rng_kinds >= {"raised", "complementary", "step_override",
                         "uneven"}


@pytest.mark.parametrize("precision", ["int8", "int8+conv", "w8a8"])
def test_plan_at_each_precision_matches_jax(precision):
    """A request's serving precision scales every worker's ETA by its
    factor: the plans, and the ETAs the planner reads, are the JAX
    package's at each rung."""
    rng = random.Random(3000)
    for trial in range(12):
        spec = random_spec(rng)
        spec["payload"]["precision"] = precision
        assert planned(PACKAGES["port"], spec) == \
            planned(PACKAGES["jax"], spec), f"trial {trial}"
        etas = {}
        for name, pkg in PACKAGES.items():
            world, _, payload = make_world(pkg, spec)
            etas[name] = [w.eta(payload) for w in world.workers_snapshot()
                          if w.cal.benchmarked]
        assert all(close(a, b) for a, b in zip(etas["jax"], etas["port"]))
        assert len(etas["jax"]) == len(etas["port"])


@pytest.mark.parametrize("chunk", range(4))
def test_adaptive_plan_matches_jax_on_random_fleets(chunk):
    """DPM adaptive runs whole on the fastest backend that fits it (the
    JAX package's ``_plan_no_split``), and splits only when none does."""
    rng = random.Random(2000 + chunk)
    kinds = set()
    for trial in range(30):
        spec = random_spec(rng)
        spec["payload"]["sampler_name"] = "DPM adaptive"
        want = planned(PACKAGES["jax"], spec)
        got = planned(PACKAGES["port"], spec)
        assert got == want, f"trial {trial}: {json.dumps(spec)}"
        if isinstance(want, list):
            kinds.add("whole" if len(want) == 1 else "split")
    assert "whole" in kinds


# -- World.execute -----------------------------------------------------------

def worker(label, ipm=10.0, master=False, cap=0, **behavior):
    return {"label": label, "ipm": ipm, "master": master, "cap": cap,
            "state": "IDLE", "behavior": behavior}


EXECUTE_CASES = {
    "healthy": [worker("m", master=True), worker("a"), worker("b", 7.0)],
    "failed-remote-requeued": [worker("m", master=True),
                               worker("bad", fail_after_n_requests=0)],
    "split-across-capped-survivors": [
        worker("bad", master=True, fail_generate=True),
        worker("c1", cap=512 * 512), worker("c2", cap=512 * 512)],
    "second-failure-falls-through": [
        worker("m", master=True), worker("f1", fail_generate=True),
        worker("f2", 12.0, fail_after_n_requests=1)],
    "complementary-failure-dropped": [
        worker("m", 60.0, master=True), worker("s2", 30.0,
                                               fail_generate=True)],
    "all-fail": [worker("m", master=True, fail_generate=True),
                 worker("x", fail_generate=True)],
}


@pytest.mark.parametrize("case", sorted(EXECUTE_CASES))
def test_execute_with_failures_matches_jax(case):
    spec = {"workers": EXECUTE_CASES[case], "job_timeout": 3,
            "complement_production": True, "step_scaling": False,
            "thin_client": False,
            "payload": dict(prompt="p", negative_prompt="n", seed=100,
                            subseed=7, steps=20, width=512, height=512,
                            batch_size=6 if case != "split-across-capped-"
                            "survivors" else 4)}
    out = {}
    for name, pkg in PACKAGES.items():
        world, stubs, payload = make_world(pkg, spec)
        r = world.execute(payload)
        out[name] = {
            "images": r.images, "seeds": r.seeds, "subseeds": r.subseeds,
            "infotexts": r.infotexts, "labels": r.worker_labels,
            "requests": {label: [(q["start"], q["count"],
                                  q["payload"].steps)
                                 for q in stub.requests]
                         for label, stub in stubs.items()},
            "states": {w.label: w.state.name for w in world.workers},
            "requeued": {w.label: w.health.summary()["requeued_images"]
                         for w in world.workers},
        }
    assert out["port"] == out["jax"]
    if case != "all-fail":
        assert out["port"]["seeds"] == sorted(out["port"]["seeds"])
        assert all(t.endswith(f", Worker Label: {lab}") for t, lab in
                   zip(out["port"]["infotexts"], out["port"]["labels"]))


def test_requeue_reapplies_the_step_override_as_jax():
    out = {}
    for name, pkg in PACKAGES.items():
        wmod, world_mod = pkg[3], pkg[4]
        world = world_mod.World(pkg[1].ConfigModel())
        survivor = wmod.WorkerNode("s", wmod.StubBackend(), avg_ipm=10.0)
        world.add_worker(survivor)
        bad = wmod.WorkerNode("bad", wmod.StubBackend(
            wmod.StubBehavior(fail_generate=True)), avg_ipm=10.0)
        job = world_mod.Job(bad, 2)
        job.start_index = 3
        job.step_override = 7
        recovered = world._requeue_failed(job, pkg[0](steps=20, seed=5))
        req = survivor.backend.requests[-1]
        out[name] = ([(j.worker.label, j.start_index, j.batch_size,
                       j.step_override) for j in recovered],
                     req["payload"].steps, req["start"], req["count"])
    assert out["port"] == out["jax"] == ([("s", 3, 2, 7)], 7, 3, 2)


# -- the config file ---------------------------------------------------------

def full_config(config_mod):
    return config_mod.ConfigModel(
        workers=[
            {"master": config_mod.WorkerModel(
                master=True, avg_ipm=81.5, eta_percent_error=[1.5, -2.0],
                pixel_cap=4 * 512 * 512)},
            {"remote": config_mod.WorkerModel(
                address="10.0.0.2", port=7861, tls=True, user="u",
                password="p", disabled=True, model_override="sd15",
                device_ids=[0, 1])},
        ],
        benchmark_payload=config_mod.BenchmarkPayload(steps=10, width=768),
        job_timeout=7, complement_production=False, step_scaling=True,
        thin_client_mode=True, default_model="sd15",
        mesh_axes={"dp": 2}, bucket_ladder="512x512", batch_ladder="1,2",
        coalesce_window=0.1, fleet_enabled=False)


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_config_written_by_one_package_loads_in_the_other(tmp_path, writer,
                                                          reader):
    path = str(tmp_path / "distributed-config.json")
    wrote = full_config(PACKAGES[writer][1])
    PACKAGES[writer][1].save_config(wrote, path)
    loaded = PACKAGES[reader][1].load_config(path)
    assert loaded.model_dump() == wrote.model_dump()
    assert not (tmp_path / "distributed-config.json.tmp").exists()


@pytest.mark.parametrize("content,kind", [
    ('[{"label": "w1", "address": "h", "port": 7000, "pixel_cap": -1}]',
     None),
    ("{not json", "corrupt"),
    ('{"workers": [{"w": {"port": "x"}}]}', "invalid"),
])
def test_legacy_and_bad_config_files_load_as_jax(tmp_path, content, kind):
    out = {}
    for name, pkg in PACKAGES.items():
        path = tmp_path / f"{name}.json"
        path.write_text(content)
        out[name] = pkg[1].load_config(str(path)).model_dump()
        aside = [p for p in tmp_path.iterdir()
                 if p.name.startswith(f"{name}.json.")]
        assert (kind is None) == (not aside)
        if kind:
            assert aside[0].name.startswith(f"{name}.json.{kind}-")
    assert out["port"] == out["jax"]


def test_world_config_round_trip_matches_jax(tmp_path):
    """``from_config`` then ``save_config`` writes back what each package
    writes (the master entry survives a World without a local engine)."""
    out = {}
    for name, pkg in PACKAGES.items():
        path = str(tmp_path / f"{name}.json")
        world = pkg[4].World.from_config(full_config(pkg[1]), path)
        world.save_config()
        with open(path) as f:
            out[name] = json.load(f)
    assert out["port"] == out["jax"]
    assert list(out["port"]["workers"][0]) == ["master"]


# -- cluster operations ------------------------------------------------------

def test_cluster_operations_match_jax(tmp_path):
    """ping (a dead worker demoted, a pin checked against the model list),
    restart, interrupt, live worker edits and scheduler settings, and what
    each package then writes to its config file."""
    out = {}
    for name, pkg in PACKAGES.items():
        _, config_mod, _, wmod, world_mod = pkg
        path = str(tmp_path / f"{name}.json")
        world = world_mod.World(config_mod.ConfigModel(), path)
        world.add_worker(wmod.WorkerNode("m", wmod.StubBackend(),
                                         master=True, avg_ipm=9.0))
        world.add_worker(wmod.WorkerNode(
            "dead", wmod.StubBackend(wmod.StubBehavior(fail_reachable=True)),
            avg_ipm=3.0))
        pinned = world.add_worker(wmod.WorkerNode(
            "pinned", wmod.StubBackend(), avg_ipm=4.0,
            model_override="not-there"))
        steps = {"ping": world.ping_workers()}
        steps["pin"] = (pinned.pin_validated, pinned._pin_refuted)
        steps["restart"] = world.restart_all()
        # restarted: UNAVAILABLE until a ping; then one in flight
        steps["after_restart"] = pinned.state.name
        pinned.set_state(wmod.State.IDLE)
        pinned.set_state(wmod.State.WORKING)
        world.interrupt_all()
        deadline = time.monotonic() + 10
        while not pinned.backend.interrupted and time.monotonic() < deadline:
            time.sleep(0.01)
        steps["interrupted"] = pinned.backend.interrupted
        world.add_remote_worker("r", "10.0.0.3", 7862, user="u",
                                password="p", pixel_cap=-5)
        with pytest.raises(ValueError):
            world.add_remote_worker("r", "10.0.0.4", 7862)
        steps["edit"] = [
            world.update_worker_endpoint("r", port=7870, password=""),
            world.update_worker_endpoint("nobody", port=1)]
        with pytest.raises(ValueError):
            world.update_worker_endpoint("m", port=1)
        steps["configure"] = [
            world.configure_worker("dead", disabled=True, pixel_cap=7),
            world.configure_worker("pinned", model_override=""),
            world.configure_worker("nobody", pixel_cap=1)]
        steps["settings"] = world.apply_settings(
            {"job_timeout": 11, "step_scaling": True,
             "complement_production": None, "bogus": 1})
        steps["remove"] = world.remove_worker("r")
        with pytest.raises(ValueError):
            world.remove_worker("m")
        steps["health"] = {
            label: {k: v for k, v in h.items() if k != "transitions"}
            for label, h in world.health_summary().items()}
        with open(path) as f:
            steps["config"] = json.load(f)
        out[name] = steps
    assert out["port"] == out["jax"]
    assert out["port"]["ping"] == {"m": True, "dead": False, "pinned": True}
    assert out["port"]["interrupted"] is True
    # an UNAVAILABLE worker cannot be disabled (the transition table)
    assert out["port"]["health"]["dead"]["state"] == "UNAVAILABLE"


# -- the port's daemons ------------------------------------------------------

def test_interrupt_watch_aborts_an_in_flight_remote_and_skips_requeue():
    """The process-wide latch set mid-request reaches the remote through
    the in-flight watch; an interrupted range is not requeued."""
    from stable_diffusion_webui_distributed_tpu_torch.runtime import (
        interrupt as interrupt_mod,
    )

    world = pworld.World()
    world.add_worker(pworker.WorkerNode("m", pworker.StubBackend(),
                                        master=True, avg_ipm=10.0))
    slow = pworker.WorkerNode("slow", pworker.StubBackend(
        pworker.StubBehavior(seconds_per_image=0.5)), avg_ipm=10.0)
    slow.interrupt_poll_s = 0.05
    world.add_worker(slow)
    out = {}
    thread = threading.Thread(
        target=lambda: out.setdefault("r", world.execute(
            PPayload(prompt="p", seed=100, batch_size=8))))
    thread.start()
    try:
        time.sleep(0.3)
        interrupt_mod.STATE.flag.interrupt()
        thread.join(timeout=30)
    finally:
        interrupt_mod.STATE.begin_request()
    assert not thread.is_alive()
    assert slow.backend.interrupted
    r = out["r"]
    assert r.seeds[:4] == [100, 101, 102, 103]  # the master's range
    assert len(r.seeds) < 8 and r.worker_labels.count("m") == 4
    assert len(world.get_worker("m").backend.requests) == 1  # no requeue


def test_heartbeat_revives_an_unavailable_worker(monkeypatch):
    monkeypatch.setenv("SDTPU_HEARTBEAT_S", "0.05")
    world = pworld.World()
    node = world.add_worker(pworker.WorkerNode("w", pworker.StubBackend(),
                                               avg_ipm=1.0))
    node.set_state(pworker.State.UNAVAILABLE)
    try:
        assert world.start_heartbeat() is world._heartbeat is not None
        deadline = time.monotonic() + 10
        while node.current_state() != pworker.State.IDLE \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        assert node.current_state() == pworker.State.IDLE
        assert node.supported_scripts == ["controlnet"]
    finally:
        beat = world._heartbeat
        world.stop_heartbeat()
    assert world._heartbeat is None and not beat._thread.is_alive()
