"""The port's TSDB (``obs/tsdb.py``) against the JAX package's on the CPU.

The same records, made from a seeded numpy stream with explicit times, go
into a ``SeriesStore`` of each package: ``rate``, ``increase``,
``avg_over_time`` and ``quantile_over_time`` agree within 1e-12 over
several windows, and so do the snapshots and the rank-interpolated
histogram quantile. A snapshot file written by either package loads into
the other's store. The sampler reads the port's own sources (the
exposition's histograms and counters, the serving metrics' captures, the
perf ledger's SLO rows), ``tick`` is 0 with the gate off, the daemon
starts and stops, the flight recorder's window is bounded, and on the CPU
no ``hbm_*`` series appears (a stubbed allocator read lands them, with
the gate on only).
"""

import json
import time

import numpy as np
import pytest

from stable_diffusion_webui_distributed_tpu.obs import (
    prometheus as j_prom,
)
from stable_diffusion_webui_distributed_tpu.obs import tsdb as j_tsdb
from stable_diffusion_webui_distributed_tpu_torch.obs import (
    prometheus as t_prom,
)
from stable_diffusion_webui_distributed_tpu_torch.obs import perf as t_perf
from stable_diffusion_webui_distributed_tpu_torch.obs import tsdb as t_tsdb
from stable_diffusion_webui_distributed_tpu_torch.serving.metrics import (
    METRICS,
)

TOL = 1e-12
WINDOWS = (0.0, 0.5, 3.0, 10.0, 100.0)
QUANTILES = (0.0, 0.25, 0.5, 0.95, 1.0)


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    for name in ("SDTPU_TSDB", "SDTPU_ALERTS", "SDTPU_TSDB_DIR",
                 "SDTPU_TSDB_POINTS", "SDTPU_TSDB_INTERVAL_S"):
        monkeypatch.delenv(name, raising=False)
    t_tsdb.reset()
    j_tsdb.reset()
    yield
    t_tsdb.reset()
    j_tsdb.reset()


def fill(seed, points=64):
    """The same records in a store of each package: three series of
    monotonic times and seeded values, one a counter."""
    rng = np.random.default_rng(seed)
    stores = (j_tsdb.SeriesStore(points=points),
              t_tsdb.SeriesStore(points=points))
    t = 1000.0
    counter = 0.0
    for _ in range(96):
        t += float(rng.uniform(0.05, 0.4))
        counter += float(rng.integers(0, 4))
        gauge = float(rng.standard_normal())
        for s in stores:
            s.record("requests_total", counter, t=t)
            s.record("queue_wait_p95_s", abs(gauge), t=t)
        spike = float(rng.exponential())
        for s in stores:
            s.record("slo_burn.t.c", spike, t=t)
    return stores, t


def close(a, b):
    if a is None or b is None:
        return a is None and b is None
    return abs(a - b) <= TOL * max(1.0, abs(a), abs(b))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_store_queries_match(seed):
    (js, ts), now = fill(seed)
    for name in ("requests_total", "queue_wait_p95_s", "slo_burn.t.c",
                 "absent"):
        for w in WINDOWS:
            for fn in ("rate", "increase", "avg_over_time"):
                a = getattr(js, fn)(name, w, now=now)
                b = getattr(ts, fn)(name, w, now=now)
                assert close(a, b), (name, w, fn, a, b)
            for q in QUANTILES:
                a = js.quantile_over_time(name, q, w, now=now)
                b = ts.quantile_over_time(name, q, w, now=now)
                assert close(a, b), (name, w, q, a, b)
            assert js.window(name, w, now=now) == ts.window(name, w, now=now)
        assert js.latest(name) == ts.latest(name)
    assert js.snapshot() == ts.snapshot()
    assert js.snapshot(max_points=5, names=["slo_burn.t.c"]) == \
        ts.snapshot(max_points=5, names=["slo_burn.t.c"])
    assert js.stats() == ts.stats()
    assert js.names() == ts.names()


@pytest.mark.parametrize("q", [0.5, 0.95, 0.99])
def test_histogram_quantile_matches(q):
    rng = np.random.default_rng(int(q * 100))
    bounds = t_prom.BUCKETS
    for _ in range(8):
        counts = [int(c) for c in rng.integers(0, 5, len(bounds) + 1)]
        n = sum(counts)
        assert close(j_tsdb.quantile_from_counts(bounds, counts, n, q),
                     t_tsdb.quantile_from_counts(bounds, counts, n, q))
    assert t_tsdb.quantile_from_counts(bounds, [0] * 17, 0, q) == 0.0


def test_store_bounds_and_garbage_match():
    stores = (j_tsdb.SeriesStore(points=8), t_tsdb.SeriesStore(points=8))
    for s in stores:
        for i in range(20):
            s.record("a", i, t=float(i))
        s.record("a", "not a number", t=21.0)
        s.record("a", None, t=22.0)
        for i in range(300):
            s.record(f"tenant{i}", 1.0, t=1.0)
    assert stores[0].snapshot() == stores[1].snapshot()
    assert stores[0].stats() == stores[1].stats()
    assert stores[1].stats()["dropped_series"] == 300 - 255
    garbage = [None, [], {"series": 3},
               {"series": {"x": [[1.0, "v"], ["t"], [2.0, 3.0],
                                 [1e18, 1.0]], "y": "bad"}}]
    for doc in garbage:
        fresh = (j_tsdb.SeriesStore(points=8), t_tsdb.SeriesStore(points=8))
        assert fresh[0].load_merge(doc) == fresh[1].load_merge(doc)
        assert fresh[0].snapshot() == fresh[1].snapshot()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_snapshot_files_load_across_packages(writer, tmp_path):
    (js, ts), _ = fill(3, points=32)
    src, dst = (js, t_tsdb) if writer == "jax" else (ts, j_tsdb)
    save = j_tsdb.save_snapshot if writer == "jax" else t_tsdb.save_snapshot
    path = str(tmp_path / "snap.json")
    assert save(src, path=path)
    doc = json.loads(open(path).read())
    assert doc["schema"] == 1 and set(doc) == {
        "schema", "points", "saved_t_mono", "series"}
    other = dst.SeriesStore(points=32)
    assert dst.load_snapshot(other, path=path) == sum(
        len(v) for v in doc["series"].values())
    assert other.snapshot() == src.snapshot()


def test_snapshot_dir_knob_and_reset_restart(tmp_path, monkeypatch):
    assert not t_tsdb.save_snapshot()
    assert t_tsdb.load_snapshot() == 0
    monkeypatch.setenv("SDTPU_TSDB", "1")
    monkeypatch.setenv("SDTPU_TSDB_DIR", str(tmp_path))
    t_tsdb.STORE.record("watchdog_stalls_total", 2.0)
    assert t_tsdb.save_snapshot()
    t_tsdb.reset()  # a restart: the history comes back
    assert t_tsdb.STORE.latest("watchdog_stalls_total")[1] == 2.0
    (tmp_path / t_tsdb.SNAPSHOT_BASENAME).write_text("{truncated")
    assert t_tsdb.load_snapshot() == 0


def test_tick_gate_and_summary_keys(monkeypatch):
    assert t_tsdb.tick() == 0 and j_tsdb.tick() == 0
    assert not t_tsdb.start_daemon()
    off = (j_tsdb.summary(), t_tsdb.summary())
    assert set(off[0]) == set(off[1]) and off[1]["enabled"] is False
    assert t_tsdb.flight_window() is None
    monkeypatch.setenv("SDTPU_TSDB", "1")
    assert t_tsdb.tick() > 0 and j_tsdb.tick() > 0
    on = (j_tsdb.summary(), t_tsdb.summary())
    assert set(on[0]) == set(on[1]) and on[1]["enabled"] is True
    assert {k: v for k, v in on[1].items() if k != "series"} == {
        "enabled": True, "interval_s": 1.0, "points": 512,
        "daemon": False, "series_count": on[1]["series_count"],
        "samples_total": on[1]["samples_total"], "dropped_series": 0}


def test_sample_once_reads_the_ports_sources(monkeypatch):
    t_prom.clear_histograms()
    j_prom.clear_histograms()
    METRICS.clear()
    t_perf.LEDGER.clear()
    for prom in (t_prom, j_prom):
        for v in (0.02, 0.3, 0.3, 2.0):
            prom.HISTOGRAMS["queue_wait"].observe(v)
            prom.HISTOGRAMS["e2e"].observe(v * 3)
        prom.worker_count("failures", worker="remote")
        prom.worker_count("transitions", worker="remote", to="UNAVAILABLE")
        prom.worker_count("transitions", worker="remote", to="IDLE")
        prom.count_watchdog_stall("job-remote")
    METRICS.record_compile("unet")
    METRICS.record_compile("deep")
    stores = (j_tsdb.SeriesStore(), t_tsdb.SeriesStore())
    for s in stores:
        s.sample_once(now=5.0)
    snap = stores[1].snapshot()
    latest = {k: v["latest"][1] for k, v in snap.items()}
    for name in ("queue_wait_p95_s", "e2e_p95_s", "worker_failures_total",
                 "worker_unavailable_total", "watchdog_stalls_total"):
        assert close(latest[name], stores[0].latest(name)[1]), name
    assert latest["worker_failures_total"] == 1.0
    assert latest["worker_unavailable_total"] == 1.0
    assert latest["watchdog_stalls_total"] == 1.0
    assert latest["compiles_total"] == 2.0
    assert latest["requests_total"] == 0.0
    # no card: no device-memory series, never a made-up number
    assert not [k for k in snap if k.startswith("hbm_")
                or k == "device_live_buffers"]
    t_prom.clear_histograms()
    j_prom.clear_histograms()
    METRICS.clear()


def test_slo_rows_become_burn_series():
    t_perf.LEDGER.clear()
    store = t_tsdb.SeriesStore()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SDTPU_PERF", "1")
        for met in (True, False, False):
            t_perf.LEDGER.record_slo(tenant="acme", cls="interactive",
                                     slo_s=1.0,
                                     latency_s=0.5 if met else 2.0)
    store.sample_once(now=1.0)
    names = store.names()
    assert "slo_attainment.acme.interactive" in names
    assert "slo_burn.acme.interactive" in names
    assert store.latest("slo_burn_worst")[1] == \
        store.latest("slo_burn.acme.interactive")[1] > 0
    t_perf.LEDGER.clear()


def test_device_memory_series_with_a_stubbed_allocator(monkeypatch):
    stats = {"allocated_bytes.all.current": 123,
             "allocated_bytes.all.peak": 456,
             "allocation.all.allocated": 7, "active.all.current": 3}
    monkeypatch.setattr(t_tsdb, "_cuda_stats", lambda: dict(stats))
    mem = t_tsdb.dispatch_memory_sample()
    assert mem == {"bytes_in_use": 123, "peak_bytes_in_use": 456,
                   "num_allocs": 7, "live_buffers": 3}
    assert t_tsdb.STORE.names() == []  # the gate is off
    monkeypatch.setenv("SDTPU_TSDB", "1")
    t_tsdb.dispatch_memory_sample()
    assert t_tsdb.STORE.latest("hbm_bytes_in_use")[1] == 123
    assert t_tsdb.STORE.latest("hbm_peak_bytes")[1] == 456
    assert t_tsdb.STORE.latest("device_live_buffers")[1] == 3
    store = t_tsdb.SeriesStore()
    store.sample_once(now=2.0)
    assert store.latest("hbm_bytes_in_use") == (2.0, 123.0)
    window = t_tsdb.flight_window()
    assert set(window["series"]) == {"hbm_bytes_in_use", "hbm_peak_bytes"}


def test_cpu_device_readers_are_none():
    assert t_tsdb.device_memory_stats() is None
    assert t_tsdb.live_buffer_count() is None
    assert t_tsdb.dispatch_memory_sample() is None


def test_daemon_starts_samples_and_stops(monkeypatch):
    monkeypatch.setenv("SDTPU_TSDB", "1")
    monkeypatch.setenv("SDTPU_TSDB_INTERVAL_S", "0.01")
    monkeypatch.setenv("SDTPU_TSDB_POINTS", "16")
    t_tsdb.reset()
    assert t_tsdb.STORE.points == 16
    assert t_tsdb.start_daemon() and t_tsdb.start_daemon()
    assert t_tsdb.summary()["daemon"] is True
    deadline = time.monotonic() + 5.0
    while t_tsdb.STORE.stats()["samples_total"] == 0 \
            and time.monotonic() < deadline:
        time.sleep(0.01)
    t_tsdb.stop_daemon()
    assert t_tsdb.summary()["daemon"] is False
    assert t_tsdb.STORE.stats()["samples_total"] > 0


def test_flight_window_is_bounded_and_filtered(monkeypatch):
    monkeypatch.setenv("SDTPU_TSDB", "1")
    for i in range(100):
        t_tsdb.STORE.record("watchdog_stalls_total", i, t=float(i))
        t_tsdb.STORE.record("slo_burn.a.b", i, t=float(i))
        t_tsdb.STORE.record("requests_total", i, t=float(i))
    window = t_tsdb.flight_window()
    assert set(window["series"]) == {"watchdog_stalls_total", "slo_burn.a.b"}
    assert window["series"]["watchdog_stalls_total"]["count"] == 64
