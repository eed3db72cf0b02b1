"""The port's alert engine (``obs/alerts.py``) and notifier
(``obs/notify.py``) against the JAX package's on the CPU.

The registry is the JAX package's nine rules, field for field. The same
synthetic series, made from a seeded numpy stream and fed tick by tick
into a TSDB store of each package, give each engine the same sequence of
(rule, from, to, tick, value, detail) transitions under the same explicit
clock (``SDTPU_ALERT_TIMESCALE`` compresses the windows to seconds), with
every rule firing and resolving. A transition journals, counts
``sdtpu_alerts_total``, sets ``sdtpu_alert_state`` and, firing, lands a
flight-recorder entry carrying the TSDB window. The notifier routes the
same route strings to the same channels; against a webhook that fails
twice both packages make the same attempts with the same outcomes and
POST the same documents apart from their timestamps; dedup, drops and the
gate behave alike.
"""

import json
import threading
import urllib.request

import numpy as np
import pytest

from stable_diffusion_webui_distributed_tpu.obs import alerts as j_alerts
from stable_diffusion_webui_distributed_tpu.obs import notify as j_notify
from stable_diffusion_webui_distributed_tpu.obs import (
    prometheus as j_prom,
)
from stable_diffusion_webui_distributed_tpu.obs import tsdb as j_tsdb
from stable_diffusion_webui_distributed_tpu_torch.obs import alerts as t_alerts
from stable_diffusion_webui_distributed_tpu_torch.obs import (
    flightrec as t_flightrec,
)
from stable_diffusion_webui_distributed_tpu_torch.obs import (
    journal as t_journal,
)
from stable_diffusion_webui_distributed_tpu_torch.obs import notify as t_notify
from stable_diffusion_webui_distributed_tpu_torch.obs import (
    prometheus as t_prom,
)
from stable_diffusion_webui_distributed_tpu_torch.obs import tsdb as t_tsdb
from stable_diffusion_webui_distributed_tpu_torch.fleet import (
    slices as t_slices,
)

GATES = ("SDTPU_TSDB", "SDTPU_ALERTS", "SDTPU_ALERT_TIMESCALE",
         "SDTPU_NOTIFY_URL", "SDTPU_NOTIFY_ROUTES", "SDTPU_NOTIFY_DEDUP_S",
         "SDTPU_JOURNAL", "SDTPU_FEDERATION")


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    for name in GATES:
        monkeypatch.delenv(name, raising=False)
    for mod in (t_alerts, j_alerts, t_notify, j_notify, t_tsdb, j_tsdb):
        mod.reset()
    t_prom.clear_histograms()
    j_prom.clear_histograms()
    t_journal.JOURNAL.clear()
    t_flightrec.RECORDER.clear()
    yield
    for mod in (t_alerts, j_alerts, t_notify, j_notify, t_tsdb, j_tsdb):
        mod.reset()
    t_journal.JOURNAL.clear()
    t_flightrec.RECORDER.clear()


def test_registry_is_the_jax_packages():
    import dataclasses

    a = {n: dataclasses.asdict(r) for n, r in
         j_alerts.registered_rules().items()}
    b = {n: dataclasses.asdict(r) for n, r in
         t_alerts.registered_rules().items()}
    assert a == b and len(b) == 9
    assert list(a) == list(b)
    with pytest.raises(ValueError):
        t_alerts.register_rule(t_alerts.AlertRule(
            name="watchdog_stall", kind="increase", series="x",
            description=""))
    with pytest.raises(ValueError):
        t_alerts.AlertRule(name="x", kind="increase", series="x",
                           description="", severity="critical")


def scenario(seed):
    """Per tick, the samples of every series the nine rules read: a quiet
    baseline with seeded noise, one episode per rule, then quiet again."""
    rng = np.random.default_rng(seed)
    ticks = []
    stalls = flaps = stale = failures = compiles = 0.0
    for i in range(120):
        noise = float(rng.normal(0.0, 0.01))
        episode = 40 <= i < 52
        burn = 100.0 if 30 <= i < 70 else abs(noise)
        # the anomaly rules need a sustained run-away (z >= 6 against an
        # EWMA that follows): tenfold a tick
        qw = 0.3 * 10.0 ** (i - 43) if 44 <= i < 48 else 0.3 + noise
        if episode and i % 3 == 0:
            stalls += 1
            flaps += 1
        if i in (60, 61):
            stale += 1
        if i == 80:
            failures += 1
        if 90 <= i < 93:
            compiles += 10.0 ** (i - 89)
        err = 1.0 if i == 100 else 0.0
        ticks.append({"slo_burn.acme.interactive": burn,
                      "queue_wait_p95_s": qw,
                      "watchdog_stalls_total": stalls,
                      "worker_unavailable_total": flaps,
                      "fleet/worker_stale_count": stale,
                      "worker_failures_total": failures,
                      "compiles_total": compiles,
                      "fleet/error_rate": err})
    return ticks


@pytest.mark.parametrize("seed", [0, 7])
def test_transitions_match_for_all_nine_rules(seed, monkeypatch):
    monkeypatch.setenv("SDTPU_ALERTS", "1")
    monkeypatch.setenv("SDTPU_ALERT_TIMESCALE", "0.01")
    stores = (j_tsdb.SeriesStore(), t_tsdb.SeriesStore())
    engines = (j_alerts.AlertEngine(store=stores[0]),
               t_alerts.AlertEngine(store=stores[1]))
    seen = ([], [])
    for i, samples in enumerate(scenario(seed)):
        now = 1000.0 + i
        for k, (store, engine) in enumerate(zip(stores, engines)):
            for name, value in samples.items():
                store.record(name, value, t=now)
            seen[k].extend((e["rule"], e["from"], e["to"], i, e["value"],
                            e["detail"]) for e in engine.evaluate(now=now))
    assert seen[0] == seen[1]
    fired = {r for r, _, to, *_ in seen[1] if to == "firing"}
    resolved = {r for r, frm, to, *_ in seen[1]
                if frm == "firing" and to == "ok"}
    assert fired == resolved == set(t_alerts.registered_rules())
    a, b = engines[0].state(), engines[1].state()
    assert a == b
    assert engines[1].firing() == [] and engines[1].scale_up_firing() == []


def test_pending_clears_and_scale_up_view(monkeypatch):
    monkeypatch.setenv("SDTPU_ALERTS", "1")
    store = t_tsdb.SeriesStore()
    engine = t_alerts.AlertEngine(store=store)
    for i in range(8):
        store.record("queue_wait_p95_s", 0.3, t=float(i))
        engine.evaluate(now=float(i))
    # one spike pends and clears
    store.record("queue_wait_p95_s", 9.0, t=8.0)
    assert [e["to"] for e in engine.evaluate(now=8.0)] == ["pending"]
    store.record("queue_wait_p95_s", 0.3, t=9.0)
    assert [e["to"] for e in engine.evaluate(now=9.0)] == ["ok"]
    for i in range(10, 13):  # a run-away latches
        store.record("queue_wait_p95_s", 0.3 * 10.0 ** (i - 8), t=float(i))
        engine.evaluate(now=float(i))
    assert engine.firing() == ["queue_wait_anomaly"]
    assert engine.scale_up_firing() == ["queue_wait_anomaly"]
    # the autoscaler's default alert feed reads the process engine
    t_alerts.ENGINE = engine
    assert t_slices._default_alert_source() == ["queue_wait_anomaly"]
    monkeypatch.delenv("SDTPU_ALERTS")
    assert t_slices._default_alert_source() == []
    assert t_alerts.evaluate() == [] and t_alerts.firing() == []
    assert t_alerts.state_snapshot() is None


def test_firing_side_effects(monkeypatch):
    for gate in ("SDTPU_ALERTS", "SDTPU_TSDB", "SDTPU_JOURNAL"):
        monkeypatch.setenv(gate, "1")
    monkeypatch.setenv("SDTPU_ALERT_TIMESCALE", "0.01")
    engine = t_alerts.ENGINE  # the flight recorder reads its state
    t_tsdb.STORE.record("watchdog_stalls_total", 0.0, t=10.0)
    t_tsdb.STORE.record("watchdog_stalls_total", 1.0, t=11.0)
    out = engine.evaluate(now=11.0)
    assert [(e["rule"], e["to"]) for e in out] == [("watchdog_stall",
                                                    "firing")]
    for t in (15.0, 16.0):
        t_tsdb.STORE.record("watchdog_stalls_total", 1.0, t=t)
    out = engine.evaluate(now=16.0)
    assert [(e["rule"], e["from"], e["to"]) for e in out] == [
        ("watchdog_stall", "firing", "ok")]
    events = [(e["event"], e["attrs"]["rule"], e["attrs"]["severity"])
              for e in t_journal.JOURNAL.snapshot()["events"]]
    assert events == [("alert_firing", "watchdog_stall", "page"),
                      ("alert_resolved", "watchdog_stall", "page")]
    assert t_prom.ALERT_COUNTER.value(rule="watchdog_stall",
                                      state="firing") == 1.0
    assert t_prom.ALERT_COUNTER.value(rule="watchdog_stall",
                                      state="resolved") == 1.0
    text = t_prom.render()
    assert 'sdtpu_alerts_total{rule="watchdog_stall",state="firing"} 1' \
        in text
    assert 'sdtpu_alert_state{rule="watchdog_stall"} 0' in text
    entries = t_flightrec.RECORDER.dump()["entries"]
    assert [e["reason"] for e in entries] == ["alert_firing"]
    entry = entries[0]
    assert entry["request_id"] == "alert-watchdog_stall"
    assert "watchdog_stalls_total" in entry["tsdb"]["series"]
    assert entry["alerts"]["rules"]["watchdog_stall"]["state"] == "firing"


def test_summary_keys_match(monkeypatch):
    for on in (False, True):
        if on:
            monkeypatch.setenv("SDTPU_ALERTS", "1")
        a, b = j_alerts.summary(), t_alerts.summary()
        assert set(a) == set(b)
        assert a["registered"] == b["registered"]
        assert set(a["rules"]) == set(b["rules"])
        for name in a["rules"]:
            assert set(a["rules"][name]) == set(b["rules"][name])
        assert b["enabled"] is on


# -- notify --------------------------------------------------------------------

ROUTES = [
    ("", "", "page", None),
    ("http://h/default", "", "warn", None),
    ("http://h/default", "page=http://h/p,warn=http://h/w", "page", None),
    ("http://h/default", "page=http://h/p,warn=http://h/w", "info", None),
    ("", "page=http://h/p,acme:page=http://h/acme", "page", "acme"),
    ("", "page=http://h/p,acme:page=http://h/acme", "page", "other"),
    ("", "page=http://h/p,acme:page=http://h/acme", "warn", "acme"),
    ("", " , =x,page=,junk,warn = http://h/w ", "warn", None),
]


@pytest.mark.parametrize("url,routes,severity,tenant", ROUTES)
def test_channel_for_matches(url, routes, severity, tenant, monkeypatch):
    monkeypatch.setenv("SDTPU_NOTIFY_URL", url)
    monkeypatch.setenv("SDTPU_NOTIFY_ROUTES", routes)
    assert j_notify.routes() == t_notify.routes()
    assert j_notify.channel_for(severity, tenant) == \
        t_notify.channel_for(severity, tenant)
    assert j_notify.enabled() == t_notify.enabled()


class FakeWebhook:
    """``urllib.request.urlopen`` that fails its first ``fail`` calls and
    records every attempt's URL and document."""

    def __init__(self, fail):
        self.fail = fail
        self.calls = []

    def __call__(self, req, timeout=None):
        doc = json.loads(req.data.decode())
        self.calls.append((req.full_url, doc, timeout))
        if len(self.calls) <= self.fail:
            raise OSError("webhook down")

        class Resp:
            status = 200

            def __enter__(self):
                return self

            def __exit__(self, *a):
                return False

        return Resp()


def drive_notifier(pkg, fail, monkeypatch):
    hook = FakeWebhook(fail)
    monkeypatch.setattr(urllib.request, "urlopen", hook)
    monkeypatch.setattr(pkg, "_BACKOFF_BASE_S", 0.001)
    notifier = pkg.Notifier()
    accepted = [
        notifier.notify_transition("watchdog_stall", "alert_firing", 1.0,
                                   "stalled", severity="page"),
        notifier.notify_transition("watchdog_stall", "alert_firing", 1.0,
                                   "stalled again", severity="page"),
        notifier.notify_transition("worker_flap", "alert_firing", 2.0,
                                   "flap", severity="warn",
                                   tenant="acme"),
    ]
    assert notifier.flush(10.0)
    notifier.stop()
    docs = [(url, {k: v for k, v in doc.items() if k != "ts"}, timeout)
            for url, doc, timeout in hook.calls]
    assert all("ts" in doc for _, doc, _ in hook.calls)
    summary = notifier.summary()
    summary.pop("draining")
    return accepted, docs, notifier.counts(), \
        notifier.counts_by_channel(), summary


@pytest.mark.parametrize("fail", [0, 2, 5])
def test_delivery_attempts_and_documents_match(fail, monkeypatch):
    monkeypatch.setenv("SDTPU_NOTIFY_URL", "http://127.0.0.1:9/hook")
    monkeypatch.setenv("SDTPU_NOTIFY_ROUTES", "warn=http://127.0.0.1:9/w")
    monkeypatch.setenv("SDTPU_JOURNAL", "1")
    a = drive_notifier(j_notify, fail, monkeypatch)
    t_journal.JOURNAL.clear()
    b = drive_notifier(t_notify, fail, monkeypatch)
    assert a == b
    accepted, docs, counts, _, summary = b
    assert accepted == [True, False, True]  # the repeat is deduped
    assert counts["deduped"] == 1
    assert docs[0][1] == {"rule": "watchdog_stall", "event": "alert_firing",
                          "value": 1.0, "detail": "stalled",
                          "severity": "page", "channel": "default"}
    journal = [(e["event"], e["attrs"]["rule"], e["attrs"]["attempts"])
               for e in t_journal.JOURNAL.snapshot()["events"]]
    outcome = "notify_sent" if fail < 3 else "notify_failed"
    assert journal[0] == (outcome, "watchdog_stall", min(fail + 1, 3))
    assert t_prom.NOTIFY_COUNTER.value(
        channel="default",
        outcome="sent" if fail < 3 else "failed") >= 1.0


def test_overflow_drops_and_journals(monkeypatch):
    monkeypatch.setenv("SDTPU_NOTIFY_URL", "http://127.0.0.1:9/hook")
    monkeypatch.setenv("SDTPU_JOURNAL", "1")
    out = []
    for pkg in (j_notify, t_notify):
        monkeypatch.setattr(pkg, "_MAX_QUEUE", 0)
        notifier = pkg.Notifier()
        out.append((notifier.notify_transition(
            "watchdog_stall", "alert_firing", 1.0, "x", severity="page"),
            notifier.counts(), notifier.summary()["dropped"],
            notifier.summary()["draining"]))
        notifier.stop()
    assert out[0] == out[1] == (False, {"dropped": 1}, 1, False)
    assert [e["event"] for e in t_journal.JOURNAL.snapshot()["events"]] == \
        ["notify_dropped"]


def test_gate_off_queues_nothing_and_starts_no_thread():
    before = {t.name for t in threading.enumerate()}
    assert t_notify.notify_transition("watchdog_stall", "alert_firing", 1.0,
                                      "x", severity="page") is False
    s = t_notify.summary()
    assert s["enabled"] is False and s["queued"] == 0 \
        and s["draining"] is False
    assert set(s) == set(j_notify.summary())
    assert "sdtpu-notify-drain" not in \
        {t.name for t in threading.enumerate()} - before
