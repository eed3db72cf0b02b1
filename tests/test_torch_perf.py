"""The port's perf ledger (``obs/perf.py``), FLOP pricer
(``pipeline/stepcache.py`` ``FlopsAccountant``), Prometheus exposition
(``obs/prometheus.py``) and device readers (``obs/tsdb.py``) against the
JAX package's, on TINY on the CPU.

- The same ``record_dispatch`` / ``record_stages`` / ``record_slo`` /
  ``record_compile`` sequence under ``SDTPU_PERF_PEAK_FLOPS`` gives equal
  summaries (integers exact, floats within 1e-12 relative) apart from
  ``device_kind`` and the JAX package's AOT-load keys, which the port has
  no artifact store for; ``peak_flops_for`` gives the H100 rows, twice
  them at int8, and None for an unknown card or the CPU.
- The pricer's count of one TINY UNet evaluation at 2 rows equals the JAX
  UNet's matrix products and convolutions within 1e-6 relative, counted
  as 2 x multiply-adds from the ``dot_general`` and
  ``conv_general_dilated`` equations of its jaxpr: the whole forward and
  the step cache's deep and reuse modes; a range priced through
  ``plan_schedule`` is the sum of its evaluations.
- The same observe and count calls into both packages render the same
  exposition lines for every family both register, after sorting; the
  families left to the next slice and the help texts that name the JAX
  package's XLA mechanisms are listed by name.
- With ``SDTPU_PERF``, ``SDTPU_OBS`` and the watchdog on, the port's PNG
  bytes equal its bytes with them off (coalesced and solo dispatches).
- The device readers give None on the CPU; the attention wrappers answer
  a meta tensor with the plain version's shape and count no launch.
"""

import math
import re
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.extend.core as jcore
import jax.numpy as jnp

from stable_diffusion_webui_distributed_tpu.models import unet as junet
from stable_diffusion_webui_distributed_tpu.models.configs import TINY as JTINY
from stable_diffusion_webui_distributed_tpu.models.prompt import (
    true_token_count as jax_true_token_count,
)
from stable_diffusion_webui_distributed_tpu.obs import perf as jperf
from stable_diffusion_webui_distributed_tpu.obs import prometheus as jprom
from stable_diffusion_webui_distributed_tpu.pipeline.engine import (
    Engine as JaxEngine,
)
from stable_diffusion_webui_distributed_tpu.pipeline.payload import (
    GenerationPayload as JaxPayload,
)
from stable_diffusion_webui_distributed_tpu.runtime import trace as jtrace
from stable_diffusion_webui_distributed_tpu.runtime.interrupt import (
    GenerationState as JaxState,
)
from stable_diffusion_webui_distributed_tpu.serving.metrics import (
    METRICS as JAX_METRICS,
)
from stable_diffusion_webui_distributed_tpu_torch import bridge
from stable_diffusion_webui_distributed_tpu_torch.models.configs import TINY
from stable_diffusion_webui_distributed_tpu_torch.models.prompt import (
    true_token_count,
)
from stable_diffusion_webui_distributed_tpu_torch.obs import perf
from stable_diffusion_webui_distributed_tpu_torch.obs import prometheus
from stable_diffusion_webui_distributed_tpu_torch.obs import spans
from stable_diffusion_webui_distributed_tpu_torch.obs import tsdb
from stable_diffusion_webui_distributed_tpu_torch.ops import (
    flash_attention as fa,
)
from stable_diffusion_webui_distributed_tpu_torch.ops import (
    ragged_attention as ra,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline import stepcache
from stable_diffusion_webui_distributed_tpu_torch.pipeline.engine import Engine
from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    GenerationPayload,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime import trace
from stable_diffusion_webui_distributed_tpu_torch.runtime.interrupt import (
    GenerationState,
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
from test_pipeline import init_params

#: the JAX ledger's summary keys the port leaves out: its artifacts are
#: per-signature executables, the port's kernel libraries, which the
#: ledger does not count (``DispatchMetrics.aot_loads`` does)
JAX_ONLY_SUMMARY = {"aot_loads", "aot_hit_rate"}
#: families of modules left to later slices (JAX only): the scenario
#: scorer's
JAX_ONLY_FAMILIES = {"sdtpu_sim_slo_burn"}
#: help texts that name the JAX package's mechanisms (XLA builds, cost
#: analysis, host-observed dispatch seconds, the AOT store)
HELP_DIFFERS = {"sdtpu_compile_seconds", "sdtpu_stage_compiles_total",
                "sdtpu_stage_cache_hits_total",
                "sdtpu_serving_unet_flops_total", "sdtpu_perf_flops_total",
                "sdtpu_perf_device_seconds_total",
                "sdtpu_cold_start_seconds"}
TOL = 1e-12


@pytest.fixture(scope="module")
def params():
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(lambda: init_params(JTINY))
    return jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.05).astype(s.dtype),
        shapes)


@pytest.fixture(scope="module")
def engine(params):
    return Engine(TINY, bridge.flax_to_torch(TINY, params), chunk_size=2,
                  state=GenerationState(), device="cpu")


@pytest.fixture(scope="module")
def jax_engine(params):
    return JaxEngine(JTINY, params, chunk_size=2, state=JaxState())


@pytest.fixture
def perf_on(monkeypatch):
    monkeypatch.setenv("SDTPU_PERF", "1")
    monkeypatch.setenv("SDTPU_PERF_PEAK_FLOPS", "1e12")
    for mod in (perf, jperf):
        mod.LEDGER.clear()
    yield
    for mod in (perf, jperf):
        mod.LEDGER.clear()


def close(a, b):
    """Equal with floats within TOL relative, recursively."""
    if isinstance(a, dict):
        return set(a) == set(b) and all(close(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(close(x, y) for x, y in zip(a, b))
    if isinstance(a, float) or isinstance(b, float):
        if a is None or b is None:
            return a is b
        return math.isclose(a, b, rel_tol=TOL, abs_tol=0.0)
    return a == b


def feed_ledger(ledger):
    rows = [
        dict(bucket="32x32", cadence=1, precision="bf16", device_s=0.25,
             flops=3.5e11, requests=2, batch_raw=2, batch_run=2,
             true_pixels=1536, padded_pixels=2048, true_tokens=20,
             padded_tokens=154),
        dict(bucket="32x32", cadence=1, precision="bf16", device_s=0.125,
             flops=1.75e11, requests=1, batch_raw=1, batch_run=2,
             true_pixels=1024, padded_pixels=2048,
             hbm={"bytes_in_use": 10, "peak_bytes_in_use": 99,
                  "live_buffers": 3}),
        dict(bucket="32x48", cadence=3, precision="int8", lora="r8s1",
             device_s=0.5, flops=1e12, requests=3, batch_raw=3,
             batch_run=4, true_pixels=3000, padded_pixels=6144,
             masked_pixels=512),
    ]
    for r in rows:
        ledger.record_dispatch(**r)
    ledger.record_stages(bucket="32x32", cadence=1, precision="bf16",
                         stage_s=0.4, overlap_s=0.1)
    ledger.record_stages(bucket="64x64", cadence=1, precision="bf16",
                         stage_s=0.2, overlap_s=0.05)
    for tenant, cls, slo, lat, ok in (("a", "interactive", 1.0, 0.5, True),
                                      ("a", "interactive", 1.0, 1.5, True),
                                      ("b", "batch", 30.0, 2.0, False),
                                      ("a", "interactive", 1.0, 0.2, True)):
        ledger.record_slo(tenant=tenant, cls=cls, slo_s=slo, latency_s=lat,
                          ok=ok)
    ledger.record_compile("unet", 1.5)
    ledger.record_compile("unet", 0.5)
    ledger.record_compile("deep", 2.0)


def test_ledger_summary_matches_jax(perf_on):
    feed_ledger(perf.LEDGER)
    feed_ledger(jperf.LEDGER)
    got, want = perf.LEDGER.summary(), jperf.LEDGER.summary()
    assert set(got) == set(want) - JAX_ONLY_SUMMARY
    for key in got:
        if key == "device_kind":
            continue
        assert close(got[key], want[key]), key
    row = next(g for g in got["groups"]
               if (g["bucket"], g["precision"]) == ("32x32", "bf16"))
    assert row["mfu"] == pytest.approx((3.5e11 + 1.75e11) / 0.375 / 1e12,
                                       rel=TOL)
    assert close(perf.LEDGER.last_dispatch(), jperf.LEDGER.last_dispatch())


def test_ledger_off_records_nothing(monkeypatch):
    monkeypatch.delenv("SDTPU_PERF", raising=False)
    perf.LEDGER.clear()
    feed_ledger(perf.LEDGER)
    s = perf.LEDGER.summary()
    assert s["enabled"] is False and s["groups"] == [] and s["slo"] == []
    assert s["compiles"] == {} and perf.LEDGER.last_dispatch() is None


@pytest.mark.parametrize("kind,precision,want", [
    ("NVIDIA H100 80GB HBM3", "bf16", 989.4e12),
    ("NVIDIA H100 80GB HBM3", "int8", 2 * 989.4e12),
    ("NVIDIA H100 80GB HBM3", "int8+conv", 2 * 989.4e12),
    ("NVIDIA H100 PCIe", "bf16", 756e12),
    ("NVIDIA H100 PCIe", "int8", 2 * 756e12),
    ("NVIDIA A100-SXM4-80GB", "bf16", None),
    ("TPU v5 lite", "bf16", None),
    ("", "bf16", None),
])
def test_peak_flops_holds_the_h100_rows(monkeypatch, kind, precision, want):
    monkeypatch.delenv("SDTPU_PERF_PEAK_FLOPS", raising=False)
    assert perf.peak_flops_for(kind, precision) == want
    monkeypatch.setenv("SDTPU_PERF_PEAK_FLOPS", "3e12")
    assert perf.peak_flops_for(kind, precision) == 3e12
    assert perf._device_kind() == ""  # the CPU: no MFU is ever made up


# -- the pricer against the JAX UNet's products -------------------------------

def _sub_jaxprs(eqn):
    for v in eqn.params.values():
        for x in (v if isinstance(v, (list, tuple)) else (v,)):
            if isinstance(x, jcore.ClosedJaxpr):
                yield x.jaxpr
            elif isinstance(x, jcore.Jaxpr):
                yield x


def product_flops(jaxpr) -> float:
    """2 x multiply-adds of every dot_general and conv_general_dilated."""
    total = 0.0
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name == "dot_general":
            (lc, _rc), _ = eqn.params["dimension_numbers"]
            lhs = eqn.invars[0].aval.shape
            out = eqn.outvars[0].aval.shape
            total += 2.0 * np.prod(out) * np.prod([lhs[d] for d in lc])
        elif name == "conv_general_dilated":
            rhs = eqn.invars[1].aval.shape
            out = eqn.outvars[0].aval.shape
            o_dim = eqn.params["dimension_numbers"].rhs_spec[0]
            total += 2.0 * np.prod(out) * np.prod(rhs) / rhs[o_dim]
        for sub in _sub_jaxprs(eqn):
            total += product_flops(sub)
    return total


def jax_eval_flops(jax_engine, rows, lat, ctx_len, mode):
    ucfg = JTINY.unet
    struct = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
        jax_engine.params["unet"])
    x = jax.ShapeDtypeStruct((rows, lat, lat, ucfg.in_channels),
                             jnp.float32)
    t = jax.ShapeDtypeStruct((rows,), jnp.float32)
    ctx = jax.ShapeDtypeStruct((rows, ctx_len, ucfg.cross_attention_dim),
                               jnp.float32)
    cache = (jax.ShapeDtypeStruct(
        junet.deep_cache_shape(ucfg, rows, lat, lat),
        jax_engine.policy.compute_dtype) if mode == "reuse" else None)

    def call(p, xx, tt, cc, ca):
        return jax_engine.unet.apply({"params": p}, xx, tt, cc, None,
                                     cache=ca, cache_mode=mode)

    return product_flops(jax.make_jaxpr(call)(struct, x, t, ctx,
                                              cache).jaxpr)


@pytest.mark.parametrize("mode", [None, "deep", "reuse"])
def test_pricer_counts_the_jax_unets_products(engine, jax_engine, mode):
    lat = 32 // TINY.vae_scale_factor
    got = stepcache.FlopsAccountant(engine).eval_flops(2, lat, lat, 77,
                                                       mode)
    want = jax_eval_flops(jax_engine, 2, lat, 77, mode)
    assert want > 0
    assert got == pytest.approx(want, rel=1e-6)


def test_range_price_sums_its_evaluations(engine):
    acct = stepcache.FlopsAccountant(engine)
    counts = stepcache.plan_schedule([(0, 2, True), (2, 2, True)], 2, 3,
                                     1, 4)
    got = acct.request_flops(counts, 1, 16, 16, 77, precision="bf16")
    want = (counts["reuse_full_evals"] * acct.eval_flops(2, 16, 16, 77,
                                                         "reuse")
            + counts["reuse_trunc_evals"] * acct.eval_flops(1, 16, 16, 77,
                                                            "reuse")
            + counts["deep_full"] * acct.eval_flops(2, 16, 16, 77, "deep")
            + counts["deep_trunc"] * acct.eval_flops(1, 16, 16, 77, "deep"))
    assert got == pytest.approx(want, rel=1e-12)
    # the int8 rung makes the same products
    assert acct.eval_flops(2, 16, 16, 77, None, "int8") == \
        acct.eval_flops(2, 16, 16, 77, None, "bf16")


def test_a_generation_prices_its_flops_per_image(engine, jax_engine):
    """The engine's denoise prices its evaluations into FLOPs per image,
    the JAX package's number for the same request's products."""
    METRICS.clear()
    body = dict(prompt="a flop cow", negative_prompt="blurry", steps=4,
                width=32, height=32, seed=5, sampler_name="Euler a")
    engine.txt2img(GenerationPayload(**body))
    s = METRICS.summary()
    lat = 32 // TINY.vae_scale_factor
    per_eval = jax_eval_flops(jax_engine, 2, lat, 77, None)
    assert s["unet_images"] == 1
    assert s["unet_flops_per_image"] == pytest.approx(4 * per_eval,
                                                      rel=1e-6)


def test_attention_wrappers_answer_meta_with_a_shape():
    before = (fa.flash_attention.launches, ra.ragged_attention.launches)
    q = torch.empty(2, 64, 2, 8, device="meta")
    k = torch.empty(2, 77, 2, 8, device="meta")
    out = fa.flash_attention(q, k, k)
    assert out.device.type == "meta" and out.shape == q.shape
    lens = torch.full((2,), 70, dtype=torch.int32, device="meta")
    out = ra.ragged_attention(q, k, k, lens, mask_queries=False)
    assert out.device.type == "meta" and out.shape == q.shape
    assert (fa.flash_attention.launches,
            ra.ragged_attention.launches) == before


def test_token_counts_match_jax(engine, jax_engine):
    for prompt in ("a cow", "a " * 100 + "cow", ""):
        body = dict(prompt=prompt, negative_prompt="blurry, low quality")
        assert engine.request_token_stats(GenerationPayload(**body)) == \
            tuple(jax_engine.request_token_stats(JaxPayload(**body)))
        ids = np.full((2, 77), 7, np.int32)
        ids[0, :5] = [1, 2, 3, 4, 7]
        assert true_token_count(ids, 7) == jax_true_token_count(ids, 7)


def test_device_readers_give_none_on_the_cpu():
    assert tsdb.device_memory_stats() is None
    assert tsdb.live_buffer_count() is None
    assert tsdb.dispatch_memory_sample() is None


# -- the exposition against the JAX package's ---------------------------------

def feed_metrics(metrics, stats, prom, ledger):
    metrics.clear()
    stats.clear()
    prom.clear_histograms()
    prom.ETA_GAUGE.clear()
    ledger.clear()
    metrics.record_request(True, padding_ratio=2.0)
    metrics.record_request(False)
    metrics.record_request(False, bypassed=True)
    metrics.record_dispatch(2, precision="bf16")
    metrics.record_dispatch(1, precision="int8")
    metrics.record_queue_wait(0.125)
    metrics.record_compile("unet")
    metrics.record_cache_hit("unet")
    metrics.record_unet_flops(3.5e11)
    metrics.record_unet_images(2)
    for stage, secs in (("denoise_chunk", 0.02), ("text_encode", 0.004),
                        ("vae_decode_dispatch", 0.3)):
        stats.record(stage, secs)
        prom.observe_stage(stage, secs)
    prom.observe_hist("e2e", 0.75)
    prom.observe_hist("queue_wait", 0.125)
    prom.observe_lora_apply(0.01)
    prom.observe_cold_start(1.5)
    prom.observe_compile("unet", 2.5)
    prom.observe_stage_graph("encode", 0.003)
    prom.observe_stage_graph("denoise", 0.2)
    prom.fleet_observe_queue_wait("interactive", 0.2)
    prom.fleet_observe_queue_wait("batch", 3.0)
    prom.count_precision("bf16", 2)
    prom.count_lora_switch("merged")
    prom.fleet_count("admissions", decision="accept", **{"class": "batch"})
    prom.fleet_count("quota_throttles", tenant='bad"ten\nant')
    prom.fleet_count("preemptions", **{"class": "batch"})
    prom.fleet_count("requests", tenant="t", **{"class": "interactive"})
    prom.worker_count("requests", worker="w0")
    prom.worker_count("failures", worker="w0")
    prom.worker_count("requeued_images", 2, worker="w0")
    prom.worker_count("transitions", worker="w0", to="IDLE")
    prom.set_worker_latency("w0", 0.5)
    prom.count_watchdog_stall("job-w0")
    prom.cache_count("result", "hit")
    prom.sim_fault_count("kill")
    prom.ETA_GAUGE.record(1.2, 1.0)
    ledger.record_dispatch(bucket="32x32", cadence=1, precision="bf16",
                           device_s=0.25, flops=3.5e11, requests=2,
                           batch_raw=2, batch_run=2, true_pixels=1536,
                           padded_pixels=2048, true_tokens=10,
                           padded_tokens=154)
    ledger.record_slo(tenant="t", cls="interactive", slo_s=1.0,
                      latency_s=0.5)
    return prom.render()


def families(text):
    """name -> {"help", "type", "samples"} of a text exposition."""
    out = {}
    for line in text.splitlines():
        m = re.match(r"# (HELP|TYPE) (\S+) (.*)$", line)
        if m:
            fam = out.setdefault(m.group(2), {"samples": []})
            fam[m.group(1).lower()] = m.group(3)
            continue
        name = re.match(r"([a-zA-Z_:][a-zA-Z0-9_:]*)", line).group(1)
        base = re.sub(r"_(bucket|sum|count)$", "", name)
        fam = out.get(name) or out[base]
        fam["samples"].append(line)
    return out


def test_exposition_matches_jax(perf_on):
    got = families(feed_metrics(METRICS, trace.STATS, prometheus,
                                perf.LEDGER))
    want = families(feed_metrics(JAX_METRICS, jtrace.STATS, jprom,
                                 jperf.LEDGER))
    assert set(got) == set(want) - JAX_ONLY_FAMILIES
    for name in got:
        assert got[name]["type"] == want[name]["type"], name
        assert sorted(got[name]["samples"]) == \
            sorted(want[name]["samples"]), name
        if name not in HELP_DIFFERS:
            assert got[name]["help"] == want[name]["help"], name
    assert set(prometheus.registered_metrics()) >= set(got)
    with pytest.raises(prometheus.MetricRegistrationError):
        prometheus.register_metric("sdtpu_request_e2e_seconds", "gauge",
                                   "x")
    with pytest.raises(prometheus.MetricRegistrationError):
        prometheus.register_metric("bad name", "gauge", "x")


# -- the gates: the same bytes -------------------------------------------------

def run_both(engine, seed):
    disp = ServingDispatcher(engine, bucketer=ShapeBucketer(
        shapes=[(32, 32)], batches=[1, 2]), window=0.3)
    body = dict(prompt="a gate cow", negative_prompt="blurry", steps=4,
                width=32, height=32, sampler_name="Euler a")
    out = []
    threads = []
    for i in range(2):
        def run(i=i):
            out.append((i, disp.submit(GenerationPayload(
                **body, seed=seed + i)).images))
        threads.append(threading.Thread(target=run))
        threads[-1].start()
        time.sleep(0.05)
    for t in threads:
        t.join(120)
    solo = disp.submit(GenerationPayload(**body, seed=seed, n_iter=3))
    return sorted(out), solo.images


def test_gates_on_give_the_same_bytes(engine, monkeypatch):
    for name in ("SDTPU_PERF", "SDTPU_WATCHDOG_FACTOR"):
        monkeypatch.delenv(name, raising=False)
    enabled = spans.TRACER.enabled
    spans.TRACER.enabled = False
    try:
        off = run_both(engine, 900)
    finally:
        spans.TRACER.enabled = enabled
    spans.TRACER.enabled = True
    monkeypatch.setenv("SDTPU_PERF", "1")
    monkeypatch.setenv("SDTPU_WATCHDOG_FACTOR", "4")
    perf.LEDGER.clear()
    try:
        on = run_both(engine, 900)
    finally:
        spans.TRACER.enabled = enabled
    assert on == off
    groups = perf.LEDGER.summary()["groups"]
    assert sum(g["dispatches"] for g in groups) == 2
    assert all(g["flops"] > 0 and g["device_s"] > 0 for g in groups)
    assert all(g["mfu"] is None for g in groups)  # no peak on the CPU
