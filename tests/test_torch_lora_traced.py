"""LoRA's traced path (``SDTPU_LORA_TRACED=1``) in the port against the JAX
package, on the CPU, and the adapter registry behind the server.

- The rank and slot ladders bucket as the JAX package's do.
- ``delta_out`` (one set for every row, and a set per row) equals the
  numpy sum of ``x @ down_s^T @ up_s^T`` within 2e-5.
- ``build_traced_set`` gives the JAX package's sig, cell, counts, content
  addresses and zero-padded factors exactly (f32 on the CPU), on TINY and
  TINY_XL; ``stack_row_sets`` its stacked rows.
- Engine requests under the traced path give the JAX traced engine's seeds
  and infotext and pixels within 1 uint8 level, merge nothing and leave
  the weights pristine; against the merged path they hold
  ``tests/quality.py``'s floors (mean PSNR >= 28 dB, SSIM >= 0.985) as the
  JAX package's own test does. Adapter churn reproduces each set's bytes;
  a sub-range equals its rows of the whole batch; a DPM adaptive request
  and a set past the rank ladder take the merged path.
- Two dispatcher requests with different sets in one (rank, slots) cell
  run as one dispatch, each image within 1 level of its solo run.
- The server: an adapter written after start is served once ``POST
  /sdapi/v1/refresh-loras`` rescans, and a file edited in place (new
  mtime) is reloaded.
"""

import json
import os
import threading
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import quality
from stable_diffusion_webui_distributed_tpu.models import lora as jlora
from stable_diffusion_webui_distributed_tpu.models.configs import TINY as JTINY
from stable_diffusion_webui_distributed_tpu.models.configs import (
    TINY_XL as JTINY_XL,
)
from stable_diffusion_webui_distributed_tpu.pipeline.engine import (
    Engine as JaxEngine,
)
from stable_diffusion_webui_distributed_tpu.pipeline.payload import (
    GenerationPayload as JaxPayload,
)
from stable_diffusion_webui_distributed_tpu.runtime.interrupt import (
    GenerationState as JaxState,
)
from stable_diffusion_webui_distributed_tpu_torch import bridge
from stable_diffusion_webui_distributed_tpu_torch.models import lora
from stable_diffusion_webui_distributed_tpu_torch.models.configs import (
    TINY,
    TINY_XL,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline.engine import Engine
from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    GenerationPayload,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline.registry import (
    ModelRegistry,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.interrupt import (
    GenerationState,
)
from stable_diffusion_webui_distributed_tpu_torch.server.api import ApiServer
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
from test_torch_lora import assert_images_match, make_adapter

ADAPTERS = {"a": make_adapter(TINY, rank=4, seed=1),
            "b": make_adapter(TINY, rank=4, seed=2),
            "c": make_adapter(TINY, rank=4, seed=3),
            "q": make_adapter(TINY, rank=4, seed=4, only=["attn1_to_q"]),
            "big": make_adapter(TINY, rank=32, seed=5)}
REQUEST = dict(prompt="a cow", negative_prompt="blurry", steps=3, width=32,
               height=32, batch_size=2, seed=21)


@pytest.fixture
def traced(monkeypatch):
    monkeypatch.setenv("SDTPU_LORA_TRACED", "1")


@pytest.fixture(scope="module")
def jparams():
    return jax.jit(init_params, static_argnums=0)(JTINY)


@pytest.fixture(scope="module")
def params(jparams):
    return jax.device_get(jparams)


@pytest.fixture(scope="module")
def xl_jparams():
    return jax.jit(init_params, static_argnums=0)(JTINY_XL)


def port_engine(params, provider=ADAPTERS.get):
    return Engine(TINY, bridge.flax_to_torch(TINY, params), chunk_size=2,
                  state=GenerationState(), device="cpu",
                  lora_provider=provider)


def body(prompt="a cow", **kw):
    return {**REQUEST, "prompt": prompt, **kw}


# --------------------------------------------------------------------------
# ladders, delta math, sets
# --------------------------------------------------------------------------


@pytest.mark.parametrize("env", [{}, {"SDTPU_LORA_RANKS": "4,12",
                                      "SDTPU_LORA_SLOTS": "2"}])
def test_ladders_bucket_as_jax(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert lora.rank_ladder() == jlora.rank_ladder()
    assert lora.slot_ladder() == jlora.slot_ladder()
    for n in range(0, 70):
        assert lora.bucket_rank(n) == jlora.bucket_rank(n)
        assert lora.bucket_slots(n) == jlora.bucket_slots(n)


def _site(rng, s, r, i, o, batch=None):
    lead = () if batch is None else (batch,)
    return {"down": rng.standard_normal(lead + (s, r, i)).astype(np.float32),
            "up": rng.standard_normal(lead + (s, o, r)).astype(np.float32)}


@pytest.mark.parametrize("batch", [None, 3])
def test_delta_out_matches_numpy(batch):
    rng = np.random.default_rng(0)
    site = _site(rng, s=2, r=4, i=8, o=6, batch=batch)
    x = rng.standard_normal((3, 5, 8)).astype(np.float32)
    got = lora.delta_out(torch.from_numpy(x),
                         {k: torch.from_numpy(v) for k, v in site.items()})
    want = np.zeros((3, 5, 6), np.float32)
    for b in range(3):
        for s in range(2):
            d = site["down"][s] if batch is None else site["down"][b, s]
            u = site["up"][s] if batch is None else site["up"][b, s]
            want[b] += x[b] @ d.T @ u.T
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    jgot = jlora.delta_out(jnp.asarray(x),
                           {k: jnp.asarray(v) for k, v in site.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=2e-5,
                               atol=2e-5)


def test_broadcast_site_takes_the_one_set_form():
    rng = np.random.default_rng(1)
    site = {k: torch.from_numpy(v)
            for k, v in _site(rng, s=1, r=4, i=8, o=6).items()}
    x = torch.from_numpy(rng.standard_normal((4, 5, 8)).astype(np.float32))
    ts = lora.TracedSet("s", 4, 1, {"unet": {"k": site}}, "", "", (), 0, 0,
                        ())
    rows = lora.broadcast_set(ts, 4)["unet"]["k"]
    assert rows["down"].stride(0) == 0  # a view, no copy per row
    assert torch.equal(lora.delta_out(x, rows), lora.delta_out(x, site))
    doubled = lora.double_rows({"k": rows})["k"]
    assert doubled["down"].shape[0] == 8 and doubled["down"].stride(0) == 0
    y = torch.zeros(4, 5, 6)
    assert lora.apply_site(y, x, None, "k") is y
    assert lora.apply_site(y, x, {"other": site}, "k") is y


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("xl,specs", [
    (False, (("a", 0.8, 0.8),)),
    (False, (("a", 0.8, 0.5), ("q", 1.0, 1.0), ("b", 0.3, 0.3))),
    (True, (("xl", 0.7, 0.2),)),
])
def test_traced_set_matches_jax(traced, jparams, xl_jparams, xl, specs):
    family, jfamily = (TINY_XL, JTINY_XL) if xl else (TINY, JTINY)
    jparams = xl_jparams if xl else jparams
    loras = {**ADAPTERS, "xl": make_adapter(TINY_XL, rank=8, seed=6)}
    want = jlora.build_traced_set(specs, loras.get, jfamily, jparams)
    leaves = bridge.flax_to_torch(family, jax.device_get(jparams))
    got = lora.build_traced_set(specs, loras.get, family, leaves)
    for attr in ("sig", "rank_bucket", "slots", "applied", "skipped",
                 "content", "te_content", "specs"):
        assert getattr(got, attr) == getattr(want, attr), attr
    got_leaves, want_leaves = dict(_flat(got.tree)), dict(_flat(want.tree))
    assert set(got_leaves) == set(want_leaves)
    for path, w in want_leaves.items():
        assert got_leaves[path].dtype == torch.float32
        np.testing.assert_array_equal(got_leaves[path].numpy(), w)


def test_zero_set_adds_exactly_nothing(params):
    zs = lora.zero_set(bridge.flax_to_torch(TINY, params), TINY, 8, 1)
    assert (zs.sig, zs.content) == ("lora:r8s1", "zero")
    x = torch.randn(2, 5, 32)
    site = zs.tree["unet"]["down_0_attn_0"]["proj_in"]
    assert not lora.delta_out(x, site).any()


def test_traced_content_for_payload(port, monkeypatch):
    p = GenerationPayload(**body("a cow <lora:a:0.8>"))
    assert port.traced_content_for_payload(p) == ""  # the merged path
    monkeypatch.setenv("SDTPU_LORA_TRACED", "1")
    want = port._traced_set_for((("a", 0.8, 0.8),)).content
    assert port.traced_content_for_payload(p) == want
    assert port.traced_content_for_payload(
        GenerationPayload(**body("a cow"))) == ""
    assert port.traced_content_for_payload(GenerationPayload(
        **body("a cow <lora:a:0.8>", sampler_name="DPM adaptive"))) == ""


def test_unbucketable_sets_are_none(params, traced):
    leaves = bridge.flax_to_torch(TINY, params)
    for specs in ((("nope", 1.0, 1.0),), (("big", 1.0, 1.0),),
                  tuple((n, 1.0, 1.0) for n in "abcq") + (("a", 1, 1),)):
        assert lora.build_traced_set(specs, ADAPTERS.get, TINY,
                                     leaves) is None


def test_stacked_rows_match_jax(jparams, params, traced):
    sets = [lora.build_traced_set(((n, 0.8, 0.8),), ADAPTERS.get, TINY,
                                  bridge.flax_to_torch(TINY, params))
            for n in "ab"]
    jsets = [jlora.build_traced_set(((n, 0.8, 0.8),), ADAPTERS.get, JTINY,
                                    jparams) for n in "ab"]
    got = dict(_flat(lora.stack_row_sets(sets, 3)))
    want = dict(_flat(jax.device_get(jlora.stack_row_sets(jsets, 3))))
    for path, w in want.items():
        np.testing.assert_array_equal(got[path].numpy(), w)
    two = lora.build_traced_set((("a", 1, 1), ("b", 1, 1)), ADAPTERS.get,
                                TINY, bridge.flax_to_torch(TINY, params))
    with pytest.raises(ValueError, match="heterogeneous"):
        lora.stack_row_sets([sets[0], two], 2)


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_engine(jparams):
    return JaxEngine(JTINY, jparams, state=JaxState(),
                     lora_provider=ADAPTERS.get)


@pytest.fixture(scope="module")
def port(params):
    return port_engine(params)


@pytest.fixture(scope="module")
def merged_runs(port):
    """The merged path's images of each traced prompt, before any test
    turns the traced path on."""
    return {p: port.txt2img(GenerationPayload(**body(p)))
            for p in ("a cow <lora:a:0.8>",
                      "a cow <lora:a:0.8> <lora:q:0.5:0.2>")}


@pytest.mark.parametrize("prompt", ["a cow <lora:a:0.8>",
                                    "a cow <lora:a:0.8> <lora:q:0.5:0.2>"])
def test_traced_requests_match_jax(jax_engine, port, merged_runs, traced,
                                   prompt):
    want = jax_engine.txt2img(JaxPayload(**body(prompt)))
    merges = port._lora_merge_total
    got = port.txt2img(GenerationPayload(**body(prompt)))
    assert port._lora_merge_total == merges and not port._pristine
    assert port._traced_lora is not None
    assert got.seeds == want.seeds and got.infotexts == want.infotexts
    assert_images_match(got.images, want.images)
    ref = merged_runs[prompt]
    assert quality.mean_psnr(ref.images, got.images) >= 28.0
    assert quality.mean_ssim(ref.images, got.images) >= 0.985


def test_traced_te_factors_key_the_conditioning(port, traced):
    port.txt2img(GenerationPayload(**body("a cow <lora:a:0.8>")))
    assert port.traced_te_content()
    assert any(k[-1] == port.traced_te_content() for k in port._cond_cache)
    port.txt2img(GenerationPayload(**body("a cow")))
    assert port.traced_te_content() == ""


def test_churn_reproduces_each_sets_bytes(params, traced):
    eng = port_engine(params)
    pristine = {k: v.clone() for k, v in eng.unet.state_dict().items()}
    base = eng.txt2img(GenerationPayload(**body()))
    outs = [eng.txt2img(GenerationPayload(**body(f"a cow <lora:{n}:0.8>")))
            for n in "abcab"]
    assert eng._lora_merge_total == 0
    assert outs[0].images != outs[1].images != outs[2].images
    assert outs[3].images == outs[0].images
    assert outs[4].images == outs[1].images
    assert eng.txt2img(GenerationPayload(**body())).images == base.images
    for k, v in eng.unet.state_dict().items():
        assert torch.equal(v, pristine[k])


def test_subrange_equals_whole_batch_rows(port, traced):
    p = GenerationPayload(**body("a cow <lora:b:0.8>"))
    full = port.txt2img(p)
    port.state.begin_request()
    assert port.generate_range(p, 0, 1).images == full.images[:1]
    assert port.generate_range(p, 1, 1).images == full.images[1:]


@pytest.mark.parametrize("prompt,sampler", [
    ("a cow <lora:a:0.8>", "DPM adaptive"),
    ("a cow <lora:big:0.8>", "Euler a"),
])
def test_unbucketable_requests_take_the_merged_path(params, monkeypatch,
                                                    prompt, sampler):
    p = body(prompt, sampler_name=sampler, batch_size=1)
    merged = port_engine(params).txt2img(GenerationPayload(**p))
    monkeypatch.setenv("SDTPU_LORA_TRACED", "1")
    eng = port_engine(params)
    got = eng.txt2img(GenerationPayload(**p))
    assert eng._traced_lora is None and eng._lora_merge_total == 1
    assert got.images == merged.images


def test_traced_dual_weight_matches_jax_on_tiny_xl(traced, xl_jparams):
    jparams = xl_jparams
    sd = {"x": make_adapter(TINY_XL, rank=4, seed=5)}
    jeng = JaxEngine(JTINY_XL, jparams, state=JaxState(),
                     lora_provider=sd.get)
    peng = Engine(TINY_XL, bridge.flax_to_torch(TINY_XL,
                                                jax.device_get(jparams)),
                  state=GenerationState(), device="cpu",
                  lora_provider=sd.get)
    b = body("a cow <lora:x:0.9:0.3>", batch_size=1)
    want = jeng.txt2img(JaxPayload(**b))
    got = peng.txt2img(GenerationPayload(**b))
    assert peng._lora_merge_total == 0
    assert got.infotexts == want.infotexts
    assert_images_match(got.images, want.images)


# --------------------------------------------------------------------------
# the dispatcher
# --------------------------------------------------------------------------


def _concurrently(submit, payloads):
    results, errors = [None] * len(payloads), []

    def run(i, p):
        try:
            results[i] = submit(p)
        except Exception as e:  # noqa: BLE001 — surfaced by the assert
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i, p))
               for i, p in enumerate(payloads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        assert not t.is_alive()
    assert not errors, errors
    return results


def test_sets_in_one_cell_share_a_dispatch(port, traced):
    disp = ServingDispatcher(
        port, bucketer=ShapeBucketer(shapes=[(32, 32)], batches=[1, 2, 4]),
        window=0.5)
    payloads = [GenerationPayload(**body(f"cow <lora:{n}:0.8>", seed=40 + i,
                                         batch_size=1 + i))
                for i, n in enumerate("ab")]
    keys = {disp._group_key(p) for p in payloads}
    # rank 4 on q, k and v: 12 at the fused sites, the 16 rung
    assert len(keys) == 1 and next(iter(keys))[-2:] == (16, 1)
    METRICS.clear()
    merges = port._lora_merge_total
    got = _concurrently(disp.submit, payloads)
    assert METRICS.summary()["dispatches"] == 1
    assert port._lora_merge_total == merges
    for r, p in zip(got, payloads):
        solo = port.txt2img(p)
        assert r.seeds == solo.seeds and r.infotexts == solo.infotexts
        assert_images_match(r.images, solo.images)


def test_merged_lora_requests_run_solo(port, monkeypatch):
    monkeypatch.delenv("SDTPU_LORA_TRACED", raising=False)
    disp = ServingDispatcher(
        port, bucketer=ShapeBucketer(shapes=[(32, 32)], batches=[1, 2, 4]),
        window=0.3)
    payloads = [GenerationPayload(**body(prompt, seed=50 + i,
                                         batch_size=1))
                for i, prompt in enumerate(["cow <lora:a:0.8>",
                                            "cow <lora:b:0.8>", "cow"])]
    assert [disp._coalescable(p) for p in payloads] == [False, False, True]
    METRICS.clear()
    got = _concurrently(disp.submit, payloads)
    assert METRICS.summary()["dispatches"] == 3
    for r, p in zip(got, payloads):
        assert r.images == port.txt2img(p).images


# --------------------------------------------------------------------------
# the registry behind the server
# --------------------------------------------------------------------------


def _write(path, sd):
    from safetensors.numpy import save_file

    save_file(sd, str(path))


def _post(port, route, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{route}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


@pytest.mark.parametrize("mode", ["merged", "traced"])
def test_refresh_loras_serves_a_new_file(params, tmp_path, monkeypatch,
                                         mode):
    if mode == "traced":
        monkeypatch.setenv("SDTPU_LORA_TRACED", "1")
    monkeypatch.setenv("SDTPU_BUCKET_LADDER", "32x32")
    (tmp_path / "Lora").mkdir()
    registry = ModelRegistry(str(tmp_path))
    eng = port_engine(params, registry.lora_provider)
    server = ApiServer(eng, port=0, registry=registry).start()
    try:
        req = body("a cow <lora:late:0.8>", batch_size=1)
        tagless = _post(server.port, "/sdapi/v1/txt2img",
                        body(batch_size=1))
        before = _post(server.port, "/sdapi/v1/txt2img", req)
        assert before["images"] == tagless["images"]  # unknown: skipped
        _write(tmp_path / "Lora" / "late.safetensors", ADAPTERS["a"])
        assert _post(server.port, "/sdapi/v1/txt2img", req)["images"] == \
            before["images"]  # not rescanned yet
        gen = registry.lora_generation
        assert _post(server.port, "/sdapi/v1/refresh-loras", {}) == {}
        assert registry.lora_generation == gen + 1
        assert registry.available_loras() == {
            "late": str(tmp_path / "Lora" / "late.safetensors")}
        after = _post(server.port, "/sdapi/v1/txt2img", req)
        assert after["images"] != before["images"]
        want = port_engine(params, ADAPTERS.get).txt2img(GenerationPayload(
            **body("a cow <lora:a:0.8>", batch_size=1)))
        assert after["images"] == want.images
    finally:
        server.stop()


def test_an_edited_file_reloads(params, tmp_path, monkeypatch):
    monkeypatch.setenv("SDTPU_LORA_TRACED", "1")
    lora_dir = tmp_path / "lora"
    lora_dir.mkdir()
    path = lora_dir / "x.safetensors"
    _write(path, ADAPTERS["a"])
    registry = ModelRegistry(str(tmp_path))
    first = registry.lora_provider("x")
    assert registry.lora_provider("x") is first  # cached
    assert registry.lora_provider("nope") is None
    eng = port_engine(params, registry.lora_provider)
    p = GenerationPayload(**body("a cow <lora:x:0.8>", batch_size=1))
    out_a = eng.txt2img(p)
    _write(path, ADAPTERS["b"])
    st = os.stat(path)
    os.utime(path, (st.st_atime + 5, st.st_mtime + 5))
    assert registry.lora_provider("x") is not first
    out_b = eng.txt2img(p)  # the traced set rebuilds from the new dict
    assert out_b.images != out_a.images
    want = port_engine(params, {"x": ADAPTERS["b"]}.get).txt2img(p)
    assert out_b.images == want.images


def test_byte_cap_keeps_nothing(tmp_path, monkeypatch):
    monkeypatch.setenv("SDTPU_LORA_CACHE_MB", "0.000001")
    (tmp_path / "Lora").mkdir()
    _write(tmp_path / "Lora" / "x.safetensors", ADAPTERS["q"])
    registry = ModelRegistry(str(tmp_path))
    one, two = registry.lora_provider("x"), registry.lora_provider("x")
    assert one is not None and two is not None and one is not two
    for k, v in ADAPTERS["q"].items():
        np.testing.assert_array_equal(one[k], v)
