"""Traced LoRA (``SDTPU_LORA_TRACED=1``) under ``tp``: each traced site of a
split layer against the meshless ``apply_site``, and the engine and the
dispatcher on ``dp=4,tp=2`` against the JAX engine and the meshless port,
on TINY on the CPU.

- **Sites** (virtual ``cpu`` meshes with ``tp`` 2 and 4, at bf16 (f32 on
  the CPU) and int8): ``_Heads``' ``qkv``, ``q`` and ``kv`` sites compute
  ``h = x @ down^T`` once and each shard adds ``h @ up_j^T`` over its heads'
  rows of the q, k and v blocks; its ``out_proj`` site sums each shard's
  ``o_j @ down[:, cols_j]^T`` in f32 and multiplies by ``up`` on the home
  device; ``_Halves``' ``proj`` splits ``up`` into its ``a`` and ``g``
  halves, each chunked by shard, and ``ff_out`` is a row site as
  ``out_proj``. ``proj_in`` and ``proj_out`` (a column and a row Dense)
  take their delta on the home device from the whole input. Each matches
  the meshless ``apply_site`` within 1e-6 relative in the one-set form,
  the per-row form and the stride-0 broadcast form (never materialized:
  every factor reaches the products in its one-set form), and in the last
  two with the CFG-doubled rows of ``double_rows``.
- **The engine**: ``dp=4,tp=2`` at batch 4 served through ``POST
  /sdapi/v1/txt2img`` with a rank-4 traced adapter at 0.8 (no merge),
  within 1 uint8 level of the JAX traced engine on the same mesh spec and
  of the port's meshless engine. The JAX engine compiles for some 33 s on
  a CPU: a file of its own.
- **The dispatcher**: two requests with different sets in one (rank,
  slots) cell coalesce into one dispatch on ``dp=4,tp=2`` (per-row
  factor leaves split over ``dp``), each image within 1 level of the same
  group on the meshless dispatcher.
"""

import threading

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
from stable_diffusion_webui_distributed_tpu_torch.models import lora, unet
from stable_diffusion_webui_distributed_tpu_torch.models.configs import (
    TINY,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    GenerationPayload,
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
from test_torch_lora import make_adapter
from test_torch_parallel import (  # noqa: F401 — fixtures
    BASE,
    LORA,
    SERVED,
    assert_within_one,
    gates_off,
    params,
    plain,
    port_engine,
    providers,
    served_case,
)

C, HEADS, CTX = 32, 4, 24
SETS, RANK = 2, 4
ROWS = 4  # the rows of an evaluation; the doubled forms double 2 rows
FORMS = ["one set", "per row", "broadcast", "per row doubled",
         "broadcast doubled"]
REL = 1e-6
CPU = torch.device("cpu")


def make_site(seed, i, o, form):
    """A ``{"down", "up"}`` site of ``SETS`` sets at rank ``RANK`` in
    ``form``, for ``ROWS`` rows."""
    rng = np.random.default_rng(seed)
    doubled = form.endswith("doubled")
    rows = ROWS // 2 if doubled else ROWS
    lead = (rows,) if form.startswith("per row") else ()

    def draw(shape):
        return torch.from_numpy(
            rng.standard_normal(lead + shape).astype(np.float32) * 0.3)

    site = {"down": draw((SETS, RANK, i)), "up": draw((SETS, o, RANK))}
    if form.startswith("broadcast"):
        site = {k: v.expand((rows,) + tuple(v.shape))
                for k, v in site.items()}
    if doubled:
        site = lora.double_rows({"s": site})["s"]
    return site


def tokens(seed, t, k):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((ROWS, t, k))
                            .astype(np.float32))


def assert_rel(got, want):
    err = float(((got - want).abs().max() / want.abs().max()).detach())
    assert err <= REL, err


@pytest.fixture
def one_set_factors(monkeypatch):
    """Records the dims of every factor the split sites multiply by."""
    dims = []
    down, up = unet.delta_down, unet.delta_up

    def record_down(x, d):
        dims.append(d.dim())
        return down(x, d)

    def record_up(h, u):
        dims.append(u.dim())
        return up(h, u)

    monkeypatch.setattr(unet, "delta_down", record_down)
    monkeypatch.setattr(unet, "delta_up", record_up)
    return dims


def check_forms(form, dims):
    assert dims
    if form.startswith("broadcast") or form == "one set":
        assert set(dims) == {3}, dims  # no per-row copy of one set


def block(seed=0):
    torch.manual_seed(seed)
    b = unet.TransformerBlock(C, HEADS, CTX)
    for p in b.parameters():
        torch.nn.init.normal_(p, std=0.2)
    return b


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("tp", [2, 4])
def test_qkv_site_matches_apply_site(tp, form, quant, one_set_factors):
    attn = block().attn1
    x = tokens(1, 6, C)
    site = make_site(2, C, 3 * C, form)
    heads = unet._Heads(attn, ["cpu"] * tp, [None] * tp, CPU)
    got = heads.project(x, None, {"qkv": site}, quant)
    want = lora.apply_site(attn.qkv(x, quant), x, {"qkv": site},
                           "qkv").split(C, -1)
    for i in range(3):
        assert_rel(torch.cat([g[i] for g in got], -2).flatten(-2), want[i])
    check_forms(form, one_set_factors)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("tp", [2, 4])
def test_q_and_kv_sites_match_apply_site(tp, form, quant, one_set_factors):
    attn = block().attn2
    x, ctx = tokens(3, 6, C), tokens(4, 5, CTX)
    sites = {"q": make_site(5, C, C, form),
             "kv": make_site(6, CTX, 2 * C, form)}
    heads = unet._Heads(attn, ["cpu"] * tp, [None] * tp, CPU)
    got = heads.project(x, ctx, sites, quant)
    want = (lora.apply_site(attn.q(x, quant), x, sites, "q"),
            *lora.apply_site(attn.kv(ctx, quant), ctx, sites,
                             "kv").split(C, -1))
    for i in range(3):
        assert_rel(torch.cat([g[i] for g in got], -2).flatten(-2), want[i])
    check_forms(form, one_set_factors)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("tp", [2, 4])
def test_out_proj_site_matches_apply_site(tp, form, quant, one_set_factors):
    attn = block().attn1
    o = tokens(7, 6, C)
    site = {"out_proj": make_site(8, C, C, form)}
    heads = unet._Heads(attn, ["cpu"] * tp, [None] * tp, CPU)
    got = heads.output(list(o.chunk(tp, -1)), site["out_proj"], quant)
    assert_rel(got, lora.apply_site(attn.out_proj(o, quant), o, site,
                                    "out_proj"))
    check_forms(form, one_set_factors)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("tp", [2, 4])
def test_geglu_and_ff_out_sites_match_apply_site(tp, form, quant,
                                                 one_set_factors):
    b = block()
    h = tokens(9, 6, C)
    proj = make_site(10, C, 8 * C, form)
    ff = {"ff_out": make_site(11, 4 * C, C, form)}
    halves = unet._Halves(b, ["cpu"] * tp, CPU)
    ys = halves.hidden(h, proj, quant)
    y = b.geglu(h, lora={"proj": proj}, ql=quant)
    assert_rel(torch.cat(ys, -1), y)
    # the ff_out site over the same hidden state on both sides
    ys = list(y.chunk(tp, -1))
    assert_rel(halves.output(ys, ff["ff_out"], quant),
               lora.apply_site(b.ff_out(y, quant), y, ff, "ff_out"))
    check_forms(form, one_set_factors)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("tp", [2, 4])
def test_home_sites_proj_in_and_proj_out_match(tp, form, quant):
    """``proj_in`` (column) and ``proj_out`` (row) stay whole Dense
    layers whose delta ``SpatialTransformer.forward`` adds on the home
    device from the whole input."""
    torch.manual_seed(1)
    st = unet.SpatialTransformer(C, 1, HEADS, CTX)
    x = tokens(12, 6, C)
    sites = {"proj_in": make_site(13, C, C, form),
             "proj_out": make_site(14, C, C, form)}
    want = {k: lora.apply_site(getattr(st, k)(x, quant), x, sites, k)
            for k in sites}
    st.proj_in.tp = unet._Column(st.proj_in, ["cpu"] * tp, CPU)
    st.proj_out.tp = unet._Row(st.proj_out, ["cpu"] * tp, CPU)
    for k in sites:
        assert_rel(lora.apply_site(getattr(st, k)(x, quant), x, sites, k),
                   want[k])


# -- the engine and the dispatcher on dp=4,tp=2 -------------------------------

@pytest.fixture
def traced(monkeypatch):
    monkeypatch.setenv("SDTPU_LORA_TRACED", "1")


def test_traced_engine_on_a_mesh_matches_jax_and_the_meshless_port(
        params, providers, plain, traced, monkeypatch):
    extra, _ = SERVED["traced LoRA"]
    body = {**BASE, **extra, "batch_size": 4}
    jax_engine = JaxEngine(JTINY, params, chunk_size=3, state=JaxState(),
                           mesh=jmesh.build_mesh("dp=4,tp=2"),
                           lora_provider=providers["lora_provider"])
    want = jax_engine.txt2img(JaxPayload(**body))
    assert jax_engine._active_loras == ()  # traced, not merged
    wants = [want, plain.txt2img(GenerationPayload(**body))]
    served_case("traced LoRA", port_engine(params, providers, "dp=4,tp=2"),
                wants, monkeypatch, batch=4)


def _group(engine, payloads):
    """``payloads`` submitted at once to a dispatcher over ``engine``:
    their results, and the dispatches they took."""
    disp = ServingDispatcher(engine, bucketer=ShapeBucketer(
        shapes=[(32, 32)], batches=[1, 2, 4]), window=0.5)
    METRICS.clear()
    results, errors = [None] * len(payloads), []

    def run(i, p):
        try:
            results[i] = disp.submit(p)
        except Exception as e:  # noqa: BLE001 — surfaced by the assert
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i, p))
               for i, p in enumerate(payloads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert not errors, errors
    return results, METRICS.summary()["dispatches"]


def test_mixed_traced_group_on_a_mesh_matches_the_meshless_dispatcher(
        params, providers, traced):
    other = make_adapter(TINY, rank=4, seed=9)
    adapters = {LORA: providers["lora_provider"](LORA), "mesh-lora-b": other}
    providers = {**providers, "lora_provider": adapters.get}
    # rows 1 + 2 pad to 4 on the ladder: one row per dp replica, each
    # with its own set's factors
    payloads = [{**BASE, "prompt": f"mesh cow <lora:{n}:0.8>",
                 "seed": 40 + i, "batch_size": 1 + i}
                for i, n in enumerate([LORA, "mesh-lora-b"])]
    runs = []
    for spec in (None, "dp=4,tp=2"):
        engine = port_engine(params, providers, spec)
        got, dispatches = _group(engine, [GenerationPayload(**p)
                                          for p in payloads])
        assert dispatches == 1
        assert engine._lora_merge_total == 0
        runs.append(got)
    for got, want in zip(*runs[::-1]):
        assert_within_one(got, want)
