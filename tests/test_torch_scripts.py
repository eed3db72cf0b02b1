"""The port's per-image prompts and script layer against the JAX package's.

Scripts: ``expand_prompt_matrix`` (its 11-option refusal included),
``apply_scripts``, the styles functions and ``parse_axis_values`` give the
JAX functions' results field for field; ``run_xyz`` over JAX
``tests/test_xyz.py``'s stub execute gives the JAX cells, labels, order and
grid pixels (both draw with the same PIL in this process).

Images: TINY engines of both packages on the same Flax weights, in f32 on
the CPU. A prompt-matrix request of 4 images at group 2 with one prompt
past 75 tokens (txt2img, img2img, the hires fix, TINY_XL with the TINY
refiner) and prompts from file with and without ``checkbox_iterate`` give
the JAX engine's seeds, prompts and infotexts, and pixels within 1 uint8
level; a sub-range equals the same rows of the whole request.

The pin: a prompts-from-file request of 3 lines, the last past 75 tokens,
split by a World over a ``LocalBackend`` and a second ``LocalBackend`` or
an ``HTTPBackend`` so that one range holds only short lines, is pinned to
the JAX engine's ``request_context_chunks``, each remote gets its slice and
the pin, and each range is within 1 level of the JAX engine's
``generate_range`` of it; the pin of the prompt and negative prompt alone
(the fault this repairs) gives the short range other images.

Server: ``GET /sdapi/v1/embeddings`` equals the JAX handler's output, a
styled request gives the expanded prompt's bytes, an X/Y/Z plot over
``/sdapi/v1/txt2img`` gives a grid and cells equal to the cells alone (and
bypasses the dispatcher), and an 11-option matrix or a 101-cell grid
answers 422. ``cli generate --model-dir`` hands the registry's embeddings
to the engine and runs ``--style`` and ``--xyz-x``; the registry keeps one
store (inside or beside the model directory) across checkpoint switches
and rescans.
"""

import json
import os
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax

from stable_diffusion_webui_distributed_tpu.models import embeddings as jemb
from stable_diffusion_webui_distributed_tpu.models.configs import TINY as JTINY
from stable_diffusion_webui_distributed_tpu.models.configs import (
    TINY_REFINER as JTINY_REFINER,
)
from stable_diffusion_webui_distributed_tpu.models.configs import (
    TINY_XL as JTINY_XL,
)
from stable_diffusion_webui_distributed_tpu.pipeline import payload as jpayload
from stable_diffusion_webui_distributed_tpu.pipeline import styles as jstyles
from stable_diffusion_webui_distributed_tpu.pipeline import xyz as jxyz
from stable_diffusion_webui_distributed_tpu.pipeline.engine import (
    Engine as JaxEngine,
)
from stable_diffusion_webui_distributed_tpu.runtime.interrupt import (
    GenerationState as JaxState,
)
from stable_diffusion_webui_distributed_tpu.server.api import (
    ApiServer as JaxApiServer,
)
from stable_diffusion_webui_distributed_tpu_torch import bridge, cli
from stable_diffusion_webui_distributed_tpu_torch.models.configs import (
    TINY,
    TINY_REFINER,
    TINY_XL,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline import payload
from stable_diffusion_webui_distributed_tpu_torch.pipeline import styles
from stable_diffusion_webui_distributed_tpu_torch.pipeline import xyz
from stable_diffusion_webui_distributed_tpu_torch.pipeline.engine import Engine
from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    GenerationPayload,
    GenerationResult,
    array_to_b64png,
    b64png_to_array,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline.registry import (
    ModelRegistry,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime import (
    config as config_mod,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.interrupt import (
    GenerationState,
)
from stable_diffusion_webui_distributed_tpu_torch.scheduler.worker import (
    HTTPBackend,
    LocalBackend,
    WorkerNode,
)
from stable_diffusion_webui_distributed_tpu_torch.scheduler.world import World
from stable_diffusion_webui_distributed_tpu_torch.server.api import ApiServer
from stable_diffusion_webui_distributed_tpu_torch.serving.metrics import (
    METRICS,
)
from test_pipeline import init_params
from test_registry import write_tiny_checkpoint
from test_xyz import _stub_execute as jax_stub_execute

#: 80 fallback-tokenizer tokens: a prompt past one 75-token chunk
LONG = " ".join(f"w{i}" for i in range(80))
REFINER = "tiny-ref"
IPM = 60.0

# -- the script functions ---------------------------------------------------

MATRIX_PROMPTS = ["a cat|red|in snow", "a cat", "a | b | c | d",
                  "base|" + LONG, " spaced | x |"]


@pytest.mark.parametrize("prompt", MATRIX_PROMPTS)
def test_expand_prompt_matrix_matches_jax(prompt):
    assert payload.expand_prompt_matrix(prompt) == \
        jpayload.expand_prompt_matrix(prompt)


def test_eleven_options_are_refused_as_in_jax():
    prompt = "x|" + "|".join(f"o{i}" for i in range(11))
    for mod in (payload, jpayload):
        with pytest.raises(ValueError, match="limit is 10 options"):
            mod.expand_prompt_matrix(prompt)
    ten = payload.expand_prompt_matrix("x|" + "|".join(
        f"o{i}" for i in range(10)))
    assert len(ten) == 1024


SCRIPT_CASES = {
    "matrix": dict(prompt="a cat|red|in snow", batch_size=2, n_iter=3,
                   script_name="Prompt matrix"),
    "matrix-no-bar": dict(prompt="a cat", script_name="prompt matrix"),
    "file": dict(prompt="ui", batch_size=2,
                 script_name="prompts from file or textbox",
                 script_args=[False, False, "a\n# comment\n\n b \nc"]),
    "file-iterate": dict(prompt="ui", script_name="prompts from file or "
                         "textbox", script_args=[True, False, "a\nb"]),
    "file-empty": dict(prompt="ui", script_name="prompts from file or "
                       "textbox", script_args=[False, False, "  \n# x"]),
    "other-script": dict(prompt="a|b", script_name="loopback",
                         script_args=[1, 2]),
    "expanded": dict(prompt="a|b", script_name="prompt matrix",
                     all_prompts=["x", "y"], batch_size=2),
    "none": dict(prompt="a|b"),
}
SCRIPT_FIELDS = ("prompt", "all_prompts", "group_size", "batch_size",
                 "n_iter", "same_seed", "script_name", "script_args")


@pytest.mark.parametrize("case", sorted(SCRIPT_CASES))
def test_apply_scripts_matches_jax(case):
    body = SCRIPT_CASES[case]
    got = payload.apply_scripts(GenerationPayload(**body))
    want = jpayload.apply_scripts(jpayload.GenerationPayload(**body))
    for field in SCRIPT_FIELDS:
        assert getattr(got, field) == getattr(want, field), field


STYLES_CSV = ("\ufeffname,prompt,negative_prompt\n"
              "st,\"{prompt}, in snow\",ugly\n"
              "tail,cinematic,\n"
              ",nameless,x\n"
              "negonly,,\"blurry, {prompt}\"\n")


def test_styles_match_jax(tmp_path):
    path = tmp_path / "styles.csv"
    path.write_text(STYLES_CSV, encoding="utf-8")
    table = styles.load_styles(str(path))
    assert table == jstyles.load_styles(str(path))
    assert styles.load_styles(str(tmp_path / "none.csv")) == {}
    for style, prompt in (("{prompt}, x", "a"), ("x", "a"), ("x", ""),
                          ("", "a"), ("", "")):
        assert styles.apply_style_text(style, prompt) == \
            jstyles.apply_style_text(style, prompt)
    body = dict(prompt="a cat", negative_prompt="bad",
                styles=["st", "unknown", "tail", "negonly"])
    got, want = GenerationPayload(**body), jpayload.GenerationPayload(**body)
    styles.apply_styles(got, table)
    jstyles.apply_styles(want, table)
    assert (got.prompt, got.negative_prompt, got.styles) == \
        (want.prompt, want.negative_prompt, want.styles)
    assert got.prompt == "a cat, in snow, cinematic"


AXIS_CASES = [("int", "10, 20,30"), ("int", "1-5"), ("int", "1-10 [5]"),
              ("float", "0-1 [3]"), ("int", "1-10 (+2)"), ("int", "3-1"),
              ("float", "1.5-0.5 (-0.25)"), ("text", "Euler a, DDIM"),
              ("sr", "red, blue"), ("none", ""), ("int", ""),
              ("float", "5, 7.5")]


@pytest.mark.parametrize("kind,text", AXIS_CASES)
def test_parse_axis_values_matches_jax(kind, text):
    assert xyz.parse_axis_values(kind, text) == \
        jxyz.parse_axis_values(kind, text)


def test_zero_step_is_refused_as_in_jax():
    for mod in (xyz, jxyz):
        with pytest.raises(ValueError, match="zero step"):
            mod.parse_axis_values("int", "1-5 (+0)")


def port_stub_execute(log):
    """JAX ``tests/test_xyz.py``'s stub execute, with the port's types."""
    def execute(p):
        log.append(p)
        img = np.full((8, 8, 3), len(log) * 10 % 255, np.uint8)
        return GenerationResult(
            images=[array_to_b64png(img)], seeds=[p.seed], subseeds=[0],
            prompts=[p.prompt], negative_prompts=[p.negative_prompt],
            infotexts=[f"Steps: {p.steps}"], worker_labels=[""])
    return execute


XYZ_CASES = {
    "grid": [{"x_axis": "Steps", "x_values": "10,20",
              "y_axis": "CFG Scale", "y_values": "5,7,9"}],
    "sr": [{"x_axis": "Prompt S/R", "x_values": "red, blue, green"}],
    "z": [{"x_axis": "Steps", "x_values": "10,20",
           "z_axis": "CFG Scale", "z_values": "5,9"}],
    "positional": ["Seed", "100,200", "Sampler", "Euler a, Heun"],
    "extra-fields": [],
    "sr-and-steps": [{"x_axis": "Prompt S/R", "x_values": "red, blue"},
                     {"y_axis": "Steps", "y_values": "10,20"}],
    "denoising": [{"x_axis": "Denoising", "x_values": "0.2-0.8 [4]",
                   "y_axis": "Clip skip", "y_values": "1-2"}],
}


@pytest.mark.parametrize("case", sorted(XYZ_CASES))
def test_run_xyz_matches_jax(case):
    body = dict(prompt="a red cat", negative_prompt="red", seed=4,
                script_name="x/y/z plot", script_args=XYZ_CASES[case])
    if case == "extra-fields":
        body.update(x_axis="Var. seed", x_values="1,2,3")
    log, jlog = [], []
    got = xyz.run_xyz(GenerationPayload(**body), port_stub_execute(log),
                      known_samplers=["Euler a", "Heun"])
    want = jxyz.run_xyz(jpayload.GenerationPayload(**body),
                        jax_stub_execute(jlog),
                        known_samplers=["Euler a", "Heun"])
    fields = ("prompt", "negative_prompt", "seed", "subseed", "steps",
              "cfg_scale", "sampler_name", "denoising_strength",
              "clip_skip")
    assert [[getattr(c, f) for f in fields] for c in log] == \
        [[getattr(c, f) for f in fields] for c in jlog]
    for f in ("seeds", "subseeds", "prompts", "negative_prompts",
              "infotexts", "worker_labels"):
        assert getattr(got, f) == getattr(want, f), f
    assert len(got.images) == len(want.images)
    for a, b in zip(got.images, want.images):
        assert np.array_equal(b64png_to_array(a), b64png_to_array(b))


BAD_XYZ = {
    "unknown-axis": [{"x_axis": "nope", "x_values": "1"}],
    "cap": [{"x_axis": "Seed", "x_values": "1-101"}],
    "sampler": [{"x_axis": "Sampler", "x_values": "Euler a, Bogus"}],
    "ints": [3, 7],
    "after-dict": [{"x_axis": "Steps", "x_values": "10"}, 3],
    "mixed": [{"x_axis": "Steps", "x_values": "10"}, "Seed"],
    "overlong": ["Steps", "10", "CFG Scale", "5", "Seed", "1,2", "tail"],
    "empty-dict": [{}],
}


@pytest.mark.parametrize("case", sorted(BAD_XYZ))
def test_run_xyz_refuses_what_jax_refuses(case):
    body = dict(prompt="x", script_name="x/y/z plot",
                script_args=BAD_XYZ[case])
    with pytest.raises(ValueError) as got:
        xyz.run_xyz(GenerationPayload(**body), port_stub_execute([]),
                    known_samplers=["Euler a"])
    with pytest.raises(ValueError) as want:
        jxyz.run_xyz(jpayload.GenerationPayload(**body), jax_stub_execute([]),
                     known_samplers=["Euler a"])
    assert str(got.value) == str(want.value)


def test_interrupted_grid_is_partial_as_in_jax():
    results = []
    for mod, pmod, stub, state in (
            (xyz, payload, port_stub_execute, GenerationState()),
            (jxyz, jpayload, jax_stub_execute, JaxState())):
        log = []
        inner = stub(log)

        def execute(p, inner=inner, log=log, state=state):
            res = inner(p)
            if len(log) == 3:
                state.flag.interrupt()
            return res

        p = pmod.GenerationPayload(
            prompt="x", seed=1, script_name="x/y/z plot",
            script_args=[{"x_axis": "Steps", "x_values": "10,20",
                          "y_axis": "CFG Scale", "y_values": "5,7,9"}])
        out = mod.run_xyz(p, execute, state=state)
        assert len(log) == 3
        results.append([b64png_to_array(i) for i in out.images])
    assert len(results[0]) == len(results[1]) == 4
    for a, b in zip(*results):
        assert np.array_equal(a, b)


# -- images against the JAX engine ------------------------------------------

BASE = dict(negative_prompt="blurry", steps=3, width=32, height=32, seed=21,
            subseed=5)
MATRIX = dict(BASE, prompt="a cow|red|" + LONG, batch_size=2,
              script_name="prompt matrix")
FILE_TEXT = "a cow\n# a comment\na (red:1.2) barn\n" + LONG + "\nsnow"


def _pattern(h, w):
    y, x = np.mgrid[0:h, 0:w]
    return np.stack([(x * 9) % 256, (y * 7) % 256, ((x + y) * 4) % 256],
                    -1).astype(np.uint8)


REQUESTS = {
    "matrix-txt2img": MATRIX,
    "matrix-img2img": dict(MATRIX, denoising_strength=0.6,
                           init_images=[array_to_b64png(_pattern(32, 32))]),
    "matrix-hires": dict(MATRIX, enable_hr=True, hr_scale=2.0,
                         denoising_strength=0.6),
    "file": dict(BASE, prompt="ui prompt", batch_size=2,
                 script_name="prompts from file or textbox",
                 script_args=[False, False, FILE_TEXT]),
    "file-iterate": dict(BASE, prompt="ui prompt", batch_size=2,
                         script_name="prompts from file or textbox",
                         script_args=[True, False, FILE_TEXT]),
}


@pytest.fixture(scope="module")
def params():
    return jax.device_get(jax.jit(init_params, static_argnums=0)(JTINY))


@pytest.fixture(scope="module")
def jax_engine(params):
    return JaxEngine(JTINY, params, chunk_size=4, state=JaxState())


@pytest.fixture(scope="module")
def port(params):
    return Engine(TINY, bridge.flax_to_torch(TINY, params), chunk_size=4,
                  state=GenerationState(), device="cpu")


def pixels(b64):
    return b64png_to_array(b64).astype(np.int32)


def assert_same_images(got, want):
    assert got.seeds == want.seeds
    assert got.subseeds == want.subseeds
    assert got.prompts == want.prompts
    assert got.infotexts == want.infotexts
    assert len(got.images) == len(want.images)
    for a, b in zip(got.images, want.images):
        pa, pb = pixels(a), pixels(b)
        assert pa.shape == pb.shape
        assert np.abs(pa - pb).max() <= 1
        assert pa.std() > 1.0


def _run(engine, pmod, body):
    p = pmod.GenerationPayload(**body)
    return engine.img2img(p) if body.get("init_images") else engine.txt2img(p)


@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_per_image_prompts_match_jax(jax_engine, port, name):
    body = REQUESTS[name]
    want = _run(jax_engine, jpayload, body)
    got = _run(port, payload, body)
    assert_same_images(got, want)
    assert len(got.images) == 4
    if name.startswith("matrix"):
        assert len(set(got.seeds)) == 1
        assert got.prompts[2] == "a cow, " + LONG
    else:
        assert got.prompts == ["a cow", "a (red:1.2) barn", LONG, "snow"]
        assert got.seeds == ([21, 22, 23, 24] if name == "file-iterate"
                             else [21] * 4)
    assert all(t.startswith(p + "\n")
               for t, p in zip(got.infotexts, got.prompts))


def test_refiner_matrix_on_tiny_xl_matches_jax():
    flax = {f: jax.device_get(jax.jit(init_params, static_argnums=0)(f))
            for f in (JTINY_XL, JTINY_REFINER)}
    jref = JaxEngine(JTINY_REFINER, flax[JTINY_REFINER], chunk_size=4,
                     state=JaxState(), model_name=REFINER)
    jbase = JaxEngine(JTINY_XL, flax[JTINY_XL], chunk_size=4,
                      state=JaxState(),
                      engine_provider=lambda n: jref if n == REFINER
                      else None)
    ref = Engine(TINY_REFINER, bridge.flax_to_torch(
        TINY_REFINER, flax[JTINY_REFINER]), chunk_size=4,
        state=GenerationState(), model_name=REFINER, device="cpu")
    base = Engine(TINY_XL, bridge.flax_to_torch(TINY_XL, flax[JTINY_XL]),
                  chunk_size=4, state=GenerationState(), device="cpu",
                  engine_provider=lambda n: ref if n == REFINER else None)
    body = dict(MATRIX, refiner_checkpoint=REFINER, refiner_switch_at=0.5)
    want = _run(jbase, jpayload, body)
    got = _run(base, payload, body)
    assert_same_images(got, want)
    plain = _run(base, payload, MATRIX)
    assert plain.images != got.images


def test_subrange_equals_the_whole_requests_rows(port):
    body = REQUESTS["matrix-txt2img"]
    whole = port.txt2img(GenerationPayload(**body))
    p = payload.apply_scripts(GenerationPayload(**body))
    part = port.generate_range(p, 2, 2)
    assert part.images == whole.images[2:]
    assert part.prompts == whole.prompts[2:]
    assert part.infotexts == whole.infotexts[2:]


PIN_TEXT = "a cow\na (red:1.2) barn\n" + LONG


@pytest.mark.parametrize("remote_kind", ["local", "http"])
def test_fleet_pins_every_row_and_matches_jax_ranges(params, jax_engine,
                                                     port, remote_kind):
    """3 lines, the last past 75 tokens: the master's range (lines 0-1)
    holds only short lines. The pin over every row is 2 chunks and reaches
    the remote with its slice (a ``LocalBackend``, or an ``HTTPBackend``
    to a node serving a World of its own); the pin of the UI prompt and
    the negative prompt alone would be 1, and gives the short range other
    images."""
    body = dict(BASE, prompt="ui prompt", batch_size=1,
                script_name="prompts from file or textbox",
                script_args=[True, False, PIN_TEXT])
    remote = Engine(TINY, bridge.flax_to_torch(TINY, params), chunk_size=4,
                    state=GenerationState(), device="cpu")
    seen = []
    for engine in (port, remote):
        def record(p, *a, _orig=engine.generate_range, **kw):
            seen.append((p.all_prompts, p.context_chunks))
            return _orig(p, *a, **kw)
        engine.generate_range = record
    srv = None
    try:
        world = World()
        world.add_worker(WorkerNode("master", LocalBackend(port),
                                    master=True, avg_ipm=2 * IPM))
        if remote_kind == "http":
            node = World()
            node.add_worker(WorkerNode("master", LocalBackend(remote),
                                       master=True, avg_ipm=IPM))
            srv = ApiServer(node, port=0).start()
            backend = HTTPBackend("127.0.0.1", srv.port)
        else:
            backend = LocalBackend(remote)
        world.add_worker(WorkerNode("remote", backend, avg_ipm=IPM))
        got = world.execute(GenerationPayload(**body))
    finally:
        del port.generate_range
        if srv is not None:
            srv.stop()
    assert [(j.worker.label, j.start_index, j.batch_size)
            for j in world.jobs] == [("master", 0, 2), ("remote", 2, 1)]
    lines = PIN_TEXT.split("\n")
    full = jpayload.apply_scripts(jpayload.GenerationPayload(**body))
    pin = jax_engine.request_context_chunks(full)
    assert pin == 2
    assert sorted((tuple(a), n) for a, n in seen) == sorted(
        [(tuple(lines[:2]), 2), (tuple(lines[2:]), 2)])
    full.context_chunks = pin
    want = jax_engine.generate_range(full.model_copy(), 0, 2)
    want.extend(jax_engine.generate_range(full.model_copy(), 2, 1))
    assert got.prompts == want.prompts == lines
    assert got.seeds == want.seeds == [21, 22, 23]
    served = ["", "", ", Worker Label: master" if srv is not None else ""]
    assert got.infotexts == [
        t + inner + f", Worker Label: {w}" for t, inner, w in
        zip(want.infotexts, served, ["master", "master", "remote"])]
    for a, b in zip(got.images, want.images):
        assert np.abs(pixels(a) - pixels(b)).max() <= 1
    # the fault: the short range conditioned at 1 chunk
    short = payload.apply_scripts(GenerationPayload(**body))
    short.context_chunks = port.request_context_chunks(GenerationPayload(
        prompt=short.prompt, negative_prompt=short.negative_prompt))
    assert short.context_chunks == 1
    bad = port.generate_range(short, 0, 2)
    assert max(np.abs(pixels(a) - pixels(b)).max()
               for a, b in zip(bad.images, want.images[:2])) > 1


# -- the server -------------------------------------------------------------


def call(server, path, body=None):
    url = f"http://127.0.0.1:{server.port}{path}"
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        url, data=data, method="GET" if body is None else "POST",
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("models")
    os.makedirs(root / "embeddings")
    from safetensors.numpy import save_file

    rng = np.random.default_rng(5)
    save_file({"emb_params": rng.standard_normal((2, 32)).astype(
        np.float32)}, str(root / "embeddings" / "Tok.safetensors"))
    import torch

    torch.save({"string_to_param": {"*": torch.from_numpy(
        rng.standard_normal((3, 32)).astype(np.float32))}},
        str(root / "embeddings" / "neg.pt"))
    (root / "embeddings" / "broken.bin").write_bytes(b"junk")
    (root / "styles.csv").write_text(STYLES_CSV, encoding="utf-8")
    return str(root)


@pytest.fixture(scope="module")
def world_server(model_dir, port):
    registry = ModelRegistry(model_dir, device="cpu")
    port.embedding_store = registry.embedding_store
    world = World()
    world.add_worker(WorkerNode("master", LocalBackend(port), master=True,
                                avg_ipm=IPM))
    srv = ApiServer(world, port=0, registry=registry).start()
    yield srv
    srv.stop()
    port.embedding_store = None


BODY = dict(prompt="a tok cow", negative_prompt="neg", steps=2, width=32,
            height=32, seed=3)


def test_embeddings_route_matches_jax(world_server, model_dir):
    status, resp = call(world_server, "/sdapi/v1/embeddings")
    assert status == 200
    jstore = jemb.EmbeddingStore(os.path.join(model_dir, "embeddings"))
    want = JaxApiServer.handle_embeddings(types.SimpleNamespace(
        registry=types.SimpleNamespace(embedding_store=jstore)))
    assert resp == json.loads(json.dumps(want))
    assert resp["loaded"]["tok"]["vectors"] == 2
    assert resp["loaded"]["neg"]["shape"] == 32
    assert list(resp["skipped"]) == ["broken"]


def test_styled_request_gives_the_expanded_prompts_bytes(world_server):
    status, styled = call(world_server, "/sdapi/v1/txt2img",
                          dict(BODY, prompt="a cow", styles=["st"]))
    assert status == 200
    status, plain = call(world_server, "/sdapi/v1/txt2img",
                         dict(BODY, prompt="a cow, in snow",
                              negative_prompt="neg, ugly"))
    assert status == 200
    assert styled["images"] == plain["images"]
    assert json.loads(styled["info"])["all_prompts"] == ["a cow, in snow"]


def test_xyz_plot_gives_a_grid_and_the_cells(world_server):
    body = dict(BODY, script_name="x/y/z plot", script_args=[
        {"x_axis": "Steps", "x_values": "2,3",
         "y_axis": "CFG Scale", "y_values": "5,7"}])
    status, resp = call(world_server, "/sdapi/v1/txt2img", body)
    assert status == 200
    assert len(resp["images"]) == 5
    grid = b64png_to_array(resp["images"][0])
    assert grid.shape[0] >= 64 and grid.shape[1] >= 64
    for b64, (cfg, steps) in zip(resp["images"][1:],
                                 [(5, 2), (5, 3), (7, 2), (7, 3)]):
        status, alone = call(world_server, "/sdapi/v1/txt2img",
                             dict(BODY, steps=steps, cfg_scale=cfg))
        assert alone["images"] == [b64]


@pytest.mark.parametrize("extra", [
    {"prompt": "x|" + "|".join(f"o{i}" for i in range(11)),
     "script_name": "prompt matrix"},
    {"script_name": "x/y/z plot",
     "script_args": [{"x_axis": "Seed", "x_values": "1-101"}]},
    {"script_name": "x/y/z plot",
     "script_args": [{"x_axis": "Sampler", "x_values": "Bogus"}]},
])
def test_refused_scripts_answer_422(world_server, extra):
    master = world_server.source.master()
    before = master.health.summary()["requests"]
    status, resp = call(world_server, "/sdapi/v1/txt2img",
                        dict(BODY, **extra))
    assert status == 422 and resp["detail"]
    assert master.health.summary()["requests"] == before


def test_xyz_bypasses_the_dispatcher(port, monkeypatch):
    monkeypatch.setenv("SDTPU_BUCKET_LADDER", "32x32")
    srv = ApiServer(port, port=0).start()
    try:
        METRICS.clear()
        body = dict(BODY, prompt="a cow", script_name="x/y/z plot",
                    script_args=["Seed", "3,4"])
        status, resp = call(srv, "/sdapi/v1/txt2img", body)
        assert status == 200 and len(resp["images"]) == 3
        assert METRICS.summary()["dispatches"] == 0
        status, alone = call(srv, "/sdapi/v1/txt2img",
                             dict(BODY, prompt="a cow", seed=4))
        assert np.abs(pixels(alone["images"][0])
                      - pixels(resp["images"][2])).max() <= 1
        status, matrix = call(srv, "/sdapi/v1/txt2img",
                              dict(BODY, prompt="a cow|red",
                                   script_name="prompt matrix"))
        assert status == 200
        assert json.loads(matrix["info"])["all_prompts"] == [
            "a cow", "a cow, red"]
    finally:
        srv.stop()


def test_cli_generate_with_styles_embeddings_and_xyz(model_dir, tmp_path,
                                                     capsys):
    """``cli generate --model-dir``: the engine holds the registry's
    embeddings, ``--style`` expands from ``styles.csv`` and ``--xyz-x``
    writes the grid and one PNG per cell."""
    cfg = str(tmp_path / "fleet.json")
    config_mod.save_config(config_mod.ConfigModel(workers=[
        {"master": config_mod.WorkerModel(master=True, avg_ipm=IPM)}]), cfg)
    common = ["--family", "tiny", "--device", "cpu", "--model-dir",
              model_dir, "--distributed-config", cfg]
    world, registry = cli._build_world(cli.build_parser().parse_args(
        ["generate", "--prompt", "x", *common]))
    assert world.master().backend.engine.embedding_store is \
        registry.embedding_store
    assert registry.embedding_store.names() == ["broken", "neg", "tok"]
    out = str(tmp_path / "out")
    assert cli.main(["generate", "--prompt", "a tok cow", "--steps", "2",
                     "--size", "32x32", "--image-seed", "3", "--style",
                     "st", "--xyz-x", "Steps: 1,2", "--outdir", out,
                     *common]) == 0
    printed = capsys.readouterr().out
    assert len(os.listdir(out)) == 3
    assert printed.count("a tok cow, in snow | Negative prompt: ugly") == 3
    assert "Steps: 1," in printed and "Steps: 2," in printed


@pytest.mark.parametrize("where", ["inside", "beside"])
def test_registry_store_survives_switches_and_rescans(tmp_path, where):
    """The registry's one store: ``<model_dir>/embeddings``, else
    ``embeddings/`` beside the model directory; every engine it builds
    holds it, and a refresh rescans it in place."""
    from safetensors.numpy import save_file

    model_dir = tmp_path / "models"
    write_tiny_checkpoint(str(model_dir), "amodel")
    write_tiny_checkpoint(str(model_dir), "bmodel")
    emb = model_dir / "embeddings" if where == "inside" \
        else tmp_path / "embeddings"
    os.makedirs(emb)
    save_file({"emb_params": np.ones((2, 32), np.float32)},
              str(emb / "tok.safetensors"))
    registry = ModelRegistry(str(model_dir), device="cpu")
    store = registry.embedding_store
    assert store.names() == ["tok"] and store.generation == 1
    first = registry.activate("amodel")
    assert first.embedding_store is store
    save_file({"emb_params": np.ones((1, 32), np.float32)},
              str(emb / "late.safetensors"))
    registry.refresh()
    assert registry.embedding_store is store and store.generation == 2
    assert store.names() == ["late", "tok"]
    assert registry.activate("bmodel").embedding_store is store
