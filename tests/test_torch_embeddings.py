"""The port's textual inversion against the JAX package's, on the CPU.

Loader: every file format (``emb_params``, ``clip_l``/``clip_g``, F16,
webui's ``string_to_param`` ``.pt``, diffusers' one-tensor ``.bin``) gives
the JAX loader's vectors exactly, and the store's discovery, bad-file
skipping, lazy counts and rescan generation behave as the JAX store's.
Tokenizer: ``tokenize_with_embeddings`` gives the JAX ids, weights and
injections exactly (word boundaries, emphasis, chunk boundaries, BREAK).
Conditioning: a prompt and a negative prompt with embeddings give the JAX
engine's conditioning on TINY and TINY_XL in f32 within 1e-5; an embedding
equal to a word's token rows reproduces the word's conditioning exactly; a
width mismatch is skipped in both packages; a traced LoRA set that
touches the text encoder takes the injection too. One txt2img request with
embeddings gives the JAX engine's image within 1 level.
"""

import numpy as np
import pytest
import torch

import jax

from stable_diffusion_webui_distributed_tpu.models import embeddings as jemb
from stable_diffusion_webui_distributed_tpu.models.configs import TINY as JTINY
from stable_diffusion_webui_distributed_tpu.models.configs import (
    TINY_XL as JTINY_XL,
)
from stable_diffusion_webui_distributed_tpu.models.prompt import (
    tokenize_with_embeddings as jax_tokenize,
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
from stable_diffusion_webui_distributed_tpu_torch.models import embeddings
from stable_diffusion_webui_distributed_tpu_torch.models.configs import (
    TINY,
    TINY_XL,
)
from stable_diffusion_webui_distributed_tpu_torch.models.prompt import (
    tokenize_with_embeddings,
)
from stable_diffusion_webui_distributed_tpu_torch.models.tokenizer import (
    load_tokenizer,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline.engine import Engine
from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    GenerationPayload,
    b64png_to_array,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.interrupt import (
    GenerationState,
)
from test_pipeline import init_params
from test_torch_lora import make_adapter

#: a word of two fallback-tokenizer tokens, and the embedding that holds
#: its token-embedding rows
WORD = "snowy owl"
EXACT = "tok_exact"


def _save_st(path, tensors):
    from safetensors.numpy import save_file

    save_file(tensors, str(path))


def _write_formats(d):
    """One file per format the loaders take; returns ``{name: path}``."""
    rng = np.random.default_rng(7)
    vec = lambda n, h: rng.standard_normal((n, h)).astype(np.float32)  # noqa: E731
    _save_st(d / "single.safetensors", {"emb_params": vec(3, 16)})
    _save_st(d / "dual.safetensors", {"clip_l": vec(2, 16),
                                      "clip_g": vec(2, 32)})
    _save_st(d / "half.safetensors",
             {"emb_params": vec(2, 16).astype(np.float16)})
    _save_st(d / "onevec.safetensors", {"emb_params": vec(1, 16)[0]})
    torch.save({"string_to_param": {"*": torch.from_numpy(vec(2, 16))},
                "name": "webui"}, str(d / "webui.pt"))
    torch.save({"string_to_param": {"<s>": torch.from_numpy(vec(4, 16))}},
               str(d / "otherkey.pt"))
    torch.save({"<tok>": torch.from_numpy(vec(5, 16))},
               str(d / "diffusers.bin"))
    return {p.stem: str(p) for p in d.iterdir()}


@pytest.fixture(scope="module")
def format_files(tmp_path_factory):
    return _write_formats(tmp_path_factory.mktemp("formats"))


@pytest.mark.parametrize("name", ["single", "dual", "half", "onevec", "webui",
                                  "otherkey", "diffusers"])
def test_every_format_loads_the_jax_vectors(format_files, name):
    want = jemb.load_embedding(format_files[name])
    got = embeddings.load_embedding(format_files[name])
    assert got.name == want.name == name
    assert got.n_vectors == want.n_vectors
    assert got.clip_l.dtype == np.float32
    assert np.array_equal(got.clip_l, want.clip_l)
    if want.clip_g is None:
        assert got.clip_g is None
    else:
        assert np.array_equal(got.clip_g, want.clip_g)


def test_unequal_vector_counts_are_refused(tmp_path):
    _save_st(tmp_path / "bad.safetensors",
             {"clip_l": np.zeros((2, 16), np.float32),
              "clip_g": np.zeros((3, 32), np.float32)})
    for mod in (jemb, embeddings):
        with pytest.raises(ValueError, match="clip_g has 3"):
            mod.load_embedding(str(tmp_path / "bad.safetensors"))


def test_store_behaves_as_the_jax_store(tmp_path, caplog):
    _save_st(tmp_path / "MyStyle.safetensors",
             {"emb_params": np.ones((2, 16), np.float32)})
    (tmp_path / "broken.safetensors").write_bytes(b"not a tensor file")
    (tmp_path / "notes.txt").write_text("ignored")
    stores = [mod.EmbeddingStore(str(tmp_path)) for mod in (jemb, embeddings)]
    for store in stores:
        assert store.names() == ["broken", "mystyle"]
        assert store.generation == 1
        counts = store.vector_counts()
        assert sorted(counts) == ["broken", "mystyle"]
        assert counts["MYSTYLE".lower()] == 2
        assert counts.get("broken") is None
        assert store.lookup("MYSTYLE").n_vectors == 2
        assert store.lookup("unknown") is None
        _save_st(tmp_path / "late.safetensors",
                 {"emb_params": np.zeros((1, 16), np.float32)})
        store.rescan(str(tmp_path))
        assert store.generation == 2
        assert "late" in store.names()
        (tmp_path / "late.safetensors").unlink()
    assert "broken" in caplog.text


def test_counts_load_only_the_names_read(tmp_path, monkeypatch):
    _save_st(tmp_path / "style.safetensors",
             {"emb_params": np.ones((2, 8), np.float32)})
    store = embeddings.EmbeddingStore(str(tmp_path))
    loads = []
    orig = embeddings.load_embedding
    monkeypatch.setattr(embeddings, "load_embedding",
                        lambda p: loads.append(p) or orig(p))
    counts = store.vector_counts()
    assert bool(counts) and list(counts) == ["style"] and not loads
    assert counts["style"] == 2 and len(loads) == 1


FILLER = " ".join(f"w{i}" for i in range(73))
TOKENIZER_CASES = {
    "placeholders": ("a MyStyle cat", {"mystyle": 2}),
    "word-boundary": ("restyled text", {"style": 1}),
    "hyphen-after": ("mystyle-x and MyStyle", {"mystyle": 1}),
    "longest-first": ("style-v2, style", {"style": 1, "style-v2": 3}),
    "emphasis": ("(MyStyle:1.5) [cat]", {"mystyle": 1}),
    "no-embeddings": ("plain words", None),
    "chunk-boundary": (FILLER + " myemb tail", {"myemb": 8}),
    "long-run": ("x " + "myemb", {"myemb": 80}),
    "break": ("a myemb BREAK myemb b", {"myemb": 2}),
    "unloadable": ("a gone cat", {"gone": 0}),
}


@pytest.mark.parametrize("case", sorted(TOKENIZER_CASES))
def test_tokenizer_matches_jax(case):
    text, counts = TOKENIZER_CASES[case]
    tok = load_tokenizer(None, TINY.text_encoder.vocab_size)
    ids, w, inj = tokenize_with_embeddings(tok, text, counts)
    jids, jw, jinj = jax_tokenize(tok, text, counts)
    assert np.array_equal(ids, jids)
    assert np.array_equal(w, jw)
    assert inj == jinj
    if case == "chunk-boundary":
        # the 8-vector run opens the second chunk instead of splitting
        assert {r for r, _, _, _ in inj} == {1}
    if case == "emphasis":
        assert w[0, inj[0][1]] == pytest.approx(1.5)


def _rows_of(table, tok, text):
    return np.asarray(table)[np.asarray(tok.encode(text))].astype(np.float32)


@pytest.fixture(scope="module")
def emb_dir(tmp_path_factory):
    """seeded embeddings for TINY (hidden 32) and TINY_XL (32 + 32)."""
    d = tmp_path_factory.mktemp("embeddings")
    rng = np.random.default_rng(3)
    h_l = JTINY.text_encoder.hidden_size
    h_g = JTINY_XL.text_encoder_2.hidden_size
    _save_st(d / "tok.safetensors", {
        "emb_params": rng.standard_normal((2, h_l)).astype(np.float32)})
    torch.save({"string_to_param": {"*": torch.from_numpy(
        rng.standard_normal((3, h_l)).astype(np.float32))}},
        str(d / "neg.pt"))
    _save_st(d / "xl.safetensors", {
        "clip_l": rng.standard_normal((2, h_l)).astype(np.float32),
        "clip_g": rng.standard_normal((2, h_g)).astype(np.float32)})
    _save_st(d / "wide.safetensors",
             {"emb_params": np.ones((1, 999), np.float32)})
    return d


def _engines(family, jfamily, store_dir, **kw):
    flax = jax.device_get(jax.jit(init_params, static_argnums=0)(jfamily))
    jax_engine = JaxEngine(jfamily, flax, chunk_size=4, state=JaxState(),
                           embedding_store=jemb.EmbeddingStore(
                               str(store_dir)), **kw)
    port = Engine(family, bridge.flax_to_torch(family, flax), chunk_size=4,
                  state=GenerationState(), device="cpu",
                  embedding_store=embeddings.EmbeddingStore(str(store_dir)))
    return flax, jax_engine, port


@pytest.fixture(scope="module")
def tiny(emb_dir):
    return _engines(TINY, JTINY, emb_dir)


@pytest.fixture(scope="module")
def tiny_xl(emb_dir):
    return _engines(TINY_XL, JTINY_XL, emb_dir)


COND_CASES = {
    "tiny": ("tiny", dict(prompt="a tok cat (tok:1.2)",
                          negative_prompt="neg, blurry")),
    "tiny-per-image": ("tiny", dict(prompt="x", negative_prompt="neg",
                                    all_prompts=["a tok", "b", "a tok"])),
    "tiny-wide-skipped": ("tiny", dict(prompt="a wide cat",
                                       negative_prompt="wide")),
    "tiny-xl": ("tiny_xl", dict(prompt="a xl cat", negative_prompt="xl")),
    "tiny-xl-single-skipped": ("tiny_xl", dict(prompt="a tok cat",
                                               negative_prompt="neg")),
}


@pytest.mark.parametrize("case", sorted(COND_CASES))
def test_conditioning_matches_jax(request, case):
    fixture, body = COND_CASES[case]
    _, jax_engine, port = request.getfixturevalue(fixture)
    prompts = body.get("all_prompts")
    jconds, jpooled = jax_engine.encode_prompts(JaxPayload(**body),
                                                prompts=prompts)
    with torch.inference_mode():
        conds, pooled = port.encode_prompts(GenerationPayload(**body),
                                            prompts=prompts)
    for got, want in zip((*conds, *pooled), (*jconds, *jpooled)):
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape
        assert np.abs(got.numpy() - want).max() <= 1e-5
    if prompts:
        assert conds[1].shape[0] == 3
        assert torch.equal(conds[1][0], conds[1][2])


def test_width_mismatch_is_skipped_as_no_vector(tiny, caplog):
    """A 999-wide embedding under a 32-wide encoder keeps its placeholder's
    id-0 row in both packages, with a warning."""
    _, _, port = tiny
    body = dict(prompt="a wide cat")
    port._cond_cache.clear()
    with torch.inference_mode():
        (_, got), _ = port.encode_prompts(GenerationPayload(**body))
        saved, port.embedding_store = port.embedding_store, None
        try:
            tok = port.tokenizer
            ids, w, inj = tokenize_with_embeddings(
                tok, body["prompt"], {"wide": 1})
            plain, _ = port._encode(ids, w, 0)
        finally:
            port.embedding_store = saved
    assert inj and torch.equal(got, plain)
    assert "width 999 != encoder width 32" in caplog.text


@pytest.mark.parametrize("fixture", ["tiny", "tiny_xl"])
def test_embedding_of_a_words_rows_reproduces_the_word(fixture, tmp_path,
                                                       request):
    """An embedding whose vectors are the token-embedding rows of
    ``WORD`` gives the word's conditioning exactly (SDXL: both encoders'
    rows, the pooled output included)."""
    flax, _, port = request.getfixturevalue(fixture)
    tok = port.tokenizer
    te = flax["text_encoder"]["token_embedding"]["embedding"]
    tensors = {"emb_params": _rows_of(te, tok, WORD)}
    if port.text_encoder_2 is not None:
        te2 = flax["text_encoder_2"]["token_embedding"]["embedding"]
        tensors = {"clip_l": tensors["emb_params"],
                   "clip_g": _rows_of(te2, tok, WORD)}
    _save_st(tmp_path / f"{EXACT}.safetensors", tensors)
    # the fallback tokenizer's pooled row is at the largest id: a context
    # word with a larger id than the word's keeps it off the placeholders
    top = max(tok.encode(WORD))
    ctx = next(f"z{i}" for i in range(1000) if tok.encode(f"z{i}")[0] > top)
    engine = Engine(port.family, bridge.flax_to_torch(port.family, flax),
                    state=GenerationState(), device="cpu",
                    embedding_store=embeddings.EmbeddingStore(str(tmp_path)))
    with torch.inference_mode():
        got = engine.encode_prompts(GenerationPayload(
            prompt=f"a {EXACT} {ctx}", negative_prompt=f"{EXACT} {ctx}"))
        want = engine.encode_prompts(GenerationPayload(
            prompt=f"a {WORD} {ctx}", negative_prompt=f"{WORD} {ctx}"))
    for a, b in zip((*got[0], *got[1]), (*want[0], *want[1])):
        assert torch.equal(a, b)


def test_rescan_serves_no_stale_conditioning(tmp_path, tiny):
    """The conditioning cache keys on the store's generation: a file
    replaced on disk and rescanned gives the new vectors."""
    flax, _, _ = tiny
    h = TINY.text_encoder.hidden_size
    _save_st(tmp_path / "tok.safetensors",
             {"emb_params": np.zeros((1, h), np.float32)})
    store = embeddings.EmbeddingStore(str(tmp_path))
    engine = Engine(TINY, bridge.flax_to_torch(TINY, flax),
                    state=GenerationState(), device="cpu",
                    embedding_store=store)
    body = GenerationPayload(prompt="a tok")
    with torch.inference_mode():
        first = engine.encode_prompts(body)[0][1]
        _save_st(tmp_path / "tok.safetensors",
                 {"emb_params": np.ones((1, h), np.float32)})
        assert torch.equal(engine.encode_prompts(body)[0][1], first)
        store.rescan(str(tmp_path))
        assert not torch.equal(engine.encode_prompts(body)[0][1], first)


def test_txt2img_with_embeddings_matches_jax(tiny):
    _, jax_engine, port = tiny
    body = dict(prompt="a tok cow", negative_prompt="neg", steps=3,
                width=32, height=32, seed=11)
    want = jax_engine.txt2img(JaxPayload(**body))
    got = port.txt2img(GenerationPayload(**body))
    assert got.seeds == want.seeds and got.infotexts == want.infotexts
    a = b64png_to_array(got.images[0]).astype(np.int32)
    b = b64png_to_array(want.images[0]).astype(np.int32)
    assert np.abs(a - b).max() <= 1
    unknown = port.txt2img(GenerationPayload(**dict(
        body, prompt="a tokx cow", negative_prompt="negx")))
    assert unknown.images[0] != got.images[0]


def test_traced_lora_path_takes_the_injection(emb_dir, tiny, monkeypatch):
    """Under ``SDTPU_LORA_TRACED=1`` a set that touches the text encoder
    rides into the encode with the injected rows: the conditioning equals
    the JAX traced engine's within 1e-5."""
    monkeypatch.setenv("SDTPU_LORA_TRACED", "1")
    flax, _, _ = tiny
    adapters = {"a": make_adapter(TINY, rank=4, seed=1)}
    jax_engine = JaxEngine(JTINY, flax, state=JaxState(),
                           lora_provider=adapters.get,
                           embedding_store=jemb.EmbeddingStore(str(emb_dir)))
    port = Engine(TINY, bridge.flax_to_torch(TINY, flax),
                  state=GenerationState(), device="cpu",
                  lora_provider=adapters.get,
                  embedding_store=embeddings.EmbeddingStore(str(emb_dir)))
    body = dict(prompt="a tok cow <lora:a:0.8>", negative_prompt="neg")
    jp = JaxPayload(**body)
    jax_engine._apply_prompt_loras(jp)
    jconds, jpooled = jax_engine.encode_prompts(jp)
    with torch.inference_mode():
        p = GenerationPayload(**body)
        port._apply_prompt_loras(p)
        assert port.traced_te_content() and not port._pristine
        conds, pooled = port.encode_prompts(p)
        plain = Engine(TINY, bridge.flax_to_torch(TINY, flax),
                       state=GenerationState(), device="cpu",
                       embedding_store=port.embedding_store)
        (_, untraced), _ = plain.encode_prompts(p)
    for got, want in zip((*conds, *pooled), (*jconds, *jpooled)):
        assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-5
    assert not torch.equal(conds[1], untraced)
