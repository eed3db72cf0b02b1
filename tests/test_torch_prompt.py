"""The port's copies of the prompt grammar and the tokenizers against the
JAX package's originals: the same prompts must give the same segments,
token ids and weights, exactly (no arithmetic beyond the weight products,
which both compute in Python floats).
"""

import numpy as np
import pytest

from stable_diffusion_webui_distributed_tpu.models import prompt as jprompt
from stable_diffusion_webui_distributed_tpu.models import tokenizer as jtok
from stable_diffusion_webui_distributed_tpu_torch.models import prompt
from stable_diffusion_webui_distributed_tpu_torch.models import tokenizer

PROMPTS = [
    "",
    "a cow",
    "a (red:1.3) cow, [blue] sky, ((very)) \\(literal\\) [unclosed",
    "left BREAK right BREAK",
    "BREAK",
    " ".join(f"w{i}" for i in range(160)) + " (tail:0.6)",  # three chunks
    " ".join(["x"] * 75),  # exactly one full chunk
    " ".join(["y"] * 700),  # past the 8-chunk cap
]


@pytest.mark.parametrize("text", PROMPTS, ids=range(len(PROMPTS)))
def test_parse_prompt_attention_matches_jax(text):
    assert prompt.parse_prompt_attention(text) == \
        jprompt.parse_prompt_attention(text)


@pytest.mark.parametrize("text", PROMPTS, ids=range(len(PROMPTS)))
def test_tokenize_weighted_matches_jax(text):
    ids, w = prompt.tokenize_weighted(tokenizer.FallbackTokenizer(1000), text)
    jids, jw = jprompt.tokenize_weighted(jtok.FallbackTokenizer(1000), text)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(w, jw)
    assert ids.dtype == np.int32 and w.dtype == np.float32


def test_pad_chunks_matches_jax():
    ids, w = prompt.tokenize_weighted(tokenizer.FallbackTokenizer(), "a (b:2)")
    got = prompt.pad_chunks(ids, w, 3, eos=1, bos=0)
    want = jprompt.pad_chunks(ids, w, 3, eos=1, bos=0)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x)


def _tiny_vocab():
    """A byte-level vocabulary with a few merges, enough to exercise BPE."""
    chars = list(tokenizer._bytes_to_unicode().values())
    merges = [("c", "o"), ("co", "w</w>"), ("h", "o"), ("r", "s"),
              ("ho", "rs"), ("e", "</w>")]
    tokens = chars + [c + "</w>" for c in chars]
    tokens += ["".join(m) for m in merges]
    tokens += ["<|startoftext|>", "<|endoftext|>"]
    return {t: i for i, t in enumerate(tokens)}, merges


@pytest.mark.parametrize("text", ["a cow and a horse", "Horses, COWS & 4k",
                                  "café &amp; don't", ""])
def test_clip_bpe_matches_jax(text):
    vocab, merges = _tiny_vocab()
    port = tokenizer.CLIPTokenizer(vocab, merges)
    ref = jtok.CLIPTokenizer(vocab, merges)
    assert port.encode(text) == ref.encode(text)
    np.testing.assert_array_equal(port([text, "cow"]), ref([text, "cow"]))


def test_fallback_tokenizer_matches_jax():
    text = "A photograph of an astronaut riding a horse"
    port, ref = tokenizer.FallbackTokenizer(), jtok.FallbackTokenizer()
    assert port.encode(text) == ref.encode(text)
    np.testing.assert_array_equal(port([text]), ref([text]))
