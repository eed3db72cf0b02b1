"""webui prompt syntax: attention emphasis + unlimited prompt length.

Every sdwui worker in the reference deployment applies this grammar to the
prompt strings the master ships over HTTP (the reference passes prompts
verbatim, distributed.py:239-265, and relies on each webui to parse them).
This module owns it natively:

- ``(text)`` multiplies attention by 1.1, ``[text]`` divides by 1.1,
  ``(text:1.3)`` sets an explicit weight, ``\\(`` escapes literals —
  webui's ``parse_prompt_attention`` grammar, reimplemented.
- Prompts longer than CLIP's 75-token window are split into 77-token
  chunks (BOS + 75 + EOS each), encoded separately, and concatenated along
  the sequence axis — cross-attention happily consumes the longer context.
- Per-token weights scale the encoded embeddings, then the chunk mean is
  restored (webui's emphasis implementation: scaling must not shift the
  overall magnitude the UNet was trained to expect).
- Textual-inversion names become placeholder runs whose rows the text
  encoder replaces (:func:`tokenize_with_embeddings`).
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import List, Optional, Tuple

import numpy as np

_ATTENTION_RE = re.compile(r"""
\\\(|\\\)|\\\[|\\]|\\\\|\\|
\(|\[|:\s*([+-]?[.\d]+)\s*\)|\)|]|
[^\\()\[\]:]+|:
""", re.X)

_BREAK_RE = re.compile(r"\s*\bBREAK\b\s*", re.S)


def parse_prompt_attention(text: str) -> List[Tuple[str, float]]:
    """'a (cat:1.3) [dog]' -> [('a ', 1.0), ('cat', 1.3), ('dog', 1/1.1)].

    webui grammar: nested parens multiply, explicit ``:w`` sets the weight
    of the innermost open paren group, backslash escapes literal brackets.
    ``BREAK`` forces a chunk boundary (marked with weight -1 sentinel).
    """
    res: List[List] = []
    round_brackets: List[int] = []
    square_brackets: List[int] = []

    def multiply_range(start: int, multiplier: float):
        for pos in range(start, len(res)):
            res[pos][1] *= multiplier

    for m in _ATTENTION_RE.finditer(text):
        tok = m.group(0)
        weight = m.group(1)
        if tok.startswith("\\"):
            res.append([tok[1:], 1.0])
        elif tok == "(":
            round_brackets.append(len(res))
        elif tok == "[":
            square_brackets.append(len(res))
        elif weight is not None and round_brackets:
            multiply_range(round_brackets.pop(), float(weight))
        elif tok == ")" and round_brackets:
            multiply_range(round_brackets.pop(), 1.1)
        elif tok == "]" and square_brackets:
            multiply_range(square_brackets.pop(), 1.0 / 1.1)
        else:
            parts = _BREAK_RE.split(tok)
            for i, part in enumerate(parts):
                if i > 0:
                    res.append(["BREAK", -1.0])
                if part:
                    res.append([part, 1.0])
    # unclosed brackets behave as if closed at the end (webui semantics)
    for pos in round_brackets:
        multiply_range(pos, 1.1)
    for pos in square_brackets:
        multiply_range(pos, 1.0 / 1.1)
    if not res:
        return [("", 1.0)]
    # merge adjacent segments with equal weight
    merged: List[Tuple[str, float]] = []
    for seg, w in res:
        if merged and merged[-1][1] == w and seg != "BREAK" \
                and merged[-1][0] != "BREAK":
            merged[-1] = (merged[-1][0] + seg, w)
        else:
            merged.append((seg, w))
    return merged


#: Tokens of usable content per 77-token CLIP window (75 + BOS + EOS).
CHUNK_CONTENT = 75


def tokenize_weighted(
    tokenizer, text: str, max_chunks: int = 8
) -> Tuple[np.ndarray, np.ndarray]:
    """Prompt -> (ids (n_chunks, 77), weights (n_chunks, 77)).

    Unlimited-length prompts: content tokens flow into as many 77-token
    windows as needed (capped at ``max_chunks``), each wrapped in BOS/EOS;
    BOS/EOS/padding carry weight 1.0. ``BREAK`` starts a new chunk.
    """
    ids, weights, _ = tokenize_with_embeddings(tokenizer, text, None,
                                               max_chunks)
    return ids, weights


def tokenize_with_embeddings(
    tokenizer,
    text: str,
    embeddings: Optional[Mapping[str, int]],
    max_chunks: int = 8,
) -> Tuple[np.ndarray, np.ndarray, List[Tuple[int, int, str, int]]]:
    """``tokenize_weighted`` plus textual-inversion placeholders.

    ``embeddings`` maps lowercase embedding names to their vector counts
    (``models/embeddings.py`` ``EmbeddingStore.vector_counts``). A mention
    of a name (whole word, case-insensitive, longest name first; a name
    followed by ``-`` does not match) emits that many placeholder tokens
    (id 0; the text encoder replaces their rows with the learned vectors)
    and returns their places as ``(chunk_row, column, name,
    vector_index)``. A run of vectors that does not fit the current chunk
    opens the next one; a name whose file cannot be loaded keeps its text.
    """
    segments = parse_prompt_attention(text)
    emb_re = None
    if embeddings:
        names = sorted(embeddings, key=len, reverse=True)
        emb_re = re.compile(
            r"(?<![\w-])(" + "|".join(re.escape(n) for n in names)
            + r")(?![\w-])", re.IGNORECASE)

    flat_ids: List[int] = []
    flat_w: List[float] = []
    flat_inj: List[Optional[Tuple[str, int]]] = []
    chunks: List[Tuple[List[int], List[float], List]] = []

    def flush():
        nonlocal flat_ids, flat_w, flat_inj
        chunks.append((flat_ids, flat_w, flat_inj))
        flat_ids, flat_w, flat_inj = [], [], []

    def emit(tid: int, w: float, inj=None):
        if len(flat_ids) >= CHUNK_CONTENT:
            flush()
        flat_ids.append(tid)
        flat_w.append(w)
        flat_inj.append(inj)

    for seg, w in segments:
        if seg == "BREAK" and w == -1.0:
            flush()
            continue
        parts = emb_re.split(seg) if emb_re else [seg]
        for i, part in enumerate(parts):
            if emb_re and i % 2 == 1:  # a matched embedding name
                name = part.lower()
                n_vec = embeddings.get(name, 0)
                if n_vec <= 0:  # unloadable file: keep the literal text
                    for tid in tokenizer.encode(part):
                        emit(tid, w)
                    continue
                # the run stays in one chunk (webui opens a new window);
                # a run longer than a whole chunk splits unavoidably
                if flat_ids and n_vec <= CHUNK_CONTENT \
                        and len(flat_ids) + n_vec > CHUNK_CONTENT:
                    flush()
                for vec in range(n_vec):
                    emit(0, w, (name, vec))
            elif part:
                for tid in tokenizer.encode(part):
                    emit(tid, w)
    flush()
    chunks = chunks[:max_chunks] or [([], [], [])]

    n = len(chunks)
    bos = getattr(tokenizer, "bos", 49406)
    eos = getattr(tokenizer, "eos", 49407)
    ids = np.full((n, CHUNK_CONTENT + 2), eos, np.int32)
    weights = np.ones((n, CHUNK_CONTENT + 2), np.float32)
    injections: List[Tuple[int, int, str, int]] = []
    for row, (cid, cw, cinj) in enumerate(chunks):
        ids[row, 0] = bos
        ids[row, 1:1 + len(cid)] = cid
        ids[row, 1 + len(cid)] = eos
        weights[row, 1:1 + len(cw)] = cw
        for col, inj in enumerate(cinj):
            if inj is not None:
                injections.append((row, col + 1, inj[0], inj[1]))
    return ids, weights, injections


def true_token_count(ids: np.ndarray, eos: int) -> int:
    """The tokens that carry meaning in a tokenized ``(n_chunks, 77)``
    prompt: BOS, the content and the closing EOS of each chunk (the EOS
    fill after it is padding). The numerator of the perf ledger's
    ``token_padding_ratio``."""
    total = 0
    for row in ids:
        tail = row[1:]          # past BOS (a BOS equal to EOS never shows)
        eos_at = np.flatnonzero(tail == eos)
        content = int(eos_at[0]) if eos_at.size else CHUNK_CONTENT
        total += 2 + content    # BOS + content + closing EOS
    return total


def pad_chunks(a: np.ndarray, wa: np.ndarray, n: int, eos: int,
               bos: int) -> Tuple[np.ndarray, np.ndarray]:
    """Grow (chunks, 77) ids/weights to ``n`` chunks with empty windows —
    cond and uncond must agree on context length (webui pads the same way).
    """
    have = a.shape[0]
    if have >= n:
        return a, wa
    pad_ids = np.full((n - have, a.shape[1]), eos, np.int32)
    pad_ids[:, 0] = bos
    pad_w = np.ones((n - have, a.shape[1]), np.float32)
    return np.concatenate([a, pad_ids]), np.concatenate([wa, pad_w])
