"""CA001: payload hashing / cache-key construction outside cache/keys.py.

The caching tier's whole correctness story is that every content address
is minted by one module: ``cache/keys.py`` canonicalizes the payload
(post-``fix_seed``, post-scripts), strips the volatile fields, folds in
the model/tower fingerprints, and hashes the result. A second hashing
site — a dispatcher helper that sha256's ``payload.model_dump()`` its
own way, a store call keyed on a hand-built ``(payload.prompt, ...)``
tuple — silently forks the key space: two sites disagree on volatile
fields or canonical ordering and the cache serves stale bytes for one of
them. This rule pins key minting to the sanctioned module at lint time.

Two offense shapes:

- **hashing**: a ``hashlib`` digest constructor (``sha256``/``sha1``/
  ``md5``/``blake2b``/… or ``hashlib.new``) whose argument subtree
  references request-payload content — the name ``payload``, a
  ``.prompt``/``.negative_prompt`` attribute, or a ``.model_dump()``
  call.
- **hand-built key**: a ``get``/``put``/``peek``/``lookup``/``begin``
  call on a cache-ish receiver (name contains ``cache``/``store``/
  ``flight``) whose first argument is an inline tuple referencing
  payload content — a cache keyed on a tuple nobody canonicalized.

Sanctioned sites: ``cache/keys.py`` (the key mint itself) and
``obs/journal.py`` (the journal fingerprints the payload dump for
replay, a digest that never keys a cache). A deliberate out-of-band
site opts out with ``# sdtpu-lint: cachekey`` on the offending line.
"""

from __future__ import annotations

import ast
from typing import List

from .core import Finding, ModuleInfo
from .envrules import _enclosing_symbol

MARKER_PREFIX = "sdtpu-lint:"
MARKER = "cachekey"

#: Modules allowed to hash payload content (path suffixes).
SANCTIONED = ("cache/keys.py", "obs/journal.py")

#: hashlib digest constructors (dotted path suffixes after alias
#: resolution).
_HASH_CTORS = ("sha256", "sha1", "md5", "sha384", "sha512",
               "blake2b", "blake2s", "new")

#: Store methods whose first argument is a key.
_STORE_METHODS = {"get", "put", "peek", "lookup", "begin"}

#: Attribute names that identify request-payload content.
_PAYLOAD_ATTRS = {"prompt", "negative_prompt"}


def _exempt(mod: ModuleInfo, line: int) -> bool:
    payload = mod.marker(line, MARKER_PREFIX)
    return payload is not None and MARKER in payload.split()


def _payloadish(node: ast.AST) -> bool:
    """Does this subtree reference request-payload content?"""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and sub.id == "payload":
            return True
        if isinstance(sub, ast.Attribute) and sub.attr in _PAYLOAD_ATTRS:
            return True
        if isinstance(sub, ast.Call) \
                and isinstance(sub.func, ast.Attribute) \
                and sub.func.attr == "model_dump":
            return True
    return False


def _is_hash_ctor(mod: ModuleInfo, node: ast.Call) -> bool:
    name, resolved = mod.call_name(node)
    if not name:
        return False
    parts = name.split(".")
    return (len(parts) >= 2 and parts[-2] == "hashlib"
            and parts[-1] in _HASH_CTORS)


def _cacheish_receiver(node: ast.Call) -> bool:
    """True for ``<something cache-like>.get/put/...(...)`` calls."""
    func = node.func
    if not isinstance(func, ast.Attribute) \
            or func.attr not in _STORE_METHODS:
        return False
    head = func.value
    # peel call chains like store().put(...) down to the callee name
    while isinstance(head, ast.Call):
        head = head.func
    parts: List[str] = []
    while isinstance(head, ast.Attribute):
        parts.append(head.attr)
        head = head.value
    if isinstance(head, ast.Name):
        parts.append(head.id)
    recv = ".".join(parts).lower()
    return any(w in recv for w in ("cache", "store", "flight"))


def check(modules: List[ModuleInfo]) -> List[Finding]:
    findings: List[Finding] = []
    for mod in modules:
        if mod.path.endswith(SANCTIONED):
            continue
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            line = node.lineno
            if _is_hash_ctor(mod, node):
                if not any(_payloadish(a) for a in
                           list(node.args)
                           + [k.value for k in node.keywords]):
                    continue
                if _exempt(mod, line):
                    continue
                findings.append(Finding(
                    "CA001", mod.path, line,
                    _enclosing_symbol(mod, line),
                    "payload content hashed outside cache/keys.py — "
                    "mint cache keys through cache.keys (or mark a "
                    "deliberate non-key digest with "
                    "'# sdtpu-lint: cachekey')"))
            elif _cacheish_receiver(node) and node.args \
                    and isinstance(node.args[0], ast.Tuple) \
                    and _payloadish(node.args[0]):
                if _exempt(mod, line):
                    continue
                findings.append(Finding(
                    "CA001", mod.path, line,
                    _enclosing_symbol(mod, line),
                    "hand-built payload cache key — canonical keys come "
                    "from cache/keys.py, which strips volatile fields "
                    "and folds in the model fingerprint (or mark with "
                    "'# sdtpu-lint: cachekey')"))
    return findings
