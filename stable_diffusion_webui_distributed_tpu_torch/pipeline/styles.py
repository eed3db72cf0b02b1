"""Prompt styles: webui's ``styles.csv`` applied server-side.

A copy of the JAX package's ``pipeline/styles.py`` (the port imports
nothing from that package). The reference ships style *names* inside payloads and relies on each webui
worker having the same styles.csv (payload fields pass through verbatim,
distributed.py:239-265). Here the node applies them itself: a style's
prompt either replaces ``{prompt}`` or is appended comma-separated, exactly
webui's ``apply_styles_to_prompt``.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, Tuple


def load_styles(path: str) -> Dict[str, Tuple[str, str]]:
    """styles.csv -> {name: (prompt, negative_prompt)}."""
    out: Dict[str, Tuple[str, str]] = {}
    if not os.path.exists(path):
        return out
    with open(path, newline="", encoding="utf-8-sig") as f:
        for row in csv.DictReader(f):
            name = (row.get("name") or "").strip()
            if not name:
                continue
            out[name] = (row.get("prompt") or "",
                         row.get("negative_prompt") or "")
    return out


def apply_style_text(style: str, prompt: str) -> str:
    """webui merge rule: ``{prompt}`` substitutes, otherwise append."""
    if "{prompt}" in style:
        return style.replace("{prompt}", prompt)
    if not style:
        return prompt
    return f"{prompt}, {style}" if prompt else style


def apply_styles(payload, styles: Dict[str, Tuple[str, str]]) -> None:
    """Expand ``payload.styles`` names into prompt/negative_prompt in place
    (unknown names are ignored, like webui)."""
    for name in payload.styles or []:
        entry = styles.get(name)
        if entry is None:
            continue
        payload.prompt = apply_style_text(entry[0], payload.prompt)
        payload.negative_prompt = apply_style_text(
            entry[1], payload.negative_prompt)
    payload.styles = []
