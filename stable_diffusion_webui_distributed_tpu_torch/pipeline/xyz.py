"""X/Y/Z plot: webui's grid-comparison script, run master-side.

A copy of the JAX package's ``pipeline/xyz.py`` (the port imports nothing
from that package).

webui's ``scripts/xyz_grid.py`` executes one full generation per
(x, y, z) cell and assembles labeled comparison grids. The reference
fleet runs it on whichever node the user drives (it is stripped from
remote payloads like any unsupported script, reference
``worker.py:375-404``); here every cell goes through the node's normal
execute path — so on a fleet, EACH CELL is itself distributed across
workers, which the reference cannot do.

Axis value syntax follows webui:
- comma lists: ``10, 20, 30`` (any axis)
- integer ranges: ``1-5`` -> 1,2,3,4,5
- counted ranges: ``1-10 [5]`` -> 5 evenly spaced values
- stepped ranges: ``1-10 (+2)`` -> 1,3,5,7,9
- ``Prompt S/R``: first value is the search text, each value replaces it
  (the first cell keeps the original prompt).

Request shape (sdapi): ``script_name: "x/y/z plot"`` with
``script_args: [{"x_axis": "Steps", "x_values": "10,20", ...}]`` — a
single dict argument beats webui's positional dropdown indices over the
wire; positional args are accepted for the axis-name/value pairs too.
"""

from __future__ import annotations

import math
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    GenerationPayload,
    GenerationResult,
    array_to_b64png,
    b64png_to_array,
    fix_seed,
)

#: axis label -> (value kind, payload field); "prompt s/r" is special-cased
AXES: Dict[str, Tuple[str, Optional[str]]] = {
    "nothing": ("none", None),
    "seed": ("int", "seed"),
    "var. seed": ("int", "subseed"),
    "var. seed strength": ("float", "subseed_strength"),
    "steps": ("int", "steps"),
    "hires steps": ("int", "hr_second_pass_steps"),
    "cfg scale": ("float", "cfg_scale"),
    "denoising": ("float", "denoising_strength"),
    "clip skip": ("int", "clip_skip"),
    "sampler": ("text", "sampler_name"),
    "prompt s/r": ("sr", None),
}

#: hard cap on total cells — each cell is a full (possibly fleet-wide)
#: generation; webui warns, we refuse loudly (surfaces as 422 at the API)
MAX_CELLS = 100

_RANGE = re.compile(r"^\s*(-?\d+(?:\.\d+)?)\s*-\s*(-?\d+(?:\.\d+)?)\s*$")
_COUNT = re.compile(r"^\s*(-?\d+(?:\.\d+)?)\s*-\s*(-?\d+(?:\.\d+)?)\s*"
                    r"\[(\d+)\]\s*$")
_STEP = re.compile(r"^\s*(-?\d+(?:\.\d+)?)\s*-\s*(-?\d+(?:\.\d+)?)\s*"
                   r"\(\+?\s*(-?\d+(?:\.\d+)?)\s*\)\s*$")


def parse_axis_values(kind: str, text: str) -> List[Any]:
    """Expand one axis' value string (webui range/list syntax)."""
    text = (text or "").strip()
    if kind == "none" or not text:
        return [None]
    if kind in ("int", "float"):
        conv = int if kind == "int" else float
        m = _COUNT.match(text)
        if m:
            lo, hi, n = float(m.group(1)), float(m.group(2)), int(m.group(3))
            n = max(1, n)
            if n == 1:
                return [conv(lo)]
            step = (hi - lo) / (n - 1)
            return [conv(round(lo + i * step, 8)) for i in range(n)]
        m = _STEP.match(text)
        if m:
            lo, hi, st = (float(m.group(1)), float(m.group(2)),
                          float(m.group(3)))
            if st == 0:
                raise ValueError("x/y/z plot: zero step in range")
            out, v = [], lo
            while (st > 0 and v <= hi + 1e-9) or (st < 0 and v >= hi - 1e-9):
                out.append(conv(round(v, 8)))
                v += st
            return out
        m = _RANGE.match(text)
        if m and kind == "int":
            lo, hi = int(float(m.group(1))), int(float(m.group(2)))
            step = 1 if hi >= lo else -1
            return list(range(lo, hi + step, step))
        return [conv(v.strip()) for v in text.split(",") if v.strip()]
    # text kinds (sampler, prompt s/r): comma list, whitespace-trimmed
    return [v.strip() for v in text.split(",") if v.strip()]


def _apply(payload: GenerationPayload, axis: str, value: Any,
           search: Optional[str]) -> None:
    kind, field = AXES[axis]
    if kind == "none" or value is None:
        return
    if kind == "sr":
        # Prompt S/R: the FIRST parsed value is the search text; applying
        # the search text itself leaves the prompt unchanged
        if search and search != value:
            payload.prompt = payload.prompt.replace(search, str(value))
            payload.negative_prompt = payload.negative_prompt.replace(
                search, str(value))
        return
    setattr(payload, field, value)


def _axis_label(axis: str, value: Any) -> str:
    if AXES[axis][0] == "none" or value is None:
        return ""
    name = axis.title() if axis != "cfg scale" else "CFG Scale"
    return f"{name}: {value}"


#: positional script_args order (webui-style flat list)
_POSITIONAL_KEYS = ("x_axis", "x_values", "y_axis", "y_values",
                    "z_axis", "z_values")


def _extract_options(payload: GenerationPayload) -> Dict[str, str]:
    """Accept the dict-argument form (script_args=[{...}]), a positional
    list of [x_axis, x_values, y_axis, ...] STRINGS (axis names, not
    webui's internal dropdown indices — those index an install-specific
    AxisOption list and cannot be resolved faithfully here), or fields set
    directly on the payload (extra=allow). A list mixing in non-string
    entries is rejected loudly rather than mis-aligned silently."""
    opts: Dict[str, str] = {}
    positional: List[str] = []
    for a in payload.script_args or []:
        if isinstance(a, dict):
            opts.update({str(k).lower(): v for k, v in a.items()})
        elif isinstance(a, str):
            positional.append(a)
        else:
            # reject unconditionally — a stray int after a dict is just as
            # mis-aligned as one before it (docstring contract)
            raise ValueError(
                "x/y/z plot: positional script_args must be axis-name/value "
                f"strings, got {type(a).__name__} {a!r} (webui dropdown "
                "indices are install-specific and not supported — pass "
                "names, e.g. ['Steps', '10,20'])")
    if opts and positional:
        # dict form and positional form never mix: with opts present the
        # strings would be discarded wholesale, which is just as silent a
        # loss as a dropped tail
        raise ValueError(
            "x/y/z plot: script_args mixes dict options with "
            f"{len(positional)} positional string(s) — pass ONE form "
            "(a single dict, or the flat [x_axis, x_values, ...] list)")
    if len(positional) > len(_POSITIONAL_KEYS):
        raise ValueError(
            f"x/y/z plot: at most {len(_POSITIONAL_KEYS)} positional "
            f"script_args ({', '.join(_POSITIONAL_KEYS)}), got "
            f"{len(positional)} — the tail would be dropped silently")
    if positional:
        opts.update(dict(zip(_POSITIONAL_KEYS, positional)))
    extra = getattr(payload, "model_extra", None) or {}
    for key in _POSITIONAL_KEYS:
        if key in extra and key not in opts:
            opts[key] = extra[key]
    return opts


def is_xyz(payload: GenerationPayload) -> bool:
    return payload.script_name.strip().lower() in ("x/y/z plot", "xyz plot")


def run_xyz(
    payload: GenerationPayload,
    execute: Callable[[GenerationPayload], GenerationResult],
    known_samplers: Optional[List[str]] = None,
    state=None,
) -> GenerationResult:
    """Run the full grid: one ``execute`` per cell, then labeled grids.

    Returns a result whose images are [grid_z0, grid_z1, ...] followed by
    every cell's images in (z, y, x) order — webui's gallery layout.

    ``state``: interrupt state checked BETWEEN cells (default: the
    process-wide latch). Each cell's execute() resets the latch at its own
    request scope, so the grid loop itself must notice an interrupt and
    stop launching cells; completed cells still come back as a partial
    grid (webui returns what it has)."""
    opts = _extract_options(payload)
    if payload.script_args and not opts:
        raise ValueError(
            "x/y/z plot: script_args contained no usable axis options "
            "(pass a dict {'x_axis': ..., 'x_values': ...} or a positional "
            "[x_axis, x_values, y_axis, ...] string list)")

    axes: List[str] = []
    values: List[List[Any]] = []
    searches: List[Optional[str]] = []
    for prefix in ("x", "y", "z"):
        axis = str(opts.get(f"{prefix}_axis", "nothing")).strip().lower()
        if axis not in AXES:
            raise ValueError(f"x/y/z plot: unknown axis '{axis}' "
                             f"(choose from {sorted(AXES)})")
        vals = parse_axis_values(AXES[axis][0],
                                 str(opts.get(f"{prefix}_values", "")))
        if AXES[axis][0] == "sr" and len(vals) > 1:
            searches.append(vals[0])
        else:
            searches.append(None)
        if known_samplers and axis == "sampler":
            bad = [v for v in vals if v not in known_samplers]
            if bad:
                raise ValueError(f"x/y/z plot: unknown sampler(s) {bad}")
        axes.append(axis)
        values.append(vals)

    n_cells = math.prod(len(v) for v in values)
    if n_cells > MAX_CELLS:
        raise ValueError(
            f"x/y/z plot: {n_cells} cells exceeds the cap of {MAX_CELLS}")

    base = payload.model_copy()
    base.script_name = ""
    base.script_args = []
    base.seed = fix_seed(base.seed)  # every cell agrees on the base seed

    if state is None:
        from stable_diffusion_webui_distributed_tpu_torch.runtime.interrupt \
            import STATE

        state = STATE

    out = GenerationResult(parameters=payload.model_dump())
    grids: List[Tuple[List[List[str]], List[str], List[str], str]] = []
    xs, ys, zs = values
    stopped = False
    for zi, zv in enumerate(zs):
        rows: List[List[str]] = []
        cell_results: List[GenerationResult] = []
        for yv in ys:
            row: List[str] = []
            for xv in xs:
                cell = base.model_copy()
                for axis, search, val in zip(axes, searches, (xv, yv, zv)):
                    _apply(cell, axis, val, search)
                res = execute(cell)
                cell_results.append(res)
                row.append(res.images[0] if res.images else "")
                # each cell clears the latch at ITS request scope; the
                # grid must notice the user's interrupt here or a
                # 100-cell plot is unstoppable
                if state.flag.interrupted:
                    stopped = True
                    break
            # an interrupt mid-row leaves it short — pad to full width so
            # _draw_grid's row concat stays rectangular (blank cells render
            # via the ""->blank path); webui likewise returns what it has
            row.extend([""] * (len(xs) - len(row)))
            rows.append(row)
            if stopped:
                break
        x_labels = [_axis_label(axes[0], v) for v in xs]
        y_labels = [_axis_label(axes[1], v) for v in ys]
        z_label = _axis_label(axes[2], zv)
        grids.append((rows, x_labels, y_labels, z_label))

        # collect this z-slice's cells into the flat tail of the gallery
        for res in cell_results:
            out.images.extend(res.images)
            out.seeds.extend(res.seeds)
            out.subseeds.extend(res.subseeds)
            out.prompts.extend(res.prompts)
            out.negative_prompts.extend(res.negative_prompts)
            out.infotexts.extend(res.infotexts)
            out.worker_labels.extend(res.worker_labels)
        if stopped:
            # stop the z loop too: every cell's execute() clears the latch
            # at its own request scope, so letting another slice start
            # would run a full row before noticing the interrupt again
            break

    # grids go FIRST in the gallery (webui order); one per z value
    first_info = out.infotexts[0] if out.infotexts else ""
    for rows, x_labels, y_labels, z_label in reversed(grids):
        g = _draw_grid(rows, x_labels, y_labels, z_label)
        if g is None:
            continue
        out.images.insert(0, g)
        out.seeds.insert(0, base.seed)
        out.subseeds.insert(0, base.subseed or 0)
        out.prompts.insert(0, payload.prompt)
        out.negative_prompts.insert(0, payload.negative_prompt)
        out.infotexts.insert(0, first_info)
        out.worker_labels.insert(0, "")
    return out


def _draw_grid(rows: List[List[str]], x_labels: List[str],
               y_labels: List[str], z_label: str) -> Optional[str]:
    """Assemble one z-slice's cells into a labeled grid PNG (b64)."""
    import numpy as np

    arrays = [[b64png_to_array(c) if c else None for c in row]
              for row in rows]
    first = next((a for row in arrays for a in row if a is not None), None)
    if first is None:
        return None
    h, w, ch = first.shape
    blank = np.zeros((h, w, ch), first.dtype)
    grid = np.concatenate(
        [np.concatenate([a if a is not None else blank for a in row], axis=1)
         for row in arrays], axis=0)

    want_labels = any(x_labels) or any(y_labels) or bool(z_label)
    if not want_labels:
        return array_to_b64png(grid)
    try:
        from PIL import Image, ImageDraw, ImageFont
    except Exception:  # no PIL: unlabeled grid beats no grid
        return array_to_b64png(grid)

    top = 28 if (any(x_labels) or z_label) else 0
    left = 110 if any(y_labels) else 0
    canvas = Image.new("RGB", (left + grid.shape[1], top + grid.shape[0]),
                       "white")
    canvas.paste(Image.fromarray(grid), (left, top))
    draw = ImageDraw.Draw(canvas)
    font = ImageFont.load_default()
    for i, lab in enumerate(x_labels):
        if lab:
            draw.text((left + i * w + w // 2, top // 2), lab,
                      fill="black", font=font, anchor="mm")
    for j, lab in enumerate(y_labels):
        if lab:
            draw.text((4, top + j * h + h // 2), lab,
                      fill="black", font=font, anchor="lm")
    if z_label:
        draw.text((max(left, 4), 4), z_label, fill="black", font=font)
    return array_to_b64png(np.asarray(canvas))
