"""LoRA adapters: kohya-format safetensors merged into, or traced through,
the port's weights.

Port of the JAX package's ``models/lora.py``. The webui ecosystem's key
format (kohya sd-scripts): ``lora_unet_<ldm module path with
underscores>.{lora_up,lora_down}.weight`` plus ``.alpha``; the text encoder
under ``lora_te_`` (``lora_te1_`` / ``lora_te2_`` for SDXL's two encoders).
Each module resolves to one ``nn.Linear`` weight of the port, ``(out, in)``:
a fused projection (``attn1.qkv``, ``attn2.kv``, CLIP's ``attn.qkv``) takes
a q, k or v module in its row block ``weight[i*rows:(i+1)*rows, :]``, where
the JAX package adds to the column block of its ``(in, out)`` kernel.

Two paths, as in the JAX package:

- **merged** (the default): ``W += weight * (alpha/rank) * up @ down`` from
  the pristine weights, the product in f32 (:func:`merge_lora`,
  :func:`merge_leaf`);
- **traced** (``SDTPU_LORA_TRACED=1``): the factors ride into the UNet and
  the text encoders as per-site tensors zero-padded to a rank ladder and a
  slot ladder (:class:`TracedSet`), and each Dense site adds
  ``sum_s (x @ down_s^T) @ up_s^T`` (:func:`apply_site`), the weights left
  pristine. One set serves every row, or each row carries its own
  (:func:`stack_row_sets`), so requests with different adapters share a
  batch.

Modules the port cannot resolve, 3x3 conv (LoCon) factors and factors whose
shape does not fit the weight are skipped and counted, as in the JAX
package.
"""

from __future__ import annotations

import hashlib
import logging
import re
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from stable_diffusion_webui_distributed_tpu_torch.models.configs import (
    ModelFamily,
    UNetConfig,
)
from stable_diffusion_webui_distributed_tpu_torch.models.safetensors_io import (
    load_safetensors,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.config import (
    env_flag,
    env_parsed,
)

log = logging.getLogger(__name__)

Array = np.ndarray
#: the weights an adapter can touch: component -> {state-dict key: tensor}
Leaves = Dict[str, Dict[str, torch.Tensor]]


def load_lora(path: str) -> Dict[str, Array]:
    return load_safetensors(path)


def group_lora(sd: Dict[str, Array]) -> Dict[str, Dict[str, Array]]:
    """{module_key: {"up": .., "down": .., "alpha": ..}}."""
    groups: Dict[str, Dict[str, Array]] = {}
    for key, value in sd.items():
        if "." not in key:
            continue
        module, _, leaf = key.partition(".")
        g = groups.setdefault(module, {})
        if leaf.startswith("lora_up"):
            g["up"] = value
        elif leaf.startswith("lora_down"):
            g["down"] = value
        elif leaf == "alpha":
            g["alpha"] = value
    return groups


# --------------------------------------------------------------------------
# kohya module key -> (component, module path, fused slot)
# --------------------------------------------------------------------------

def _unet_block_index_maps(cfg: UNetConfig):
    """Replay ldm's input/output block numbering to map block numbers to
    the port's module names."""
    levels = list(zip(cfg.block_out_channels, cfg.down_blocks))
    in_map: Dict[int, str] = {}
    n = 1
    for level, (_, depth) in enumerate(levels):
        for i in range(cfg.layers_per_block):
            if depth is not None:
                in_map[n] = f"down_{level}_attn_{i}"
            n += 1
        if level < len(levels) - 1:
            n += 1  # downsample block: no attention
    out_map: Dict[int, str] = {}
    n = 0
    for level in reversed(range(len(levels))):
        _, depth = levels[level]
        for i in range(cfg.layers_per_block + 1):
            if depth is not None:
                out_map[n] = f"up_{level}_attn_{i}"
            n += 1
    return in_map, out_map


#: leaf name inside a transformer block -> (module path suffix, fused slot
#: (index, of) into the fused weight's row blocks)
_ATTN_LEAVES = {
    "attn1_to_q": ("attn1/qkv", (0, 3)),
    "attn1_to_k": ("attn1/qkv", (1, 3)),
    "attn1_to_v": ("attn1/qkv", (2, 3)),
    "attn1_to_out_0": ("attn1/out_proj", None),
    "attn2_to_q": ("attn2/q", None),
    "attn2_to_k": ("attn2/kv", (0, 2)),
    "attn2_to_v": ("attn2/kv", (1, 2)),
    "attn2_to_out_0": ("attn2/out_proj", None),
    "ff_net_0_proj": ("geglu/proj", None),
    "ff_net_2": ("ff_out", None),
}

_TE_TABLE = {
    "self_attn_q_proj": (["attn", "qkv"], (0, 3)),
    "self_attn_k_proj": (["attn", "qkv"], (1, 3)),
    "self_attn_v_proj": (["attn", "qkv"], (2, 3)),
    "self_attn_out_proj": (["attn", "out_proj"], None),
    "mlp_fc1": (["fc1"], None),
    "mlp_fc2": (["fc2"], None),
}


def _resolve_unet_key(module: str, cfg: UNetConfig
                      ) -> Optional[Tuple[List[str], Optional[Tuple[int, int]]]]:
    """kohya unet module key -> (module path in the UNet, fused slot)."""
    in_map, out_map = _unet_block_index_maps(cfg)

    m = re.match(r"lora_unet_input_blocks_(\d+)_1_(.+)", module)
    base = None
    if m:
        base = in_map.get(int(m.group(1)))
        rest = m.group(2)
    else:
        m = re.match(r"lora_unet_output_blocks_(\d+)_1_(.+)", module)
        if m:
            base = out_map.get(int(m.group(1)))
            rest = m.group(2)
        else:
            m = re.match(r"lora_unet_middle_block_1_(.+)", module)
            if m:
                base = "mid_attn"
                rest = m.group(1)
    if base is None:
        return None

    if rest in ("proj_in", "proj_out"):
        return [base, rest], None
    m = re.match(r"transformer_blocks_(\d+)_(.+)", rest)
    if not m:
        return None
    leaf = _ATTN_LEAVES.get(m.group(2))
    if leaf is None:
        return None
    suffix, slot = leaf
    return [base, f"block_{m.group(1)}", *suffix.split("/")], slot


def _resolve_te_key(module: str, prefix: str
                    ) -> Optional[Tuple[List[str], Optional[Tuple[int, int]]]]:
    """kohya text-encoder module key -> module path in the CLIP model."""
    m = re.match(rf"{prefix}_text_model_encoder_layers_(\d+)_(.+)", module)
    if not m:
        return None
    hit = _TE_TABLE.get(m.group(2))
    if hit is None:
        return None
    path, slot = hit
    return [f"layer_{m.group(1)}", *path], slot


def _resolve_module(module: str, family: ModelFamily):
    """kohya module key -> (component, path tuple, fused slot) or None."""
    if module.startswith("lora_unet_"):
        r = _resolve_unet_key(module, family.unet)
        return ("unet", tuple(r[0]), r[1]) if r else None
    for prefix, comp in (("lora_te1_", "text_encoder"),
                         ("lora_te2_", "text_encoder_2"),
                         ("lora_te_", "text_encoder")):
        if module.startswith(prefix):
            r = _resolve_te_key(module, prefix.rstrip("_"))
            return (comp, tuple(r[0]), r[1]) if r else None
    return None


def _factor_pair(g: Dict[str, Array]):
    """(up [O_sub, r], down [r, I], alpha) in f32, or None for a form the
    port does not apply (a factor missing, a 3x3 conv LoCon)."""
    up, down = g.get("up"), g.get("down")
    if up is None or down is None:
        return None
    if up.ndim == 4:  # 1x1 conv LoRA
        up = up[:, :, 0, 0]
    if down.ndim == 4:
        if down.shape[2:] != (1, 1):
            return None  # 3x3 conv (LoCon) unsupported
        down = down[:, :, 0, 0]
    rank = int(down.shape[0])
    alpha = float(g["alpha"]) if "alpha" in g else float(rank)
    return np.asarray(up, np.float32), np.asarray(down, np.float32), alpha


def _is_te(component: str) -> bool:
    return component.startswith("text_encoder")


# --------------------------------------------------------------------------
# the merged path
# --------------------------------------------------------------------------

class Patch(NamedTuple):
    """One module of an adapter, resolved onto one weight: ``weight[rows]
    += w * scale * up @ down`` (``rows`` None: the whole weight)."""
    component: str
    key: str                 # state-dict key of the nn.Linear weight
    rows: Optional[slice]    # a fused slot's row block
    up: Array                # (O_sub, r) f32
    down: Array              # (r, I) f32
    scale: float             # alpha / rank

    def delta(self, device) -> torch.Tensor:
        """``up @ down * alpha/rank`` in f32 on ``device``."""
        up = torch.from_numpy(self.up).to(device)
        down = torch.from_numpy(self.down).to(device)
        return (up @ down) * self.scale


def resolve_lora(lora_sd: Dict[str, Array], family: ModelFamily,
                 shape_of: Callable[[str, str], Optional[Tuple[int, int]]]
                 ) -> Tuple[List[Patch], int, int]:
    """An adapter's modules as :class:`Patch` es, with the JAX package's
    ``(applied, skipped)`` counts. ``shape_of(component, key)`` gives the
    ``(out, in)`` shape of a 2-D weight, or None where the engine has no
    such weight (a component it lacks, a path it does not have)."""
    patches: List[Patch] = []
    applied = skipped = 0
    for module, g in group_lora(lora_sd).items():
        pair = _factor_pair(g)
        resolved = None if pair is None else _resolve_module(module, family)
        if resolved is None:
            skipped += 1
            continue
        up, down, alpha = pair
        comp, path, slot = resolved
        key = ".".join(path) + ".weight"
        shape = shape_of(comp, key)
        rows = None
        want = shape
        if shape is not None and slot is not None:
            idx, of = slot
            n = shape[0] // of
            rows = slice(idx * n, (idx + 1) * n)
            want = (n, shape[1])
        if shape is None or (up.shape[0], down.shape[1]) != want:
            skipped += 1
            continue
        patches.append(Patch(comp, key, rows, up, down,
                             alpha / down.shape[0]))
        applied += 1
    return patches, applied, skipped


def merge_leaf(leaf: torch.Tensor,
               patches: Sequence[Tuple[Patch, float]]) -> torch.Tensor:
    """``leaf`` with each ``(patch, w)`` added in order, ``w * delta`` in
    f32 on the leaf's device, rounded once to the leaf's dtype: on the card
    policy's bf16 weights, one rounding however many adapters stack."""
    acc = leaf.to(torch.float32, copy=True)
    for p, w in patches:
        target = acc if p.rows is None else acc[p.rows]
        target += p.delta(acc.device) * w
    return acc.to(leaf.dtype)


def shape_getter(leaves: Leaves):
    """``shape_of`` for :func:`resolve_lora` over state dicts or named
    parameters."""
    def shape_of(comp: str, key: str):
        t = (leaves.get(comp) or {}).get(key)
        return tuple(t.shape) if t is not None and t.dim() == 2 else None

    return shape_of


def merge_lora(params: Leaves, lora_sd: Dict[str, Array], weight: float,
               family: ModelFamily, te_weight: Optional[float] = None
               ) -> Tuple[Leaves, int, int]:
    """New state dicts with the adapter merged at ``weight`` (text-encoder
    modules at ``te_weight``, default ``weight``: webui's
    ``<lora:name:unet_w:te_w>``). Only the touched weights are new tensors;
    the rest are shared. Returns ``(params, applied, skipped)``."""
    if te_weight is None:
        te_weight = weight
    out = {k: (dict(v) if isinstance(v, dict) else v)
           for k, v in params.items()}
    patches, applied, skipped = resolve_lora(lora_sd, family,
                                             shape_getter(out))
    by_leaf: Dict[Tuple[str, str], List[Tuple[Patch, float]]] = {}
    for p in patches:
        w = te_weight if _is_te(p.component) else weight
        by_leaf.setdefault((p.component, p.key), []).append((p, w))
    for (comp, key), ps in by_leaf.items():
        out[comp][key] = merge_leaf(out[comp][key], ps)
    if skipped:
        log.debug("lora: %d module(s) applied, %d skipped", applied, skipped)
    return out, applied, skipped


# --------------------------------------------------------------------------
# the traced path (SDTPU_LORA_TRACED)
# --------------------------------------------------------------------------
#
# Every Dense site an adapter can target carries ``down`` [S, rb, I] and
# ``up`` [S, O, rb] (the scale folded into ``up``), zero-padded to a rank
# bucket rb and a slot count S from static ladders; zero padding adds
# exactly 0. A fused site (attn qkv / kv) stacks each adapter's q, k and v
# along its rank axis with the up rows placed block-wise, so one site
# carries q+k+v at an effective rank <= 3r. Delta at each site:
#
#     y = x @ W^T + sum_s (x @ down_s^T) @ up_s^T

DEFAULT_RANK_LADDER: Tuple[int, ...] = (8, 16, 32, 64)
DEFAULT_SLOT_LADDER: Tuple[int, ...] = (1, 2, 4)

_SITE_RE = re.compile(r"^(down_\d+_attn_\d+|mid_attn|up_\d+_attn_\d+)$")
_BLOCK_RE = re.compile(r"^block_\d+$")
_LAYER_RE = re.compile(r"^layer_\d+$")

#: Dense leaves inside one transformer block that can carry a delta
_BLOCK_LEAVES = (("attn1", "qkv"), ("attn1", "out_proj"), ("attn2", "q"),
                 ("attn2", "kv"), ("attn2", "out_proj"), ("geglu", "proj"),
                 ("ff_out",))
_TE_LEAVES = (("attn", "qkv"), ("attn", "out_proj"), ("fc1",), ("fc2",))


def traced_enabled() -> bool:
    """Live read of ``SDTPU_LORA_TRACED`` (default off: the merged path)."""
    return env_flag("SDTPU_LORA_TRACED", False)


def _ladder_strict(raw: str) -> Tuple[int, ...]:
    vals = tuple(sorted({int(p.strip()) for p in raw.split(",")
                         if p.strip()}))
    if not vals or any(v <= 0 for v in vals):
        raise ValueError("ladder needs positive ints")
    return vals


def rank_ladder() -> Tuple[int, ...]:
    return env_parsed("SDTPU_LORA_RANKS", _ladder_strict,
                      DEFAULT_RANK_LADDER, "comma list of ranks")


def slot_ladder() -> Tuple[int, ...]:
    return env_parsed("SDTPU_LORA_SLOTS", _ladder_strict,
                      DEFAULT_SLOT_LADDER, "comma list of slot counts")


def _bucket(value: int, ladder: Tuple[int, ...]) -> Optional[int]:
    for rung in ladder:
        if value <= rung:
            return rung
    return None


def bucket_rank(rank: int) -> Optional[int]:
    """An effective site rank on the ladder (None past the top rung: the
    set then takes the merged path)."""
    return _bucket(int(rank), rank_ladder())


def bucket_slots(n: int) -> Optional[int]:
    """An adapter count on the slot ladder."""
    return _bucket(int(n), slot_ladder())


def site_inventory(params: Leaves) -> Dict[str, Dict[Tuple[str, ...],
                                                     Tuple[int, int]]]:
    """Every Dense site an adapter can target, per component: ``{component:
    {path: (in_dim, out_dim)}}`` from the engine's weights (state dicts or
    named parameters). The full inventory keeps a traced tree's structure
    the same for every adapter set."""
    out: Dict[str, Dict[Tuple[str, ...], Tuple[int, int]]] = {}
    for comp in ("unet", "text_encoder", "text_encoder_2"):
        sites: Dict[Tuple[str, ...], Tuple[int, int]] = {}
        for key, t in (params.get(comp) or {}).items():
            if not key.endswith(".weight") or t.dim() != 2:
                continue
            path = tuple(key[:-len(".weight")].split("."))
            if comp == "unet":
                ok = _SITE_RE.match(path[0]) and (
                    path[1:] in (("proj_in",), ("proj_out",))
                    or (len(path) > 2 and _BLOCK_RE.match(path[1])
                        and path[2:] in _BLOCK_LEAVES))
            else:
                ok = _LAYER_RE.match(path[0]) and path[1:] in _TE_LEAVES
            if ok:
                sites[path] = (int(t.shape[1]), int(t.shape[0]))
        out[comp] = sites
    return out


class TracedSet:
    """One resolved adapter set in traced form: zero-padded factor trees
    and the content address that keys the conditioning cache. ``tree``
    holds, per component, nested dicts along the module paths with
    ``{"down": [S, rb, I], "up": [S, O, rb]}`` tensors (scale folded into
    ``up``)."""

    __slots__ = ("sig", "rank_bucket", "slots", "tree", "content",
                 "te_content", "specs", "applied", "skipped", "srcs")

    def __init__(self, sig: str, rank_bucket: int, slots: int, tree: Dict,
                 content: str, te_content: str, specs: Tuple,
                 applied: int, skipped: int, srcs: Tuple) -> None:
        self.sig = sig
        self.rank_bucket = rank_bucket
        self.slots = slots
        self.tree = tree
        self.content = content
        self.te_content = te_content
        self.specs = specs
        self.applied = applied
        self.skipped = skipped
        self.srcs = srcs  # adapter state dicts (the staleness check)


def _zero_tree(inventory: Dict, rb: int, sc: int, device,
               dtype: torch.dtype) -> Dict:
    """Full-inventory zero factor tree at (rank_bucket, slot_count)."""
    tree: Dict = {}
    for comp, sites in inventory.items():
        ctree: Dict = {}
        for path, (i_dim, o_dim) in sites.items():
            node = ctree
            for part in path[:-1]:
                node = node.setdefault(part, {})
            node[path[-1]] = {
                "down": torch.zeros((sc, rb, i_dim), dtype=dtype,
                                    device=device),
                "up": torch.zeros((sc, o_dim, rb), dtype=dtype,
                                  device=device),
            }
        tree[comp] = ctree
    return tree


def _site_leaf(tree: Dict, comp: str, path: Tuple[str, ...]):
    node = tree.get(comp)
    for part in path:
        if not isinstance(node, dict):
            return None
        node = node.get(part)
    return node


def build_traced_set(specs, provider, family: ModelFamily, params: Leaves,
                     device="cpu", dtype: torch.dtype = torch.float32
                     ) -> Optional[TracedSet]:
    """Resolve ``specs`` (``[(name, unet_w, te_w), ...]``, the
    :func:`extract_lora_tags` form) into a :class:`TracedSet` whose factor
    trees are ``dtype`` tensors on ``device`` (the engine's compute dtype,
    in which :func:`apply_site` computes; the factors are made in f32 and
    rounded once), or None when the set cannot be bucketed (an unknown
    adapter, the rank or slot ladder exceeded): the caller then takes the
    merged path."""
    inventory = site_inventory(params)
    sc = bucket_slots(max(1, len(specs)))
    if sc is None:
        return None

    # pass 1: resolve every contribution and find the effective rank per
    # (slot, site): each adapter owns its slot's rank axis, and the fused
    # sub-modules (q+k+v) stack within it
    contribs = []   # (slot, comp, path, fused, up, down, scale)
    site_rank: Dict[Tuple, int] = {}
    hasher = hashlib.sha256()
    te_hasher = hashlib.sha256()
    te_touched = False
    srcs = []
    applied = skipped = 0
    for slot, (name, w, te_w) in enumerate(specs):
        sd = provider(name) if provider else None
        if sd is None:
            return None  # unresolvable: the merged path logs the skip
        srcs.append(sd)
        hasher.update(f"{name}|{w}|{te_w}".encode())
        groups = group_lora(sd)
        for module in sorted(groups):
            pair = _factor_pair(groups[module])
            resolved = _resolve_module(module, family)
            if pair is None or resolved is None:
                skipped += 1
                continue
            up, down, alpha = pair
            comp, path, fused = resolved
            if path not in inventory.get(comp, {}):
                skipped += 1
                continue
            scale = (te_w if _is_te(comp) else w) * alpha / down.shape[0]
            key = (slot, comp, path)
            site_rank[key] = site_rank.get(key, 0) + int(down.shape[0])
            contribs.append((slot, comp, path, fused, up, down, scale))
            parts = (module.encode(), up.tobytes(), down.tobytes(),
                     np.float32(scale).tobytes())
            for part in parts:
                hasher.update(part)
            if _is_te(comp):
                te_touched = True
                for part in parts:
                    te_hasher.update(part)
            applied += 1
    if not contribs:
        return None
    rb = bucket_rank(max(site_rank.values()))
    if rb is None:
        return None

    # pass 2: the full-inventory zero tree with the factors placed
    tree = _zero_tree(inventory, rb, sc, device, dtype)
    cursor: Dict[Tuple, int] = {}
    for slot, comp, path, fused, up, down, scale in contribs:
        leaf = _site_leaf(tree, comp, path)
        i_dim, o_dim = leaf["down"].shape[2], leaf["up"].shape[1]
        r = int(down.shape[0])
        if down.shape[1] != i_dim:
            continue  # another family's adapter: the site stays zero
        ck = (slot, comp, path)
        at = cursor.get(ck, 0)
        if at + r > rb:
            continue
        cursor[ck] = at + r
        leaf["down"][slot, at:at + r, :] = torch.from_numpy(down)
        if fused is None:
            if up.shape[0] != o_dim:
                continue
            rows = slice(0, o_dim)
        else:
            idx, of = fused
            cols = o_dim // of
            if up.shape[0] != cols:
                continue
            rows = slice(idx * cols, (idx + 1) * cols)
        leaf["up"][slot, rows, at:at + r] = torch.from_numpy(up * scale)

    return TracedSet(f"lora:r{rb}s{sc}", rb, sc, tree, hasher.hexdigest(),
                     te_hasher.hexdigest() if te_touched else "",
                     tuple(specs), applied, skipped, tuple(srcs))


def zero_set(params: Leaves, family: ModelFamily, rb: int, sc: int,
             device="cpu", dtype: torch.dtype = torch.float32) -> TracedSet:
    """An all-zero traced set at an explicit (rank_bucket, slot_count): an
    exact no-op contribution in that cell."""
    rb = bucket_rank(rb) or rank_ladder()[-1]
    sc = bucket_slots(sc) or slot_ladder()[-1]
    tree = _zero_tree(site_inventory(params), rb, sc, device, dtype)
    return TracedSet(f"lora:r{rb}s{sc}", rb, sc, tree, "zero", "",
                     (), 0, 0, ())


def delta_out(x: torch.Tensor, site: Dict[str, torch.Tensor]
              ) -> torch.Tensor:
    """The traced delta at one Dense site, ``sum_s (x @ down_s^T) @
    up_s^T``, in ``x``'s dtype. ``site`` leaves are ``[S, rb, I]`` / ``[S,
    O, rb]`` (one set for every row) or ``[B, S, rb, I]`` / ``[B, S, O,
    rb]`` (a set per row). A per-row site broadcast from one set (row
    stride 0, :func:`broadcast_set`) takes the one-set form: one product
    over all rows instead of a batched one."""
    down, up = site_factors(site)
    return delta_up(delta_down(x, down.to(x.dtype)), up.to(x.dtype))


def site_factors(site: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A site's ``(down, up)``, a per-row site broadcast from one set
    (row stride 0) in the one-set form. Their input features are the last
    axis of ``down``, their output features the last but one of ``up``,
    in every form: a split layer slices them there (views, no copy)."""
    down, up = site["down"], site["up"]
    if down.dim() == 4 and down.stride(0) == 0 and up.stride(0) == 0:
        return down[0], up[0]
    return down, up


def delta_down(x: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
    """``h = x @ down_s^T`` per set, ``(B, S, T, rb)``."""
    if down.dim() == 4:
        return torch.einsum("bti,bsri->bstr", x, down)
    return torch.einsum("bti,sri->bstr", x, down)


def delta_up(h: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """``sum_s h_s @ up_s^T``, ``(B, T, O)``."""
    if up.dim() == 4:
        return torch.einsum("bstr,bsor->bto", h, up)
    return torch.einsum("bstr,sor->bto", h, up)


def apply_site(y: torch.Tensor, x: torch.Tensor, lora: Optional[Dict],
               key: str) -> torch.Tensor:
    """``y + delta_out(x, lora[key])``, computed in ``y``'s dtype, the
    projection's compute dtype (bf16 on the card, where the projection
    itself rounds ``x`` so; the JAX package computes in ``x``'s dtype, f32
    after a LayerNorm, which a TPU multiplies in bf16 passes by default);
    ``y`` itself when ``lora`` is None or has no such site."""
    site = None if lora is None else lora.get(key)
    if site is None:
        return y
    return y + delta_out(x if x.dtype == y.dtype else x.to(y.dtype), site)


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of the same structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def stack_row_sets(sets: List[TracedSet], batch: int) -> Dict:
    """Per-row adapter sets stacked into one ``[B, S, ...]`` tree for a
    coalesced group. Every set must share one (rank_bucket, slots) cell
    (the dispatcher's group key sees to it); a short list pads by
    repeating its last set (the batch ladder's pad-and-drop rows)."""
    if not sets:
        raise ValueError("stack_row_sets needs at least one set")
    cell = {(s.rank_bucket, s.slots) for s in sets}
    if len(cell) != 1:
        raise ValueError(f"heterogeneous cells in one group: {cell}")
    if all(s is sets[0] for s in sets):
        return broadcast_set(sets[0], batch)  # the same rows, no copies
    rows = list(sets) + [sets[-1]] * (batch - len(sets))
    return tree_map(lambda *leaves: torch.stack(leaves),
                    *[r.tree for r in rows])


def broadcast_set(ts: TracedSet, batch: int) -> Dict:
    """One set for every row: ``[B, S, ...]`` views with a row stride of
    0 (no copy)."""
    return tree_map(lambda a: a.expand((batch,) + tuple(a.shape)), ts.tree)


def double_rows(tree: Dict) -> Dict:
    """A per-row tree for ``[uncond; cond]`` rows: each row's set twice,
    the rows of a broadcast set still a view."""
    def double(a: torch.Tensor) -> torch.Tensor:
        if a.stride(0) == 0:
            return a[:1].expand((2 * a.shape[0],) + tuple(a.shape[1:]))
        return torch.cat([a, a])

    return tree_map(double, tree)


# --------------------------------------------------------------------------
# prompt syntax
# --------------------------------------------------------------------------

_LORA_TAG = re.compile(
    r"<lora:([^:>]+)(?::([0-9.+-]+))?(?::([0-9.+-]+))?>")


def extract_lora_tags(prompt: str
                      ) -> Tuple[str, List[Tuple[str, float, float]]]:
    """Strip webui ``<lora:name[:weight[:te_weight]]>`` extra-network tags.

    Returns (clean_prompt, [(name, unet_weight, te_weight), ...]). A single
    weight applies to both; omitted weights default to 1.0.
    """
    tags: List[Tuple[str, float, float]] = []

    def keep(m: re.Match) -> str:
        def num(g, default):
            try:
                return float(g) if g else default
            except ValueError:
                return default

        w = num(m.group(2), 1.0)
        te_w = num(m.group(3), w)
        tags.append((m.group(1), w, te_w))
        return ""

    clean = _LORA_TAG.sub(keep, prompt)
    return re.sub(r"\s{2,}", " ", clean).strip(), tags
