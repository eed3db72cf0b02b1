"""sdtpu-lint over the port: AST static analysis for capture purity,
recapture hazards, and lock discipline.

Run over the repo:   python -m stable_diffusion_webui_distributed_tpu_torch.analysis
Tier-1 gate:         tests/test_torch_lint.py (zero findings vs the committed
                     allowlist, parity with the JAX package's lint on its
                     fixtures, the retargeted rules on
                     tests/torch_lint_fixtures/).
Rule reference:      ANALYSIS.md at the repo root; the trace rules'
                     retargeting at CUDA-graph capture is in
                     ``capture.py``, ``purity.py``, ``escape.py``,
                     ``recompile.py`` and ``donation.py``.

Pure ``ast``/``tokenize`` — importable and runnable with no GPU, without
torch, and without importing any of the code under analysis.
"""

from __future__ import annotations

import datetime
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from . import allowlist as allowlist_mod
from . import cache as cache_mod
from . import callgraph as callgraph_mod
from . import summaries as summaries_mod
from . import (alertrules, atomicity, cacherules, donation, envrules,
               escape, fleetrules, journalrules, lockorder, locks,
               metricrules, netrules, purity, recompile, threadrules,
               timerules)
from .core import RULES, Finding, ModuleInfo, walk_package

__all__ = ["Finding", "RULES", "AnalysisResult", "run_analysis",
           "analyze_modules"]


@dataclass
class AnalysisResult:
    findings: List[Finding]  # unsuppressed (includes AL001/AL002)
    suppressed: List[Finding]
    modules: int = 0
    counts: Dict[str, int] = field(default_factory=dict)
    wall_time_s: float = 0.0
    cache_hit: bool = False  # every module key hit; no pass ran

    @property
    def clean(self) -> bool:
        return not self.findings


def analyze_modules(modules: List[ModuleInfo],
                    interprocedural: bool = True,
                    prog=None, summaries=None) -> List[Finding]:
    """Run every rule pass. ``interprocedural=False`` runs without the
    taint summaries, so RC001/RC002 stay silent — kept so the cross-module
    fixture test can assert what a per-function pass misses.
    ``prog``/``summaries`` accept prebuilt indexes (the cache path)."""
    prog = prog if prog is not None else callgraph_mod.build(modules)
    if interprocedural:
        summaries = summaries if summaries is not None \
            else summaries_mod.compute(prog)
    else:
        summaries = None
    findings: List[Finding] = []
    findings.extend(purity.check(modules, prog=prog))
    findings.extend(recompile.check(modules, summaries=summaries))
    findings.extend(envrules.check(modules))
    findings.extend(timerules.check(modules))
    findings.extend(metricrules.check(modules))
    findings.extend(journalrules.check(modules))
    findings.extend(alertrules.check(modules))
    findings.extend(netrules.check(modules))
    lock_res = locks.analyze(modules, prog=prog)
    findings.extend(lock_res.findings)
    findings.extend(lockorder.check(modules, prog=prog, base=lock_res))
    findings.extend(atomicity.check(modules, prog=prog))
    findings.extend(threadrules.check(modules, prog=prog))
    findings.extend(donation.check(modules, prog=prog))
    findings.extend(escape.check(modules, prog=prog))
    findings.extend(fleetrules.check(modules))
    findings.extend(cacherules.check(modules))
    # rule passes may re-walk nested statements; dedupe identical findings
    seen = set()
    out = []
    for f in findings:
        key = (f.rule, f.path, f.line, f.symbol, f.message)
        if key not in seen:
            seen.add(key)
            out.append(f)
    out.sort(key=lambda f: (f.path, f.line, f.rule))
    return out


def run_analysis(root: str,
                 paths: Optional[Sequence[str]] = None,
                 allowlist_path: Optional[str] = None,
                 use_allowlist: bool = True,
                 today: Optional[datetime.date] = None,
                 use_cache: bool = False,
                 changed_only: bool = False) -> AnalysisResult:
    t0 = time.perf_counter()
    modules = walk_package(root, paths)
    prog = callgraph_mod.build(modules)
    findings: Optional[List[Finding]] = None
    cache_hit = False
    if use_cache:
        store = cache_mod.Cache(root)
        dirty, keys = store.split(modules)
        if not dirty:
            findings = store.cached_findings()
            cache_hit = findings is not None
        if findings is None:
            dirty_closure = prog.dependents(dirty) if dirty else None
            seed = store.seed_summaries(
                {m.path for m in modules} - (dirty_closure or set()))
            summaries = summaries_mod.compute(
                prog, seed=seed, dirty_paths=dirty_closure)
            findings = analyze_modules(modules, prog=prog,
                                       summaries=summaries)
            store.store(keys, findings, summaries_mod.by_path(summaries))
    if findings is None:
        findings = analyze_modules(modules, prog=prog)
    if changed_only:
        changed = cache_mod.git_changed_paths(root)
        scope = prog.dependents(changed) if changed else set()
        findings = [f for f in findings if f.path in scope]
    suppressed: List[Finding] = []
    if use_allowlist:
        entries, list_path = allowlist_mod.load(allowlist_path)
        findings, suppressed = allowlist_mod.apply(findings, entries,
                                                   list_path, today=today)
    counts: Dict[str, int] = {}
    for f in findings:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    return AnalysisResult(findings=findings, suppressed=suppressed,
                          modules=len(modules), counts=counts,
                          wall_time_s=time.perf_counter() - t0,
                          cache_hit=cache_hit)
