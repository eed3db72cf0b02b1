"""CLI: ``python -m stable_diffusion_webui_distributed_tpu_torch.analysis``.

Exit code 0 = no unallowlisted findings, 1 = findings, 2 = usage error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from . import RULES, run_analysis


def repo_root() -> str:
    # package dir is <root>/stable_diffusion_webui_distributed_tpu_torch/analysis
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m stable_diffusion_webui_distributed_tpu_torch.analysis",
        description="sdtpu-lint over the port: capture-purity, "
                    "recapture-hazard, and lock-discipline analysis (pure "
                    "AST, no device needed)")
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to analyze (default: the package)")
    ap.add_argument("--json", action="store_true",
                    help="emit findings as JSON instead of text")
    ap.add_argument("--allowlist", default=None,
                    help="allowlist path (default: analysis/allowlist.json)")
    ap.add_argument("--no-allowlist", action="store_true",
                    help="report raw findings, ignoring the allowlist")
    ap.add_argument("--rules", action="store_true",
                    help="list rule IDs and exit")
    ap.add_argument("--changed", action="store_true",
                    help="report only findings in git-changed files and "
                         "their import dependents (full package is still "
                         "analyzed for cross-module soundness)")
    ap.add_argument("--no-cache", action="store_true",
                    help="ignore and don't write the per-module analysis "
                         "cache (.sdtpu-torch-lint-cache.json)")
    args = ap.parse_args(argv)

    if args.rules:
        for rule, desc in sorted(RULES.items()):
            print(f"{rule}  {desc}")
        return 0

    result = run_analysis(repo_root(), paths=args.paths or None,
                          allowlist_path=args.allowlist,
                          use_allowlist=not args.no_allowlist,
                          # cache entries are keyed per-module; explicit
                          # path scoping would poison the full-package set
                          use_cache=not args.no_cache and not args.paths,
                          changed_only=args.changed)
    if args.json:
        json.dump({"modules": result.modules,
                   "counts": result.counts,
                   "suppressed": len(result.suppressed),
                   "findings": [f.as_dict() for f in result.findings]},
                  sys.stdout, indent=2)
        print()
    else:
        for f in result.findings:
            print(f.render())
        cached = " (cached)" if result.cache_hit else ""
        print(f"sdtpu-lint: {len(result.findings)} finding(s), "
              f"{len(result.suppressed)} allowlisted, "
              f"{result.modules} module(s) analyzed in "
              f"{result.wall_time_s:.2f}s{cached}", file=sys.stderr)
    return 1 if result.findings else 0


if __name__ == "__main__":
    sys.exit(main())
