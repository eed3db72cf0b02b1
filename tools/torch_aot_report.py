#!/usr/bin/env python
"""Render and verify the port's kernel-library artifact store
(``stable_diffusion_webui_distributed_tpu_torch/serving/aot.py``).

Reads the manifest under ``SDTPU_AOT_DIR`` (or ``--dir``) and reports every
cell: the library's kind, its source hash (``key``), its toolchain
(``sig``), its size, the runtime fingerprint it was built under and
whether that fingerprint matches this process's, with the byte totals per
kind and this process's hit / miss / saved / fallback tallies.

    python tools/torch_aot_report.py                  # JSON to stdout
    python tools/torch_aot_report.py --dir /tmp/aot   # another root
    python tools/torch_aot_report.py -o aot.json      # ... or to a file

The verify pass is the gate: every cell's library must exist with the
manifest's sha256, and every ``*.so`` in the root must be claimed by a
cell. Exit code 0 when the store is coherent, 1 on any divergence (a
missing library, a sha256 mismatch, an orphan), 2 when the root does not
exist.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from stable_diffusion_webui_distributed_tpu_torch.serving import (  # noqa: E402
    aot as aot_mod,
)


def build_report(root=None):
    store = aot_mod.AotStore(root) if root else aot_mod.get_store()
    verify = store.verify()
    cells = verify["cells"]
    by_kind = {}
    total_bytes = 0
    for c in cells:
        k = str(c.get("kind"))
        row = by_kind.setdefault(k, {"cells": 0, "bytes": 0})
        row["cells"] += 1
        row["bytes"] += int(c.get("bytes") or 0)
        total_bytes += int(c.get("bytes") or 0)
        c["fingerprint_match"] = (c.get("fingerprint_id")
                                  == verify["fingerprint_id"])
    report = {
        "root": verify["root"],
        "enabled": aot_mod.enabled(),
        "runtime_fingerprint": verify["fingerprint"],
        "runtime_fingerprint_id": verify["fingerprint_id"],
        "cells": cells,
        "cell_count": len(cells),
        "total_bytes": total_bytes,
        "by_kind": dict(sorted(by_kind.items())),
        "divergent": verify["divergent"],
        "orphans": verify["orphans"],
        "stats": store.stats_snapshot(),
        "ok": verify["ok"],
    }
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default=None,
                    help="store root (default: SDTPU_AOT_DIR)")
    ap.add_argument("-o", "--output", default=None,
                    help="write JSON here instead of stdout")
    args = ap.parse_args(argv)

    root = args.dir or aot_mod.default_dir()
    if not os.path.isdir(root):
        print(f"torch_aot_report: store root {root} does not exist",
              file=sys.stderr)
        return 2
    report = build_report(root)
    text = json.dumps(report, indent=2, sort_keys=True) + "\n"
    if args.output:
        with open(args.output, "w", encoding="utf-8") as fh:
            fh.write(text)
        print(f"wrote {args.output} ({report['cell_count']} cell(s), "
              f"ok={report['ok']})", file=sys.stderr)
    else:
        sys.stdout.write(text)
    if not report["ok"]:
        print("torch_aot_report: DIVERGENT — "
              + ", ".join(report["divergent"]
                          + [f"orphan:{o}" for o in report["orphans"]]),
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
