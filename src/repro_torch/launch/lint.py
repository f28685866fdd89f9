"""The linter CLI: run the port's rigs for every (config × strategy ×
precision × accum) cell and lint what they record against the
performance contracts (``repro_torch.analysis``).

Port of ``repro/launch/lint.py``.  It runs on the card unless it is
given ``--device cpu``; without a card ``--device cuda`` raises (nothing
falls back to the CPU).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.lint --arch gemma3-1b [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.lint --all --device cpu [--out PATH]
    PYTHONPATH=src python -m repro_torch.launch.lint --validate

``--all`` writes the committed ``LINT_torch.json``; ``--smoke`` (or
``LINT_SMOKE=1``) sweeps ``SMOKE_CONFIGS`` only.  Exit codes: 0 clean,
1 rule violations, 2 unknown config name.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from repro_torch.analysis import report as R
from repro_torch.analysis import sweep as SW

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))
OUT = os.path.join(ROOT, "LINT_torch.json")


def _progress(cell):
    counts = {"pass": 0, "fail": 0, "skip": 0}
    for r in cell.rules:
        counts[r.status] += 1
    tag = (f"{cell.config}/{cell.strategy}/{cell.precision}"
           f"/accum{cell.accum}")
    print(f"  {tag}: pass={counts['pass']} skip={counts['skip']}"
          + (f" FAIL={counts['fail']}" if counts["fail"] else ""),
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.lint",
        description="performance-contract linter over the port's matrix")
    ap.add_argument("--arch", help="lint a single config (all strategies "
                    "x precisions x accums)")
    ap.add_argument("--all", action="store_true",
                    help="sweep every lint config and write the artifact")
    ap.add_argument("--out", default=None,
                    help=f"artifact path (default {OUT} with --all)")
    ap.add_argument("--smoke", action="store_true",
                    help="small config slice (also via LINT_SMOKE=1)")
    ap.add_argument("--validate", action="store_true",
                    help="validate the committed artifact and exit")
    ap.add_argument("--device", default="cuda",
                    help="where the rigs run (default cuda; cpu for the "
                         "plain path)")
    args = ap.parse_args(argv)

    out_path = args.out or OUT
    if args.validate:
        rep = R.validate_file(out_path)
        s = rep["summary"]
        print(f"{out_path}: OK — {s['cells']} cells, {s['pass']} pass, "
              f"{s['skip']} skip, smoke={rep['meta']['smoke']}")
        return 0

    smoke = args.smoke or os.environ.get("LINT_SMOKE") == "1"
    configs = None
    if args.arch is not None:
        if args.arch not in SW.LINT_CONFIGS:
            print(f"unknown config {args.arch!r}; valid names: "
                  + ", ".join(SW.LINT_CONFIGS), file=sys.stderr)
            raise SystemExit(2)
        configs = (args.arch,)
    elif not args.all:
        ap.error("one of --arch, --all or --validate is required")

    t0 = time.time()
    rep = SW.run(configs=configs, smoke=smoke, progress=_progress,
                 device=args.device)
    s = rep["summary"]
    print(f"linted {s['cells']} cells in {time.time() - t0:.1f}s: "
          f"{s['pass']} pass, {s['skip']} skip, {s['fail']} fail")
    if args.all or args.out:
        with open(out_path, "w") as f:
            json.dump(rep, f, indent=1, sort_keys=True)
        print(f"wrote {out_path}")
    bad = R.violations(rep)
    for line in bad:
        print(f"VIOLATION {line}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
