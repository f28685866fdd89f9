"""Report schema of the port's linter.

Port of ``repro/analysis/report.py``, schema unchanged: one
``RuleResult`` per (rule, matrix cell), one report per sweep.
``LINT_torch.json`` is the committed artifact; ``validate`` rejects a
missing file, a malformed record or any ``fail`` status.  The only
difference is ``meta``: it names the torch build and the device type
(``backend``) in place of the jax version and backend.  The validator's
helpers (``require_sections``, ``require_keys``, ``check``) are the
port's own copies of ``benchmarks/common.py``'s.

Statuses:

  pass  the measured artifact satisfies the contract
  fail  a violation; ``findings`` carries one message per offence
  skip  the rule does not apply to this cell (e.g. promotion-proof on an
        f32 wire); never counts against the sweep
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import List, Optional

# every lint-matrix CELL carries exactly these rules
CELL_RULES = (
    "collective-budget",
    "tp-collective-budget",
    "promotion-proof",
    "donation-aliasing",
    "cond-gating",
    "fused-dispatch",
    "retrace-detector",
    "state-aliasing",
)

# the full rule vocabulary: CELL_RULES plus the rule proven once on its
# own rig (elastic-demotion-gated, on ``rigs.elastic_artifacts``)
RULES = CELL_RULES + (
    "elastic-demotion-gated",
)

STATUSES = ("pass", "fail", "skip")


def check(cond, msg: str):
    """One uniform failure shape for the validator."""
    if not cond:
        raise ValueError(msg)


def require_sections(report: dict, names, label: str):
    for key in names:
        check(key in report, f"{label}: missing section {key!r}")


def require_keys(row: dict, fields, label: str):
    for f_ in fields:
        check(f_ in row, f"{label} missing {f_!r}: {row}")


@dataclass
class RuleResult:
    rule: str
    status: str
    findings: List[str] = field(default_factory=list)
    details: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.rule not in RULES:
            raise ValueError(f"unknown rule {self.rule!r}")
        if self.status not in STATUSES:
            raise ValueError(f"unknown status {self.status!r}")
        if self.status == "fail" and not self.findings:
            raise ValueError(f"{self.rule}: fail with no findings")

    def to_json(self) -> dict:
        return {"rule": self.rule, "status": self.status,
                "findings": list(self.findings), "details": self.details}


def result(rule: str, findings: List[str], details: Optional[dict] = None,
           skip: Optional[str] = None) -> RuleResult:
    """Build a RuleResult: ``skip`` (a reason string) wins, else the
    presence of findings decides pass/fail."""
    if skip is not None:
        return RuleResult(rule, "skip", [], {"reason": skip,
                                             **(details or {})})
    return RuleResult(rule, "fail" if findings else "pass",
                      findings, details or {})


@dataclass
class Cell:
    config: str
    strategy: str
    precision: str
    accum: int
    rules: List[RuleResult]

    def to_json(self) -> dict:
        return {"config": self.config, "strategy": self.strategy,
                "precision": self.precision, "accum": self.accum,
                "rules": [r.to_json() for r in self.rules]}


def build_report(cells: List[Cell], meta: dict) -> dict:
    counts = {"pass": 0, "fail": 0, "skip": 0}
    for c in cells:
        for r in c.rules:
            counts[r.status] += 1
    return {
        "meta": {"schema": 1, **meta},
        "cells": [c.to_json() for c in cells],
        "summary": {"cells": len(cells), **counts,
                    "violations": counts["fail"]},
    }


def violations(report: dict) -> List[str]:
    """Flat '<config>/<strategy>/<precision>/accum<k>: <rule>: <msg>'
    lines for every failing rule in the report."""
    out = []
    for c in report.get("cells", []):
        tag = (f"{c['config']}/{c['strategy']}/{c['precision']}"
               f"/accum{c['accum']}")
        for r in c["rules"]:
            if r["status"] == "fail":
                for f in r["findings"] or ["(no message)"]:
                    out.append(f"{tag}: {r['rule']}: {f}")
    return out


def validate(report: dict, path: str = "LINT_torch.json") -> dict:
    """Schema + acceptance check; raises ValueError on any problem.

    Acceptance (smoke or full): zero ``fail`` statuses, the lint
    contracts must hold on whatever slice was swept."""
    require_sections(report, ("meta", "cells", "summary"), path)
    meta = report["meta"]
    check(meta.get("schema") == 1,
          f"{path}: unsupported schema {meta.get('schema')}")
    require_keys(meta, ("backend", "torch", "smoke", "workers"),
                 f"{path}: meta")
    cells = report["cells"]
    check(cells, f"{path}: empty cell list")
    seen = set()
    for c in cells:
        require_keys(c, ("config", "strategy", "precision", "accum",
                         "rules"), f"{path}: cell")
        tag = (c["config"], c["strategy"], c["precision"], c["accum"])
        check(tag not in seen, f"{path}: duplicate cell {tag}")
        seen.add(tag)
        check(c["rules"], f"{path}: cell {tag} has no rule results")
        names = [r.get("rule") for r in c["rules"]]
        for r in c["rules"]:
            check(r.get("rule") in RULES,
                  f"{path}: unknown rule {r.get('rule')!r}")
            check(r.get("status") in STATUSES,
                  f"{path}: bad status {r.get('status')!r} in {tag}")
        missing = set(CELL_RULES) - set(names)
        check(not missing,
              f"{path}: cell {tag} missing rules {sorted(missing)}")
    bad = violations(report)
    check(not bad, f"{path}: {len(bad)} rule violation(s); first: "
                   + (bad[0] if bad else ""))
    summ = report["summary"]
    check(summ.get("cells") == len(cells),
          f"{path}: summary cell count mismatch")
    return report


def validate_file(path: str) -> dict:
    try:
        with open(path) as f:
            report = json.load(f)
    except FileNotFoundError:
        raise ValueError(f"{path}: missing — run "
                         f"`python -m repro_torch.launch.lint --all "
                         f"--device cpu` and commit the artifact") from None
    except json.JSONDecodeError as e:
        raise ValueError(f"{path}: not valid JSON ({e})") from None
    return validate(report, path)
