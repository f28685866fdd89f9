"""repro_torch.analysis: the linter over the port's measured artifacts.

Port of ``repro/analysis`` (DESIGN.md §11).  Every performance contract
is a named lint rule with ONE implementation (``rules``), fed by rig
builders (``rigs``) that run the port's own code and record what it does
(``ShardComm`` call logs, host-decided schedules, storage reuse, kernel
libraries built), swept over the config × strategy × precision × accum
matrix (``sweep``), reported in the reference's schema (``report``), and
driven by ``python -m repro_torch.launch.lint``, whose committed
``LINT_torch.json`` the tests validate.
"""

from repro_torch.analysis.report import (  # noqa: F401
    CELL_RULES,
    RULES,
    Cell,
    RuleResult,
    build_report,
    result,
    validate,
    validate_file,
    violations,
)
from repro_torch.analysis.rules import (  # noqa: F401
    collective_budget,
    cond_gating,
    donation_aliasing,
    elastic_demotion_gated,
    fused_dispatch,
    gating_ratio,
    promotion_proof,
    retrace,
    state_aliasing,
    tp_collective_budget,
    tree_snapshot,
)
