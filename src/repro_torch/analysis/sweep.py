"""Matrix sweep: every lint rule for every (config × strategy × precision ×
accum) cell, assembled into one report.

Port of ``repro/analysis/sweep.py``, the same matrix and the same reuse of
artifacts, recorded in each rule's details:

  * exchange artifacts are per (config, strategy, precision): the loop
    calls ``strategy.update`` once a boundary, so the boundary exchange is
    the same at every ``accum_steps`` and the accum cells lint one rig;
  * loop artifacts (donation, retrace) and eager artifacts
    (state-aliasing) prove contracts of ``train/loop.py`` and the strategy
    code that do not depend on the model, so they are shared across
    configs.

Every rank rig of a sweep runs in ONE pool of ``rigs.WORKERS`` gloo
ranks (``prepare``), before the cells are evaluated.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.analysis import rigs, rules
from repro_torch.analysis.report import Cell, RuleResult, build_report, result
from repro_torch.configs import list_configs
from repro_torch.core import strategies as ST

# the 10 registered archs + the sliding-window long-context variant
LINT_CONFIGS = tuple(sorted(list_configs())) + ("qwen2.5-14b-swa",)
LINT_STRATEGIES = tuple(sorted(ST.REGISTRY))
LINT_PRECISIONS = ("f32", "bf16")
LINT_ACCUMS = (1, 4)

SMOKE_CONFIGS = ("gemma3-1b", "qwen2-1.5b")


class _Cache(dict):
    """Every rig of a sweep, by key; ``device`` places the rigs this
    process builds."""

    def __init__(self, device="cuda"):
        super().__init__()
        self.device = device

    def get_or(self, key, build):
        if key not in self:
            self[key] = build()
        return self[key]


def rank_specs(configs, strategies, precisions) -> list:
    """The rank rigs the matrix needs: an exchange rig a (config,
    strategy, precision) and a TP rig a precision."""
    return ([rigs.exchange_spec(c, s, p) for c in configs
             for s in strategies for p in precisions]
            + [rigs.tp_spec(p) for p in precisions])


def prepare(configs, strategies, precisions, device="cuda",
            extra_specs=()) -> _Cache:
    """A cache holding the matrix's rank rigs, run in ONE pool (with
    ``extra_specs`` beside them; their results are in the cache under
    their keys)."""
    cache = _Cache(device)
    cache.update(rigs.run_pool(
        rank_specs(configs, strategies, precisions) + list(extra_specs),
        device))
    return cache


def _exchange_rules(cache: _Cache, cfg_name: str, strategy: str,
                    precision: str, accum: int) -> List[RuleResult]:
    spec = rigs.exchange_spec(cfg_name, strategy, precision)
    ex = cache.get_or(("artifacts",) + spec["key"],
                      lambda: rigs.exchange_artifacts(cache[spec["key"]],
                                                      strategy, precision))
    strat = ex["strategy"]
    budget = rules.collective_budget(ex["calls"], ex["contract"],
                                     peers=ex["peers"])
    budget.details["n_buckets"] = ex["n_buckets"]
    if accum > 1:
        budget.details["accum_note"] = (
            "boundary exchange is accum-invariant: the loop calls "
            "strategy.update once a boundary (tests/test_torch_accum.py)")
    promo = rules.promotion_proof([c for log in ex["logs"] for c in log],
                                  ex["narrow_wire"])
    gating = rules.cond_gating(ex["logs"], strat.gated, strat.sync_every)
    if strat.gated:
        # the bytes of the period against the firing step's bytes shipped
        # every step
        sent = [sum(c["bytes"] for c in log) for log in ex["logs"]]
        ratio = rules.gating_ratio(strat.sync_every * sent[-1], sum(sent),
                                   strat.sync_every)
        gating = result("cond-gating", gating.findings + ratio.findings,
                        {**gating.details, **ratio.details})
    return [budget, promo, gating]


def _fused_rule(cache: _Cache, cfg_name: str, strategy: str,
                precision: str) -> RuleResult:
    # only compressed wire profiles dispatch the fused codec kernels
    if strategy != "sync_dgc":
        return result("fused-dispatch", [],
                      skip="uncompressed wire (no codec on this path)")

    def build():
        params = cache.get_or(("params", cfg_name),
                              lambda: rigs.init_params(cfg_name, None))
        return rigs.fused_artifacts(params, precision, device=cache.device)

    art = cache.get_or(("fused", cfg_name, precision), build)
    return rules.fused_dispatch(art["fused_calls"], art["codec_calls"],
                                art["n_buckets"], art["launches"])


def _tp_rule(cache: _Cache, precision: str) -> RuleResult:
    key = rigs.tp_spec(precision)["key"]
    art = cache.get_or(("artifacts",) + key,
                       lambda: rigs.tp_artifacts(cache[key], precision))
    rr = rules.tp_collective_budget(art["calls"], art["contract"],
                                    art["tp_degree"], peers=art["peers"])
    rr.details["shared_rig"] = "per precision (model-level contract)"
    return rr


def _loop_rules(cache: _Cache, strategy: str, precision: str,
                accum: int) -> List[RuleResult]:
    art = cache.get_or(
        ("loop", strategy, precision, accum),
        lambda: rigs.loop_artifacts(strategy, precision, accum,
                                    device=cache.device))
    donation = rules.donation_aliasing(art["alias_bytes"],
                                       art["donated_bytes"])
    donation.details["shared_rig"] = "per (strategy, precision, accum)"
    retrace = rules.retrace(art["cache_sizes"])
    return [donation, retrace]


def _state_rule(cache: _Cache, strategy: str, precision: str) -> RuleResult:
    art = cache.get_or(
        ("state", strategy, precision),
        lambda: rigs.state_aliasing_artifacts(strategy, precision,
                                              device=cache.device))
    findings: List[str] = []
    for before, after in art["snapshots"]:
        findings.extend(rules.state_aliasing(before, after).findings)
    return result("state-aliasing", findings,
                  {"update_calls": len(art["snapshots"])})


def evaluate_cell(cache: _Cache, cfg_name: str, strategy: str,
                  precision: str, accum: int) -> Cell:
    """One cell's eight rules; its rank rigs must be in ``cache``
    (``prepare``)."""
    rr = _exchange_rules(cache, cfg_name, strategy, precision, accum)
    rr.append(_tp_rule(cache, precision))
    rr.append(_fused_rule(cache, cfg_name, strategy, precision))
    rr.extend(_loop_rules(cache, strategy, precision, accum))
    rr.append(_state_rule(cache, strategy, precision))
    return Cell(cfg_name, strategy, precision, accum, rr)


def sweep(configs: Optional[Tuple[str, ...]] = None,
          strategies: Tuple[str, ...] = LINT_STRATEGIES,
          precisions: Tuple[str, ...] = LINT_PRECISIONS,
          accums: Tuple[int, ...] = LINT_ACCUMS,
          smoke: bool = False, progress=None,
          device="cuda", cache: Optional[_Cache] = None
          ) -> Tuple[List[Cell], Dict]:
    """Evaluate the matrix on ``device``; returns (cells, stats):
    ``rigs_built`` counts every rig, rank rigs included.  ``cache``: one
    ``prepare`` already ran (with extra specs beside the matrix's)."""
    from repro_torch import resolve_device

    resolve_device(device)  # a CUDA device without a card raises
    if configs is None:
        configs = SMOKE_CONFIGS if smoke else LINT_CONFIGS
    if cache is None:
        cache = prepare(configs, strategies, precisions, device)
    cells: List[Cell] = []
    for cfg_name in configs:
        for strategy in strategies:
            for precision in precisions:
                for accum in accums:
                    cells.append(evaluate_cell(cache, cfg_name, strategy,
                                               precision, accum))
                    if progress is not None:
                        progress(cells[-1])
    built = [k for k in cache if k[0] not in ("artifacts", "params")]
    return cells, {"rigs_built": len(built)}


def run(configs: Optional[Tuple[str, ...]] = None, smoke: bool = False,
        progress=None, device="cuda", cache: Optional[_Cache] = None
        ) -> dict:
    cells, stats = sweep(configs=configs, smoke=smoke, progress=progress,
                         device=device, cache=cache)
    meta = {
        "backend": torch.device(device).type,
        "torch": torch.__version__,
        "smoke": bool(smoke),
        "workers": rigs.WORKERS,
        "configs": sorted({c.config for c in cells}),
        "strategies": list(LINT_STRATEGIES),
        "precisions": list(LINT_PRECISIONS),
        "accums": list(LINT_ACCUMS),
        **stats,
    }
    return build_report(cells, meta)
