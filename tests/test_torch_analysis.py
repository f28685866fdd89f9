"""The port's lint tier (``repro_torch.analysis``,
``python -m repro_torch.launch.lint``): one counterpart of each test of
``tests/test_analysis.py``, run on the port's own artifacts.

  (a) every rule passes on the port's code and fails on a deliberately
      broken piece of it (``tests/_torch_lint_ranks.py``): per-leaf
      buckets, a stray all-reduce under ZeRO-1, a scalar flood, an
      exchange that never runs, an f32 payload on the bf16 wire, a step
      that keeps its input state, a gated strategy that ships every step
      or never, an unfused top-k wire, a library loaded after step 0, an
      in-place comm_state edit, a per-leaf TP finalize, a resync every
      boundary;
  (b) the report schema round-trips and the validator rejects every
      tampering mode;
  (c) a real sweep cell (gemma3-1b, ``sync`` and ``local_sgd``, f32,
      accum 1) passes through ``evaluate_cell``, and the committed
      ``LINT_torch.json`` validates;
  (d) the CLI exits 2 on an unknown config, 0 on ``--validate``, and
      raises for ``--device cuda`` without a card;
  (e) ``Fabric.collective_contract`` and ``tp_collective_contract`` are
      the reference's contracts with its ops renamed to the port's
      realization, for every profile, both wire widths and every reduced
      config's bucket layout.

Every rank rig of the file runs in ONE pool of 4 gloo ranks on the CPU
(``pool``), while the parent builds the stacked rigs.
"""

import ctypes.util
import dataclasses
import json
import os
import subprocess
import sys

import _torch_lint_ranks as LR
import jax.numpy as jnp
import pytest
import torch

from repro.analysis import rigs as JR
from repro.configs import get_config as jax_config
from repro.core.comm import ShardComm as JShardComm
from repro.core.fabric import BucketLayout as JBucketLayout
from repro.core.fabric import Fabric as JFabric
from repro.models import tensor_parallel as JTP
from repro_torch.analysis import (CELL_RULES, Cell, RuleResult, build_report,
                                  collective_budget, cond_gating,
                                  donation_aliasing, elastic_demotion_gated,
                                  fused_dispatch, gating_ratio,
                                  promotion_proof, result, retrace,
                                  state_aliasing, tp_collective_budget,
                                  tree_snapshot, validate, validate_file,
                                  violations)
from repro_torch.analysis import report as R
from repro_torch.analysis import rigs
from repro_torch.analysis import sweep as SW
from repro_torch.core.comm import LocalComm
from repro_torch.core.fabric import BucketLayout, Fabric
from repro_torch.kernels import _build
from repro_torch.models.tensor_parallel import tp_collective_contract

pytestmark = [pytest.mark.torch, pytest.mark.lint]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "gemma3-1b"
CELL_STRATEGIES = ("sync", "local_sgd")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ex(strategy, precision="f32", bucket_bytes=None):
    return rigs.exchange_spec(ARCH, strategy, precision, bucket_bytes)


PER_LEAF = ex("sync", bucket_bytes=4)
NEGATIVE_SPECS = [
    ex("sync", "bf16"), PER_LEAF, ex(LR.zero1_extra_all_reduce),
    ex(LR.sync_one_flag), ex(LR.sync_flag_flood),
    ex(LR.sync_without_exchange), ex(LR.sync_dropping_policy, "bf16"),
    ex(LR.gated_ships_every_step), ex(LR.gated_never_ships),
    ex(LR.bf16_all_sum), rigs.tp_spec("f32", bucket_bytes=4),
    rigs.elastic_spec(), rigs.elastic_spec(resync_every=1),
]


@pytest.fixture(scope="module")
def pool():
    """The sweep cell's rank rigs and every negative's, in ONE pool."""
    return SW.prepare((ARCH,), CELL_STRATEGIES, ("f32",), device="cpu",
                      extra_specs=NEGATIVE_SPECS)


def arts(pool, spec, precision=None):
    return rigs.exchange_artifacts(pool[spec["key"]], spec["strategy"],
                                   precision or spec["precision"])


def budget_of(pool, spec, contract=None, **kw):
    a = arts(pool, spec)
    return collective_budget(a["calls"], contract or a["contract"],
                             peers=a["peers"], **kw)


# ---------------------------------------------------------------------------
# collective-budget
# ---------------------------------------------------------------------------
def test_collective_budget_accepts_contract_and_scalars(pool):
    res = budget_of(pool, ex(LR.sync_one_flag))
    assert res.status == "pass", res.findings
    assert res.details["scalar"] == 1
    nb = res.details["contract"]["all_to_all"]
    assert res.details["counts"] == {"all_to_all": nb, "all_gather": nb}
    assert res.details["ranks"] == 4


def test_collective_budget_flags_per_leaf_collectives(pool):
    """The bug class the fabric exists to prevent: one collective a LEAF
    instead of a bucket."""
    good = arts(pool, ex("sync"))
    res = budget_of(pool, PER_LEAF, contract=good["contract"])
    assert res.status == "fail"
    n_leaves = res.details["counts"]["all_to_all"]
    assert n_leaves > good["n_buckets"]
    assert (f"all_gather: {n_leaves} wire call(s) exceed budget "
            f"{good['n_buckets']}") in res.findings[0]


def test_collective_budget_flags_stray_allreduce_on_zero1(pool):
    """ZeRO-1's contract has no dense all-reduce: one beside the
    reduce-scatters doubles both ops."""
    res = budget_of(pool, ex(LR.zero1_extra_all_reduce))
    assert res.status == "fail"
    assert any(f.startswith("all_to_all:") for f in res.findings)


def test_collective_budget_flags_scalar_flood_and_empty_wire(pool):
    res = budget_of(pool, ex(LR.sync_flag_flood))
    assert res.status == "fail"
    assert "5 scalar collectives exceed allowance 4" in res.findings
    res = budget_of(pool, ex(LR.sync_without_exchange))
    assert res.status == "fail"
    assert "no wire collective called" in res.findings[0]


def test_collective_budget_flags_a_rank_that_differs(pool):
    a = arts(pool, ex("sync"))
    peers = [list(p) for p in a["peers"]]
    peers[1] = peers[1][:-1]  # rank 2 skipped a bucket's all-gather
    res = collective_budget(a["calls"], a["contract"], peers=peers)
    assert res.status == "fail"
    assert res.findings == ["rank 2's call log differs from rank 0's "
                            f"({len(a['calls']) - 1} calls vs "
                            f"{len(a['calls'])})"]


# ---------------------------------------------------------------------------
# tp-collective-budget
# ---------------------------------------------------------------------------
def test_tp_collective_budget_passes_and_skips(pool):
    a = rigs.tp_artifacts(pool[rigs.tp_spec("f32")["key"]], "f32")
    res = tp_collective_budget(a["calls"], a["contract"], a["tp_degree"],
                               peers=a["peers"])
    assert res.status == "pass", res.findings
    # 2 layers x (wo + w_down) x (fwd + bwd) combines, + 1 finalize bucket
    assert res.details["counts"] == {"all_to_all": 9, "all_gather": 9}
    assert tp_collective_budget([], {}, 1).status == "skip"


def test_tp_collective_budget_flags_per_leaf_finalize(pool):
    a = rigs.tp_artifacts(pool[rigs.tp_spec("f32", 4)["key"]], "f32")
    res = tp_collective_budget(a["calls"], a["contract"], a["tp_degree"])
    assert res.status == "fail"
    assert "exceed tp budget 9" in res.findings[0]
    res = tp_collective_budget([], a["contract"], 2)
    assert "no wire collective called" in res.findings[0]


# ---------------------------------------------------------------------------
# promotion-proof
# ---------------------------------------------------------------------------
def test_promotion_proof_skips_wide_wire_and_accepts_narrow(pool):
    wide = arts(pool, ex("sync"))
    assert promotion_proof(wide["calls"], narrow_wire=False).status == "skip"
    narrow = arts(pool, ex("sync", "bf16"))
    res = promotion_proof(narrow["calls"], narrow_wire=True)
    assert res.status == "pass", res.findings
    # the bf16 chunks' all-to-all and the 16-bit image's all-gather
    assert {(c["op"], c["dtype"]) for c in narrow["calls"]} == {
        ("all_to_all", "bfloat16"), ("all_gather", "int16")}


def test_promotion_proof_flags_f32_payload_on_narrow_wire(pool):
    a = arts(pool, ex(LR.sync_dropping_policy, "bf16"))
    res = promotion_proof(a["calls"], a["narrow_wire"])
    assert a["narrow_wire"] and res.status == "fail"
    assert "f32 payload" in res.findings[0]


def test_bf16_all_sum_logs_bfloat16(pool):
    calls = arts(pool, ex(LR.bf16_all_sum))["calls"]
    # 64 elements over 4 ranks: 16 a chunk
    assert calls == [{"op": "all_to_all", "dtype": "bfloat16", "bytes": 128},
                     {"op": "all_gather", "dtype": "bfloat16", "bytes": 32}]


# ---------------------------------------------------------------------------
# donation-aliasing
# ---------------------------------------------------------------------------
def test_donation_aliasing_passes_on_donated_step():
    art = rigs.loop_artifacts("sync", "f32", 1)
    res = donation_aliasing(art["alias_bytes"], art["donated_bytes"])
    assert res.status == "pass", res.findings
    assert res.details["frac"] >= 0.5


def keeps_input(step):
    kept = []

    def run(state, batch):
        kept.append(state)  # the input state outlives the step
        return step(state, batch)

    return run


def test_donation_aliasing_flags_undonated_step():
    art = rigs.loop_artifacts("sync", "f32", 1, wrap=keeps_input)
    res = donation_aliasing(art["alias_bytes"], art["donated_bytes"])
    assert res.status == "fail"
    assert "donation had no effect" in res.findings[0]


def test_donation_aliasing_flags_partial_aliasing():
    res = donation_aliasing(alias_bytes=100, donated_bytes=1000)
    assert res.status == "fail"
    assert "10.0%" in res.findings[0]


# ---------------------------------------------------------------------------
# cond-gating and elastic-demotion-gated
# ---------------------------------------------------------------------------
def test_cond_gating_passes_on_gated_schedule(pool):
    a = arts(pool, ex("local_sgd"))
    res = cond_gating(a["logs"], gated=True, sync_every=8)
    assert res.status == "pass", res.findings
    assert res.details["under_cond"] == res.details["collectives"] > 0


def test_cond_gating_flags_where_gate(pool):
    a = arts(pool, ex(LR.gated_ships_every_step))
    res = cond_gating(a["logs"], gated=True, sync_every=4)
    assert res.status == "fail"
    assert "at t=0, off the sync_every=4 schedule" in res.findings[0]


def test_cond_gating_flags_exchange_that_never_runs(pool):
    a = arts(pool, ex(LR.gated_never_ships))
    res = cond_gating(a["logs"], gated=True, sync_every=4)
    assert res.status == "fail"
    assert "never ran" in res.findings[0]
    assert cond_gating(a["logs"], gated=False).status == "skip"


def test_gating_ratio_bounds(pool):
    assert gating_ratio(800.0, 100.0, sync_every=8).status == "pass"
    assert gating_ratio(800.0, 700.0, sync_every=8).status == "fail"
    assert gating_ratio(0.0, 0.0, sync_every=8).status == "fail"
    # the where-gate's bytes: the full exchange at each of the 4 steps
    sent = [sum(c["bytes"] for c in log)
            for log in arts(pool, ex(LR.gated_ships_every_step))["logs"]]
    assert gating_ratio(4 * sent[-1], sum(sent), 4).status == "fail"


def test_elastic_demotion_gated_rule(pool):
    logs = pool[rigs.elastic_spec()["key"]][0]["logs"]
    res = elastic_demotion_gated(logs, resync_every=4)
    assert res.status == "pass", res.findings
    assert [len(c) > 0 for c in logs] == [False, False, False, True]
    # a resync run every boundary against the schedule of 4
    bad = pool[rigs.elastic_spec(resync_every=1)["key"]][0]["logs"]
    res = elastic_demotion_gated(bad, resync_every=4)
    assert res.status == "fail"
    assert "off the resync_every=4 schedule" in res.findings[0]
    res = elastic_demotion_gated([[], [], [], []], resync_every=4)
    assert "the gated resync never ran" in res.findings[0]


# ---------------------------------------------------------------------------
# fused-dispatch
# ---------------------------------------------------------------------------
# four leaves of 1024 f32: one 4 KiB bucket each
FUSED_PARAMS = {k: torch.empty(1024) for k in "abcd"}


def test_fused_dispatch_passes_on_fused_path():
    art = rigs.fused_artifacts(FUSED_PARAMS, "f32", bucket_bytes=4096)
    res = fused_dispatch(art["fused_calls"], art["codec_calls"],
                         art["n_buckets"], art["launches"])
    assert res.status == "pass", res.findings
    assert art["fused_calls"] == art["n_buckets"] == 4
    assert art["launches"] is None  # CPU tensors: the plain version


def test_fused_dispatch_flags_unfused_codec():
    art = rigs.fused_artifacts(FUSED_PARAMS, "f32", bucket_bytes=4096,
                               fused=False)
    res = fused_dispatch(art["fused_calls"], art["codec_calls"],
                         art["n_buckets"], art["launches"])
    assert res.status == "fail"
    msgs = " | ".join(res.findings)
    assert "no fused encode" in msgs
    assert "codec round invoked 16 time(s)" in msgs  # 4 buckets x 4 replicas
    assert fused_dispatch(0, 16, 4, expect_fused=False).status == "skip"
    # on the card: a fused path whose kernel did not launch once a bucket
    res = fused_dispatch(4, 0, 4, launches=0)
    assert res.findings == ["topk_encode_ef launched 0 time(s) for 4 "
                            "bucket(s)"]


# ---------------------------------------------------------------------------
# retrace-detector
# ---------------------------------------------------------------------------
def test_retrace_passes_on_stable_steps():
    art = rigs.loop_artifacts("sync_dgc", "f32", 1)
    res = retrace(art["cache_sizes"])
    assert res.status == "pass", res.findings
    assert len(art["cache_sizes"]) == 3


def test_retrace_flags_a_library_loaded_after_step_0(monkeypatch):
    libm = ctypes.util.find_library("m")
    monkeypatch.setattr(_build, "build_all", lambda: {"lint_probe": libm})
    monkeypatch.setattr(_build, "_loaded", dict(_build._loaded))

    def loads_late(step):
        calls = []

        def run(state, batch):
            calls.append(1)
            if len(calls) == 2:
                _build.load("lint_probe")
            return step(state, batch)

        return run

    art = rigs.loop_artifacts("sync", "f32", 1, wrap=loads_late)
    res = retrace(art["cache_sizes"])
    assert res.status == "fail"
    assert res.findings[0].startswith("retrace at step 1: cache grew")
    assert retrace([]).status == "fail"


# ---------------------------------------------------------------------------
# state-aliasing
# ---------------------------------------------------------------------------
def test_state_aliasing_clean_update_passes():
    art = rigs.state_aliasing_artifacts("downpour", "f32")
    for before, after in art["snapshots"]:
        assert state_aliasing(before, after).status == "pass"
    state = {"velocity": [torch.ones(4)], "t": torch.zeros(())}
    assert tree_snapshot(state) == tree_snapshot(state)


def test_state_aliasing_flags_inplace_mutation():
    art = rigs.state_aliasing_artifacts(LR.downpour_writing_comm_state,
                                        "f32")
    before, after = art["snapshots"][0]
    res = state_aliasing(before, after)
    assert res.status == "fail"
    msgs = " | ".join(res.findings)
    assert "replaced in place" in msgs and "inserted into the argument" in msgs


# ---------------------------------------------------------------------------
# report schema + validator tampering modes
# ---------------------------------------------------------------------------
def _mini_report():
    cells = [Cell(ARCH, "sync", "f32", 1,
                  [result(r, []) for r in CELL_RULES])]
    return build_report(cells, {"backend": "cpu", "torch": torch.__version__,
                                "smoke": True, "workers": 4})


def test_report_roundtrip_validates(tmp_path):
    rep = _mini_report()
    validate(rep)
    p = tmp_path / "LINT_torch.json"
    p.write_text(json.dumps(rep))
    assert validate_file(str(p))["summary"]["pass"] == len(CELL_RULES)


def test_result_constructor_guards():
    with pytest.raises(ValueError, match="unknown rule"):
        result("no-such-rule", [])
    with pytest.raises(ValueError, match="fail with no findings"):
        RuleResult("retrace-detector", "fail", [])
    assert result("retrace-detector", [], skip="why").status == "skip"
    assert result("retrace-detector", ["boom"]).status == "fail"


@pytest.mark.parametrize("tamper,msg", [
    (lambda r: r.pop("summary"), "missing section"),
    (lambda r: r["meta"].pop("workers"), "meta missing"),
    (lambda r: r["meta"].pop("torch"), "meta missing"),
    (lambda r: r["meta"].update(schema=2), "unsupported schema"),
    (lambda r: r.update(cells=[]), "empty cell list"),
    (lambda r: r.update(cells=r["cells"] * 2), "duplicate cell"),
    (lambda r: r["cells"][0]["rules"].pop(), "missing rules"),
    (lambda r: r["cells"][0]["rules"][0].update(status="bogus"),
     "bad status"),
    (lambda r: r["summary"].update(cells=99), "cell count mismatch"),
])
def test_validate_rejects_tampering(tamper, msg):
    rep = _mini_report()
    tamper(rep)
    with pytest.raises(ValueError, match=msg):
        validate(rep)


def test_validate_rejects_failing_report():
    rep = _mini_report()
    rep["cells"][0]["rules"][0].update(status="fail",
                                       findings=["stray all_to_all"])
    assert violations(rep) == \
        [f"{ARCH}/sync/f32/accum1: collective-budget: stray all_to_all"]
    with pytest.raises(ValueError, match="rule violation"):
        validate(rep)


def test_validate_file_missing(tmp_path):
    with pytest.raises(ValueError, match="missing"):
        validate_file(str(tmp_path / "nope.json"))


# ---------------------------------------------------------------------------
# end to end: a real sweep cell, the committed artifact, the CLI
# ---------------------------------------------------------------------------
def test_sweep_cell_passes_on_production_rigs(pool):
    """Real matrix cells through ``evaluate_cell``: the eight rules
    report, none fails."""
    cells = [SW.evaluate_cell(pool, ARCH, s, "f32", 1)
             for s in CELL_STRATEGIES]
    rep = build_report(cells, {"backend": "cpu", "torch": torch.__version__,
                               "smoke": True, "workers": 4})
    R.validate(rep)
    status = {(c.strategy, r.rule): r.status for c in cells for r in c.rules}
    assert status[("local_sgd", "cond-gating")] == "pass"
    assert status[("sync", "cond-gating")] == "skip"
    assert all(status[(s, r)] == "pass" for s in CELL_STRATEGIES
               for r in ("collective-budget", "tp-collective-budget",
                         "donation-aliasing", "retrace-detector",
                         "state-aliasing"))


def test_committed_artifact_validates():
    rep = validate_file(os.path.join(ROOT, "LINT_torch.json"))
    assert rep["summary"]["cells"] == 440
    assert rep["meta"]["backend"] == "cpu" and not rep["meta"]["smoke"]
    assert rep["meta"]["configs"] == sorted(SW.LINT_CONFIGS)
    assert all(len(c["rules"]) == len(CELL_RULES) for c in rep["cells"])


def test_lint_cli_exit_codes():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    run = [sys.executable, "-m", "repro_torch.launch.lint"]
    bad = subprocess.run(run + ["--arch", "bogus", "--device", "cpu"],
                         capture_output=True, text=True, env=env,
                         timeout=120)
    assert bad.returncode == 2
    assert "unknown config 'bogus'" in bad.stderr.splitlines()[0]
    ok = subprocess.run(run + ["--validate"], capture_output=True, text=True,
                        env=env, cwd=ROOT, timeout=120)
    assert ok.returncode == 0, ok.stderr[-2000:]
    assert "OK — 440 cells" in ok.stdout
    if not torch.cuda.is_available():
        card = subprocess.run(run + ["--arch", ARCH], capture_output=True,
                              text=True, env=env, timeout=120)
        assert card.returncode != 0
        assert "torch.cuda.is_available() is False" in card.stderr


def test_strategies_match_the_reference_matrix():
    from repro.analysis import sweep as JS

    assert SW.LINT_STRATEGIES == JS.LINT_STRATEGIES
    assert SW.LINT_CONFIGS == JS.LINT_CONFIGS
    assert SW.SMOKE_CONFIGS == JS.SMOKE_CONFIGS
    assert (SW.LINT_PRECISIONS, SW.LINT_ACCUMS) == (JS.LINT_PRECISIONS,
                                                    JS.LINT_ACCUMS)


# ---------------------------------------------------------------------------
# the contracts against the reference's
# ---------------------------------------------------------------------------
# the reference's HLO op -> the ShardComm calls that realize it
REALIZED = {"all-reduce": ("all_to_all", "all_gather"),
            "reduce-scatter": ("all_to_all",),
            "all-to-all": ("all_to_all",), "all-gather": ("all_gather",),
            "collective-permute": ("ppermute",)}
PROFILES = {"dense": 1, "partitioned": 1, "compressed": 1, "ring": 2,
            "tp": 8, "none": 1}  # profile -> events


def realized(ref_contract):
    out = {}
    for op, n in ref_contract.items():
        for mine in REALIZED[op]:
            assert out.setdefault(mine, n) == n
    return out


@pytest.mark.parametrize("arch", SW.LINT_CONFIGS)
def test_collective_contract_matches_reference(arch):
    """Every profile at both wire widths on the config's reduced tree,
    bucketed as the rigs bucket it: the same bucket count as the
    reference's ``BucketLayout`` and the reference's contract realized."""
    sds = JR.param_sds(jax_config(arch), None)
    bb = JR.pick_bucket_bytes(sds)
    ref_lay = JBucketLayout.build(sds, bb, lead_axes=0)
    params = rigs.init_params(arch, None)
    assert rigs.pick_bucket_bytes(params) == bb
    lay = BucketLayout.build(params, bb, lead_axes=0)
    assert lay.n_buckets == ref_lay.n_buckets
    assert lay.bucket_sizes == ref_lay.bucket_sizes
    for wire in (None, "bfloat16"):
        ref = JFabric(JShardComm("pod", 4), bb, wire_dtype=wire)
        mine = Fabric(LocalComm(4), bb, wire_dtype=wire)
        for profile, events in PROFILES.items():
            want = realized(ref.collective_contract(ref_lay, profile,
                                                    events=events))
            assert mine.collective_contract(lay, profile,
                                            events=events) == want, \
                (arch, wire, profile)
    with pytest.raises(ValueError, match="unknown wire profile"):
        mine.collective_contract(lay, "bogus")


@pytest.mark.parametrize("wire", [None, "bfloat16"])
def test_tp_collective_contract_matches_reference(wire):
    import jax

    from repro.models.tensor_parallel import tp_collective_contract as jtp

    cfg = rigs.tp_config("f32")
    jcfg = dataclasses.replace(jax_config("qwen2-1.5b").reduced(),
                               **rigs.TP_CUT, tp_degree=rigs.TP_DEGREE)
    shape = rigs.TP_TOKENS + (cfg.d_model,)
    # the default bucket and one smaller than the activation (a leaf is
    # never split: one bucket either way)
    for bb in (JTP.DEFAULT_BUCKET_BYTES, 64):
        want = realized(jtp(jcfg, jax.ShapeDtypeStruct(shape, jnp.float32),
                            bb, wire_dtype=wire))
        got = tp_collective_contract(
            cfg, torch.empty(shape, device="meta"), bb, wire_dtype=wire)
        assert got == want == {"all_to_all": 8, "all_gather": 8}
