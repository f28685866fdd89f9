"""The lint rules of the port: pure functions over measured artifacts.

Port of ``repro/analysis/rules.py``: the reference's nine rules, with its
names, bounds, findings and details keys.  The reference reads what XLA
made (HLO text, jaxprs, alias tables, jit cache sizes); the port has no
compiler between the program and the card, so each rule reads what the
port's own code does when it runs, as its docstring says:

  * a ``ShardComm.record`` call log (``core/comm.py``): one
    ``{"op", "dtype", "bytes"}`` record a backend call, in the op names of
    ``Fabric.collective_contract`` (``all_to_all``, ``all_gather``,
    ``ppermute``, ``all_min``, ``scalars``), stands in for the HLO
    collectives;
  * a strategy's host-decided schedule (``core/strategies.py``: the step
    is a Python int) stands in for ``lax.cond``: a gated exchange is
    proven by the calls it logs at each step of its period;
  * storage reuse or release of the input state after a step stands in
    for XLA's donation aliases;
  * the count of kernel libraries built or loaded
    (``kernels/_build.py::libraries_built``) stands in for the jit cache.

No rule builds or runs anything: ``repro_torch.analysis.rigs`` produces
the artifacts.  Each function returns a ``RuleResult`` (pass /
fail+findings / skip).
"""

from __future__ import annotations

from collections import Counter
from typing import List, Optional, Sequence

from repro_torch.analysis.report import RuleResult, result

# Calls above this many bytes are "wire" traffic charged against the
# bucket budget; at or below it they are scalar control traffic (a loss
# mean, the finite flag's minimum under loss scaling), which every step
# is allowed a small number of.
SCALAR_BYTES_OK = 64
SCALAR_COUNT_OK = 4

NARROW_FORBIDDEN = ("float32", "float64")


def _split_wire_scalar(calls, scalar_bytes_ok: int):
    wire = [c for c in calls if c["bytes"] > scalar_bytes_ok]
    scalar = [c for c in calls if c["bytes"] <= scalar_bytes_ok]
    return wire, scalar


def _peer_findings(calls, peers) -> List[str]:
    """One finding a rank whose log is not rank 0's."""
    return [f"rank {i}'s call log differs from rank 0's ({len(p)} calls "
            f"vs {len(calls)})"
            for i, p in enumerate(peers, start=1) if list(p) != list(calls)]


def _budget(calls, contract, scalar_bytes_ok, scalar_count_ok, what):
    wire, scalar = _split_wire_scalar(calls, scalar_bytes_ok)
    counts = Counter(c["op"] for c in wire)
    findings: List[str] = []
    for op, n in sorted(counts.items()):
        cap = int(contract.get(op, 0))
        if n > cap:
            findings.append(
                f"{op}: {n} wire call(s) exceed {what} {cap}")
    if len(scalar) > scalar_count_ok:
        findings.append(
            f"{len(scalar)} scalar collectives exceed allowance "
            f"{scalar_count_ok}")
    return wire, scalar, counts, findings


# ---------------------------------------------------------------------------
# collective-budget: <= n_buckets calls an exchange, per op
# ---------------------------------------------------------------------------
def collective_budget(calls, contract: dict,
                      scalar_bytes_ok: int = SCALAR_BYTES_OK,
                      scalar_count_ok: int = SCALAR_COUNT_OK,
                      require_wire: bool = True,
                      peers: Sequence = ()) -> RuleResult:
    """Lint rank 0's call log of ONE ``strategy.update`` (at a step where
    its exchange fires, over a ``ShardComm`` of 4 ranks) against a
    ``Fabric.collective_contract``: every wire-sized op stays within its
    budget, ops absent from the contract are not called at all, and
    scalar control traffic stays under a small count allowance.  The
    reference reads the HLO of ``shard_map(strategy.update)``.

    ``require_wire``: a non-empty contract must log at least one wire
    call (an exchange that never ran violates it as much as an extra
    all-reduce).  ``peers``: the other ranks' logs of the same call; a
    rank whose log is not rank 0's is a finding."""
    wire, scalar, counts, findings = _budget(
        calls, contract, scalar_bytes_ok, scalar_count_ok, "budget")
    if require_wire and contract and not wire:
        findings.insert(0, "no wire collective called for a non-empty "
                           f"contract {contract}")
    findings.extend(_peer_findings(calls, peers))
    return result("collective-budget", findings,
                  {"counts": dict(counts), "scalar": len(scalar),
                   "contract": {k: int(v) for k, v in contract.items()},
                   "ranks": 1 + len(peers)})


# ---------------------------------------------------------------------------
# tp-collective-budget: the TP combines stay within the "tp" contract
# ---------------------------------------------------------------------------
def tp_collective_budget(calls, contract: dict, tp_degree: int,
                         scalar_bytes_ok: int = SCALAR_BYTES_OK,
                         scalar_count_ok: int = SCALAR_COUNT_OK,
                         peers: Sequence = ()) -> RuleResult:
    """Lint the call log of one TP rank step (forward, backward and
    ``TPContext.finalize_grads``) against ``tp_collective_contract`` plus
    the finalize buckets: the activation combines of
    ``models/tensor_parallel.py`` stay within their budget (2 a layer ×
    forward and backward), no other op is called, and at least one
    combine runs (a TP model whose combines vanished computes garbage
    silently).  The reference reads the HLO of one rank step.
    ``tp_degree <= 1`` skips: there is nothing to combine."""
    if tp_degree <= 1:
        return result("tp-collective-budget", [],
                      skip="tp_degree=1: no tensor-parallel combines")
    wire, scalar, counts, findings = _budget(
        calls, contract, scalar_bytes_ok, scalar_count_ok, "tp budget")
    if contract and not wire:
        findings.insert(0, "no wire collective called for a non-empty tp "
                           f"contract {contract}")
    findings.extend(_peer_findings(calls, peers))
    return result("tp-collective-budget", findings,
                  {"counts": dict(counts), "scalar": len(scalar),
                   "tp_degree": int(tp_degree),
                   "contract": {k: int(v) for k, v in contract.items()},
                   "ranks": 1 + len(peers)})


# ---------------------------------------------------------------------------
# promotion-proof: no f32 payload on the wire when wire_dtype is narrow
# ---------------------------------------------------------------------------
def promotion_proof(calls, narrow_wire: bool,
                    scalar_bytes_ok: int = SCALAR_BYTES_OK) -> RuleResult:
    """Under a narrow (bf16) wire no logged call above the scalar
    allowance may carry an f32 or f64 payload: the ``Fabric`` ships the
    bf16 chunks themselves and their 16-bit image (``core/fabric.py``),
    and a bucket that reaches the backend in f32 doubles the wire.  The
    log's dtype is the payload's before ``ShardComm``'s uint8 view.  The
    reference reads the HLO's collective payload types."""
    if not narrow_wire:
        return result("promotion-proof", [],
                      skip="f32 wire: nothing to promote")
    wire, _ = _split_wire_scalar(calls, scalar_bytes_ok)
    findings = [
        f"{c['op']}: f32 payload ({c['bytes']} B) on a narrow wire"
        for c in wire if c["dtype"] in NARROW_FORBIDDEN]
    return result("promotion-proof", findings,
                  {"wire_instrs": len(wire)})


# ---------------------------------------------------------------------------
# donation-aliasing: the step reuses or frees the input train state
# ---------------------------------------------------------------------------
def donation_aliasing(alias_bytes: int, donated_bytes: int,
                      min_frac: float = 0.5) -> RuleResult:
    """``alias_bytes``: the bytes of the input train state that, once the
    caller drops it after ``step(state, batch)``, either share storage
    with the output state or are freed (``rigs.loop_artifacts``); it must
    cover at least ``min_frac`` of the input state's bytes.  A step that
    keeps its input alive doubles the state's memory without any error.
    The reference reads ``alias_size_in_bytes`` of the compiled step."""
    findings: List[str] = []
    frac = alias_bytes / max(1, donated_bytes)
    if alias_bytes <= 0:
        findings.append("no input state storage reused or freed by the "
                        "step (donation had no effect)")
    elif frac < min_frac:
        findings.append(
            f"aliased {alias_bytes} of {donated_bytes} donated bytes "
            f"({frac:.1%} < {min_frac:.0%})")
    return result("donation-aliasing", findings,
                  {"alias_bytes": int(alias_bytes),
                   "donated_bytes": int(donated_bytes),
                   "frac": round(frac, 4)})


# ---------------------------------------------------------------------------
# cond-gating: a gated exchange calls nothing off its schedule
# ---------------------------------------------------------------------------
def _fires(n: int, period: int) -> List[bool]:
    """The port's schedule: step t fires where (t + 1) % period == 0."""
    return [(t + 1) % period == 0 for t in range(n)]


def _gated_findings(logs, fires, period, what, noun):
    findings: List[str] = []
    on = 0
    for t, (calls, fire) in enumerate(zip(logs, fires)):
        if fire:
            on += len(calls)
        else:
            findings.extend(
                f"collective {c['op']!r} at t={t}, off the {what}={period} "
                "schedule" for c in calls)
    if not on:
        findings.append(f"no collective found at a firing step — the gated "
                        f"{noun} never ran")
    return findings, on


def cond_gating(logs, gated: bool, sync_every: Optional[int] = None
                ) -> RuleResult:
    """A ``gated=True`` strategy's ``update`` run at each step ``t`` of
    one period (``logs[t]``: its call log at t, t in ``range(sync_every)``)
    calls nothing where its schedule does not fire ((t + 1) % sync_every
    != 0) and at least once where it does: a where-style gate would ship
    the bytes every step and discard them, multiplying the wire by
    ``sync_every``.  The port decides the gate on the host
    (``core/strategies.py``); the reference proves its ``lax.cond`` in
    the jaxpr."""
    if not gated:
        return result("cond-gating", [],
                      skip="strategy communicates unconditionally")
    period = sync_every or len(logs)
    findings, on = _gated_findings(logs, _fires(len(logs), period), period,
                                   "sync_every", "exchange")
    return result("cond-gating", findings,
                  {"collectives": sum(len(c) for c in logs),
                   "under_cond": on})


def elastic_demotion_gated(logs, resync_every: int) -> RuleResult:
    """The straggler-demotion resync (``launch/elastic.py::demoted_resync``)
    over a ``ShardComm`` at each boundary ``t`` in ``range(resync_every)``
    (``logs[t]``) calls nothing but where (t + 1) % resync_every == 0, and
    at least once there.  Demotion exists to REDUCE a straggler's wire
    cost: a resync that shipped every boundary would restore the full
    sync traffic for the whole fleet.  Runs on ``rigs.elastic_artifacts``,
    not the per-cell sweep matrix."""
    findings, on = _gated_findings(logs, _fires(len(logs), resync_every),
                                   resync_every, "resync_every", "resync")
    return result("elastic-demotion-gated", findings,
                  {"collectives": sum(len(c) for c in logs),
                   "under_cond": on})


def gating_ratio(bytes_ungated: float, bytes_gated: float,
                 sync_every: int, slack: float = 0.75) -> RuleResult:
    """Wire-byte side of the gating contract: summed over sync_every
    consecutive steps, a gated schedule must ship ≤ 1/(slack·sync_every)
    of the every-step bytes (slack absorbs per-sync constant traffic)."""
    findings: List[str] = []
    if bytes_ungated <= 0:
        findings.append("ungated baseline shipped zero bytes")
    else:
        ratio = bytes_ungated / max(1.0, bytes_gated)
        if ratio < slack * sync_every:
            findings.append(
                f"gated bytes only {ratio:.2f}x below every-step bytes "
                f"(expected ≥ {slack * sync_every:.2f}x for "
                f"sync_every={sync_every})")
    return result("cond-gating", findings,
                  {"bytes_ungated": float(bytes_ungated),
                   "bytes_gated": float(bytes_gated),
                   "sync_every": sync_every})


# ---------------------------------------------------------------------------
# fused-dispatch: compressed exchanges go through the fused encode
# ---------------------------------------------------------------------------
def fused_dispatch(fused_calls: int, codec_calls: int, n_buckets: int,
                   launches: Optional[int] = None,
                   expect_fused: bool = True) -> RuleResult:
    """On a ``Fabric(fused=True)`` compressed exchange the compressor's
    fused encode is entered once a bucket and the codec's unfused round
    (``compressor.compress``) never; on CUDA tensors the kernel behind
    the fused encode (``topk_encode_ef``'s launch counter, ``launches``)
    rose by exactly one a bucket.  The reference finds ``pallas_call``
    in the jaxpr and counts jnp codec entries while tracing."""
    if not expect_fused:
        return result("fused-dispatch", [], skip="fused dispatch disabled")
    findings: List[str] = []
    if not fused_calls:
        findings.append("no fused encode in the exchange (fused kernel "
                        "not dispatched)")
    elif fused_calls != n_buckets:
        findings.append(f"fused encode entered {fused_calls} time(s) for "
                        f"{n_buckets} bucket(s)")
    if codec_calls:
        findings.append(f"codec round invoked {codec_calls} time(s) on the "
                        "fused path")
    if launches is not None and launches != n_buckets:
        findings.append(f"topk_encode_ef launched {launches} time(s) for "
                        f"{n_buckets} bucket(s)")
    return result("fused-dispatch", findings,
                  {"codec_calls": codec_calls, "fused_calls": fused_calls,
                   "n_buckets": n_buckets, "launches": launches})


# ---------------------------------------------------------------------------
# retrace-detector: nothing built or loaded after step 0
# ---------------------------------------------------------------------------
def retrace(cache_sizes: List[int]) -> RuleResult:
    """``cache_sizes[i]``: the count of kernel libraries built or loaded
    (``kernels/_build.py::libraries_built``) after call i of a steady
    run.  It must not grow after the first step: every growth is an
    ``nvcc`` run or a library load inside the training loop.  The count
    is the process's (0 until a CUDA kernel first runs; constant on CPU
    tensors), so the reference's check that the first value is 1 (a jit
    cache of one program) has no counterpart."""
    findings: List[str] = []
    if not cache_sizes:
        findings.append("no steps recorded")
    else:
        for i, n in enumerate(cache_sizes[1:], start=1):
            if n != cache_sizes[0]:
                findings.append(f"retrace at step {i}: cache grew "
                                f"{cache_sizes[0]} → {n}")
                break
    return result("retrace-detector", findings,
                  {"cache_sizes": list(cache_sizes)})


# ---------------------------------------------------------------------------
# state-aliasing: strategy.update must not mutate its comm_state argument
# ---------------------------------------------------------------------------
def tree_snapshot(tree):
    """Structural identity snapshot of a tree: container ids + keys +
    leaf object ids.  Taken before/after a call, a diff proves in-place
    mutation of the argument (``update`` writing into the caller's dict
    corrupts saved state that resume and re-step paths rely on)."""
    if isinstance(tree, dict):
        return ("dict", id(tree),
                tuple(sorted((k, tree_snapshot(v)) for k, v in tree.items())))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, id(tree),
                tuple(tree_snapshot(v) for v in tree))
    return ("leaf", id(tree))


def _diff(before, after, path: str, out: List[str]):
    if before[0] != after[0]:
        out.append(f"{path or '<root>'}: container type changed "
                   f"{before[0]} → {after[0]}")
        return
    if before[0] == "leaf":
        if before[1] != after[1]:
            out.append(f"{path or '<root>'}: leaf object replaced in place")
        return
    if before[1] != after[1]:
        out.append(f"{path or '<root>'}: container object replaced")
        return
    if before[0] == "dict":
        bk = {k: v for k, v in before[2]}
        ak = {k: v for k, v in after[2]}
        for k in sorted(set(bk) | set(ak)):
            if k not in ak:
                out.append(f"{path}[{k!r}]: key deleted from the argument")
            elif k not in bk:
                out.append(f"{path}[{k!r}]: key inserted into the argument")
            else:
                _diff(bk[k], ak[k], f"{path}[{k!r}]", out)
    else:
        for i, (b, a) in enumerate(zip(before[2], after[2])):
            _diff(b, a, f"{path}[{i}]", out)


def state_aliasing(snap_before, snap_after) -> RuleResult:
    findings: List[str] = []
    _diff(snap_before, snap_after, "comm_state", findings)
    return result("state-aliasing", findings)
