"""Staleness accounting and the implicit-momentum connection.

Copy of ``repro/core/staleness.py`` (numpy only), so that the port
imports nothing of the JAX package; ``tests/test_torch_consistency.py``
holds it against the reference.

The paper (§3) leans on Mitliagkas et al., "Asynchrony begets Momentum":
with W asynchronous workers, the expected update direction behaves like
momentum SGD with  β ≈ 1 − 1/W  (geometric staleness distribution).  The
paper flags "no clear understanding of what happens in case of incomplete
communication" — we provide the measurement tooling:

  * ``implicit_momentum(W)`` — the Mitliagkas prediction.
  * ``effective_momentum_fit`` — fit β̂ from an observed weight trajectory
    by regressing update_t against update_{t-1} (used by
    benchmarks/bench_staleness.py to compare sync/ssp/downpour/gossip
    against the prediction, and by tests).
  * ``staleness_histogram`` — delivery-delay distribution of a strategy's
    schedule, the quantity a centralized parameter server would measure
    "for free" and a decentralized system must reconstruct (paper §3).
  * ``StragglerDetector`` — per-worker boundary-time EWMAs vs the fleet
    median, with hysteresis (DESIGN.md §13): persistent stragglers are
    demoted from sync to local-step participation and re-promoted on
    recovery.  Host-side numpy only; the launch layer flips a traced
    mask, so demotion never retraces the step.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def implicit_momentum(n_workers: int) -> float:
    """Mitliagkas et al. prediction: β = 1 − 1/W."""
    return 1.0 - 1.0 / max(1, n_workers)


def effective_momentum_fit(weight_traj: np.ndarray) -> float:
    """Least-squares fit of u_t ≈ β u_{t-1} over a weight trajectory
    (T, dim) — returns β̂."""
    w = np.asarray(weight_traj, np.float64)
    u = np.diff(w, axis=0)  # (T-1, dim)
    if len(u) < 3:
        return 0.0
    num = float(np.sum(u[1:] * u[:-1]))
    den = float(np.sum(u[:-1] * u[:-1])) + 1e-30
    return num / den


@dataclass(frozen=True)
class StragglerPolicy:
    """Hysteresis thresholds for straggler demotion/re-promotion.

    A worker whose boundary-time EWMA exceeds ``demote_ratio`` × the
    fleet median for ``patience`` consecutive boundaries is demoted to
    the local-step tier; a demoted worker back under ``promote_ratio`` ×
    median for ``recovery`` consecutive boundaries is re-promoted.  The
    gap between the two ratios prevents flapping at the threshold."""

    alpha: float = 0.4
    demote_ratio: float = 1.75
    promote_ratio: float = 1.25
    patience: int = 2
    recovery: int = 3


class StragglerDetector:
    """Per-worker boundary-time EWMAs against the fleet median.

    ``observe`` once per optimizer boundary with the measured (or
    simulated — ``core/chaos.py::FleetClock``) per-worker times; then
    ``to_demote()``/``to_promote()`` list the workers whose hysteresis
    counters crossed the policy thresholds, and the caller commits the
    transitions with ``demote``/``promote`` (membership changes with
    ``add``/``drop``).  Pure host-side numpy — no traced state."""

    def __init__(self, workers, policy: StragglerPolicy | None = None):
        self.policy = policy or StragglerPolicy()
        self.ewma = {w: None for w in workers}
        self.slow = {w: 0 for w in workers}
        self.fast = {w: 0 for w in workers}
        self.demoted = set()

    def add(self, worker) -> None:
        self.ewma.setdefault(worker, None)
        self.slow.setdefault(worker, 0)
        self.fast.setdefault(worker, 0)

    def drop(self, worker) -> None:
        for d in (self.ewma, self.slow, self.fast):
            d.pop(worker, None)
        self.demoted.discard(worker)

    def observe(self, times: dict) -> float:
        """Fold one boundary's per-worker times in; returns the median EWMA."""
        p = self.policy
        for w, t in times.items():
            self.add(w)
            prev = self.ewma[w]
            self.ewma[w] = t if prev is None else p.alpha * t + (1 - p.alpha) * prev
        known = [v for v in self.ewma.values() if v is not None]
        med = float(np.median(known)) if known else 0.0
        for w in times:
            e = self.ewma[w]
            if w not in self.demoted:
                self.slow[w] = self.slow[w] + 1 if e > p.demote_ratio * med else 0
            else:
                self.fast[w] = self.fast[w] + 1 if e < p.promote_ratio * med else 0
        return med

    def to_demote(self) -> list:
        return sorted(w for w, c in self.slow.items()
                      if w not in self.demoted and c >= self.policy.patience)

    def to_promote(self) -> list:
        return sorted(w for w, c in self.fast.items()
                      if w in self.demoted and c >= self.policy.recovery)

    def demote(self, worker) -> None:
        self.demoted.add(worker)
        self.slow[worker] = 0
        self.fast[worker] = 0

    def promote(self, worker) -> None:
        self.demoted.discard(worker)
        self.slow[worker] = 0
        self.fast[worker] = 0


def staleness_histogram(schedule, n_workers: int, horizon: int):
    """schedule: callable (src, dst, t) -> delivery delay (int or None).
    Returns (delays list, drop_fraction)."""
    delays, drops, total = [], 0, 0
    for t in range(horizon):
        for src in range(n_workers):
            for dst in range(n_workers):
                if src == dst:
                    continue
                total += 1
                d = schedule(src, dst, t)
                if d is None:
                    drops += 1
                else:
                    delays.append(d)
    return np.asarray(delays), drops / max(1, total)
