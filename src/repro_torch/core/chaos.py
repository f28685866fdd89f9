"""Seeded, schedulable fault injection for elastic fleet training.

Copy of ``repro/core/chaos.py`` (numpy only), so that the port imports
nothing of the JAX package; ``tests/test_torch_elastic.py`` holds it
against the reference (the same ``np.random.default_rng`` draws give the
same schedules and clock times).  Tests and ``chip_smoke.py`` drive
``launch/elastic.py::ElasticFleet`` with a deterministic event schedule
and assert on membership epochs, retry logs and loss trajectories.

Event schema (``ChaosEvent``): ``t`` is the optimizer-boundary index the
event fires at, ``worker`` a *global* worker id (stable across resizes:
ranks are reassigned per ``FleetView`` epoch, ids never are), ``kind``:

  * ``kill``     — the worker dies mid-collective: the boundary exchange
                   raises :class:`ExchangeFailure`, retries exhaust, and
                   the controller drops the worker from the next epoch.
  * ``preempt``  — an ANNOUNCED departure (spot reclaim warning): the
                   controller resizes down gracefully before the
                   exchange, no failed collective.
  * ``flake``    — a transient exchange failure (network blip): fails
                   the first attempt, succeeds on retry; membership is
                   unchanged.
  * ``slowdown`` — the worker's boundary wall-time is multiplied by
                   ``factor`` until restored (feeds the straggler
                   detector, ``core/staleness.py``).
  * ``restore``  — clears a ``slowdown``.
  * ``rejoin``   — the worker (re)joins the fleet at this boundary.

Everything is seeded (``ChaosSchedule.from_seed``, ``FleetClock``), so a
chaos run is exactly replayable.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

KINDS = ("kill", "preempt", "flake", "slowdown", "restore", "rejoin")


class ExchangeFailure(RuntimeError):
    """A boundary collective failed for ``workers``.

    ``transient=True`` marks a blip expected to clear on retry; a
    non-transient failure means the workers are gone and the fleet must
    degrade to the survivors."""

    def __init__(self, msg: str, workers=(), transient: bool = False):
        super().__init__(msg)
        self.workers = frozenset(workers)
        self.transient = transient


@dataclass(frozen=True, order=True)
class ChaosEvent:
    t: int
    kind: str
    worker: int
    factor: float = 1.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown chaos kind {self.kind!r} "
                             f"(expected one of {KINDS})")

    def spec(self) -> dict:
        return {"t": self.t, "kind": self.kind, "worker": self.worker,
                "factor": self.factor}


@dataclass(frozen=True)
class ChaosSchedule:
    """An immutable, time-sorted event list."""

    events: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(sorted(self.events)))

    def at(self, t: int) -> list:
        return [e for e in self.events if e.t == t]

    def horizon(self) -> int:
        return max((e.t for e in self.events), default=0)

    def spec(self) -> list:
        return [e.spec() for e in self.events]

    @staticmethod
    def from_seed(seed: int, horizon: int, n_workers: int, *,
                  p_kill: float = 0.01, p_flake: float = 0.02,
                  p_slowdown: float = 0.02, slow_factor: float = 3.0,
                  rejoin_after: int = 4) -> "ChaosSchedule":
        """Deterministic random schedule: same seed ⇒ same events.

        At most one kill total (keeps small test fleets alive); each
        killed worker rejoins ``rejoin_after`` boundaries later; slowdowns
        are paired with a restore."""
        rng = np.random.default_rng(seed)
        events = []
        killed = False
        for t in range(1, horizon):
            for w in range(n_workers):
                r = rng.random()
                if not killed and r < p_kill:
                    events.append(ChaosEvent(t, "kill", w))
                    if t + rejoin_after < horizon:
                        events.append(ChaosEvent(t + rejoin_after, "rejoin", w))
                    killed = True
                elif r < p_kill + p_flake:
                    events.append(ChaosEvent(t, "flake", w))
                elif r < p_kill + p_flake + p_slowdown:
                    dur = int(rng.integers(2, 6))
                    events.append(ChaosEvent(t, "slowdown", w, slow_factor))
                    if t + dur < horizon:
                        events.append(ChaosEvent(t + dur, "restore", w))
        return ChaosSchedule(tuple(events))


@dataclass
class FleetClock:
    """Simulated per-worker boundary wall-times (seconds).

    ``boundary_times`` returns one time per fleet member: a common base,
    the worker's current slowdown factor, and seeded jitter.  Feeds the
    straggler detector so demotion tests don't depend on real wall time."""

    n_workers: int
    base_s: float = 1.0
    jitter: float = 0.05
    seed: int = 0
    factor: np.ndarray = field(default=None, repr=False)

    def __post_init__(self):
        self.factor = np.ones(self.n_workers)
        self._rng = np.random.default_rng(self.seed)

    def apply(self, events) -> None:
        for e in events:
            if e.kind == "slowdown":
                self.factor[e.worker] = e.factor
            elif e.kind == "restore":
                self.factor[e.worker] = 1.0

    def boundary_times(self, members) -> dict:
        jit = 1.0 + self.jitter * self._rng.random(len(members))
        return {w: float(self.base_s * self.factor[w] * jit[i])
                for i, w in enumerate(members)}
