"""Statement 1 machinery (paper §3, Figure 3).

Copy of ``repro/core/consistency.py`` (numpy only), so that the port
imports nothing of the JAX package; ``tests/test_torch_consistency.py``
holds it against the reference on the same seeded schedules.

    "Assuming mini-batch SGD without momentum in a distributed setting, if
     all the gradient updates (communications) are delivered to all the
     workers, regardless of the delay, all the model replicas will be
     consistent [once the queues are emptied]."

This module is the executable form of Figure 3: workers produce updates,
a *delivery schedule* decides when (or whether) each update reaches each
peer, pending updates sit in queues, and ``drain`` empties them.  The
property tests drive it with
hypothesis-generated schedules to validate both the statement and its
boundary conditions:

  * complete delivery, any order/delay  → replicas consistent   (Statement 1)
  * dropped updates (partial comm.)     → replicas diverge      (¬Statement 1)
  * momentum                            → consistency breaks    (the paper's
    "without momentum" qualifier is load-bearing: momentum makes the update
    a non-commutative function of arrival order)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class Update:
    src: int
    seq: int  # per-source sequence number
    grad: np.ndarray


class Replica:
    """One model replica applying (possibly stale) updates via plain SGD or
    momentum SGD — momentum exists to demonstrate the counterexample."""

    def __init__(self, w0: np.ndarray, lr: float, momentum: float = 0.0):
        self.w = w0.astype(np.float64).copy()
        self.lr = lr
        self.beta = momentum
        self.m = np.zeros_like(self.w)
        self.applied: set = set()

    def apply(self, upd: Update):
        key = (upd.src, upd.seq)
        assert key not in self.applied, f"duplicate delivery {key}"
        self.applied.add(key)
        if self.beta:
            self.m = self.beta * self.m + upd.grad
            self.w -= self.lr * self.m
        else:
            self.w -= self.lr * upd.grad


class ConsistencySim:
    """W replicas + per-(src,dst) delivery queues.

    ``schedule[(src, dst)]`` maps a produced update index to the round at
    which it is delivered (np.inf ⇒ never — partial communication).
    Updates produced locally are applied immediately at the source.
    """

    def __init__(self, n_workers: int, dim: int, lr: float = 0.1,
                 momentum: float = 0.0, seed: int = 0):
        rng = np.random.default_rng(seed)
        w0 = rng.normal(size=(dim,))
        self.replicas = [Replica(w0, lr, momentum) for _ in range(n_workers)]
        self.n = n_workers
        self.queues: dict = {}  # (src, dst) -> list[(deliver_round, Update)]
        self.round = 0
        self.rng = rng
        self.dropped = 0

    def produce(self, src: int, grad: np.ndarray, seq: int,
                delays: Optional[dict] = None):
        """Worker ``src`` computes ``grad``: applies locally, enqueues for
        every peer with per-destination delay (None/inf ⇒ drop)."""
        upd = Update(src, seq, np.asarray(grad, np.float64))
        self.replicas[src].apply(upd)
        for dst in range(self.n):
            if dst == src:
                continue
            delay = (delays or {}).get(dst, 0)
            if delay is None or delay == np.inf:
                self.dropped += 1
                continue
            self.queues.setdefault((src, dst), []).append(
                (self.round + delay, upd))

    def deliver_due(self):
        for (src, dst), q in self.queues.items():
            due = [u for (r, u) in q if r <= self.round]
            self.queues[(src, dst)] = [(r, u) for (r, u) in q if r > self.round]
            for u in due:
                self.replicas[dst].apply(u)

    def step(self):
        self.round += 1
        self.deliver_due()

    def drain(self):
        """The Figure-3 'event that triggers application of all pending
        updates' (e.g. a global synchronization)."""
        for (src, dst), q in self.queues.items():
            for (_, u) in q:
                self.replicas[dst].apply(u)
            self.queues[(src, dst)] = []

    def weights(self) -> np.ndarray:
        return np.stack([r.w for r in self.replicas])

    def max_divergence(self) -> float:
        w = self.weights()
        return float(np.max(np.abs(w - w[0:1])))

    def consistent(self, atol: float = 1e-9) -> bool:
        return self.max_divergence() <= atol
