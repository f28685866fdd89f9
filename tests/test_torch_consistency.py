"""The port's copies of ``core/consistency.py`` and ``core/staleness.py``
against the reference's, on the same seeded schedules.

The cases of ``tests/test_consistency_property.py`` (hypothesis-drawn
delivery schedules, few examples) and of
``tests/test_staleness_consistency.py``: both modules are numpy only, so
the port's copy and the reference's run the same float64 operations in
the same order, and their weights, queues and counters are compared
exactly.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import consistency as JC
from repro.core import staleness as JS
from repro_torch.core import consistency as TC
from repro_torch.core import staleness as TS

pytestmark = pytest.mark.torch

DIM = 5


def _grad(rng):
    return rng.normal(size=(DIM,))


def _assert_same(sim_t, sim_j):
    np.testing.assert_array_equal(sim_t.weights(), sim_j.weights())
    assert sim_t.dropped == sim_j.dropped and sim_t.round == sim_j.round
    assert sim_t.max_divergence() == sim_j.max_divergence()
    assert sim_t.consistent() == sim_j.consistent()
    assert {k: len(q) for k, q in sim_t.queues.items()} \
        == {k: len(q) for k, q in sim_j.queues.items()}


@st.composite
def delivery_schedules(draw, max_workers=4, max_rounds=5):
    n = draw(st.integers(2, max_workers))
    rounds = draw(st.integers(1, max_rounds))
    # delays[t][src][dst] in [0, 10], None a drop
    delays = draw(st.lists(
        st.lists(st.lists(st.one_of(st.integers(0, 10), st.none()),
                          min_size=n, max_size=n),
                 min_size=n, max_size=n),
        min_size=rounds, max_size=rounds))
    return n, rounds, delays


@given(delivery_schedules(), st.integers(0, 2**31 - 1),
       st.sampled_from([0.0, 0.9]))
@settings(max_examples=15, deadline=None)
def test_consistency_sim_matches_reference(sched, seed, beta):
    """Statement 1's simulator, round by round and after the drain: the
    same weights, queues and drop counts as the reference's; with complete
    delivery and no momentum the replicas end consistent."""
    n, rounds, delays = sched
    sims = [M.ConsistencySim(n, DIM, lr=0.1, momentum=beta, seed=seed)
            for M in (TC, JC)]
    rng = np.random.default_rng(seed)
    seq = 0
    for t in range(rounds):
        for src in range(n):
            g = _grad(rng)
            d = {dst: delays[t][src][dst] for dst in range(n) if dst != src}
            for sim in sims:
                sim.produce(src, g, seq, delays=d)
            seq += 1
        for sim in sims:
            sim.step()
        _assert_same(*sims)
    for sim in sims:
        sim.drain()
    _assert_same(*sims)
    if beta == 0.0 and sims[0].dropped == 0:
        assert sims[0].consistent(atol=1e-9)


def test_replica_mechanics_match_reference():
    for M in (TC, JC):
        r = M.Replica(np.zeros(4), lr=1.0, momentum=0.5)
        r.apply(M.Update(0, 0, np.ones(4)))
        r.apply(M.Update(0, 1, np.ones(4)))
        np.testing.assert_allclose(r.w, np.full(4, -2.5))
        with pytest.raises(AssertionError, match="duplicate delivery"):
            r.apply(M.Update(0, 1, np.ones(4)))


def test_consistent_but_not_sequential_matches_reference():
    rng = np.random.default_rng(0)
    grads = [[_grad(rng) for _ in range(3)] for _ in range(2)]
    sims = [M.ConsistencySim(2, DIM, lr=0.1, seed=1) for M in (TC, JC)]
    for t in range(3):
        for w in range(2):
            for sim in sims:
                sim.produce(w, grads[w][t], t, delays={1 - w: 5})
        for sim in sims:
            sim.step()
    for sim in sims:
        sim.drain()
    _assert_same(*sims)
    assert sims[0].consistent()


def test_staleness_functions_match_reference():
    for w in (0, 1, 2, 7, 1000):
        assert TS.implicit_momentum(w) == JS.implicit_momentum(w)
    rng = np.random.default_rng(2)
    for t in (1, 2, 3, 40):
        traj = np.cumsum(rng.normal(size=(t, 4)), axis=0)
        assert TS.effective_momentum_fit(traj) \
            == JS.effective_momentum_fit(traj)

    def schedule(src, dst, t):
        return None if (src + dst + t) % 5 == 0 else (src * 3 + t) % 4

    for w, h in ((3, 4), (4, 0), (5, 7)):
        dt, ft = TS.staleness_histogram(schedule, w, h)
        dj, fj = JS.staleness_histogram(schedule, w, h)
        np.testing.assert_array_equal(dt, dj)
        assert ft == fj


@given(st.lists(st.lists(st.floats(0.1, 10.0), min_size=4, max_size=4),
                min_size=1, max_size=12))
@settings(max_examples=15, deadline=None)
def test_straggler_detector_matches_reference(times):
    """The same boundary times give the same EWMAs, medians and
    demote/promote decisions."""
    dets = [M.StragglerDetector(range(4)) for M in (TS, JS)]
    for row in times:
        meds = [d.observe(dict(enumerate(row))) for d in dets]
        assert meds[0] == meds[1]
        assert dets[0].ewma == dets[1].ewma
        for how in ("to_demote", "to_promote"):
            picks = [getattr(d, how)() for d in dets]
            assert picks[0] == picks[1]
            for d in dets:
                for w in picks[0]:
                    getattr(d, how[3:])(w)
        assert dets[0].demoted == dets[1].demoted
