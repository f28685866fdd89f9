"""The port's elastic fleet against the JAX package on the CPU.

``FleetView``, the chaos harness (``core/chaos.py``, a numpy copy), the
tensor path of ``core/resharding.py``, ``resize_state``, the masked
boundary step and ``ElasticFleet`` are held against the reference on the
same numpy inputs (the reference's tiny problem, ``tests/test_elastic.py``,
buckets of 160 bytes).  Bitwise where the reference claims it: the
in-memory resize against the port's own checkpoint round trip and
against the JAX ``resize_state``, the all-ones masked step against the
port's ``sync`` step; f32 tolerances elsewhere (masked sums 1e-6, steps
and fleets 1e-5).  ``sample_batch`` is keyed by (seed, worker, step),
and ``edge_async_sim``'s fleet ends in the reference's membership.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import chaos as JC
from repro.core import resharding as JRS
from repro.core import strategies as JST
from repro.core.comm import LocalComm as JLocalComm
from repro.core.fabric import Fabric as JFabric
from repro.core.precision import get_policy as jget_policy
from repro.core.staleness import StragglerPolicy as JStragglerPolicy
from repro.launch import elastic as JE
from repro.optim import adam as jadam
from repro.optim import sgd as jsgd
from repro.train import loop as JLOOP
from repro_torch import checkpoint as CK
from repro_torch.bridge import train_state_to_numpy
from repro_torch.core import chaos as C
from repro_torch.core import resharding as RS
from repro_torch.core import strategies as ST
from repro_torch.core import tree as TT
from repro_torch.core.comm import LocalComm
from repro_torch.core.fabric import Fabric
from repro_torch.core.precision import get_policy
from repro_torch.core.staleness import StragglerPolicy
from repro_torch.data.pipeline import (DataConfig, sample_batch,
                                       worker_batches)
from repro_torch.launch import elastic as E
from repro_torch.optim import adam, sgd
from repro_torch.train import loop as TLOOP

pytestmark = pytest.mark.torch

BB = 4 * 40  # small buckets: several unevenly padded buckets a tree


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the reference's tiny problem, fed to both packages
# ---------------------------------------------------------------------------
def tiny_np(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((7, 9)).astype(np.float32),
            "b": np.zeros((9,), np.float32),
            "v": rng.standard_normal((13,)).astype(np.float32)}


def tiny_params(seed=0):
    return TT.tree_map(torch.from_numpy, tiny_np(seed))


def jtiny_params(seed=0):
    return jax.tree.map(jnp.asarray, tiny_np(seed))


def tiny_loss(p, batch):
    x, y = batch
    h = torch.tanh(x.to(p["w"].dtype) @ p["w"] + p["b"])
    return torch.mean(((h @ p["v"][:9]).float() - y) ** 2)


def jtiny_loss(p, batch):
    x, y = batch
    h = jnp.tanh(x.astype(p["w"].dtype) @ p["w"] + p["b"])
    return jnp.mean(((h @ p["v"][:9]).astype(jnp.float32) - y) ** 2)


def np_batches(w, t, seed=0):
    rng = np.random.default_rng(seed * 1000 + t)
    return (rng.standard_normal((w, 4, 7)).astype(np.float32),
            rng.standard_normal((w, 4)).astype(np.float32))


def tiny_batches(w, t):
    return tuple(torch.from_numpy(a) for a in np_batches(w, t))


def jtiny_batches(w, t):
    return tuple(jnp.asarray(a) for a in np_batches(w, t))


def np_fleet_batch(view, t):
    # keyed by stable worker id, so a resize regenerates the right rows
    rng = np.random.default_rng(t)
    x = rng.standard_normal((8, 4, 7)).astype(np.float32)
    y = rng.standard_normal((8, 4)).astype(np.float32)
    idx = np.array(view.members)
    return x[idx], y[idx]


def batch_fn(view, t):
    return tuple(torch.from_numpy(a) for a in np_fleet_batch(view, t))


def jbatch_fn(view, t):
    return tuple(jnp.asarray(a) for a in np_fleet_batch(view, t))


def _np(x):
    """A tensor on the host as numpy, bf16 widened to f32 (exact)."""
    return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()


def assert_bitwise(a, b):
    la, lb = TT.leaves(a), TT.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def assert_np_bitwise(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x.reshape(-1).view(np.uint8),
                                      y.reshape(-1).view(np.uint8))


def _views(direction):
    """(old, new) views: shrink drops members 1 and 3, grow adds 5 and 7
    to a fleet with a demoted member (the joiners copy a sync row)."""
    if direction == "shrink":
        return E.FleetView(0, (0, 1, 2, 3)), E.FleetView(1, (0, 2))
    return E.FleetView(0, (0, 1), (0,)), E.FleetView(1, (0, 1, 5, 7), (0,))


def _jview(v):
    return JE.FleetView(v.epoch, v.members, v.demoted)


# ---------------------------------------------------------------------------
# FleetView
# ---------------------------------------------------------------------------
def test_fleet_view_matches_reference():
    ops = [("without", (2,)), ("with_joined", (5,)),
           ("with_demoted", ((1, 7),)), ("without", (1,)),
           ("with_joined", (1, 9)), ("with_demoted", ((),))]
    v, jv = E.FleetView(0, (3, 1, 7, 1, 0)), JE.FleetView(0, (3, 1, 7, 1, 0))
    for name, arg in ops:
        assert (v.epoch, v.members, v.demoted, v.size) \
            == (jv.epoch, jv.members, jv.demoted, jv.size)
        assert [v.rank_of(w) for w in v.members] \
            == [jv.rank_of(w) for w in jv.members]
        np.testing.assert_array_equal(v.mask(), jv.mask())
        assert v.mask().dtype == jv.mask().dtype == np.float32
        v, jv = getattr(v, name)(*arg), getattr(jv, name)(*arg)
    assert (v.epoch, v.members, v.demoted) == (jv.epoch, jv.members,
                                               jv.demoted)


def test_resize_with_no_survivor_raises():
    with pytest.raises(ValueError, match="no surviving member"):
        E.resize_dense_tree({"x": torch.zeros((2, 3))},
                            E.FleetView(0, (0, 1)), E.FleetView(1, (5, 6)))


# ---------------------------------------------------------------------------
# the chaos harness
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [7, 8])
def test_chaos_schedule_from_seed_matches_reference(seed):
    for kw in ({}, {"p_kill": 0.05, "p_flake": 0.1, "p_slowdown": 0.1,
                    "rejoin_after": 2}):
        ours = C.ChaosSchedule.from_seed(seed, horizon=50, n_workers=4, **kw)
        ref = JC.ChaosSchedule.from_seed(seed, horizon=50, n_workers=4, **kw)
        assert ours.spec() == ref.spec() and ours.spec()
        assert ours.horizon() == ref.horizon()
        for t in range(50):
            assert [e.spec() for e in ours.at(t)] \
                == [e.spec() for e in ref.at(t)]
    assert C.ChaosSchedule.from_seed(7, 50, 4).spec() \
        != C.ChaosSchedule.from_seed(8, 50, 4).spec()


def test_fleet_clock_matches_reference_under_slowdown_restore_and_jitter():
    for jitter, seed in ((0.0, 0), (0.05, 3)):
        ours, ref = C.FleetClock(4, jitter=jitter, seed=seed), \
            JC.FleetClock(4, jitter=jitter, seed=seed)
        for events, members in (
                ([(0, "slowdown", 2, 3.0)], (0, 1, 2, 3)),
                ([(1, "restore", 2), (1, "slowdown", 0, 5.0)], (0, 2, 3)),
                ([], (0, 1, 2, 3)), ([(3, "restore", 0)], (1, 0))):
            ours.apply([C.ChaosEvent(*e) for e in events])
            ref.apply([JC.ChaosEvent(*e) for e in events])
            assert ours.boundary_times(members) \
                == ref.boundary_times(members)
    clock = C.FleetClock(4, base_s=1.0, jitter=0.0, seed=0)
    clock.apply([C.ChaosEvent(0, "slowdown", 2, 3.0)])
    assert clock.boundary_times((0, 2)) == {0: 1.0, 2: 3.0}


def test_chaos_event_kinds_and_exchange_failure():
    assert C.KINDS == JC.KINDS
    with pytest.raises(ValueError, match="kind"):
        C.ChaosEvent(0, "meteor", 1)
    e = C.ExchangeFailure("x", workers=[2, 1], transient=True)
    assert e.workers == frozenset({1, 2}) and e.transient
    assert isinstance(e, RuntimeError)


# ---------------------------------------------------------------------------
# the tensor path of the re-shard
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wf,wt", [(4, 2), (2, 4), (4, 3)],
                         ids=["shrink", "grow", "shrink_to_3"])
@pytest.mark.parametrize("ndim", [1, 2])
def test_tensor_reshard_is_bitwise_the_numpy_path(ndim, wf, wt, dtype):
    true = 37
    padded = -(-true // wf) * wf
    rng = np.random.default_rng(wf * 10 + wt + ndim)
    a = np.zeros((padded,), np.float32)
    a[:true] = rng.standard_normal(true)
    if ndim == 2:
        a = a.reshape(wf, padded // wf)
    x = torch.from_numpy(a).to(dtype)
    got = RS._reshard_one(x, true, wt)
    want = RS._reshard_one(_np(x), true, wt)
    assert isinstance(got, torch.Tensor) and isinstance(want, np.ndarray)
    assert got.dtype == dtype and got.device == x.device
    assert got.shape == want.shape and got.dim() == ndim
    np.testing.assert_array_equal(_np(got), want)
    assert _np(x).tobytes() == _np(torch.from_numpy(a).to(dtype)).tobytes()
    meta = RS._reshard_one(torch.empty(x.shape, dtype=dtype, device="meta"),
                           true, wt)
    assert meta.device.type == "meta" and meta.shape == got.shape


def test_repartition_tree_walks_tensor_and_numpy_trees():
    sizes = (10, 3)
    rng = np.random.default_rng(0)
    np_tree = {"m": [rng.standard_normal((4, 3)).astype(np.float32),
                     rng.standard_normal((4, 1)).astype(np.float32)],
               "n": np.arange(5)}
    t_tree = {"m": [torch.from_numpy(x) for x in np_tree["m"]],
              "n": torch.arange(5)}
    got = RS.repartition_tree(t_tree, sizes, 2)
    want = JRS.repartition_tree(np_tree, sizes, 2)
    assert all(isinstance(x, torch.Tensor) for x in got["m"])
    for x, y in zip(got["m"], want["m"]):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert got["n"] is t_tree["n"]


# ---------------------------------------------------------------------------
# resize_state
# ---------------------------------------------------------------------------
def _zero_state(stage, opt, w, precision="f32", steps=2):
    pol = None if precision == "f32" else get_policy(precision)
    comm = LocalComm(w)
    strat = ST.get_strategy(f"sync_zero{stage}", bucket_bytes=BB, policy=pol)
    params = comm.replicate(tiny_params())
    if pol is not None:
        params = pol.cast_to_param(params)
    state = TLOOP.init_train_state(params, opt, strat, comm, policy=pol)
    step = TLOOP.make_replica_train_step(tiny_loss, opt, strat, comm,
                                         policy=pol, bucket_bytes=BB)
    for t in range(steps):  # make the optimizer state non-trivial
        state, _ = step(state, tiny_batches(w, t))
    return state, strat, comm, pol


def _shard_tree(state, owns):
    tree = {"opt_state": state["opt_state"]}
    if owns:
        tree["param_shards"] = state["params"]
    return tree


def _clone(tree):
    return TT.tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor)
                       else x, tree)


@pytest.mark.parametrize("direction", [(4, 2), (2, 4)],
                         ids=["shrink", "grow"])
@pytest.mark.parametrize("opt_name", ["sgd", "adam"])
@pytest.mark.parametrize("stage", [1, 2, 3])
def test_resize_bitwise_vs_checkpoint_roundtrip(tmp_path, stage, opt_name,
                                                direction):
    """The in-memory resize IS the port's checkpoint save →
    restore(repartition=True) round trip, bitwise, with no disk."""
    wf, wt = direction
    opt = sgd(0.05) if opt_name == "sgd" else adam(1e-2)
    state, strat, comm, _ = _zero_state(stage, opt, wf)
    owns = strat.owns_params
    # the checkpoint first: the resize re-primes ZeRO-3's layout to W'
    full = strat.gather_params(state["params"], comm) if owns \
        else state["params"]
    play = Fabric(comm, BB).partitioned_layout(full)
    CK.save_checkpoint(str(tmp_path), 0, _shard_tree(state, owns),
                       partition=play.spec())
    before = _clone(state)
    vf, vt = E.FleetView(0, tuple(range(wf))), E.FleetView(1,
                                                           tuple(range(wt)))
    live = E.resize_state(state, vf, vt, strategy=strat, bucket_bytes=BB)
    assert_bitwise(state, before)  # nothing written in place

    comm2 = LocalComm(wt)
    fresh, *_ = _zero_state(stage, opt, wt, steps=0)
    template = TT.tree_map(torch.zeros_like, _shard_tree(fresh, owns))
    restored = CK.restore_checkpoint(str(tmp_path), 0, template,
                                     repartition=True)
    assert_bitwise(live["opt_state"], restored["opt_state"])
    if owns:
        assert_bitwise(live["params"], restored["param_shards"])
        # the re-primed layout keeps gather_params working at W'
        regathered = strat.gather_params(live["params"], comm2)
        assert_bitwise(comm2.replica(regathered, 0), comm.replica(full, 0))
    else:
        assert all(x.shape[0] == wt for x in TT.leaves(live["params"]))
    assert live["step"] is state["step"]


@pytest.mark.parametrize("direction", [(4, 2), (2, 4)],
                         ids=["shrink", "grow"])
def test_resize_zero1_bf16_master_in_shards_vs_checkpoint(tmp_path,
                                                          direction):
    wf, wt = direction
    state, strat, comm, _ = _zero_state(1, adam(1e-2), wf, "bf16")
    assert "master" in state["opt_state"] and "loss_scale" in state
    play = Fabric(comm, BB).partitioned_layout(state["params"])
    CK.save_checkpoint(str(tmp_path), 0, _shard_tree(state, False),
                       partition=play.spec())
    live = E.resize_state(state, E.FleetView(0, tuple(range(wf))),
                          E.FleetView(1, tuple(range(wt))), strategy=strat,
                          bucket_bytes=BB)
    fresh, *_ = _zero_state(1, adam(1e-2), wt, "bf16", steps=0)
    restored = CK.restore_checkpoint(
        str(tmp_path), 0,
        TT.tree_map(torch.zeros_like, _shard_tree(fresh, False)),
        repartition=True)
    assert_bitwise(live["opt_state"], restored["opt_state"])
    assert live["loss_scale"] is state["loss_scale"]
    assert live["params"]["w"].dtype == torch.bfloat16


def _jax_state(np_state):
    return jax.tree.map(jnp.asarray, np_state)


def _port_and_jax_states(case, w):
    """The same numpy state in both packages, and each one's strategy."""
    opt, jopt = adam(1e-2), jadam(1e-2)
    if case.startswith("zero"):
        stage = int(case[-1])
        state, strat, comm, _ = _zero_state(stage, opt, w)
        jstrat = JST.get_strategy(f"sync_zero{stage}", bucket_bytes=BB)
    else:
        name, precision = {"sync_bf16": ("sync", "bf16"),
                           "downpour": ("downpour", "f32")}[case]
        pol = None if precision == "f32" else get_policy(precision)
        comm = LocalComm(w)
        strat = ST.get_strategy(name, bucket_bytes=BB, policy=pol)
        jstrat = JST.get_strategy(name, bucket_bytes=BB, policy=(
            None if pol is None else jget_policy(precision)))
        params = comm.replicate(tiny_params())
        if pol is not None:
            params = pol.cast_to_param(params)
        state = TLOOP.init_train_state(params, opt, strat, comm, policy=pol)
        step = TLOOP.make_replica_train_step(tiny_loss, opt, strat, comm,
                                             policy=pol, bucket_bytes=BB)
        for t in range(3):
            state, _ = step(state, tiny_batches(w, t))
    # prime the JAX strategy's recorded layout (ZeRO-3) at W
    jcomm = JLocalComm(w)
    JLOOP.init_train_state(jcomm.replicate(jtiny_params()), jopt, jstrat,
                           jcomm)
    np_state = train_state_to_numpy(state)
    return state, strat, _jax_state(np_state), jstrat


@pytest.mark.parametrize("direction", ["shrink", "grow"])
@pytest.mark.parametrize("case", ["zero1", "zero2", "zero3", "sync_bf16",
                                  "downpour"])
def test_resize_state_bitwise_vs_jax(case, direction):
    vf, vt = _views(direction)
    state, strat, jstate, jstrat = _port_and_jax_states(case, vf.size)
    got = E.resize_state(state, vf, vt, strategy=strat, bucket_bytes=BB)
    want = JE.resize_state(jstate, _jview(vf), _jview(vt), strategy=jstrat,
                           bucket_bytes=BB)
    got_np = train_state_to_numpy(got)
    assert jax.tree.structure(got_np) == jax.tree.structure(
        jax.tree.map(np.asarray, want))
    assert_np_bitwise(got_np, jax.tree.map(np.asarray, want))
    if case == "sync_bf16":
        assert set(got) >= {"master", "loss_scale"}


def test_resize_roundtrip_is_identity():
    state, strat, comm, _ = _zero_state(2, adam(1e-2), 4, steps=1)
    v4, v2 = E.FleetView(0, (0, 1, 2, 3)), E.FleetView(1, (0, 1))
    down = E.resize_state(state, v4, v2, strategy=strat, bucket_bytes=BB)
    back = E.resize_state(down, v2, E.FleetView(2, (0, 1, 2, 3)),
                          strategy=strat, bucket_bytes=BB)
    assert_bitwise(back["opt_state"], state["opt_state"])
    # dense params: survivors keep their rows, joiners copy consensus
    assert_bitwise(back["params"], state["params"])


def test_zero1_params_keep_one_storage_across_resizes():
    state, strat, comm, _ = _zero_state(1, adam(1e-2), 4)
    assert all(x.stride(0) == 0 for x in TT.leaves(state["params"]))
    v4, v2 = E.FleetView(0, (0, 1, 2, 3)), E.FleetView(1, (0, 2))
    down = E.resize_state(state, v4, v2, strategy=strat, bucket_bytes=BB)
    up = E.resize_state(down, v2, E.FleetView(2, (0, 2, 3, 4)),
                        strategy=strat, bucket_bytes=BB)
    for tree, w in ((down, 2), (up, 4)):
        for x, old in zip(TT.leaves(tree["params"]),
                          TT.leaves(state["params"])):
            assert x.shape[0] == w and x.stride(0) == 0
            assert torch.equal(x, old[0].expand(x.shape))
    # the row-gather of a materialized copy gives the same values
    dense = TT.tree_map(lambda x: x.contiguous(), state["params"])
    assert_bitwise(TT.tree_map(lambda x: x.contiguous(), up["params"]),
                   E.resize_dense_tree(E.resize_dense_tree(dense, v4, v2),
                                       v2, E.FleetView(2, (0, 2, 3, 4))))


def test_dense_resize_makes_rows_of_their_own_storage():
    opt = adam(1e-2, fused=True)
    comm = LocalComm(3)
    params = comm.replicate(tiny_params())
    state = {"params": params, "opt_state": opt.init(params),
             "comm_state": {}, "step": torch.zeros((), dtype=torch.int32)}
    before = _clone(state)
    new = E.resize_state(state, E.FleetView(0, (0, 1, 2), (1,)),
                         E.FleetView(1, (0, 1, 2, 4), (1,)))
    assert_bitwise(state, before)
    for x, old in zip(TT.leaves(new["params"]) + TT.leaves(new["opt_state"]),
                      TT.leaves(state["params"])
                      + TT.leaves(state["opt_state"])):
        assert x.is_contiguous() and x.shape[0] == 4
        assert x.untyped_storage().data_ptr() \
            != old.untyped_storage().data_ptr()
        # the joiner (rank 3) copied the first sync member's row, rank 0
        assert torch.equal(x[3], old[0]) and torch.equal(x[1], old[1])


def test_ssp_ring_fails_loudly():
    comm = LocalComm(3)
    strat = ST.get_strategy("ssp", staleness=5)
    state = TLOOP.init_train_state(comm.replicate(tiny_params()), sgd(0.05),
                                   strat, comm)
    assert isinstance(state["comm_state"]["buf"], tuple)
    with pytest.raises(ValueError, match="not elastically resizable"):
        E.resize_state(state, E.FleetView(0, (0, 1, 2)),
                       E.FleetView(1, (0, 1)), strategy=strat,
                       bucket_bytes=BB)


# ---------------------------------------------------------------------------
# the masked boundary step
# ---------------------------------------------------------------------------
MASKS = [[1.0, 0.0, 1.0, 1.0], [1.0, 1.0, 1.0, 1.0], [0.0, 1.0, 1.0, 0.0],
         [0.0, 0.0, 0.0, 0.0]]


@pytest.mark.parametrize("mask", MASKS, ids=["1011", "1111", "0110",
                                             "0000"])
def test_masked_exchange_and_resync_match_jax(mask):
    rng = np.random.default_rng(3)
    g = {"g": rng.standard_normal((4, 5)).astype(np.float32),
         "h": rng.standard_normal((4, 3, 2)).astype(np.float32)}
    tg = TT.tree_map(torch.from_numpy, g)
    fab, jfab = Fabric(LocalComm(4), BB), JFabric(JLocalComm(4), BB)
    m, jm = torch.tensor(mask), jnp.asarray(mask)
    got, met = E.masked_exchange(fab, tg, m)
    want, jmet = JE.masked_exchange(jfab, jax.tree.map(jnp.asarray, g), jm)
    assert float(met["wire_bytes"]) == float(jmet["wire_bytes"]) > 0
    assert float(met["comm_events"]) == float(jmet["comm_events"])
    for k in g:
        out, ref = got[k].numpy(), np.asarray(want[k])
        np.testing.assert_allclose(out, ref, rtol=1e-6)
        for w in range(4):
            if mask[w] == 0.0:  # the local tier keeps its own gradient
                np.testing.assert_array_equal(out[w], g[k][w])
        assert torch.equal(tg[k], torch.from_numpy(g[k]))  # untouched
    p = {"p": np.array([[1.0], [9.0], [1.0], [3.0]], np.float32)}
    tp = TT.tree_map(torch.from_numpy, p)
    for t in (2, 3):
        out, did = E.demoted_resync(fab, tp, m, t, 4)
        ref, jdid = JE.demoted_resync(jfab, jax.tree.map(jnp.asarray, p),
                                      jm, jnp.asarray(t, jnp.int32), 4)
        assert did == bool(jdid) == (t == 3)
        np.testing.assert_allclose(out["p"].numpy(), np.asarray(ref["p"]),
                                   rtol=1e-6)
        for w in range(4):
            if mask[w] == 1.0:  # sync rows keep their values
                np.testing.assert_array_equal(out["p"][w].numpy(),
                                              p["p"][w])
        if not did:
            assert out is tp


@pytest.mark.parametrize("fused", [False, True], ids=["adam", "fused_adam"])
def test_all_ones_masked_step_is_bitwise_the_ports_sync(fused):
    """Everyone in the sync tier: bitwise the port's ``sync`` step at W = 4,
    across two resyncs."""
    opt = adam(1e-2, fused=fused)
    comm = LocalComm(4)
    ref = TLOOP.init_train_state(comm.replicate(tiny_params()), opt,
                                 ST.sync(bucket_bytes=BB), comm)
    ref_step = TLOOP.make_replica_train_step(
        tiny_loss, opt, ST.sync(bucket_bytes=BB), comm, bucket_bytes=BB)
    params = comm.replicate(tiny_params())
    ela = {"params": params, "opt_state": opt.init(params), "comm_state": {},
           "step": torch.zeros((), dtype=torch.int32)}
    ela_step = E.make_elastic_replica_step(tiny_loss, opt, comm,
                                           resync_every=2, bucket_bytes=BB)
    mask = torch.ones(4)
    resyncs = 0
    for t in range(4):
        b = tiny_batches(4, t)
        ref, rm = ref_step(ref, b)
        ela, m = ela_step(ela, b, mask)
        resyncs += int(m["resync"])
        assert float(m["wire_bytes"]) == float(rm["wire_bytes"])
        assert torch.equal(m["loss"], rm["loss"])
    assert resyncs == 2
    assert_bitwise(ela["params"], ref["params"])
    assert_bitwise(ela["opt_state"], ref["opt_state"])
    assert int(ela["step"]) == 4


@pytest.mark.parametrize("opt_name", ["sgd", "adam"])
def test_masked_step_matches_jax(opt_name):
    mask = [1.0, 0.0, 1.0, 1.0]
    opt, jopt = ((sgd(0.05), jsgd(0.05)) if opt_name == "sgd"
                 else (adam(1e-2, fused=True), jadam(1e-2)))
    comm, jcomm = LocalComm(4), JLocalComm(4)
    params = comm.replicate(tiny_params())
    state = {"params": params, "opt_state": opt.init(params),
             "comm_state": {}, "step": torch.zeros((), dtype=torch.int32)}
    jp = jcomm.replicate(jtiny_params())
    jstate = {"params": jp, "opt_state": jopt.init(jp), "comm_state": {},
              "step": jnp.zeros((), jnp.int32)}
    step = E.make_elastic_replica_step(tiny_loss, opt, comm, resync_every=2,
                                       bucket_bytes=BB)
    jstep = JE.make_elastic_replica_step(jtiny_loss, jopt, jcomm,
                                         resync_every=2, bucket_bytes=BB,
                                         donate=False)
    for t in range(4):
        state, m = step(state, tiny_batches(4, t), torch.tensor(mask))
        jstate, jm = jstep(jstate, jtiny_batches(4, t), jnp.asarray(mask))
        assert m["resync"] == bool(jm["resync"])
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["sync_divergence"]),
                                   float(jm["sync_divergence"]), atol=1e-6)
        assert float(m["wire_bytes"]) == float(jm["wire_bytes"])
    for a, b in zip(TT.leaves(state["params"]) + TT.leaves(
            state["opt_state"]), jax.tree.leaves(jstate["params"])
            + jax.tree.leaves(jstate["opt_state"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-7)


# ---------------------------------------------------------------------------
# the controller
# ---------------------------------------------------------------------------
def _events(spec, mod):
    return mod.ChaosSchedule(tuple(mod.ChaosEvent(*e) for e in spec))


FLEET_CASES = {
    "kill": dict(events=[(5, "kill", 2)], opt="adam", workers=4, n=8,
                 kw=dict(retries=2, backoff_s=0.0)),
    "flake": dict(events=[(3, "flake", 1)], opt="sgd", workers=4, n=5,
                  kw=dict(retries=2, backoff_s=1e-4)),
    "transient_surfaced": dict(events=[(0, "flake", 1)], opt="sgd",
                               workers=2, n=1,
                               kw=dict(retries=0, backoff_s=0.0)),
    "preempt_rejoin": dict(events=[(2, "preempt", 1), (5, "rejoin", 1)],
                           opt="adam", workers=4, n=7,
                           kw=dict(backoff_s=0.0)),
    "straggler": dict(events=[(1, "slowdown", 3, 6.0), (6, "restore", 3)],
                      opt="adam", workers=4, n=16,
                      kw=dict(resync_every=4, backoff_s=0.0), straggler=1),
}


def _fleets(case):
    c = FLEET_CASES[case]
    opt, jopt = ((adam(1e-2, fused=True), jadam(1e-2)) if c["opt"] == "adam"
                 else (sgd(0.05), jsgd(0.05)))
    extra, jextra = {}, {}
    if "straggler" in c:
        extra = dict(straggler_policy=StragglerPolicy(patience=2,
                                                      recovery=2),
                     clock=C.FleetClock(4, jitter=0.0, seed=c["straggler"]))
        jextra = dict(straggler_policy=JStragglerPolicy(patience=2,
                                                        recovery=2),
                      clock=JC.FleetClock(4, jitter=0.0,
                                          seed=c["straggler"]))
    ours = E.ElasticFleet(tiny_params(), tiny_loss, opt,
                          workers=c["workers"],
                          chaos=_events(c["events"], C), bucket_bytes=BB,
                          **c["kw"], **extra)
    ref = JE.ElasticFleet(jtiny_params(), jtiny_loss, jopt,
                          workers=c["workers"],
                          chaos=_events(c["events"], JC), bucket_bytes=BB,
                          **c["kw"], **jextra)
    return ours, ref, c["n"]


def _compare_logs(logs, jlogs):
    assert len(logs) == len(jlogs)
    for a, b in zip(logs, jlogs):
        a, b = dict(a), dict(b)
        la, lb = a.pop("loss"), b.pop("loss")
        assert a == b
        np.testing.assert_allclose(la, lb, rtol=1e-5)


@pytest.mark.parametrize("case", list(FLEET_CASES))
def test_elastic_fleet_matches_jax(case):
    ours, ref, n = _fleets(case)
    if case == "transient_surfaced":
        with pytest.raises(C.ExchangeFailure) as e:
            ours.run_boundary(batch_fn)
        with pytest.raises(JC.ExchangeFailure) as je:
            ref.run_boundary(jbatch_fn)
        assert (e.value.transient, e.value.workers) \
            == (je.value.transient, je.value.workers) == (True,
                                                          frozenset({1}))
        assert ours.view.size == ref.view.size == 2
        return
    _compare_logs(ours.run(n, batch_fn), ref.run(n, jbatch_fn))
    assert (ours.view.epoch, ours.view.members, ours.view.demoted) \
        == (ref.view.epoch, ref.view.members, ref.view.demoted)
    assert list(ours._steps) == list(ref._steps)
    for a, b in zip(TT.leaves(ours.state["params"]),
                    jax.tree.leaves(ref.state["params"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    assert int(ours.state["step"]) == n
    if case == "preempt_rejoin":  # the joiner copied the consensus row
        p = ours.state["params"]["w"]
        assert torch.equal(p[1], p[0])
    if case == "straggler":
        assert list(ours._steps) == [4] and ours.view.demoted == ()
        assert any(3 in lg.get("demoted", ()) for lg in ours.history)


# ---------------------------------------------------------------------------
# sample_batch
# ---------------------------------------------------------------------------
def test_sample_batch_is_keyed_by_seed_worker_and_step():
    cfg = DataConfig(vocab_size=97, seq_len=48, batch_per_worker=3, seed=5,
                     active_vocab=41)
    a = sample_batch(cfg, 2, 7, device="cpu")
    assert a.shape == (3, 48) and a.dtype == torch.int32
    assert torch.equal(a, sample_batch(cfg, 2, 7, device="cpu"))
    for other in ((cfg, 3, 7), (cfg, 2, 8),
                  (DataConfig(97, 48, 3, seed=6, active_vocab=41), 2, 7)):
        assert not torch.equal(a, sample_batch(*other, device="cpu"))
    assert int(a.min()) >= 0 and int(a.max()) < 41
    succ = (cfg.a * a[:, :-1].long() + cfg.b) % 41 == a[:, 1:].long()
    assert 0.75 < succ.float().mean().item() < 0.99  # structure 0.9
    # a worker's batch does not depend on W
    for w_count in (3, 4, 6):
        stack = worker_batches(cfg, w_count, 7, device="cpu")
        for w in range(w_count):
            assert torch.equal(stack[w], sample_batch(cfg, w, 7,
                                                      device="cpu"))


# ---------------------------------------------------------------------------
# the example
# ---------------------------------------------------------------------------
def test_edge_async_sim_ends_in_the_reference_membership():
    from repro_torch.examples import edge_async_sim as EX

    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        fleet = EX.main(["--device", "cpu", "--steps", "2"])
    lines = text.getvalue().splitlines()
    assert lines[-1].startswith("fleet finished all 24 boundaries: "
                                "membership epoch 4, final W=4, demoted=[]")
    assert all(np.isfinite(lg["loss"]) for lg in fleet.history)
    # the controller's decisions do not depend on the model: the JAX fleet
    # on the reference's tiny problem, same schedule, policy and clock
    sched = JC.ChaosSchedule(tuple(JC.ChaosEvent(**e) for e in
                                   EX.SCHEDULE.spec()))
    ref = JE.ElasticFleet(jtiny_params(), jtiny_loss, jadam(3e-3), workers=4,
                          straggler_policy=JStragglerPolicy(patience=2,
                                                            recovery=2),
                          resync_every=4, chaos=sched,
                          clock=JC.FleetClock(4, jitter=0.0, seed=0),
                          retries=2, backoff_s=1e-4, bucket_bytes=BB)
    jlogs = ref.run(24, jbatch_fn)
    assert (fleet.view.epoch, fleet.view.size, fleet.view.demoted) \
        == (ref.view.epoch, ref.view.size, ref.view.demoted)
    for a, b in zip(fleet.history, jlogs):
        assert {k: v for k, v in a.items() if k != "loss"} \
            == {k: v for k, v in b.items() if k != "loss"}
