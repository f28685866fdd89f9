"""The port's ZeRO-1/2/3 against its own ``sync`` and against the JAX
package's ZeRO on the CPU.

Inputs are made with numpy from a seed and handed to both packages.  The
partitioned Fabric ops (``PartitionedLayout``, ``shard_params``,
``exchange_partitioned[_accumulated]`` on the f32 wire and on the bf16
wire of the stacked simulator, ``unpartition``, the padded and the 1/W
shard accumulators) are held bitwise against the reference's on the same
buckets.  The strategies run the reference's MLP problem
(``tests/test_zero23.py``: a 12-16-8-1 tanh MLP, W = 4, buckets of 50
f32): at ``accum_steps=1`` each ZeRO stage is bitwise the port's own
``sync`` with ``sgd``, ``adam`` and ``adam(fused=True)`` (the kernel's
plain version on the CPU), since the reduce-scatter mean is the same
f32 reduction as the all-reduce's and the optimizers are elementwise;
the same under ``bf16`` (params, f32 master, m and v), whose wire is the
same bf16 image reduced in f32; ZeRO-2 and ZeRO-3 at ``accum_steps=4``
within 2e-6 of ``sync``, params, m and v (the reference's bound: the sum
of microbatch means against the mean of the sum).  Against the JAX
package's ZeRO on a two-layer cut of qwen2-1.5b (d_model 64, W = 2, 3
steps): in f32, under momentum, the params and the shard-bucket
optimizer state at atol 1e-6 and the loss at rtol 1e-5 (the same f32
operations, the model's matrix products summed in another order);
ZeRO-1/2/3 under ``bf16`` with momentum, the f32 master at atol 1e-4
(a step moves it by up to ~1e-3), the bf16 params within one bf16 ulp
of JAX's beyond that, m at a per-leaf relative norm of 5e-2; ZeRO-1
under ``bf16`` with Adam, m and v at 0.15 and the size of each master
leaf's movement within 5% of JAX's (``JAX_BOUNDS`` gives each bound
beside its reading); wire bytes and comm events exact in every case.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_layers import np_params, to_jax

from repro.configs import get_config as jax_config
from repro.core import strategies as JST
from repro.core.comm import LocalComm as JLocalComm
from repro.core.fabric import BucketLayout as JBucketLayout
from repro.core.fabric import Fabric as JFabric
from repro.core.fabric import PartitionedLayout as JPartitionedLayout
from repro.core.precision import get_policy as jget_policy
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import microbatch_stack as jmicrobatch_stack
from repro.optim import optimizers as JO
from repro.train import loop as JLOOP
from repro_torch.bridge import params_from_numpy, train_state_to_numpy
from repro_torch.configs import get_config as torch_config
from repro_torch.core import strategies as ST
from repro_torch.core import tree as TT
from repro_torch.core.comm import LocalComm
from repro_torch.core.fabric import BucketLayout, Fabric, PartitionedLayout
from repro_torch.core.precision import get_policy
from repro_torch.optim import optimizers as TO
from repro_torch.train import loop as TLOOP

pytestmark = pytest.mark.torch

W = 4
BB = 4 * 50  # small buckets, so every tree spans several


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(seed, lead=(W,)):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal(lead + (13,)).astype(np.float32),
            "b": rng.standard_normal(lead + (7, 9)).astype(np.float32),
            "c": rng.standard_normal(lead + (301,)).astype(np.float32)}


def _t(tree):
    return TT.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _eq(a, b):
    """Bitwise: same dtype and shape, same bits."""
    a = a.detach().cpu().contiguous().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)
    b = b.detach().cpu().contiguous().numpy() if isinstance(b, torch.Tensor) \
        else np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    return a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# the partitioned Fabric against the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("w", [2, 3, 4])
def test_partitioned_layout_matches_reference(w):
    tree = _np_tree(0, (w,))
    play = PartitionedLayout.build(BucketLayout.build(_t(tree), 4 * 100, 1),
                                   w)
    jplay = JPartitionedLayout.build(
        JBucketLayout.build(to_jax(tree), 4 * 100, 1), w)
    assert play.padded_sizes == jplay.padded_sizes
    assert play.shard_sizes == jplay.shard_sizes
    assert play.spec() == jplay.spec()
    assert all(p % w == 0 for p in play.padded_sizes)
    for w2 in (1, 2, 5):
        assert play.with_parts(w2).padded_sizes \
            == jplay.with_parts(w2).padded_sizes
        assert play.with_parts(w2).layout is play.layout


def test_shard_params_and_unpartition_match_reference():
    """On a replicated tree: the shards bitwise the reference's, and
    ``unpartition(shard_params(x))`` is ``x`` bitwise."""
    tree = {k: np.repeat(v[:1], W, axis=0)
            for k, v in _np_tree(1).items()}
    fab, jfab = Fabric(LocalComm(W), 4 * 64), JFabric(JLocalComm(W), 4 * 64)
    play = fab.partitioned_layout(_t(tree))
    shards = fab.shard_params(_t(tree), play)
    jshards = jfab.shard_params(to_jax(tree))
    assert len(shards) == len(jshards) == play.layout.n_buckets
    for a, b in zip(shards, jshards):
        assert a.shape == (W, a.shape[-1]) and _eq(a, b)
    back = fab.unpartition(shards, play)
    for k in tree:
        assert _eq(back[k], tree[k])
        assert back[k].stride()[0] == 0  # one copy behind the replica axis


@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
def test_exchange_partitioned_matches_reference(wire):
    """f32 wire and the bf16 wire of the stacked simulator (buckets
    rounded to bf16, reduced in f32): the shards, the unpartitioned mean
    and the metrics bitwise; ``_accumulated`` from padded buckets gives
    the same shards."""
    tree = _np_tree(2)
    fab = Fabric(LocalComm(W), 4 * 100, wire_dtype=wire)
    jfab = JFabric(JLocalComm(W), 4 * 100, wire_dtype=getattr(jnp, wire))
    play = fab.partitioned_layout(_t(tree))
    shards, m = fab.exchange_partitioned(_t(tree), play)
    jshards, jm = jfab.exchange_partitioned(to_jax(tree))
    for a, b in zip(shards, jshards):
        assert a.dtype == torch.float32 and _eq(a, b)
    for key in ("wire_bytes", "comm_events"):
        assert _eq(m[key], jm[key])
    assert float(m["wire_bytes"]) == fab.flat_bytes(play.layout)
    full, jfull = fab.unpartition(shards, play), \
        jfab.unpartition(jshards, jfab.partitioned_layout(to_jax(tree)))
    for k in tree:
        assert _eq(full[k], jfull[k])
    padded = fab._pad_buckets(play.layout.bucketize(_t(tree)), play)
    again, _ = fab.exchange_partitioned_accumulated(padded, play)
    assert all(torch.equal(a, b) for a, b in zip(again, shards))


def test_accumulators_match_reference():
    """``init_accum(lay, play=)`` + ``accumulate`` into it (stacked and
    replica by replica: the same buckets, padding zero) and
    ``init_accum_partitioned`` + ``accumulate_partitioned`` against the
    reference's over three microbatches, bitwise, with equal metrics."""
    trees = [_np_tree(10 + j) for j in range(3)]
    fab, jfab = Fabric(LocalComm(W), 4 * 100), JFabric(JLocalComm(W),
                                                       4 * 100)
    play = fab.partitioned_layout(_t(trees[0]))
    jplay = jfab.partitioned_layout(to_jax(trees[0]))
    lay = play.layout
    acc, rows = fab.init_accum(lay, play=play), fab.init_accum(lay, play=play)
    jacc = jfab.init_accum(jplay.layout, jplay)
    sacc = fab.init_accum_partitioned(play)
    jsacc = jfab.init_accum_partitioned(jplay)
    for tree in trees:
        assert fab.accumulate(acc, _t(tree), lay) is acc
        for w in range(W):
            fab.accumulate(rows, TT.tree_map(lambda x, w=w: x[w], _t(tree)),
                           lay, replica=w)
        jacc = jfab.accumulate(jacc, to_jax(tree), jplay.layout, jplay)
        sacc, m = fab.accumulate_partitioned(sacc, _t(tree), play)
        jsacc, jm = jfab.accumulate_partitioned(jsacc, to_jax(tree), jplay)
        assert _eq(m["wire_bytes"], jm["wire_bytes"])
    for a, r, b in zip(acc, rows, jacc):
        assert a.shape[-1] in play.padded_sizes
        assert _eq(a, b) and _eq(r, b)
    for a, b in zip(sacc, jsacc):
        assert _eq(a, b)
    # the shard accumulator of the padded buckets, microbatch by microbatch
    # through ``accumulate_partitioned_buckets``, is the same
    again = fab.init_accum_partitioned(play)
    for tree in trees:
        mb = fab.init_accum(lay, play=play)
        fab.accumulate(mb, _t(tree), lay)
        fab.accumulate_partitioned_buckets(again, mb, play)
    assert all(torch.equal(a, b) for a, b in zip(again, sacc))


# ---------------------------------------------------------------------------
# the strategies on the reference's MLP problem: ZeRO-k against sync
# ---------------------------------------------------------------------------
DIMS = (12, 16, 8, 1)


def mlp_problem(accum=1):
    rng = np.random.default_rng(0)
    base = {f"w{i}": (0.3 * rng.standard_normal((a, b))).astype(np.float32)
            for i, (a, b) in enumerate(zip(DIMS[:-1], DIMS[1:]))}
    x = rng.standard_normal((W, 32, DIMS[0])).astype(np.float32)
    if accum > 1:
        x = np.stack([x * (0.5 + 0.25 * i) for i in range(accum)])
    y = x.sum(-1, keepdims=True)
    return base, (torch.from_numpy(x), torch.from_numpy(y))


def mlp_loss(p, batch):
    x, y = batch
    h = x.to(p["w0"].dtype)
    for i in range(len(DIMS) - 1):
        h = h @ p[f"w{i}"]
        if i < len(DIMS) - 2:
            h = torch.tanh(h)
    return torch.mean((h.float() - y) ** 2)


OPTS = {"sgd": lambda: TO.sgd(0.05), "adam": lambda: TO.adam(0.02),
        "adam_fused": lambda: TO.adam(0.02, fused=True)}


def _train(name, opt, steps=12, accum=1, policy=None):
    base, batches = mlp_problem(accum)
    comm = LocalComm(W)
    strat = ST.sync(policy=policy) if name == "sync" \
        else ST.get_strategy(name, bucket_bytes=BB, policy=policy)
    params = comm.replicate(_t(base))
    if policy is not None:
        params = policy.cast_to_param(params)
    state = TLOOP.init_train_state(params, opt, strat, comm, policy=policy)
    step = TLOOP.make_replica_train_step(mlp_loss, opt, strat, comm,
                                         policy=policy, accum_steps=accum,
                                         bucket_bytes=BB)
    ms = []
    for _ in range(steps):
        state, m = step(state, batches)
        ms.append(m)
    return state, ms, strat, comm


def _full(state, strat, comm):
    return strat.gather_params(state["params"], comm) \
        if strat.owns_params else state["params"]


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("opt_name", sorted(OPTS))
@pytest.mark.parametrize("stage", ["sync_zero1", "sync_zero2", "sync_zero3"])
def test_zero_bitwise_vs_sync(stage, opt_name, precision):
    """After 12 steps the params, the master (under ``bf16`` the f32 copy:
    ZeRO-1/2's ``opt_state["master"]``, ZeRO-3's param shards) and, for
    adam, m and v, each after ``unpartition``: ``torch.equal`` to
    ``sync``'s under the same policy; the same wire bytes, the flat bytes
    of the policy's wire.  Under ``bf16`` both ship the bf16 image of the
    buckets reduced in f32, run the same elementwise update of the same
    f32 master and cast it to bf16."""
    pol = None if precision == "f32" else get_policy(precision)
    ref, rms, *_ = _train("sync", OPTS[opt_name](), policy=pol)
    state, ms, strat, comm = _train(stage, OPTS[opt_name](), policy=pol)
    fab = Fabric(comm, BB)
    ref_master = ref.get("master", ref["params"])
    play = fab.partitioned_layout(ref_master)
    master, _, opt = _split(state)
    if isinstance(master, list):
        master = fab.unpartition(master, play)
    full = _full(state, strat, comm)
    for k in ref["params"]:
        assert torch.equal(full[k], ref["params"][k]), k
        assert torch.equal(master[k], ref_master[k]), k
    for key in ("m", "v") if opt_name != "sgd" else ():
        got = fab.unpartition(opt[key], play)
        for k in got:
            assert torch.equal(got[k], ref["opt_state"][key][k]), (key, k)
    assert [float(m["wire_bytes"]) for m in ms] \
        == [float(m["wire_bytes"]) for m in rms]
    wire = torch.float32 if pol is None else torch.bfloat16
    assert float(ms[0]["wire_bytes"]) \
        == Fabric(comm, BB, wire_dtype=wire).flat_bytes(ref_master)


@pytest.mark.parametrize("stage", ["sync_zero2", "sync_zero3"])
def test_zero23_accum_within_2e6_of_sync(stage):
    """At ``accum_steps=4`` the shard accumulator sums microbatch means
    where ``sync`` takes the mean of the sum: the params within the
    reference's 2e-6, and m and v after ``unpartition`` too (Adam's step
    does not see a gradient's scale; m and v do: they read 6e-8 and 1e-9
    here, of values up to 1.1 and 0.03).  The reduce-scatter of each
    microbatch and the boundary's all-gather are charged: 4 halves and 1
    half of the flat bytes a boundary."""
    ref, _, _, comm = _train("sync", TO.adam(0.02), steps=8, accum=4)
    state, ms, strat, comm = _train(stage, TO.adam(0.02), steps=8, accum=4)
    full = _full(state, strat, comm)
    for k in ref["params"]:
        np.testing.assert_allclose(full[k].numpy(),
                                   ref["params"][k].numpy(), rtol=0,
                                   atol=2e-6, err_msg=k)
    fab = Fabric(comm, BB)
    play = fab.partitioned_layout(ref["params"])
    for key in ("m", "v"):
        got = fab.unpartition(state["opt_state"][key], play)
        for k in got:
            np.testing.assert_allclose(got[k].numpy(),
                                       ref["opt_state"][key][k].numpy(),
                                       rtol=0, atol=2e-6, err_msg=(key, k))
    flat = Fabric(comm, BB).flat_bytes(ref["params"])
    assert float(ms[-1]["wire_bytes"]) == 4 * flat / 2 + flat / 2
    assert float(ms[-1]["comm_events"]) == 5.0


def test_zero1_state_is_one_over_w_and_zero3_params_too():
    base, _ = mlp_problem()
    n_dense = sum(a.size for a in base.values())
    for stage in ("sync_zero1", "sync_zero3"):
        state, _, strat, comm = _train(stage, TO.adam(0.02), steps=2)
        m = state["opt_state"]["m"]
        assert isinstance(m, list) and all(x.shape[0] == W for x in m)
        per_worker = sum(x[0].numel() for x in m)
        assert n_dense / W <= per_worker < n_dense / W + len(m)
        if stage == "sync_zero3":
            shards = state["params"]
            assert isinstance(shards, list)
            assert sum(x[0].numel() for x in shards) == per_worker
            full = strat.gather_params(shards, comm)
            assert {k: tuple(v.shape[1:]) for k, v in full.items()} \
                == {k: a.shape for k, a in base.items()}


@pytest.mark.parametrize("stage", ["sync_zero1", "sync_zero3"])
def test_bf16_master_rides_the_shards_and_an_overflow_writes_nothing(stage):
    """Under ``bf16`` no ``state["master"]``: ZeRO-1 keeps the f32 master
    shards in ``opt_state["master"]``, ZeRO-3's param shards are the
    master.  A boundary forced to overflow leaves every leaf bitwise,
    ships nothing and halves the scale."""
    pol = get_policy("bf16")
    base, batches = mlp_problem()
    comm = LocalComm(W)
    strat = ST.get_strategy(stage, bucket_bytes=BB, policy=pol)
    opt = TO.adam(0.02, fused=True)
    state = TLOOP.init_train_state(pol.cast_to_param(
        comm.replicate(_t(base))), opt, strat, comm, policy=pol)
    assert "master" not in state
    if stage == "sync_zero1":
        assert set(state["opt_state"]) == {"opt", "master"}
        assert all(x.dtype == torch.float32
                   for x in state["opt_state"]["master"])
    else:
        assert all(x.dtype == torch.float32 for x in state["params"])
    boom = {"on": False}

    def loss(p, b):
        out = mlp_loss(p, b)
        return out * float("inf") if boom["on"] else out

    step = TLOOP.make_replica_train_step(loss, opt, strat, comm, policy=pol,
                                         bucket_bytes=BB)
    state, _ = step(state, batches)
    snap = [x.clone() for x in TT.leaves(
        {k: state[k] for k in ("params", "opt_state", "comm_state")})]
    scale = float(state["loss_scale"]["scale"])
    boom["on"] = True
    state, m = step(state, batches)
    now = TT.leaves({k: state[k] for k in ("params", "opt_state",
                                           "comm_state")})
    assert len(now) == len(snap)
    assert all(torch.equal(a, b) for a, b in zip(now, snap))
    assert float(m["overflow"]) == 1.0
    assert float(m["wire_bytes"]) == 0.0 and float(m["comm_events"]) == 0.0
    assert float(state["loss_scale"]["scale"]) == scale / 2


# ---------------------------------------------------------------------------
# against the JAX package's ZeRO on a transformer cut
# ---------------------------------------------------------------------------
JW, JSTEPS = 2, 3

# (stage, precision, accum, optimizer).  Momentum's state is a linear
# function of the gradients, so its master holds an element bound across
# packages.  Adam's first steps move an element by ~lr * sign(g): where
# the two realizations round a gradient near 0 to opposite signs the
# element moves by up to 2 lr, so no element bound holds for its master
# (within the port, ZeRO and sync are held bitwise under adam above).
ZERO_JAX_CASES = [("sync_zero1", "f32", 1, "momentum"),
                  ("sync_zero2", "f32", 2, "momentum"),
                  ("sync_zero3", "f32", 2, "momentum"),
                  ("sync_zero1", "bf16", 2, "momentum"),
                  ("sync_zero2", "bf16", 2, "momentum"),
                  ("sync_zero3", "bf16", 2, "momentum"),
                  ("sync_zero1", "bf16", 2, "adam")]

# Bounds per (precision, optimizer), each about three times this test's
# own reading on the CPU (the largest over the stages, in brackets):
#   master: atol on every element of the f32 master (the params under
#     f32, ``opt_state["master"]`` under ZeRO-1/2 bf16, the param shards
#     under ZeRO-3 bf16); the JAX run must move every master leaf by more
#     than five times it, so a stalled update fails it;
#   move: per master leaf, ‖Δport − Δjax‖ / ‖Δjax‖ of the movement from
#     the initial state (a stalled leaf reads 1); under adam, where signs
#     flip, | ‖Δport‖ / ‖Δjax‖ − 1 | instead (a stalled leaf reads 1, a
#     halved step 0.5);
#   state: per leaf of m (and v), ‖s_port − s_jax‖ / ‖s_jax‖;
#   state_atol: under f32 also on every element of m;
#   loss: rtol of each step's loss (the 3 steps move it by 1-5%).
# Under bf16 the params are the bf16 image of the port's own master,
# bitwise, and within one bf16 ulp plus the master's atol of JAX's.
JAX_BOUNDS = {
    # [master 6.0e-8, move 7.0e-6, m 1.0e-6, loss 1.5e-7]
    ("f32", "momentum"): {"master": 1e-6, "move": 1e-4, "state": 1e-5,
                          "state_atol": 1e-6, "loss": 1e-5},
    # [master 4.5e-5, move 1.7e-2, m 1.8e-2, loss 3.4e-4]
    ("bf16", "momentum"): {"master": 1e-4, "move": 5e-2, "state": 5e-2,
                           "state_atol": None, "loss": 1e-3},
    # [master 5.0e-2 (no bound), |norm ratio - 1| 1.5e-2, m 6.2e-2,
    #  v 5.3e-2, loss 7.2e-4]
    ("bf16", "adam"): {"master": None, "move": 5e-2, "state": 0.15,
                       "state_atol": None, "loss": 3e-3},
}


def _split(state):
    """(the f32 master, the bf16 params or None, the optimizer's own
    state) of a train state, either package's: ZeRO-1/2 under bf16 keep
    the master in ``opt_state``, ZeRO-3's param shards are the master."""
    opt = state["opt_state"]
    if "master" in opt:
        return opt["master"], state["params"], opt["opt"]
    return state["params"], None, opt


def _relnorm(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("stage,precision,accum,optimizer", ZERO_JAX_CASES)
def test_zero_matches_jax_on_qwen2_cut(stage, precision, accum, optimizer):
    bound = JAX_BOUNDS[(precision, optimizer)]
    jcfg = dataclasses.replace(jax_config("qwen2-1.5b").reduced(),
                               d_model=64, d_ff=128, vocab_size=256)
    tcfg = dataclasses.replace(torch_config("qwen2-1.5b").reduced(),
                               d_model=64, d_ff=128, vocab_size=256)
    jpol = None if precision == "f32" else jget_policy(precision)
    tpol = None if precision == "f32" else get_policy(precision)
    if jpol is not None:
        from repro.core.precision import apply_policy as japply
        from repro_torch.core.precision import apply_policy
        jcfg, tcfg = japply(jcfg, jpol), apply_policy(tcfg, tpol)
    jcomm, tcomm = JLocalComm(JW), LocalComm(JW)
    make = (lambda m, s: m.momentum(s, 0.9)) if optimizer == "momentum" \
        else (lambda m, s: m.adam(s))
    jopt = make(JO, JO.warmup_cosine(1e-2, 1, JSTEPS))
    topt = make(TO, TO.warmup_cosine(1e-2, 1, JSTEPS))
    bb = 1 << 16
    jstrat = JST.get_strategy(stage, bucket_bytes=bb, policy=jpol)
    tstrat = ST.get_strategy(stage, bucket_bytes=bb, policy=tpol)
    params = jcomm.replicate(to_jax(np_params(jcfg, seed=4)))
    if jpol is not None:
        params = jpol.cast_to_param(params)
    jstate = JLOOP.init_train_state(params, jopt, jstrat, jcomm,
                                    policy=jpol)
    np_state = jax.tree.map(np.asarray, jstate)
    tstate = TLOOP.init_train_state(
        params_from_numpy(jax.tree.map(np.asarray, params), "cpu"), topt,
        tstrat, tcomm, policy=tpol)
    assert jax.tree.structure(train_state_to_numpy(tstate)) \
        == jax.tree.structure(np_state)
    jl = JLOOP.make_loss_fn(jcfg, remat=False)
    tl = TLOOP.make_loss_fn(tcfg, remat=False)
    jstep = JLOOP.make_replica_train_step(
        lambda p, x: jl(p, {"tokens": x, "labels": x}), jopt, jstrat, jcomm,
        policy=jpol, accum_steps=accum, bucket_bytes=bb)
    tstep = TLOOP.make_replica_train_step(
        lambda p, x: tl(p, {"tokens": x, "labels": x}), topt, tstrat, tcomm,
        policy=tpol, accum_steps=accum, bucket_bytes=bb)
    dcfg = JDataConfig(vocab_size=jcfg.vocab_size, seq_len=16,
                       batch_per_worker=2)
    for t in range(JSTEPS):
        toks = np.asarray(jmicrobatch_stack(dcfg, JW, t, accum))
        if accum == 1:
            toks = toks[0]
        jstate, jm = jstep(jstate, jnp.asarray(toks))
        tstate, tm = tstep(tstate, torch.from_numpy(toks.copy()))
        for key in ("wire_bytes", "comm_events"):
            assert tm[key].item() == float(jm[key]), key
        assert tm["replica_divergence"].item() == 0.0
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   rtol=bound["loss"])
    got = train_state_to_numpy(tstate)
    want = jax.tree.map(np.asarray, jstate)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
    for key in ("step", "loss_scale"):
        assert all(_eq(a, b) for a, b in zip(jax.tree.leaves(got.get(key)),
                                             jax.tree.leaves(want.get(key))))
    (gm, gp, gopt), (wm, wp, wopt), (im, _, _) = map(
        _split, (got, want, np_state))
    for a, b, a0 in zip(jax.tree.leaves(gm), jax.tree.leaves(wm),
                        jax.tree.leaves(im)):
        assert a.dtype == np.float32
        if bound["master"] is not None:
            np.testing.assert_allclose(a, b, rtol=0, atol=bound["master"])
            assert np.abs(b - a0).max() > 5 * bound["master"]
        moved = _relnorm(a - a0, b - a0) if optimizer == "momentum" \
            else abs(np.linalg.norm(a - a0) / np.linalg.norm(b - a0) - 1)
        assert moved <= bound["move"], moved
    for key in wopt:
        for a, b in zip(jax.tree.leaves(gopt[key]),
                        jax.tree.leaves(wopt[key])):
            assert _relnorm(a, b) <= bound["state"], (key, _relnorm(a, b))
            if bound["state_atol"] is not None:
                np.testing.assert_allclose(a, b, rtol=0,
                                           atol=bound["state_atol"])
    if gp is None:  # the master is the params (f32, or ZeRO-3's shards)
        return
    # bf16 params: the bf16 image of the port's own master, bitwise ...
    play = Fabric(tcomm, bb).partitioned_layout(tstate["params"])
    master = Fabric(tcomm, bb).unpartition(tstate["opt_state"]["master"],
                                           play)
    for a, b in zip(TT.leaves(tstate["params"]), TT.leaves(master)):
        assert torch.equal(a, b.to(torch.bfloat16))
    if bound["master"] is None:
        return
    # ... and within one bf16 ulp (2^16 f32 ulps) plus the master's atol
    # of JAX's, where the two masters straddle a rounding boundary
    for a, b in zip(jax.tree.leaves(gp), jax.tree.leaves(wp)):
        a, b = a.astype(np.float32), b.astype(np.float32)
        ulp = np.spacing(np.maximum(np.abs(a), np.abs(b))) * 2.0 ** 16
        assert np.all(np.abs(a - b) <= ulp + bound["master"])


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_global_templates_match_reference(precision):
    """``zero1_opt_template`` (with the master FROM the params under
    ``bf16``), ``zero1_master_buckets`` and ``zero3_param_template`` for
    one unstacked tree, bitwise the reference's; meta params give meta
    buckets of the same shapes, nothing allocated."""
    base = {k: v[0] for k, v in _np_tree(5).items()}
    jpol = None if precision == "f32" else jget_policy(precision)
    pol = None if precision == "f32" else get_policy(precision)
    got = TLOOP.zero1_opt_template(_t(base), TO.adam(1e-3), 3, 4 * 64, pol)
    want = JLOOP.zero1_opt_template(to_jax(base), JO.adam(1e-3), 3, 4 * 64,
                                    jpol)
    a, b = TT.leaves(got), jax.tree.leaves(want)
    assert len(a) == len(b) and all(_eq(x, y) for x, y in zip(a, b))
    for ours, ref in ((TLOOP.zero1_master_buckets(_t(base), 3, 4 * 64),
                       JLOOP.zero1_master_buckets(to_jax(base), 3, 4 * 64)),
                      (TLOOP.zero3_param_template(_t(base), 3, 4 * 64),
                       JLOOP.zero3_param_template(to_jax(base), 3, 4 * 64))):
        assert len(ours) == len(ref) and all(_eq(x, y)
                                             for x, y in zip(ours, ref))
    meta = TT.tree_map(lambda x: torch.empty(x.shape, device="meta"),
                       _t(base))
    tmpl = TLOOP.zero1_opt_template(meta, TO.adam(1e-3), 3, 4 * 64, pol)
    assert all(x.device.type == "meta" for x in TT.leaves(tmpl))
    assert [tuple(x.shape) for x in TT.leaves(tmpl)] \
        == [tuple(x.shape) for x in b]
    assert [tuple(x.shape) for x in TLOOP.zero3_param_template(
        meta, 3, 4 * 64)] == [tuple(x.shape) for x in TT.leaves(
            TLOOP.zero3_param_template(_t(base), 3, 4 * 64))]
