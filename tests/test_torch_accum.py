"""The port's microbatch accumulation, data prefetch and the CLI's
``--accum-steps`` against the JAX package on the CPU.

The replica cases of ``tests/test_accum.py``: inputs are made with numpy
from a seed and handed to both packages (a two-layer tanh MLP on K = 4
microbatches of W = 2 replicas, the reference's ``micro_problem``).  The
JAX side runs its jitted step; the port runs its own.

Tolerances: the accumulated step against the port's own per-microbatch
sum, divided once and handed to one strategy update: bitwise
(``torch.equal``), as the reference claims for its own; against the JAX
step on the same inputs, parameters at atol 1e-6 over 3 steps (the same
f32 operations, matrix products summed in another order), wire bytes and
events exact; accumulated against one K-sized batch at atol 1e-5 on the
parameters and rtol 1e-5 on the loss (the reference's bounds: the matrix
products split differently); under the bf16 policy at rtol 5e-2 on the
loss and atol 5e-2 on the master (the reference's).  The 5-step CLI
histories at ``--accum-steps 2`` on a two-layer, d_model 64 cut of
qwen2-1.5b: loss at rtol 1e-5, wire bytes exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_layers import np_params, to_jax

import repro.launch.train as JCLI
from repro.configs import get_config as jax_config
from repro.core import strategies as JST
from repro.core.comm import LocalComm as JLocalComm
from repro.core.comm import LocalHierComm as JLocalHierComm
from repro.core.compression import get_compressor as jget_compressor
from repro.core.precision import get_policy as jget_policy
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import microbatch_stack as jmicrobatch_stack
from repro.optim import optimizers as JO
from repro.train import loop as JLOOP
from repro_torch.bridge import train_state_from_numpy
from repro_torch.configs import get_config as torch_config
from repro_torch.core import strategies as ST
from repro_torch.core import tree as TT
from repro_torch.core.comm import LocalComm, LocalHierComm
from repro_torch.core.compression import get_compressor
from repro_torch.core.fabric import Fabric
from repro_torch.core.precision import get_policy
from repro_torch.data.pipeline import (DataConfig, microbatch_stack,
                                       prefetch_batches, worker_batches)
from repro_torch.launch import train as CLI
from repro_torch.optim import optimizers as TO
from repro_torch.train import loop as TLOOP

pytestmark = pytest.mark.torch

W, K = 2, 4


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny models: one intra-op thread keeps the suite's parallel workers
    from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcomp(name, **kw):
    return dataclasses.replace(jget_compressor(name, **kw), fused_encode=None)


@pytest.fixture(scope="module")
def micro():
    """(base params, X (K, W, 8, 10), Y) as numpy: K microbatches whose
    concatenation along the batch dim is one big batch."""
    rng = np.random.default_rng(0)
    base = {"w0": (0.4 * rng.standard_normal((10, 12))).astype(np.float32),
            "w1": (0.4 * rng.standard_normal((12, 1))).astype(np.float32)}
    x = rng.standard_normal((K, W, 8, 10)).astype(np.float32)
    return base, x, x.sum(-1, keepdims=True)


def tloss(p, batch):
    x, y = batch
    h = torch.tanh(x @ p["w0"].to(x.dtype)) @ p["w1"].to(x.dtype)
    return torch.mean((h.float() - y.float()) ** 2)


def jloss(p, batch):
    x, y = batch
    h = jnp.tanh(x @ p["w0"].astype(x.dtype)) @ p["w1"].astype(x.dtype)
    return jnp.mean((h.astype(jnp.float32) - y.astype(jnp.float32)) ** 2)


def tbatch(x, y):
    return torch.from_numpy(x), torch.from_numpy(y)


def big(x):  # (K, W, b, d) -> (W, K*b, d): the same samples, one batch
    return np.swapaxes(x, 0, 1).reshape(W, -1, x.shape[-1])


def tstate_of(base, opt, strat, comm, policy=None):
    params = comm.replicate(TT.tree_map(torch.from_numpy, base))
    if policy is not None:
        params = policy.cast_to_param(params)
    return TLOOP.init_train_state(params, opt, strat, comm, policy=policy)


def assert_close_to_jax(tree, jtree, atol):
    for a, b in zip(TT.leaves(tree), jax.tree.leaves(jtree)):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32), rtol=0,
                                   atol=atol)


# ---------------------------------------------------------------------------
# the accumulated step against the per-microbatch sum and the JAX step
# ---------------------------------------------------------------------------
OPTS = {"sgd": (lambda: TO.sgd(0.05), lambda: JO.sgd(0.05)),
        "adam": (lambda: TO.adam(0.02), lambda: JO.adam(0.02)),
        "adam_fused": (lambda: TO.adam(0.02, fused=True),
                       lambda: JO.adam(0.02))}


@pytest.mark.parametrize("opt_name", list(OPTS))
def test_accum_bitwise_vs_per_microbatch_sum(opt_name, micro):
    base, x, y = micro
    make, jmake = OPTS[opt_name]
    comm = LocalComm(W)
    opt, strat = make(), ST.sync()
    state = tstate_of(base, opt, strat, comm)
    step = TLOOP.make_replica_train_step(tloss, opt, strat, comm,
                                         accum_steps=K)
    # the port's own reference: K gradient trees summed in microbatch
    # order, divided once, one strategy update
    opt2 = make()
    ref = tstate_of(base, opt2, strat, comm)
    for t in range(3):
        state, m = step(state, tbatch(x, y))
        acc = None
        for j in range(K):
            _, g = TLOOP._replica_grads(tloss, ref["params"],
                                        tbatch(x[j], y[j]))
            acc = g if acc is None else TT.tree_map(torch.add, acc, g)
        p, o, _, _ = strat.update(ref["params"],
                                  TT.tree_map(lambda a: a / K, acc),
                                  ref["opt_state"], ref["comm_state"], t,
                                  opt2, comm)
        ref = {**ref, "params": p, "opt_state": o}
    for a, b in zip(TT.leaves(state["params"]), TT.leaves(ref["params"])):
        assert torch.equal(a, b)
    assert m["replica_divergence"].item() == 0.0

    jcomm, jopt, jstrat = JLocalComm(W), jmake(), JST.sync()
    jstate = JLOOP.init_train_state(jcomm.replicate(to_jax(base)), jopt,
                                    jstrat, jcomm)
    jstep = JLOOP.make_replica_train_step(jloss, jopt, jstrat, jcomm,
                                          accum_steps=K)
    for _ in range(3):
        jstate, jm = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)))
    assert_close_to_jax(state["params"], jstate["params"], 1e-6)
    assert m["wire_bytes"].item() == float(jm["wire_bytes"])


def test_accum_loss_equivalent_to_one_big_batch(micro):
    base, x, y = micro

    def train(accum):
        comm, opt, strat = LocalComm(W), TO.adam(0.02), ST.sync()
        state = tstate_of(base, opt, strat, comm)
        step = TLOOP.make_replica_train_step(tloss, opt, strat, comm,
                                             accum_steps=K if accum else 1)
        batch = tbatch(x, y) if accum else tbatch(big(x), big(y))
        for _ in range(10):
            state, m = step(state, batch)
        return state, m

    (s_acc, m_acc), (s_big, m_big) = train(True), train(False)
    for a, b in zip(TT.leaves(s_acc["params"]), TT.leaves(s_big["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(m_acc["loss"].item(), m_big["loss"].item(),
                               rtol=1e-5)
    # the same bytes a step for K times the samples
    assert m_acc["wire_bytes"].item() == m_big["wire_bytes"].item()


def test_accum_bf16_loss_equivalent_and_matches_jax(micro):
    base, x, y = micro
    pol, jpol = get_policy("bf16"), jget_policy("bf16")

    def train(accum):
        comm, opt = LocalComm(W), TO.adam(0.02)
        strat = ST.sync(policy=pol)
        state = tstate_of(base, opt, strat, comm, pol)
        step = TLOOP.make_replica_train_step(tloss, opt, strat, comm,
                                             policy=pol,
                                             accum_steps=K if accum else 1)
        batch = tbatch(x, y) if accum else tbatch(big(x), big(y))
        for _ in range(10):
            state, m = step(state, batch)
        return state, m

    (s_acc, m_acc), (s_big, m_big) = train(True), train(False)
    assert m_acc["overflow"].item() == 0.0
    np.testing.assert_allclose(m_acc["loss"].item(), m_big["loss"].item(),
                               rtol=5e-2)
    for a, b in zip(TT.leaves(s_acc["master"]), TT.leaves(s_big["master"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=5e-2)

    jcomm, jopt = JLocalComm(W), JO.adam(0.02)
    jstrat = JST.sync(policy=jpol)
    jstate = JLOOP.init_train_state(
        jpol.cast_to_param(jcomm.replicate(to_jax(base))), jopt, jstrat,
        jcomm, policy=jpol)
    jstep = JLOOP.make_replica_train_step(jloss, jopt, jstrat, jcomm,
                                          policy=jpol, accum_steps=K)
    for _ in range(10):
        jstate, jm = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)))
    # bf16 forward: a last-bit difference in a bf16 product moves the
    # master by up to a bf16 ulp of the update a step
    assert_close_to_jax(s_acc["master"], jstate["master"], 1e-3)
    np.testing.assert_allclose(m_acc["loss"].item(), float(jm["loss"]),
                               rtol=1e-3)
    assert m_acc["loss_scale"].item() == float(jm["loss_scale"])


# ---------------------------------------------------------------------------
# error-feedback and DGC state advance once a boundary
# ---------------------------------------------------------------------------
CODEC = {  # (compressor, port strategy of it, JAX strategy, state key)
    "onebit": (("onebit", {"block": 16}), ST.sync, JST.sync, "residual"),
    "dgc": (("topk", {"ratio": 0.25, "block": 16}),
            lambda c: ST.sync_dgc(c, momentum=0.9),
            lambda c: JST.sync_dgc(c, momentum=0.9), "dgc")}


@pytest.mark.parametrize("name", list(CODEC))
def test_codec_state_advances_once_per_boundary(name, micro):
    """One boundary: the comm state equals ONE exchange of the
    microbatch-mean gradients (bitwise), and the JAX step's."""
    base, x, y = micro
    (cname, ckw), make, jmake, key = CODEC[name]
    comp = get_compressor(cname, **ckw)
    comm, opt, strat = LocalComm(W), TO.sgd(0.05), make(comp)
    state0 = tstate_of(base, opt, strat, comm)
    step = TLOOP.make_replica_train_step(tloss, opt, strat, comm,
                                         accum_steps=K)
    state, m = step(state0, tbatch(x, y))
    assert m["comm_events"].item() == 1.0

    acc = None
    for j in range(K):
        _, g = TLOOP._replica_grads(tloss, state0["params"],
                                    tbatch(x[j], y[j]))
        acc = g if acc is None else TT.tree_map(torch.add, acc, g)
    gm = TT.tree_map(lambda a: a / K, acc)
    fresh = strat.init(state0["params"], comm)
    fab = Fabric(comm)
    if name == "onebit":
        _, want, _ = fab.exchange(gm, fresh["residual"], comp)
    else:
        _, want, _ = fab.exchange_dgc(gm, fresh["dgc"], comp, 0.9)
    for a, b in zip(TT.leaves(state["comm_state"][key]), TT.leaves(want)):
        assert torch.equal(a, b)

    jcomm, jopt = JLocalComm(W), JO.sgd(0.05)
    jstrat = jmake(_jcomp(cname, **ckw))
    jstate = JLOOP.init_train_state(jcomm.replicate(to_jax(base)), jopt,
                                    jstrat, jcomm)
    jstep = JLOOP.make_replica_train_step(jloss, jopt, jstrat, jcomm,
                                          accum_steps=K)
    jstate, jm = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)))
    assert m["wire_bytes"].item() == float(jm["wire_bytes"])
    assert_close_to_jax(state["comm_state"][key], jstate["comm_state"][key],
                        1e-5)


def test_local_step_strategies_count_optimizer_steps(micro):
    """local_sgd(sync_every=2) under accum_steps=4: 3 averaging events in
    6 optimizer steps (24 microbatches), as without accumulation, and the
    same events as the JAX step's."""
    base, x, y = micro
    assert not ST.local_sgd().exchange_at_boundary
    assert ST.sync().exchange_at_boundary
    for accum in (False, True):
        comm, opt = LocalComm(W), TO.sgd(0.05)
        strat = ST.local_sgd(sync_every=2)
        state = tstate_of(base, opt, strat, comm)
        step = TLOOP.make_replica_train_step(tloss, opt, strat, comm,
                                             accum_steps=K if accum else 1)
        batch = tbatch(x, y) if accum else tbatch(x[0], y[0])
        events = []
        for _ in range(6):
            state, m = step(state, batch)
            events.append(m["comm_events"].item())
        assert events == [0.0, 1.0] * 3, (accum, events)


def test_accum_with_hierarchical_comm():
    """The accumulator rides the (P, W, ...) two-tier layout: the inner
    tier's lead axes, so no microbatch mixes replicas across pods or
    workers.  Losses against the JAX step's."""
    pods, wk, dim = 2, 2, 6
    rng = np.random.default_rng(0)
    x = rng.standard_normal((K, pods, wk, 8, dim)).astype(np.float32)
    y = x.sum(-1, keepdims=True)

    def tl(p, batch):
        xb, yb = batch
        pred = torch.einsum("wbd,wd->wb", xb, p["w"])[..., None]
        return torch.mean((pred - yb) ** 2)

    def jl(p, batch):
        xb, yb = batch
        pred = jnp.einsum("wbd,wd->wb", xb, p["w"])[..., None]
        return jnp.mean((pred - yb) ** 2)

    comm = LocalHierComm(pods, wk)
    strat = ST.hierarchical(ST.sync(), ST.gossip(mix_every=2))
    opt = TO.sgd(0.05)
    state = TLOOP.init_train_state({"w": torch.zeros(pods, wk, dim)}, opt,
                                   strat, comm)
    step = TLOOP.make_replica_train_step(tl, opt, strat, comm, accum_steps=K)
    jcomm = JLocalHierComm(pods, wk)
    jstrat = JST.hierarchical(JST.sync(), JST.gossip(mix_every=2))
    jopt = JO.sgd(0.05)
    jstate = JLOOP.init_train_state({"w": jnp.zeros((pods, wk, dim))}, jopt,
                                    jstrat, jcomm)
    jstep = JLOOP.make_replica_train_step(jl, jopt, jstrat, jcomm,
                                          accum_steps=K)
    losses = []
    for _ in range(6):
        state, m = step(state, tbatch(x, y))
        jstate, jm = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)))
        losses.append(m["loss"].item())
        np.testing.assert_allclose(losses[-1], float(jm["loss"]), rtol=1e-5)
        assert m["wire_bytes"].item() == float(jm["wire_bytes"])
    assert losses[-1] < losses[0] and np.isfinite(losses).all()
    assert_close_to_jax(state["params"], jstate["params"], 1e-5)


def test_fabric_accumulate_matches_reference_and_per_replica_rows():
    """``Fabric.accumulate`` of a stacked tree is the reference's
    ``acc + bucketize(tree)``, bitwise; one replica's tree added into its
    rows gives the same buckets; ``init_accum`` owns its storage even for
    a one-leaf bucket."""
    from repro.core.fabric import Fabric as JFabric

    rng = np.random.default_rng(5)
    trees = [{"a": rng.standard_normal((W, 301)).astype(np.float32),
              "b": rng.standard_normal((W, 13, 7)).astype(np.float32)}
             for _ in range(3)]
    fab, jfab = Fabric(LocalComm(W), 4 * 100), JFabric(JLocalComm(W), 4 * 100)
    tt = [TT.tree_map(torch.from_numpy, t) for t in trees]
    lay, jlay = fab.layout(tt[0]), jfab.layout(to_jax(trees[0]))
    assert lay.bucket_sizes == jlay.bucket_sizes and lay.n_buckets == 2
    acc, rows = fab.init_accum(lay), fab.init_accum(lay)
    jacc = jfab.init_accum(jlay)
    for t, jt in zip(tt, trees):
        assert fab.accumulate(acc, t, lay) is acc
        for w in range(W):
            fab.accumulate(rows, TT.tree_map(lambda x, w=w: x[w], t), lay,
                           replica=w)
        jacc = jfab.accumulate(jacc, to_jax(jt), jlay)
    for a, r, j in zip(acc, rows, jacc):
        assert torch.equal(a, r)
        np.testing.assert_array_equal(a.numpy(), np.asarray(j))
    assert not any(np.shares_memory(a.numpy(), x.numpy())
                   for a in acc for x in TT.leaves(tt[-1]))


def test_accum_steps_validated():
    with pytest.raises(ValueError, match="accum_steps"):
        TLOOP.make_replica_train_step(lambda p, b: 0.0, TO.sgd(0.1),
                                      ST.sync(), LocalComm(2), accum_steps=0)


# ---------------------------------------------------------------------------
# the data pipeline
# ---------------------------------------------------------------------------
def test_microbatch_stack_matches_plain_stream():
    """Microbatch j of optimizer step T is plain step T*k + j, in both
    packages (each its own stream)."""
    cfg = DataConfig(vocab_size=32, seq_len=8, batch_per_worker=2, seed=1)
    k, w = 3, 2
    stack = microbatch_stack(cfg, w, 5, k, device="cpu")
    assert stack.shape == (k, w, 2, 8) and stack.dtype == torch.int32
    for j in range(k):
        assert torch.equal(stack[j], worker_batches(cfg, w, 5 * k + j,
                                                    device="cpu"))
    jcfg = JDataConfig(vocab_size=32, seq_len=8, batch_per_worker=2, seed=1)
    assert jmicrobatch_stack(jcfg, w, 5, k).shape == tuple(stack.shape)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_prefetch_batches_order_and_values(depth):
    cfg = DataConfig(vocab_size=32, seq_len=8, batch_per_worker=2, seed=2)
    got = list(prefetch_batches(cfg, 2, 5, depth=depth, device="cpu"))
    assert [t for t, _ in got] == list(range(5))
    for t, b in got:
        assert torch.equal(b, worker_batches(cfg, 2, t, device="cpu"))
    acc = list(prefetch_batches(cfg, 2, 3, accum_steps=2, depth=depth,
                                device="cpu"))
    assert [t for t, _ in acc] == [0, 1, 2]
    for t, b in acc:
        assert torch.equal(b, microbatch_stack(cfg, 2, t, 2, device="cpu"))


# ---------------------------------------------------------------------------
# the CLI's --accum-steps against the JAX CLI
# ---------------------------------------------------------------------------
def cli_cfgs():
    over = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=1,
                head_dim=32, d_ff=128, vocab_size=256)
    return (dataclasses.replace(jax_config("qwen2-1.5b").reduced(), **over),
            dataclasses.replace(torch_config("qwen2-1.5b").reduced(), **over))


STEPS = 5


@pytest.mark.parametrize("comp", ["none", "onebit"])
def test_cli_accum_history_matches_jax(comp, monkeypatch):
    """Both CLIs' strategies and optimizers at ``--accum-steps 2`` from one
    initial state (through the bridge) over the JAX package's microbatch
    stacks."""
    monkeypatch.setattr(JCLI, "get_compressor", _jcomp)
    jcfg, tcfg = cli_cfgs()
    w, k = 4, 2
    argv = ["--compressor", comp, "--fused-adam", "--accum-steps", str(k),
            "--steps", str(STEPS), "--workers", str(w)]
    jargs = JCLI.build_argparser().parse_args(argv)
    targs = CLI.build_argparser().parse_args(argv + ["--device", "cpu"])
    jstrat, tstrat = (JCLI.strategy_from_args(jargs),
                      CLI.strategy_from_args(targs))
    jopt = JO.adam(JO.warmup_cosine(1e-3, 1, STEPS))
    topt = TO.adam(TO.warmup_cosine(1e-3, 1, STEPS), fused=True)
    jcomm, tcomm = JLocalComm(w), LocalComm(w)
    jstate = JLOOP.init_train_state(
        jcomm.replicate(to_jax(np_params(jcfg, seed=2))), jopt, jstrat, jcomm)
    tstate = train_state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    jloss_fn = JLOOP.make_loss_fn(jcfg, remat=False)
    tloss_fn = TLOOP.make_loss_fn(tcfg, remat=False)
    jstep = JLOOP.make_replica_train_step(
        lambda p, x: jloss_fn(p, {"tokens": x, "labels": x}), jopt, jstrat,
        jcomm, accum_steps=k)
    tstep = TLOOP.make_replica_train_step(
        lambda p, x: tloss_fn(p, {"tokens": x, "labels": x}), topt, tstrat,
        tcomm, accum_steps=k)
    dcfg = JDataConfig(vocab_size=jcfg.vocab_size, seq_len=16,
                       batch_per_worker=2)
    for t in range(STEPS):
        toks = np.array(jmicrobatch_stack(dcfg, w, t, k))
        jstate, jm = jstep(jstate, jnp.asarray(toks))
        tstate, tm = tstep(tstate, torch.from_numpy(toks))
        assert tm["wire_bytes"].item() == float(jm["wire_bytes"]), t
        assert tm["comm_events"].item() == float(jm["comm_events"]) == 1.0
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   rtol=1e-5)
        assert tm["replica_divergence"].item() == 0.0
    assert int(tstate["step"]) == STEPS
