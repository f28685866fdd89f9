"""The port's strategy spectrum, hierarchical comms, bridge and trainer CLI
against the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages.  The
JAX side runs its jnp codec path (compressors without their fused encode,
which the JAX package's tests hold bitwise equal to its kernels); the port
runs its default path, the kernels' plain versions.

Tolerances: on the reference's linear problem the parameters after every
step at rtol 1e-5, atol 1e-6 (the same f32 steps, matrix products summed
in another order), wire bytes and events exact; CLI histories on a
two-layer, d_model 64 cut of qwen2-1.5b: loss and replica divergence at
rtol 1e-4 over 5 steps (a 1-bit sign or a top-k choice near a tie can
flip on a last-bit difference), wire bytes exact.
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
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import worker_batches as jworker_batches
from repro.optim import optimizers as JO
from repro.train import loop as JLOOP
from repro_torch.bridge import train_state_from_numpy, train_state_to_numpy
from repro_torch.configs import get_config as torch_config
from repro_torch.core import strategies as ST
from repro_torch.core import tree as TT
from repro_torch.core.comm import LocalComm, LocalHierComm
from repro_torch.core.compression import get_compressor
from repro_torch.examples import spectrum_comparison
from repro_torch.launch import train as CLI
from repro_torch.optim import optimizers as TO
from repro_torch.train import loop as TLOOP

pytestmark = pytest.mark.torch

W, DIM, NDATA = 4, 12, 64


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


# ---------------------------------------------------------------------------
# the reference's linear problem (tests/test_strategies.py), both packages
# ---------------------------------------------------------------------------
def _problem():
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((W, NDATA, DIM)).astype(np.float32)
    w_true = rng.standard_normal(DIM).astype(np.float32)
    ys = (xs @ w_true + 0.01 * rng.standard_normal((W, NDATA))) \
        .astype(np.float32)
    return np.concatenate([xs, ys[..., None]], axis=-1)  # (W, N, DIM + 1)


def _jloss(params, b):
    return jnp.mean((b[:, :DIM] @ params["w"] - b[:, DIM]) ** 2)


def _tloss(params, b):
    return ((b[:, :DIM] @ params["w"] - b[:, DIM]) ** 2).mean()


# (name, the port's strategy, the reference's), compressors at block 16
LINEAR = [
    ("sync", lambda: ST.sync(), lambda: JST.sync()),
    ("sync_onebit", lambda: ST.sync(get_compressor("onebit", block=16)),
     lambda: JST.sync(_jcomp("onebit", block=16))),
    ("sync_dgc_topk",
     lambda: ST.sync_dgc(get_compressor("topk", ratio=0.25, block=16)),
     lambda: JST.sync_dgc(_jcomp("topk", ratio=0.25, block=16))),
    ("sync_dgc_onebit", lambda: ST.sync_dgc(get_compressor("onebit",
                                                           block=16)),
     lambda: JST.sync_dgc(_jcomp("onebit", block=16))),
    ("local_sgd", lambda: ST.local_sgd(sync_every=4),
     lambda: JST.local_sgd(sync_every=4)),
    ("easgd", lambda: ST.easgd(alpha=0.2, sync_every=3),
     lambda: JST.easgd(alpha=0.2, sync_every=3)),
    ("ssp", lambda: ST.ssp(staleness=3), lambda: JST.ssp(staleness=3)),
    ("ssp_aware_int8",
     lambda: ST.ssp(staleness=3, staleness_aware_lr=True,
                    compressor=get_compressor("int8", block=16)),
     lambda: JST.ssp(staleness=3, staleness_aware_lr=True,
                     compressor=_jcomp("int8", block=16))),
    ("downpour", lambda: ST.downpour(push_every=4),
     lambda: JST.downpour(push_every=4)),
    ("downpour_onebit",
     lambda: ST.downpour(push_every=3,
                         compressor=get_compressor("onebit", block=16)),
     lambda: JST.downpour(push_every=3,
                          compressor=_jcomp("onebit", block=16))),
    ("gossip", lambda: ST.gossip(), lambda: JST.gossip()),
    ("gossip_one_sided", lambda: ST.gossip(mix_every=2, symmetric=False),
     lambda: JST.gossip(mix_every=2, symmetric=False)),
]


@pytest.mark.parametrize("name,make,jmake", LINEAR, ids=[c[0] for c in LINEAR])
def test_strategy_matches_jax_on_the_linear_problem(name, make, jmake):
    data = _problem()
    rng = np.random.default_rng(1)
    w0 = (0.1 * rng.standard_normal((W, DIM))).astype(np.float32)
    jopt, topt = JO.sgd(0.05), TO.sgd(0.05)
    jcomm, tcomm = JLocalComm(W), LocalComm(W)
    jstrat, tstrat = jmake(), make()
    jstate = JLOOP.init_train_state({"w": jnp.asarray(w0)}, jopt, jstrat,
                                    jcomm)
    tstate = train_state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    jstep = JLOOP.make_replica_train_step(_jloss, jopt, jstrat, jcomm)
    tstep = TLOOP.make_replica_train_step(_tloss, topt, tstrat, tcomm)
    jb, tb = jnp.asarray(data), torch.from_numpy(data)
    for t in range(12):
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb)
        np.testing.assert_allclose(tstate["params"]["w"].numpy(),
                                   np.asarray(jstate["params"]["w"]),
                                   rtol=1e-5, atol=1e-6, err_msg=f"step {t}")
        assert tm["wire_bytes"].item() == float(jm["wire_bytes"])
        assert tm["comm_events"].item() == float(jm["comm_events"])
    assert int(tstate["step"]) == 12
    back = train_state_to_numpy(tstate)
    assert jax.tree.structure(back["comm_state"]) == \
        jax.tree.structure(jax.tree.map(np.asarray, jstate["comm_state"]))


def test_registry_holds_the_reference_spectrum_but_zero():
    # the ZeRO strategies joined the registry with their slice: the whole
    # reference registry now, and the same declarations
    assert set(ST.REGISTRY) == set(JST.REGISTRY)
    for name in ST.REGISTRY:
        kw = {"compressor": get_compressor("topk", ratio=0.01)} \
            if name == "sync_dgc" else {}
        jkw = {"compressor": jget_compressor("topk", ratio=0.01)} \
            if name == "sync_dgc" else {}
        ours, ref = ST.get_strategy(name, **kw), JST.get_strategy(name, **jkw)
        for field in ("name", "spectrum_point", "complete",
                      "exchange_at_boundary", "wire_profile", "gated",
                      "sync_every", "wire_events", "owns_master",
                      "owns_params", "partitioned_accum"):
            assert getattr(ours, field) == getattr(ref, field), (name, field)


# ---------------------------------------------------------------------------
# hierarchical comms and the hierarchical strategy
# ---------------------------------------------------------------------------
def _hier_grads(params, data, jax_side):
    """Per-(pod, worker) gradients of the linear loss."""
    pods, wk = params["w"].shape[:2]
    d = data.reshape(pods, wk, NDATA, DIM + 1)
    if jax_side:
        return jax.vmap(jax.vmap(jax.grad(_jloss)))(params, jnp.asarray(d))
    return torch.func.vmap(torch.func.vmap(torch.func.grad(_tloss)))(
        params, torch.from_numpy(d))


HIER = [
    ("sync_x_gossip", lambda: ST.hierarchical(ST.sync(),
                                              ST.gossip(mix_every=2)),
     lambda: JST.hierarchical(JST.sync(), JST.gossip(mix_every=2))),
    ("sync_onebit_x_gossip",
     lambda: ST.hierarchical(ST.sync(get_compressor("onebit", block=16)),
                             ST.gossip(mix_every=2)),
     lambda: JST.hierarchical(JST.sync(_jcomp("onebit", block=16)),
                              JST.gossip(mix_every=2))),
    ("sync_x_easgd", lambda: ST.hierarchical(ST.sync(), ST.easgd()),
     lambda: JST.hierarchical(JST.sync(), JST.easgd())),
]


@pytest.mark.parametrize("name,make,jmake", HIER, ids=[c[0] for c in HIER])
def test_hierarchical_matches_jax_on_local_hier_comm(name, make, jmake):
    pods, wk = 2, 2
    data = _problem()
    w0 = np.zeros((pods, wk, DIM), np.float32)
    jcomm, tcomm = JLocalHierComm(pods, wk), LocalHierComm(pods, wk)
    jstrat, tstrat = jmake(), make()
    jopt, topt = JO.sgd(0.05), TO.sgd(0.05)
    jp, tp = {"w": jnp.asarray(w0)}, {"w": torch.from_numpy(w0.copy())}
    jo, to = jopt.init(jp), topt.init(tp)
    jc, tc = jstrat.init(jp, jcomm), tstrat.init(tp, tcomm)
    for t in range(9):
        jp, jo, jc, jm = jstrat.update(jp, _hier_grads(jp, data, True), jo,
                                       jc, jnp.asarray(t, jnp.int32), jopt,
                                       jcomm)
        tp, to, tc, tm = tstrat.update(tp, _hier_grads(tp, data, False), to,
                                       tc, t, topt, tcomm)
        np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                                   rtol=1e-5, atol=1e-6, err_msg=f"step {t}")
        assert tm["wire_bytes"].item() == float(jm["wire_bytes"])
    # the complete inner tier keeps a pod's workers equal
    assert torch.equal(tp["w"][:, 0], tp["w"][:, 1])


def test_hierarchical_inner_complete_outer_partial():
    """Zero grads, lr 0: workers in a pod stay equal and pod p mixes only
    with its ring neighbours p - 1 and p + 1."""
    pods, wk, dim = 4, 2, 3
    comm = LocalHierComm(pods, wk)
    strat = ST.hierarchical(ST.sync(), ST.gossip(mix_every=1))
    vals = torch.arange(1.0, pods + 1)
    params = {"w": vals[:, None, None].expand(pods, wk, dim).clone()}
    grads = {"w": torch.zeros(pods, wk, dim)}
    opt = TO.sgd(0.0)
    p, _, _, m = strat.update(params, grads, opt.init(params),
                              strat.init(params, comm), 0, opt, comm)
    w = p["w"]
    assert torch.equal(w[:, 0], w[:, 1])
    expect = (vals + torch.roll(vals, 1) + torch.roll(vals, -1)) / 3.0
    torch.testing.assert_close(w[:, 0, 0], expect, rtol=0, atol=1e-6)
    assert strat.spectrum_point == 4 and not strat.complete


def test_hier_comm_axis_binding_and_easgd_center_match_reference():
    pods, wk = 3, 2
    jcomm, tcomm = JLocalHierComm(pods, wk), LocalHierComm(pods, wk)
    assert (tcomm.inner.axis, tcomm.outer.axis) == (1, 0)
    assert tcomm.inner.lead_axes == tcomm.outer.lead_axes == 2
    assert tcomm.size == jcomm.size == pods * wk
    x = np.arange(float(pods * wk * 4), dtype=np.float32) \
        .reshape(pods, wk, 4)
    jx, tx = {"w": jnp.asarray(x)}, {"w": torch.from_numpy(x)}
    for tier in ("inner", "outer"):
        jt, tt = getattr(jcomm, tier), getattr(tcomm, tier)
        for op in ("all_mean", "all_sum"):
            np.testing.assert_array_equal(getattr(tt, op)(tx)["w"].numpy(),
                                          np.asarray(getattr(jt, op)(jx)["w"]))
        for shift in (1, -1):
            np.testing.assert_array_equal(
                tt.ppermute(tx, shift)["w"].numpy(),
                np.asarray(jt.ppermute(jx, shift)["w"]))
        np.testing.assert_array_equal(tt.worker_index().numpy(),
                                      np.asarray(jt.worker_index()))
        np.testing.assert_array_equal(
            ST.easgd().init(tx, tt)["center"]["w"].numpy(),
            np.asarray(JST.easgd().init(jx, jt)["center"]["w"]))


class _NoReplicaAxes:
    """A comm whose params carry no replica axis (``lead_axes == 0``), as a
    sharded comm's; ``axis`` names a weight axis that must not be averaged."""
    lead_axes = 0
    axis = 0


def test_easgd_center_without_replica_axes_matches_reference():
    rng = np.random.default_rng(3)
    x = {"w": rng.standard_normal((3, 5)).astype(np.float32),
         "b": rng.standard_normal(5).astype(np.float16)}
    comm = _NoReplicaAxes()
    center = ST.easgd().init({k: torch.from_numpy(a) for k, a in x.items()},
                             comm)["center"]
    jcenter = JST.easgd().init({k: jnp.asarray(a) for k, a in x.items()},
                               comm)["center"]
    for k, a in x.items():
        assert center[k].dtype == torch.float32
        assert center[k].shape == a.shape
        np.testing.assert_array_equal(center[k].numpy(), a.astype(np.float32))
        np.testing.assert_array_equal(center[k].numpy(),
                                      np.asarray(jcenter[k]))


# ---------------------------------------------------------------------------
# the no-mutation contract and downpour's events
# ---------------------------------------------------------------------------
NO_MUTATION = [
    ("sync_dgc", lambda: ST.sync_dgc(get_compressor("topk", ratio=0.25,
                                                    block=16))),
    ("ssp", lambda: ST.ssp(staleness=3,
                           compressor=get_compressor("int8", block=16))),
    ("downpour", lambda: ST.downpour(
        push_every=4, compressor=get_compressor("int8", block=16))),
    ("hierarchical", lambda: ST.hierarchical(ST.sync(),
                                             ST.gossip(mix_every=2))),
]


@pytest.mark.parametrize("name,make", NO_MUTATION,
                         ids=[c[0] for c in NO_MUTATION])
def test_update_does_not_mutate_comm_state(name, make):
    """Stepping twice from the SAME saved state gives identical results,
    and the caller's comm state still holds its original tensors, unchanged
    (the ssp ring is neither copied nor written)."""
    strat = make()
    if name == "hierarchical":
        comm = LocalHierComm(2, 2)
        shape = (2, 2, DIM)
    else:
        comm = LocalComm(W)
        shape = (W, DIM)
    params = {"w": torch.zeros(shape)}
    grads = {"w": torch.ones(shape)}
    opt = TO.sgd(0.05)
    opt_state = opt.init(params)
    cstate = strat.init(params, comm)
    # a state that is not all zeros, so a write into it would show
    cstate = TT.tree_map(lambda x: x + torch.randn(x.shape), cstate)
    saved = TT.leaves(cstate)
    copies = [x.clone() for x in saved]
    for t in (0, 1):
        out1 = strat.update(params, grads, opt_state, cstate, t, opt, comm)
        out2 = strat.update(params, grads, opt_state, cstate, t, opt, comm)
        for a, b in zip(TT.leaves(out1[0]) + TT.leaves(out1[2]),
                        TT.leaves(out2[0]) + TT.leaves(out2[2])):
            assert torch.equal(a, b)
    for a, b, c in zip(saved, TT.leaves(cstate), copies):
        assert a is b and torch.equal(b, c)


def test_ssp_ring_shares_the_fresh_gradient_without_a_copy():
    strat = ST.ssp(staleness=3)
    comm = LocalComm(W)
    params = {"w": torch.zeros(W, DIM)}
    grads = {"w": torch.randn(W, DIM)}
    opt = TO.sgd(0.05)
    cstate = strat.init(params, comm)
    _, _, new, _ = strat.update(params, grads, opt.init(params), cstate, 4,
                                opt, comm)
    assert new["buf"][1]["w"] is grads["w"]  # slot 4 % 3
    assert new["buf"][0] is cstate["buf"][0]
    assert new["buf"][2] is cstate["buf"][2]


def test_downpour_events_is_fleet_fraction():
    """comm_events is the fleet-wide push fraction (1/push_every with
    staggered offsets), not a per-replica 0/1 indicator."""
    strat = ST.downpour(push_every=4)
    comm = LocalComm(W)
    params = {"w": torch.zeros(W, DIM)}
    grads = {"w": torch.ones(W, DIM)}
    opt = TO.sgd(0.05)
    cstate = strat.init(params, comm)
    for t in range(4):
        *_, m = strat.update(params, grads, opt.init(params), cstate, t,
                             opt, comm)
        assert m["comm_events"].item() == pytest.approx(0.25)


# ---------------------------------------------------------------------------
# the bridge and the CLI
# ---------------------------------------------------------------------------
def cfgs():
    over = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=1,
                head_dim=32, d_ff=128, vocab_size=256)
    return (dataclasses.replace(jax_config("qwen2-1.5b").reduced(), **over),
            dataclasses.replace(torch_config("qwen2-1.5b").reduced(), **over))


# (strategy, compressor) as the CLI builds them
CLI_CASES = [("local_sgd", "none"), ("easgd", "none"), ("ssp", "none"),
             ("ssp", "onebit"), ("downpour", "none"), ("downpour", "onebit"),
             ("gossip", "none"), ("sync_dgc", "topk"), ("sync_dgc", "onebit")]


@pytest.mark.parametrize("strategy,comp", CLI_CASES)
def test_bridge_round_trips_each_strategy_state(strategy, comp):
    jcfg, _ = cfgs()
    argv = ["--strategy", strategy, "--compressor", comp]
    jstrat = JCLI.strategy_from_args(JCLI.build_argparser().parse_args(argv))
    tstrat = CLI.strategy_from_args(CLI.build_argparser().parse_args(argv))
    jcomm = JLocalComm(2)
    params = jcomm.replicate(to_jax(np_params(jcfg)))
    np_state = jax.tree.map(np.asarray, JLOOP.init_train_state(
        params, JO.adam(1e-3), jstrat, jcomm))
    # a comm state that is not all zeros, so a misplaced leaf would show
    np_state["comm_state"] = jax.tree.map(
        lambda x: np.random.default_rng(x.size).standard_normal(
            x.shape).astype(x.dtype), np_state["comm_state"])
    tstate = train_state_from_numpy(np_state, "cpu")
    own = TLOOP.init_train_state(tstate["params"], TO.adam(1e-3), tstrat,
                                 LocalComm(2))
    assert TT.flatten(own["comm_state"])[1] == \
        TT.flatten(tstate["comm_state"])[1]
    back = train_state_to_numpy(tstate)
    assert jax.tree.structure(back) == jax.tree.structure(np_state)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_state)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


STEPS = 5


@pytest.mark.parametrize("strategy,comp", CLI_CASES)
def test_cli_history_matches_jax(strategy, comp, monkeypatch):
    """Both CLIs' strategies (``strategy_from_args``) and optimizers from
    one initial state (through the bridge) over the same batches."""
    monkeypatch.setattr(JCLI, "get_compressor", _jcomp)
    jcfg, tcfg = cfgs()
    w = 4
    argv = ["--strategy", strategy, "--compressor", comp, "--fused-adam",
            "--steps", str(STEPS), "--workers", str(w)]
    jargs = JCLI.build_argparser().parse_args(argv)
    targs = CLI.build_argparser().parse_args(argv + ["--device", "cpu"])
    jstrat, tstrat = JCLI.strategy_from_args(jargs), \
        CLI.strategy_from_args(targs)
    jopt = JO.adam(JO.warmup_cosine(1e-3, 1, STEPS))
    topt = TO.adam(TO.warmup_cosine(1e-3, 1, STEPS), fused=True)
    jcomm, tcomm = JLocalComm(w), LocalComm(w)
    params = jcomm.replicate(to_jax(np_params(jcfg, seed=2)))
    jstate = JLOOP.init_train_state(params, jopt, jstrat, jcomm)
    tstate = train_state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    jloss = JLOOP.make_loss_fn(jcfg, remat=False)
    tloss = TLOOP.make_loss_fn(tcfg, remat=False)
    jstep = JLOOP.make_replica_train_step(
        lambda p, x: jloss(p, {"tokens": x, "labels": x}), jopt, jstrat,
        jcomm)
    tstep = TLOOP.make_replica_train_step(
        lambda p, x: tloss(p, {"tokens": x, "labels": x}), topt, tstrat,
        tcomm)
    dcfg = JDataConfig(vocab_size=jcfg.vocab_size, seq_len=16,
                       batch_per_worker=2)
    for t in range(STEPS):
        toks = np.array(jworker_batches(dcfg, w, t))
        jstate, jm = jstep(jstate, jnp.asarray(toks))
        tstate, tm = tstep(tstate, torch.from_numpy(toks))
        assert tm["wire_bytes"].item() == float(jm["wire_bytes"]), t
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(tm["replica_divergence"].item(),
                                   float(jm["replica_divergence"]),
                                   rtol=1e-4)
    if strategy == "sync_dgc":
        assert tm["replica_divergence"].item() == 0.0


@pytest.mark.parametrize("argv,msg", [
    (["--strategy", "sync_dgc"], "sync_dgc needs --compressor"),
    (["--zero-stage", "2", "--strategy", "gossip"],
     "--zero-stage 2 conflicts with --strategy gossip"),
    (["--zero-stage", "3", "--strategy", "sync_zero1"],
     "--zero-stage 3 conflicts with --strategy sync_zero1"),
])
def test_cli_exit_2_paths_of_the_spectrum(argv, msg, capsys):
    with pytest.raises(SystemExit) as e:
        CLI.main(["--reduced", "--device", "cpu"] + argv)
    assert e.value.code == 2
    err = capsys.readouterr().err.strip()
    assert msg in err and len(err.splitlines()) == 1


@pytest.mark.parametrize("strategy", ["local_sgd", "easgd", "ssp",
                                      "downpour", "gossip", "sync_dgc"])
def test_cli_trains_each_strategy_on_cpu(strategy, capsys):
    hist = CLI.main(["--reduced", "--device", "cpu", "--strategy", strategy,
                     "--compressor", "topk" if strategy == "sync_dgc"
                     else "none", "--steps", "2", "--log-every", "1",
                     "--workers", "2", "--batch-per-worker", "1",
                     "--seq-len", "8"])
    text = capsys.readouterr().out
    assert f"strategy={strategy} " in text and len(hist) == 2
    assert all(np.isfinite(h["loss"]) for h in hist)


def test_spectrum_example_runs_on_cpu():
    rows = spectrum_comparison.main(["--device", "cpu", "--steps", "3"])
    assert [r[1] for r in rows] == [1, 1, 2, 3, 4, 2]
    by = {r[0]: r for r in rows}
    assert by["sync (pt 1)"][3] == 0.0
    assert by["sync + 1-bit"][4] < by["sync (pt 1)"][4] / 20
