"""The port's precision policies against the JAX package on the CPU.

The replica cases of ``tests/test_precision.py``: the presets and their
spec; the f32 policy as a strict no-op for every ported strategy; the
bf16 wire; loss-scaled bf16 training of a tiny transformer; the skip-step
on an overflow, with ``adam(fused=True)`` and without it; every strategy
of the spectrum under bf16; fused Adam's flag parity; and
``delay_compensated_sgd``.  Inputs are made with numpy from a seed and
handed to both packages; the JAX side runs its jitted step and its jnp
codec path, the port its own step and the kernels' plain versions.

Tolerances: the f32 policy against no policy bitwise (``torch.equal``);
f32 against the JAX step at atol 1e-6 on the parameters (the same f32
operations, matrix products summed in another order); the bf16 wire's
mean at rtol 1e-6 against the JAX fabric's (both round the same f32
buckets to bf16, then average in f32) and its bytes exact; bf16 training
against the JAX step on the loss: rtol 2e-2 after 12 steps of the tiny
transformer, 3e-2 after 60 steps of the MLP (measured ≤ 1.5e-2, sync_dgc):
the forward and backward run in bf16, and XLA keeps some intermediates
of a fused bf16 expression in f32 where PyTorch rounds each to bf16, so
gradients differ by a bf16 ulp on most elements (1e-4 on the master
after one SGD step), and Adam turns a gradient within an ulp of zero into
an update of ±lr; loss scales and overflow flags identical.  The
5-step CLI histories at ``--precision bf16`` and ``bf16-pure`` on a
two-layer, d_model 64 cut of qwen2-1.5b: loss at rtol 1e-3 (the bf16
forward; measured ≤ 2.3e-4 over the three cases), loss scales identical,
wire bytes exact.
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
from repro.configs.base import ModelConfig as JModelConfig
from repro.core import strategies as JST
from repro.core.comm import LocalComm as JLocalComm
from repro.core.compression import get_compressor as jget_compressor
from repro.core.fabric import Fabric as JFabric
from repro.core.precision import apply_policy as japply_policy
from repro.core.precision import get_policy as jget_policy
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import worker_batches as jworker_batches
from repro.optim import optimizers as JO
from repro.train import loop as JLOOP
from repro_torch.bridge import train_state_from_numpy
from repro_torch.configs import get_config as torch_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import strategies as ST
from repro_torch.core import tree as TT
from repro_torch.core.comm import LocalComm
from repro_torch.core.compression import get_compressor
from repro_torch.core.fabric import Fabric
from repro_torch.core.precision import (POLICIES, PrecisionPolicy,
                                        apply_policy, get_policy,
                                        policy_from_spec)
from repro_torch.kernels import fused_adam as FA
from repro_torch.launch import train as CLI
from repro_torch.optim import optimizers as TO
from repro_torch.train import loop as TLOOP

pytestmark = pytest.mark.torch

W = 4


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


def assert_close_to_jax(tree, jtree, atol, rtol=0.0):
    for a, b in zip(TT.leaves(tree), jax.tree.leaves(jtree)):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32), rtol=rtol,
                                   atol=atol)


# ---------------------------------------------------------------------------
# the policy object
# ---------------------------------------------------------------------------
def test_policy_presets_and_spec_roundtrip():
    bf = get_policy("bf16")
    assert bf.param_dt == torch.bfloat16 and bf.master_dt == torch.float32
    assert bf.wire_dt == torch.bfloat16 and bf.keeps_master
    assert bf.uses_scaling and bf.narrow_wire
    assert get_policy(None).is_noop and get_policy("f32").is_noop
    assert not get_policy("bf16-pure").keeps_master
    assert not get_policy("bf16-pure").uses_scaling
    assert policy_from_spec(bf.spec()) == bf
    assert get_policy(bf) is bf
    with pytest.raises(KeyError, match="unknown precision"):
        get_policy("fp8")
    with pytest.raises(ValueError, match="wire_dtype"):
        PrecisionPolicy("bad", wire_dtype="float64")
    # the reference's presets, field for field
    assert sorted(POLICIES) == sorted(["f32", "bf16", "bf16-pure"])
    for name in POLICIES:
        assert get_policy(name).spec() == jget_policy(name).spec()


def test_config_dtype_validated_and_policy_applied():
    with pytest.raises(ValueError, match="param_dtype"):
        ModelConfig(name="bad", param_dtype="float8")
    with pytest.raises(ValueError, match="compute_dtype"):
        dataclasses.replace(ModelConfig(), compute_dtype="tf32")
    for name in POLICIES:
        ours = apply_policy(ModelConfig(), get_policy(name))
        ref = japply_policy(JModelConfig(), jget_policy(name))
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)


def test_scale_helpers_match_reference():
    """``init_scale_state``, ``unscale_grads``, ``tree_finite``,
    ``next_scale_state`` (dynamic backoff and growth, static scale),
    ``select_tree`` and ``cast_floats`` against the reference's on the
    same inputs, bitwise."""
    from repro.core import precision as JP
    from repro_torch.core import precision as TP

    rng = np.random.default_rng(6)
    tree = {"a": rng.standard_normal((3, 5)).astype(np.float32),
            "b": (rng.standard_normal(4) * 1e4).astype(np.float32)}
    tt = TT.tree_map(torch.from_numpy, tree)
    for name in ("bf16", "bf16-pure"):
        pol, jpol = dataclasses.replace(get_policy(name), growth_interval=2), \
            dataclasses.replace(jget_policy(name), growth_interval=2)
        st, jst = TP.init_scale_state(pol), JP.init_scale_state(jpol)
        for finite in (True, True, False, True, False, False):
            st = TP.next_scale_state(pol, st, torch.tensor(finite))
            jst = JP.next_scale_state(jpol, jst, jnp.asarray(finite))
            assert st["scale"].item() == float(jst["scale"])
            assert st["good_steps"].item() == int(jst["good_steps"])
            assert st["scale"].dtype == torch.float32
            assert st["good_steps"].dtype == torch.int32
    for scale in (1.0, 2.0 ** 15, 3.0):
        assert_close_to_jax(TP.unscale_grads(tt, torch.tensor(scale)),
                            JP.unscale_grads(to_jax(tree), scale), 0.0)
    bad = {**tree, "b": np.where(np.arange(4) == 2, np.inf, tree["b"])}
    for t in (tree, bad):
        assert bool(TP.tree_finite(TT.tree_map(torch.from_numpy, t))) \
            == bool(JP.tree_finite(to_jax(t)))
    other = TT.tree_map(torch.neg, tt)
    for pred in (True, False):
        assert_close_to_jax(
            TP.select_tree(torch.tensor(pred), tt, other),
            JP.select_tree(jnp.asarray(pred), to_jax(tree),
                           jax.tree.map(jnp.negative, to_jax(tree))), 0.0)
    cast = TP.cast_floats({**tt, "i": torch.arange(3)}, torch.bfloat16)
    assert cast["a"].dtype == torch.bfloat16 and cast["i"].dtype == torch.int64
    assert_close_to_jax({k: cast[k] for k in tree},
                        JP.cast_floats(to_jax(tree), jnp.bfloat16), 0.0)


# ---------------------------------------------------------------------------
# the reference's MLP problem, both packages
# ---------------------------------------------------------------------------
DIMS = (12, 16, 8, 1)


@pytest.fixture(scope="module")
def mlp():
    rng = np.random.default_rng(0)
    base = {f"w{i}": (0.3 * rng.standard_normal((a, b))).astype(np.float32)
            for i, (a, b) in enumerate(zip(DIMS[:-1], DIMS[1:]))}
    x = rng.standard_normal((W, 32, DIMS[0])).astype(np.float32)
    return base, x, x.sum(-1, keepdims=True)


def tloss(p, batch):
    x, y = batch
    h = x
    for i in range(len(DIMS) - 1):
        h = h @ p[f"w{i}"].to(h.dtype)
        if i < len(DIMS) - 2:
            h = torch.tanh(h)
    return torch.mean((h.float() - y.float()) ** 2)


def jloss(p, batch):
    x, y = batch
    h = x
    for i in range(len(DIMS) - 1):
        h = h @ p[f"w{i}"].astype(h.dtype)
        if i < len(DIMS) - 2:
            h = jnp.tanh(h)
    return jnp.mean((h.astype(jnp.float32) - y.astype(jnp.float32)) ** 2)


def train_port(strat, problem, policy, steps, opt):
    base, x, y = problem
    comm = LocalComm(W)
    pol = None if policy is None else get_policy(policy)
    params = comm.replicate(TT.tree_map(torch.from_numpy, base))
    batch = (torch.from_numpy(x), torch.from_numpy(y))
    if pol is not None:
        params = pol.cast_to_param(params)
        batch = tuple(b.to(pol.compute_dt) for b in batch)
    state = TLOOP.init_train_state(params, opt, strat, comm, policy=pol)
    step = TLOOP.make_replica_train_step(tloss, opt, strat, comm, policy=pol)
    for _ in range(steps):
        state, m = step(state, batch)
    return state, m


def train_jax(strat, problem, policy, steps, opt):
    base, x, y = problem
    comm = JLocalComm(W)
    pol = None if policy is None else jget_policy(policy)
    params = comm.replicate(to_jax(base))
    batch = (jnp.asarray(x), jnp.asarray(y))
    if pol is not None:
        params = pol.cast_to_param(params)
        batch = tuple(b.astype(pol.compute_dt) for b in batch)
    state = JLOOP.init_train_state(params, opt, strat, comm, policy=pol)
    step = JLOOP.make_replica_train_step(jloss, opt, strat, comm, policy=pol)
    for _ in range(steps):
        state, m = step(state, batch)
    return state, m


# (name, port strategy of a policy, the reference's)
SPECTRUM = [
    ("sync", lambda p: ST.sync(policy=p), lambda p: JST.sync(policy=p)),
    ("sync_onebit",
     lambda p: ST.sync(get_compressor("onebit", block=16), policy=p),
     lambda p: JST.sync(_jcomp("onebit", block=16), policy=p)),
    ("sync_dgc",
     lambda p: ST.sync_dgc(get_compressor("topk", ratio=0.25, block=16),
                           policy=p),
     lambda p: JST.sync_dgc(_jcomp("topk", ratio=0.25, block=16), policy=p)),
    ("local_sgd", lambda p: ST.local_sgd(sync_every=4, policy=p),
     lambda p: JST.local_sgd(sync_every=4, policy=p)),
    ("easgd", lambda p: ST.easgd(alpha=0.2, sync_every=3, policy=p),
     lambda p: JST.easgd(alpha=0.2, sync_every=3, policy=p)),
    ("ssp", lambda p: ST.ssp(staleness=3, policy=p),
     lambda p: JST.ssp(staleness=3, policy=p)),
    ("downpour", lambda p: ST.downpour(push_every=4, policy=p),
     lambda p: JST.downpour(push_every=4, policy=p)),
    ("gossip", lambda p: ST.gossip(policy=p), lambda p: JST.gossip(policy=p)),
]
IDS = [c[0] for c in SPECTRUM]


# ---------------------------------------------------------------------------
# the f32 policy is bitwise the policy-less path
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,make,jmake", SPECTRUM, ids=IDS)
def test_f32_policy_bitwise_identical(name, make, jmake, mlp):
    f32 = get_policy("f32")
    s_none, _ = train_port(make(None), mlp, None, 10, TO.adam(0.02))
    s_f32, m = train_port(make(f32), mlp, "f32", 10, TO.adam(0.02))
    assert set(s_f32) == set(s_none)  # no master, no loss scale
    for a, b in zip(TT.leaves((s_none["params"], s_none["opt_state"],
                               s_none["comm_state"])),
                    TT.leaves((s_f32["params"], s_f32["opt_state"],
                               s_f32["comm_state"]))):
        assert torch.equal(a, b)
    js, jm = train_jax(jmake(jget_policy("f32")), mlp, "f32", 10,
                       JO.adam(0.02))
    assert_close_to_jax(s_f32["params"], js["params"], 1e-6, 1e-5)
    assert m["wire_bytes"].item() == float(jm["wire_bytes"])


# ---------------------------------------------------------------------------
# the bf16 wire
# ---------------------------------------------------------------------------
def test_bf16_wire_halves_exchange_bytes():
    rng = np.random.default_rng(1)
    tree = {"a": rng.standard_normal((W, 301)).astype(np.float32),
            "b": rng.standard_normal((W, 13, 7)).astype(np.float32)}
    tt = TT.tree_map(torch.from_numpy, tree)
    f32 = Fabric(LocalComm(W), bucket_bytes=4 * 100)
    bf16 = Fabric(LocalComm(W), bucket_bytes=4 * 100,
                  wire_dtype=torch.bfloat16)
    assert f32.flat_bytes(tt) == 2 * bf16.flat_bytes(tt)
    _, _, m32 = f32.exchange(tt)
    g16, _, m16 = bf16.exchange(tt)
    assert m32["wire_bytes"].item() == 2 * m16["wire_bytes"].item()
    ref = f32.all_mean(tt)
    for k in tree:
        np.testing.assert_allclose(g16[k].numpy(), ref[k].numpy(),
                                   rtol=2e-2, atol=2e-2)
    jfab = JFabric(JLocalComm(W), bucket_bytes=4 * 100,
                   wire_dtype=jnp.bfloat16)
    jg, _, jm = jfab.exchange(to_jax(tree))
    assert m16["wire_bytes"].item() == float(jm["wire_bytes"])
    assert_close_to_jax(g16, jg, 0.0, 1e-6)
    # all_sum and ppermute ride the same narrow wire
    assert_close_to_jax(bf16.all_sum(tt), jfab.all_sum(to_jax(tree)), 0.0,
                        1e-6)
    assert_close_to_jax(bf16.ppermute(tt), jfab.ppermute(to_jax(tree)), 0.0,
                        0.0)
    # the compressors keep their own format
    comp = get_compressor("onebit", block=16)
    assert bf16.wire_bytes(tt, comp) == f32.wire_bytes(tt, comp)


# ---------------------------------------------------------------------------
# loss-scaled bf16 training of a tiny transformer: within 5% of f32
# ---------------------------------------------------------------------------
def test_bf16_transformer_loss_within_5pct_of_f32_and_matches_jax():
    w, steps = 2, 12
    results = {}
    for pname in ("f32", "bf16"):
        over = dict(num_layers=2, d_model=32, num_heads=2, num_kv_heads=1,
                    head_dim=16, d_ff=64, vocab_size=32)
        pol, jpol = get_policy(pname), jget_policy(pname)
        jcfg = dataclasses.replace(japply_policy(
            jax_config("qwen2-1.5b").reduced(), jpol), **over)
        tcfg = dataclasses.replace(apply_policy(
            torch_config("qwen2-1.5b").reduced(), pol), **over)
        dcfg = JDataConfig(vocab_size=32, seq_len=16, batch_per_worker=2)
        jl, tl = (JLOOP.make_loss_fn(jcfg, remat=False),
                  TLOOP.make_loss_fn(tcfg, remat=False))
        policy = None if pol.is_noop else pol
        jpolicy = None if pol.is_noop else jpol
        jcomm, tcomm = JLocalComm(w), LocalComm(w)
        jopt, topt = JO.adam(3e-3), TO.adam(3e-3)
        jstrat, tstrat = JST.sync(policy=jpolicy), ST.sync(policy=policy)
        jstate = JLOOP.init_train_state(
            jcomm.replicate(to_jax(np_params(jcfg, seed=0))), jopt, jstrat,
            jcomm, policy=jpolicy)
        tstate = train_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                        "cpu")
        jstep = JLOOP.make_replica_train_step(
            lambda p, x: jl(p, {"tokens": x, "labels": x}), jopt, jstrat,
            jcomm, policy=jpolicy)
        tstep = TLOOP.make_replica_train_step(
            lambda p, x: tl(p, {"tokens": x, "labels": x}), topt, tstrat,
            tcomm, policy=policy)
        for t in range(steps):
            toks = np.array(jworker_batches(dcfg, w, t))
            jstate, jm = jstep(jstate, jnp.asarray(toks))
            tstate, tm = tstep(tstate, torch.from_numpy(toks))
        results[pname] = tm["loss"].item()
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   rtol=2e-2 if policy else 1e-5)
        if pname == "bf16":
            assert tm["overflow"].item() == float(jm["overflow"]) == 0.0
            assert tstate["params"]["embed"].dtype == torch.bfloat16
            assert tstate["master"]["embed"].dtype == torch.float32
            assert tm["loss_scale"].item() == float(jm["loss_scale"])
    assert np.isfinite(results["bf16"])
    rel = abs(results["bf16"] - results["f32"]) / results["f32"]
    assert rel < 0.05, results


# ---------------------------------------------------------------------------
# the skip-step on an overflow
# ---------------------------------------------------------------------------
def _boom_loss(torch_side):
    if torch_side:
        def loss(p, batch):
            x, boom = batch
            out = torch.mean((x @ p["w"].to(x.dtype)).float() ** 2)
            return out * torch.where(boom > 0, torch.inf, 1.0)
    else:
        def loss(p, batch):
            x, boom = batch
            out = jnp.mean((x @ p["w"].astype(x.dtype)).astype(jnp.float32)
                           ** 2)
            return out * jnp.where(boom > 0, jnp.inf, 1.0)
    return loss


@pytest.mark.parametrize("fused", [False, True], ids=["adam", "adam_fused"])
def test_loss_scale_skip_step_leaves_state_untouched(fused, monkeypatch):
    """An overflow boundary leaves params, master, m, v and the 1-bit
    residual bitwise as they were, runs no Adam update, halves the scale;
    ``growth_interval`` finite steps double it again.  Scales and overflow
    flags as the JAX step's, params at its tolerance."""
    calls = []
    plain = FA.fused_adam_plain
    monkeypatch.setattr(FA, "fused_adam_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    pol = dataclasses.replace(get_policy("bf16"), growth_interval=3)
    jpol = dataclasses.replace(jget_policy("bf16"), growth_interval=3)
    comm, opt = LocalComm(W), TO.adam(0.05, fused=fused)
    strat = ST.sync(get_compressor("onebit", block=16), policy=pol)
    base = np.ones((6, 2), np.float32)
    x = np.ones((W, 4, 6), np.float32)
    x[1, 0, 2] = 0.5  # replicas differ, so the residual is not all zero
    params = pol.cast_to_param(comm.replicate({"w": torch.from_numpy(base)}))
    state = TLOOP.init_train_state(params, opt, strat, comm, policy=pol)
    step = TLOOP.make_replica_train_step(_boom_loss(True), opt, strat, comm,
                                         policy=pol)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    ok, bad = (xb, torch.zeros(W)), (xb, torch.ones(W))

    jcomm, jopt = JLocalComm(W), JO.adam(0.05)
    jstrat = JST.sync(_jcomp("onebit", block=16), policy=jpol)
    jstate = JLOOP.init_train_state(
        jpol.cast_to_param(jcomm.replicate({"w": jnp.asarray(base)})), jopt,
        jstrat, jcomm, policy=jpol)
    jstep = JLOOP.make_replica_train_step(_boom_loss(False), jopt, jstrat,
                                          jcomm, policy=jpol)
    jxb = jnp.asarray(x).astype(jnp.bfloat16)
    jok, jbad = (jxb, jnp.zeros((W,))), (jxb, jnp.ones((W,)))

    state, m = step(state, ok)  # one good step to move off init
    jstate, jm = jstep(jstate, jok)
    scale0 = state["loss_scale"]["scale"].item()
    keys = ("params", "master", "opt_state", "comm_state")
    snap = [x.clone() for x in TT.leaves({k: state[k] for k in keys})]
    assert any(x.abs().max() > 0 for x in
               TT.leaves(state["comm_state"]["residual"]))
    n_calls = len(calls)
    state, m = step(state, bad)  # overflow: a no-op and a backoff
    jstate, jm = jstep(jstate, jbad)
    assert m["overflow"].item() == float(jm["overflow"]) == 1.0
    assert m["loss_scale"].item() == float(jm["loss_scale"]) == scale0
    assert m["comm_events"].item() == 0.0 and m["wire_bytes"].item() == 0.0
    for a, b in zip(TT.leaves({k: state[k] for k in keys}), snap):
        assert torch.equal(a, b)
    assert len(calls) == n_calls  # no Adam update ran
    assert state["loss_scale"]["scale"].item() == scale0 / 2
    assert int(state["loss_scale"]["good_steps"]) == 0
    assert int(state["step"]) == 2
    for _ in range(pol.growth_interval):
        state, m = step(state, ok)
        jstate, jm = jstep(jstate, jok)
        assert m["loss_scale"].item() == float(jm["loss_scale"])
    assert state["loss_scale"]["scale"].item() == scale0 \
        == float(jstate["loss_scale"]["scale"])
    assert not torch.equal(state["master"]["w"], snap[0])
    if fused:
        assert len(calls) > n_calls
    assert_close_to_jax(state["master"], jstate["master"], 1e-5, 1e-5)
    assert_close_to_jax(state["comm_state"], jstate["comm_state"], 1e-5)


# ---------------------------------------------------------------------------
# every strategy of the spectrum trains under bf16
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,make,jmake", SPECTRUM, ids=IDS)
def test_strategy_trains_under_bf16(name, make, jmake, mlp):
    """Finite loss, well below the initial one, bf16 working params, the
    halved wire for the uncompressed gradient exchange; against the JAX
    step after 60 steps."""
    pol = get_policy("bf16")
    state, m = train_port(make(pol), mlp, "bf16", 60, TO.adam(0.02))
    base, x, y = mlp
    init = tloss(TT.tree_map(torch.from_numpy, base),
                 (torch.from_numpy(x[0]), torch.from_numpy(y[0]))).item()
    final = m["loss"].item()
    assert np.isfinite(final) and final < 0.5 * init, (name, final)
    assert state["params"]["w0"].dtype == torch.bfloat16
    assert state["master"]["w0"].dtype == torch.float32
    n = sum(v.size for v in base.values())
    if name == "sync":
        assert m["wire_bytes"].item() == 2 * n * W
        assert m["replica_divergence"].item() == 0.0
    js, jm = train_jax(jmake(jget_policy("bf16")), mlp, "bf16", 60,
                       JO.adam(0.02))
    assert m["wire_bytes"].item() == float(jm["wire_bytes"])
    assert m["loss_scale"].item() == float(jm["loss_scale"])
    np.testing.assert_allclose(final, float(jm["loss"]), rtol=3e-2)


# ---------------------------------------------------------------------------
# optimizers: fused Adam's flag, DC-ASGD
# ---------------------------------------------------------------------------
def test_adam_fused_flag_parity():
    """adam(fused=True) (the kernel's plain version on the CPU) tracks the
    unfused adam leaf for leaf over several steps, non-flat leaves and a
    schedule included, and the JAX package's adam."""
    rng = np.random.default_rng(3)
    tree = {"a": rng.standard_normal(700).astype(np.float32),
            "b": rng.standard_normal((13, 5)).astype(np.float32),
            "nest": {"c": rng.standard_normal((2, 3, 4)).astype(np.float32)}}
    grads = TT.tree_map(lambda v: torch.from_numpy(v * 0.1), tree)
    sched = TO.warmup_cosine(1e-2, warmup=2, total_steps=10)
    pure, fused = TO.adam(sched), TO.adam(sched, fused=True)
    pp = TT.tree_map(torch.from_numpy, tree)
    pf = TT.tree_map(lambda v: torch.from_numpy(v.copy()), tree)
    sp, sf = pure.init(pp), fused.init(pf)
    jopt = JO.adam(JO.warmup_cosine(1e-2, warmup=2, total_steps=10))
    jp = to_jax(tree)
    js = jopt.init(jp)
    for t in range(4):
        pp, sp = pure.update(grads, sp, pp, t)
        pf, sf = fused.update(grads, sf, pf, t)
        jp, js = jopt.update(jax.tree.map(lambda v: v * 0.1, to_jax(tree)),
                             js, jp, jnp.asarray(t, jnp.int32))
    for a, b in zip(TT.leaves((pp, sp)), TT.leaves((pf, sf))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)
    assert_close_to_jax((pf, sf), (jp, js), 1e-6, 1e-5)


def test_delay_compensated_sgd_matches_reference():
    rng = np.random.default_rng(4)
    tree = {"w": rng.standard_normal((3, 5)).astype(np.float32),
            "b": rng.standard_normal(7).astype(np.float32)}
    sched = (TO.warmup_cosine(1e-1, 1, 5), JO.warmup_cosine(1e-1, 1, 5))
    topt = TO.delay_compensated_sgd(sched[0], lam=0.5)
    jopt = JO.delay_compensated_sgd(sched[1], lam=0.5)
    tp = TT.tree_map(torch.from_numpy, tree)
    jp = to_jax(tree)
    ts, js = topt.init(tp), jopt.init(jp)
    for t in range(3):
        g = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in tree.items()}
        # the snapshot the gradient was computed against lags the weights
        if t:
            stale = TT.tree_map(lambda v: v - 0.01, ts["w_bak"])
            ts = {"w_bak": stale}
            js = {"w_bak": jax.tree.map(lambda v: v - 0.01, js["w_bak"])}
        tp, ts = topt.update(TT.tree_map(torch.from_numpy, g), ts, tp, t)
        jp, js = jopt.update(to_jax(g), js, jp, jnp.asarray(t, jnp.int32))
        assert_close_to_jax((tp, ts), (jp, js), 1e-6, 1e-6)
    assert topt.state_floats == jopt.state_floats == 1
    assert ts["w_bak"]["w"] is not tp["w"]  # its own storage


# ---------------------------------------------------------------------------
# the CLI's --precision against the JAX CLI
# ---------------------------------------------------------------------------
def cli_cfgs(policy):
    over = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=1,
                head_dim=32, d_ff=128, vocab_size=256)
    return (japply_policy(dataclasses.replace(
                jax_config("qwen2-1.5b").reduced(), **over), policy),
            apply_policy(dataclasses.replace(
                torch_config("qwen2-1.5b").reduced(), **over), policy))


STEPS = 5


@pytest.mark.parametrize("precision,comp", [("bf16", "none"),
                                            ("bf16", "onebit"),
                                            ("bf16-pure", "none")])
def test_cli_precision_history_matches_jax(precision, comp, monkeypatch):
    """Both CLIs' strategies, policies and optimizers from one initial
    state (the JAX package's bf16 init, master and loss scale, through the
    bridge) over the JAX package's batches."""
    monkeypatch.setattr(JCLI, "get_compressor", _jcomp)
    jcfg, tcfg = cli_cfgs(precision)
    w = 4
    jpol, tpol = jget_policy(precision), get_policy(precision)
    argv = ["--compressor", comp, "--fused-adam", "--precision", precision,
            "--steps", str(STEPS), "--workers", str(w)]
    jargs = JCLI.build_argparser().parse_args(argv)
    targs = CLI.build_argparser().parse_args(argv + ["--device", "cpu"])
    jstrat = JCLI.strategy_from_args(jargs, jpol)
    tstrat = CLI.strategy_from_args(targs, tpol)
    jopt = JO.adam(JO.warmup_cosine(1e-3, 1, STEPS))
    topt = TO.adam(TO.warmup_cosine(1e-3, 1, STEPS), fused=True)
    jcomm, tcomm = JLocalComm(w), LocalComm(w)
    jstate = JLOOP.init_train_state(
        jcomm.replicate(jpol.cast_to_param(to_jax(np_params(jcfg, seed=2)))),
        jopt, jstrat, jcomm, policy=jpol)
    tstate = train_state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    assert set(tstate) == set(jstate)
    assert tstate["params"]["embed"].dtype == torch.bfloat16
    jl = JLOOP.make_loss_fn(jcfg, remat=False)
    tl = TLOOP.make_loss_fn(tcfg, remat=False)
    jstep = JLOOP.make_replica_train_step(
        lambda p, x: jl(p, {"tokens": x, "labels": x}), jopt, jstrat, jcomm,
        policy=jpol)
    tstep = TLOOP.make_replica_train_step(
        lambda p, x: tl(p, {"tokens": x, "labels": x}), topt, tstrat, tcomm,
        policy=tpol)
    dcfg = JDataConfig(vocab_size=jcfg.vocab_size, seq_len=16,
                       batch_per_worker=2)
    for t in range(STEPS):
        toks = np.array(jworker_batches(dcfg, w, t))
        jstate, jm = jstep(jstate, jnp.asarray(toks))
        tstate, tm = tstep(tstate, torch.from_numpy(toks))
        assert tm["wire_bytes"].item() == float(jm["wire_bytes"]), t
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   rtol=1e-3)
        assert ("loss_scale" in tm) == ("loss_scale" in jm)
        if "loss_scale" in tm:
            assert tm["loss_scale"].item() == float(jm["loss_scale"])
            assert tm["overflow"].item() == float(jm["overflow"])
        assert tm["replica_divergence"].item() == 0.0
    if precision == "bf16-pure":
        assert "master" not in tstate and "loss_scale" not in tstate
