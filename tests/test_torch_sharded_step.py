"""The port's sharded step (``train/loop.py::make_sharded_train_step``)
across gloo rank processes on the CPU, against the port's stacked replica
step and against the JAX package's sharded step.

Inputs are made with numpy from a seed: the parameters of a qwen2-1.5b
cut (2 layers, d_model 32, vocab 32), the batches of the port's pipeline
and the JAX package's initial global states (``zero1_opt_template``,
``zero3_param_template``, the residual, the loss scale).  Three sides run
the same cases (``tests/_torch_ranks.py``), 3 steps each, W = 2:

  * the port's ranks: ONE pool of 4 gloo processes, two meshes of 2
    ranks at once (the cases under Adam, and under momentum), each rank
    from its cut of the JAX state (``bridge.sharded_state_from_numpy``);
  * the port's ``make_replica_train_step`` with the matching strategy
    (``sync``, ``sync`` + compressor, ``sync_zero1/2/3``) on a stacked
    ``LocalComm``, in this process: every leaf of every rank's final
    state (params, the master, m, v, residuals) ``torch.equal`` to its
    replica's, and the losses;
  * the JAX package's ``make_sharded_train_step`` on a ``("pod",)`` mesh
    of 2 forced host devices: in f32 the losses at rtol 1e-5 and the
    params at rtol 1e-5 (atol 1e-6); under ``bf16``, ZeRO-1 at accum 2,
    whose second step overflows on rank 0 alone and is skipped by every
    rank, and ZeRO-2/3 at accum 2, under ``tests/test_torch_zero.py``'s
    per-leaf bounds for bf16 momentum.

ZeRO-2/3 at accum 2 under ``bf16`` reduce-scatter each microbatch on the
bf16 wire in the sharded step (the JAX package's sharded step does too)
and on an f32 wire in the replica step (as the JAX package's replica
step), so those two cases are held to the replica step within the same
bounds, and their bytes a step show the 2-byte wire.

The strategies run through the step's strategy path the same way: W = 2
ranks against the stacked ``LocalComm`` run (bitwise) and against the
JAX package's step under the caller's ``shard_map`` (rtol 1e-5), and the
hierarchy (sync inside a pod, gossip across) on the pool's 4 ranks as
2 x 2 against the stacked ``LocalHierComm(2, 2)`` (bitwise) and JAX on a
(2, 2) mesh.  The JAX side runs in two subprocesses at once (the
uncompressed step cases; the compressed ones and the strategies), beside
the rank pool.
"""

import dataclasses
import os
import pickle
import subprocess
import sys
import tempfile

import _torch_model_ranks as MR
import _torch_ranks as R
import jax
import numpy as np
import pytest
import torch
from test_torch_layers import np_params
from test_torch_zero import JAX_BOUNDS, _relnorm, _split

from repro.configs import get_config as jax_config
from repro.core import precision as JPR
from repro.core.compression import ef_init as jef_init
from repro.data import pipeline as JP
from repro.optim import optimizers as JO
from repro.train import loop as JL
from repro_torch.bridge import (params_from_numpy, rank_state,
                                sharded_state_to_numpy, shard_chunks,
                                train_state_to_numpy, unshard_chunks)
from repro_torch.configs import get_config as torch_config
from repro_torch.core import tree as T
from repro_torch.core.comm import LocalHierComm
from repro_torch.data import pipeline as P
from repro_torch.launch.mesh import run_ranks
from repro_torch.train import loop as TL

pytestmark = pytest.mark.torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = 2
# the model-axis cases' cut: 4 heads over 2 kv heads (T = 2 divides both)
TP_OVER = dict(num_heads=4, num_kv_heads=2, tp_degree=MR.TP_DEGREE)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    # module-wide, so that the stacked references of ``runs`` take one
    # thread beside the rank and JAX processes too
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_cfg(precision=None):
    cfg = dataclasses.replace(jax_config("qwen2-1.5b").reduced(), **R.CUT)
    return cfg if precision is None else JPR.apply_policy(
        cfg, JPR.get_policy(precision))


def dcfg():
    return P.DataConfig(vocab_size=R.CUT["vocab_size"], seq_len=R.SEQ,
                        batch_per_worker=R.BPW)


def case_batches(case, world=W):
    """Per step the (W, B, L) (or (accum, W, B, L)) tokens of the port's
    pipeline and the matching "mul" rows (ones; inf on the poisoned
    step, microbatch and rank)."""
    toks, muls = [], []
    for t in range(R.STEPS):
        x = P.microbatch_stack(dcfg(), world, t, case["accum"], "cpu")
        mul = np.ones(x.shape[:-1], np.float32)
        if "poison" in case and case["poison"][0] == t:
            _, j, r = case["poison"]
            mul[j, r] = np.inf
        if case["accum"] == 1:
            x, mul = x[0], mul[0]
        toks.append(x.numpy())
        muls.append(mul)
    return toks, muls


def jax_opt(name):
    return JO.adam(R.LR) if name == "adam" else JO.momentum(R.LR, 0.9)


def jax_init(case, params, opt_name):
    """The JAX package's initial global state of a ``STEP_CASES`` row."""
    prec = case.get("precision")
    pol = None if prec is None else JPR.get_policy(prec)
    opt = jax_opt(opt_name)
    p = params if pol is None else pol.cast_to_param(params)
    st = {"params": p, "comm_state": {}, "step": np.zeros((), np.int32)}
    if case["zero"]:
        st["opt_state"] = JL.zero1_opt_template(
            p, opt, W, R.BB, policy=None if case["zero"] >= 3 else pol)
    else:
        st["opt_state"] = opt.init(p)
    if case["zero"] >= 3:
        st["params"] = JL.zero3_param_template(p, W, R.BB)
    if case.get("comp"):
        st["comm_state"] = {"residual": jef_init(p)}
    if pol is not None and pol.uses_scaling:
        st["loss_scale"] = JPR.init_scale_state(pol)
    return jax.tree.map(np.asarray, st)


JAX_SCRIPT = r'''
import dataclasses, pickle, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.core import precision as PR
from repro.core import strategies as ST
from repro.core.comm import HierComm, ShardComm
from repro.core.compression import get_compressor
from repro.core.jax_compat import set_mesh, shard_map
from repro.optim import optimizers as O
from repro.train import loop as L

inp = pickle.load(open(sys.argv[1], "rb"))
CUT, BB, LR = inp["cut"], inp["bb"], inp["lr"]
_loss = L.make_loss_fn
def _with_mul(cfg, remat=True):  # the tests' loss: times mean(mul)
    f = _loss(cfg, remat=remat)
    return lambda p, b: f(p, b) * jnp.mean(b["mul"])
L.make_loss_fn = _with_mul

def cfg_of(prec):
    c = dataclasses.replace(get_config("qwen2-1.5b").reduced(), **CUT)
    return c if prec is None else PR.apply_policy(c, PR.get_policy(prec))

def comp_of(name):
    return None if name is None else get_compressor(name, **inp["comps"][name])

out = {"steps": {}, "strategies": {}}
mesh2 = Mesh(np.asarray(jax.devices()[:2]), ("pod",))
for name, case in inp.get("step_cases", {}).items():
    prec = case.get("precision")
    pol = None if prec is None else PR.get_policy(prec)
    z = case["zero"]
    init = inp["init"][name + "/momentum"]
    params = inp["params"] if pol is None else jax.tree.map(
        np.asarray, pol.cast_to_param(inp["params"]))
    step = L.make_sharded_train_step(
        cfg_of(prec), O.momentum(LR, 0.9), remat=False, pod_compressor=comp_of(case.get("comp")),
        bucket_bytes=BB, policy=pol, accum_steps=case["accum"], zero_stage=z,
        param_template=params if z >= 3 else None)
    rep, shd = NamedSharding(mesh2, P()), NamedSharding(mesh2, P("pod"))
    ssh = jax.tree.map(lambda _: rep, init)
    if z:
        ssh["opt_state"] = jax.tree.map(lambda _: shd, init["opt_state"])
    if z >= 3:
        ssh["params"] = jax.tree.map(lambda _: shd, init["params"])
    bsh = NamedSharding(mesh2, P("pod") if case["accum"] == 1 else P(None, "pod"))
    st = jax.device_put(init, ssh)
    fn = jax.jit(step, in_shardings=(ssh, {"tokens": bsh, "labels": bsh, "mul": bsh}),
                 out_shardings=(ssh, rep))
    losses = []
    with set_mesh(mesh2):
        for t in range(inp["steps"]):
            x, m = inp["tokens"][name][t], inp["mul"][name][t]
            lead = x.shape[:-3]  # (accum,) or ()
            x = x.reshape(lead + (-1, x.shape[-1]))
            m = m.reshape(lead + (-1,))
            b = {"tokens": jax.device_put(x, bsh), "labels": jax.device_put(x, bsh),
                 "mul": jax.device_put(m, bsh)}
            st, loss = fn(st, b)
            losses.append(float(loss))
    out["steps"][name] = {"losses": losses, "state": jax.tree.map(np.asarray, st)}

def strategy_of(name, kw, comp):
    if name == "hierarchical":
        return ST.hierarchical(ST.sync(bucket_bytes=BB), ST.gossip(bucket_bytes=BB))
    if comp is not None:
        kw = dict(kw, compressor=comp_of(comp))
    return ST.get_strategy(name, bucket_bytes=BB, **kw)

mesh4 = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("pod", "data"))
for case, (name, kw, comp, w) in inp.get("strategy_cases", {}).items():
    hier = name == "hierarchical"
    mesh = mesh4 if hier else mesh2
    axes = ("pod", "data") if hier else ("pod",)
    comm = (HierComm(ShardComm("data", 2), ShardComm("pod", 2)) if hier
            else ShardComm("pod", 2))
    step = L.make_sharded_train_step(cfg_of(None), O.momentum(LR, 0.9),
                                     strategy=strategy_of(name, kw, comp),
                                     comm=comm, remat=False)
    init = inp["strategy_init"][case]  # stacked: replica axis first

    def ax(path):  # ssp's ring leads with its s slots
        return 1 if any(getattr(k, "key", None) == "buf" for k in path) else 0

    specs = jax.tree_util.tree_map_with_path(
        lambda p, _: P(None, axes) if ax(p) else P(axes), init)

    def body(st, b, _p=specs):
        st = jax.tree_util.tree_map_with_path(
            lambda p, x: jnp.squeeze(x, ax(p)), st)
        new, loss = step(st, b)
        new = jax.tree_util.tree_map_with_path(
            lambda p, x: jnp.expand_dims(x, ax(p)), new)
        return new, loss[None]

    fn = jax.jit(shard_map(body, mesh=mesh, axis_names=set(axes),
                           in_specs=(specs, P(axes)), out_specs=(specs, P(axes)),
                           check_vma=False))
    # placed as the outputs come back, so the step compiles once
    st = jax.device_put(init, jax.tree.map(
        lambda sp: NamedSharding(mesh, sp), specs,
        is_leaf=lambda x: isinstance(x, P)))
    bsh = NamedSharding(mesh, P(axes))
    losses = []
    with set_mesh(mesh):
        for t in range(inp["steps"]):
            x = inp["strategy_tokens"][w][t]
            x = jax.device_put(x.reshape((-1, x.shape[-1])), bsh)
            b = {"tokens": x, "labels": x,
                 "mul": jax.device_put(np.ones(x.shape[0], np.float32), bsh)}
            st, loss = fn(st, b)
            losses.append(np.asarray(loss))
    out["strategies"][case] = {"losses": losses,
                               "state": jax.tree.map(np.asarray, st)}

# the model-axis cases: the replica step at tp_degree 2, W = 2, under
# momentum; on the whole tree (its exchange and optimizer are elementwise
# there), and for the 1-bit compressor per (model rank, part), whose
# blocks the split decides (tests/_torch_model_ranks.py::tp_replica_run)
from repro.core.comm import LocalComm
from repro.models.tensor_parallel import (_merge_trees, _partition_replicated,
                                          tp_split_params, tp_unsplit_params)
out["tp"] = {}
lcomm = LocalComm(2)

def stack2(tree):
    return jax.tree.map(lambda x: jnp.stack([x, x]), tree)

for name, case in inp.get("tp_cases", {}).items():
    prec = case.get("precision")
    pol = None if prec is None else PR.get_policy(prec)
    cfg = dataclasses.replace(cfg_of(prec), **inp["tp_over"])
    params = inp["tp_params"] if pol is None else jax.tree.map(
        np.asarray, pol.cast_to_param(inp["tp_params"]))
    z = case["zero"]
    opt = O.momentum(LR, 0.9)
    lf = L.make_loss_fn(cfg, remat=False)

    def strat_of():
        return (ST.get_strategy(f"sync_zero{z}", bucket_bytes=BB, policy=pol)
                if z else ST.sync(comp_of(case.get("comp")), bucket_bytes=BB,
                                  policy=pol))

    def batch_of(t, extra=None):
        x, m = inp["tp_tokens"][name][t], inp["tp_mul"][name][t]
        b = {"tokens": x, "labels": x, "mul": m}
        if extra is not None:
            b["others"] = extra
        return b

    losses = []
    if not case.get("comp"):
        strat = strat_of()
        st = L.init_train_state(stack2(params), opt, strat, lcomm, policy=pol)
        step = L.make_replica_train_step(lf, opt, strat, lcomm, policy=pol,
                                         accum_steps=case["accum"],
                                         bucket_bytes=BB)
        for t in range(inp["steps"]):
            st, m = step(st, batch_of(t))
            losses.append(float(m["loss"]))
        full = (strat.gather_params(st["params"], lcomm)
                if getattr(strat, "owns_params", False) else st["params"])
        finals = [jax.tree.map(lambda x: np.asarray(x[w]), full)
                  for w in range(2)]
    else:
        shards = tp_split_params(params, 2)
        runs = {}
        for mm in range(2):
            rep, split = _partition_replicated(
                jax.tree.map(lambda v: v[mm], shards), "stack")
            for n, tree in (("rep", rep), ("split", split)):
                strat = strat_of()

                def loss(p, b, mm=mm, n=n):
                    trees = [_merge_trees(
                        p if n == "rep" else b["others"][r]["rep"],
                        p if (n == "split" and r == mm)
                        else b["others"][r]["split"]) for r in range(2)]
                    full = tp_unsplit_params(
                        jax.tree.map(lambda *xs: jnp.stack(xs), *trees))
                    return lf(full, b)

                runs[(mm, n)] = [
                    L.init_train_state(stack2(tree), opt, strat, lcomm),
                    L.make_replica_train_step(loss, opt, strat, lcomm,
                                              bucket_bytes=BB, donate=False)]
        for t in range(inp["steps"]):
            others = [{n: runs[(r, n)][0]["params"] for n in ("rep", "split")}
                      for r in range(2)]
            for key, run in runs.items():
                run[0], m = run[1](run[0], batch_of(t, others))
            losses.append(float(m["loss"]))
        finals = []
        for w in range(2):
            trees = [_merge_trees(
                jax.tree.map(lambda x: x[w], runs[(r, "rep")][0]["params"]),
                jax.tree.map(lambda x: x[w], runs[(r, "split")][0]["params"]))
                for r in range(2)]
            finals.append(jax.tree.map(np.asarray, tp_unsplit_params(
                jax.tree.map(lambda *xs: jnp.stack(xs), *trees))))
    out["tp"][name] = {"losses": losses, "params": finals}
pickle.dump(out, open(sys.argv[2], "wb"))
print("JAX_SIDE_OK")
'''


def _strategy_tokens(world):
    return [P.worker_batches(dcfg(), world, t, "cpu").numpy()
            for t in range(R.STEPS)]


def _case_optimizers(case):
    return (("momentum",) if R.narrow_microbatch_wire(case)
            else R.STEP_OPTIMIZERS)


def _start_jax(tmp, part, inputs):
    """The JAX side of ``inputs``' cases in a subprocess of its own, with
    4 forced host devices."""
    src = os.path.join(tmp, f"{part}.in.pkl")
    dst = os.path.join(tmp, f"{part}.out.pkl")
    with open(src, "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=os.environ.get("XLA_FLAGS", "")
               + " --xla_force_host_platform_device_count=4")
    proc = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, src, dst],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, dst


@pytest.fixture(scope="module")
def runs():
    """Every side's results: two JAX subprocesses and the port's rank pool
    run at the same time; the stacked references run here meanwhile."""
    jcfg = jax_cfg()
    params = np_params(jcfg, seed=3)
    tokens, muls, init = {}, {}, {}
    for name, case in R.STEP_CASES.items():
        tokens[name], muls[name] = case_batches(case)
        for opt in _case_optimizers(case):
            init[f"{name}/{opt}"] = jax_init(case, params, opt)
    s_tokens = {w: _strategy_tokens(w) for w in (2, 4)}
    s_init = {c: train_state_to_numpy(R.strategy_init(params, c))
              for c in R.STRATEGY_CASES}
    for c, (name, *_) in R.STRATEGY_CASES.items():
        if name == "hierarchical":  # (2, 2, ...) -> one replica axis
            s_init[c] = jax.tree.map(
                lambda x: x.reshape((4,) + x.shape[2:]) if x.ndim >= 2
                else x, s_init[c])
            s_init[c]["step"] = np.zeros((4,), np.int32)
        else:
            s_init[c]["step"] = np.zeros((2,), np.int32)
    tp_params = np_params(dataclasses.replace(jcfg, **TP_OVER), seed=5)
    tp_tokens, tp_muls = {}, {}
    for name, case in MR.TP_STEP_CASES.items():
        tp_tokens[name], tp_muls[name] = case_batches(case)
    tp_inputs = {"params": tp_params, "tokens": tp_tokens, "mul": tp_muls}
    tmp = tempfile.mkdtemp(prefix="sharded-step-")
    common = {"cut": R.CUT, "bb": R.BB, "lr": R.LR, "steps": R.STEPS,
              "comps": R.COMPRESSORS, "params": params}
    # two halves of about the same time: the compressed step cases go
    # with the strategies
    compressed = {n for n, c in R.STEP_CASES.items() if c.get("comp")}
    procs = [_start_jax(tmp, f"part{i}", dict(
        common, step_cases={n: c for n, c in R.STEP_CASES.items()
                            if (n in compressed) == bool(i)},
        tokens=tokens, mul=muls,
        init={k: v for k, v in init.items() if k.endswith("/momentum")},
        **(dict(strategy_cases=R.STRATEGY_CASES, strategy_init=s_init,
                strategy_tokens=s_tokens) if i else {})))
        for i in range(2)]
    procs.append(_start_jax(tmp, "tp", dict(
        common, tp_cases=MR.TP_STEP_CASES, tp_over=TP_OVER,
        tp_params=tp_params, tp_tokens=tp_tokens, tp_mul=tp_muls)))
    jax_out = {"steps": {}, "strategies": {}, "tp": {}}
    try:
        pool = run_ranks(R.pool_cases, 4, args=(
            {"params": params, "strategy_tokens": s_tokens, "init": init,
             "tokens": tokens, "mul": muls, "tp": tp_inputs},),
            device="cpu", timeout=500)
        tp_ranks = [pool[r]["tp"] for r in range(4)]
        tp_replica = {f"{n}/{o}": MR.tp_replica_run(
            tp_params, n, o, tp_tokens[n], tp_muls[n])
            for n, c in MR.TP_STEP_CASES.items()
            for o in MR.tp_optimizers(c)}
        # ranks 0-1 ran the Adam cases, 2-3 the momentum ones
        ranks = [dict(pool[r]["steps"], **pool[r + 2]["steps"])
                 for r in range(W)]
        s_ranks = {2: [pool[r]["strategies"] for r in range(2)],
                   4: [pool[r]["strategies"] for r in range(4)]}
        replica = R.replica_step_cases(params, {"tokens": tokens,
                                                "mul": muls}, W)
        s_replica = R.strategy_replica_cases(params, s_tokens[2], 2)
        s_replica.update(_hier_replica(params, s_tokens[4]))
        for proc, dst in procs:
            out, err = proc.communicate(timeout=500)
            assert proc.returncode == 0 and "JAX_SIDE_OK" in out, \
                err[-3000:]
            with open(dst, "rb") as f:
                for part, got in pickle.load(f).items():
                    jax_out[part].update(got)
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return {"ranks": ranks, "replica": replica, "jax": jax_out,
            "params": params, "init": init, "s_ranks": s_ranks,
            "s_replica": s_replica, "tp_ranks": tp_ranks,
            "tp_replica": tp_replica, "tp_params": tp_params}


def _hier_replica(params, tokens):
    """The hierarchy's stacked reference on ``LocalHierComm(2, 2)``: the
    replica step's loop written out for a (P, W) stack (per-replica
    gradients, then the strategy), rank r = pod * 2 + worker."""
    case = "hier_sync_gossip"
    name, kw, comp, w = R.STRATEGY_CASES[case]
    cfg = R.torch_cfg()
    comm, opt = LocalHierComm(2, 2), R.optimizer("momentum")
    strat = R.strategy(name, kw, comp)
    state = R.strategy_init(params, case)
    lf = R.loss_with_mul(cfg)
    losses = []
    for t in range(R.STEPS):
        toks = torch.from_numpy(tokens[t])
        flat = T.tree_map(lambda x: x.reshape((4,) + x.shape[2:]),
                          state["params"])
        loss, grads = TL._replica_grads(
            lf, flat, {"tokens": toks, "labels": toks,
                       "mul": torch.ones(4, R.BPW)})
        grads = T.tree_map(lambda g: g.reshape((2, 2) + g.shape[1:]), grads)
        params, opt_state, cstate, _ = strat.update(
            state["params"], grads, state["opt_state"],
            state["comm_state"], t, opt, comm)
        state = {"params": params, "opt_state": opt_state,
                 "comm_state": cstate, "step": state["step"] + 1}
        losses.append(loss.mean())
    state = {k: (T.tree_map(lambda x: x.reshape((4,) + x.shape[2:]), v)
                 if k != "step" else v) for k, v in state.items()}
    return {case: {"ranks": [rank_state(state, r) for r in range(4)],
                   "losses": losses}}


def _equal_states(a, b):
    la, ta = T.flatten({k: v for k, v in a.items() if k != "step"})
    lb, tb = T.flatten({k: v for k, v in b.items() if k != "step"})
    assert ta == tb
    bad = [i for i, (x, y) in enumerate(zip(la, lb))
           if not (x.dtype == y.dtype and torch.equal(x, y))]
    assert not bad, f"{len(bad)} of {len(la)} leaves differ"
    assert int(a["step"]) == int(b["step"])


# ---------------------------------------------------------------------------
# the step against the stacked replica step: bitwise
# ---------------------------------------------------------------------------
BITWISE_CASES = sorted(c for c, k in R.STEP_CASES.items()
                       if not R.narrow_microbatch_wire(k))
NARROW_CASES = sorted(c for c, k in R.STEP_CASES.items()
                      if R.narrow_microbatch_wire(k))


@pytest.mark.parametrize("case", BITWISE_CASES)
def test_sharded_step_bitwise_replica_step(runs, case):
    rep = runs["replica"][case]
    for r in range(W):
        got = runs["ranks"][r][case + "/adam"]
        _equal_states(got["state"], rep["ranks"][r])
        assert all(torch.equal(a, b.cpu()) for a, b in zip(got["losses"],
                                                            rep["losses"]))
        assert got["same_init"]  # the bridge's cut = init_sharded_state


# ---------------------------------------------------------------------------
# the step against the JAX package's sharded step
# ---------------------------------------------------------------------------
def _global(runs, case):
    zero = R.STEP_CASES[case]["zero"]
    return sharded_state_to_numpy(
        [runs["ranks"][r][case + "/momentum"]["state"] for r in range(W)],
        zero)


@pytest.mark.parametrize("case", sorted(c for c in R.STEP_CASES
                                        if "precision" not in R.STEP_CASES[c]))
def test_sharded_step_matches_jax_f32(runs, case):
    want = runs["jax"]["steps"][case]
    got = _global(runs, case)
    losses = [float(x)
              for x in runs["ranks"][0][case + "/momentum"]["losses"]]
    np.testing.assert_allclose(losses, want["losses"], rtol=1e-5)
    assert jax.tree.structure(got) == jax.tree.structure(want["state"])
    for a, b in zip(jax.tree.leaves(got["params"]),
                    jax.tree.leaves(want["state"]["params"])):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    assert int(got["step"]) == int(want["state"]["step"]) == R.STEPS


def _hold_to_bf16_bounds(got, want, init, bound):
    """``got`` against ``want`` (global states of the JAX package's
    layout) under the bf16 bounds: the f32 master within ``master`` of
    it, its move since ``init`` within ``move`` of the other's (and the
    other's move well above the master bound), and the optimizer's state
    within ``state``."""
    (gm, _, go), (wm, _, wo), (im, _, _) = (_split(s)
                                            for s in (got, want, init))
    for a, b, a0 in zip(gm, wm, im):
        np.testing.assert_allclose(a, b, rtol=0, atol=bound["master"])
        assert np.abs(b - a0).max() > 5 * bound["master"]
        assert _relnorm(a - a0, b - a0) <= bound["move"]
    for a, b in zip(jax.tree.leaves(go), jax.tree.leaves(wo)):
        assert _relnorm(a, b) <= bound["state"], _relnorm(a, b)


def test_zero1_bf16_skip_matches_jax_and_every_rank_skips(runs):
    case = "zero1_bf16_skip"
    bound = JAX_BOUNDS[("bf16", "momentum")]
    want = runs["jax"]["steps"][case]
    got = _global(runs, case)
    losses = [float(x)
              for x in runs["ranks"][0][case + "/momentum"]["losses"]]
    assert np.isinf(losses[1]) and np.isinf(want["losses"][1])
    np.testing.assert_allclose([losses[0], losses[2]],
                               [want["losses"][0], want["losses"][2]],
                               rtol=bound["loss"])
    # the overflow on rank 0 halved every rank's scale, as JAX's
    for r in range(W):
        st = runs["ranks"][r][case + "/momentum"]["state"]
        assert float(st["loss_scale"]["scale"]) \
            == float(want["state"]["loss_scale"]["scale"])
    _hold_to_bf16_bounds(got, want["state"], runs["init"][case + "/momentum"],
                         bound)


@pytest.mark.parametrize("case", NARROW_CASES)
def test_narrow_microbatch_wire_matches_jax_and_replica(runs, case):
    """ZeRO-2/3 at accum 2 under bf16: the JAX package's sharded step and
    the port's replica step (whose microbatch wire is f32), both within
    the bf16 momentum bounds."""
    bound = JAX_BOUNDS[("bf16", "momentum")]
    zero = R.STEP_CASES[case]["zero"]
    got = _global(runs, case)
    init = runs["init"][case + "/momentum"]
    want = runs["jax"]["steps"][case]
    rep = runs["replica"][case]
    losses = [float(x)
              for x in runs["ranks"][0][case + "/momentum"]["losses"]]
    np.testing.assert_allclose(losses, want["losses"], rtol=bound["loss"])
    np.testing.assert_allclose(losses, [float(x) for x in rep["losses"]],
                               rtol=bound["loss"])
    _hold_to_bf16_bounds(got, want["state"], init, bound)
    _hold_to_bf16_bounds(got, sharded_state_to_numpy(rep["ranks"], zero),
                         init, bound)


def test_skipped_step_writes_nothing_on_any_rank(runs):
    """Step 1 of the bf16 case overflows on rank 0 only: every rank skips
    it (params, master, m, v unchanged), ships no bucket, and the other
    steps move the state."""
    case = "zero1_bf16_skip"
    for r in range(W):
        got = runs["ranks"][r][case + "/adam"]
        assert got["unchanged"] == [False, True, False]
        stats = got["stats"]
        assert _per_step(stats, 1, "all_to_all") == (0, 0)
        assert _per_step(stats, 1, "all_gather") == (0, 0)
        assert _per_step(stats, 1, "all_min")[0] == 1
        assert _per_step(stats, 0, "all_to_all")[0] > 0


# ---------------------------------------------------------------------------
# what the step shipped
# ---------------------------------------------------------------------------
def _per_step(stats, t, op):
    now = stats[t].get(op, (0, 0))
    before = stats[t - 1].get(op, (0, 0)) if t else (0, 0)
    return now[0] - before[0], now[1] - before[1]


@pytest.mark.parametrize("case", ["sync", "zero1", "zero2_a2", "onebit",
                                  "topk", "zero2_bf16_a2"])
def test_collectives_and_bytes_a_step_are_the_closed_form(runs, case):
    from repro_torch.core.fabric import (BucketLayout, PartitionedLayout,
                                         wire_nbytes)

    spec = R.STEP_CASES[case]
    params = params_from_numpy(runs["params"], "cpu")
    lay = BucketLayout.build(params, R.BB)
    play = PartitionedLayout.build(lay, W)
    nb = lay.n_buckets
    width = 2 if spec.get("precision") == "bf16" else 4  # wire bytes
    opt = "momentum" if R.narrow_microbatch_wire(spec) else "adam"
    stats = runs["ranks"][0][f"{case}/{opt}"]["stats"]
    for t in range(R.STEPS):
        a2a, ag = _per_step(stats, t, "all_to_all"), \
            _per_step(stats, t, "all_gather")
        if spec.get("comp"):
            comp = R.compressor(spec["comp"])
            assert a2a == (0, 0)
            assert ag == (nb, sum(wire_nbytes(comp, n)
                                  for n in lay.bucket_sizes))
        elif spec["zero"] >= 2 and spec["accum"] > 1:
            # a reduce-scatter a microbatch, one all-gather a boundary
            assert a2a == (spec["accum"] * nb, spec["accum"] * width
                           * sum(play.padded_sizes))
            assert ag == (nb, width * sum(play.shard_sizes))
        else:  # the all-mean: an all-to-all and an all-gather a bucket
            assert a2a[0] == nb and ag[0] == nb
            assert a2a[1] == 4 * sum(play.padded_sizes)
            assert ag[1] == 4 * sum(play.shard_sizes)
        assert _per_step(stats, t, "scalars")[0] == 1  # the losses


# ---------------------------------------------------------------------------
# the strategies over ShardComm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", sorted(R.STRATEGY_CASES))
def test_strategy_bitwise_stacked_run(runs, case):
    w = R.STRATEGY_CASES[case][3]
    rep = runs["s_replica"][case]
    for r in range(w):
        got = runs["s_ranks"][w][r][case]
        _equal_states(got["state"], rep["ranks"][r])
        assert all(torch.equal(a, b) for a, b in zip(got["losses"],
                                                     rep["losses"]))


@pytest.mark.parametrize("case", sorted(R.STRATEGY_CASES))
def test_strategy_matches_jax_under_shard_map(runs, case):
    w = R.STRATEGY_CASES[case][3]
    want = runs["jax"]["strategies"][case]
    states = [train_state_to_numpy(runs["s_ranks"][w][r][case]["state"])
              for r in range(w)]
    for r in range(w):
        for a, b in zip(jax.tree.leaves(states[r]["params"]),
                        jax.tree.leaves(want["state"]["params"])):
            np.testing.assert_allclose(a, b[r], rtol=1e-5, atol=1e-6)
    # the port's loss is the rank mean; JAX's step returns each rank's
    losses = [float(x) for x in runs["s_ranks"][w][0][case]["losses"]]
    np.testing.assert_allclose(losses, [float(np.mean(x))
                                        for x in want["losses"]],
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# data, bridge, errors
# ---------------------------------------------------------------------------
def test_global_batch_and_rank_rows():
    d = dcfg()
    g = P.global_batch(d, 5, 3 * R.BPW, "cpu")
    stacked = P.worker_batches(d, 3, 5, "cpu")
    assert g.shape == (3 * R.BPW, R.SEQ) and g.dtype == torch.int32
    assert torch.equal(g, stacked.reshape(-1, R.SEQ))
    for r in range(3):
        assert torch.equal(P.rank_batch(d, r, 5, device="cpu"),
                           P.sample_batch(d, r, 5, "cpu"))
        assert torch.equal(P.rank_batch(d, r, 5, device="cpu"),
                           g[r * R.BPW:(r + 1) * R.BPW])
        mb = P.microbatch_stack(d, 3, 2, 2, "cpu")
        assert torch.equal(P.rank_batch(d, r, 2, 2, "cpu"), mb[:, r])
    # JAX's global_batch is the same layout of its own workers' rows
    jd = JP.DataConfig(vocab_size=d.vocab_size, seq_len=d.seq_len,
                       batch_per_worker=d.batch_per_worker)
    jg = np.asarray(JP.global_batch(jd, 5, 3 * R.BPW))
    jw = np.asarray(JP.worker_batches(jd, 3, 5))
    assert jg.shape == tuple(g.shape)
    np.testing.assert_array_equal(jg, jw.reshape(-1, R.SEQ))


def test_bridge_cuts_and_joins_shard_buckets(runs):
    init = runs["init"]["zero3_a2/adam"]
    for key in ("params", "opt_state"):
        glob = params_from_numpy(init[key], "cpu")
        parts = [shard_chunks(glob, r, W) for r in range(W)]
        for a, b in zip(T.leaves(unshard_chunks(parts)), T.leaves(glob)):
            assert torch.equal(a, b)
        for r in range(W):
            for a, b in zip(T.leaves(parts[r]), T.leaves(glob)):
                c = b.shape[-1] // W
                assert torch.equal(a, b[..., r * c:(r + 1) * c])


def test_model_axis_and_bad_arguments_raise():
    """A "model" axis builds a step for what its split covers: a Mamba
    layer (jamba), an encoder-decoder stack, ``cp`` on attention stacks
    with dense-MLP or MoE FFNs and on an encoder-decoder, and a strategy;
    ``cp`` with a Mamba layer raises before any collective, naming
    ROADMAP; so do bad arguments."""
    import types

    class _Mesh:  # building a step makes comms and reads sizes only
        sizes = {"data": 2, "model": 2}
        axes = ("data", "model")
        coords = {"data": 0, "model": 0}

        def comm(self, axes):
            return types.SimpleNamespace(size=2)

        shared_comm = comm

    jamba = dataclasses.replace(
        torch_config("jamba-1.5-large-398b").reduced(), num_experts=0)
    seamless = torch_config("seamless-m4t-medium").reduced()
    for cfg in (jamba, seamless,
                dataclasses.replace(R.torch_cfg(), sharding_mode="cp")):
        assert callable(TL.make_sharded_train_step(cfg, R.optimizer(),
                                                   _Mesh()))
    assert callable(TL.make_sharded_train_step(
        R.torch_cfg(), R.optimizer(), _Mesh(),
        strategy=R.strategy("gossip", {}, None), comm=_Mesh().comm("data")))
    moe = torch_config("granite-moe-1b-a400m").reduced()
    for cfg in (moe, seamless):
        assert callable(TL.make_sharded_train_step(
            dataclasses.replace(cfg, sharding_mode="cp"), R.optimizer(),
            _Mesh()))
    with pytest.raises(NotImplementedError, match="cp") as err:
        TL.make_sharded_train_step(
            dataclasses.replace(jamba, sharding_mode="cp"), R.optimizer(),
            _Mesh())
    assert "mamba" in str(err.value) and "ROADMAP" in str(err.value)
    cfg = R.torch_cfg()
    with pytest.raises(ValueError, match="zero_stage"):
        TL.make_sharded_train_step(cfg, R.optimizer(), _Mesh(),
                                   zero_stage=4)
    with pytest.raises(ValueError, match="param_template"):
        TL.make_sharded_train_step(cfg, R.optimizer(), _Mesh(),
                                   zero_stage=3)


# ---------------------------------------------------------------------------
# the model axis: data 2 x model 2
# ---------------------------------------------------------------------------
# the ranks against the port's replica step at tp_degree 2 (run per model
# rank and part, tests/_torch_model_ranks.py::tp_replica_run), each data
# rank's unsplit params after 3 steps.  The TP gradients differ from the
# blocked form's by ulps (the residual stream's cotangent summed in
# another association, test_torch_tp.py), which no case here absorbs
# bitwise: momentum carries them linearly; Adam turns a gradient of
# rounding noise (bk's, zero in exact arithmetic) into steps of ~lr; a
# 1-bit block whose element sat near 0 flips a sign; bf16's backward
# rounds them into bf16 ulps.  Each case's bound: (every element within
# atol, the share of elements beyond 1e-6 at most share, losses at rtol),
# beside its reading on the CPU [max |d|, share, loss |d|]:
TP_BOUNDS = {
    ("f32", "momentum"): (1e-7, 0.0, 1e-6),       # [3.0e-8, 0, 4.8e-7]
    ("f32", "adam"): (2e-3, 2e-3, 1e-6),          # [1.0e-3, 8.8e-4, 0]
    ("onebit", "momentum"): (2e-3, 2e-2, 1e-4),   # [7.2e-4, 6.9e-3, 6.8e-5]
    ("onebit", "adam"): (2e-2, 2e-2, 1e-4),       # [8.2e-3, 6.5e-3, 3.4e-5]
    ("bf16", "momentum"): (5e-3, 5e-2, 1e-3),     # [2.0e-3, 2.3e-2, 1.4e-3]
}
# against the JAX package's replica step, momentum: f32 at rtol 1e-5,
# atol 1e-6 [6.0e-8]; the 1-bit and bf16 cases at the bounds above (the
# same elements part: JAX's run is the port's replica run to 1e-7)


def _kind(name):
    case = MR.TP_STEP_CASES[name]
    return "onebit" if case.get("comp") else (case.get("precision")
                                              or "f32")


def _within(got, want, atol, share):
    """Every element of the leaves within ``atol``, and at most ``share``
    of them beyond 1e-6."""
    n = beyond = 0
    for a, b in zip(got, want):
        d = np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))
        assert d.max() <= atol, (d.max(), atol)
        n, beyond = n + d.size, beyond + int((d > 1e-6).sum())
    assert beyond <= share * n, (beyond, n, share)


TP_RUNS = sorted(f"{n}/{o}" for n, c in MR.TP_STEP_CASES.items()
                 for o in MR.tp_optimizers(c))


def _tp_params(runs, key, d):
    """Data rank d's full params: its model ranks' shards unsplit."""
    from repro_torch.models.tensor_parallel import tp_unsplit_ranks

    return tp_unsplit_ranks([runs["tp_ranks"][d * 2 + m][key]["params"]
                             for m in range(MR.TP_DEGREE)])


@pytest.mark.parametrize("key", TP_RUNS)
def test_model_axis_step_matches_the_replica_step(runs, key):
    name, opt = key.split("/")
    atol, share, loss_rtol = TP_BOUNDS[(_kind(name), opt)]
    rep = runs["tp_replica"][key]
    for d in range(W):
        got = _tp_params(runs, key, d)
        for a, b in zip(T.leaves(got), T.leaves(rep["params"][d])):
            assert a.dtype == b.dtype and a.shape == b.shape
        _within([a.float() for a in T.leaves(got)],
                [b.float() for b in T.leaves(rep["params"][d])], atol, share)
    for r in range(4):  # the same loss on every rank of the mesh
        assert all(torch.equal(x, y) for x, y in zip(
            runs["tp_ranks"][r][key]["losses"],
            runs["tp_ranks"][0][key]["losses"]))
    np.testing.assert_allclose(
        [float(x) for x in runs["tp_ranks"][0][key]["losses"]],
        [float(x) for x in rep["losses"]], rtol=loss_rtol)


@pytest.mark.parametrize("name", sorted(MR.TP_STEP_CASES))
def test_model_axis_step_matches_jax_replica_step(runs, name):
    """Against the JAX package's replica step at tp_degree 2, W = 2, under
    momentum (for the 1-bit case per model rank and part, as the port's
    reference): f32 at rtol 1e-5 (atol 1e-6); the 1-bit and bf16 cases at
    ``TP_BOUNDS``."""
    kind = _kind(name)
    want = runs["jax"]["tp"][name]
    key = f"{name}/momentum"
    atol, share, loss_rtol = TP_BOUNDS[(kind, "momentum")]
    for d in range(W):
        got = [a.float().numpy() for a in T.leaves(_tp_params(runs, key, d))]
        ref = [np.asarray(b, np.float32)
               for b in jax.tree.leaves(want["params"][d])]
        assert len(got) == len(ref)
        if kind == "f32":
            for a, b in zip(got, ref):
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
        else:
            _within(got, ref, atol, share)
    np.testing.assert_allclose(
        [float(x) for x in runs["tp_ranks"][0][key]["losses"]],
        want["losses"], rtol=1e-5 if kind == "f32" else loss_rtol)


def test_model_axis_keeps_replicated_leaves_equal_and_counts(runs):
    """Every case: the replicated leaves bitwise equal on the two model
    ranks of a data rank (each part's buckets its own); one all-sum a
    sub-layer a layer forward and backward a microbatch; the batch
    group's all-mean one all-to-all and one all-gather a bucket of each
    part (sync), and the state in two parts."""
    from repro_torch.core.fabric import BucketLayout
    from repro_torch.models.tensor_parallel import (_partition_replicated,
                                                    tp_rank_params)

    full = params_from_numpy(runs["tp_params"], "cpu")
    parts = _partition_replicated(tp_rank_params(full, 2, 0))
    nb = sum(BucketLayout.build(p, R.BB).n_buckets for p in parts)
    layers = R.CUT["num_layers"]
    for key in TP_RUNS:
        name = key.split("/")[0]
        case = MR.TP_STEP_CASES[name]
        for d in range(W):
            reps = [_partition_replicated(
                runs["tp_ranks"][d * 2 + m][key]["params"])[0]
                for m in range(2)]
            assert all(torch.equal(a, b) for a, b in zip(
                T.leaves(reps[0]), T.leaves(reps[1]))), (key, d)
        got = runs["tp_ranks"][0][key]
        assert got["model_ops"]["psum"][0] == \
            2 * 2 * layers * case["accum"] * R.STEPS
        if case["zero"] < 3:
            assert got["parts"] == ["rep", "split"]
        if name == "tp_sync":
            assert got["stats"]["all_to_all"][0] == nb * R.STEPS
            assert got["stats"]["all_gather"][0] == nb * R.STEPS
