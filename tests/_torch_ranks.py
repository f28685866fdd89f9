"""Rank programs of the port's multi-process tests.

``tests/test_torch_shard.py`` and ``tests/test_torch_sharded_step.py``
start these module-level functions in gloo rank processes on the CPU
(``repro_torch/launch/mesh.py::run_ranks``); each runs every case of its
test file in one pool and returns the results, which the tests read.
Torch only: a rank process imports neither JAX nor the JAX package.  The
case tables live here so that the parent (the JAX side and the stacked
``LocalComm`` references) and the ranks read one definition.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.bridge import (params_from_numpy, rank_state,
                                sharded_state_from_numpy)
from repro_torch.configs import get_config
from repro_torch.core import strategies as ST
from repro_torch.core import tree as T
from repro_torch.core.comm import (LocalComm, LocalHierComm, ShardComm,
                                   ShardHierComm)
from repro_torch.core.compression import get_compressor
from repro_torch.core.fabric import Fabric
from repro_torch.core.precision import apply_policy, get_policy
from repro_torch.launch.mesh import make_mesh
from repro_torch.optim import optimizers as TO
from repro_torch.train import loop as TL

# the model: qwen2-1.5b cut to 2 layers, d_model 32, vocab 32
CUT = dict(num_layers=2, d_model=32, d_ff=64, vocab_size=32, head_dim=16,
           num_heads=2, num_kv_heads=1)
SEQ, BPW, STEPS, LR = 16, 2, 3, 1e-2
BB = 1 << 12  # buckets of 1024 f32: the cut's ~12k params span several
COMPRESSORS = {"onebit": dict(block=64), "topk": dict(ratio=0.1, block=64)}

# make_sharded_train_step cases (W = 2): zero stage, accum, compressor,
# precision, and the (step, microbatch, rank) whose loss is made inf.
# ZeRO-2 at accum 1 is ZeRO-1's body in both packages, so it has no case.
STEP_CASES = {
    "sync": dict(zero=0, accum=1),
    "sync_a2": dict(zero=0, accum=2),
    "zero1": dict(zero=1, accum=1),
    "zero1_a2": dict(zero=1, accum=2),
    "zero2_a2": dict(zero=2, accum=2),
    "zero3": dict(zero=3, accum=1),
    "zero3_a2": dict(zero=3, accum=2),
    "onebit": dict(zero=0, accum=1, comp="onebit"),
    "topk": dict(zero=0, accum=2, comp="topk"),
    "zero1_bf16_skip": dict(zero=1, accum=2, precision="bf16",
                            poison=(1, 0, 0)),
    "zero2_bf16_a2": dict(zero=2, accum=2, precision="bf16"),
    "zero3_bf16_a2": dict(zero=3, accum=2, precision="bf16"),
}


def narrow_microbatch_wire(case) -> bool:
    """ZeRO-2/3 at accum > 1 under bf16: the sharded step reduce-scatters
    each microbatch on the bf16 wire (as the JAX package's sharded step),
    the replica step on an f32 one (as the JAX package's replica step),
    so the two are not bitwise there."""
    return (case.get("precision") is not None and case["zero"] >= 2
            and case["accum"] > 1)


# strategies through the sharded step's strategy path (name, kwargs,
# compressor, world); hierarchical on a 2 x 2 grid of ranks
STRATEGY_CASES = {
    "local_sgd": ("local_sgd", dict(sync_every=2), None, 2),
    "easgd": ("easgd", dict(sync_every=2), None, 2),
    "gossip": ("gossip", {}, None, 2),
    "downpour_onebit": ("downpour", dict(push_every=2), "onebit", 2),
    "ssp": ("ssp", dict(staleness=2), None, 2),
    "sync_dgc_topk": ("sync_dgc", {}, "topk", 2),
    "hier_sync_gossip": ("hierarchical", {}, None, 4),
}


def torch_cfg(precision=None):
    cfg = dataclasses.replace(get_config("qwen2-1.5b").reduced(), **CUT)
    return cfg if precision is None else apply_policy(cfg,
                                                      get_policy(precision))


def compressor(name):
    return None if name is None else get_compressor(name,
                                                    **COMPRESSORS[name])


def optimizer(name="adam"):
    """Adam for the bitwise comparisons with the stacked step (params, m
    and v); momentum where the JAX package's step is compared, since
    Adam's first steps move an element by ~lr * sign(g) and a gradient
    near 0 can take another sign in the other package."""
    return TO.adam(LR) if name == "adam" else TO.momentum(LR, 0.9)


STEP_OPTIMIZERS = ("adam", "momentum")


def loss_with_mul(cfg):
    """The model's loss times the mean of the batch's "mul" rows: ones
    leave it bitwise as it is, an inf row overflows that rank's step."""
    lf = TL.make_loss_fn(cfg, remat=False)
    return lambda p, b: lf(p, b) * b["mul"].mean()


def strategy(name, kw, comp):
    """The port's strategy of a ``STRATEGY_CASES`` row."""
    if name == "hierarchical":
        return ST.hierarchical(ST.sync(bucket_bytes=BB),
                               ST.gossip(bucket_bytes=BB))
    if comp is not None:
        kw = dict(kw, compressor=compressor(comp))
    return ST.get_strategy(name, bucket_bytes=BB, **kw)


def _cpu(tree):
    return T.tree_map(lambda x: x.detach().cpu().clone()
                      if isinstance(x, torch.Tensor) else x, tree)


def _stats(comm):
    return {k: tuple(v) for k, v in comm.stats.items()}


# ---------------------------------------------------------------------------
# the sharded step
# ---------------------------------------------------------------------------
def step_cases(mesh, inputs, opt_name):
    """Every ``STEP_CASES`` row that ``inputs["init"]`` holds under
    ``opt_name``, 3 steps on this rank of ``mesh``, from the JAX package's
    initial global state cut by the bridge.  Returns, per case, the final
    state, the losses and the comm's counters a step."""
    rank, world = mesh.rank, mesh.shape[0]
    params = params_from_numpy(inputs["params"], "cpu")
    out = {}
    for key in inputs["init"]:
        name, opt = key.split("/")
        if opt != opt_name:
            continue
        case = STEP_CASES[name]
        prec = case.get("precision")
        cfg = torch_cfg(prec)
        comp = compressor(case.get("comp"))
        opt = optimizer(opt_name)
        state = sharded_state_from_numpy(inputs["init"][key], rank, world,
                                         case["zero"], "cpu")
        pol = None if prec is None else get_policy(prec)
        own = TL.init_sharded_state(
            pol.cast_to_param(params) if pol else params, opt, mesh,
            zero_stage=case["zero"], pod_compressor=comp, policy=pol,
            bucket_bytes=BB)
        same_init = all(torch.equal(a, b) for a, b in zip(
            T.leaves(own), T.leaves(state)))
        template = (T.tree_map(lambda x: x.to("meta"), pol.cast_to_param(
            params) if pol else params) if case["zero"] >= 3 else None)
        step = TL.make_sharded_train_step(
            cfg, opt, mesh, pod_compressor=comp, zero_stage=case["zero"],
            accum_steps=case["accum"], bucket_bytes=BB, policy=pol,
            param_template=template, loss_fn=loss_with_mul(cfg))
        losses, stats, unchanged = [], [], []
        for t in range(STEPS):
            before = _cpu({k: v for k, v in state.items()
                           if k not in ("step", "loss_scale")})
            toks = torch.from_numpy(inputs["tokens"][name][t])
            mul = torch.from_numpy(inputs["mul"][name][t])
            if case["accum"] == 1:
                toks, mul = toks[rank], mul[rank]
            else:
                toks, mul = toks[:, rank], mul[:, rank]
            state, loss = step(state, {"tokens": toks, "labels": toks,
                                       "mul": mul})
            losses.append(loss)
            stats.append(_stats(step.comm))
            after = {k: v for k, v in state.items()
                     if k not in ("step", "loss_scale")}
            unchanged.append(all(torch.equal(a, b) for a, b in zip(
                T.leaves(before), T.leaves(after))))
        out[key] = {"state": _cpu(state), "losses": _cpu(losses),
                    "stats": stats, "same_init": same_init,
                    "unchanged": unchanged}
    return out


def replica_step_cases(params_np, inputs, world):
    """The stacked ``LocalComm`` reference of every ``STEP_CASES`` row in
    this process: the replica step with the matching strategy, under Adam
    (momentum for the rows of ``narrow_microbatch_wire``, which are held
    to the ranks within bounds).  Returns each rank's view of its final
    state (``rank_state``) and the losses."""
    out = {}
    for name, case in STEP_CASES.items():
        prec = case.get("precision")
        cfg = torch_cfg(prec)
        pol = None if prec is None else get_policy(prec)
        comm = LocalComm(world)
        strat = (ST.get_strategy(f"sync_zero{case['zero']}",
                                 bucket_bytes=BB, policy=pol)
                 if case["zero"] else
                 ST.sync(compressor(case.get("comp")), bucket_bytes=BB,
                         policy=pol))
        params = comm.replicate(params_from_numpy(params_np, "cpu"))
        if pol is not None:
            params = pol.cast_to_param(params)
        opt = optimizer("momentum" if narrow_microbatch_wire(case)
                        else "adam")
        state = TL.init_train_state(params, opt, strat, comm, policy=pol)
        step = TL.make_replica_train_step(
            loss_with_mul(cfg), opt, strat, comm, policy=pol,
            accum_steps=case["accum"], bucket_bytes=BB)
        losses = []
        for t in range(STEPS):
            toks = torch.from_numpy(inputs["tokens"][name][t])
            mul = torch.from_numpy(inputs["mul"][name][t])
            state, m = step(state, {"tokens": toks, "labels": toks,
                                    "mul": mul})
            losses.append(m["loss"])
        out[name] = {"ranks": [rank_state(state, r) for r in range(world)],
                     "losses": losses}
    return out


def pool_cases(rank, world, inputs):
    """The one pool of 4 ranks of ``tests/test_torch_sharded_step.py``:
    two meshes of 2 ranks at once, ranks 0-1 running the step cases under
    Adam and the W = 2 strategies, ranks 2-3 the step cases under
    momentum; then the 4 ranks the strategies of W = 4 (the hierarchy)
    and the model-axis cases on a data 2 x model 2 mesh
    (``_torch_model_ranks.tp_step_cases``).  Returns this rank's
    results."""
    import _torch_model_ranks as MR  # it imports this module

    torch.set_num_threads(1)
    meshes = [make_mesh((2,), ("pod",), device="cpu", ranks=rs)
              for rs in ((0, 1), (2, 3))]
    half = rank // 2
    mesh = meshes[half]
    out = {"steps": step_cases(mesh, inputs, STEP_OPTIMIZERS[half]),
           "strategies": {}}
    if half == 0:
        out["strategies"] = strategy_cases(mesh, inputs)
    out["strategies"].update(strategy_cases(
        make_mesh((world,), ("pod",), device="cpu"), inputs))
    out["tp"] = MR.tp_step_cases(
        make_mesh((2, 2), ("data", "model"), device="cpu"), inputs["tp"])
    return out


# ---------------------------------------------------------------------------
# the strategies over ShardComm
# ---------------------------------------------------------------------------
def strategy_comm(name, mesh):
    if name == "hierarchical":
        return ShardHierComm(2, mesh.shape[0] // 2)
    return mesh.comm("pod")


def strategy_cases(mesh, inputs):
    """Every ``STRATEGY_CASES`` row of ``mesh``'s size through the sharded
    step's strategy path, each rank's state made by ``init_train_state``
    over its comm.  Returns the final states and losses."""
    rank, world = mesh.rank, mesh.shape[0]
    cfg = torch_cfg()
    params = params_from_numpy(inputs["params"], "cpu")
    out = {}
    for case, (name, kw, comp, w) in STRATEGY_CASES.items():
        if w != world:
            continue
        strat = strategy(name, kw, comp)
        comm = strategy_comm(name, mesh)
        state = TL.init_train_state(params, optimizer("momentum"), strat, comm)
        step = TL.make_sharded_train_step(
            cfg, optimizer("momentum"), mesh, strategy=strat, comm=comm,
            bucket_bytes=BB, loss_fn=loss_with_mul(cfg))
        losses = []
        for t in range(STEPS):
            toks = torch.from_numpy(inputs["strategy_tokens"][w][t][rank])
            state, loss = step(state, {"tokens": toks, "labels": toks,
                                       "mul": torch.ones(BPW)})
            losses.append(loss)
        out[case] = {"state": _cpu(state), "losses": _cpu(losses)}
    return out


def strategy_init(params_np, case):
    """The stacked initial state (``LocalComm``, or ``LocalHierComm(2, 2)``
    flattened to one replica axis for the hierarchy) of a strategy case."""
    name, kw, comp, w = STRATEGY_CASES[case]
    comm = LocalHierComm(2, w // 2) if name == "hierarchical" \
        else LocalComm(w)
    params = LocalComm(w).replicate(params_from_numpy(params_np, "cpu"))
    if name == "hierarchical":
        params = T.tree_map(lambda x: x.reshape((2, w // 2) + x.shape[1:]),
                            params)
    return TL.init_train_state(params, optimizer("momentum"),
                               strategy(name, kw, comp), comm)


def strategy_replica_cases(params_np, tokens, world):
    """The stacked ``LocalComm`` run of every W = ``world`` strategy case
    (not the hierarchy)."""
    cfg = torch_cfg()
    out = {}
    for case, (name, kw, comp, w) in STRATEGY_CASES.items():
        if w != world or name == "hierarchical":
            continue
        comm = LocalComm(w)
        strat = strategy(name, kw, comp)
        state = strategy_init(params_np, case)
        step = TL.make_replica_train_step(loss_with_mul(cfg),
                                          optimizer("momentum"), strat,
                                          comm, bucket_bytes=BB)
        losses = []
        for t in range(STEPS):
            toks = torch.from_numpy(tokens[t])
            state, m = step(state, {"tokens": toks, "labels": toks,
                                    "mul": torch.ones(w, BPW)})
            losses.append(m["loss"])
        out[case] = {"ranks": [rank_state(state, r) for r in range(w)],
                     "losses": losses}
    return out


# ---------------------------------------------------------------------------
# ShardComm, the mesh and the Fabric
# ---------------------------------------------------------------------------
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "uint8": torch.uint8}
FABRIC_COMPRESSORS = ("none", "int8", "onebit", "topk")
FABRIC_KW = {"int8": dict(block=64), **COMPRESSORS}


def primitives(comm, x):
    """Every ``Comm`` op of one tensor (a rank's row, or the stacked
    rows under ``LocalComm``), by name."""
    out = {"ag_tiled": comm.all_gather([x], tiled=True)[0],
           "pp_1": comm.ppermute([x], 1)[0],
           "pp_-1": comm.ppermute([x], -1)[0],
           "shard_chunk": comm.shard_chunk([x])[0],
           "all_sum": comm.all_sum([x])[0],
           "rs_sum": comm.reduce_scatter([x])[0]}
    if x.is_floating_point():
        out["all_mean"] = comm.all_mean([x])[0]
        out["rs_mean"] = comm.reduce_scatter([x], mean=True)[0]
    return out


def fabric_cases(comm, grads, residual):
    """Every ``Fabric`` op of the tests: the compressed and uncompressed
    exchanges, fused and unfused, and the bf16 narrow wire's partitioned
    exchange, all-mean, ring shift and all-gather."""
    out = {}
    for name in FABRIC_COMPRESSORS:
        comp = None if name == "none" else get_compressor(name,
                                                          **FABRIC_KW[name])
        for fused in (True, False):
            fab = Fabric(comm, BB_FABRIC, fused=fused)
            mean, new_r, _ = fab.exchange(grads, residual, comp)
            out[f"{name}/{fused}"] = {"mean": mean, "residual": new_r}
    fab = Fabric(comm, BB_FABRIC, wire_dtype="bfloat16")
    play = fab.partitioned_layout(grads)
    shards, _ = fab.exchange_partitioned(grads, play)
    out["bf16"] = {"rs": shards, "all_mean": fab.all_mean(grads),
                   "all_sum": fab.all_sum(grads),
                   "ppermute": fab.ppermute(grads, 1),
                   "unpartition": fab.unpartition(shards, play)}
    return out


BB_FABRIC = 1 << 12


def comm_cases(rank, world, inputs):
    """This rank's view of every ``ShardComm`` op, the hierarchy (W = 4),
    the mesh's groups and the ``Fabric`` over ``ShardComm``."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    comm = ShardComm()
    out = {"transport": comm.transport("cpu"),
           "worker_index": int(comm.worker_index()),
           "all_min": float(comm.all_min(torch.tensor(float(rank + 3)))),
           "prims": {}}
    for dt, rows in inputs["rows"].items():
        x = torch.from_numpy(rows[rank]).to(DTYPES[dt])
        out["prims"][dt] = primitives(comm, x)
        out["prims"][dt]["ag"] = comm.all_gather([x])[0]
        out["prims"][dt]["gather_chunks"] = comm.gather_chunks([x])[0]
    if world == 4:
        hier = ShardHierComm(2, 2)
        x = torch.from_numpy(inputs["rows"]["float32"][rank])
        out["hier"] = {"inner": primitives(hier.inner, x),
                       "outer": primitives(hier.outer, x)}
        mesh = make_mesh((2, 2), ("pod", "data"), device="cpu")
        out["mesh"] = {"coords": mesh.coords, "sizes": mesh.sizes,
                       "groups": {"/".join(k): dist.get_process_group_ranks(
                           g if g is not None else dist.group.WORLD)
                           for k, g in mesh._groups.items()}}
    grads = T.tree_map(lambda a: torch.from_numpy(a[rank]),
                       inputs["grads"])
    residual = T.tree_map(torch.zeros_like, grads)
    out["fabric"] = fabric_cases(ShardComm(), grads, residual)
    out["fabric_gathers"] = gathered_bytes(grads, residual)
    return out


def gathered_bytes(grads, residual):
    """The bytes of each compressed exchange's all-gathers on a fresh
    comm: one packed buffer a bucket."""
    out = {}
    for name in ("int8", "onebit", "topk"):
        comm = ShardComm()
        fab = Fabric(comm, BB_FABRIC)
        fab.exchange(grads, residual, get_compressor(name,
                                                     **FABRIC_KW[name]))
        out[name] = _stats(comm)
    return out


def fails_on_rank_one(rank, world):
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    return rank
