"""Rank programs of the port's model-axis tests.

``tests/test_torch_tp.py`` (tensor parallelism, a mesh of 2 "model"
ranks), ``tests/test_torch_ep.py`` (expert parallelism, data 2 x model 2)
and the model-axis cases of ``tests/test_torch_sharded_step.py`` (data
2 x model 2) start these module-level functions in gloo rank processes on
the CPU (``repro_torch/launch/mesh.py::run_ranks``).  Torch only: a rank
process imports neither JAX nor the JAX package.  The parent-side
references that need only torch (the per-part replica runs of the
sharded step) live here too, so that both sides read one definition.
"""

from __future__ import annotations

import dataclasses

import _torch_ranks as R
import torch

from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import strategies as ST
from repro_torch.core import tree as T
from repro_torch.core.comm import LocalComm
from repro_torch.core.precision import get_policy
from repro_torch.launch.mesh import make_mesh, use_mesh
from repro_torch.models import layers as L
from repro_torch.models import tensor_parallel as TP
from repro_torch.models import transformer as TT
from repro_torch.train import loop as TL

# tests/test_tp.py's tiny_cfg: qwen2-1.5b reduced, 2 layers, d_model 32
TINY = dict(num_layers=2, d_model=32, num_heads=4, num_kv_heads=2,
            head_dim=16, d_ff=64, vocab_size=64)
TP_DEGREE = 2


def tiny_cfg(tp_degree=TP_DEGREE):
    return dataclasses.replace(get_config("qwen2-1.5b").reduced(), **TINY,
                               tp_degree=tp_degree)


def loss_of(cfg, p, tokens, targets):
    """tests/test_tp.py's ``_loss_of``: mean negative log-likelihood of
    the targets, f32 log-softmax."""
    logits, _ = TT.forward(p, cfg, tokens=tokens)
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, targets[..., None].long()).mean()


def _cpu(tree):
    return T.tree_map(lambda x: x.detach().cpu().clone()
                      if isinstance(x, torch.Tensor) else x, tree)


# ---------------------------------------------------------------------------
# tensor parallelism: forward, loss, gradients on 2 model ranks
# ---------------------------------------------------------------------------
def tp_rank(rank, world, inputs):
    """This model rank's logits, loss, per-rank gradients (the loss
    back-propagated with the cotangent 1/T) and ``finalize_grads``' result,
    on the rank's ``tp_rank_params`` of the full params."""
    torch.set_num_threads(1)
    mesh = make_mesh((world,), ("model",), device="cpu")
    cfg = tiny_cfg(world)
    params = params_from_numpy(inputs["params"], "cpu")
    tokens = torch.from_numpy(inputs["tokens"])
    targets = torch.from_numpy(inputs["targets"])
    shard = TP.tp_rank_params(params, world, mesh.coords["model"])
    comm = mesh.shared_comm("model")
    with TP.tp_context(world, comm) as tp:
        logits, _ = TT.forward(shard, cfg, tokens=tokens)
        loss, grads = TL._local_grads(
            lambda p, _: loss_of(cfg, p, tokens, targets), shard, None,
            weight=1.0 / world)
        final = tp.finalize_grads(grads)
    return {"logits": logits.detach(), "loss": loss, "grads": _cpu(grads),
            "final": _cpu(final), "ops": dict(comm.ops)}


# ---------------------------------------------------------------------------
# expert parallelism: data 2 x model 2
# ---------------------------------------------------------------------------
EP_CFG = dict(d_model=64, num_experts=8, top_k=2, moe_d_ff=128,
              expert_pad_to=4, capacity_factor=8.0)
EP_X = (4, 2048, 64)  # the global batch: 8192 tokens, the EP branch
EP_CASES = {  # capacity factor, shared experts
    "cf8": (8.0, 0),
    "cf_config": (ModelConfig().capacity_factor, 0),
    "shared": (8.0, 1),
}


def ep_cfg(case):
    cf, shared = EP_CASES[case]
    return ModelConfig(**dict(EP_CFG, capacity_factor=cf,
                              num_shared_experts=shared))


def ep_rank(rank, world, inputs):
    """Every ``EP_CASES`` row on this rank of a data 2 x model 2 mesh:
    ``moe`` under the mesh and a TP context on the rank's rows of x and
    its experts; the loss sum(out²) + aux / n_dp back-propagated with the
    cotangent 1/T, the router's (and the shared experts') partials
    finalized over "model", then every gradient all-summed over "data":
    the global batch's gradient of sum(out²) + aux.  Returns the rank's
    out, aux, the global gradients, the rows ``_route`` kept, whether the
    EP branch ran and the model group's collectives."""
    torch.set_num_threads(1)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    d, m = mesh.coords["data"], mesh.coords["model"]
    n_dp, ep = mesh.sizes["data"], mesh.sizes["model"]
    dc, mc = mesh.comm("data"), mesh.shared_comm("model")
    x_all = torch.from_numpy(inputs["x"])
    b = x_all.shape[0] // n_dp
    x = x_all[d * b:(d + 1) * b]
    out = {}
    for case in EP_CASES:
        cfg = ep_cfg(case)
        p = params_from_numpy(inputs["params"][case], "cpu")
        # under a "moe" key, as in the model's tree: the banks split on
        # their expert axis, the router and the shared MLP replicated
        shard = TP.tp_rank_params({"moe": p}, ep, m, experts=True)["moe"]
        kept, ran = [], []
        route, moe_ep = L._route, L._moe_ep

        def spy_route(*a, **k):
            res = route(*a, **k)
            kept.append(int(res[2].sum()))
            return res

        def spy_ep(*a, **k):
            ran.append(True)
            return moe_ep(*a, **k)

        L._route, L._moe_ep = spy_route, spy_ep
        try:
            with use_mesh(mesh), TP.tp_context(ep, mc, experts=True) as tp:
                def lfn(q, _):
                    o, a = L.moe(q, cfg, x)
                    lfn.out = (o.detach(), a.detach())
                    return (o ** 2).sum() + a / n_dp
                _, grads = TL._local_grads(lfn, shard, None, weight=1 / ep)
                grads = tp.finalize_grads({"moe": grads})["moe"]
        finally:
            L._route, L._moe_ep = route, moe_ep
        grads = T.tree_map(lambda g: dc.all_sum([g])[0], grads)
        out[case] = {"out": lfn.out[0], "aux": lfn.out[1],
                     "grads": _cpu(grads), "kept": kept, "ep": bool(ran)}
    out["ops"] = dict(mc.ops)
    out["coords"] = (d, m)
    return out


# ---------------------------------------------------------------------------
# the sharded step on data 2 x model 2
# ---------------------------------------------------------------------------
# zero stage, accum, compressor, precision: sync, the 1-bit pod
# compressor, accum 2, ZeRO-1, ZeRO-3, bf16
TP_STEP_CASES = {
    "tp_sync": dict(zero=0, accum=1),
    "tp_onebit": dict(zero=0, accum=1, comp="onebit"),
    "tp_accum2": dict(zero=0, accum=2),
    "tp_zero1": dict(zero=1, accum=1),
    "tp_zero3": dict(zero=3, accum=1),
    "tp_bf16": dict(zero=0, accum=1, precision="bf16"),
}
TP_OPTIMIZERS = ("adam", "momentum")


def tp_optimizers(case):
    """Adam and momentum in f32; momentum under bf16, where Adam's
    lr·sign(g) first steps turn the bf16 backward's rounding into
    parameter differences of several bf16 ulps."""
    return ("momentum",) if case.get("precision") else TP_OPTIMIZERS


def tp_step_cfg(precision=None):
    """``_torch_ranks``'s cut with 4 heads over 2 kv heads (the split
    needs T to divide both) and ``tp_degree`` 2."""
    cfg = dataclasses.replace(R.torch_cfg(precision), num_heads=4,
                              num_kv_heads=2, tp_degree=TP_DEGREE)
    return cfg


def _batch(tokens, mul, case, d):
    if case["accum"] == 1:
        return tokens[d], mul[d]
    return tokens[:, d], mul[:, d]


def tp_step_cases(mesh, inputs):
    """Every ``TP_STEP_CASES`` row under each of ``TP_OPTIMIZERS``, 3 steps
    on this rank of the data 2 x model 2 ``mesh``: the final full param
    tree of the rank's model shard (``step.params_of``), the losses, the
    batch group's and the model group's counters."""
    d = mesh.coords["data"]
    params = params_from_numpy(inputs["params"], "cpu")
    out = {}
    for name, case in TP_STEP_CASES.items():
        prec = case.get("precision")
        cfg = tp_step_cfg(prec)
        pol = None if prec is None else get_policy(prec)
        comp = R.compressor(case.get("comp"))
        full = pol.cast_to_param(params) if pol else params
        for opt_name in tp_optimizers(case):
            opt = R.optimizer(opt_name)
            state = TL.init_sharded_state(
                full, opt, mesh, zero_stage=case["zero"],
                pod_compressor=comp, policy=pol, bucket_bytes=R.BB,
                cfg=cfg)
            template = (T.tree_map(lambda x: x.to("meta"), full)
                        if case["zero"] >= 3 else None)
            step = TL.make_sharded_train_step(
                cfg, opt, mesh, pod_compressor=comp, zero_stage=case["zero"],
                accum_steps=case["accum"], bucket_bytes=R.BB, policy=pol,
                param_template=template, loss_fn=R.loss_with_mul(cfg))
            before = {k: tuple(v) for k, v in mesh.shared_comm(
                "model").ops.items()}
            losses = []
            for t in range(R.STEPS):
                toks, mul = _batch(torch.from_numpy(inputs["tokens"][name][t]),
                                   torch.from_numpy(inputs["mul"][name][t]),
                                   case, d)
                state, loss = step(state, {"tokens": toks, "labels": toks,
                                           "mul": mul})
                losses.append(loss)
            out[f"{name}/{opt_name}"] = {
                "params": _cpu(step.params_of(state)),
                "losses": _cpu(losses),
                "stats": {k: tuple(v) for k, v in step.comm.stats.items()},
                "model_ops": {k: (v[0] - before.get(k, (0, 0))[0],
                                  v[1] - before.get(k, (0, 0))[1])
                              for k, v in step.model_comm.ops.items()},
                "parts": sorted(state["params"]) if case["zero"] < 3
                else None}
    return out


def _assemble(snap, m, part, sub):
    """The full param tree from the per-(model rank, part) trees ``snap``
    with (m, part)'s replaced by ``sub``: split leaves concatenated over
    the model ranks, replicated ones from rank 0's (or ``sub``)."""
    tp_n = len(snap)
    trees = []
    for r in range(tp_n):
        rep = sub if (part == "rep") else snap[r]["rep"]
        split = sub if (part == "split" and r == m) else snap[r]["split"]
        trees.append(TP._merge_trees(rep, split))
    return TP.tp_unsplit_ranks(trees)


def tp_replica_run(params_np, name, opt_name, tokens, muls, world=2):
    """The port's replica step at ``tp_degree`` 2 and W = ``world`` for one
    ``TP_STEP_CASES`` row, run per (model rank, part): for each model rank
    m and each part of its shard (the replicated leaves, the split ones)
    a ``make_replica_train_step`` over the stacked ``LocalComm`` whose
    loss is the blocked form's on the full tree assembled from that part
    and, from the batch, every other part as it stood before the step.
    So each part takes the blocked form's gradient (its slice of it, or
    the whole replicated leaves') through the replica step's own body:
    the policy, the accumulation, the strategy's exchange of that part's
    buckets and its optimizer.  Returns per data replica the unsplit
    full params after each step's update, and the losses."""
    case = TP_STEP_CASES[name]
    prec = case.get("precision")
    cfg = tp_step_cfg(prec)
    pol = None if prec is None else get_policy(prec)
    comm = LocalComm(world)
    full = params_from_numpy(params_np, "cpu")
    if pol is not None:
        full = pol.cast_to_param(full)
    lf = R.loss_with_mul(cfg)
    keys = [(m, n) for m in range(TP_DEGREE) for n in ("rep", "split")]
    runs = {}
    for m, n in keys:
        strat = (ST.get_strategy(f"sync_zero{case['zero']}",
                                 bucket_bytes=R.BB, policy=pol)
                 if case["zero"] else
                 ST.sync(R.compressor(case.get("comp")), bucket_bytes=R.BB,
                         policy=pol))
        sub = TP._partition_replicated(
            TP.tp_rank_params(full, TP_DEGREE, m))[0 if n == "rep" else 1]
        opt = R.optimizer(opt_name)
        state = TL.init_train_state(comm.replicate(sub), opt, strat, comm,
                                    policy=pol)

        def loss(p, b, m=m, n=n):
            return lf(_assemble(b["others"], m, n, p), b)

        step = TL.make_replica_train_step(loss, opt, strat, comm, policy=pol,
                                          accum_steps=case["accum"],
                                          bucket_bytes=R.BB)
        runs[(m, n)] = [strat, state, step]

    def snapshot():
        """Per data replica, the param-dtype trees of every (m, part)."""
        out = {}
        for (m, n), (strat, st, _) in runs.items():
            p = (strat.gather_params(st["params"], comm)
                 if strat.owns_params else st["params"])
            if pol is not None and strat.owns_params:
                p = pol.cast_to_param(p)
            out[(m, n)] = p
        return out

    losses = []
    for t in range(R.STEPS):
        snap = snapshot()
        toks = torch.from_numpy(tokens[t])
        mul = torch.from_numpy(muls[t])
        lead = toks.shape[:-2]  # (accum, W) or (W,)
        # copies: an in-place update must not move another part's loss
        others = [{n: T.tree_map(
            lambda x: x.expand(lead + tuple(x.shape[1:])).clone()
            if case["accum"] > 1 else x.clone(), snap[(r, n)])
            for n in ("rep", "split")} for r in range(TP_DEGREE)]
        batch = {"tokens": toks, "labels": toks, "mul": mul,
                 "others": others}
        step_losses = []
        for key, run in runs.items():
            run[1], metrics = run[2](run[1], batch)
            step_losses.append(metrics["loss"])
        losses.append(step_losses[0])
    snap = snapshot()
    return {"params": [_unsplit_replica(snap, w) for w in range(world)],
            "losses": losses}


def _unsplit_replica(snap, w):
    trees = [TP._merge_trees(T.tree_map(lambda x: x[w], snap[(r, "rep")]),
                             T.tree_map(lambda x: x[w], snap[(r, "split")]))
             for r in range(TP_DEGREE)]
    return TP.tp_unsplit_ranks(trees)
