"""Rank programs of ``tests/test_torch_model_axis.py``: the "model" mesh
axis for the recurrent and encoder-decoder families, a strategy on a
data x model mesh, and context parallelism.

One pool of 4 gloo ranks on the CPU (``launch/mesh.py::run_ranks``) runs
``axis_pool``: the families' TP forward and gradients on the model ranks
of data rank 0, the strategies on data 2 x model 2, the hierarchy on pod
2 x data 1 x model 2 and ``cp`` on data 2 x model 2 (a dense stack, then
the MoE families and the encoder-decoder).  Torch only: a rank
process imports neither JAX nor the JAX package.  The parent-side
references that need only torch live here too.
"""

from __future__ import annotations

import dataclasses

import _torch_ranks as R
import torch

from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core import strategies as ST
from repro_torch.core import tree as T
from repro_torch.core.comm import HierComm, LocalComm, LocalHierComm
from repro_torch.core.fabric import Fabric
from repro_torch.launch.mesh import make_mesh, use_mesh
from repro_torch.models import layers as L
from repro_torch.models import tensor_parallel as TP
from repro_torch.models import transformer as TT
from repro_torch.models.context_parallel import cp_context
from repro_torch.train import loop as TL

TP_N = 2
JAMBA, XLSTM, SEAMLESS = ("jamba-1.5-large-398b", "xlstm-125m",
                          "seamless-m4t-medium")
# the families at their .reduced() widths: jamba without experts cut to
# one attention and one Mamba layer, xlstm-125m (2 mLSTM, 2 sLSTM),
# seamless (2 + 2 layers); (batch rows, tokens, source frames)
FAMILIES = {"jamba": (JAMBA, dict(num_experts=0, num_layers=2, attn_every=2,
                                  ssm_chunk=16), 2, 32, 0),
            "xlstm": (XLSTM, {}, 2, 16, 0),
            "seamless": (SEAMLESS, {}, 2, 10, 12)}
# a strategy on data 2 x model 2: tests/_torch_ranks.py's W = 2 rows
STRATEGIES = sorted(c for c, (_, _, _, w) in R.STRATEGY_CASES.items()
                    if w == 2)
HIER = "hier_sync_gossip"
CP_L = 16  # tokens a data rank's row: 8 a model rank
GRANITE, QWEN2_MOE = "granite-moe-1b-a400m", "qwen2-moe-a2.7b"
# cp for the MoE families and the encoder at their .reduced() widths on
# data 2 x model 2, one row a data rank: (arch, tokens, source frames).
# At 256 tokens a row (512 global) the MoE takes _moe_dense, at 2048
# (4096 global) _moe_ep, both at the configs' capacity factor 1.25
CP_FAMILIES = {"granite_dense": (GRANITE, 256, 0),
               "qwen2_moe_dense": (QWEN2_MOE, 256, 0),
               "granite_ep": (GRANITE, 2048, 0),
               "seamless": (SEAMLESS, 128, 256)}
CP_BB = 1 << 22  # finalize_grads' buckets: a few a tree


def family_cfg(case, tp_degree=TP_N):
    arch, over, *_ = FAMILIES[case]
    return dataclasses.replace(get_config(arch).reduced(), **over,
                               tp_degree=tp_degree)


def strategy_cfg():
    """``_torch_ranks``'s cut with 4 heads over 2 kv heads (T divides both)
    at ``tp_degree`` 2."""
    return dataclasses.replace(R.torch_cfg(), num_heads=4, num_kv_heads=2,
                               tp_degree=TP_N)


def cp_cfg():
    return dataclasses.replace(R.torch_cfg(), num_heads=4, num_kv_heads=2,
                               sharding_mode="cp")


def cp_family_cfg(case):
    return dataclasses.replace(get_config(CP_FAMILIES[case][0]).reduced(),
                               sharding_mode="cp")


def cp_closed_form(cfg, ep: bool):
    """The model group's autograd collectives of one cp forward and
    backward without remat: k and v gathered a self-attention layer (the
    encoder's too), x a MoE layer and ``_moe_ep``'s combine, the memory
    once; each gather's reduce-scatter backward; the loss's all-sum and
    ``_moe_ep``'s aux pmean each way; its dispatch and combine
    all-to-alls and their reverses."""
    specs, repeat = cfg.superblock()
    moe = sum(s.ffn == "moe" for s in specs) * repeat
    attn = sum(s.mixer == "attn" for s in specs) * repeat
    gathers = 2 * (attn + cfg.num_encoder_layers) + moe * (2 if ep else 1) \
        + (1 if cfg.is_encoder_decoder else 0)
    return {"all_gather": gathers, "reduce_scatter": gathers, "psum": 2,
            "pmean": 2 * moe if ep else 0,
            "all_to_all": 4 * moe if ep else 0}


def family_batch(inputs, case):
    return {k: torch.from_numpy(v) for k, v in inputs["batch"][case].items()}


def _cpu(tree):
    return T.tree_map(lambda x: x.detach().cpu().clone()
                      if isinstance(x, torch.Tensor) else x, tree)


# ---------------------------------------------------------------------------
# the families under tensor parallelism
# ---------------------------------------------------------------------------
def family_cases(mesh, inputs):
    """Each family on this model rank: its ``tp_rank_params`` under the TP
    context, the logits (seamless: and the encoder's memory), the loss
    and its per-rank gradients (cotangent 1/T), ``finalize_grads``' result,
    the loss and gradients again under remat, and the model group's
    all-sums."""
    comm = mesh.shared_comm("model")
    out = {}
    for case in FAMILIES:
        cfg = family_cfg(case)
        params = params_from_numpy(inputs["params"][case], "cpu")
        shard = TP.tp_rank_params(params, TP_N, mesh.coords["model"])
        batch = family_batch(inputs, case)
        before = comm.ops["psum"][0]
        with TP.tp_context(TP_N, comm) as tp, torch.no_grad():
            memory = None
            if cfg.is_encoder_decoder:
                memory = TT.encode(shard, cfg, embeds=batch["source_embeds"],
                                   kernel=False)
            logits, _ = TT.forward(shard, cfg, tokens=batch["tokens"],
                                   memory=memory)
        fwd_psums = comm.ops["psum"][0] - before
        res = {"logits": logits, "memory": memory, "fwd_psums": fwd_psums}
        for remat in (False, True):
            lf = TL.make_loss_fn(cfg, remat=remat)
            with TP.tp_context(TP_N, comm) as tp:
                loss, grads = TL._local_grads(lf, shard, batch,
                                              weight=1.0 / TP_N)
                final = tp.finalize_grads(grads)
            res[remat] = {"loss": loss, "grads": _cpu(grads),
                          "final": _cpu(final)}
        out[case] = res
    return out


# ---------------------------------------------------------------------------
# a strategy on the model axis
# ---------------------------------------------------------------------------
def _batch(tokens, d):
    toks = torch.from_numpy(tokens[d])
    return {"tokens": toks, "labels": toks, "mul": torch.ones(R.BPW)}


def strategy_run(mesh, params, tokens, case, comm, coord):
    """``R.STEPS`` steps of one strategy through the sharded step's
    strategy path on this rank: per step the rank's local gradients (the
    parts, as the step computes them before its exchange) and its
    replicated leaves; the final state and the losses."""
    name, kw, comp, _ = R.STRATEGY_CASES[case]
    cfg = strategy_cfg()
    strat = R.strategy(name, kw, comp)
    opt = R.optimizer("momentum")
    state = TL.init_sharded_state(params, opt, mesh, strategy=strat,
                                  comm=comm, bucket_bytes=R.BB, cfg=cfg)
    step = TL.make_sharded_train_step(cfg, opt, mesh, strategy=strat,
                                      comm=comm, bucket_bytes=R.BB,
                                      loss_fn=R.loss_with_mul(cfg))
    grads, reps, losses = [], [], []
    for t in range(R.STEPS):
        batch = _batch(tokens[t], coord)
        _, g = step.local_grads(state, batch)
        grads.append(_cpu(g))
        state, loss = step(state, batch)
        reps.append(_cpu(state["params"]["rep"]))
        losses.append(loss)
    return {"state": _cpu(state), "grads": grads, "reps": reps,
            "losses": _cpu(losses), "parts": sorted(state["params"])}


def strategy_cases(mesh, inputs):
    params = params_from_numpy(inputs["params"]["strategy"], "cpu")
    comm = mesh.comm("data")
    return {case: strategy_run(mesh, params, inputs["strategy_tokens"], case,
                               comm, mesh.coords["data"])
            for case in STRATEGIES}


def hier_case(inputs):
    """``hierarchical`` (sync inside a pod, gossip across) on pod 2 x data
    1 x model 2: its comm the mesh's "data" and "pod" groups."""
    mesh = make_mesh((2, 1, 2), ("pod", "data", "model"), device="cpu")
    comm = HierComm(mesh.comm("data"), mesh.comm("pod"))
    params = params_from_numpy(inputs["params"]["strategy"], "cpu")
    return strategy_run(mesh, params, inputs["strategy_tokens"], HIER, comm,
                        mesh.coords["pod"])


# ---------------------------------------------------------------------------
# context parallelism
# ---------------------------------------------------------------------------
def cp_cases(mesh, inputs):
    """On data 2 x model 2 under ``cp``: the data rank's loss and
    all-summed gradients (``step.local_grads``), with and without remat;
    then ``R.STEPS`` sync steps under momentum with remat; the final
    params and the losses, and the model group's all-gathers."""
    cfg = cp_cfg()
    d = mesh.coords["data"]
    params = params_from_numpy(inputs["params"]["cp"], "cpu")
    opt = R.optimizer("momentum")
    mc = mesh.shared_comm("model")
    out = {}
    for remat in (False, True):
        state = TL.init_sharded_state(params, opt, mesh, bucket_bytes=R.BB,
                                      cfg=cfg)
        step = TL.make_sharded_train_step(cfg, opt, mesh, remat=remat,
                                          bucket_bytes=R.BB)
        before = {k: tuple(v) for k, v in mc.ops.items()}
        toks = torch.from_numpy(inputs["cp_tokens"][0][d])
        loss, grads = step.local_grads(state, {"tokens": toks,
                                               "labels": toks})
        ops = {k: (v[0] - before.get(k, (0, 0))[0],
                   v[1] - before.get(k, (0, 0))[1])
               for k, v in mc.ops.items()}
        out[remat] = {"loss": loss, "grads": _cpu(grads), "ops": ops}
    losses = []
    for t in range(R.STEPS):
        toks = torch.from_numpy(inputs["cp_tokens"][t][d])
        state, loss = step(state, {"tokens": toks, "labels": toks})
        losses.append(loss)
    out["steps"] = {"params": _cpu(step.params_of(state)),
                    "losses": _cpu(losses), "parts": sorted(state["params"])}
    return out


def _delta(ops, before):
    return {k: v[0] - before.get(k, (0, 0))[0] for k, v in ops.items()
            if v[0] - before.get(k, (0, 0))[0]}


def cp_family_cases(mesh, inputs):
    """Each of ``CP_FAMILIES`` on this rank of data 2 x model 2 under
    ``cp``: the data rank's loss and all-summed gradients through
    ``make_sharded_train_step`` (``step.local_grads``), the model group's
    autograd collectives and its backend calls in ``ShardComm.record``
    meanwhile; then a forward under ``cp_context``: the logits chunk,
    the aux, each routing's kept rows and the MoE branch taken.  On
    ``granite_ep`` each MoE layer's output chunk is held bitwise against
    the chunk of the port's tp-mode ``moe`` (``_moe_ep`` on the whole
    rows, no context) on the layer's gathered input."""
    d, m = mesh.coords["data"], mesh.coords["model"]
    mc = mesh.shared_comm("model")
    out = {}
    for case in CP_FAMILIES:
        cfg = cp_family_cfg(case)
        params = params_from_numpy(inputs["params"][case], "cpu")
        batch = {k: torch.from_numpy(v[d:d + 1])
                 for k, v in inputs["cp_batch"][case].items()}
        opt = R.optimizer("momentum")
        state = TL.init_sharded_state(params, opt, mesh, bucket_bytes=CP_BB,
                                      cfg=cfg)
        step = TL.make_sharded_train_step(cfg, opt, mesh, remat=False,
                                          bucket_bytes=CP_BB)
        before = {k: tuple(v) for k, v in mc.ops.items()}
        with mc.record() as calls:
            loss, grads = step.local_grads(state, batch)
        res = {"loss": loss, "grads": _cpu(grads["rep"]),
               "ops": _delta(mc.ops, before),
               "backend_gathers": sum(c["op"] == "all_gather"
                                      for c in calls),
               "buckets": Fabric(mc, CP_BB).layout(params).n_buckets,
               "parts": sorted(state["params"])}
        kept, branch, io = [], [], []
        route, moe_ep, moe_dense, moe = L._route, L._moe_ep, L._moe_dense, \
            L.moe

        def route_spy(*a):
            r = route(*a)
            kept.append(int(r[2].sum()))
            return r

        def moe_spy(p, c, x):
            o = moe(p, c, x)
            io.append((p, x, o[0]))
            return o

        L._route, L.moe = route_spy, moe_spy
        L._moe_ep = lambda *a: branch.append("ep") or moe_ep(*a)
        L._moe_dense = lambda *a: branch.append("dense") or moe_dense(*a)
        try:
            with torch.no_grad(), use_mesh(mesh), \
                    cp_context(TP_N, mc) as cp:
                memory = None
                if cfg.is_encoder_decoder:
                    memory = TT.encode(params, cfg,
                                       embeds=batch["source_embeds"],
                                       kernel=False)
                    res["memory_chunk"] = memory
                    memory = cp.gather_seq(memory)
                logits, aux = TT.forward(params, cfg, tokens=batch["tokens"],
                                         memory=memory)
                whole = [cp.gather_seq(x) for _, x, _ in io]
            res.update(logits=logits, aux=float(aux), kept=kept,
                       branch=list(branch))
            if case == "granite_ep":
                kept.clear()
                branch.clear()
                bitwise = []
                with torch.no_grad(), use_mesh(mesh):
                    for (p, _, o), xw in zip(io, whole):
                        c = o.shape[1]
                        ref, _ = moe(p, cfg, xw)
                        bitwise.append(torch.equal(
                            o, ref[:, m * c:(m + 1) * c]))
                res["tp_mode"] = {"bitwise": bitwise, "branch": branch[:],
                                  "kept": kept[:]}
        finally:
            L._route, L._moe_ep, L._moe_dense, L.moe = route, moe_ep, \
                moe_dense, moe
        out[case] = res
    return out


def axis_pool(rank, world, inputs):
    """The one pool of 4 ranks: every case on this rank."""
    torch.set_num_threads(1)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    out = {"coords": (mesh.coords["data"], mesh.coords["model"])}
    if mesh.coords["data"] == 0:
        out["families"] = family_cases(mesh, inputs)
    out["strategies"] = strategy_cases(mesh, inputs)
    out["hier"] = hier_case(inputs)
    out["cp"] = cp_cases(mesh, inputs)
    out["cp_families"] = cp_family_cases(mesh, inputs)
    return out


# ---------------------------------------------------------------------------
# parent-side references (torch only)
# ---------------------------------------------------------------------------
def _stacked_comm(case):
    return LocalHierComm(2, 1) if case == HIER else LocalComm(2)


def exchange_reference(params_np, case, rank_grads):
    """The strategy's exchange fed the ranks' own gradients: for each
    (model rank, part) a stacked state over the batch group (``LocalComm``
    of the 2 data ranks, ``LocalHierComm(2, 1)`` for the hierarchy) from
    ``init_train_state``, stepped by ``strategy.update`` with the stacked
    local gradients of the ranks.  ``rank_grads[(b, m)]`` is the list of
    per-step gradient parts of batch rank b, model rank m.  Returns
    {(m, part): the stacked final state}."""
    name, kw, comp, _ = R.STRATEGY_CASES[case]
    full = params_from_numpy(params_np, "cpu")
    opt = R.optimizer("momentum")
    out = {}
    for m in range(TP_N):
        parts = TP._partition_replicated(TP.tp_rank_params(full, TP_N, m))
        for n, sub in zip(("rep", "split"), parts):
            comm = _stacked_comm(case)
            strat = R.strategy(name, kw, comp)
            params = LocalComm(2).replicate(sub)
            if case == HIER:
                params = T.tree_map(lambda x: x.reshape((2, 1) + x.shape[1:]),
                                    params)
            state = TL.init_train_state(params, opt, strat, comm)
            for t in range(R.STEPS):
                g = T.tree_map(lambda *xs: torch.stack(xs),
                               *[rank_grads[(b, m)][t][n] for b in range(2)])
                if case == HIER:
                    g = T.tree_map(lambda x: x.reshape((2, 1) + x.shape[1:]),
                                   g)
                p, o, c, _ = strat.update(state["params"], g,
                                          state["opt_state"],
                                          state["comm_state"], t, opt, comm)
                state = {"params": p, "opt_state": o, "comm_state": c}
            out[(m, n)] = state
    return out


def _assemble(others, m, part, sub):
    trees = []
    for r in range(TP_N):
        rep = sub if part == "rep" else others[r]["rep"]
        split = sub if (part == "split" and r == m) else others[r]["split"]
        trees.append(TP._merge_trees(rep, split))
    return TP.tp_unsplit_ranks(trees)


def strategy_replica_run(params_np, case, tokens):
    """The port's replica step at ``tp_degree`` 2, W = 2, with the case's
    strategy, run per (model rank, part) as
    ``_torch_model_ranks.tp_replica_run``: each part's loss is the blocked
    form's on the full tree assembled from it and a copy of every other
    part before the step.  Returns per data replica the unsplit full
    params, and the losses."""
    name, kw, comp, _ = R.STRATEGY_CASES[case]
    cfg = strategy_cfg()
    comm = LocalComm(2)
    full = params_from_numpy(params_np, "cpu")
    lf = R.loss_with_mul(cfg)
    runs = {}
    for m in range(TP_N):
        parts = TP._partition_replicated(TP.tp_rank_params(full, TP_N, m))
        for n, sub in zip(("rep", "split"), parts):
            strat = R.strategy(name, kw, comp)
            opt = R.optimizer("momentum")
            state = TL.init_train_state(comm.replicate(sub), opt, strat,
                                        comm)

            def loss(p, b, m=m, n=n):
                return lf(_assemble(b["others"], m, n, p), b)

            runs[(m, n)] = [state, TL.make_replica_train_step(
                loss, opt, strat, comm, bucket_bytes=R.BB)]
    losses = []
    for t in range(R.STEPS):
        toks = torch.from_numpy(tokens[t])
        others = [{n: T.tree_map(torch.clone, runs[(r, n)][0]["params"])
                   for n in ("rep", "split")} for r in range(TP_N)]
        batch = {"tokens": toks, "labels": toks, "mul": torch.ones(2, R.BPW),
                 "others": others}
        for key, run in runs.items():
            run[0], met = run[1](run[0], batch)
        losses.append(met["loss"])
    finals = []
    for w in range(2):
        trees = [TP._merge_trees(*(T.tree_map(lambda x: x[w],
                                              runs[(r, n)][0]["params"])
                                   for n in ("rep", "split")))
                 for r in range(TP_N)]
        finals.append(TP.tp_unsplit_ranks(trees))
    return {"params": finals, "losses": losses}


def cp_replica_run(params_np, tokens):
    """The port's one-rank step for ``cp``'s cases: the replica step over
    the 2 data rows (``LocalComm``, sync, momentum) with the unsharded
    loss of the same config, remat on; the final params per replica and
    the losses."""
    cfg = cp_cfg()
    comm = LocalComm(2)
    opt = R.optimizer("momentum")
    strat = ST.sync(bucket_bytes=R.BB)
    state = TL.init_train_state(
        comm.replicate(params_from_numpy(params_np, "cpu")), opt, strat,
        comm)
    step = TL.make_replica_train_step(TL.make_loss_fn(cfg, remat=True), opt,
                                      strat, comm, bucket_bytes=R.BB)
    losses = []
    for t in range(R.STEPS):
        toks = torch.from_numpy(tokens[t])
        state, met = step(state, {"tokens": toks, "labels": toks})
        losses.append(met["loss"])
    return {"params": [T.tree_map(lambda x: x[w], state["params"])
                       for w in range(2)], "losses": losses}
