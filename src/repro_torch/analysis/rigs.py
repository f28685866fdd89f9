"""Rig builders: the small runs of the port whose artifacts the lint rules
(``repro_torch.analysis.rules``) check.

Port of ``repro/analysis/rigs.py``.  The reference traces and compiles
its rigs; the port runs them and records what its own code does.  The
same three cost tiers:

  * **rank rigs**, run in ONE pool of ``WORKERS`` gloo rank processes
    (``launch/mesh.py::run_ranks``; the parent sends the list of rig
    specs, ``rank_rigs`` runs them in order, the parent gets each rank's
    results back): the exchange rig, ``strategy.update`` over a
    ``ShardComm`` on each config's ``.reduced()`` tree (drawn by
    ``init_model`` from a seed) at every step of its period, each step's
    ``ShardComm.record`` call log; the tensor-parallel rig, one rank step
    on a ``TP_DEGREE``-split tiny model over the "model" group of a data
    2 × model 2 mesh; the elastic rig, ``demoted_resync`` at each boundary
    of its period;
  * **loop rigs** (donation, retrace) and **eager rigs** (state-aliasing,
    fused-dispatch): ``LocalComm`` stacked replicas in this process on a
    tiny problem made with numpy from a seed (the fused rig on the
    config's tree): the contracts they prove live in the train step and
    the strategy code, not the model, so the loop and state rigs are
    shared across configs.

``device`` places every rig's tensors (the rank processes share one
card over gloo, as the sharded paths do).
"""

from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Optional

import numpy as np
import torch

from repro_torch.analysis import rules
from repro_torch.configs import get_config
from repro_torch.core import compression as C
from repro_torch.core import strategies as ST
from repro_torch.core import tree as T
from repro_torch.core.comm import LocalComm
from repro_torch.core.fabric import DEFAULT_BUCKET_BYTES, Fabric
from repro_torch.core.precision import (PrecisionPolicy, apply_policy,
                                        cast_floats, get_policy, torch_dtype)
from repro_torch.kernels import _build
from repro_torch.kernels import topk_sparsify as tk
from repro_torch.launch.elastic import demoted_resync
from repro_torch.launch.mesh import make_mesh, run_ranks
from repro_torch.models import tensor_parallel as TP
from repro_torch.models import transformer as TT
from repro_torch.optim.optimizers import sgd
from repro_torch.train.loop import (_local_grads, init_train_state,
                                    make_replica_train_step)

WORKERS = 4  # the pool's ranks and the stacked rigs' replicas
TP_DEGREE = 2
LOOP_BUCKET_BYTES = 4 * 256
SEED = 0
RESYNC_EVERY = 4
# the tensor-parallel rig's model: qwen2-1.5b reduced, cut to 2 layers at
# d_model 32 (the reference's tp_artifacts)
TP_CUT = dict(num_layers=2, d_model=32, num_heads=4, num_kv_heads=2,
              head_dim=16, d_ff=64, vocab_size=64)
TP_TOKENS = (2, 8)


def rig_policy(precision: str) -> Optional[PrecisionPolicy]:
    """'f32' rides the policy-less path (the f32 policy is bitwise the
    policy-less step)."""
    pol = get_policy(precision)
    return None if pol.is_noop else pol


def build_strategy(name, policy: Optional[PrecisionPolicy],
                   bucket_bytes: int) -> ST.Strategy:
    """A registered strategy by name (``sync_dgc`` with top-k at ratio
    0.25), or ``name(policy, bucket_bytes)`` for a module-level factory
    (the rank processes import it by name)."""
    if callable(name):
        return name(policy, bucket_bytes)
    kw = dict(bucket_bytes=bucket_bytes, policy=policy)
    if name == "sync_dgc":
        kw["compressor"] = C.get_compressor("topk", ratio=0.25)
    return ST.get_strategy(name, **kw)


def strategy_name(name) -> str:
    return name if isinstance(name, str) else name.__name__


def init_params(cfg_name: str, policy: Optional[PrecisionPolicy],
                device="cpu"):
    """The config's ``.reduced()`` tree from ``init_model`` (seed
    ``SEED``), float leaves at the policy's param dtype."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = TT.init_model(gen, get_config(cfg_name).reduced(), device=dev)
    return params if policy is None else cast_floats(params,
                                                     policy.param_dt)


def pick_bucket_bytes(tree, target_buckets: int = 6) -> int:
    """A bucket size giving a handful of buckets at rig scale, so the
    ≤ n_buckets budgets are exercised with n_buckets > 1."""
    total = sum(math.prod(x.shape) for x in T.leaves(tree))
    return max(4 * 2000, 4 * -(-total // target_buckets))


def _randn_like(tree, seed: int, lead=(), device=None):
    """Seeded f32 normals of ``tree``'s leaf shapes (``lead`` prepended),
    on ``device`` (the leaves' by default)."""
    leaves, tdef = T.flatten(tree)
    dev = torch.device(device) if device is not None else leaves[0].device
    gen = torch.Generator(device=dev).manual_seed(seed)
    return T.unflatten(tdef, [torch.randn(lead + tuple(x.shape),
                                          generator=gen, device=dev)
                              for x in leaves])


# ---------------------------------------------------------------------------
# rank rigs: the specs the pool runs
# ---------------------------------------------------------------------------
def exchange_spec(cfg_name: str, strategy, precision: str,
                  bucket_bytes: Optional[int] = None) -> dict:
    """One exchange rig: ``strategy.update`` on ``cfg_name``'s tree.
    ``bucket_bytes`` None is ``pick_bucket_bytes`` of the tree."""
    return {"kind": "exchange", "config": cfg_name, "strategy": strategy,
            "precision": precision, "bucket_bytes": bucket_bytes,
            "key": ("exchange", cfg_name, strategy_name(strategy),
                    precision, bucket_bytes)}


def tp_spec(precision: str, bucket_bytes: int = DEFAULT_BUCKET_BYTES
            ) -> dict:
    """One tensor-parallel rank step; ``bucket_bytes`` is the TP
    context's (``finalize_grads``' buckets)."""
    return {"kind": "tp", "precision": precision,
            "bucket_bytes": bucket_bytes,
            "key": ("tp", precision, bucket_bytes)}


def elastic_spec(resync_every: int = RESYNC_EVERY,
                 period: int = RESYNC_EVERY) -> dict:
    """``demoted_resync`` at each boundary t in ``range(period)`` with its
    own ``resync_every``."""
    return {"kind": "elastic", "resync_every": resync_every,
            "period": period, "key": ("elastic", resync_every, period)}


def _exchange_rank(comm, spec, params, device):
    pol = rig_policy(spec["precision"])
    bb = spec["bucket_bytes"] or pick_bucket_bytes(params)
    strat = build_strategy(spec["strategy"], pol, bb)
    opt = sgd(0.1)
    state = init_train_state(params, opt, strat, comm, policy=pol)
    src = state.get("master", state["params"])
    grads = _randn_like(params, SEED + 1 + comm.rank)
    fab = Fabric(comm, bb, wire_dtype=pol.wire_dt if pol else None)
    logs = []
    for t in range(strat.sync_every if strat.gated else 1):
        with comm.record() as calls:
            strat.update(src, grads, state["opt_state"],
                         state["comm_state"], t, opt, comm)
        logs.append(calls)
    return {"logs": logs, "bucket_bytes": bb,
            "n_buckets": fab.layout(grads).n_buckets,
            "contract": fab.collective_contract(
                grads, strat.wire_profile, events=strat.wire_events)}


def tp_config(precision: str):
    cfg = dataclasses.replace(get_config("qwen2-1.5b").reduced(), **TP_CUT,
                              tp_degree=TP_DEGREE)
    pol = rig_policy(precision)
    return cfg if pol is None else apply_policy(cfg, pol)


def _tp_rank(mesh, spec, device):
    cfg = tp_config(spec["precision"])
    comm = mesh.shared_comm("model")
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = TT.init_model(gen, cfg, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, TP_TOKENS, generator=gen,
                           device=dev)
    targets = torch.randint(0, cfg.vocab_size, TP_TOKENS, generator=gen,
                            device=dev)
    shard = TP.tp_rank_params(params, TP_DEGREE, mesh.coords["model"])

    def loss_of(p, _):
        logits, _ = TT.forward(p, cfg, tokens=tokens)
        logp = torch.log_softmax(logits.float(), dim=-1)
        return -torch.gather(logp, -1, targets[..., None]).mean()

    with comm.record() as calls, \
            TP.tp_context(TP_DEGREE, comm, spec["bucket_bytes"]) as tp:
        _, grads = _local_grads(loss_of, shard, None,
                                weight=1.0 / TP_DEGREE)
        tp.finalize_grads(grads)
    rep, _ = TP._partition_replicated(shard)
    return {"calls": calls,
            "finalize_buckets": Fabric(comm).layout(rep).n_buckets,
            "activation": (TP_TOKENS + (cfg.d_model,),
                           str(cfg.compute_dtype))}


def _elastic_rank(comm, spec, device):
    fab = Fabric(comm, 4 * 64)
    params = _randn_like({"w": torch.empty(8, 16), "b": torch.empty(16)},
                         SEED + comm.rank, device=device)
    # one demoted member (rank 1): its rows are pulled at a resync
    mask = torch.ones(comm.size, device=device)
    mask[1] = 0.0
    logs = []
    for t in range(spec["period"]):
        with comm.record() as calls:
            demoted_resync(fab, params, mask, t, spec["resync_every"])
        logs.append(calls)
    return {"logs": logs}


def rank_rigs(rank, world, specs, device):
    """The pool's program (``run_ranks(rank_rigs, WORKERS, (specs,
    device))``): every spec in order on this rank, the exchange rigs over
    the world's ``ShardComm``, the TP rigs over the "model" group of a
    data × model mesh.  Returns ``{spec key: this rank's result}``."""
    torch.set_num_threads(1)
    dev = torch.device(device)
    mesh = make_mesh((world,), ("pod",), device=dev)
    comm = mesh.comm("pod")
    tp_mesh = None
    if any(s["kind"] == "tp" for s in specs):
        tp_mesh = make_mesh((world // TP_DEGREE, TP_DEGREE),
                            ("data", "model"), device=dev)
    out, params = {}, {}
    for spec in specs:
        if spec["kind"] == "exchange":
            pkey = (spec["config"], spec["precision"])
            if pkey not in params:
                params.clear()  # one config's tree at a time
                params[pkey] = init_params(spec["config"],
                                           rig_policy(spec["precision"]),
                                           dev)
            out[spec["key"]] = _exchange_rank(comm, spec, params[pkey], dev)
        elif spec["kind"] == "tp":
            out[spec["key"]] = _tp_rank(tp_mesh, spec, dev)
        elif spec["kind"] == "elastic":
            out[spec["key"]] = _elastic_rank(comm, spec, dev)
        else:
            raise ValueError(f"unknown rig kind {spec['kind']!r}")
    return out


def run_pool(specs, device="cuda", world: int = WORKERS,
             timeout: float = 1800.0) -> dict:
    """ONE pool of ``world`` gloo rank processes runs every spec; returns
    ``{spec key: [each rank's result]}``."""
    specs = sorted(specs, key=lambda s: (s["kind"] != "exchange",
                                         str(s.get("config"))))
    per_rank = run_ranks(rank_rigs, world, (specs, str(device)),
                         backend="gloo", device=device, timeout=timeout)
    return {s["key"]: [r[s["key"]] for r in per_rank] for s in specs}


# ---------------------------------------------------------------------------
# the rank rigs' artifacts, as the rules read them
# ---------------------------------------------------------------------------
def exchange_artifacts(ranks, strategy, precision: str) -> dict:
    """An exchange rig's per-rank results → rank 0's call log at the
    first step where the exchange fires (``calls``) and the other ranks'
    (``peers``), rank 0's logs of every step of the period (``logs``),
    the contract for the strategy's declared wire profile, the layout's
    bucket count, the strategy and whether the wire is narrow."""
    pol = rig_policy(precision)
    bb = ranks[0]["bucket_bytes"]
    strat = build_strategy(strategy, pol, bb)
    fire = (strat.sync_every - 1) if strat.gated else 0
    return {"calls": ranks[0]["logs"][fire],
            "peers": [r["logs"][fire] for r in ranks[1:]],
            "logs": ranks[0]["logs"], "contract": ranks[0]["contract"],
            "n_buckets": ranks[0]["n_buckets"], "strategy": strat,
            "narrow_wire": pol is not None and pol.narrow_wire,
            "bucket_bytes": bb}


def tp_artifacts(ranks, precision: str) -> dict:
    """The TP rig's per-rank results → rank 0's log, the others', and the
    contract: ``tp_collective_contract`` plus ``finalize_grads``' buckets
    (one all-sum a bucket of the replicated leaves' gradients)."""
    shape, dtype = ranks[0]["activation"]
    act = torch.empty(shape, dtype=torch_dtype(dtype), device="meta")
    contract = dict(TP.tp_collective_contract(tp_config(precision), act))
    for op in ("all_to_all", "all_gather"):
        contract[op] = contract.get(op, 0) + ranks[0]["finalize_buckets"]
    return {"calls": ranks[0]["calls"],
            "peers": [r["calls"] for r in ranks[1:]],
            "contract": contract, "tp_degree": TP_DEGREE}


# ---------------------------------------------------------------------------
# loop rig: donation and retrace on the replica train step
# ---------------------------------------------------------------------------
def _tiny_problem(workers: int, accum: int, seed: int = SEED, device="cpu"):
    rng = np.random.default_rng(seed)
    dev = torch.device(device)
    params = {"w": torch.from_numpy(rng.standard_normal((8, 16),
                                                        np.float32)).to(dev),
              "b": torch.zeros(16, device=dev)}
    lead = (accum, workers) if accum > 1 else (workers,)
    batch = {k: torch.from_numpy(rng.standard_normal(lead + shape,
                                                     np.float32)).to(dev)
             for k, shape in (("x", (4, 8)), ("y", (4, 16)))}

    def loss_fn(p, b):
        # promoted as jnp promotes a mixed f32 @ bf16
        dt = torch.promote_types(b["x"].dtype, p["w"].dtype)
        pred = b["x"].to(dt) @ p["w"].to(dt) + p["b"].to(dt)
        return torch.mean((pred - b["y"]) ** 2)

    return params, batch, loss_fn


def _nbytes(x) -> int:
    return x.numel() * x.element_size()


def donated_step(step, holder: list, batch):
    """Run ``step(state, batch)`` on the state popped from ``holder``, so
    nothing but the step holds it, then drop it.  Returns (new_state,
    metrics, alias_bytes, donated_bytes): the bytes of the input state's
    tensors that are freed (a weakref to the tensor is dead) or share
    storage with a tensor of the output state, and all of its bytes."""
    state = holder.pop()
    refs = [(weakref.ref(x), _nbytes(x)) for x in T.leaves(state)
            if isinstance(x, torch.Tensor)]
    donated = sum(n for _, n in refs)
    new_state, metrics = step(state, batch)
    del state
    out = {x.untyped_storage().data_ptr() for x in T.leaves(new_state)
           if isinstance(x, torch.Tensor)}
    alias = sum(n for ref, n in refs if ref() is None
                or ref().untyped_storage().data_ptr() in out)
    return new_state, metrics, alias, donated


def loop_artifacts(strategy, precision: str, accum: int,
                   workers: int = WORKERS, steps: int = 3, device="cpu",
                   wrap=None) -> dict:
    """The replica train step on the tiny problem: step 0 measures what
    of its input state the step reuses or frees (the donation proof), and
    the count of kernel libraries built or loaded after each of
    ``steps`` steps is the retrace proof.  ``wrap(step)`` replaces the
    step (the tests' deliberately broken steps)."""
    pol = rig_policy(precision)
    comm = LocalComm(workers)
    opt = sgd(0.05)
    base, batch, loss_fn = _tiny_problem(workers, accum, device=device)
    params = comm.replicate(base)
    if pol is not None:
        params = cast_floats(params, pol.param_dt)
    strat = build_strategy(strategy, pol, LOOP_BUCKET_BYTES)
    step = make_replica_train_step(loss_fn, opt, strat, comm, policy=pol,
                                   accum_steps=accum,
                                   bucket_bytes=LOOP_BUCKET_BYTES)
    if wrap is not None:
        step = wrap(step)
    holder = [init_train_state(params, opt, strat, comm, policy=pol)]
    del params
    state, _, alias, donated = donated_step(step, holder, batch)
    cache_sizes = [_build.libraries_built()]
    for _ in range(steps - 1):
        state, _ = step(state, batch)
        cache_sizes.append(_build.libraries_built())
    return {"alias_bytes": alias, "donated_bytes": donated,
            "cache_sizes": cache_sizes}


# ---------------------------------------------------------------------------
# eager rig: comm_state mutation detector
# ---------------------------------------------------------------------------
def state_aliasing_artifacts(strategy, precision: str,
                             workers: int = WORKERS, device="cpu") -> dict:
    """Run ``strategy.update`` on the stacked tiny problem at several
    schedule phases (t hitting and missing sync boundaries) and snapshot
    the input comm_state around every call: any structural diff is an
    in-place mutation of the caller's tree."""
    pol = rig_policy(precision)
    comm = LocalComm(workers)
    opt = sgd(0.05)
    base, _, _ = _tiny_problem(workers, accum=1, device=device)
    params = comm.replicate(base)
    if pol is not None:
        params = cast_floats(params, pol.param_dt)
    strat = build_strategy(strategy, pol, LOOP_BUCKET_BYTES)
    grads = T.tree_map(lambda p: torch.full_like(p, 0.01,
                                                 dtype=torch.float32),
                       params)
    if strat.owns_params:  # ZeRO-3: the params are shard buckets
        params = strat.init_params(params, comm)
    opt_state = (strat.init_opt(params, opt, comm)
                 if strat.init_opt is not None else opt.init(params))
    cstate = strat.init(params, comm)
    snaps = []
    for t in range(max(2, strat.sync_every)):
        before = rules.tree_snapshot(cstate)
        _, opt_state, new_c, _ = strat.update(
            params, grads, opt_state, cstate, t, opt, comm)
        snaps.append((before, rules.tree_snapshot(cstate)))
        cstate = new_c
    return {"snapshots": snaps}


# ---------------------------------------------------------------------------
# eager rig: fused compressed dispatch
# ---------------------------------------------------------------------------
def fused_artifacts(params, precision: str, workers: int = WORKERS,
                    bucket_bytes: Optional[int] = None, fused: bool = True,
                    device="cpu") -> dict:
    """``Fabric(LocalComm(workers), fused=fused).exchange_dgc`` (the
    ``sync_dgc`` wire, top-k at ratio 0.25) on stacked random gradients
    of ``params``' shapes: the entries into the compressor's fused encode
    and into the codec's unfused round (``compressor.compress``) are
    counted, and on CUDA tensors the rise of ``topk_encode_ef``'s launch
    counter."""
    pol = rig_policy(precision)
    if bucket_bytes is None:
        bucket_bytes = pick_bucket_bytes(params)
    calls = {"fused": 0, "codec": 0}

    def counted(fn, name):
        def run(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return run

    comp = C.get_compressor("topk", ratio=0.25)
    comp = dataclasses.replace(
        comp, compress=counted(comp.compress, "codec"),
        fused_encode=counted(comp.fused_encode, "fused"))
    fab = Fabric(LocalComm(workers), bucket_bytes,
                 wire_dtype=pol.wire_dt if pol is not None else None,
                 fused=fused)
    dev = torch.device(device)
    grads = _randn_like(params, SEED + 7, lead=(workers,), device=dev)
    state = {"velocity": T.tree_map(torch.zeros_like, grads),
             "residual": T.tree_map(torch.zeros_like, grads)}
    before = tk.topk_encode_ef.launches
    fab.exchange_dgc(grads, state, comp)
    launches = (tk.topk_encode_ef.launches - before
                if dev.type == "cuda" else None)
    return {"fused_calls": calls["fused"], "codec_calls": calls["codec"],
            "n_buckets": fab.layout(grads).n_buckets, "launches": launches}
