"""The communication-completeness spectrum (paper §3) as executable
strategies.

Port of ``repro/core/strategies.py``.  Spectrum point → strategy:

  1. synchronous (large mini-batch)   → ``sync``; with DGC momentum
     correction ``sync_dgc``; with the optimizer state partitioned
     (ZeRO-1) ``sync_zero1``, also the gradients (ZeRO-2) ``sync_zero2``,
     also the parameters (ZeRO-3) ``sync_zero3``
  2. complete, bounded delay          → ``ssp`` (stale-synchronous)
  3. complete, unbounded delay        → ``downpour`` (decentralized
     parameter-server semantics)
  4. partial communication            → ``gossip`` (ring mixing)
  +. model averaging                  → ``local_sgd``, ``easgd``
  +. hierarchical                     → ``hierarchical`` (complete within
     the fast tier × partial across the slow tier)

Every strategy is written against the ``Comm`` interface and moves its
tensors through the bucketed ``Fabric`` (``core/fabric.py``).  Asynchrony
is logical: per-worker schedules are explicit, deterministic state.

Differences from the reference, none of which changes a result:
  * the schedule gates decide on the host.  The reference traces the
    step ``t`` and gates with ``lax.cond``; here ``t`` is a Python int
    (the train loop keeps one beside its device step counter), so a
    gated collective simply does not run, and no step reads a device
    value back;
  * ``ssp``'s ring of the last s gradients is a tuple of s trees, not one
    (s, W, ...) array: a step builds a new tuple that holds the fresh
    gradient in its slot, so the ring is neither copied nor mutated
    (``bridge.py`` converts to and from the reference's layout);
  * the unused ``compressor`` arguments of ``local_sgd`` and ``gossip``
    are not ported.

Every strategy runs unchanged over both realizations of the comm: the
stacked ``LocalComm`` and the per-rank ``ShardComm`` (``lead_axes`` 0,
one replica a process), where ``easgd``'s center is the rank's own copy,
``downpour``'s push reads the rank from ``worker_index`` and ``gossip``
and ``ssp`` move their buckets through the ring and the reductions.

Every strategy takes the precision policy (``policy=``, ``core/precision.py``):
its Fabric rounds the uncompressed exchanges (``all_mean``, ``all_sum``,
``ppermute``) to the policy's wire dtype and counts their bytes at that
width; the compressors keep their own packed format.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.core import tree as T
from repro_torch.core.compression import Compressor, dgc_init, ef_init
from repro_torch.core.fabric import DEFAULT_BUCKET_BYTES, Fabric
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.optim.optimizers import Optimizer


@dataclass(frozen=True)
class Strategy:
    name: str
    spectrum_point: int  # 1..4 per the paper's §3 taxonomy
    complete: bool  # does every update eventually reach every worker?
    init: Callable  # (params, comm) -> comm_state
    update: Callable  # (params, grads, opt_state, comm_state, t, optimizer,
    #                   comm) -> (params, opt_state, comm_state, metrics),
    #                   t the step as a Python int
    init_opt: Optional[Callable] = None  # (params, optimizer, comm) ->
    #                 opt_state, for strategies that own its layout (ZeRO)
    owns_master: bool = False  # the f32 master lives in opt_state (ZeRO-1)
    exchange_at_boundary: bool = True  # DECLARATIVE: one exchange per update
    wire_profile: str = "dense"  # DECLARATIVE: dense / partitioned /
    #                 compressed / ring / none
    gated: bool = False  # DECLARATIVE: the exchange is schedule-gated
    sync_every: int = 1  # the gating period when ``gated``
    wire_events: int = 1  # collective rounds per exchange event
    owns_params: bool = False  # ZeRO-3: params are 1/W shard buckets
    init_params: Optional[Callable] = None  # (params, comm) -> shards
    gather_params: Optional[Callable] = None  # (shards, comm) -> params
    partitioned_accum: bool = False  # ZeRO-2/3 microbatch accumulation
    update_partitioned: Optional[Callable] = None  # boundary step of it

    # Contract: ``update`` treats ``comm_state`` as immutable and returns a
    # FRESH mapping: callers re-step from saved state.


def _fab(comm, bucket_bytes: int,
         policy: Optional[PrecisionPolicy]) -> Fabric:
    """Fabric with the policy's wire dtype (f32 when no policy)."""
    return Fabric(comm, bucket_bytes,
                  wire_dtype=policy.wire_dt if policy is not None else None)


# ---------------------------------------------------------------------------
# 1. synchronous — large mini-batch all-reduce (bucket-fused)
# ---------------------------------------------------------------------------
def sync(compressor: Optional[Compressor] = None,
         bucket_bytes: int = DEFAULT_BUCKET_BYTES,
         policy: Optional[PrecisionPolicy] = None) -> Strategy:
    def init(params, comm):
        return {"residual": ef_init(params)} if compressor else {}

    def update(params, grads, opt_state, cstate, t, opt, comm):
        fab = _fab(comm, bucket_bytes, policy)
        g, new_res, m = fab.exchange(grads, cstate.get("residual"), compressor)
        if compressor:
            cstate = {"residual": new_res}
        params, opt_state = opt.update(g, opt_state, params, t)
        return params, opt_state, cstate, m

    return Strategy("sync", 1, True, init, update,
                    wire_profile="compressed" if compressor else "dense")


# ---------------------------------------------------------------------------
# 1z. synchronous + partitioned optimizer state (ZeRO-1)
# ---------------------------------------------------------------------------
def _shard_update(fab, play, params, g_shards, opt_state, t, opt,
                  keeps_master):
    """The shard step of ZeRO-1/2: the optimizer on this worker's 1/W
    shard buckets (the f32 master shards under a master-keeping policy),
    then the all-gather of the updated shards into the replicated params.
    The list ``g_shards`` is emptied once the optimizer has read it, so
    the gradient shards are freed before the all-gather.  Returns
    (params, opt_state)."""
    if keeps_master:
        inner, p_shards = opt_state["opt"], opt_state["master"]
    else:
        inner, p_shards = opt_state, fab.shard_params(params, play)
    p_shards, inner = opt.update(g_shards, inner, p_shards, t)
    g_shards.clear()
    params = fab.unpartition(p_shards, play)
    return params, ({"opt": inner, "master": p_shards} if keeps_master
                    else inner)


def sync_zero1(bucket_bytes: int = DEFAULT_BUCKET_BYTES,
               policy: Optional[PrecisionPolicy] = None) -> Strategy:
    """Spectrum point 1 with sharded-optimizer data parallelism (ZeRO-1,
    Rajbhandari et al.): each flat f32 bucket is reduce-scattered so
    worker w owns only chunk w of the mean gradient, updates its 1/W
    shard of the parameters against 1/W of the optimizer state, and the
    updated shards are all-gathered back into the replicated params.

    The wire bytes a step equal the dense all-reduce's; the optimizer
    state a worker drops from N to N/W.  The numerics are ``sync``'s: the
    same mean reaches the same elementwise update.  Under a master-keeping
    policy the f32 master rides the shard: ``opt_state = {"opt": <inner
    state>, "master": <1/W f32 shard buckets>}``, and the all-gather
    ships the bf16 image of the new master.

    The params it returns are the broadcast view of ``unpartition``
    (``core/fabric.py``): nothing writes them in place, since the
    optimizer updates shard buckets of their own storage."""

    keeps_master = policy is not None and policy.keeps_master

    def init(params, comm):
        return {}

    def init_opt(params, opt, comm):
        # optimizer state over THIS worker's shard buckets
        shards = _fab(comm, bucket_bytes, policy).shard_params(params)
        inner = opt.init(shards)
        return {"opt": inner, "master": shards} if keeps_master else inner

    def update(params, grads, opt_state, cstate, t, opt, comm):
        fab = _fab(comm, bucket_bytes, policy)
        play = fab.partitioned_layout(params)
        g_shards, m = fab.exchange_partitioned(grads, play)
        del grads
        params, opt_state = _shard_update(fab, play, params, g_shards,
                                          opt_state, t, opt, keeps_master)
        return params, opt_state, cstate, m

    return Strategy("sync_zero1", 1, True, init, update, init_opt,
                    owns_master=keeps_master, wire_profile="partitioned")


# ---------------------------------------------------------------------------
# 1z2. ZeRO-2: gradient sharding on top of the partitioned optimizer state
# ---------------------------------------------------------------------------
def sync_zero2(bucket_bytes: int = DEFAULT_BUCKET_BYTES,
               policy: Optional[PrecisionPolicy] = None) -> Strategy:
    """ZeRO-1 plus gradient sharding (stage 2): under microbatch
    accumulation each microbatch's gradient is reduce-scattered into the
    ``PartitionedLayout`` as it is produced
    (``Fabric.accumulate_partitioned``), so the accumulator holds 1/W
    shard buckets.  One reduce-scatter a bucket a MICROBATCH against a W
    times smaller accumulator; at ``accum_steps=1`` it is ``sync_zero1``,
    wire and numerics."""

    keeps_master = policy is not None and policy.keeps_master
    z1 = sync_zero1(bucket_bytes=bucket_bytes, policy=policy)

    def update_partitioned(params, g_shards, opt_state, cstate, t, opt,
                           comm):
        # the boundary: the gradients arrive as reduced 1/W shard buckets,
        # only the shard update and the param all-gather remain
        fab = _fab(comm, bucket_bytes, policy)
        play = fab.partitioned_layout(params)
        params, opt_state = _shard_update(fab, play, params, g_shards,
                                          opt_state, t, opt, keeps_master)
        m = fab.metrics(fab.flat_bytes(play.layout) / 2.0)  # the AG half
        return params, opt_state, cstate, m

    return Strategy("sync_zero2", 1, True, z1.init, z1.update, z1.init_opt,
                    owns_master=keeps_master, wire_profile="partitioned",
                    partitioned_accum=True,
                    update_partitioned=update_partitioned)


# ---------------------------------------------------------------------------
# 1z3. ZeRO-3: parameter sharding, the train state holds 1/W of the model
# ---------------------------------------------------------------------------
def sync_zero3(bucket_bytes: int = DEFAULT_BUCKET_BYTES,
               policy: Optional[PrecisionPolicy] = None) -> Strategy:
    """Full ZeRO (stage 3): parameters, gradients and optimizer state are
    partitioned.  The train state's ``params`` are this worker's flat f32
    shard buckets; the loop all-gathers the full parameters a step with
    ``gather_params`` (a temporary of the step), the gradients are
    reduce-scattered, and the elementwise optimizer updates the shards in
    place.  The numerics are ``sync``'s bitwise.  The f32 shard buckets
    are the precision master too (``owns_master``), and the gather ships
    their wire-dtype image."""

    keeps_master = policy is not None and policy.keeps_master
    box = {}  # the partition layout, recorded by init_params

    def _fab_play(comm, tree=None):
        fab = _fab(comm, bucket_bytes, policy)
        play = box.get("play")
        if play is None and tree is not None:
            play = fab.partitioned_layout(tree)
        return fab, play

    def init(params, comm):
        return {}

    def init_params(params, comm):
        fab = _fab(comm, bucket_bytes, policy)
        play = fab.partitioned_layout(params)
        box["play"] = play
        return fab.shard_params(params, play)  # flat f32 shard buckets

    def gather_params(shards, comm):
        fab, play = _fab_play(comm)
        return fab.unpartition(shards, play)

    def init_opt(p_shards, opt, comm):
        # init_train_state hands the shard buckets of init_params
        return opt.init(p_shards)

    def update(p_shards, grads, opt_state, cstate, t, opt, comm):
        # grads: the full per-worker tree of the backward over the
        # gathered params, whose partitioned layout is the params'
        fab, play = _fab_play(comm, grads)
        g_shards, m = fab.exchange_partitioned(grads, play)
        del grads
        p_shards, opt_state = opt.update(g_shards, opt_state, p_shards, t)
        return p_shards, opt_state, cstate, m

    def update_partitioned(p_shards, g_shards, opt_state, cstate, t, opt,
                           comm):
        # the partitioned accumulation's boundary: only the shard update
        # (the next step's param gather is the AG half of the wire)
        fab = _fab(comm, bucket_bytes, policy)
        p_shards, opt_state = opt.update(g_shards, opt_state, p_shards, t)
        play = box.get("play")
        nb = fab.flat_bytes(play.layout) / 2.0 if play is not None else 0.0
        return p_shards, opt_state, cstate, fab.metrics(nb)

    return Strategy("sync_zero3", 1, True, init, update, init_opt,
                    owns_master=keeps_master, wire_profile="partitioned",
                    owns_params=True, init_params=init_params,
                    gather_params=gather_params, partitioned_accum=True,
                    update_partitioned=update_partitioned)


# ---------------------------------------------------------------------------
# +. local SGD / model averaging (paper §2.2.3)
# ---------------------------------------------------------------------------
def local_sgd(sync_every: int = 8,
              bucket_bytes: int = DEFAULT_BUCKET_BYTES,
              policy: Optional[PrecisionPolicy] = None) -> Strategy:
    def init(params, comm):
        return {}

    def update(params, grads, opt_state, cstate, t, opt, comm):
        fab = _fab(comm, bucket_bytes, policy)
        params, opt_state = opt.update(grads, opt_state, params, t)
        do_avg = (t + 1) % sync_every == 0
        if do_avg:
            # the mean is a broadcast view: materialize W replicas again,
            # so the optimizer can update them in place
            params = T.tree_map(lambda x: x.contiguous(),
                                fab.all_mean(params))
        m = fab.metrics(fab.flat_bytes(params), events=float(do_avg))
        return params, opt_state, cstate, m

    return Strategy("local_sgd", 2, True, init, update,
                    exchange_at_boundary=False,
                    gated=True, sync_every=sync_every)


# ---------------------------------------------------------------------------
# 1b. sync + Deep Gradient Compression (momentum correction)
# ---------------------------------------------------------------------------
def sync_dgc(compressor: Compressor, momentum: float = 0.9,
             bucket_bytes: int = DEFAULT_BUCKET_BYTES,
             policy: Optional[PrecisionPolicy] = None) -> Strategy:
    """Synchronous exchange of momentum-corrected compressed gradients:
    velocity (not the raw gradient) accumulates into the residual, so the
    updates compression left out keep their momentum.  Runs on the flat
    buckets."""

    def init(params, comm):
        return {"dgc": dgc_init(params)}

    def update(params, grads, opt_state, cstate, t, opt, comm):
        fab = _fab(comm, bucket_bytes, policy)
        g, new_dgc, m = fab.exchange_dgc(grads, cstate["dgc"], compressor,
                                         momentum)
        params, opt_state = opt.update(g, opt_state, params, t)
        return params, opt_state, {"dgc": new_dgc}, m

    return Strategy("sync_dgc", 1, True, init, update,
                    wire_profile="compressed")


# ---------------------------------------------------------------------------
# +. elastic averaging SGD (paper §2.2.3)
# ---------------------------------------------------------------------------
def easgd(alpha: float = 0.1, sync_every: int = 4,
          bucket_bytes: int = DEFAULT_BUCKET_BYTES,
          policy: Optional[PrecisionPolicy] = None) -> Strategy:
    """Workers are elastically attracted to a (replicated) center variable;
    the center moves toward the worker average."""

    def init(params, comm):
        def center(p):
            if comm.lead_axes:  # stacked replicas: a common center
                # average over the axis THIS comm reduces (not
                # lead_axes - 1 for the outer tier of a hierarchy)
                ax = getattr(comm, "axis", comm.lead_axes - 1)
                return (p.float().mean(dim=ax, keepdim=True)
                        + torch.zeros_like(p, dtype=torch.float32))
            # one rank (ShardComm): its own copy, never the params' storage,
            # which a fused optimizer updates in place
            return p.to(torch.float32, copy=True)

        return {"center": T.tree_map(center, params)}

    def update(params, grads, opt_state, cstate, t, opt, comm):
        fab = _fab(comm, bucket_bytes, policy)
        params, opt_state = opt.update(grads, opt_state, params, t)
        do = (t + 1) % sync_every == 0
        center = cstate["center"]
        if do:
            diff = T.tree_map(lambda p_, c_: p_.float() - c_, params, center)
            center = T.tree_map(lambda c_, d: c_ + alpha * d, center,
                                fab.all_mean(diff))
            params = T.tree_map(
                lambda p_, d: (p_.float() - alpha * d).to(p_.dtype), params,
                diff)
        m = fab.metrics(fab.flat_bytes(params), events=float(do))
        return params, opt_state, {"center": center}, m

    return Strategy("easgd", 2, True, init, update,
                    exchange_at_boundary=False,
                    gated=True, sync_every=sync_every)


# ---------------------------------------------------------------------------
# 2. stale-synchronous — complete communication, bounded delay s
# ---------------------------------------------------------------------------
def ssp(staleness: int = 4, compressor: Optional[Compressor] = None,
        staleness_aware_lr: bool = False,
        bucket_bytes: int = DEFAULT_BUCKET_BYTES,
        policy: Optional[PrecisionPolicy] = None) -> Strategy:
    """Each worker applies its own fresh gradient and the others' from s
    steps ago.  ``staleness_aware_lr`` (Zhang et al.) scales the stale
    contributions by 1/s."""
    s = max(1, staleness)

    def init(params, comm):
        st = {"buf": tuple(T.tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), params)
            for _ in range(s))}
        if compressor:
            st["residual"] = ef_init(params)
        return st

    def update(params, grads, opt_state, cstate, t, opt, comm):
        fab = _fab(comm, bucket_bytes, policy)
        new_c = dict(cstate)
        if compressor:
            grads, new_c["residual"], nbytes = fab.compress(
                grads, cstate["residual"], compressor)
        else:
            nbytes = fab.flat_bytes(grads)
        slot = t % s
        g_old = cstate["buf"][slot]  # g_{t-s}
        others_old = T.tree_map(lambda a, b: a - b, fab.all_sum(g_old),
                                g_old)
        w = comm.size
        stale_scale = 1.0 / s if staleness_aware_lr else 1.0
        g_eff = T.tree_map(lambda g, o: (g.float() + stale_scale * o) / w,
                           grads, others_old)
        del others_old
        params, opt_state = opt.update(g_eff, opt_state, params, t)
        buf = cstate["buf"]
        new_c["buf"] = (buf[:slot] + (T.tree_map(lambda g: g.float(), grads),)
                        + buf[slot + 1:])
        return params, opt_state, new_c, fab.metrics(nbytes)

    return Strategy("ssp", 2, True, init, update,
                    exchange_at_boundary=False)


# ---------------------------------------------------------------------------
# 3. downpour — complete communication, unbounded(-class) delay
# ---------------------------------------------------------------------------
def downpour(push_every: int = 4,
             compressor: Optional[Compressor] = None,
             bucket_bytes: int = DEFAULT_BUCKET_BYTES,
             policy: Optional[PrecisionPolicy] = None) -> Strategy:
    """Decentralized Downpour: workers accumulate locally and push on
    staggered schedules; every update is eventually delivered everywhere
    (complete)."""

    def init(params, comm):
        st = {"acc": T.tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), params)}
        if compressor:
            st["residual"] = ef_init(params)
        return st

    def update(params, grads, opt_state, cstate, t, opt, comm):
        fab = _fab(comm, bucket_bytes, policy)
        new_c = dict(cstate)
        if compressor:
            grads, new_c["residual"], nbytes = fab.compress(
                grads, cstate["residual"], compressor)
        else:
            nbytes = fab.flat_bytes(grads)
        n, w = t, comm.size
        lay = fab.layout(grads)
        flat_g, tdef = T.flatten(grads)
        del grads
        acc = T.leaves(cstate["acc"])
        # per-replica push mask, on the leaves' device, trailing axes 1
        push = (n + comm.worker_index(like=acc[0])) % push_every == 0
        g_eff, new_acc = [None] * len(flat_g), [None] * len(flat_g)
        # bucket by bucket: one all-sum a bucket (the leaves of one bucket
        # form one bucket again), one bucket's temporaries alive at a time
        for b in range(lay.n_buckets):
            idx = [i for i in range(len(flat_g)) if lay.bucket_of[i] == b]
            a_plus = [acc[i] + flat_g[i].float() for i in idx]
            masks = [push.reshape(tuple(push.shape)
                                  + (1,) * (a.dim() - push.dim()))
                     for a in a_plus]
            deliver = [torch.where(m_, a, 0.0)
                       for m_, a in zip(masks, a_plus)]
            summed = fab.all_sum(deliver)
            for j, i in enumerate(idx):
                g, flat_g[i] = flat_g[i], None
                g_eff[i] = (g.float() + (summed[j] - deliver[j])) / w
                new_acc[i] = torch.where(masks[j], 0.0, a_plus[j])
            del a_plus, deliver, summed, g
        params, opt_state = opt.update(T.unflatten(tdef, g_eff), opt_state,
                                       params, t)
        new_c["acc"] = T.unflatten(tdef, new_acc)
        # the fleet-wide push fraction: the staggered schedule is
        # deterministic in t, so it is known here without a collective
        ev = sum((n + i) % push_every == 0 for i in range(w)) / w
        return params, opt_state, new_c, fab.metrics(nbytes, events=ev)

    return Strategy("downpour", 3, True, init, update,
                    exchange_at_boundary=False)


# ---------------------------------------------------------------------------
# 4. gossip — PARTIAL communication (ring mixing)
# ---------------------------------------------------------------------------
def gossip(mix_every: int = 1, symmetric: bool = True,
           bucket_bytes: int = DEFAULT_BUCKET_BYTES,
           policy: Optional[PrecisionPolicy] = None) -> Strategy:
    """Ring gossip on the weights after the local step.  A worker only ever
    hears from its ring neighbors: updates from the others are never
    delivered directly (point 4: model consistency is given up)."""

    def init(params, comm):
        return {}

    def update(params, grads, opt_state, cstate, t, opt, comm):
        fab = _fab(comm, bucket_bytes, policy)
        params, opt_state = opt.update(grads, opt_state, params, t)
        do_mix = (t + 1) % mix_every == 0
        if do_mix:
            left = fab.ppermute(params, shift=1)
            if symmetric:
                right = fab.ppermute(params, shift=-1)
                mixed = T.tree_map(
                    lambda p_, lf, rt: (p_.float() + lf.float()
                                        + rt.float()) / 3.0,
                    params, left, right)
            else:
                mixed = T.tree_map(
                    lambda p_, lf: (p_.float() + lf.float()) / 2.0, params,
                    left)
            params = T.tree_map(lambda m_, p_: m_.to(p_.dtype), mixed, params)
        ev = float(do_mix) * (2.0 if symmetric else 1.0)
        m = fab.metrics(fab.flat_bytes(params), events=ev)
        return params, opt_state, cstate, m

    return Strategy("gossip", 4, False, init, update,
                    exchange_at_boundary=False, wire_profile="ring",
                    gated=True, sync_every=mix_every,
                    wire_events=2 if symmetric else 1)


# ---------------------------------------------------------------------------
# beyond-paper: hierarchical — complete inner tier × partial outer tier
# ---------------------------------------------------------------------------
def hierarchical(inner: Strategy, outer: Strategy) -> Strategy:
    """Compose: ``inner`` runs every step on the fast fabric (intra-pod),
    ``outer`` on the slow fabric (cross-pod).  The comm handed to update
    must be a ``HierComm``; each tier builds its own Fabric over its own
    comm."""

    def init(params, comm):
        return {"inner": inner.init(params, comm.inner),
                "outer": outer.init(params, comm.outer)}

    def update(params, grads, opt_state, cstate, t, opt, comm):
        params, opt_state, c_in, m1 = inner.update(
            params, grads, opt_state, cstate["inner"], t, opt, comm.inner)
        noop = Optimizer(lambda p: {}, lambda g, s_, p, tt: (p, s_))
        zero_g = T.tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                            grads)
        params, _, c_out, m2 = outer.update(
            params, zero_g, {}, cstate["outer"], t, noop, comm.outer)
        m = {k: m1[k] + m2[k] for k in m1}
        return params, opt_state, {"inner": c_in, "outer": c_out}, m

    return Strategy(f"hier({inner.name}x{outer.name})",
                    4 if not outer.complete else inner.spectrum_point,
                    inner.complete and outer.complete, init, update,
                    exchange_at_boundary=(inner.exchange_at_boundary
                                          and outer.exchange_at_boundary))


REGISTRY = {
    "sync": sync,
    "sync_zero1": sync_zero1,
    "sync_zero2": sync_zero2,
    "sync_zero3": sync_zero3,
    "sync_dgc": sync_dgc,
    "local_sgd": local_sgd,
    "easgd": easgd,
    "ssp": ssp,
    "downpour": downpour,
    "gossip": gossip,
}


def get_strategy(name: str, **kw) -> Strategy:
    return REGISTRY[name](**kw)
