"""The replica-simulator training step.

Port of ``repro/train/loop.py``: ``make_loss_fn``, ``init_train_state``,
``make_replica_train_step`` and ``_stack_divergence``.  W model replicas
are stacked on axis 0 of every leaf (the ``LocalComm`` layout), each
replica takes its own data shard, and the strategy exchanges the
gradients and steps the optimizer.

Per-replica gradients come from a loop over the W replicas with
``torch.autograd.grad``, each replica's parameters taken as views of the
stacked leaves (every model family the forward takes, the recurrent ones
included: a Mamba layer's scan brings its own backward kernel, and the
step needs no logic of its own for it): one replica's activations and
gradients are alive at a time, and the stacked gradient is written in place, so the peak holds one
replica's temporaries instead of W of them (``torch.func.vmap`` over the
stacked tree would hold all W).  The step mutates the train state it is
given where the optimizer updates in place (``adam(fused=True)``), as the
reference's donated step reuses its buffers: keep a copy of a state you
want to re-step from.

The step counter ``state["step"]`` is an int32 tensor on the device, as
the reference's; beside it the step keeps the counter as a Python int and
hands that to ``strategy.update``, so a strategy's schedule (``local_sgd``,
``easgd`` and ``gossip``'s gates, ``ssp``'s ring slot, ``downpour``'s
pushes) decides on the host with no device read-back a step.  The int is
read back from the tensor only for a state this step did not make (the
first step, a state from ``bridge``).

``accum_steps > 1`` makes the step a microbatched boundary step: batches
carry a leading ``(accum_steps, W, ...)`` axis, each replica's gradient of
each microbatch is added straight into its rows of flat f32 accumulator
buckets (``Fabric.accumulate``, in microbatch order), the sum is divided
once at the boundary, and the strategy, hence the exchange and any
compression or error-feedback state, runs once a boundary.
``state["step"]`` counts optimizer steps, so the schedules of the
local-step strategies are those of an unaccumulated run.

A precision ``policy`` (``core/precision.py``) other than f32 makes the
step cast-params → forward (scaled loss) → unscale → skip-or-apply: the
strategy and optimizer run on the f32 master where the policy keeps one,
the forward on its bf16 image, the fabric ships wire-dtype buckets, and a
boundary whose gradients hold an inf or a nan leaves params, master,
optimizer state and comm state untouched while the loss scale backs off.
The reference applies the update and then selects the old tree; the
port's fused Adam and the codec write in place, so the port decides first:
it reads the one finite flag back to the host (a synchronisation a step,
only for a policy that scales) and on an overflow runs no exchange and no
update at all (``wire_bytes`` and ``comm_events`` 0 that step; the
reference reports the bytes of the exchange it discards).  The f32 policy
(``policy=None``) scales nothing, keeps no master and casts nothing, so
the same step computes the policy-less update bitwise.

The ZeRO strategies own parts of the state.  ``sync_zero1`` keeps the
optimizer state (and under ``bf16`` the f32 master) as 1/W shard buckets
inside ``opt_state``, so the state holds no ``master``; ``sync_zero3``
keeps the params themselves as shard buckets, and the step all-gathers
the full params for the forward and backward only (a temporary of the
step, never state).  With ``accum_steps > 1``, ``sync_zero2`` and
``sync_zero3`` accumulate in shard space: each microbatch's gradients
are added replica by replica into padded stacked buckets, those are
reduce-scattered at once (the reference's per-microbatch
reduce-scatter), the 1/W result is added into the shard accumulator and
the stacked buckets are freed, so no full-size accumulator outlives a
microbatch.  The boundary divides once and hands the shard buckets to
``update_partitioned``.  A skipped boundary of that path reports the
reduce-scatter bytes its microbatches shipped before the decision.
``zero1_opt_template``, ``zero1_master_buckets`` and
``zero3_param_template`` build the global (unstacked) shard-bucket state
of the partitioned layout.

``make_sharded_train_step`` is the reference's production step realized
per rank: each rank process holds ONE replica (or, under ZeRO, its 1/W
shard buckets of the optimizer state, the master and ZeRO-3's params)
and its own batch rows, and the gradients cross the ranks through the
``Fabric`` over a ``ShardComm`` (``core/comm.py``).  It runs the replica
step's body with the matching strategy (``sync``, ``sync`` with a
compressor, ``sync_zero1/2/3``), rank for replica: the same local
gradients, the same bucket adds and division, the same reductions in
rank order, so a run of W ranks is bitwise ``make_replica_train_step``
with that strategy, except where a bf16 policy's ZeRO-2/3 accumulation
reduce-scatters each microbatch on the bf16 wire (the reference's
sharded step; its replica step ships f32).

On a mesh with a "model" axis (``("data", "model")``, ``("pod", "data",
"model")``) each rank holds its model shard (``init_sharded_state``):
the leaves of attention (self and cross), the dense MLP, Mamba and
mLSTM split by ``tensor_parallel.SPLIT_AXES``, the MoE expert banks on
their expert axis, the rest (the sLSTM among them) replicated.  The loss
runs under ``tp_context`` and ``use_mesh`` (Megatron tensor parallelism,
``layers.py::_moe_ep``), ``finalize_grads`` completes the replicated
leaves' gradients over the model group, and the batch group's exchange
(sync, the pod compressor, accumulation, ZeRO-1/2/3, the bf16 policy, or
any strategy of the spectrum) runs over the shard tree in TWO parts, the
replicated leaves and the split ones, each with its own buckets,
optimizer state and residual: no bucket or compression block mixes
them, so the replicated leaves stay bitwise equal on every model rank (a
1-bit block straddling both would decode differently on each).  Under
``sharding_mode="cp"`` (``models/context_parallel.py``) the "model" axis
carries the sequence instead: every leaf is replicated, the state is the
one part ``{"rep": ...}``, the loss runs under ``cp_context`` and every
gradient is all-summed over the model group.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import precision as PR
from repro_torch.core import strategies as ST
from repro_torch.core import tree as T
from repro_torch.core.comm import HierComm, ShardComm
from repro_torch.core.fabric import (DEFAULT_BUCKET_BYTES, BucketLayout,
                                     Fabric, PartitionedLayout)
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.core.strategies import Strategy
from repro_torch.launch.mesh import BATCH_AXES, use_mesh
from repro_torch.models import tensor_parallel as TP
from repro_torch.models import transformer as TM
from repro_torch.models.context_parallel import (check_cp, cp_context,
                                                 cp_lm_loss, current_cp)
from repro_torch.optim.optimizers import Optimizer, state_template
from repro_torch.train.losses import lm_loss


def make_loss_fn(cfg, remat: bool = True):
    """loss_fn(params, batch) -> scalar for ONE replica; ``batch`` holds
    "labels" and "tokens" or "embeds" (B, L, D), and for an
    encoder-decoder model "source_embeds" (B, S, D), which ``encode``
    turns into the memory first, on the reference's ``_sdpa`` path
    (``kernel=False``) so that autograd differentiates it.  ``remat``
    recomputes each super-block's activations in the backward pass (the
    reference's default; the trainer CLI passes ``remat=False``).  Under
    a ``cp_context`` the forward runs this rank's sequence chunk and the
    loss is ``cp_lm_loss`` (the unsharded loss on every model rank); the
    encoder runs the source's chunk and its memory is all-gathered once
    a step, for every cross-attention layer."""
    def loss_fn(params, batch):
        cp = current_cp()
        memory = None
        if cfg.is_encoder_decoder:
            memory = TM.encode(params, cfg, embeds=batch["source_embeds"],
                               kernel=False)
            if cp is not None:
                memory = cp.gather_seq(memory)
        logits, aux = TM.forward(params, cfg, tokens=batch.get("tokens"),
                                 embeds=batch.get("embeds"), memory=memory,
                                 remat=remat)
        if cp is not None:
            return cp_lm_loss(logits, batch["labels"], cp, aux)
        return lm_loss(logits, batch["labels"], aux)

    return loss_fn


def init_train_state(params, optimizer: Optimizer, strategy: Strategy,
                     comm, policy: Optional[PrecisionPolicy] = None):
    """Stacked ``params`` → {params, opt_state, comm_state, step}; the step
    counter is an int32 tensor on the params' device.  A strategy that
    owns the params (ZeRO-3) shards them first; one that owns the
    optimizer-state layout (ZeRO) builds it.  A policy that scales adds
    ``loss_scale`` ({"scale", "good_steps"}); one whose master is wider
    than its params adds ``master``, a copy of the params in the master
    dtype, unless the strategy keeps the master in its optimizer state."""
    device = T.leaves(params)[0].device
    if strategy.owns_params:
        params = strategy.init_params(params, comm)
    state = {
        "params": params,
        "opt_state": (strategy.init_opt(params, optimizer, comm)
                      if strategy.init_opt is not None
                      else optimizer.init(params)),
        "comm_state": strategy.init(params, comm),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }
    policy = PR.get_policy(policy)
    if policy.uses_scaling:
        state["loss_scale"] = PR.init_scale_state(policy, device)
    if policy.keeps_master and not strategy.owns_master:
        # its own storage: the optimizer may update it in place
        state["master"] = T.tree_map(
            lambda x: x.to(policy.master_dt, copy=True)
            if x.is_floating_point() else x, params)
    return state


def _replica(batches, w):
    return T.tree_map(lambda b: b[w], batches)


def _local_grads(loss_fn, params, batch, weight=None):
    """(loss, grads) of ``loss_fn`` on one replica's params and batch;
    ``weight`` (a Python float) is the loss's cotangent (1 when None)."""
    leaves, tdef = T.flatten(params)
    pw = [x.detach().requires_grad_() for x in leaves]
    loss = loss_fn(T.unflatten(tdef, pw), batch)
    ct = None if weight is None else torch.full_like(loss, weight)
    gws = torch.autograd.grad(loss, pw, grad_outputs=ct)
    return loss.detach(), T.unflatten(tdef, list(gws))


def _replica_grads(loss_fn, params, batches, add=None):
    """Per-replica (losses, stacked grads) of ``loss_fn`` for the stacked
    ``params`` and per-replica ``batches``, replica by replica over axis
    0.  ``add(w, grads_w)``, when given, takes each replica's gradient
    tree instead, and no stacked tree is made."""
    leaves, tdef = T.flatten(params)
    grads = None if add else [torch.empty_like(x) for x in leaves]
    losses = []
    for w in range(leaves[0].shape[0]):
        loss, gw = _local_grads(loss_fn,
                                T.unflatten(tdef, [x[w] for x in leaves]),
                                _replica(batches, w))
        if add:
            add(w, gw)
        else:
            for out, g in zip(grads, T.leaves(gw)):
                out[w].copy_(g)
        del gw
        losses.append(loss)
    return torch.stack(losses), (None if add else T.unflatten(tdef, grads))


def make_replica_train_step(loss_fn, optimizer: Optimizer, strategy: Strategy,
                            comm, policy: Optional[PrecisionPolicy] = None,
                            accum_steps: int = 1,
                            bucket_bytes: int = DEFAULT_BUCKET_BYTES):
    """loss_fn(params, batch) -> scalar, defined for ONE replica.

    The returned step takes the stacked state (leading dim W on every leaf
    of params and opt_state) and per-worker batches (leading dim W; with
    ``accum_steps > 1`` a leading ``(accum_steps, W)``), and returns
    (new_state, metrics) with the metrics ``wire_bytes``, ``comm_events``,
    ``loss`` (mean over replicas and microbatches) and
    ``replica_divergence``, and under a policy that scales ``loss_scale``
    (the scale this step used) and ``overflow``."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    policy = PR.get_policy(policy)
    host = {"tensor": None, "t": 0}  # the last step tensor made, its value
    # the accumulator only needs the replica-axis layout, which a two-tier
    # HierComm takes from its inner comm (both tiers declare lead_axes)
    acc_fab = Fabric(comm.inner if isinstance(comm, HierComm) else comm,
                     bucket_bytes)

    def accum_grads(lfn, src, batches):
        """Sum of the microbatches' gradients in flat f32 buckets, in
        microbatch order, and the sum of their replica-mean losses: no
        collective runs in here."""
        lay = acc_fab.layout(src)
        dev = T.leaves(src)[0].device
        acc = acc_fab.init_accum(lay, dev)
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        def add(w, grads_w):
            acc_fab.accumulate(acc, grads_w, lay, replica=w)

        for j in range(accum_steps):
            loss, _ = _replica_grads(lfn, src, _replica(batches, j), add)
            loss_sum = loss_sum + loss.mean()
        return acc, lay, loss_sum

    owns_params = strategy.owns_params
    part_accum = accum_steps > 1 and strategy.partitioned_accum

    def accum_grads_part(lfn, full, batches):
        """ZeRO-2/3 accumulation: each microbatch's gradients go replica
        by replica into padded stacked buckets, which are reduce-scattered
        (an f32 wire, as the reference's) and added into the 1/W shard
        accumulator, then freed.  Returns (summed shard buckets, the sum
        of the replica-mean losses, the reduce-scatter bytes and events);
        the caller divides the shards once."""
        fab = Fabric(comm, bucket_bytes)
        play = fab.partitioned_layout(full)
        dev = T.leaves(full)[0].device
        acc = fab.init_accum_partitioned(play, dev)
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        wire = ev = torch.zeros((), dtype=torch.float32)
        for j in range(accum_steps):
            mb = fab.init_accum(play.layout, dev, play=play)

            def add(w, grads_w, mb=mb):
                fab.accumulate(mb, grads_w, play.layout, replica=w)

            loss, _ = _replica_grads(lfn, full, _replica(batches, j), add)
            _, m = fab.accumulate_partitioned_buckets(acc, mb, play)
            del mb
            loss_sum = loss_sum + loss.mean()
            wire, ev = wire + m["wire_bytes"], ev + m["comm_events"]
        return acc, loss_sum, wire, ev

    def divisor(x, dev):
        # a device tensor, never a host scalar: CUDA divides by a host
        # scalar through its reciprocal, which rounds differently
        return torch.as_tensor(x, dtype=torch.float32).to(dev)

    def next_t(state):
        return host["t"] if state["step"] is host["tensor"] \
            else int(state["step"])

    def finish(new_state, t, metrics, loss):
        host.update(tensor=new_state["step"], t=t + 1)
        metrics = dict(metrics)
        metrics["loss"] = loss
        params = new_state["params"]
        metrics["replica_divergence"] = _stack_divergence(
            strategy.gather_params(params, comm) if owns_params else params)
        return new_state, metrics

    def step(state, batches):
        sstate = state.get("loss_scale")
        src = state.get("master", state["params"])
        # ZeRO-3: the params are shard buckets; the full tree is gathered
        # for the forward and backward only
        fwd = strategy.gather_params(src, comm) if owns_params else src
        t = next_t(state)
        boundary_wire = None

        def policy_loss(p_src, batch):
            # the forward consumes the param-dtype image of the (possibly
            # wider) source of truth; the backward runs through that cast
            loss = loss_fn(policy.cast_to_param(p_src), batch)
            return loss * sstate["scale"] if sstate is not None else loss

        if accum_steps == 1:
            loss, grads = _replica_grads(policy_loss, fwd, batches)
            grads = (PR.unscale_grads(grads, sstate["scale"])
                     if sstate is not None
                     else PR.cast_floats(grads, torch.float32))
            mean_loss = loss.mean()
        else:
            if part_accum:
                acc, loss_sum, *boundary_wire = accum_grads_part(
                    policy_loss, fwd, batches)
            else:
                acc, lay, loss_sum = accum_grads(policy_loss, fwd, batches)
            # one division at the boundary: microbatch mean AND unscale
            k = divisor(accum_steps, loss_sum.device)
            ks = k * sstate["scale"] if sstate is not None else k
            grads = [a.div_(ks) for a in acc]
            if not part_accum:  # shard buckets stay buckets
                grads = lay.debucketize(grads, cast=False)
            del acc
            mean_loss = loss_sum / k
        del fwd
        finite = PR.tree_finite(grads) if sstate is not None else None
        # the skip is decided before anything is written: the update
        # writes params, master, m, v and the codec residuals in place
        apply = finite is None or bool(finite)
        if not apply:  # nothing updated, no boundary exchange
            new_src, opt_state, comm_state = (src, state["opt_state"],
                                              state["comm_state"])
            metrics = acc_fab.metrics(0.0, events=0.0)
        elif part_accum:
            new_src, opt_state, comm_state, metrics = \
                strategy.update_partitioned(
                    src, grads, state["opt_state"], state["comm_state"], t,
                    optimizer, comm)
        else:
            new_src, opt_state, comm_state, metrics = strategy.update(
                src, grads, state["opt_state"], state["comm_state"], t,
                optimizer, comm)
        del grads
        metrics = dict(metrics)
        if boundary_wire is not None:  # the microbatches' reduce-scatters
            metrics["wire_bytes"] = metrics["wire_bytes"] + boundary_wire[0]
            metrics["comm_events"] = metrics["comm_events"] \
                + boundary_wire[1]
        new_state = {"opt_state": opt_state, "comm_state": comm_state,
                     "step": state["step"] + 1}
        if "master" in state:
            new_state["master"] = new_src
            new_state["params"] = (policy.cast_to_param(new_src) if apply
                                   else state["params"])
        else:
            new_state["params"] = new_src
        if sstate is not None:
            new_state["loss_scale"] = PR.next_scale_state(policy, sstate,
                                                          finite)
            metrics["loss_scale"] = sstate["scale"]
            metrics["overflow"] = 1.0 - finite.float()
            mean_loss = mean_loss / sstate["scale"]
        return finish(new_state, t, metrics, mean_loss)

    return step


# ---------------------------------------------------------------------------
# the global (unstacked) shard-bucket state of the partitioned layout
# ---------------------------------------------------------------------------
def zero1_opt_template(params, optimizer: Optimizer, n_parts: int,
                       bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                       policy: Optional[PrecisionPolicy] = None):
    """GLOBAL optimizer state of the partitioned layout: one padded flat
    f32 bucket a state leaf, for one (unstacked) ``params`` tree.  Meta
    ``params`` give a meta template (no allocation); real ones give
    zeros, and under a master-keeping policy ``{"opt": <inner>,
    "master": <the buckets FROM the params>}`` (zeros would reset the
    model on the first step)."""
    play = PartitionedLayout.build(
        BucketLayout.build(params, bucket_bytes, lead_axes=0), n_parts)
    meta = [torch.empty((p,), dtype=torch.float32, device="meta")
            for p in play.padded_sizes]
    template = state_template(optimizer, meta)
    keeps_master = policy is not None and policy.keeps_master
    if all(x.device.type == "meta" for x in T.leaves(params)):
        return {"opt": template, "master": meta} if keeps_master \
            else template
    dev = T.leaves(params)[0].device
    zeros = T.tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                             device=dev), template)
    if keeps_master:
        return {"opt": zeros,
                "master": zero1_master_buckets(params, n_parts,
                                               bucket_bytes)}
    return zeros


def zero1_master_buckets(params, n_parts: int,
                         bucket_bytes: int = DEFAULT_BUCKET_BYTES):
    """The f32 master in GLOBAL form (padded flat buckets) from the
    params: what the "master" entry of the partitioned opt state holds
    before the first step."""
    lay = BucketLayout.build(params, bucket_bytes, lead_axes=0)
    play = PartitionedLayout.build(lay, n_parts)
    return [torch.nn.functional.pad(b, (0, p - b.shape[-1]))
            for b, p in zip(lay.bucketize(params), play.padded_sizes)]


def zero3_param_template(params, n_parts: int,
                         bucket_bytes: int = DEFAULT_BUCKET_BYTES):
    """GLOBAL parameter state of ZeRO-3: one padded flat f32 bucket a param
    bucket, for one (unstacked) ``params`` tree; meta ``params`` give
    meta buckets, real ones the buckets filled FROM the params."""
    if all(x.device.type == "meta" for x in T.leaves(params)):
        play = PartitionedLayout.build(
            BucketLayout.build(params, bucket_bytes, lead_axes=0), n_parts)
        return [torch.empty((p,), dtype=torch.float32, device="meta")
                for p in play.padded_sizes]
    return zero1_master_buckets(params, n_parts, bucket_bytes)


# ---------------------------------------------------------------------------
# the sharded production step: one replica a rank process
# ---------------------------------------------------------------------------
def data_comm(mesh) -> ShardComm:
    """The data-parallel ``ShardComm`` of a mesh: the group over its batch
    axes ("pod" and/or "data"; both together act as one group of their
    product)."""
    axes = tuple(a for a in BATCH_AXES if a in mesh.axes)
    if not axes:
        raise ValueError(f"mesh axes {mesh.axes} hold no batch axis "
                         f"({BATCH_AXES})")
    return mesh.comm(axes)


def model_comm(mesh) -> Optional[ShardComm]:
    """The mesh's "model" ``ShardComm`` (``Mesh.shared_comm``, which the
    layers' collectives count in too), or None without a "model" axis of
    more than one rank."""
    if mesh.sizes.get("model", 1) < 2:
        return None
    return mesh.shared_comm("model")


def check_model_axis(cfg) -> None:
    """Raise ``NotImplementedError`` for what the port's "model" axis does
    not cover.  ``sharding_mode="tp"`` covers every stack the training
    forward takes: attention (self and cross, so the encoder too), the
    dense MLP, the MoE experts (expert parallelism), Mamba and mLSTM
    (split) and sLSTM (replicated).  ``sharding_mode="cp"`` covers
    attention stacks with dense-MLP or MoE FFNs (the MoE on the data
    rank's gathered rows) and encoders (one memory all-gather a step);
    with recurrent mixers it raises (ROADMAP.md Queue 1 item 11d part
    3)."""
    if cfg.sharding_mode == "cp":
        check_cp(cfg)
    elif cfg.sharding_mode != "tp":
        raise ValueError(f"sharding_mode must be 'tp' or 'cp', got "
                         f"{cfg.sharding_mode!r}")


def _sync_strategy(zero_stage: int, pod_compressor, bucket_bytes: int,
                   policy: Optional[PrecisionPolicy]) -> Strategy:
    """The strategy of the sharded step's own paths: ``sync`` (with the
    pod compressor) or ``sync_zero{1,2,3}``."""
    if zero_stage:
        return ST.get_strategy(f"sync_zero{zero_stage}",
                               bucket_bytes=bucket_bytes, policy=policy)
    return ST.sync(pod_compressor, bucket_bytes=bucket_bytes, policy=policy)


def make_sharded_train_step(cfg, optimizer: Optimizer, mesh,
                            strategy: Optional[Strategy] = None,
                            comm=None, remat: bool = True,
                            pod_compressor=None,
                            partition_grads: bool = False,
                            bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                            policy: Optional[PrecisionPolicy] = None,
                            accum_steps: int = 1, zero_stage: int = 0,
                            param_template=None, loss_fn=None):
    """Port of ``repro/train/loop.py::make_sharded_train_step``: the step of
    ONE rank of ``mesh`` (``launch/mesh.py``).  ``step(state, batch)``
    takes this rank's state and batch rows (a dict of "tokens" and
    "labels", each with a leading ``accum_steps`` axis when it is > 1) and
    returns ``(new_state, loss)``, the loss the mean over the batch ranks
    (the replica step's order: over the ranks, then over the
    microbatches).

    ``strategy=None``: synchronous data parallelism, the gradients
    all-meaned over the batch ranks by the ``Fabric``, one collective
    pair a bucket a boundary.  ``pod_compressor``: the same exchange
    compressed with error feedback (``state["comm_state"]["residual"]``).
    ``zero_stage`` 1/2/3 (``partition_grads`` is stage 1): the gradients
    are reduce-scattered, ``state["opt_state"]`` holds this rank's chunk
    of ``zero1_opt_template``'s buckets, the shard update is all-gathered
    back (stages 1/2); stage 2 reduce-scatters every microbatch into a
    1/W accumulator; stage 3's ``state["params"]`` are this rank's chunks
    of ``zero3_param_template`` and ``param_template`` (the full model's
    tensors, meta ones will do) gives their layout.  These paths run the
    strategy of the same name (``sync``, ``sync_zero1/2/3``) over the
    mesh's batch group.  With a ``strategy`` and its ``comm`` (a
    ``ShardComm`` or ``ShardHierComm``) that strategy exchanges and steps
    (the reference's tree-space accumulation is the same f32 adds in the
    same order, here in the flat buckets).

    One body serves every path, the replica step's, rank for replica:
    the same local gradients, the same bucket adds and division, the same
    strategy update, whose reductions sum in rank order; so a run of W
    ranks is bitwise ``make_replica_train_step`` with the matching
    strategy.  One exception, as in the reference: under a policy with a
    narrow wire, ZeRO-2/3's per-microbatch reduce-scatter ships the
    policy's wire dtype here (the reference's sharded step) and f32 in
    the replica step (the reference's replica step).

    A "model" axis of T ranks (the module docstring): ``state`` is this
    rank's ``init_sharded_state`` over its model shard, whose params,
    master, optimizer and comm state are ``{"rep": ..., "split": ...}``;
    the loss runs under ``tp_context`` and ``use_mesh`` and back-propagates
    with the cotangent 1/T, the replicated leaves' gradients are
    all-summed over the model group (``finalize_grads``, every
    microbatch), and each part runs the batch group's path.  The skip
    flag is MIN-reduced over the model group too, so every rank of the
    mesh takes the same decision; the loss is the same on every model
    rank.  ``param_template`` (ZeRO-3) is the FULL model's tensors here
    too.  A ``strategy`` (any of the spectrum, with its ``comm`` over the
    batch group: ``mesh.comm("data")``, or a ``HierComm`` of the "data"
    and "pod" groups for ``hierarchical``) runs per part as the sync
    paths do.  Under ``sharding_mode="cp"`` (the module docstring) the
    state is one part, ``{"rep": ...}``, the loss runs under
    ``cp_context`` with the same cotangent 1/T and every gradient is
    all-summed over the model group.  ``cp`` with recurrent mixers
    raises ``NotImplementedError`` (``check_model_axis``).

    A policy that scales decides the skip before anything is written, as
    the replica step: the finite flag of this rank's gradients (ZeRO-2/3
    at accum > 1: of its reduced shards) is MIN-reduced over the ranks,
    read on the host, and a skipped boundary runs no exchange and no
    update.  ``loss_fn`` (default ``make_loss_fn(cfg, remat)``) takes
    ``(params, batch)``."""
    if partition_grads:  # the reference's spelling of the first stage
        zero_stage = max(zero_stage, 1)
    if zero_stage not in (0, 1, 2, 3):
        raise ValueError(f"zero_stage must be 0..3, got {zero_stage}")
    if zero_stage and (pod_compressor is not None or strategy is not None):
        raise ValueError("partition_grads composes with the plain sync "
                         "path only (no pod_compressor / strategy)")
    if zero_stage >= 3 and param_template is None:
        raise ValueError("zero_stage=3 needs param_template (the FULL "
                         "model's tensors, meta ones will do) for the "
                         "shard-bucket layout")
    if strategy is not None and pod_compressor is not None:
        raise ValueError("pod_compressor is the plain sync path's; a "
                         "strategy brings its own compressor")
    if strategy is not None and comm is None:
        raise ValueError("a strategy needs its comm (ShardComm or "
                         "ShardHierComm)")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    policy = None if policy is None else PR.get_policy(policy)
    if policy is not None and policy.is_noop:
        policy = None  # f32: the policy-less path bit for bit
    scaling = policy is not None and policy.uses_scaling
    loss_fn = loss_fn or make_loss_fn(cfg, remat=remat)
    if mesh.sizes.get("model", 1) > 1:
        check_model_axis(cfg)
    mc = model_comm(mesh)
    tp_n = 1 if mc is None else mc.size
    cp = mc is not None and cfg.sharding_mode == "cp"
    names = _part_names(mc is not None, cfg)
    dp = data_comm(mesh)
    if strategy is None:
        strategy = _sync_strategy(zero_stage, pod_compressor, bucket_bytes,
                                  policy)
        comm = dp
    part_accum = accum_steps > 1 and strategy.partitioned_accum
    # the accumulator (and ZeRO-2/3's microbatch reduce-scatter, on the
    # policy's wire as the reference's sharded step) over the batch ranks
    fab = Fabric(dp, bucket_bytes,
                 wire_dtype=policy.wire_dt if policy is not None else None)
    z3_plays = None
    if zero_stage >= 3:
        z3_plays = [PartitionedLayout.build(
            BucketLayout.build(tree, bucket_bytes, lead_axes=0), dp.size)
            for tree in _parts(model_shard(param_template, mesh, cfg),
                               names)]
    host = {"tensor": None, "t": 0}

    def gather(src):
        """The full params of the forward, part by part: ZeRO-3
        all-gathers its shard buckets (a temporary of the step, never
        state)."""
        if names != (None,) and sorted(src) != sorted(names):
            raise ValueError(f"a state of parts {sorted(src)} for a step "
                             f"of parts {list(names)}: build it with "
                             "init_sharded_state(..., cfg=) of this cfg")
        if z3_plays is not None:
            return _join([fab.unpartition(x, play) for x, play in
                          zip(_parts(src, names), z3_plays)], names)
        return strategy.gather_params(src, comm) if strategy.owns_params \
            else src

    def value_and_grad(full, batch, scale):
        """cast-params → forward → scaled loss → this rank's gradients, in
        the parts of ``full``; on a model axis under the TP context, with
        the cotangent 1/T and the replicated leaves' gradients completed
        over the model group."""
        def lfn(p, b):
            if policy is not None:
                p = policy.cast_to_param(p)
            loss = loss_fn(p, b)
            return loss * scale if scaling else loss
        if mc is None:
            return _local_grads(lfn, full, batch)
        if cp:
            with use_mesh(mesh), cp_context(tp_n, mc, bucket_bytes) as ctx:
                loss, grads = _local_grads(lfn, full["rep"], batch,
                                           weight=1.0 / tp_n)
                grads = ctx.finalize_grads(grads)
            return loss, {"rep": grads}
        experts = _has_moe(full["split"])
        with use_mesh(mesh), TP.tp_context(tp_n, mc, bucket_bytes,
                                           experts=experts) as tp:
            loss, grads = _local_grads(
                lfn, TP._merge_trees(full["rep"], full["split"]), batch,
                weight=1.0 / tp_n)
            grads = tp.finalize_grads(grads)
        return loss, _split_like(grads, full)

    def micro(batch, j):
        return T.tree_map(lambda b: b[j], batch)

    def boundary_divisor(dev, scale):
        # a device tensor, as the replica step's: CUDA divides by a host
        # scalar through its reciprocal, which rounds differently
        k = torch.as_tensor(accum_steps, dtype=torch.float32).to(dev)
        return k * scale if scaling else k

    def accum_grads(full, batch, scale):
        """The microbatches' gradients added into flat f32 buckets, no
        collective, divided once at the boundary: ZeRO-2/3 reduce-scatter
        each microbatch's buckets as they come and only the 1/W shard
        accumulates.  Returns (gradient tree, or shard buckets under
        ZeRO-2/3; the per-microbatch losses)."""
        dev = T.leaves(full)[0].device
        lays, accs = [], []
        for tree in _parts(full, names):
            lay = (fab.partitioned_layout(tree) if part_accum
                   else fab.layout(tree))
            lays.append(lay)
            accs.append(fab.init_accum_partitioned(lay, dev) if part_accum
                        else fab.init_accum(lay, dev))
        losses = []
        for j in range(accum_steps):
            loss, grads = value_and_grad(full, micro(batch, j), scale)
            parts = _parts(grads, names)
            del grads  # each part is freed once it is added
            for i, (lay, acc) in enumerate(zip(lays, accs)):
                g, parts[i] = parts[i], None
                if part_accum:
                    mb = fab.init_accum(lay.layout, dev, play=lay)
                    fab.accumulate(mb, g, lay.layout)
                    del g
                    fab.accumulate_partitioned_buckets(acc, mb, lay)
                    del mb
                else:
                    fab.accumulate(acc, g, lay)
                    del g
            losses.append(loss)
        ks = boundary_divisor(dev, scale)
        out = []
        for lay, acc in zip(lays, accs):
            acc = [a.div_(ks) for a in acc]
            out.append(acc if part_accum
                       else lay.debucketize(acc, cast=False))
        return _join(out, names), losses

    def mean_loss(losses):
        """The replica step's loss from every rank's microbatch losses:
        the rank mean of each microbatch, summed, over ``accum_steps``."""
        every = dp.gather_scalars(torch.stack(losses))  # (W, accum)
        if accum_steps == 1:
            return every[:, 0].mean()
        total = torch.zeros((), dtype=torch.float32, device=every.device)
        for j in range(accum_steps):
            total = total + every[:, j].mean()
        return total / torch.as_tensor(accum_steps, dtype=torch.float32
                                       ).to(every.device)

    def next_t(state):
        return host["t"] if state["step"] is host["tensor"] \
            else int(state["step"])

    def step(state, batch):
        sstate = state.get("loss_scale")
        scale = sstate["scale"] if scaling else None
        t = next_t(state)
        src = state.get("master", state["params"])
        full = gather(src)
        if accum_steps == 1:
            loss, grads = value_and_grad(full, batch, scale)
            losses = [loss]
            grads = (PR.unscale_grads(grads, scale) if scaling
                     else PR.cast_floats(grads, torch.float32))
        else:
            grads, losses = accum_grads(full, batch, scale)
        del full
        # the skip is decided before anything is written, by every rank
        # alike: the update writes params, master, m, v and residuals in
        # place
        finite = True
        if scaling:
            flag = PR.tree_finite_across(grads, dp)
            if mc is not None:  # every rank of the mesh alike
                flag = mc.all_min(flag.float()) > 0.5
            finite = bool(flag)
        if not finite:
            new_src, opt_state, cstate = (src, state["opt_state"],
                                          state["comm_state"])
        else:
            update = (strategy.update_partitioned if part_accum
                      else strategy.update)
            outs = [update(*args, t, optimizer, comm) for args in zip(
                _parts(src, names), _parts(grads, names),
                _parts(state["opt_state"], names),
                _parts(state["comm_state"], names))]
            new_src, opt_state, cstate = (_join([o[i] for o in outs], names)
                                          for i in range(3))
            del outs
        del grads
        new_state = {"opt_state": opt_state, "comm_state": cstate,
                     "step": state["step"] + 1}
        if "master" in state:
            new_state["master"] = new_src
            new_state["params"] = (policy.cast_to_param(new_src) if finite
                                   else state["params"])
        else:
            new_state["params"] = new_src
        loss = mean_loss(losses)
        if scaling:
            dev = sstate["scale"].device
            new_state["loss_scale"] = PR.next_scale_state(
                policy, sstate, torch.tensor(finite, device=dev))
            loss = loss / sstate["scale"]
        host.update(tensor=new_state["step"], t=t + 1)
        return new_state, loss

    def params_of(state):
        """This rank's full param tree (its model shard, the parts
        merged); ZeRO-3 all-gathers it over the batch group, a collective
        every rank of the group calls."""
        full = gather(state["params"])
        if mc is None:
            return full
        return full["rep"] if cp else TP._merge_trees(full["rep"],
                                                      full["split"])

    def local_grads(state, batch):
        """(loss, this rank's gradients) of one batch (``accum_steps`` 1)
        as the step computes them before the batch group's exchange: f32,
        unscaled, the model axis's replicated leaves completed."""
        sstate = state.get("loss_scale")
        scale = sstate["scale"] if scaling else None
        loss, grads = value_and_grad(
            gather(state.get("master", state["params"])), batch, scale)
        grads = (PR.unscale_grads(grads, scale) if scaling
                 else PR.cast_floats(grads, torch.float32))
        return (loss / scale if scaling else loss), grads

    step.comm = dp  # its counters say what the step shipped
    step.model_comm = mc  # the model group's: the TP and EP collectives
    step.params_of = params_of
    step.local_grads = local_grads
    return step


def init_sharded_state(params, optimizer: Optimizer, mesh,
                       zero_stage: int = 0, pod_compressor=None,
                       policy: Optional[PrecisionPolicy] = None,
                       bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                       strategy: Optional[Strategy] = None, comm=None,
                       cfg=None):
    """This rank's train state for ``make_sharded_train_step`` from the
    full (replicated) ``params``: the replica step's ``init_train_state``
    over the rank's ``ShardComm`` with the matching strategy (``sync``,
    the pod compressor, ``sync_zero{1,2,3}``), so a ZeRO state holds the
    rank's chunk of every global shard bucket (the optimizer state, the
    master, ZeRO-3's params), a compressed one the residual; or with the
    given ``strategy`` over its ``comm`` (the batch group's).  On a
    "model" axis it is built over this rank's model shard of ``cfg``'s
    placement (``model_shard``), part by part: each entry ``{"rep": ...,
    "split": ...}``, or ``{"rep": ...}`` under ``sharding_mode="cp"``
    (the step counter and the loss scale once)."""
    pol = None if policy is None else PR.get_policy(policy)
    if strategy is None:
        strategy = _sync_strategy(zero_stage, pod_compressor, bucket_bytes,
                                  pol)
        comm = data_comm(mesh)
    elif comm is None:
        raise ValueError("a strategy needs its comm (the batch group's)")
    if mesh.sizes.get("model", 1) < 2:
        return init_train_state(params, optimizer, strategy, comm,
                                policy=policy)
    if cfg is None:
        raise ValueError("a state on a \"model\" axis needs its cfg (the "
                         "placement of its sharding_mode)")
    shard = model_shard(params, mesh, cfg)
    names = tuple(shard)
    states = [init_train_state(shard[n], optimizer, strategy, comm,
                               policy=policy) for n in names]
    out = {k: v for k, v in states[0].items()
           if k in ("step", "loss_scale")}
    for k in states[0]:
        if k not in out:
            out[k] = {n: st[k] for n, st in zip(names, states)}
    return out


def model_shard(params, mesh, cfg):
    """This rank's model shard of the full ``params`` under ``cfg``'s
    ``sharding_mode``, one entry a part (``_part_names``): ``{"rep":
    replicated leaves, "split": split leaves}`` (``params`` itself without
    a "model" axis), ``tensor_parallel.tp_rank_params`` at the rank's
    "model" coordinate, the MoE expert banks split on their expert axis
    where it divides (``splits_experts``); under ``sharding_mode="cp"``
    every leaf is replicated: ``{"rep": params}``."""
    n = mesh.sizes.get("model", 1)
    if n < 2:
        return params
    if _part_names(True, cfg) == ("rep",):
        return {"rep": params}
    experts = TP.splits_experts(params, n)
    shard = TP.tp_rank_params(params, n, mesh.coords["model"],
                              experts=experts)
    rep, split = TP._partition_replicated(shard, experts=experts)
    return {"rep": rep, "split": split}


def _part_names(model_axis: bool, cfg):
    """The state's parts: the whole tree (no "model" axis), the replicated
    and split leaves (``tp``), or the replicated ones alone (``cp``)."""
    if not model_axis:
        return (None,)
    return ("rep",) if cfg.sharding_mode == "cp" else ("rep", "split")


def _parts(tree, names):
    return [tree] if names == (None,) else [tree[n] for n in names]


def _join(values, names):
    return values[0] if names == (None,) else dict(zip(names, values))


def _has_moe(tree) -> bool:
    return any(k == "moe" or (isinstance(v, dict) and _has_moe(v))
               for k, v in tree.items())


def _split_like(tree, parts):
    """``tree`` (the merged shard tree) cut into the two-part structure of
    ``parts`` ({"rep": ..., "split": ...})."""
    def take(t, like):
        return {k: take(t[k], v) if isinstance(v, dict) else t[k]
                for k, v in like.items()}

    return {n: take(tree, parts[n]) for n in ("rep", "split")}


def _stack_divergence(params):
    """Max |w_i − w_0| over replicas, the model-consistency measure of §3.
    Replica by replica, so the temporaries stay one replica's size."""
    out = []
    for x in T.leaves(params):
        if x.dim() > 0 and x.shape[0] > 1:
            out.append(torch.stack([(x[i] - x[0]).abs().max()
                                    for i in range(1, x.shape[0])]).max()
                       .float())
        else:
            out.append(torch.zeros((), dtype=torch.float32, device=x.device))
    return torch.stack(out).max() if out else torch.zeros(())
