"""Elastic fault-tolerant fleet training on the stacked simulator.

Port of ``repro/launch/elastic.py``.  Worker failure, preemption, slowness
and (re)join are boundary events instead of run-killers.  Four pieces:

  * :class:`FleetView`: epoch-numbered membership.  Workers keep stable
    global ids; ranks are their index in the sorted member tuple, so the
    ranks after any transition are deterministic.  Every transition bumps
    ``epoch``; membership changes only at optimizer boundaries.
  * :func:`resize_state`: the in-memory W → W′ re-partition.  ZeRO
    shard-bucket state goes through ``core/resharding.py``'s
    ``repartition_tree`` on tensors, the same ``reshard_bucket`` the
    checkpoint restore applies, so the live resize is bitwise a
    ``save → restore(repartition=True)`` round trip with no disk.  Dense
    replica-stacked state is row-gathered (survivors keep their row,
    joiners copy the sync consensus row).
  * :func:`make_elastic_replica_step`: a dense-sync boundary step that
    takes the fleet's participation mask as a (W,) f32 tensor on the
    device: demotion and promotion change its values only.  Demoted
    workers keep taking local optimizer steps and are pulled back to the
    sync consensus every ``resync_every`` boundaries.
  * :class:`ElasticFleet`: the boundary-driven controller wiring it to
    the chaos harness (``core/chaos.py``) and the straggler detector
    (``core/staleness.py``): graceful preempt and rejoin resizes, bounded
    retry with exponential backoff on an exchange failure, and graceful
    degradation (workers still failing after the retries are dropped and
    the surviving fleet re-runs the boundary from the last consistent
    state: state commits only on success).

Differences from the reference, none of which changes a result:
  * the demoted resync is decided on the host from the step as a Python
    int, as the port's strategies decide their schedules; the reference
    gates it with ``lax.cond`` on a traced step.  On a boundary without a
    resync no collective runs and no bytes move;
  * ``ssp``'s ring is a tuple of s trees of ``(W, …)`` leaves
    (``core/strategies.py``), which the reference's worker-axis test would
    pass and row-gather; ``resize_state`` rejects it explicitly, with the
    reference's message;
  * a leaf whose W rows are one storage (stride 0 on the replica axis:
    ZeRO-1's params) resizes to a stride-0 view of the new width.  Its
    values are the row-gather's, without W′ copies;
  * ZeRO-3's recorded layout is re-primed by ``strategy.init_params`` on
    meta tensors of the new width, the reference's ``eval_shape``;
  * the masked sums run bucket by bucket through ``Fabric.all_sum``, and
    the blends leaf by leaf into new tensors, so a step holds one
    weighted bucket at a time and every tree it hands the fused Adam
    update has rows of their own storage.

Scope: plain ``LocalComm`` (lead axis 0).  A state whose leaves have no
leading worker axis fails loudly in ``resize_dense_tree``.  The masked
exchange and the demoted resync also run over a ``ShardComm``, a rank's
own leaves against its entry of the mask, as the reference's run under
``shard_map`` (``repro_torch.analysis`` lints the resync's calls there).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import tree as T
from repro_torch.core.chaos import ChaosSchedule, ExchangeFailure, FleetClock
from repro_torch.core.comm import LocalComm
from repro_torch.core.fabric import DEFAULT_BUCKET_BYTES, Fabric
from repro_torch.core.resharding import repartition_tree
from repro_torch.core.staleness import StragglerDetector, StragglerPolicy
from repro_torch.data.pipeline import _to_device
from repro_torch.train.loop import _replica_grads


# ---------------------------------------------------------------------------
# membership
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class FleetView:
    """One epoch of fleet membership.

    ``members`` are stable global worker ids (sorted); a worker's rank is
    its index in the tuple.  ``demoted`` members still hold a rank and a
    replica row but sit in the local-step tier (mask 0).  Transitions
    return a NEW view with ``epoch + 1``."""

    epoch: int
    members: tuple
    demoted: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "members", tuple(sorted(set(self.members))))
        object.__setattr__(
            self, "demoted",
            tuple(sorted(set(self.demoted) & set(self.members))))

    @property
    def size(self) -> int:
        return len(self.members)

    def rank_of(self, worker) -> int:
        return self.members.index(worker)

    def mask(self) -> np.ndarray:
        """(W,) f32 participation mask: 1 = sync tier, 0 = demoted."""
        return np.array([0.0 if w in self.demoted else 1.0
                         for w in self.members], np.float32)

    def without(self, *workers) -> "FleetView":
        return FleetView(self.epoch + 1,
                         tuple(w for w in self.members if w not in workers),
                         self.demoted)

    def with_joined(self, *workers) -> "FleetView":
        return FleetView(self.epoch + 1, self.members + tuple(workers),
                         self.demoted)

    def with_demoted(self, demoted) -> "FleetView":
        return FleetView(self.epoch + 1, self.members, tuple(demoted))


# ---------------------------------------------------------------------------
# in-memory resize
# ---------------------------------------------------------------------------
def _row_index(old_view: FleetView, new_view: FleetView) -> np.ndarray:
    """Old-row index for each new member: survivors keep their own row,
    joiners copy the consensus row (the first surviving sync-tier member:
    sync training keeps those rows identical, so the choice is exact)."""
    common = [w for w in new_view.members if w in old_view.members]
    if not common:
        raise ValueError("resize with no surviving member — nothing to "
                         "carry the fleet state across the transition")
    sync_common = [w for w in common if w not in old_view.demoted]
    consensus = old_view.rank_of((sync_common or common)[0])
    return np.array([old_view.rank_of(w) if w in old_view.members
                     else consensus for w in new_view.members])


def _not_resizable(what) -> ValueError:
    return ValueError(f"{what} — not elastically resizable (stacked "
                      "replica-first layout required)")


def resize_dense_tree(tree, old_view: FleetView, new_view: FleetView):
    """Row-gather every stacked (W, …) leaf from the old view's rows to
    the new view's, into new tensors (the input is left untouched).  A
    leaf whose rows are one storage (stride 0 on axis 0) becomes a
    stride-0 view of the new width: every row is row 0, so the values are
    the gather's.  Leaves without a leading worker axis are rejected."""
    idx = _row_index(old_view, new_view)
    w, w_new = old_view.size, new_view.size
    on = {}  # the index tensor, a device

    def one(x):
        if getattr(x, "ndim", 0) == 0 or x.shape[0] != w:
            raise _not_resizable(
                f"leaf with shape {tuple(getattr(x, 'shape', ()))} has no "
                f"leading worker axis of size {w}")
        if w > 1 and x.stride(0) == 0:
            return x[:1].expand((w_new,) + tuple(x.shape[1:]))
        if x.device not in on:  # pinned, non-blocking: no wait on the card
            on[x.device] = _to_device(torch.from_numpy(idx), x.device)
        return x[on[x.device]]

    return T.tree_map(one, tree)


def resize_state(state, old_view: FleetView, new_view: FleetView, *,
                 strategy=None, bucket_bytes: int = DEFAULT_BUCKET_BYTES):
    """Re-partition a train state in memory for a fleet transition.

    ZeRO shard-bucket state (``sync_zero1/2`` opt shards, ``sync_zero3``
    parameter shards) is re-sharded by ``repartition_tree``, bitwise what
    a checkpoint save → ``restore(repartition=True)`` round trip
    produces.  Dense replica-stacked state is row-gathered per
    :func:`resize_dense_tree`; ``master`` is row-gathered and
    ``loss_scale`` carried across.  ``bucket_bytes`` must match the
    strategy's own bucket layout.  Every leaf of the result is new
    storage or a view of the old state that nothing writes in place (a
    stride-0 leaf); the input state is left untouched.

    For ZeRO-3 the strategy's recorded layout is re-primed for the new
    width by ``strategy.init_params`` on meta tensors, so
    ``gather_params`` works at W′ (and no longer at W: gather the old
    width's params first)."""
    if old_view.members == new_view.members:
        return dict(state)
    # ssp's ring: a tuple of s trees, one a schedule slot, whose (W, …)
    # leaves would pass the worker-axis test
    if isinstance(state["comm_state"].get("buf"), tuple):
        raise _not_resizable(
            "ssp's ring buffer is keyed by schedule slot, not worker")
    comm_old = LocalComm(old_view.size)
    comm_new = LocalComm(new_view.size)
    owns_params = bool(strategy is not None and strategy.owns_params)
    sharded_opt = bool(strategy is not None
                       and strategy.init_opt is not None)

    new_state = {"step": state["step"]}
    sizes = None
    if sharded_opt or owns_params:
        full_old = (strategy.gather_params(state["params"], comm_old)
                    if owns_params else state["params"])
        play = Fabric(comm_old, bucket_bytes).partitioned_layout(full_old)
        sizes = play.layout.bucket_sizes

    if owns_params:
        new_state["params"] = repartition_tree(state["params"], sizes,
                                               new_view.size)
        # re-prime the recorded layout for the new width: meta tensors,
        # nothing allocated
        meta = T.tree_map(lambda x: torch.empty(
            (new_view.size,) + tuple(x.shape[1:]), dtype=x.dtype,
            device="meta"), full_old)
        strategy.init_params(meta, comm_new)
    else:
        new_state["params"] = resize_dense_tree(state["params"], old_view,
                                                new_view)

    new_state["opt_state"] = (
        repartition_tree(state["opt_state"], sizes, new_view.size)
        if sharded_opt
        else resize_dense_tree(state["opt_state"], old_view, new_view))
    new_state["comm_state"] = resize_dense_tree(state["comm_state"],
                                                old_view, new_view)
    if "master" in state:
        new_state["master"] = resize_dense_tree(state["master"], old_view,
                                                new_view)
    if "loss_scale" in state:
        new_state["loss_scale"] = state["loss_scale"]
    return new_state


# ---------------------------------------------------------------------------
# masked boundary step (straggler tiers)
# ---------------------------------------------------------------------------
def _member(fab: Fabric, mask):
    """This worker's mask entry: the (W,) mask itself on the stacked
    simulator (it aligns with the replica axis), the rank's 0-d entry
    over a ``ShardComm`` (the reference's ``_member_scalar``)."""
    return mask[fab.comm.rank] if fab._sharded else mask


def _bcast(m, x):
    """A (W,) mask against a stacked (W, …) leaf; a rank's 0-d entry as
    it is."""
    if m.dim() == 0:
        return m
    return m.reshape(m.shape + (1,) * (x.dim() - 1))


def _nsync(mask):
    # a device tensor, never a host scalar: CUDA divides by a host scalar
    # through its reciprocal, which rounds differently at W = 3
    return torch.clamp_min(mask.sum(), 1.0)


def _masked_sums(fab: Fabric, tree, mask):
    """Σ_w mask_w · x_w of every leaf of the stacked ``tree``, a (1, …) f32
    view a leaf (over a ``ShardComm``: of this rank's leaves, the sum
    itself): one ``Fabric.all_sum`` a bucket, each bucket's weighted copy
    alive only while it is summed."""
    lay = fab.layout(tree)
    m = _member(fab, mask)
    sums = [fab.all_sum([b * _bcast(m, b)])[0]
            for b in lay.bucketize(tree)]
    out = T.leaves(lay.debucketize(sums, cast=False))
    return out if fab._sharded else [s[:1] for s in out]


def masked_exchange(fab: Fabric, grads, mask):
    """Sync-tier mean with local-tier passthrough.

    Sync members (mask 1) receive sum(mask·g)/n_sync: with an all-ones
    mask at a power-of-two W this is bitwise the dense all-mean.  Demoted
    members (mask 0) keep their LOCAL gradient.  Returns (g_eff, metrics);
    ``g_eff`` is new f32 tensors, the input is left untouched."""
    nsync = _nsync(mask)
    sums = _masked_sums(fab, grads, mask)
    flat, tdef = T.flatten(grads)
    m = _member(fab, mask)

    def blend(g, s):
        gb = _bcast(m, g)
        # (1 - m)·g + m·(s / n): the reference's two terms, added in the
        # other order (an exact swap), the second in place
        return ((1.0 - gb) * g.float()).add_(gb * (s / nsync))

    g_eff = T.unflatten(tdef, [blend(g, s) for g, s in zip(flat, sums)])
    return g_eff, fab.metrics(fab.flat_bytes(grads))


def demoted_resync(fab: Fabric, params, mask, t: int, resync_every: int):
    """Recovery pull for the local tier, decided on the host.

    Every ``resync_every`` boundaries (``(t + 1) % resync_every == 0``)
    the demoted rows are reset to the sync-tier consensus, so a
    re-promoted worker rejoins from fleet state rather than its drifted
    local weights; the sync rows keep their values.  On any other
    boundary nothing runs and no bytes move.  Returns (params, did)."""
    if (t + 1) % resync_every != 0:
        return params, False
    nsync = _nsync(mask)
    sums = _masked_sums(fab, params, mask)
    flat, tdef = T.flatten(params)
    m = _member(fab, mask)

    def pull(x, s):
        gb = _bcast(m, x)
        return (gb * x.float() + (1.0 - gb) * (s / nsync)).to(x.dtype)

    return T.unflatten(tdef, [pull(x, s) for x, s in zip(flat, sums)]), True


def _masked_divergence(params, mask):
    """Max |x − sync_mean| over sync rows: 0 when the sync tier agrees.
    Row by row, so the temporaries stay one row's size."""
    n = _nsync(mask)
    out = []
    for x in T.leaves(params):
        rows = [x[i].float() for i in range(x.shape[0])]
        total = rows[0] * mask[0]
        for i in range(1, len(rows)):
            total = total + rows[i] * mask[i]
        mean = total / n
        out.append(torch.stack([((r - mean) * mask[i]).abs().max()
                                for i, r in enumerate(rows)]).max())
    return torch.stack(out).max() if out else torch.zeros(())


def make_elastic_replica_step(loss_fn, optimizer, comm: LocalComm, *,
                              resync_every: int = 8,
                              bucket_bytes: int = DEFAULT_BUCKET_BYTES):
    """Dense-sync boundary step with the participation mask as an input.

    ``step(state, batches, mask, t=None) -> (state, metrics)``: ``mask``
    is a (W,) f32 tensor on the device, so demotion and promotion change
    values only.  Gradients come replica by replica
    (``train/loop.py::_replica_grads``).  ``t`` is the step as a Python
    int when the caller keeps one (``ElasticFleet`` does); otherwise the
    step keeps it beside ``state["step"]``, as ``make_replica_train_step``
    does, and reads the tensor back only for a state it did not make.
    The metrics are ``wire_bytes``, ``comm_events``, ``loss`` (the mean
    over replicas), ``resync`` (a bool) and ``sync_divergence``.  Under
    ``adam(fused=True)`` the update writes the params, m and v it is
    given in place."""
    fab = Fabric(comm, bucket_bytes)
    host = {"tensor": None, "t": 0}  # the last step tensor made, its value

    def step(state, batches, mask, t=None):
        if t is None:
            t = host["t"] if state["step"] is host["tensor"] \
                else int(state["step"])
        loss, grads = _replica_grads(loss_fn, state["params"], batches)
        g_eff, m = masked_exchange(fab, grads, mask)
        del grads
        params, opt_state = optimizer.update(g_eff, state["opt_state"],
                                             state["params"], t)
        del g_eff
        params, did_resync = demoted_resync(fab, params, mask, t,
                                            resync_every)
        new_state = {"params": params, "opt_state": opt_state,
                     "comm_state": state["comm_state"],
                     "step": state["step"] + 1}
        host.update(tensor=new_state["step"], t=t + 1)
        metrics = dict(m)
        metrics["loss"] = loss.mean()
        metrics["resync"] = did_resync
        metrics["sync_divergence"] = _masked_divergence(params, mask)
        return new_state, metrics

    return step


# ---------------------------------------------------------------------------
# the controller
# ---------------------------------------------------------------------------
class ElasticFleet:
    """Boundary-driven elastic controller over the stacked simulator.

    Owns the :class:`FleetView`, the train state, and one step a fleet
    width.  ``run_boundary(batch_fn)`` executes one optimizer boundary
    end to end: graceful membership events → straggler demotion and
    promotion → the exchange attempt loop (bounded retry with exponential
    backoff; persistent failures degrade to the survivors) → the
    committed step.  ``batch_fn(view, t)`` must return stacked (W, …)
    batches for the CURRENT view, on the params' device.

    State is committed only when the step succeeds: a boundary that
    loses workers re-runs on the surviving fleet from the last consistent
    state.  The step is kept as a Python int beside ``state["step"]``, so
    a boundary reads one value back, its loss.  ``last_metrics`` holds
    the metrics of the last committed step."""

    def __init__(self, params, loss_fn, optimizer, *, workers: int = 4,
                 straggler_policy: StragglerPolicy | None = None,
                 resync_every: int = 8,
                 bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                 chaos: ChaosSchedule | None = None,
                 clock: FleetClock | None = None,
                 retries: int = 2, backoff_s: float = 0.01):
        self.view = FleetView(0, tuple(range(workers)))
        self.loss_fn, self.optimizer = loss_fn, optimizer
        self.resync_every = resync_every
        self.bucket_bytes = bucket_bytes
        self.chaos = chaos
        self.clock = clock or (FleetClock(workers) if straggler_policy
                               else None)
        self.retries, self.backoff_s = retries, backoff_s
        self.detector = (StragglerDetector(range(workers), straggler_policy)
                         if straggler_policy else None)
        stacked = LocalComm(workers).replicate(params)
        self.device = T.leaves(stacked)[0].device
        self.state = {"params": stacked, "opt_state": optimizer.init(stacked),
                      "comm_state": {},
                      "step": torch.zeros((), dtype=torch.int32,
                                          device=self.device)}
        self._t = 0
        self._steps = {}
        self.history = []
        self.last_metrics = None

    def _step_for(self, width: int):
        if width not in self._steps:
            self._steps[width] = make_elastic_replica_step(
                self.loss_fn, self.optimizer, LocalComm(width),
                resync_every=self.resync_every,
                bucket_bytes=self.bucket_bytes)
        return self._steps[width]

    def resize(self, new_view: FleetView) -> None:
        """Commit a membership transition at the current boundary."""
        old = self.view
        if new_view.members != old.members:
            self.state = resize_state(self.state, old, new_view,
                                      bucket_bytes=self.bucket_bytes)
        if self.detector is not None:
            for w in set(old.members) - set(new_view.members):
                self.detector.drop(w)
            for w in set(new_view.members) - set(old.members):
                self.detector.add(w)
        self.view = new_view

    def _straggler_pass(self, events, log) -> None:
        if self.clock is None:
            return
        self.clock.apply(events)
        times = self.clock.boundary_times(self.view.members)
        log["boundary_times"] = times
        if self.detector is None:
            return
        self.detector.observe(times)
        demote, promote = self.detector.to_demote(), self.detector.to_promote()
        for w in demote:
            self.detector.demote(w)
        for w in promote:
            self.detector.promote(w)
        if demote or promote:
            log["demoted"], log["promoted"] = demote, promote
            self.resize(self.view.with_demoted(self.detector.demoted))

    def _attempt_exchange(self, t: int, attempt: int, kills, flakes) -> None:
        failed = set(kills) | (set(flakes) if attempt == 0 else set())
        if failed:
            raise ExchangeFailure(
                f"boundary {t}: collective failed at attempt {attempt} "
                f"for workers {sorted(failed)}",
                workers=failed, transient=not kills)

    def run_boundary(self, batch_fn) -> dict:
        t = self._t
        events = self.chaos.at(t) if self.chaos else []
        log = {"t": t, "epoch": self.view.epoch, "size": self.view.size,
               "events": [e.spec() for e in events], "attempts": 0,
               "backoffs": []}
        # announced transitions first: rejoin/preempt resize gracefully
        joins = [e.worker for e in events
                 if e.kind == "rejoin" and e.worker not in self.view.members]
        if joins:
            self.resize(self.view.with_joined(*joins))
        pre = [e.worker for e in events
               if e.kind == "preempt" and e.worker in self.view.members]
        if pre:
            self.resize(self.view.without(*pre))
        self._straggler_pass(events, log)
        # the exchange attempt loop: flakes clear on retry, kills exhaust
        # the retries and degrade the fleet to the survivors
        kills = {e.worker for e in events
                 if e.kind == "kill" and e.worker in self.view.members}
        flakes = {e.worker for e in events
                  if e.kind == "flake" and e.worker in self.view.members}
        attempt, backoff = 0, self.backoff_s
        while True:
            try:
                self._attempt_exchange(t, attempt, kills, flakes)
                break
            except ExchangeFailure as e:
                log["attempts"] += 1
                if attempt >= self.retries:
                    if not e.transient:
                        # graceful degradation: drop the dead workers from
                        # the next epoch and re-run on the survivors
                        log["dropped"] = sorted(kills)
                        self.resize(self.view.without(*kills))
                        kills, flakes = set(), set()
                        attempt, backoff = 0, self.backoff_s
                        continue
                    raise
                log["backoffs"].append(backoff)
                time.sleep(backoff)
                backoff *= 2
                attempt += 1
        # the committed step, on whatever fleet survived
        batches = batch_fn(self.view, t)
        mask = _to_device(torch.from_numpy(self.view.mask()), self.device)
        self.state, metrics = self._step_for(self.view.size)(
            self.state, batches, mask, t=t)
        self._t = t + 1
        self.last_metrics = metrics
        log["epoch_after"] = self.view.epoch
        log["size_after"] = self.view.size
        log["loss"] = float(metrics["loss"])
        self.history.append(log)
        return log

    def run(self, n_boundaries: int, batch_fn) -> list:
        return [self.run_boundary(batch_fn) for _ in range(n_boundaries)]
