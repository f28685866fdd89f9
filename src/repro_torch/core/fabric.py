"""Bucketed flat-buffer exchange fabric.

Port of ``repro/core/fabric.py``, over both realizations of the comm:
the stacked-replica simulator (``LocalComm``) and the per-rank one
(``ShardComm``, one process a rank).  The ``Fabric`` flattens a gradient
tree into size-capped
flat f32 buckets (leaves in ``jax.tree`` order, ``core/tree.py``) and
drives each ``Comm`` primitive once per bucket.  Compression with error
feedback runs on the flat buffer: by default through the compressor's
fused encode (one kernel launch per bucket, all replicas folded into its
rows), else through the codec's compress → pack → unpack → decode round.
``wire_bytes`` is the exact size of the packed uint8 buffer a sharded
exchange would gather per bucket.

Replica safety: the ``comm.lead_axes`` leading replica axes are kept
through flattening, and every per-replica decode runs replica by replica
(``_vmap_replicas``), so a compression block never mixes two replicas.

Besides the all-mean exchange it ports the ring shift (``ppermute``), the
error-feedback compression without a collective that buffering strategies
use (``compress``) and the exchange with DGC momentum correction
(``exchange_dgc``), the wire dtype of the precision policy (uncompressed
buckets rounded to bf16 before the axis reduction, which accumulates in
f32, and counted at 2 bytes an element) and the microbatch accumulator
(``init_accum``, ``accumulate``), and the partitioned (ZeRO) half: the
``PartitionedLayout`` (each bucket zero-padded to a multiple of W, worker
w owning chunk w), the reduce-scatter exchange, the shard slice of a
replicated tree, the all-gather back (``unpartition``) and the 1/W shard
accumulator of ZeRO-2/3.

The ``ShardComm`` branches are the reference's:
  * a compressed bucket is encoded on this rank (the fused encode, one
    kernel launch a bucket), packed into ONE uint8 buffer of exactly
    ``wire_nbytes`` bytes, and all-gathered once; every peer's buffer is
    unpacked and decoded locally, and the decodes are averaged by the
    same ``mean`` over a stacked rank axis that ``LocalComm`` runs over
    its replica axis, so both realizations agree bitwise;
  * the narrow (bf16) wire ships the narrow buffer itself: a reduction is
    ONE all-to-all of the bf16 chunks (``gather_chunks``), an f32 local
    accumulate and a 16-bit all-gather of the result (the ring bytes of
    the all-reduce it replaces); a ring shift or a gather moves the 16-bit
    image (an int16 view: gloo refuses uint16).  The dense all-mean then
    hands back bf16-rounded means where ``LocalComm`` keeps them in f32;
    the partitioned exchange and ``unpartition`` agree bitwise.

``LocalComm.all_gather`` returns a broadcast view: the tree
``unpartition`` hands back holds ONE copy of each bucket behind stride 0
on the replica axis, and for an f32 leaf that copy is the shard buckets'
own storage.  Nothing of the ZeRO strategies writes such a tree in place
(the optimizer updates the shard buckets); a caller that would must copy
it first.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch.core import tree as T
from repro_torch.core.comm import ShardComm
from repro_torch.core.compression import (Compressor, _narrow_wire, _pack,
                                          _unpack, packed_nbytes)
from repro_torch.core.precision import torch_dtype

DEFAULT_BUCKET_BYTES = 4 << 20  # 4 MiB of f32 per bucket


def _prod(shape):
    n = 1
    for s in shape:
        n *= s
    return n


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class BucketLayout:
    """Static description of the tree ↔ flat-bucket correspondence.

    Leaves are assigned greedily, in tree order, to f32 buckets holding at
    most ``bucket_bytes`` (a leaf larger than the cap gets its own bucket;
    leaves are never split).  ``lead_shape`` is the common shape of the
    leading replica axes; offsets and sizes count trailing elements."""

    treedef: Any
    lead_shape: tuple
    shapes: tuple  # per-leaf trailing shape
    dtypes: tuple  # per-leaf original dtype
    sizes: tuple  # per-leaf trailing element count
    bucket_of: tuple  # leaf index -> bucket index
    offsets: tuple  # leaf offset inside its bucket (elements)
    bucket_sizes: tuple  # elements per bucket
    bucket_bytes: int

    @property
    def n_leaves(self) -> int:
        return len(self.sizes)

    @property
    def n_buckets(self) -> int:
        return len(self.bucket_sizes)

    @property
    def total_elements(self) -> int:
        return sum(self.bucket_sizes)

    @staticmethod
    def build(tree, bucket_bytes: int = DEFAULT_BUCKET_BYTES,
              lead_axes: int = 0) -> "BucketLayout":
        leaves, treedef = T.flatten(tree)
        lead_shape = tuple(leaves[0].shape[:lead_axes]) if leaves else ()
        for x in leaves:
            if tuple(x.shape[:lead_axes]) != lead_shape:
                raise ValueError(
                    f"inconsistent replica axes: {tuple(x.shape[:lead_axes])}"
                    f" vs {lead_shape} (lead_axes={lead_axes})")
        shapes = tuple(tuple(x.shape[lead_axes:]) for x in leaves)
        dtypes = tuple(x.dtype for x in leaves)
        sizes = tuple(_prod(s) for s in shapes)
        cap = max(1, bucket_bytes // 4)  # elements of f32
        bucket_of, offsets, bucket_sizes = [], [], []
        cur = -1  # no open bucket
        for sz in sizes:
            if cur < 0 or (bucket_sizes[cur] > 0
                           and bucket_sizes[cur] + sz > cap):
                bucket_sizes.append(0)
                cur += 1
            bucket_of.append(cur)
            offsets.append(bucket_sizes[cur])
            bucket_sizes[cur] += sz
        return BucketLayout(treedef, lead_shape, shapes, dtypes, sizes,
                            tuple(bucket_of), tuple(offsets),
                            tuple(bucket_sizes), bucket_bytes)

    # -- tree <-> buckets ---------------------------------------------------
    def bucketize(self, tree):
        """Tree → list of f32 buckets of shape lead_shape + (n_b,).  A
        bucket of one f32 leaf is a view of it, not a copy."""
        flats = [x.float().reshape(self.lead_shape + (-1,))
                 for x in T.leaves(tree)]
        out = []
        for b in range(self.n_buckets):
            segs = [flats[i] for i in range(self.n_leaves)
                    if self.bucket_of[i] == b]
            out.append(segs[0] if len(segs) == 1
                       else torch.cat(segs, dim=-1))
        return out

    def debucketize(self, buckets, cast: bool = True):
        """Buckets → tree (cast back to the leaf dtypes unless
        ``cast=False``, which keeps f32, as residual state does).  Leaves
        are views into the buckets where the shapes allow."""
        leaves = []
        for i in range(self.n_leaves):
            b = buckets[self.bucket_of[i]]
            seg = b[..., self.offsets[i]:self.offsets[i] + self.sizes[i]]
            seg = seg.reshape(self.lead_shape + self.shapes[i])
            leaves.append(seg.to(self.dtypes[i]) if cast else seg)
        return T.unflatten(self.treedef, leaves)


# ---------------------------------------------------------------------------
# partitioned (ZeRO) layout: every bucket padded to a multiple of W
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class PartitionedLayout:
    """BucketLayout + the ZeRO partition: each flat f32 bucket is
    zero-padded to a multiple of ``n_parts`` and worker w owns chunk w.

    What is kept in shard form (optimizer state, the master, ZeRO-3's
    params) costs ``sum(shard_sizes)`` ≈ ``total_elements / n_parts`` a
    worker.  One partitioned exchange (reduce-scatter + all-gather) ships
    the bytes of the dense all-reduce."""

    layout: BucketLayout
    n_parts: int
    padded_sizes: tuple  # per-bucket elements after padding

    @staticmethod
    def build(layout: BucketLayout, n_parts: int) -> "PartitionedLayout":
        """THE padding rule: each bucket rounds up to the next multiple of
        ``n_parts``."""
        padded = tuple(-(-n // n_parts) * n_parts
                       for n in layout.bucket_sizes)
        return PartitionedLayout(layout, n_parts, padded)

    @property
    def shard_sizes(self) -> tuple:
        return tuple(p // self.n_parts for p in self.padded_sizes)

    def spec(self) -> dict:
        """JSON-able partition description for checkpoint re-sharding."""
        return {"n_parts": self.n_parts,
                "bucket_sizes": list(self.layout.bucket_sizes)}

    def with_parts(self, n_parts: int) -> "PartitionedLayout":
        """The same bucket layout re-padded for another worker count: the
        bucket contents are invariant, only padding and chunk width
        change."""
        return PartitionedLayout.build(self.layout, n_parts)


# ---------------------------------------------------------------------------
# wire accounting (the codec itself lives in core/compression.py)
# ---------------------------------------------------------------------------
def wire_nbytes(compressor: Optional[Compressor], n: int,
                wire_dtype=torch.float32) -> int:
    """Exact packed-wire size (bytes) to ship ``n`` f32 elements once: raw
    ``wire_dtype`` buckets uncompressed (2 bytes an element under the bf16
    policy), else the compressor's packed format, which ignores
    ``wire_dtype``."""
    if compressor is None or compressor.name == "none":
        return wire_dtype.itemsize * n
    return packed_nbytes(compressor, n)


# ---------------------------------------------------------------------------
# fabric
# ---------------------------------------------------------------------------
class Fabric:
    """Bucket-fused tensor moving over a ``LocalComm`` or a ``ShardComm``:
    every public op issues at most one collective per bucket (one
    all-to-all and one all-gather a bucket for a reduction over a
    ``ShardComm``).  Residual state stays param-shaped f32 trees."""

    def __init__(self, comm, bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                 wire_dtype=None, fused: bool = True):
        self.comm = comm
        self.bucket_bytes = bucket_bytes
        # dtype of the UNCOMPRESSED wire (PrecisionPolicy.wire_dtype):
        # buckets are rounded to it before every collective; f32 (the
        # default) leaves every path bit for bit unchanged
        self.wire_dtype = (torch.float32 if wire_dtype is None
                           else torch_dtype(wire_dtype))
        # compressed exchanges go through the compressor's fused encode
        # (kernels/ops.py) when it has one; bitwise identical to the codec
        self.fused = fused

    def _wire_cast(self, buckets):
        """Round flat f32 buckets to the wire dtype.  On the stacked
        simulator the rounded values come back to f32, so the axis
        reduction accumulates in f32 (a bf16 wire with f32 ring
        accumulation, as the reference's simulator computes it); a
        ``ShardComm`` ships the narrow buffer itself."""
        if self.wire_dtype == torch.float32:
            return buckets
        narrowed = [b.to(self.wire_dtype) for b in buckets]
        if self._sharded:
            return narrowed
        return [b.float() for b in narrowed]

    @property
    def _sharded(self) -> bool:
        return isinstance(self.comm, ShardComm)

    @property
    def _narrow_sharded(self) -> bool:
        """A 16-bit wire on the per-rank realization: every reduction is
        an all-to-all of narrow chunks plus a local f32 accumulate, and
        every gather or ring shift moves the 16-bit image."""
        return self.wire_dtype.itemsize == 2 and self._sharded

    def _bitcast16(self, buckets):
        """The wire-dtype buckets as int16 images (the reference's
        uint16 bitcast; gloo refuses uint16)."""
        return [b.to(self.wire_dtype).view(torch.int16) for b in buckets]

    def _reduce_narrow_sharded(self, buckets, mean: bool):
        """All-reduce(-mean) of each flat bucket over a narrow wire: pad
        to a multiple of W, ONE all-to-all of the narrowed chunks, the W
        received chunks accumulated in f32 on this rank (the stacked
        simulator's reduction over its replica axis), and one all-gather
        of the reduced shard's 16-bit image.  Returns f32 buckets."""
        w = self.comm.size
        out = []
        for b in buckets:
            n = b.shape[-1]
            p = -(-n // w) * w
            bb = b if n == p else torch.nn.functional.pad(b, (0, p - n))
            (stacked,) = self.comm.gather_chunks([bb.to(self.wire_dtype)])
            stacked = stacked.float()
            red = stacked.mean(dim=0) if mean else stacked.sum(dim=0)
            del stacked
            (full,) = self.comm.all_gather(self._bitcast16([red]),
                                           tiled=True)
            out.append(full.view(self.wire_dtype)[..., :n].float())
        return out

    def layout(self, tree) -> BucketLayout:
        return BucketLayout.build(tree, self.bucket_bytes,
                                  self.comm.lead_axes)

    # -- plain (uncompressed) fused collectives -----------------------------
    def all_mean(self, tree):
        return self._reduce(tree, mean=True)

    def all_sum(self, tree):
        return self._reduce(tree, mean=False)

    def _reduce(self, tree, mean: bool):
        lay = self.layout(tree)
        if lay.n_leaves == 0:
            return tree
        gb = lay.bucketize(tree)
        if self._narrow_sharded:
            return lay.debucketize(self._reduce_narrow_sharded(gb, mean))
        op = self.comm.all_mean if mean else self.comm.all_sum
        return lay.debucketize(op(self._wire_cast(gb)))

    def ppermute(self, tree, shift: int = 1):
        """Ring shift of every bucket: worker w receives worker
        (w - shift) % W's value."""
        lay = self.layout(tree)
        if lay.n_leaves == 0:
            return tree
        gb = lay.bucketize(tree)
        if self._narrow_sharded:  # pure data movement: shift the 16 bits
            out = self.comm.ppermute(self._bitcast16(gb), shift)
            return lay.debucketize([b.view(self.wire_dtype) for b in out])
        return lay.debucketize(self.comm.ppermute(self._wire_cast(gb),
                                                  shift))

    # -- wire accounting ----------------------------------------------------
    def flat_bytes(self, tree_or_layout) -> float:
        """Uncompressed wire-dtype bytes to ship the tree once (all
        replicas): halves under a bf16 wire."""
        lay = tree_or_layout if isinstance(tree_or_layout, BucketLayout) \
            else self.layout(tree_or_layout)
        return float(self.wire_dtype.itemsize * lay.total_elements
                     * _prod(lay.lead_shape))

    def wire_bytes(self, tree_or_layout, compressor=None) -> float:
        """Packed bytes to ship the tree once (all replicas)."""
        lay = tree_or_layout if isinstance(tree_or_layout, BucketLayout) \
            else self.layout(tree_or_layout)
        per = sum(wire_nbytes(compressor, n, self.wire_dtype)
                  for n in lay.bucket_sizes)
        return float(per * _prod(lay.lead_shape))

    def metrics(self, nbytes, events=1.0):
        """f32 scalars on the host, as the reference's f32 arrays: the byte
        count is rounded to f32 before the event multiply."""
        ev = torch.tensor(events, dtype=torch.float32)
        return {"wire_bytes": torch.tensor(nbytes, dtype=torch.float32) * ev,
                "comm_events": ev}

    def collective_contract(self, tree_or_layout, profile: str,
                            events: int = 1) -> dict:
        """The backend calls ONE exchange of the tree may make over a
        ``ShardComm``, op name (``ShardComm.record``'s) -> the most calls,
        for the wire shape a strategy declares (``Strategy.wire_profile``);
        an op absent from the mapping must not be called at all (scalar
        control traffic is budgeted apart, by ``repro_torch.analysis``).
        The reference's profiles and signature, with the port's own
        realization, the same at every wire width:

          dense        all-reduce of the tree: one all-to-all of the
                       chunks and one tiled all-gather a bucket
                       (``ShardComm._reduce``, ``_reduce_narrow_sharded``)
          partitioned  ZeRO's reduce-scatter (an all-to-all) and the
                       shards' all-gather, one each a bucket
          compressed   one all-gather of the packed bytes a bucket
          ring         ``events`` ring shifts a bucket
          tp           ``events`` all-sums of the layer activation (the
                       row-parallel combines, forward and backward)
          none         no wire traffic at all

        ``nb`` is the ``BucketLayout``'s bucket count, built as the
        reference builds it."""
        lay = (tree_or_layout if isinstance(tree_or_layout, BucketLayout)
               else self.layout(tree_or_layout))
        nb = lay.n_buckets
        if profile == "none":
            return {}
        if profile == "compressed":
            return {"all_gather": nb}
        if profile in ("dense", "partitioned"):
            return {"all_to_all": nb, "all_gather": nb}
        if profile == "ring":
            return {"ppermute": int(events) * nb}
        if profile == "tp":
            return {"all_to_all": int(events) * nb,
                    "all_gather": int(events) * nb}
        raise ValueError(f"unknown wire profile {profile!r}")

    # -- compression plumbing ----------------------------------------------
    def _vmap_replicas(self, fn):
        """``fn`` of ONE replica's tensors (a tensor or a list of them),
        mapped over the ``lead_axes`` leading replica axes.  Replica by
        replica, written into one output tensor, so at most one replica's
        temporaries are alive at a time."""
        k = self.comm.lead_axes

        def run(x):
            flat, tdef = T.flatten(x)
            lead = tuple(flat[0].shape[:k])
            count = _prod(lead)
            rows = [t.reshape((count,) + tuple(t.shape[k:])) for t in flat]
            out = None
            for i in range(count):
                y = fn(T.unflatten(tdef, [t[i] for t in rows]))
                if out is None:
                    out = torch.empty((count,) + tuple(y.shape),
                                      dtype=y.dtype, device=y.device)
                out[i] = y
            return out.reshape(lead + tuple(out.shape[1:]))

        return run

    def _self_decode(self, target, compressor):
        """Per-replica compress → pack → unpack → decode of a flat bucket.
        The pack/unpack round trip is kept on purpose: the simulator then
        sees exactly the wire numerics (bf16 scales etc.) a sharded
        exchange ships."""

        def one(t):
            wire, meta = compressor.compress(t)
            arrs, widen = _narrow_wire(compressor.name, wire)
            buf, specs = _pack(arrs)
            return compressor.decompress(widen(_unpack(buf, specs)), meta,
                                         tuple(t.shape), torch.float32)

        return self._vmap_replicas(one)(target)

    def _bucket_encode(self, g, r, compressor):
        """One compressed error-feedback round for a flat bucket, with no
        collective: (own decode, new residual).

        Fused path (the default): ``compressor.fused_encode`` runs the
        whole encode (t = g + r, narrow wire arrays, residual update) as
        ONE kernel launch over all replicas' rows; the narrow arrays are
        byte-identical to the codec path's."""
        fe = compressor.fused_encode if self.fused else None
        if fe is None:
            t = g + r
            dec_self = self._self_decode(t, compressor)
            return dec_self, t - dec_self
        arrs, widen, new_r = fe(g, r)
        n = g.shape[-1]

        def dec(a):  # one replica's narrow arrays → decoded flat bucket
            return compressor.decompress(widen(a), None, (n,),
                                         torch.float32)

        return self._vmap_replicas(dec)(arrs), new_r

    def _gather_mean(self, arrs, dec):
        """ShardComm: ONE all-gather of this rank's narrow arrays packed
        into a uint8 buffer (``wire_nbytes`` bytes), every peer's buffer
        unpacked and decoded here.  Returns (the mean of the decodes over
        the stacked rank axis, ``LocalComm``'s reduction; this rank's own
        decode)."""
        buf, specs = _pack(arrs)
        (gathered,) = self.comm.all_gather([buf])
        decs = torch.stack([dec(_unpack(gathered[i], specs))
                            for i in range(self.comm.size)])
        return decs.mean(dim=0), decs[self.comm.rank]

    def _bucket_ef_round(self, g, r, compressor):
        """One compressed error-feedback round of a flat bucket: (mean of
        the replicas' decodes, own decode, new residual).  LocalComm:
        ``_bucket_encode``, then one axis-mean.  ShardComm: the encode on
        this rank, then ``_gather_mean`` of the packed bytes."""
        if not self._sharded:
            dec_self, new_r = self._bucket_encode(g, r, compressor)
            (mean,) = self.comm.all_mean([dec_self])
            return mean, dec_self, new_r
        n = g.shape[-1]
        fe = compressor.fused_encode if self.fused else None
        if fe is None:  # the codec's round on t = g + r
            t = g + r
            wire, meta = compressor.compress(t)
            arrs, widen = _narrow_wire(compressor.name, wire)
        else:
            (arrs, widen, new_r), meta = fe(g, r), None

        def dec(a):
            return compressor.decompress(widen(a), meta, (n,), torch.float32)

        mean, dec_self = self._gather_mean(arrs, dec)
        return mean, dec_self, (t - dec_self if fe is None else new_r)

    # -- flat-bucket gradient accumulation ----------------------------------
    # The microbatched train step (train/loop.py) keeps its gradient
    # accumulator in bucket space, and the boundary exchange consumes the
    # accumulated sum: compression, error feedback and the collective all
    # run at the boundary only.

    def init_accum(self, lay: BucketLayout, device=None,
                   play: Optional[PartitionedLayout] = None):
        """Zeroed flat f32 accumulator buckets on ``device`` (padded when
        ``play`` is given, so the boundary reduce-scatter needs no
        re-pad).  They own their storage: a one-leaf bucket of
        ``bucketize`` is a view of the leaf, and an add into such a view
        would write into a microbatch's gradient."""
        sizes = play.padded_sizes if play is not None else lay.bucket_sizes
        return [torch.zeros(lay.lead_shape + (n,), dtype=torch.float32,
                            device=device) for n in sizes]

    def accumulate(self, acc, tree, lay: BucketLayout, replica=None):
        """acc + bucketize(tree), IN PLACE on the accumulator's buckets
        (the reference's donated scan carry): elementwise f32 adds.  With
        ``replica`` (an index on the leading replica axis) ``tree`` is that
        one replica's tree and is added into its rows only: the same adds,
        without a stacked tree.  A padded accumulator
        (``init_accum(lay, play=...)``) takes the same adds and its padding
        stays zero.  Returns ``acc``."""
        if replica is None:
            for a, g in zip(acc, lay.bucketize(tree)):
                a[..., :g.shape[-1]].add_(g)
            return acc
        for i, x in enumerate(T.leaves(tree)):
            row = acc[lay.bucket_of[i]][replica]
            off = lay.offsets[i]
            row[..., off:off + lay.sizes[i]].add_(
                x.reshape(tuple(row.shape[:-1]) + (-1,)))
        return acc

    # ZeRO-2 (gradient sharding): each microbatch's gradient is
    # reduce-scattered and only the local 1/W shard accumulates.  One
    # reduce-scatter a bucket a MICROBATCH against a W times smaller
    # accumulator.

    def init_accum_partitioned(self, play: PartitionedLayout, device=None):
        """Zeroed 1/W shard-bucket f32 accumulator (ZeRO-2)."""
        lead = play.layout.lead_shape
        return [torch.zeros(lead + (n,), dtype=torch.float32, device=device)
                for n in play.shard_sizes]

    def accumulate_partitioned(self, acc, tree, play: PartitionedLayout):
        """acc + reduce_scatter_mean(tree), IN PLACE: the shard-space
        microbatch add of ZeRO-2.  It accumulates each microbatch's
        cross-worker MEAN, so the boundary divides by accum_steps only.
        Returns (acc, metrics); the metrics charge the reduce-scatter half
        of the partitioned exchange."""
        return self.accumulate_partitioned_buckets(
            acc, self._pad_buckets(play.layout.bucketize(tree), play), play)

    def accumulate_partitioned_buckets(self, acc, buckets,
                                       play: PartitionedLayout):
        """``accumulate_partitioned`` from one microbatch's PADDED stacked
        buckets (``init_accum(lay, play=play)`` filled replica by replica,
        as the train loop builds them)."""
        shards, _ = self.exchange_partitioned_accumulated(buckets, play)
        for a, s in zip(acc, shards):
            a.add_(s)
        return acc, self.metrics(self.flat_bytes(play.layout) / 2.0)

    # -- fused exchanges ----------------------------------------------------
    def exchange(self, grads, residual=None, compressor=None, events=1.0):
        """Fused all-mean of ``grads`` with optional compression and error
        feedback.  Returns (mean_tree, new_residual_tree, metrics)."""
        lay = self.layout(grads)
        return self.exchange_accumulated(lay.bucketize(grads), lay,
                                         residual=residual,
                                         compressor=compressor, events=events)

    def exchange_accumulated(self, buckets, lay: BucketLayout, residual=None,
                             compressor=None, events=1.0):
        """The exchange of ``exchange`` starting from flat f32 buckets
        instead of a tree; one collective per bucket.  Returns (mean_tree,
        new_residual_tree, metrics)."""
        if compressor is None or compressor.name == "none":
            out = (self._reduce_narrow_sharded(buckets, mean=True)
                   if self._narrow_sharded
                   else self.comm.all_mean(self._wire_cast(buckets)))
            return (lay.debucketize(out), residual,
                    self.metrics(self.flat_bytes(lay), events))
        rb = lay.bucketize(residual)
        g_out, r_out = [], []
        for g, r in zip(buckets, rb):
            mean, _, new_r = self._bucket_ef_round(g, r, compressor)
            g_out.append(mean)
            r_out.append(new_r)
        return (lay.debucketize(g_out),
                lay.debucketize(r_out, cast=False),
                self.metrics(self.wire_bytes(lay, compressor), events))

    def exchange_dgc(self, grads, state, compressor, momentum: float = 0.9,
                     events=1.0):
        """Fused all-mean with DGC momentum correction (Lin et al.):
        velocity accumulates into the residual before compression, and
        whatever was sent leaves both accumulators.  ``state`` =
        {"velocity", "residual"} param-shaped f32 trees.  Returns
        (mean_tree, new_state, metrics)."""
        lay = self.layout(grads)
        g_out, u_out, r_out = [], [], []
        for g, u, r in zip(lay.bucketize(grads),
                           lay.bucketize(state["velocity"]),
                           lay.bucketize(state["residual"])):
            u1 = momentum * u + g
            mean, sent, new_r = self._bucket_ef_round(u1, r, compressor)
            g_out.append(mean)
            u_out.append(u1 * (sent == 0))  # u1 * (1 - (sent != 0))
            r_out.append(new_r)
            del u1, sent
        new_state = {"velocity": lay.debucketize(u_out, cast=False),
                     "residual": lay.debucketize(r_out, cast=False)}
        return (lay.debucketize(g_out), new_state,
                self.metrics(self.wire_bytes(lay, compressor), events))

    # -- partitioned (ZeRO) exchange ----------------------------------------
    def partitioned_layout(self, tree) -> PartitionedLayout:
        return PartitionedLayout.build(self.layout(tree), self.comm.size)

    def _pad_buckets(self, buckets, play: PartitionedLayout):
        return [b if b.shape[-1] == p else torch.nn.functional.pad(
                    b, (0, p - b.shape[-1]))
                for b, p in zip(buckets, play.padded_sizes)]

    def shard_params(self, tree, play: Optional[PartitionedLayout] = None):
        """This worker's 1/W shard of each (replicated) flat f32 bucket: a
        local slice, no collective, into storage of its own (the optimizer
        updates it in place).  The optimizer state built from these shard
        buckets is ZeRO-1's partitioned state."""
        play = play or self.partitioned_layout(tree)
        buckets = self._pad_buckets(play.layout.bucketize(tree), play)
        return self.comm.shard_chunk(buckets)

    def exchange_partitioned(self, grads,
                             play: Optional[PartitionedLayout] = None,
                             events=1.0):
        """Fused reduce-scatter mean: every worker receives ONLY its own
        1/W shard of the cross-worker mean gradient, one reduce-scatter a
        bucket.  Returns (shard_buckets, metrics).  With the all-gather of
        ``unpartition`` it ships the bytes of the dense all-reduce."""
        play = play or self.partitioned_layout(grads)
        gb = self._pad_buckets(play.layout.bucketize(grads), play)
        return self.exchange_partitioned_accumulated(gb, play, events=events)

    def exchange_partitioned_accumulated(self, buckets,
                                         play: PartitionedLayout,
                                         events=1.0):
        """``exchange_partitioned`` from PADDED flat f32 buckets (the
        accumulator of ``init_accum(lay, play=play)``): one reduce-scatter
        a bucket.  The stacked simulator rounds the buckets to the wire
        dtype and reduces in f32; over a ``ShardComm`` a narrow wire is
        one all-to-all of the narrowed chunks and an f32 local mean.
        Returns (f32 shard_buckets, metrics)."""
        if self._narrow_sharded:
            stacked = self.comm.gather_chunks(
                [b.to(self.wire_dtype) for b in buckets])
            shards = [s.float().mean(dim=0) for s in stacked]
        else:
            shards = [s.float() for s in self.comm.reduce_scatter(
                self._wire_cast(buckets), mean=True)]
        return shards, self.metrics(self.flat_bytes(play.layout), events)

    def unpartition(self, shards, play: PartitionedLayout):
        """All-gather the shards back into the full tree: one tiled
        all-gather a bucket of wire-dtype buffers (the gathered params are
        the wire-dtype image of f32 master shards), padding sliced away,
        leaf dtypes restored.  The leaves are broadcast views on the
        replica axis (module docstring)."""
        if self._narrow_sharded:  # the 16-bit image of the shards
            full = [b.view(self.wire_dtype) for b in self.comm.all_gather(
                self._bitcast16(shards), tiled=True)]
        else:
            full = self.comm.all_gather(self._wire_cast(shards), tiled=True)
        full = [b[..., :n] for b, n in zip(full, play.layout.bucket_sizes)]
        return play.layout.debucketize(full)

    def compress(self, grads, residual, compressor):
        """Error-feedback compression WITHOUT a collective, for strategies
        that buffer or accumulate before communicating (ssp, downpour).
        Returns (g_hat_tree, new_residual_tree, packed_bytes_one_send)."""
        lay = self.layout(grads)
        if compressor is None or compressor.name == "none":
            return grads, residual, self.flat_bytes(lay)
        g_out, r_out = [], []
        for g, r in zip(lay.bucketize(grads), lay.bucketize(residual)):
            dec, new_r = self._bucket_encode(g, r, compressor)
            g_out.append(dec)
            r_out.append(new_r)
        return (lay.debucketize(g_out),
                lay.debucketize(r_out, cast=False),
                self.wire_bytes(lay, compressor))
