"""The tensor-moving interface, in two realizations.

Port of ``repro/core/comm.py``.  ``LocalComm``, ``HierComm`` and
``LocalHierComm`` are the stacked-replica realization: every worker's
tensors are stacked on leading replica axes and the collectives are axis
reductions and rolls, on one device.  ``all_mean`` and ``all_sum`` return
a broadcast VIEW of the reduced value (``expand``), not W copies; the
reference's ``broadcast_to`` means the same.

``ShardComm`` is the per-rank realization (the reference's ``shard_map``
one): each rank is a process holding ONE replica (``lead_axes = 0``), and
the collectives run over a ``torch.distributed`` process group.
``ShardHierComm`` is ``HierComm`` over two ``ShardComm``s, a pods ×
workers grid of groups.  Strategies are written against the interface,
and ``core/fabric.py`` drives it once per flat bucket.

What ``ShardComm`` ships and how it reduces:

  * every op moves raw bytes (a ``uint8`` view of the payload), so any
    dtype travels (gloo refuses some, uint16 among them) and the data
    movement is exact;
  * reductions never use the backend's own ring ``all_reduce``, which
    sums in an order of its own.  ``all_sum``/``all_mean``/
    ``reduce_scatter`` run as ``gather_chunks`` (one ``all_to_all``: the
    ring bytes of a reduce-scatter), then the same torch reduction over
    the stacked rank axis that ``LocalComm`` runs over its replica axis
    (``sum``/``mean`` over dim 0 of a ``(W, ..., C)`` tensor, rank order),
    then (``all_sum``/``all_mean``) one tiled all-gather.  So EVERY op is
    bitwise ``LocalComm``'s on the same device and dtype, at any W:
    ``all_gather``, ``ppermute``, ``gather_chunks`` and ``shard_chunk``
    move data only, and the reductions are the same reduction of the same
    values in the same order;
  * ``all_min`` (the precision policy's finite flag) is the one op that
    calls the backend's reduction: a minimum is exact in any order;
  * the transport is the backend's, decided by it and never by catching
    a failure: ``nccl`` takes CUDA tensors; ``gloo`` takes host tensors,
    so for a CUDA tensor the comm ALWAYS stages through pinned host
    memory (a copy to the host, the collective, a copy back;
    ``transport`` says "gloo+host").  ``stats`` counts each op's calls and the bytes this
    rank handed to the backend;
  * ``with comm.record() as calls:`` logs every backend call made inside
    the block, one ``{"op", "dtype", "bytes"}`` record each: the op's name
    in ``stats``, the payload's dtype before the uint8 view (a bf16
    bucket logs ``bfloat16``, the Fabric's 16-bit image ``int16``) and
    the bytes handed to the backend.  ``repro_torch.analysis`` lints
    these logs where the reference reads collectives out of HLO.

Beside ``ShardComm``, the collectives that autograd goes through, for the
model code on a mesh's "model" axis (``models/tensor_parallel.py``,
``models/layers.py::_moe_ep``).  Each is a ``torch.autograd.Function``
over a ``ShardComm`` whose backward is the reference's transpose under
``shard_map``: ``psum`` (an all-sum) → the all-sum of the cotangents,
``pmean`` → their all-mean, a tiled ``all_to_all(split, concat)`` → the
reverse all-to-all, a tiled ``all_gather`` → a summing reduce-scatter.
The comm's ``ops`` counts each call, forward and backward, with its
payload bytes (the tensor's, not what the backend moved: ``stats``
counts that).
"""

from __future__ import annotations

from collections import defaultdict
from contextlib import contextmanager

import torch

from repro_torch.core.tree import tree_map


class LocalComm:
    """Stacked-replica realization: leaves carry a worker dim at ``axis``.

    ``lead_axes`` (defaults to ``axis + 1``) is the total count of leading
    replica axes in the layout."""

    def __init__(self, size: int, axis: int = 0, lead_axes: int | None = None):
        self.size = size
        self.axis = axis
        self.lead_axes = axis + 1 if lead_axes is None else lead_axes

    def all_mean(self, tree):
        ax = self.axis
        return tree_map(lambda x: x.mean(dim=ax, keepdim=True).expand(x.shape),
                        tree)

    def all_sum(self, tree):
        ax = self.axis
        return tree_map(lambda x: x.sum(dim=ax, keepdim=True).expand(x.shape),
                        tree)

    def ppermute(self, tree, shift: int = 1):
        """Ring shift: worker w receives worker (w - shift) % W's value."""
        return tree_map(lambda x: torch.roll(x, shift, dims=self.axis), tree)

    def all_gather(self, tree, tiled: bool = False):
        """Tiled gather: every worker's last-axis shard concatenated in rank
        order (the inverse of ``reduce_scatter``).  The stacked layout
        already sees every replica, so the untiled gather is undefined."""
        if not tiled:
            raise NotImplementedError(
                "stacked LocalComm already sees every replica; only the "
                "tiled (last-axis concat) gather is defined")
        ax, w = self.axis, self.size

        def one(x):
            y = torch.movedim(x, ax, -2)  # (..., W, C): shards in rank order
            flat = y.reshape(y.shape[:-2] + (w * x.shape[-1],))
            return flat.unsqueeze(ax).expand(x.shape[:-1]
                                             + (w * x.shape[-1],))

        return tree_map(one, tree)

    def reduce_scatter(self, tree, mean: bool = False):
        """Cross-worker sum (or mean), scattered: worker w keeps chunk w of
        the last axis, which must divide by W."""
        ax, w = self.axis, self.size

        def one(x):
            red = x.mean(dim=ax) if mean else x.sum(dim=ax)
            c = x.shape[-1] // w
            chunks = red.reshape(red.shape[:-1] + (w, c))
            return torch.movedim(chunks, -2, ax)  # worker w gets chunk w

        return tree_map(one, tree)

    def shard_chunk(self, tree):
        """Worker w's own 1/W chunk of the last axis of a REPLICATED tree
        (a local slice, no communication)."""
        ax, w = self.axis, self.size

        def one(x):
            c = x.shape[-1] // w
            chunks = x.reshape(x.shape[:-1] + (w, c))
            shape = [1] * chunks.dim()
            shape[ax] = x.shape[ax]
            idx = torch.arange(x.shape[ax], device=x.device).reshape(shape)
            idx = idx.expand(chunks.shape[:-2] + (1, c))
            return torch.gather(chunks, -2, idx).reshape(x.shape[:-1] + (c,))

        return tree_map(one, tree)

    def worker_index(self, like=None):
        """Per-worker index in [0, W), broadcastable against the stacked
        leaves, on ``like``'s device (the host when None)."""
        dev = like.device if like is not None else None
        return torch.arange(self.size, device=dev).reshape(
            (1,) * self.axis + (self.size,))

    # helpers for the stacked layout ---------------------------------------
    def replicate(self, tree):
        """Broadcast a single-replica tree to the stacked layout (copies)."""
        return tree_map(
            lambda x: x.unsqueeze(0).expand((self.size,) + tuple(x.shape))
            .clone(), tree)

    def replica(self, tree, w: int):
        return tree_map(lambda x: x[w], tree)


class HierComm:
    """Two-tier comm: ``inner`` (the fast fabric, within a pod) and
    ``outer`` (the slow fabric, pod to pod).  The hierarchical strategy
    composes a complete strategy on ``inner`` with a partial one on
    ``outer``."""

    def __init__(self, inner, outer):
        self.inner = inner
        self.outer = outer
        self.size = inner.size * outer.size


class LocalHierComm(HierComm):
    """Stacked layout (P, W, ...): axis 0 = pods (outer), axis 1 = workers.

    Both tier comms declare lead_axes=2: a compression block must never
    mix values across pods OR workers, whichever tier is communicating."""

    def __init__(self, pods: int, workers: int):
        super().__init__(LocalComm(workers, axis=1, lead_axes=2),
                         LocalComm(pods, axis=0, lead_axes=2))


# ---------------------------------------------------------------------------
# the per-rank realization
# ---------------------------------------------------------------------------
class ShardComm:
    """One rank's view of a ``torch.distributed`` process group: every
    leaf is THIS rank's tensor (``lead_axes = 0``).  ``group`` None is the
    default (world) group.  The reductions' order is the module
    docstring's: bitwise ``LocalComm`` at any W."""

    lead_axes = 0

    def __init__(self, group=None):
        import torch.distributed as dist

        self._dist = dist
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.backend = str(dist.get_backend(group))
        # group rank -> global rank, for the point-to-point ring
        self._peer = [dist.get_global_rank(group, i) if group is not None
                      else i for i in range(self.size)]
        self.stats = defaultdict(lambda: [0, 0])  # op -> [calls, bytes]
        # the autograd collectives: op -> [calls, payload bytes]
        self.ops = defaultdict(lambda: [0, 0])
        self._logs = []  # the open ``record`` blocks' lists

    @contextmanager
    def record(self):
        """A list that collects one ``{"op", "dtype", "bytes"}`` record a
        backend call made inside the block (blocks may nest)."""
        calls = []
        self._logs.append(calls)
        try:
            yield calls
        finally:
            self._logs.remove(calls)

    # -- transport ------------------------------------------------------------
    def transport(self, device) -> str:
        """How a tensor on ``device`` travels: "gloo" (host tensors),
        "gloo+host" (a CUDA tensor staged through host memory) or
        "nccl"."""
        dev = torch.device(device)
        if self.backend == "gloo":
            return "gloo+host" if dev.type == "cuda" else "gloo"
        if self.backend == "nccl":
            if dev.type != "cuda":
                raise ValueError("ShardComm over nccl takes CUDA tensors, "
                                 f"got a tensor on {dev}")
            return "nccl"
        raise ValueError(f"ShardComm: unsupported backend {self.backend!r}")

    def _wire(self, x):
        """(the tensor handed to the backend, the device to return to):
        under gloo a CUDA tensor's copy in pinned (page-locked) host
        memory, which the card copies at full rate and PyTorch's host
        allocator caches; else ``x`` itself."""
        if self.transport(x.device) == "gloo+host":
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            host.copy_(x)
            return host, x.device
        return x, x.device

    @staticmethod
    def _out(shape, like):
        """An output buffer for the backend beside its input ``like``
        (pinned too when ``like`` is)."""
        return torch.empty(shape, dtype=like.dtype, device=like.device,
                           pin_memory=like.is_pinned())

    def _count(self, op, nbytes, dtype):
        st = self.stats[op]
        st[0] += 1
        st[1] += int(nbytes)
        for calls in self._logs:
            calls.append({"op": op, "dtype": str(dtype).removeprefix("torch."),
                          "bytes": int(nbytes)})

    @staticmethod
    def _bytes(x):
        """Flat uint8 view of a contiguous tensor's storage."""
        flat = x.contiguous().reshape(-1)
        return flat if flat.dtype == torch.uint8 else flat.view(torch.uint8)

    def _gather(self, x, op="all_gather"):
        """(W,) + x.shape: every rank's ``x`` in rank order."""
        src, dev = self._wire(self._bytes(x))
        out = self._out((self.size * src.numel(),), src)
        self._count(op, src.numel(), x.dtype)
        self._dist.all_gather_into_tensor(out, src, group=self.group)
        out = out.to(dev).reshape(self.size, -1)
        if x.dtype != torch.uint8:
            out = out.view(x.dtype)
        return out.reshape((self.size,) + tuple(x.shape))

    def _all_to_all(self, y):
        """y (W, ...): piece i goes to rank i; returns (W, ...) whose row i
        came from rank i."""
        w = self.size
        src, dev = self._wire(self._bytes(y).reshape(w, -1))
        out = self._out(src.shape, src)
        self._count("all_to_all", src.numel(), y.dtype)
        self._dist.all_to_all_single(out, src, group=self.group)
        out = out.to(dev)
        if y.dtype != torch.uint8:
            out = out.view(y.dtype)
        return out.reshape(y.shape)

    # -- the interface --------------------------------------------------------
    def gather_chunks(self, tree):
        """The data movement of a reduce-scatter WITHOUT the reduction:
        this rank receives every peer's chunk ``rank`` of the last axis
        (which must divide by W), stacked on a NEW leading axis
        ``(W, ..., C)``, in rank order.  One all-to-all a leaf, the ring
        bytes of a reduce-scatter; the caller picks the accumulation
        dtype (the fabric's narrow wire ships bf16 chunks and sums in
        f32)."""
        w = self.size

        def one(x):
            c = x.shape[-1] // w
            if c * w != x.shape[-1]:
                raise ValueError(f"gather_chunks: last axis {x.shape[-1]} "
                                 f"does not divide by W={w}")
            y = torch.movedim(x.reshape(x.shape[:-1] + (w, c)), -2, 0)
            return self._all_to_all(y)

        return tree_map(one, tree)

    def reduce_scatter(self, tree, mean: bool = False):
        """Cross-rank sum (or mean), scattered: this rank keeps chunk
        ``rank`` of the last axis, which must divide by W."""
        def one(x):
            (s,) = self.gather_chunks([x])
            return s.mean(dim=0) if mean else s.sum(dim=0)

        return tree_map(one, tree)

    def all_gather(self, tree, tiled: bool = False):
        """Untiled: every rank's leaf stacked on a new leading axis (W,
        ...).  Tiled: the ranks' last-axis shards concatenated in rank
        order (the inverse of ``reduce_scatter``)."""
        w = self.size

        def one(x):
            g = self._gather(x)
            if not tiled:
                return g
            g = torch.movedim(g, 0, -2)  # (..., W, C)
            return g.reshape(x.shape[:-1] + (w * x.shape[-1],))

        return tree_map(one, tree)

    def _reduce(self, x, mean: bool):
        w = self.size
        flat = x.reshape(-1)
        n = flat.shape[0]
        p = -(-n // w) * w
        if p != n:
            flat = torch.nn.functional.pad(flat, (0, p - n))
        (red,) = self.reduce_scatter([flat], mean=mean)
        (full,) = self.all_gather([red], tiled=True)
        return full[:n].reshape(x.shape)

    def all_mean(self, tree):
        return tree_map(lambda x: self._reduce(x, mean=True), tree)

    def all_sum(self, tree):
        return tree_map(lambda x: self._reduce(x, mean=False), tree)

    def all_min(self, x):
        """Elementwise minimum over the ranks (exact in any order): the
        precision policy's finite flag, so that every rank takes the same
        skip decision."""
        src, dev = self._wire(x.float().contiguous())
        self._count("all_min", src.numel() * 4, src.dtype)
        self._dist.all_reduce(src, op=self._dist.ReduceOp.MIN,
                              group=self.group)
        return src.to(dev)

    def ppermute(self, tree, shift: int = 1):
        """Ring shift: rank w receives rank (w - shift) % W's value (a
        batched send to (w + shift) % W and receive from (w - shift) % W)."""
        w, r = self.size, self.rank

        def one(x):
            if w == 1:
                return x.clone()
            src, dev = self._wire(self._bytes(x))
            out = self._out(src.shape, src)
            self._count("ppermute", src.numel(), x.dtype)
            P2P = self._dist.P2POp
            ops = [P2P(self._dist.isend, src, self._peer[(r + shift) % w],
                       group=self.group),
                   P2P(self._dist.irecv, out, self._peer[(r - shift) % w],
                       group=self.group)]
            for req in self._dist.batch_isend_irecv(ops):
                req.wait()
            out = out.to(dev)
            if x.dtype != torch.uint8:
                out = out.view(x.dtype)
            return out.reshape(x.shape)

        return tree_map(one, tree)

    def shard_chunk(self, tree):
        """This rank's 1/W chunk of the last axis of a REPLICATED tree: a
        local slice, no communication, into storage of its own."""
        w, r = self.size, self.rank

        def one(x):
            c = x.shape[-1] // w
            return x[..., r * c:(r + 1) * c].clone()

        return tree_map(one, tree)

    def worker_index(self, like=None):
        """This rank's index in [0, W) as a scalar tensor on ``like``'s
        device (the host when None)."""
        dev = like.device if like is not None else None
        return torch.tensor(self.rank, device=dev)

    def gather_scalars(self, x):
        """(W,) + x.shape: a small control value of every rank (losses,
        counters), counted apart from the buckets' traffic."""
        return self._gather(x, op="scalars")


class ShardHierComm(HierComm):
    """``HierComm`` over the world group seen as a pods × workers grid:
    global rank = pod * workers + worker.  ``inner`` is this rank's pod
    (its ``workers`` ranks), ``outer`` the ranks of its worker index
    across the pods.  Every rank must build it (group creation is
    collective)."""

    def __init__(self, pods: int, workers: int, backend=None):
        import torch.distributed as dist

        if dist.get_world_size() != pods * workers:
            raise ValueError(f"ShardHierComm({pods}, {workers}) needs "
                             f"{pods * workers} ranks, the world has "
                             f"{dist.get_world_size()}")
        inner, _ = dist.new_subgroups_by_enumeration(
            [[p * workers + w for w in range(workers)]
             for p in range(pods)], backend=backend)
        outer, _ = dist.new_subgroups_by_enumeration(
            [[p * workers + w for p in range(pods)]
             for w in range(workers)], backend=backend)
        super().__init__(ShardComm(inner), ShardComm(outer))


# ---------------------------------------------------------------------------
# collectives that autograd goes through
# ---------------------------------------------------------------------------
def _note(comm, op, x):
    st = comm.ops[op]
    st[0] += 1
    st[1] += x.numel() * x.element_size()


def _psum(comm, x, mean=False):
    _note(comm, "pmean" if mean else "psum", x)
    (out,) = comm.all_mean([x]) if mean else comm.all_sum([x])
    return out


def _a2a(comm, x, split_axis, concat_axis):
    """Tiled all-to-all: piece i of ``split_axis`` goes to rank i; the
    pieces received are concatenated on ``concat_axis`` in rank order."""
    _note(comm, "all_to_all", x)
    w = comm.size
    if x.shape[split_axis] % w:
        raise ValueError(f"all_to_all: axis {split_axis} ({x.shape[split_axis]})"
                         f" does not divide by W={w}")
    recv = comm._all_to_all(torch.stack(x.chunk(w, dim=split_axis)))
    return torch.cat(recv.unbind(0), dim=concat_axis)


def _gather(comm, x, axis):
    _note(comm, "all_gather", x)
    return torch.cat(comm._gather(x.contiguous()).unbind(0), dim=axis)


def _reduce_scatter(comm, x, axis):
    """Sum over the ranks of piece ``rank`` of ``axis``, in rank order."""
    _note(comm, "reduce_scatter", x)
    w = comm.size
    pieces = torch.stack(x.chunk(w, dim=axis))
    return comm._all_to_all(pieces).sum(dim=0)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, mean):
        ctx.comm, ctx.mean = comm, mean
        return _psum(comm, x, mean)

    @staticmethod
    def backward(ctx, g):
        return _psum(ctx.comm, g.contiguous(), ctx.mean), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, split_axis, concat_axis):
        ctx.args = (comm, split_axis, concat_axis)
        return _a2a(comm, x, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        comm, split_axis, concat_axis = ctx.args
        return _a2a(comm, g, concat_axis, split_axis), None, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axis):
        ctx.args = (comm, axis)
        return _gather(comm, x, axis)

    @staticmethod
    def backward(ctx, g):
        comm, axis = ctx.args
        return _reduce_scatter(comm, g, axis), None, None


def psum(x, comm: ShardComm):
    """All-sum of ``x`` over ``comm``'s ranks (bitwise ``LocalComm``'s sum
    in rank order); backward: the all-sum of the cotangents."""
    return _PSum.apply(x, comm, False)


def pmean(x, comm: ShardComm):
    """All-mean of ``x``; backward: the all-mean of the cotangents."""
    return _PSum.apply(x, comm, True)


def all_to_all(x, comm: ShardComm, split_axis: int, concat_axis: int):
    """Tiled all-to-all (``lax.all_to_all(..., tiled=True)``); backward:
    the reverse all-to-all."""
    return _AllToAll.apply(x, comm, split_axis, concat_axis)


def all_gather(x, comm: ShardComm, axis: int):
    """Tiled all-gather on ``axis`` (``lax.all_gather(..., tiled=True)``);
    backward: a reduce-scatter that sums the cotangents in rank order."""
    return _AllGather.apply(x, comm, axis)
