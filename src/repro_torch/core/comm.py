"""The tensor-moving interface, stacked-replica realization.

Port of ``repro/core/comm.py``'s ``LocalComm``, ``HierComm`` and
``LocalHierComm``: every worker's tensors are stacked on leading replica
axes and the collectives are axis reductions and rolls, on one device.
Strategies are written against it, and ``core/fabric.py`` drives it once
per flat bucket.  ``all_mean`` and ``all_sum`` return a broadcast VIEW of
the reduced value (``expand``), not W copies; the reference's
``broadcast_to`` means the same.

``ShardComm`` is a later slice of the port.
"""

from __future__ import annotations

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
