"""Worker-count re-partitioning of ZeRO shard-bucket state.

Port of ``repro/core/resharding.py``: one implementation,
:func:`reshard_bucket`, serves the checkpoint restore
(``checkpoint/checkpointer.py``, ``restore_checkpoint(repartition=True)``)
and the live resize of a state tree (:func:`repartition_tree`).

Shard chunks are stored in rank order: a stacked simulator leaf (W, C)
and a global flat leaf (padded,) both flatten to chunk_0 ‖ chunk_1 ‖ … ‖
old padding, so "drop the old padding, zero-pad for the new worker count,
reshape" is the whole transition.  A numpy array takes the reference's
code line for line (the checkpointer re-shards what it read from disk);
a torch tensor takes the same steps on its own device and in its own
dtype, into new storage (the live resize of ``launch/elastic.py``), so
both give the same values bitwise.
"""

from __future__ import annotations

import numpy as np
import torch


def _prod(shape):
    n = 1
    for s in shape:
        n *= s
    return n


def reshard_bucket(arr, true_size: int, target_shape):
    """Re-shard one ZeRO bucket to a new partition: keep the
    ``true_size`` live elements of the rank-ordered flat image, zero-pad
    to the target's size and reshape to ``target_shape``.  A tensor comes
    back as a new tensor on its device in its dtype; anything else as a
    numpy array."""
    if isinstance(arr, torch.Tensor):
        flat = arr.reshape(-1)[:true_size]
        out = torch.zeros((_prod(target_shape),), dtype=arr.dtype,
                          device=arr.device)
        out[:true_size] = flat
        return out.reshape(target_shape)
    flat = np.asarray(arr).reshape(-1)[:true_size]
    out = np.zeros((_prod(target_shape),), flat.dtype)
    out[:true_size] = flat
    return out.reshape(target_shape)


def _is_bucket_list(node, n_buckets: int) -> bool:
    return (n_buckets > 0 and isinstance(node, (list, tuple))
            and len(node) == n_buckets
            and all(getattr(x, "ndim", 0) in (1, 2)
                    and hasattr(x, "dtype") for x in node))


def _reshard_one(x, true_size: int, n_new: int):
    padded = -(-true_size // n_new) * n_new
    # a stacked simulator shard (W, C) keeps its 2-d layout at the new
    # width; a global flat shard (padded,) stays flat
    target = (n_new, padded // n_new) if x.ndim == 2 else (padded,)
    return reshard_bucket(x, true_size, target)


def repartition_tree(tree, bucket_sizes, n_new: int):
    """Re-partition every shard-bucket list of a ZeRO state tree W → W′.

    A shard-bucket list is a list or tuple of ``len(bucket_sizes)``
    numpy arrays or tensors, each 1-d (flat) or 2-d (stacked ``(W, C)``),
    re-sharded by :func:`reshard_bucket` into the same kind: the layout of
    ``Fabric.shard_params`` and the ZeRO ``init_opt`` hooks.  Bucket i
    carries ``bucket_sizes[i]`` live elements (``PartitionedLayout.spec()``);
    the rest is padding, dropped and regrown for the new worker count.
    Apply it to ZeRO shard state only (``opt_state`` of ``sync_zero*``,
    ZeRO-3's param shards): any other list of that length would be
    resharded too.  Other leaves pass through untouched."""
    nb = len(bucket_sizes)

    def go(node):
        if isinstance(node, dict):
            return {k: go(v) for k, v in node.items()}
        if _is_bucket_list(node, nb):
            return type(node)(_reshard_one(x, n, n_new)
                              for x, n in zip(node, bucket_sizes))
        if isinstance(node, (list, tuple)):
            return type(node)(go(v) for v in node)
        return node

    return go(tree)
