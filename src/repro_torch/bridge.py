"""Parameters, train states and dense decode caches between the JAX
package's trees and the port's tensors.

Both packages use the same nested-dict layout (``models/transformer.py``,
``train/loop.py::init_train_state``, each strategy's ``comm_state``), so
the conversion is a pure copy, leaf by leaf, through numpy; the one
exception is ``ssp``'s ring, one (s, W, ...) array a parameter in the
reference and a tuple of s parameter trees in the port.  Lists and
tuples are kept: the ZeRO strategies' shard-bucket states (an optimizer
state of per-bucket ``(W, chunk)`` arrays, ZeRO-1's ``{"opt",
"master"}``, ZeRO-3's param shards) are lists in both packages.  Every
leaf is copied into storage of its own, so a broadcast view (the
replicated params ``unpartition`` returns) comes back as W rows.  bfloat16
leaves go through a 16-bit integer view: ``torch.from_numpy`` rejects
ml_dtypes' ``bfloat16``.

The sharded step (``train/loop.py::make_sharded_train_step``) keeps each
rank's chunk of the partitioned state: ``sharded_state_from_numpy`` cuts
a global state of the JAX package's sharded step (the padded flat shard
buckets of ZeRO-1/2/3's optimizer state and master, ZeRO-3's params) into
rank r's, and ``sharded_state_to_numpy`` joins the ranks' states back;
``rank_state`` takes replica r of a stacked (``LocalComm``) train state.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import tree as T
from repro_torch.core.precision import torch_dtype


def _leaf_to_torch(a, device, dtype):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree, device="cuda", dtype=None):
    """Nested dict of numpy arrays (the JAX package's parameters after
    ``np.asarray``) → the same dict of tensors on ``device``.  ``dtype``
    optionally casts the floating leaves."""
    dev = resolve_device(device)
    dt = None if dtype is None else torch_dtype(dtype)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        return _leaf_to_torch(x, dev, dt)

    return conv(tree)


def params_to_numpy(tree):
    """Inverse of ``params_from_numpy``: tensors → numpy arrays on the host;
    bfloat16 leaves come back as ml_dtypes' ``bfloat16``."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to_numpy(v) for v in tree)
    t = tree.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # installed with JAX; only this direction needs it

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def cache_from_numpy(cache, device="cuda"):
    """A dense decode cache of the JAX package after ``np.asarray`` (per
    layer attention ``{"k", "v"}`` stacked (repeat, B, S, KV, Dh), or a
    recurrent mixer's state, as ``init_cache``/``prefill`` return it) →
    the port's, on ``device``, every leaf in its stored dtype (the f32
    recurrent states of a bf16 cache stay f32), so both packages'
    ``decode_step`` can start from one cache."""
    return params_from_numpy(cache, device)


def cache_to_numpy(cache):
    """Inverse of ``cache_from_numpy``."""
    return params_to_numpy(cache)


def _map_rings(tree, fn):
    """``fn`` applied to every ``ssp`` ring (a ``"buf"`` entry) of a comm
    state, at any depth (a hierarchy nests one tier's state)."""
    if not isinstance(tree, dict):
        return tree
    return {k: fn(v) if k == "buf" else _map_rings(v, fn)
            for k, v in tree.items()}


def _ring_to_tuple(buf):
    """The reference's ring, one (s, W, ...) leaf per parameter → the
    port's tuple of s parameter trees (each slot its own tensor)."""
    s = T.leaves(buf)[0].shape[0]
    return tuple(T.tree_map(lambda x, i=i: x[i].clone(), buf)
                 for i in range(s))


def _ring_to_stack(buf):
    """Inverse of ``_ring_to_tuple``."""
    return T.tree_map(lambda *slots: torch.stack(slots), *buf)


def train_state_from_numpy(state, device="cuda"):
    """A train state of the JAX package after ``np.asarray`` (stacked
    ``params``, ``opt_state``, the strategy's ``comm_state``, ``step``,
    and under a precision policy the f32 ``master`` and ``loss_scale``
    {"scale" f32, "good_steps" int32}) → the port's, on ``device``, every
    leaf in its dtype; ``step`` becomes an int32 scalar tensor and an
    ``ssp`` ring a tuple of s trees."""
    out = params_from_numpy({k: v for k, v in state.items() if k != "step"},
                            device)
    if "comm_state" in out:
        out["comm_state"] = _map_rings(out["comm_state"], _ring_to_tuple)
    out["step"] = torch.tensor(int(np.asarray(state["step"])),
                               dtype=torch.int32,
                               device=resolve_device(device))
    return out


def train_state_to_numpy(state):
    """Inverse of ``train_state_from_numpy``."""
    state = dict(state)
    if "comm_state" in state:
        state["comm_state"] = _map_rings(state["comm_state"], _ring_to_stack)
    out = params_to_numpy({k: v for k, v in state.items() if k != "step"})
    out["step"] = np.asarray(int(state["step"]), np.int32)
    return out


# ---------------------------------------------------------------------------
# the per-rank states of the sharded step
# ---------------------------------------------------------------------------
def shard_chunks(tree, rank: int, n_parts: int):
    """Every leaf's chunk ``rank`` of ``n_parts`` along its last axis, in
    storage of its own (a global padded shard bucket → the rank's)."""
    def one(x):
        c = x.shape[-1] // n_parts
        if c * n_parts != x.shape[-1]:
            raise ValueError(f"last axis {x.shape[-1]} does not divide "
                             f"into {n_parts} chunks")
        return x[..., rank * c:(rank + 1) * c].clone()

    return T.tree_map(one, tree)


def unshard_chunks(trees):
    """Inverse of ``shard_chunks``: the ranks' trees (in rank order) joined
    along the last axis."""
    return T.tree_map(lambda *xs: torch.cat(xs, dim=-1), *trees)


def _sharded_keys(zero_stage: int):
    return (("opt_state",) if zero_stage else ()) + \
        (("params",) if zero_stage >= 3 else ())


def sharded_state_from_numpy(state, rank: int, n_parts: int,
                             zero_stage: int = 0, device="cuda"):
    """A GLOBAL train state of the JAX package's sharded step after
    ``np.asarray`` → rank ``rank``'s state of the port's: the replicated
    leaves copied, the padded flat shard buckets (ZeRO's ``opt_state``,
    ZeRO-3's ``params``) cut to the rank's chunk."""
    out = train_state_from_numpy(state, device)
    for key in _sharded_keys(zero_stage):
        out[key] = shard_chunks(out[key], rank, n_parts)
    return out


def sharded_state_to_numpy(states, zero_stage: int = 0):
    """The ranks' states (in rank order) → one global state in the JAX
    package's layout: the shard buckets joined, the rest from rank 0."""
    out = dict(states[0])
    for key in _sharded_keys(zero_stage):
        out[key] = unshard_chunks([s[key] for s in states])
    return train_state_to_numpy(out)


def rank_state(state, rank: int):
    """Replica ``rank`` of a stacked train state (every leaf of ``params``,
    ``opt_state``, ``comm_state`` and ``master`` carries the replica axis
    first), copied; ``step`` and ``loss_scale`` are shared."""
    out = {}
    for k, v in state.items():
        if k in ("step", "loss_scale"):
            out[k] = v
        else:
            out[k] = T.tree_map(lambda x: x[rank].clone(), v)
    return out
