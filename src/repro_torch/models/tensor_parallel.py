"""Explicit tensor parallelism over a mesh's "model" axis.

Port of ``repro/models/tensor_parallel.py``.  A Megatron-style
column/row split of each mixer and FFN whose activation combines are
issued by the model code itself.  The split is keyed by the mixer
subtree a leaf sits in (``SPLIT_AXES``), not by its name alone: mLSTM's
``wq``/``wk``/``wv`` share attention's names but not its combine.

  attention, self and cross (``attn``, ``cross_attn``), heads:
      column  wq/wk/wv (D, H, Dh) → (D, H/T, Dh); bq/bk/bv (H, Dh) → (H/T, Dh)
      row     wo (H, Dh, D) → (H/T, Dh, D)                     one all-sum
  dense MLP (``mlp``), d_ff:
      column  w_gate/w_up (D, F) → (D, F/T);  row w_down (F, D) → (F/T, D)
  Mamba (``mamba``), the d_in channels (independent through the conv
  and the scan):
      column  in_proj (D, 2·d_in): the columns [i·d_in/T, (i+1)·d_in/T) of
              the u half AND of the z half, side by side (``HALVES``);
              conv_w (k, d_in) → (k, d_in/T); dt_proj (R, d_in) → (R, d_in/T);
              conv_b, dt_bias, D (d_in,) and A_log (d_in, N) on axis 0
      row     x_proj (d_in, R + 2N): the partial u @ x_proj all-summed
              before dt, B and C are sliced out           one all-sum
              out_proj (d_in, D)                           one all-sum
  mLSTM (``mlstm``), heads:
      column  wq/wk/wv (D, H, dh) → (D, H/T, dh); w_igate/w_fgate (D, H)
              → (D, H/T); fgate_bias (H,); out_norm.scale (H·dh,), head-major
      row     out_proj (H·dh, D)                           one all-sum
              and the out-norm's sum of squares (B, L, 1), all-summed
              before the rank normalises its heads          one all-sum
  sLSTM (``slstm``): replicated.  Its recurrence mixes heads (the (B,
  4D) gate pre-activations are chunked into i, f, z, o after the
  per-head recurrent product), so a split would need a collective a
  time step; every model rank runs it whole and ``finalize_grads``
  completes its gradients, as for the MoE's shared experts.
  everything else (norms, embed, lm_head, router, the sLSTM) replicated.

Each TP rank computes one block of each combine's sum and
``TPContext.all_sum`` combines them.  The unsharded path with
``cfg.tp_degree = T`` and no active context (``models/layers.py``,
``models/ssm.py``) computes the same T blocks and sums them with
``torch.stack(...).sum(0)``, the reduction ``ShardComm.all_sum`` runs
over its stacked rank axis: a TP forward is bitwise its blocked form.

The reference runs the ranks under ``jax.vmap(axis_name="model")`` or a
``shard_map``; here each rank is a process (``launch/mesh.py``) and the
context is built over the mesh's "model" ``ShardComm``
(``Mesh.shared_comm("model")``).  The collectives go through autograd
(``core/comm.py``: ``psum``, whose backward is the all-sum of the
cotangents, as psum transposes to psum).

**Which gradients a rank gets.** The reference differentiates the MEAN
over the ranks of the per-rank losses (every rank's loss is the same
value).  The port pairs the same weight with the same transpose: each
rank back-propagates its loss with the cotangent 1/T, and ``psum``'s
backward all-sums.  So a split leaf's gradient is the unsharded
gradient's slice (the T cotangents of 1/T sum to 1 at the combine), and
a replicated leaf's is this rank's partial: the residual stream's 1/T
plus its own blocks' contribution, whose sum over the ranks is the
unsharded gradient.  ``TPContext.finalize_grads`` all-sums those (the
reference's, Megatron's layernorm-grad all-reduce).  Weight 1 with an
all-sum backward would give T× gradients, weight 1 with an identity
backward T× on the replicated leaves' residual share.  The same holds
for a combine inside a mixer (Mamba's x_proj partial, mLSTM's norm
statistic): the backward is linear in the cotangents, so the ranks'
partials of a replicated quantity sum to the unsharded one.

End-to-end gradients are not bitwise the blocked form's (the reference
says the same of its own): the residual stream's cotangent is summed in
another association (≤ ~1 ulp a layer).

Expert parallelism (``layers.py::_moe_ep``) splits the MoE expert banks
on their expert axis instead (``EXPERT_AXES``, ``experts=True``): each
model rank holds its E/T experts whole and their gradients complete
(the dispatch all-to-all's transpose brings every token's cotangent), so
they are not replicated leaves.  The reference keeps the whole ``moe``
subtree replicated in ``tp_split_params`` (its experts are placed by
pjit); ``tp_split_params``/``tp_unsplit_params`` here are the
reference's for attention and the MLP, and ``tp_rank_params``/
``tp_unsplit_ranks`` the rank processes' per-rank form with or without
the expert split.  The reference's by-name split would also cut mLSTM's
``wq``/``wk``/``wv`` (its explicit-TP module has no mLSTM combine) and
leaves Mamba whole; the port's split is the table above.

``tp_collective_contract`` is the collective budget of one TP rank step,
which ``repro_torch.analysis`` lints a rank's ``ShardComm.record`` log
against.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass

import torch

from repro_torch.core.comm import ShardComm, psum
from repro_torch.core.fabric import DEFAULT_BUCKET_BYTES, BucketLayout, Fabric

# mixer subtree -> {path of a leaf inside it: the axis to slice}
_ATTN_AXES = {"wq": 1, "wk": 1, "wv": 1, "bq": 0, "bk": 0, "bv": 0, "wo": 0}
SPLIT_AXES = {
    "attn": _ATTN_AXES,
    "cross_attn": _ATTN_AXES,
    "mlp": {"w_gate": 1, "w_up": 1, "w_down": 0},
    "mamba": {"in_proj": 1, "conv_w": 1, "conv_b": 0, "x_proj": 0,
              "dt_proj": 1, "dt_bias": 0, "A_log": 0, "D": 0,
              "out_proj": 0},
    "mlstm": {"wq": 1, "wk": 1, "wv": 1, "w_igate": 1, "w_fgate": 1,
              "fgate_bias": 0, "out_norm/scale": 0, "out_proj": 0},
    "slstm": {},
}
# leaves whose split axis holds two halves ([u | z]), each split alike
HALVES = {("mamba", "in_proj")}
# the expert banks directly under a "moe" key: their expert axis
EXPERT_AXES = {"w_gate": 0, "w_up": 0, "w_down": 0}


@dataclass(frozen=True)
class TPContext:
    """Active tensor-parallel execution: ``degree`` ranks over ``comm``
    (the mesh's "model" ``ShardComm``); ``fabric`` buckets
    ``finalize_grads``' all-sum; ``experts`` says whether the MoE expert
    banks are split over the ranks (their gradients then complete)."""

    degree: int
    comm: ShardComm
    fabric: Fabric
    experts: bool = False

    def all_sum(self, x):
        """Combine one row-parallel partial (Megatron's *g*): one all-sum
        of the activation, whose backward all-sums the cotangents."""
        return psum(x, self.comm)

    def finalize_grads(self, grads, stacked_marker: str = "stack"):
        """All-sum the REPLICATED leaves' gradients (this rank's partials)
        over the ranks: one bucketed Fabric all-sum of the replicated
        subtree; split leaves (and split expert banks) pass through."""
        rep, keep = _partition_replicated(grads, stacked_marker,
                                          experts=self.experts)
        if rep:
            rep = self.fabric.all_sum(rep)
        return _merge_trees(rep, keep)


_STACK: list = []


def current_tp():
    """The innermost active ``tp_context``, or None (unsharded paths)."""
    return _STACK[-1] if _STACK else None


@contextmanager
def tp_context(degree: int, comm: ShardComm = None,
               bucket_bytes: int = DEFAULT_BUCKET_BYTES,
               experts: bool = False):
    """Install a TP context over ``comm`` (``degree`` ranks) for the code
    run within, the backward passes that code's autograd graph takes
    included."""
    if degree < 2:
        raise ValueError(f"tp_context needs degree >= 2, got {degree}")
    if comm is None or comm.size != degree:
        raise ValueError(f"tp_context({degree}) needs the model axis's "
                         f"ShardComm of {degree} ranks, got "
                         f"{None if comm is None else comm.size}")
    ctx = TPContext(degree, comm, Fabric(comm, bucket_bytes), experts)
    _STACK.append(ctx)
    try:
        yield ctx
    finally:
        _STACK.pop()


def _walk(tree, leaf, stacked_marker, in_stack=False, where=None, rel=""):
    """``leaf(key, value, axis or None)`` over a dict tree: ``axis`` is the
    split axis of a TP leaf (shifted by one under the stacked marker),
    ``("halves", axis)`` for a leaf of ``HALVES``, ``("expert", axis)``
    for an expert bank directly under "moe", None for a replicated one.
    ``where`` is the mixer subtree the walk is in ("moe" directly under
    the MoE key, "in_moe" below it) and ``rel`` the path inside it."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            if where in ("moe", "in_moe"):
                sub, r = "in_moe", ""
            elif k == "moe" or k in SPLIT_AXES:
                sub, r = k, ""
            else:
                sub, r = where, (rel + k + "/" if where else "")
            out[k] = _walk(v, leaf, stacked_marker,
                           in_stack or k == stacked_marker, sub, r)
            continue
        shift = 1 if in_stack else 0
        table = SPLIT_AXES.get(where, {})
        if where == "moe" and k in EXPERT_AXES:
            axis = ("expert", EXPERT_AXES[k] + shift)
        elif rel + k in table:
            axis = table[rel + k] + shift
            if (where, rel + k) in HALVES:
                axis = ("halves", axis)
        else:
            axis = None
        out[k] = leaf(k, v, axis)
    return out


def _axis(axis, experts):
    """The split of a ``_walk`` axis: an int, ``("halves", ax)``, or None
    (an expert bank without ``experts``)."""
    if isinstance(axis, tuple) and axis[0] == "expert":
        return axis[1] if experts else None
    return axis


def _check(k, v, ax, degree, fn):
    a = ax[1] if isinstance(ax, tuple) else ax
    n = v.shape[a] // 2 if isinstance(ax, tuple) else v.shape[a]
    if v.shape[a] % degree or n % degree:
        raise ValueError(f"{fn}: {k} axis {a} ({v.shape[a]}) not "
                         f"divisible by tp_degree={degree}")


def _chunks(v, ax, degree):
    """The ``degree`` pieces of ``v`` along its split: ``ax`` an int, or
    ``("halves", axis)``, whose piece i is piece i of each half, side by
    side."""
    if not isinstance(ax, tuple):
        return v.chunk(degree, dim=ax)
    a = ax[1]
    first, second = v.chunk(2, dim=a)
    return [torch.cat([x, y], dim=a) for x, y in
            zip(first.chunk(degree, dim=a), second.chunk(degree, dim=a))]


def _unchunk(pieces, ax):
    """Inverse of ``_chunks``."""
    if not isinstance(ax, tuple):
        return torch.cat(pieces, dim=ax)
    a = ax[1]
    halves = [p.chunk(2, dim=a) for p in pieces]
    return torch.cat([h[0] for h in halves] + [h[1] for h in halves], dim=a)


def tp_split_params(params, degree: int, stacked_marker: str = "stack"):
    """Full param tree → per-rank shards STACKED on a new leading axis of
    size ``degree`` (the reference's layout: index ``[r]`` for rank r).
    Splits follow ``SPLIT_AXES`` by mixer subtree; leaves under ``moe``
    and everything else are replicated."""
    if not isinstance(params, dict):
        raise TypeError("tp_split_params expects the dict param tree")

    def leaf(k, v, axis):
        ax = _axis(axis, False)
        if ax is None:
            return torch.stack([v] * degree)
        _check(k, v, ax, degree, "tp_split_params")
        return torch.stack(_chunks(v, ax, degree))

    return _walk(params, leaf, stacked_marker)


def tp_unsplit_params(shards, stacked_marker: str = "stack"):
    """Inverse of ``tp_split_params`` (replicated leaves take rank 0's)."""
    def leaf(k, v, axis):
        ax = _axis(axis, False)
        if ax is None:
            return v[0]
        return _unchunk(v.unbind(0), ax)

    return _walk(shards, leaf, stacked_marker)


def tp_rank_params(params, degree: int, rank: int,
                   stacked_marker: str = "stack", experts: bool = False):
    """Rank ``rank``'s tree of the split: ``tp_split_params(...)[rank]``,
    each split leaf a contiguous tensor of its own; with ``experts`` the
    MoE expert banks split on their expert axis too.  Replicated leaves
    are the caller's tensors."""
    if not isinstance(params, dict):
        raise TypeError("tp_rank_params expects the dict param tree")

    def leaf(k, v, axis):
        ax = _axis(axis, experts)
        if ax is None:
            return v
        _check(k, v, ax, degree, "tp_rank_params")
        return _chunks(v, ax, degree)[rank].contiguous()

    return _walk(params, leaf, stacked_marker)


def tp_unsplit_ranks(trees, stacked_marker: str = "stack",
                     experts: bool = False):
    """Inverse of ``tp_rank_params`` over the ranks' trees, in rank order
    (replicated leaves take rank 0's)."""
    leaves = [_flat(t) for t in trees]

    def leaf(k, v, axis):
        ax = _axis(axis, experts)
        mine = [next(it) for it in leaves]
        if ax is None:
            return mine[0]
        return _unchunk(mine, ax)

    return _walk(trees[0], leaf, stacked_marker)


def _flat(tree):
    """The leaves of a dict tree in ``_walk``'s (insertion) order."""
    for v in tree.values():
        if isinstance(v, dict):
            yield from _flat(v)
        else:
            yield v


def splits_experts(params, degree: int) -> bool:
    """Whether ``tp_rank_params`` should split the expert banks: the tree
    has MoE banks and each one's expert axis divides by ``degree`` (else
    they stay replicated and every rank runs the whole dispatch)."""
    found = []

    def leaf(k, v, axis):
        if isinstance(axis, tuple) and axis[0] == "expert":
            found.append(v.shape[axis[1]] % degree == 0)
        return v

    _walk(params, leaf, "stack")
    return bool(found) and all(found)


def _partition_replicated(tree, stacked_marker: str = "stack",
                          experts: bool = False):
    """Split a dict tree into (replicated-leaf subtree, split-leaf
    subtree) by ``SPLIT_AXES`` (and, with ``experts``, the expert banks);
    either side omits empty branches."""
    split = _walk(tree, lambda k, v, axis: _axis(axis, experts) is not None,
                  stacked_marker)

    def cut(t, flags, want):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                sub = cut(v, flags[k], want)
                if sub:
                    out[k] = sub
            elif flags[k] == want:
                out[k] = v
        return out

    return cut(tree, split, False), cut(tree, split, True)


def _merge_trees(a, b):
    """Recombine the two disjoint subtrees of ``_partition_replicated``."""
    out = dict(a)
    for k, v in b.items():
        out[k] = _merge_trees(out[k], v) if isinstance(v, dict) and \
            isinstance(out.get(k), dict) else v
    return out


def tp_collective_contract(cfg, activation,
                           bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                           wire_dtype=None) -> dict:
    """The backend calls of ONE training step of a ``tp_degree``-split
    model, as ``Fabric.collective_contract(..., "tp")`` counts them: two
    row-parallel combines a layer (the out-projection and the
    down-projection), each an all-sum of the layer ``activation`` (a
    tensor, meta or real, of its shape and dtype), forward AND backward
    (``psum``'s backward all-sums the cotangents).  The reference's
    count; ``finalize_grads``' buckets come on top."""
    combines = 2 * cfg.num_layers * 2  # (wo + w_down) x (fwd + bwd)
    lay = BucketLayout.build(activation, bucket_bytes, lead_axes=0)
    # the contract reads the layout only: no comm (nor process group)
    fab = Fabric(None, bucket_bytes, wire_dtype=wire_dtype)
    return fab.collective_contract(lay, "tp", events=combines)
