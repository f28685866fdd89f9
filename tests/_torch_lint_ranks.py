"""Strategies and steps that ``tests/test_torch_analysis.py`` breaks on
purpose, each the port's own code put together wrongly, so that every
lint rule is seen to fail on the bug class it encodes.

The strategy factories take ``(policy, bucket_bytes)``, as
``repro_torch.analysis.rigs.build_strategy`` calls them; the exchange
rigs run them in gloo rank processes, which import this module by name.
Torch only: a rank process imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import strategies as ST
from repro_torch.core import tree as T
from repro_torch.core.fabric import Fabric


def _fab(comm, bucket_bytes, policy):
    return Fabric(comm, bucket_bytes,
                  wire_dtype=policy.wire_dt if policy is not None else None)


def zero1_extra_all_reduce(policy, bucket_bytes):
    """``sync_zero1`` with a stray dense all-reduce of the gradients beside
    its reduce-scatter: one all-to-all and one all-gather a bucket too
    many."""
    z1 = ST.sync_zero1(bucket_bytes=bucket_bytes, policy=policy)

    def update(params, grads, opt_state, cstate, t, opt, comm):
        _fab(comm, bucket_bytes, policy).all_mean(grads)
        return z1.update(params, grads, opt_state, cstate, t, opt, comm)

    return dataclasses.replace(z1, update=update)


def _sync_with_flags(policy, bucket_bytes, n_flags):
    base = ST.sync(bucket_bytes=bucket_bytes, policy=policy)

    def update(params, grads, opt_state, cstate, t, opt, comm):
        for _ in range(n_flags):  # a finite flag a call
            comm.all_min(torch.ones((), device=T.leaves(grads)[0].device))
        return base.update(params, grads, opt_state, cstate, t, opt, comm)

    return dataclasses.replace(base, update=update)


def sync_one_flag(policy, bucket_bytes):
    """``sync`` with one scalar control call (a finite flag's minimum)."""
    return _sync_with_flags(policy, bucket_bytes, 1)


def sync_flag_flood(policy, bucket_bytes):
    """``sync`` with a finite flag's minimum five times a step."""
    return _sync_with_flags(policy, bucket_bytes, 5)


def sync_without_exchange(policy, bucket_bytes):
    """Declares the dense wire, ships nothing: every worker steps on its
    own gradients."""
    base = ST.sync(bucket_bytes=bucket_bytes, policy=policy)

    def update(params, grads, opt_state, cstate, t, opt, comm):
        params, opt_state = opt.update(grads, opt_state, params, t)
        return params, opt_state, cstate, {}

    return dataclasses.replace(base, update=update)


def sync_dropping_policy(policy, bucket_bytes):
    """``sync`` built without the precision policy: under bf16 its Fabric
    ships f32 buckets."""
    return ST.sync(bucket_bytes=bucket_bytes)


def _gated(policy, bucket_bytes, ship_every_step):
    base = ST.local_sgd(sync_every=4, bucket_bytes=bucket_bytes,
                        policy=policy)

    def update(params, grads, opt_state, cstate, t, opt, comm):
        fab = _fab(comm, bucket_bytes, policy)
        params, opt_state = opt.update(grads, opt_state, params, t)
        do = (t + 1) % 4 == 0
        if ship_every_step:
            # a where-style gate: the mean is computed every step and kept
            # only at a firing one
            mean = fab.all_mean(params)
            if do:
                params = T.tree_map(lambda x: x.contiguous(), mean)
        return params, opt_state, cstate, fab.metrics(
            fab.flat_bytes(params), events=float(do))

    return dataclasses.replace(base, update=update)


def gated_ships_every_step(policy, bucket_bytes):
    """Declares ``gated`` with ``sync_every`` 4, averages every step."""
    return _gated(policy, bucket_bytes, True)


def gated_never_ships(policy, bucket_bytes):
    """Declares ``gated`` with ``sync_every`` 4, never averages."""
    return _gated(policy, bucket_bytes, False)


def bf16_all_sum(policy, bucket_bytes):
    """One all-sum of a bf16 tensor straight through the comm."""
    base = ST.sync(bucket_bytes=bucket_bytes, policy=policy)

    def update(params, grads, opt_state, cstate, t, opt, comm):
        x = torch.ones(64, dtype=torch.bfloat16,
                       device=T.leaves(grads)[0].device)
        comm.all_sum([x])
        return params, opt_state, cstate, {}

    return dataclasses.replace(base, update=update)


def downpour_writing_comm_state(policy, bucket_bytes):
    """``downpour`` that writes its new accumulator and a key into the
    caller's comm_state."""
    base = ST.downpour(bucket_bytes=bucket_bytes, policy=policy)

    def update(params, grads, opt_state, cstate, t, opt, comm):
        out = base.update(params, grads, opt_state, cstate, t, opt, comm)
        cstate["acc"]["w"] = out[2]["acc"]["w"]
        cstate["extra"] = 1
        return out

    return dataclasses.replace(base, update=update)
