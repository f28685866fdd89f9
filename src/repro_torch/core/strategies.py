"""The communication-completeness spectrum as executable strategies.

Port of ``repro/core/strategies.py``.  ``Strategy`` keeps every field of
the reference, so the later strategies (ZeRO, DGC, the local-step and
asynchronous ones) slot in without changing it; the registry holds only
what is ported.  This slice ports spectrum point 1, ``sync``: a
bucket-fused all-mean of the gradients (``core/fabric.py``), optionally
compressed with error feedback, then one optimizer step.  Every replica
applies the same mean, so the replicas never diverge.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from repro_torch.core.compression import Compressor, ef_init
from repro_torch.core.fabric import DEFAULT_BUCKET_BYTES, Fabric


@dataclass(frozen=True)
class Strategy:
    name: str
    spectrum_point: int  # 1..4 per the paper's §3 taxonomy
    complete: bool  # does every update eventually reach every worker?
    init: Callable  # (params, comm) -> comm_state
    update: Callable  # (params, grads, opt_state, comm_state, t, optimizer,
    #                   comm) -> (params, opt_state, comm_state, metrics)
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
    # FRESH mapping.


# ---------------------------------------------------------------------------
# 1. synchronous — large mini-batch all-reduce (bucket-fused)
# ---------------------------------------------------------------------------
def sync(compressor: Optional[Compressor] = None,
         bucket_bytes: int = DEFAULT_BUCKET_BYTES) -> Strategy:
    """f32 wire and update; the precision policy is a later slice."""

    def init(params, comm):
        return {"residual": ef_init(params)} if compressor else {}

    def update(params, grads, opt_state, cstate, t, opt, comm):
        fab = Fabric(comm, bucket_bytes)
        g, new_res, m = fab.exchange(grads, cstate.get("residual"), compressor)
        if compressor:
            cstate = {"residual": new_res}
        params, opt_state = opt.update(g, opt_state, params, t)
        return params, opt_state, cstate, m

    return Strategy("sync", 1, True, init, update,
                    wire_profile="compressed" if compressor else "dense")


REGISTRY = {
    "sync": sync,
}


def get_strategy(name: str, **kw) -> Strategy:
    return REGISTRY[name](**kw)
