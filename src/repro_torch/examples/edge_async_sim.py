"""The paper's edge scenario (§1, §3): loosely-coupled heterogeneous
workers where communication is costly, in two acts.

    PYTHONPATH=src python -m repro_torch.examples.edge_async_sim \
        [--device cpu] [--steps 100]

Port of ``examples/edge_async_sim.py``.

Act 1: the hierarchical strategy, complete synchronization inside each
"site" and partial (gossip) communication across sites, on
``LocalHierComm(3, 2)``.

Act 2: the same edge fleet under chaos: a fault schedule (slowdown →
straggler demotion → flake → kill → graceful degradation → restore →
rejoin) driven through ``launch/elastic.py::ElasticFleet``, printing the
log of each boundary.  Edge workers do not just communicate loosely;
they disappear.  Batches are keyed by stable worker id
(``data/pipeline.py::sample_batch``), so a resize draws the rows of
exactly the members present.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core import strategies as ST
from repro_torch.core import tree as T
from repro_torch.core.chaos import ChaosEvent, ChaosSchedule, FleetClock
from repro_torch.core.comm import LocalHierComm
from repro_torch.core.staleness import StragglerPolicy
from repro_torch.data.pipeline import DataConfig, sample_batch
from repro_torch.launch.elastic import ElasticFleet
from repro_torch.models import transformer as TM
from repro_torch.optim import adam
from repro_torch.train.loop import _replica_grads, make_loss_fn

PODS, WORKERS, W, CHAOS_STEPS = 3, 2, 4, 24
SCHEDULE = ChaosSchedule((
    ChaosEvent(3, "slowdown", 1, 5.0),   # worker 1 turns straggler
    ChaosEvent(7, "flake", 0),           # one transient exchange failure
    ChaosEvent(10, "kill", 3),           # worker 3 dies mid-boundary
    ChaosEvent(14, "restore", 1),        # worker 1 recovers speed
    ChaosEvent(18, "rejoin", 3),         # worker 3 comes back
))


def edge_config():
    return dataclasses.replace(
        get_config("qwen2-1.5b").reduced(), num_layers=2, d_model=64,
        num_heads=2, num_kv_heads=1, head_dim=32, d_ff=128, vocab_size=64)


def hierarchical_act(base, loss_fn, dcfg, steps, dev):
    """Act 1: ``hierarchical(sync, gossip)`` over (pods, workers) stacked
    replicas; each replica's gradient from its own worker's batch."""
    comm = LocalHierComm(PODS, WORKERS)
    strat = ST.hierarchical(ST.sync(), ST.gossip(mix_every=4))
    opt = adam(3e-3)
    params = T.tree_map(lambda x: x.expand((PODS, WORKERS) + x.shape)
                        .contiguous(), base)
    opt_state, cstate = opt.init(params), strat.init(params, comm)
    for t in range(steps):
        batches = torch.stack([
            torch.stack([sample_batch(dcfg, pod * WORKERS + w, t, device=dev)
                         for w in range(WORKERS)]) for pod in range(PODS)])
        # the (pods, workers) replicas as one replica axis of views
        flat = T.tree_map(lambda x: x.reshape((PODS * WORKERS,)
                                              + x.shape[2:]), params)
        loss, grads = _replica_grads(loss_fn, flat,
                                     batches.reshape((PODS * WORKERS,)
                                                     + batches.shape[2:]))
        grads = T.tree_map(lambda g: g.reshape((PODS, WORKERS) + g.shape[1:]),
                           grads)
        params, opt_state, cstate, _ = strat.update(
            params, grads, opt_state, cstate, t, opt, comm)
        if t % 20 == 0 or t == steps - 1:
            w = params["final_norm"]["scale"]
            intra = float((w[:, 0] - w[:, 1]).abs().max())
            cross = float((w[0] - w[1]).abs().max())
            print(f"step {t:3d} loss {float(loss.mean()):.4f}  "
                  f"intra-site divergence {intra:.1e}  cross-site "
                  f"{cross:.1e}")
    print("\nintra-site replicas consistent (complete sync tier); "
          "cross-site divergence bounded by gossip mixing — the paper's "
          "edge deployment story.")


def chaos_act(base, loss_fn, dcfg, dev, steps=CHAOS_STEPS):
    """Act 2: the chaos rig, the fleet survives the schedule."""
    print("\n--- chaos rig: elastic fleet under a seeded fault schedule ---")

    def chaos_batch_fn(view, t):
        # keyed by STABLE worker id: a resize regenerates the rows for
        # exactly the members present this boundary
        return torch.stack([sample_batch(dcfg, w, t, device=dev)
                            for w in view.members])

    fleet = ElasticFleet(base, loss_fn, adam(3e-3), workers=W,
                         straggler_policy=StragglerPolicy(patience=2,
                                                          recovery=2),
                         resync_every=4, chaos=SCHEDULE,
                         clock=FleetClock(W, jitter=0.0, seed=0),
                         retries=2, backoff_s=1e-4)
    for _ in range(steps):
        lg = fleet.run_boundary(chaos_batch_fn)
        note = "; ".join(
            [f"{e['kind']}(w{e['worker']})" for e in lg["events"]]
            + ([f"demoted {lg['demoted']}"] if "demoted" in lg else [])
            + ([f"promoted {lg['promoted']}"] if "promoted" in lg else [])
            + ([f"DROPPED {lg['dropped']} after {lg['attempts']} attempts"]
               if "dropped" in lg else [])
            + ([f"retried x{lg['attempts']}"]
               if lg["attempts"] and "dropped" not in lg else []))
        print(f"boundary {lg['t']:2d} epoch {lg['epoch_after']} "
              f"W={lg['size_after']} loss {lg['loss']:.4f}"
              + (f"  [{note}]" if note else ""))
    print(f"\nfleet finished all {steps} boundaries: membership epoch "
          f"{fleet.view.epoch}, final W={fleet.view.size}, demoted="
          f"{list(fleet.view.demoted)} — every fault in the schedule was "
          "absorbed at an optimizer boundary.")
    return fleet


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=100,
                    help="Act 1's hierarchical steps")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = edge_config()
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                      batch_per_worker=4)
    lf = make_loss_fn(cfg, remat=False)

    def loss_fn(p, toks):
        return lf(p, {"tokens": toks, "labels": toks})

    base = TM.init_model(torch.Generator(device=dev).manual_seed(0), cfg,
                         device=dev)
    hierarchical_act(base, loss_fn, dcfg, args.steps, dev)
    return chaos_act(base, loss_fn, dcfg, dev)


if __name__ == "__main__":
    main()
