"""The paper's §3 experiment: train the SAME model under every point of the
communication-completeness spectrum and compare convergence and
consistency.

    PYTHONPATH=src python -m repro_torch.examples.spectrum_comparison \
        [--device cpu] [--steps 120]

Port of ``examples/spectrum_comparison.py``.  Expected outcome (the
paper's argument):
  * sync / ssp / downpour (complete communication): near-identical loss;
  * gossip (partial): trains, but the replicas genuinely diverge;
  * compression: the same loss at a fraction of the wire bytes.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core import strategies as ST
from repro_torch.core.comm import LocalComm
from repro_torch.core.compression import get_compressor
from repro_torch.data.pipeline import DataConfig, bayes_entropy, worker_batches
from repro_torch.models import transformer as T
from repro_torch.optim import adam
from repro_torch.train.loop import (init_train_state, make_loss_fn,
                                    make_replica_train_step)

W = 4


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=120)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = dataclasses.replace(
        get_config("qwen2-1.5b").reduced(), num_layers=2, d_model=64,
        num_heads=2, num_kv_heads=1, head_dim=32, d_ff=128, vocab_size=64)
    comm = LocalComm(W)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                      batch_per_worker=4)
    lf = make_loss_fn(cfg, remat=False)

    def loss_fn(p, toks):
        return lf(p, {"tokens": toks, "labels": toks})

    print(f"{'strategy':22s} {'pt':>2s} {'final_loss':>10s} "
          f"{'divergence':>11s} {'wireB/step':>10s}")
    rows = []
    for name, strat in [
        ("sync (pt 1)", ST.sync()),
        ("sync + 1-bit", ST.sync(compressor=get_compressor("onebit"))),
        ("ssp s=4 (pt 2)", ST.ssp(staleness=4)),
        ("downpour (pt 3)", ST.downpour(push_every=4)),
        ("gossip (pt 4)", ST.gossip()),
        ("local_sgd H=8", ST.local_sgd(sync_every=8)),
    ]:
        opt = adam(3e-3)
        gen = torch.Generator(device=dev).manual_seed(0)
        params = comm.replicate(T.init_model(gen, cfg, device=dev))
        state = init_train_state(params, opt, strat, comm)
        step = make_replica_train_step(loss_fn, opt, strat, comm)
        losses, wire = [], 0.0
        for t in range(args.steps):
            state, m = step(state, worker_batches(dcfg, W, t, device=dev))
            losses.append(float(m["loss"]))
            wire += float(m["wire_bytes"])
        row = (name, strat.spectrum_point, float(np.mean(losses[-10:])),
               float(m["replica_divergence"]), wire / args.steps)
        rows.append(row)
        print(f"{row[0]:22s} {row[1]:2d} {row[2]:10.4f} {row[3]:11.2e} "
              f"{row[4]:10.0f}")

    print(f"\nuniform baseline: {np.log(cfg.vocab_size):.4f}   "
          f"generating-process floor: {bayes_entropy(dcfg):.4f}")
    return rows


if __name__ == "__main__":
    main()
