"""Quickstart: train a tiny LM with the port's public API, then generate.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Port of ``examples/quickstart.py``: W = 2 stacked replicas under ``sync``
with Adam on the synthetic affine-stream data, then ``greedy_generate``
from replica 0.  On ``--device cuda`` (the default) generation prefills
through the flash-attention kernel.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core.comm import LocalComm
from repro_torch.core.strategies import sync
from repro_torch.data.pipeline import DataConfig, worker_batches
from repro_torch.models import transformer as T
from repro_torch.optim import adam
from repro_torch.serve.engine import greedy_generate
from repro_torch.train.loop import (init_train_state, make_loss_fn,
                                    make_replica_train_step)

W, STEPS = 2, 80


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = dataclasses.replace(
        get_config("qwen2-1.5b").reduced(),
        num_layers=2, d_model=64, num_heads=2, num_kv_heads=1, head_dim=32,
        d_ff=128, vocab_size=64)
    comm = LocalComm(W)
    strategy = sync()
    opt = adam(3e-3)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                      batch_per_worker=4)

    gen = torch.Generator(device=dev).manual_seed(0)
    params = comm.replicate(T.init_model(gen, cfg, device=dev))
    state = init_train_state(params, opt, strategy, comm)
    lf = make_loss_fn(cfg, remat=False)
    step = make_replica_train_step(
        lambda p, toks: lf(p, {"tokens": toks, "labels": toks}),
        opt, strategy, comm)

    for t in range(STEPS):
        state, m = step(state, worker_batches(dcfg, W, t, device=dev))
        if t % 20 == 0 or t == STEPS - 1:
            print(f"step {t:3d}  loss {float(m['loss']):.4f}  "
                  f"replica divergence "
                  f"{float(m['replica_divergence']):.1e}")

    tokens = greedy_generate(comm.replica(state["params"], 0), cfg,
                             np.array([1, 2, 3], np.int32), max_new_tokens=8,
                             device=dev)
    print("generated:", tokens)
    print("OK")
    return tokens


if __name__ == "__main__":
    main()
