"""End-to-end example: train a decoder LM with the full stack (data
pipeline, a strategy of the spectrum, Adam, a checkpoint at the end).

    PYTHONPATH=src python -m repro_torch.examples.train_lm \\
        [--scale tiny|10m|110m] [--strategy sync_zero1] [--ckpt-dir DIR] \\
        [--device cpu]

Port of ``examples/train_lm.py``: the same scales (``110m`` is 12 layers,
d_model 768, GQA 12/4, a 32k vocabulary), W stacked replicas, and with
``--ckpt-dir`` replica 0's params saved at the last step in the
reference's format (``repro_torch.checkpoint``).  Runs on
``--device cuda`` (the default) unless asked for the CPU.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs.base import ModelConfig
from repro_torch.core import tree as TT
from repro_torch.core.comm import LocalComm
from repro_torch.core.compression import get_compressor
from repro_torch.core.strategies import get_strategy
from repro_torch.data.pipeline import DataConfig, bayes_entropy, worker_batches
from repro_torch.models import transformer as T
from repro_torch.optim import adam, warmup_cosine
from repro_torch.train.loop import (init_train_state, make_loss_fn,
                                    make_replica_train_step)

SCALES = {
    # ~110M: 12L d768 ff2048 (GQA 12/4) vocab 32k, a GPT-2-small-class model
    "110m": ModelConfig(name="lm-110m", num_layers=12, d_model=768,
                        num_heads=12, num_kv_heads=4, d_ff=2048,
                        vocab_size=32_768, tie_embeddings=True),
    "10m": ModelConfig(name="lm-10m", num_layers=4, d_model=256,
                       num_heads=4, num_kv_heads=2, d_ff=1024,
                       vocab_size=8_192, tie_embeddings=True),
    "tiny": ModelConfig(name="lm-tiny", num_layers=2, d_model=64,
                        num_heads=2, num_kv_heads=1, d_ff=128,
                        vocab_size=256, tie_embeddings=True),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", default="tiny", choices=list(SCALES))
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--strategy", default="sync")
    ap.add_argument("--compressor", default="none")
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch-per-worker", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = SCALES[args.scale]
    comm = LocalComm(args.workers)
    comp = None if args.compressor == "none" \
        else get_compressor(args.compressor)
    kw = {"compressor": comp} \
        if args.strategy in ("sync", "ssp", "downpour") else {}
    strategy = get_strategy(args.strategy, **kw)
    opt = adam(warmup_cosine(args.lr, warmup=max(1, args.steps // 20),
                             total_steps=args.steps))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                      batch_per_worker=args.batch_per_worker,
                      active_vocab=min(256, cfg.vocab_size))

    gen = torch.Generator(device=dev).manual_seed(0)
    params = comm.replicate(T.init_model(gen, cfg, device=dev))
    n = sum(x.numel() for x in TT.leaves(params)) // args.workers
    print(f"model {cfg.name}: {n:,} params | strategy {strategy.name} | "
          f"W={args.workers} | entropy floor {bayes_entropy(dcfg):.3f} | "
          f"uniform {math.log(cfg.vocab_size):.3f}")

    state = init_train_state(params, opt, strategy, comm)
    del params
    lf = make_loss_fn(cfg, remat=False)
    step = make_replica_train_step(
        lambda p, toks: lf(p, {"tokens": toks, "labels": toks}),
        opt, strategy, comm)

    hist = []
    t0 = time.time()
    for t in range(args.steps):
        state, m = step(state, worker_batches(dcfg, args.workers, t,
                                              device=dev))
        if t % 10 == 0 or t == args.steps - 1:
            rec = {"step": t, "loss": float(m["loss"]),
                   "div": float(m["replica_divergence"]),
                   "elapsed_s": round(time.time() - t0, 1)}
            hist.append(rec)
            tok_s = (t + 1) * args.workers * args.batch_per_worker \
                * args.seq_len / (time.time() - t0)
            print(f"step {t:4d}  loss {rec['loss']:.4f}  "
                  f"div {rec['div']:.1e}  {tok_s:,.0f} tok/s")
    if args.ckpt_dir:
        # ZeRO-3 keeps shard buckets in the state: save the gathered tree
        full = strategy.gather_params(state["params"], comm) \
            if strategy.owns_params else state["params"]
        save_checkpoint(args.ckpt_dir, args.steps,
                        {"params": comm.replica(full, 0)})
        print(f"checkpoint saved to {args.ckpt_dir}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(hist, f, indent=1)
    return hist


if __name__ == "__main__":
    main()
