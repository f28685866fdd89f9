"""Deterministic synthetic data pipeline.

Port of ``repro/data/pipeline.py``: a learnable token stream in which,
with probability ``structure``, the next token is the affine successor
``x' = (a·x + b) mod V`` and otherwise uniform.  Every (worker, step) gets
a reproducible shard from an explicit ``torch.Generator`` seeded from
``(seed, step)``, drawn on the host: ``jax.random``'s bits cannot be
reproduced and need not be (the parity tests feed the JAX package's
batches to the port).  A batch is a few KB, so the host draws it and one
non-blocking copy moves it to the card.

``prefetch_batches`` and ``microbatch_stack`` (the device double buffer
and microbatch accumulation) are later slices of the port.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import resolve_device


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_per_worker: int
    structure: float = 0.9  # P(next = successor)
    a: int = 31
    b: int = 7
    seed: int = 0
    # tokens are drawn from [0, active_vocab); 0 ⇒ the full vocabulary
    active_vocab: int = 0

    @property
    def v_act(self) -> int:
        return self.active_vocab or self.vocab_size


def _generator(cfg: DataConfig, step: int) -> torch.Generator:
    # one stream per (seed, step); the workers' shards are its rows
    return torch.Generator().manual_seed(
        (cfg.seed * 1_000_003 + int(step)) % (1 << 63))


def worker_batches(cfg: DataConfig, n_workers: int, step: int,
                   device="cuda"):
    """Stacked (W, batch_per_worker, seq_len) int32 tokens of ``step``,
    deterministic in (seed, step), on ``device``."""
    dev = resolve_device(device)
    gen = _generator(cfg, step)
    w, b, l, v = n_workers, cfg.batch_per_worker, cfg.seq_len, cfg.v_act
    start = torch.randint(0, v, (w, b), generator=gen, dtype=torch.int64)
    noise = torch.randint(0, v, (w, b, l), generator=gen, dtype=torch.int64)
    coin = torch.rand((w, b, l), generator=gen) < cfg.structure
    toks = torch.empty((w, b, l), dtype=torch.int32)
    x = start
    for i in range(l):
        x = torch.where(coin[..., i], (cfg.a * x + cfg.b) % v, noise[..., i])
        toks[..., i] = x
    if dev.type == "cuda":
        return toks.pin_memory().to(dev, non_blocking=True)
    return toks.to(dev)


def bayes_entropy(cfg: DataConfig) -> float:
    """Entropy of the generating process (loss floor for a perfect model)."""
    s, v = cfg.structure, cfg.v_act
    # next ~ s·δ(successor) + (1−s)·uniform; the successor gets s+(1−s)/V
    p_succ = s + (1 - s) / v
    p_other = (1 - s) / v
    return float(-(p_succ * np.log(p_succ)
                   + (v - 1) * p_other * np.log(p_other)))
