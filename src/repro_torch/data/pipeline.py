"""Deterministic synthetic data pipeline.

Port of ``repro/data/pipeline.py``: a learnable token stream in which,
with probability ``structure``, the next token is the affine successor
``x' = (a·x + b) mod V`` and otherwise uniform.  Every (worker, step) gets
a reproducible shard from an explicit ``torch.Generator`` seeded from
``(seed, worker, step)``, as the reference folds ``worker`` and then
``step`` into its key, drawn on the host: ``jax.random``'s bits cannot
be reproduced and need not be (the parity tests feed the JAX package's
batches to the port).  ``sample_batch`` is one worker's batch and
``worker_batches`` the stack of W of them, so a worker's batch does not
depend on W: an elastic fleet keyed by stable worker ids draws, for
members ``(0, …, W-1)``, exactly the trainer's tokens.  A batch is a few
KB, so the host draws it and one non-blocking copy moves it to the card.

``global_batch`` is the flat batch of the production step (the workers'
rows in order) and ``rank_batch`` one rank's rows of it, which a rank
process of the sharded step draws on its own.  ``microbatch_stack`` stacks the microbatches of one accumulation boundary
(microbatch j of optimizer step T is plain step ``T*accum_steps + j``),
and ``prefetch_batches`` keeps ``depth`` batches in flight: on the card
batch t+1 is drawn on the host and its pinned copy enqueued on a side
stream before step t is dispatched, and the consumer's stream waits for
that stream when it takes the batch.  The values are the same at every
depth.
"""

from __future__ import annotations

from collections import deque
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


def _generator(cfg: DataConfig, worker: int, step: int) -> torch.Generator:
    # one stream per (seed, worker, step)
    key = (cfg.seed * 1_000_003 + int(worker)) * 1_000_003 + int(step)
    return torch.Generator().manual_seed(key % (1 << 63))


def _host_rows(cfg: DataConfig, workers, step: int):
    """(len(workers), batch_per_worker, seq_len) int32 tokens of ``step``
    on the host: each worker's draws from its own generator, the affine
    recurrence run on all rows at once (it is elementwise a row)."""
    b, l, v = cfg.batch_per_worker, cfg.seq_len, cfg.v_act
    start, noise, coin = [], [], []
    for w in workers:
        gen = _generator(cfg, w, step)
        start.append(torch.randint(0, v, (b,), generator=gen,
                                   dtype=torch.int64))
        noise.append(torch.randint(0, v, (b, l), generator=gen,
                                   dtype=torch.int64))
        coin.append(torch.rand((b, l), generator=gen) < cfg.structure)
    noise, coin = torch.stack(noise), torch.stack(coin)
    toks = torch.empty((len(workers), b, l), dtype=torch.int32)
    x = torch.stack(start)
    for i in range(l):
        x = torch.where(coin[..., i], (cfg.a * x + cfg.b) % v, noise[..., i])
        toks[..., i] = x
    return toks


def _host_batches(cfg: DataConfig, n_workers: int, step: int):
    """(W, batch_per_worker, seq_len) int32 tokens of ``step`` on the host:
    the rows of workers 0 … W-1."""
    return _host_rows(cfg, range(n_workers), step)


def _host_stack(cfg, n_workers, opt_step, accum_steps):
    steps = range(opt_step * accum_steps, (opt_step + 1) * accum_steps)
    return torch.stack([_host_batches(cfg, n_workers, s) for s in steps])


def _to_device(toks, dev):
    if dev.type == "cuda":
        return toks.pin_memory().to(dev, non_blocking=True)
    return toks.to(dev)


def sample_batch(cfg: DataConfig, worker: int, step: int, device="cuda"):
    """(batch_per_worker, seq_len) int32 tokens of one worker at ``step``,
    deterministic in (seed, worker, step), on ``device``."""
    dev = resolve_device(device)
    return _to_device(_host_rows(cfg, (worker,), step)[0], dev)


def worker_batches(cfg: DataConfig, n_workers: int, step: int,
                   device="cuda"):
    """Stacked (W, batch_per_worker, seq_len) int32 tokens of ``step`` on
    ``device``: row w is ``sample_batch(cfg, w, step)``."""
    dev = resolve_device(device)
    return _to_device(_host_batches(cfg, n_workers, step), dev)


def microbatch_stack(cfg: DataConfig, n_workers: int, opt_step: int,
                     accum_steps: int, device="cuda"):
    """(accum_steps, W, batch_per_worker, seq_len): the microbatches of one
    accumulation boundary.  Microbatch j of optimizer step T draws the data
    of plain step ``T*accum_steps + j``, so the token stream is the one of
    ``accum_steps`` unaccumulated steps."""
    dev = resolve_device(device)
    return _to_device(_host_stack(cfg, n_workers, opt_step, accum_steps),
                      dev)


def global_batch(cfg: DataConfig, step: int, global_batch_size: int,
                 device="cuda"):
    """One flat (global_batch_size, seq_len) batch of ``step``: the
    workers' rows concatenated in worker order, as the reference's."""
    n = global_batch_size // cfg.batch_per_worker
    return worker_batches(cfg, n, step, device).reshape(global_batch_size,
                                                         cfg.seq_len)


def rank_batch(cfg: DataConfig, rank: int, step: int, accum_steps: int = 1,
               device="cuda"):
    """Rank ``rank``'s rows of ``global_batch`` at optimizer step ``step``:
    ``sample_batch`` of worker ``rank`` (bitwise replica ``rank``'s batch
    of the stacked step); with ``accum_steps > 1`` the
    ``(accum_steps, batch_per_worker, seq_len)`` stack of plain steps
    ``step * accum_steps + j``, replica ``rank``'s rows of
    ``microbatch_stack``."""
    dev = resolve_device(device)
    if accum_steps == 1:
        return _to_device(_host_rows(cfg, (rank,), step)[0], dev)
    rows = torch.stack([_host_rows(cfg, (rank,), s)[0]
                        for s in range(step * accum_steps,
                                       (step + 1) * accum_steps)])
    return _to_device(rows, dev)


def prefetch_batches(cfg: DataConfig, n_workers: int, steps: int,
                     accum_steps: int = 1, depth: int = 2, device="cuda"):
    """Yields ``(t, batch)`` for ``steps`` optimizer steps in order, keeping
    up to ``depth`` batches in flight (``depth=1`` is synchronous).

    A batch is ``worker_batches`` of step t, or ``microbatch_stack`` of
    boundary t when ``accum_steps > 1``.  On a CUDA device each batch is
    drawn on the host, pinned, and copied on a side stream; when the
    consumer takes it, its current stream waits for the side stream and
    the batch is recorded on the consumer's stream, so the caching
    allocator does not reuse it early."""
    dev = resolve_device(device)
    depth = max(1, depth)
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    q = deque()

    def synth(t):
        host = (_host_stack(cfg, n_workers, t, accum_steps) if accum_steps > 1
                else _host_batches(cfg, n_workers, t))
        if side is None:
            return host.to(dev)
        host = host.pin_memory()
        with torch.cuda.stream(side):
            return host.to(dev, non_blocking=True)

    def take():
        t, b = q.popleft()
        if side is not None:
            cur = torch.cuda.current_stream(dev)
            cur.wait_stream(side)
            b.record_stream(cur)
        return t, b

    for t in range(steps):
        q.append((t, synth(t)))
        while len(q) >= depth:
            yield take()
    while q:
        yield take()


def bayes_entropy(cfg: DataConfig) -> float:
    """Entropy of the generating process (loss floor for a perfect model)."""
    s, v = cfg.structure, cfg.v_act
    # next ~ s·δ(successor) + (1−s)·uniform; the successor gets s+(1−s)/V
    p_succ = s + (1 - s) / v
    p_other = (1 - s) / v
    return float(-(p_succ * np.log(p_succ)
                   + (v - 1) * p_other * np.log(p_other)))
