"""Batched decode engines with continuous batching, and greedy generation.

Port of ``repro/serve/engine.py``: ``DecodeEngine`` (a dense (B, max_seq)
KV cache, ragged per-slot positions, prompts ingested one token per step),
``PagedDecodeEngine`` (a paged KV cache with chunked prefill) and
``greedy_generate`` (one full-sequence prefill, then greedy decode).  The
engines keep the reference's admission, prefill, eviction and drain, step
for step, so on the same parameters and requests they emit the same
greedy tokens.

Differences from the reference:
  * ``device`` replaces ``use_kernel``: on ``"cuda"`` the paged engine's
    single-token decode attention runs the CUDA paged-attention kernel and
    ``greedy_generate``'s prefill attention the CUDA flash-attention
    kernel; on ``"cpu"`` their plain PyTorch versions.  int8 pools take the
    gather path on either device, as in the reference.
  * ``DecodeEngine`` and ``greedy_generate`` take attention and the
    recurrent families (jamba's Mamba layers, with or without experts,
    xLSTM), with dense MLP or MoE FFNs, decoder-only or encoder-decoder;
    ``PagedDecodeEngine`` takes the decoder-only attention stacks, MoE
    included (``init_paged_cache`` rejects an encoder-decoder stack, as
    the reference's).  On ``"cuda"`` the prefill's Mamba scans run the
    CUDA ``mamba_scan`` kernel.  An MoE step routes every row it is
    given, pads and idle slots included, so capacity drops what the
    reference's step drops.
  * an encoder-decoder model's ``memory`` (the output of ``encode``, in
    the compute dtype) is a keyword after the port's other parameters,
    moved to the engine's device; every decode step and the prefill
    attend over it, each cross attention one flash launch on the card.
    As in the reference, ``DecodeEngine``'s memory is (batch_slots, S,
    D) and slot i attends to row i whatever request it holds;
    ``greedy_generate``'s is (1, S, D).
  * parameters are cast to ``cfg.compute_dtype`` once, here, instead of on
    every step;
  * the caches are updated in place;
  * ``prefill_steps`` and ``decode_steps`` count the model calls of each
    kind (``steps`` counts engine steps, as in the reference).
"""

from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.precision import torch_dtype
from repro_torch.models import transformer as T
from repro_torch.serve.kv_cache import BlockAllocator, PagedKVCache


@dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (Lp,) int32
    max_new_tokens: int
    generated: list = field(default_factory=list)
    done: bool = False
    truncated: bool = False  # prompt tail-clipped to the engine's max_seq
    preempted: bool = False  # evicted in-flight by run(max_steps=...)
    evictions: int = 0       # times evicted-to-queue under memory pressure
    t_submit: float = 0.0    # perf_counter stamps
    token_times: list = field(default_factory=list)


def _submit(eng, req: Request):
    """Queue ``req`` on engine ``eng``.  Cache positions run 0..max_seq-1:
    an over-long prompt keeps its tail, leaving room for one generated
    token (``truncated=True``); an empty prompt completes at once with an
    empty generation."""
    limit = max(1, eng.max_seq - 1)
    req.t_submit = time.perf_counter()
    if len(req.prompt) == 0:
        req.done = True
        eng.finished.append(req)
        return
    if len(req.prompt) > limit:
        req.prompt = np.asarray(req.prompt[-limit:])
        req.truncated = True
    eng.queue.append(req)


def _tensor(a, device):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


class DecodeEngine:
    """Continuous batching over a dense (B, max_seq) cache: every slot
    carries its own position (ragged (B,) writes), a freed slot is refilled
    from the queue at once (its recurrent state zeroed) and ingests its
    prompt one token per step while the other slots generate.  One decode
    call serves both phases.  An encoder-decoder model's ``memory``
    (batch_slots, S, D) is attended by every step: slot i reads row i,
    whatever request it holds, as in the reference."""

    def __init__(self, params, cfg: ModelConfig, batch_slots: int,
                 max_seq: int, pad_token: int = 0, cache_dtype=None,
                 device="cuda", memory=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = T.cast_compute(_to_device(params, self.device), cfg)
        self.b = batch_slots
        self.max_seq = max_seq
        self.memory = None if memory is None else memory.to(self.device)
        self.pad = pad_token
        self.cache_dtype = torch_dtype(cache_dtype if cache_dtype is not None
                                       else cfg.compute_dtype)
        self.queue: Deque[Request] = deque()
        self.finished: List[Request] = []
        self.steps = 0
        self.cache = T.init_cache(cfg, batch_slots, max_seq,
                                  dtype=self.cache_dtype, device=self.device)
        self.pos = np.zeros(batch_slots, np.int32)  # per-slot write position
        self.slot: List[Optional[Request]] = [None] * batch_slots
        self.phase = ["idle"] * batch_slots  # idle | prompt | decode
        self.prompt_cursor = np.zeros(batch_slots, np.int32)
        self._next_tok = np.zeros(batch_slots, np.int32)
        specs, _ = cfg.superblock()
        # only recurrent mixers need a reset at admission: attention slots
        # are hidden by the causal mask, mamba/xLSTM state carries over
        self._recurrent = [str(i) for i, s in enumerate(specs)
                           if s.mixer != "attn"]

    @torch.no_grad()
    def _decode(self, toks, pos):
        """One decode call; returns the greedy token of every row."""
        dev = self.device
        logits = T.decode_step(self.params, self.cfg, _tensor(toks, dev),
                               _tensor(pos, dev), self.cache,
                               memory=self.memory)
        return logits.argmax(-1).to(torch.int32).cpu().numpy()

    def submit(self, req: Request):
        _submit(self, req)

    def _reset_slot(self, i: int):
        """Zero slot i of the recurrent state leaves (in place).  Attention
        k/v need no reset: every j <= pos is rewritten by the new request
        before it is read."""
        for key in self._recurrent:
            for leaf in self.cache[key].values():
                leaf[:, i].zero_()

    def _admit(self):
        for i in range(self.b):
            if self.phase[i] == "idle" and self.queue:
                req = self.queue.popleft()
                self.slot[i] = req
                self.phase[i] = "prompt"
                self.prompt_cursor[i] = 0
                self.pos[i] = 0
                self._reset_slot(i)
                self._next_tok[i] = req.prompt[0]

    def step(self):
        self._admit()
        if all(p == "idle" for p in self.phase):
            return
        toks = np.where(np.array([p != "idle" for p in self.phase]),
                        self._next_tok, self.pad).astype(np.int32)
        argmax = self._decode(toks, self.pos)
        self.steps += 1
        now = time.perf_counter()
        for i in range(self.b):
            req = self.slot[i]
            if req is None:
                continue
            self.pos[i] += 1
            if self.phase[i] == "prompt":
                self.prompt_cursor[i] += 1
                if self.prompt_cursor[i] < len(req.prompt):
                    self._next_tok[i] = req.prompt[self.prompt_cursor[i]]
                else:  # prompt consumed: this step gave the first token
                    req.generated.append(int(argmax[i]))
                    req.token_times.append(now)
                    self._next_tok[i] = argmax[i]
                    self.phase[i] = "decode"
            else:
                req.generated.append(int(argmax[i]))
                req.token_times.append(now)
                self._next_tok[i] = argmax[i]
            # decode slots finish at max_new_tokens; any slot finishes when
            # the cache is full, so pos never passes max_seq
            if (self.phase[i] == "decode"
                    and len(req.generated) >= req.max_new_tokens) \
                    or self.pos[i] >= self.max_seq:
                req.done = True
                self.finished.append(req)
                self.slot[i] = None
                self.phase[i] = "idle"

    def run(self, max_steps: int = 100_000) -> List[Request]:
        """Serve until the queue and every slot drain, or ``max_steps``
        steps have run; then every in-flight request lands in ``finished``
        with ``preempted=True`` and its partial generation, and its slot is
        freed."""
        while (self.queue or any(p != "idle" for p in self.phase)) \
                and self.steps < max_steps:
            self.step()
        for i in range(self.b):
            req = self.slot[i]
            if req is not None:
                req.preempted = True
                self.finished.append(req)
                self.slot[i] = None
                self.phase[i] = "idle"
        return self.finished


class PagedDecodeEngine:
    """Continuous-batching engine over a PAGED KV cache (DESIGN.md §10).

      * Memory follows live context: a slot owns only the pages its
        sequence has reached; releasing a request is a free-list push.
      * Chunked prefill: prompts are ingested ``chunk_size`` tokens per
        step through one batched call (write-then-attend).
      * Admission is gated on free pages, FIFO with head-of-line blocking.
        On page exhaustion during decode growth the youngest-admitted slot
        is evicted back to the queue front, recompute-style: greedy decode
        is deterministic, so eviction changes latency, never output.

    Attention-only decoder stacks with dense MLPs.
    """

    def __init__(self, params, cfg: ModelConfig, batch_slots: int,
                 max_seq: int, *, page_size: int = 16,
                 num_pages: Optional[int] = None, chunk_size: int = 32,
                 pad_token: int = 0, cache_dtype=None, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = T.cast_compute(_to_device(params, self.device), cfg)
        self.b = batch_slots
        self.max_seq = max_seq
        self.pad = pad_token
        self.page_size = page_size
        self.chunk = chunk_size
        self.cache_dtype = torch_dtype(cache_dtype if cache_dtype is not None
                                       else cfg.compute_dtype)
        self.pages_per_seq = math.ceil(max_seq / page_size)
        if num_pages is None:  # fully provisioned: every slot can hit max_seq
            num_pages = 1 + batch_slots * self.pages_per_seq
        self.kv = PagedKVCache(batch_slots, self.pages_per_seq,
                               BlockAllocator(num_pages, page_size))
        self.cache = T.init_paged_cache(cfg, num_pages, page_size,
                                        dtype=self.cache_dtype,
                                        device=self.device)

        self.queue: Deque[Request] = deque()
        self.finished: List[Request] = []
        self.steps = 0
        self.prefill_steps = 0
        self.decode_steps = 0
        self.slot: List[Optional[Request]] = [None] * batch_slots
        self.phase = ["idle"] * batch_slots  # idle | prefill | decode
        self.pos = np.zeros(batch_slots, np.int32)  # next write position
        self.prompt_cursor = np.zeros(batch_slots, np.int32)
        self._next_tok = np.zeros(batch_slots, np.int32)
        self._admit_seq = np.zeros(batch_slots, np.int64)
        self._admitted = 0

    @torch.no_grad()
    def _decode(self, toks, pos, tables):
        """One decode call; returns the greedy token of every row."""
        dev = self.device
        logits = T.decode_step_paged(
            self.params, self.cfg, _tensor(toks, dev), _tensor(pos, dev),
            self.cache, _tensor(tables, dev))
        return logits.argmax(-1).to(torch.int32).cpu().numpy()

    @torch.no_grad()
    def _prefill(self, toks, poss, tables, last):
        dev = self.device
        logits = T.prefill_chunk_paged(
            self.params, self.cfg, _tensor(toks, dev), _tensor(poss, dev),
            self.cache, _tensor(tables, dev), _tensor(last, dev))
        return logits.argmax(-1).to(torch.int32).cpu().numpy()

    # ------------------------------------------------------------------
    # admission / eviction
    # ------------------------------------------------------------------
    def submit(self, req: Request):
        _submit(self, req)

    def _admit(self):
        """FIFO with head-of-line blocking on free pages: if the queue
        head does not fit, nothing is admitted this step."""
        for i in range(self.b):
            if not self.queue:
                return
            if self.phase[i] != "idle":
                continue
            req = self.queue[0]
            # reserve prompt + first generated token so the prefill →
            # decode transition never needs an immediate grow
            if not self.kv.admit(i, min(len(req.prompt) + 1, self.max_seq)):
                return
            self.queue.popleft()
            self.slot[i] = req
            self.phase[i] = "prefill"
            self.prompt_cursor[i] = 0
            self.pos[i] = 0
            self._admitted += 1
            self._admit_seq[i] = self._admitted

    def _evict(self, i: int):
        """Evict slot i back to the queue front, recompute-style."""
        req = self.slot[i]
        req.generated = []
        req.token_times = []
        req.evictions += 1
        self.kv.release(i)
        self.slot[i] = None
        self.phase[i] = "idle"
        self.queue.appendleft(req)

    def _evict_youngest(self, exclude=None) -> bool:
        cands = [i for i in range(self.b)
                 if self.slot[i] is not None and i != exclude]
        if not cands:
            return False
        self._evict(max(cands, key=lambda i: self._admit_seq[i]))
        return True

    def _finish(self, i: int, *, preempted=False):
        req = self.slot[i]
        req.done = not preempted
        req.preempted = preempted
        self.kv.release(i)
        self.finished.append(req)
        self.slot[i] = None
        self.phase[i] = "idle"

    # ------------------------------------------------------------------
    # stepping
    # ------------------------------------------------------------------
    def step(self):
        self._admit()
        if all(p == "idle" for p in self.phase):
            return
        self.steps += 1
        self._step_prefill()
        self._step_decode()

    def _step_prefill(self):
        rows = [i for i in range(self.b) if self.phase[i] == "prefill"]
        if not rows:
            return
        c = self.chunk
        toks = np.zeros((self.b, c), np.int32)
        poss = np.full((self.b, c), -1, np.int32)
        last = np.zeros((self.b,), np.int32)
        take = {}
        for i in rows:
            req = self.slot[i]
            cur = int(self.prompt_cursor[i])
            n = min(c, len(req.prompt) - cur)
            toks[i, :n] = req.prompt[cur:cur + n]
            poss[i, :n] = np.arange(cur, cur + n, dtype=np.int32)
            last[i] = n - 1
            take[i] = n
        argmax = self._prefill(toks, poss, self.kv.tables, last)
        self.prefill_steps += 1
        now = time.perf_counter()
        for i in rows:
            req = self.slot[i]
            self.prompt_cursor[i] += take[i]
            self.pos[i] += take[i]
            if self.prompt_cursor[i] >= len(req.prompt):
                # this chunk held the last prompt token ⇒ its logits give
                # the first generated token
                req.generated.append(int(argmax[i]))
                req.token_times.append(now)
                self._next_tok[i] = argmax[i]
                self.phase[i] = "decode"
                if len(req.generated) >= req.max_new_tokens \
                        or self.pos[i] >= self.max_seq:
                    self._finish(i)

    def _step_decode(self):
        # grow each decode row to cover this step's write; on exhaustion
        # evict the youngest-admitted slot (possibly this one) to queue
        for i in range(self.b):
            if self.phase[i] != "decode":
                continue
            while not self.kv.ensure(i, int(self.pos[i]) + 1):
                if not self._evict_youngest(exclude=i):
                    self._evict(i)
                    break
        rows = [i for i in range(self.b) if self.phase[i] == "decode"]
        if not rows:
            return
        active = np.array([self.phase[i] == "decode" for i in range(self.b)])
        toks = np.where(active, self._next_tok, self.pad).astype(np.int32)
        pos = np.where(active, self.pos, -1).astype(np.int32)
        argmax = self._decode(toks, pos, self.kv.tables)
        self.decode_steps += 1
        now = time.perf_counter()
        for i in rows:
            req = self.slot[i]
            self.pos[i] += 1
            req.generated.append(int(argmax[i]))
            req.token_times.append(now)
            self._next_tok[i] = argmax[i]
            if len(req.generated) >= req.max_new_tokens \
                    or self.pos[i] >= self.max_seq:
                self._finish(i)

    def run(self, max_steps: int = 100_000) -> List[Request]:
        """Serve until queue + slots drain or ``max_steps``.  Early exit
        drains in-flight requests as ``preempted=True`` and releases their
        pages."""
        while (self.queue or any(p != "idle" for p in self.phase)) \
                and self.steps < max_steps:
            self.step()
        for i in range(self.b):
            if self.slot[i] is not None:
                self._finish(i, preempted=True)
        return self.finished

    def utilization(self) -> float:
        return self.kv.utilization()


@torch.no_grad()
def greedy_generate(params, cfg: ModelConfig, prompt, max_new_tokens: int,
                    device="cuda", memory=None):
    """Single-sequence generation: one prefill over the whole prompt (on
    the card each attention layer one flash-attention launch, each cross
    attention over ``memory`` (1, S, D) one more, each Mamba layer one
    mamba_scan launch), the attention cache grown to prompt +
    ``max_new_tokens``, then greedy decode, each step attending over
    ``memory`` too.  Returns the generated token ids; the first comes from
    the prefill, so at least one is returned, as in the reference."""
    dev = resolve_device(device)
    params = T.cast_compute(_to_device(params, dev), cfg)
    memory = None if memory is None else memory.to(dev)
    prompt = torch.as_tensor(np.asarray(prompt, np.int32), device=dev)[None]
    lp = prompt.shape[1]
    logits, cache = T.prefill(params, cfg, prompt, last_only=True,
                              memory=memory)
    cache = T.pad_prefill_cache(cfg, cache, lp + max_new_tokens)
    tok = logits[:, -1].argmax(-1)
    out = [int(tok[0])]
    for i in range(max_new_tokens - 1):
        logits = T.decode_step(params, cfg, tok, lp + i, cache,
                               memory=memory)
        tok = logits.argmax(-1)
        out.append(int(tok[0]))
    return out


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)
