#!/usr/bin/env python3
"""Drive the PyTorch port's paged serving, dense serving (attention,
recurrent, MoE, encoder-decoder and vision models) and data-parallel
training paths on one CUDA card.

    python3 chip_smoke.py [--mamba-before PATH] [--mamba-bwd-before PATH]

Builds every CUDA kernel from ``src/repro_torch/kernels/csrc`` (into
``build/kernels/``), holds each kernel against its plain PyTorch version,
then drives the main paths through their entry points:

  * paged serving: qwen2-1.5b at full width and depth and gemma3-1b at
    full width through ``repro_torch.serve.engine.PagedDecodeEngine``, and
    the card's greedy tokens against the CPU's on a two-layer cut;
  * dense serving: ``greedy_generate`` (one prefill whose attention is the
    flash kernel, one launch per layer, then dense-cache decode) on
    qwen2-1.5b, gemma3-1b and qwen2.5-14b at full width and depth in bf16;
    ``DecodeEngine`` on qwen2-1.5b; and on two-layer cuts in f32 the
    card's prefill logits and tokens against the CPU's, and
    ``greedy_generate``'s tokens against ``DecodeEngine``'s;
  * the recurrent families on the dense serving path: ``greedy_generate``
    on jamba-1.5-large without experts at full width, cut to 16 layers (2
    attention, 14 Mamba: each Mamba layer's prefill scan one launch of the
    ``mamba_scan`` kernel), and on xlstm-125m whole, bf16; ``DecodeEngine``
    on the jamba cut; and in f32 the card against the CPU on jamba's
    reduced widths (8 layers) and xlstm-125m, with ``DecodeEngine``
    reusing a slot (its recurrent state reset);
  * the leaf-wise error-feedback codec: ``ef_compress_tree`` and
    ``dgc_compress_tree`` with 1-bit and top-k on qwen2-1.5b's stacked
    gradient tree at full width (4 layers, W = 4, 14 leaves), each leaf's
    round one launch of ``onebit_quant`` or ``topk_sparsify``;
  * training: the trainer CLI's body (``repro_torch.launch.train.train``)
    on qwen2-1.5b at full width, cut to 4 layers, W = 4 replicas,
    ``--fused-adam``, under ``sync`` with ``--compressor onebit`` and
    ``topk`` and under the rest of the spectrum: ``local_sgd``, ``easgd``,
    ``gossip``, ``downpour --compressor onebit``, ``sync_dgc --compressor
    topk`` and ``ssp`` (cut to 2 layers: its ring holds 4 gradients);
    the rest of the replica trainer: ``--precision bf16`` with 1-bit and
    ``--accum-steps 2``, ``--precision bf16-pure --accum-steps 2`` (fused
    Adam on bf16 params) and top-k at ``--accum-steps 4``, each encode
    once a boundary; one step of each under ``torch.profiler``; a boundary
    forced to overflow (``skip_step``: nothing written, nothing launched,
    the scale halved); ``--prefetch-depth`` 1 against 2; one replica's
    gradient with and without remat at 8 x 2048 tokens; and the card's
    losses and replica divergence against the CPU's on a two-layer, W = 2
    cut under ``sync`` (1-bit; and at ``--accum-steps 2``, f32 and bf16
    with a skipped boundary), ``downpour`` (1-bit) and ``ssp``;
  * ZeRO and checkpoints on that trainer: ``sync_zero1``, ``sync_zero2``
    (``--accum-steps 2``), ``sync_zero3`` and ``sync_zero1`` under
    ``--precision bf16 --accum-steps 2`` on the same cut, ``fused_adam``
    once a shard bucket; every leaf of ZeRO-1/2/3's params, m and v
    ``torch.equal`` to ``sync``'s after 3 steps, with each one's peak
    memory, and ZeRO-2 at ``--accum-steps 2`` against ``sync`` at 2: SGD
    params within 2e-6, Adam's gradients within the two sums' rounding
    bound and its params within Adam's predicted response to them, with a
    doubled-microbatch control that must fail (``zero_vs_sync``); a forced
    overflow under ``sync_zero1`` (``skip_step_zero1``); and on
    ``qwen2-1.5b --reduced`` a resume from a checkpoint bitwise an
    uninterrupted run (ZeRO-1 bf16, ZeRO-3), a re-shard from W = 4 to
    W = 2 and ``--ckpt-dir``/``--resume auto`` through the CLI
    (``ckpt_resume``);
  * the elastic fleet (``repro_torch.launch.elastic``): ZeRO-1 and ZeRO-3
    states on the training cut resized W 4 → 2 → 4 in memory, each shard
    leaf against the checkpoint restore's numpy re-shard on host copies,
    with 2 steps at W = 2 (``fused_adam`` on ``(2, chunk')`` buckets) and
    on ``--reduced`` a disk round trip bitwise the live resize
    (``elastic_resize``); ``ElasticFleet`` on the training cut for 24
    boundaries of ``edge_async_sim``'s schedule (straggler demotion, a
    flake, a kill, a restore, a rejoin), its log against a CPU run's
    (``elastic_fleet``); the fleet with an all-ones mask bitwise the
    trainer's ``sync`` step (``elastic_vs_sync``); and the schedule on
    the card against the CPU on a reduced cut (``elastic_card_vs_cpu``);
  * the MoE families: ``greedy_generate`` on granite-moe-1b-a400m and
    qwen2-moe-a2.7b at full width cut to ``GRANITE_MOE_LAYERS`` and
    ``QWEN2_MOE_LAYERS`` of their 24 layers, in bf16 (one flash launch a
    layer a prefill; a decode step profiled with its device time split
    into router and sort, dispatch scatter, expert matmuls, combine
    gather, shared experts and the rest, beside the floor of reading
    every weight once), ``PagedDecodeEngine`` on qwen2-moe-a2.7b's
    parameters and, on the same weights in f32, its tokens against
    ``DecodeEngine``'s; the trainer on granite-moe-1b-a400m at full width,
    4 layers, W = 4 (``train_moe``: 1-bit, fused Adam, the share of rows
    capacity dropped in step 0); and in f32 the card against the CPU on
    2-layer cuts of both and on jamba ``.reduced()`` with its experts:
    logits, each MoE layer's routing, tokens (``moe_card_vs_cpu``);
  * the encoder-decoder and vision families at full width and depth in
    bf16: seamless-m4t-medium's ``encode`` (one non-causal flash launch an
    encoder layer over 3072 frames) and ``greedy_generate(memory=...)``
    (each cross attention one flash launch, Lq != Lk), a decode step's
    device time split into the memory's k/v projection, cross attention,
    self attention, MLP, head and the rest (``greedy_seamless``), and
    ``DecodeEngine`` with 8 slots over 8 memory rows
    (``dense_serve_seamless``); pixtral-12b's prefill from 1024 patch
    embeddings and 256 text tokens' rows, then greedy decode beside the
    floor of reading every weight once (``greedy_pixtral``); and in f32
    the card against the CPU on a seamless cut (d_model 256, 2 + 2 layers,
    300 frames) and pixtral ``.reduced()``: ``encode``, logits, tokens, a
    4-slot ``DecodeEngine`` against ``greedy_generate`` row by row, the
    loss and every leaf's gradient (``encdec_card_vs_cpu``);
  * training the recurrent families: the trainer's body on
    jamba-1.5-large without experts at full width, cut to one super-block
    (8 layers, 8.9 B parameters: 1 attention, 7 Mamba), bf16-pure, SGD,
    W = 1, 1 x 2048 tokens (``train_jamba``: each Mamba layer one launch
    of ``mamba_scan`` and one of the backward kernel ``mamba_scan_bwd`` a
    step), and on xlstm-125m whole in f32 under ``sync --compressor
    onebit --fused-adam`` at W = 2 (``train_xlstm``: the sLSTM loop's
    host share); and in f32 the card against the CPU on jamba
    ``.reduced()`` with and without its experts and a 4-layer xlstm-125m
    cut: the loss, every leaf's gradient, 3 train steps, and remat's
    gradients bitwise (``recurrent_train_card_vs_cpu``);
  * data-parallel training across processes
    (``repro_torch.train.loop.make_sharded_train_step`` over
    ``repro_torch.core.comm.ShardComm``): the stacked ``LocalComm`` runs
    first in this process, keeping only each leaf's sha256; then ONE
    pool of 4 rank processes sharing the card over gloo (NCCL refuses
    two ranks on one card; ``ShardComm`` stages CUDA tensors through
    host memory): every comm primitive at 4 and 2 ranks bitwise
    ``LocalComm``'s on the card, and a 4 MiB bucket's ms and GB/s
    (``shard_comm``); on ranks 0 and 1, qwen2-1.5b at full width, 2
    layers, 2 steps of sync, accumulation, 1-bit, top-k, ZeRO-1, ZeRO-2,
    ZeRO-3 and ZeRO-1 under bf16, each rank's final state bitwise its
    stacked replica's, the kernels' launches in the ranks, the wire a
    step the closed form (``train_sharded``), and ``local_sgd``,
    ``gossip`` and ``downpour`` 1-bit on 2 layers
    (``sharded_strategies``); then one sync step over NCCL at world size
    1 against the replica step (``nccl_world1``);
  * the "model" mesh axis on the same pool of 4 ranks as data 2 x model
    2: tensor parallelism on qwen2-1.5b at full width, 4 layers, 2 steps
    under fused Adam with the 1-bit pod compressor and under ZeRO-1,
    each rank's unsplit params against the one-process replica step at
    tp_degree 2, W = 2 (``train_tp``); expert parallelism on
    granite-moe-1b-a400m at full width, 4 layers, 4096 tokens a data
    rank: step 0's loss and MoE gradients at capacity factor 8 against
    the one-device dispatch, then 2 steps at the config's, with the
    drop share and the all-to-all bytes a layer (``train_ep``);
  * the same pool for the rest of the model axis, each phase held to a
    one-process reference run first in this process: jamba-1.5-large
    without experts at full width cut to one attention and one Mamba
    layer (Mamba's d_in in 2 blocks: the scan and its backward at (1,
    2048, 8192) on each rank, held against their plain versions there and
    timed; ``train_tp_jamba``) beside xlstm-125m at full width cut to one
    mLSTM and one sLSTM layer (``train_tp_xlstm``), then
    seamless-m4t-medium at full width cut to 4 + 4 layers
    (``train_tp_seamless``), each on data 1 x model 2: step 0's loss
    bitwise the one-process blocked form's and its gradients within
    ``AXIS_GRAD_RTOL`` of each leaf's largest or ``AXIS_FLOOR_MULT`` times
    its blocked-vs-single distance, then a step (SGD; Adam on xlstm), the
    replicated leaves equal on both model ranks; ``local_sgd`` and
    ``downpour`` 1-bit on data 2 x model 2 (``train_tp_strategies``, 2
    steps against the replica step at tp_degree 2 with the same
    strategy); ``sharding_mode="cp"`` on qwen2-1.5b, 4 layers, 1 x 2048
    tokens a data rank, 1024 a model rank: step 0's loss and all-summed
    gradients against the unsharded ones, then a fused-Adam step with
    the k/v all-gather's bytes (``train_cp``); the same under ``cp`` for
    granite-moe-1b-a400m at full width, 4 layers, 1 x 2048 tokens a data
    rank (4096 global: ``_moe_ep`` on every rank, step 0 at capacity
    factor 8 without the aux term, then the step at the config's, with
    each rank's drop share; ``train_cp_moe``) and for seamless-m4t-medium
    at ``train_tp_seamless``'s cut, its encoder on the source's chunk and
    the memory all-gathered once a step (``train_cp_seamless``, the
    cancelling leaves held to 10 times a second ordering of the
    unsharded step), each with its all-gathers a step against the closed
    form.  Every one of these lines
    carries a rank's peak GB, host step ms and last step's device ms,
    the model group's bytes to gloo a step and the kernels' launches.

Each kernel's launches are counted from zero over the paths that run it,
and each is timed against its bound, its plain version and one PyTorch
call (``fused_adam`` also on one ZeRO shard bucket of the training path:
the embedding bucket's 4 x 58.3 M elements).  The paged kernel is
checked at the edges of its split-K parts and
timed at the qwen2-1.5b and gemma3-1b decode shapes; the top-k kernels
are checked bitwise on rows that drive both paths of their selection
(ties, NaN and +-inf, +-0.0, 32 and 33 candidates), and their general
path is timed at the timing size; the build line counts the tensor-core
instructions in each library's SASS (the bf16 flash kernel runs on
wgmma: HGMMA).  The scan kernel's h_last is held bitwise against its
plain version, its library must build without spills (its backward's
too, at every N), and ``time_mamba`` reports the SASS
of its loop (instructions a state-step, MUFU.EX2); ``--mamba-before
PATH`` builds an earlier design's
``mamba_scan.cu`` beside it and times both in the same run
(``ms_before``).  The scan's backward kernel, which replaces no TPU
kernel (the reference differentiates its jnp chunked scan), is held
against its plain version on the same shapes in f32 and bf16, each output
within a share of its largest value and bitwise across two calls
(``kernel_check_mamba_bwd``), and timed at jamba's scan
(``time_mamba_bwd``: the SASS of its two loops, instructions and
MUFU.EX2 a state-step; ``--mamba-bwd-before PATH`` builds an earlier
``mamba_scan_bwd.cu`` and times both in turns, ``ms_before``).  The CPU
side of every card-vs-CPU phase (``CPU_HALVES``: each phase's ``*_side``
function on "cpu", and the train cases of ``train_card_vs_cpu`` and
``strategies_card_vs_cpu``, which run after the sharded phases) runs
from the build on in a spawned worker at the lowest priority, beside
the card's phases, which read each side as they need it; each line of a
phase it ran beside carries ``cpu_worker``, since its host-timed numbers
shared the host's cores.

The lint tier (``repro_torch.analysis``) runs its smoke slice on the
card after the sharded phases (``lint``): 80 cells, the exchange and
tensor-parallel rigs in one pool of 4 gloo ranks on the card, every
``sync_dgc`` cell's fused top-k encode launched once a bucket, no kernel
library built after a loop rig's step 0, and two deliberately broken
rigs that must fail their rules.  Each line of output is a JSON object, except the raw
``nvidia-smi --query-gpu=name,power.limit`` line just before the last;
every JSON line but the last carries ``phase_s``, the wall seconds since
the line before it; the last line is ``{"ok": true, "device": {...}}``.  Any failed phase
raises and the script exits non-zero without that line.  It needs one
card and exits non-zero when ``torch.cuda.is_available()`` is false.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import gc
import io
import json
import math
import multiprocessing
import os
import queue
import re
import shutil
import statistics
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory, NVIDIA data sheet
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores, data sheet
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


_LAST_LINE = [time.perf_counter()]
# the ``cpu_half`` worker while it runs, and whether it was alive at the
# previous line
_CPU_WORKER = {"proc": None, "alive": False}


def emit(obj, phase_s=True):
    """Print ``obj`` as one JSON line; with ``phase_s``, add the wall
    seconds since the previous line (the phase that emits it), and, where
    the ``cpu_half`` worker ran during that phase, ``cpu_worker``:
    "started", "alive" (the whole phase) or "ended".  Host-timed numbers
    of such a line were taken beside the worker's threads."""
    now = time.perf_counter()
    if phase_s:
        obj = {**obj, "phase_s": now - _LAST_LINE[0]}
        proc, was = _CPU_WORKER["proc"], _CPU_WORKER["alive"]
        alive = proc is not None and proc.is_alive()
        if was or alive:
            obj["cpu_worker"] = ("alive" if was and alive else
                                 "ended" if was else "started")
        _CPU_WORKER["alive"] = alive
    _LAST_LINE[0] = now
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def library_sass(lib, nvcc):
    """The SASS of a built library, from the ``cuobjdump`` beside
    ``nvcc``; None where the toolkit has none."""
    tool = Path(nvcc).with_name("cuobjdump")
    if not tool.is_file():
        return None
    return subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout


def tensor_core_instructions(lib, nvcc):
    """Counts of HGMMA (wgmma) and HMMA (mma.sync) in the SASS of a built
    library; "not available" where the toolkit has no ``cuobjdump``."""
    sass = library_sass(lib, nvcc)
    if sass is None:
        return "not available"
    return {op: len(re.findall(rf"\b{op}\b", sass))
            for op in ("HGMMA", "HMMA")}


def cuda_ms(fn, iters, flush=None):
    """Median device time of ``fn`` over ``iters`` calls after warm-up,
    one pair of CUDA events around each call; ``flush`` (untimed) runs
    before each call to evict the L2 cache.  A spin kernel of ~0.2 ms
    keeps the card busy before the start event while the host enqueues
    ``fn``, so the host's time in a wrapper is not counted as the
    kernel's."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush()
        torch.cuda._sleep(400_000)  # clock cycles: ~0.2 ms at 1.98 GHz
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def l2_flush():
    """A call that evicts the 50 MB L2 cache (zeroes a 256 MB buffer), for
    ``cuda_ms``: each timed call then starts cold."""
    buf = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    return buf.zero_


# ---------------------------------------------------------------------------
# kernel inputs
# ---------------------------------------------------------------------------
def paged_inputs(rng, b, kv, g, dh, page, ctx, q_dtype, kv_dtype, idle_row):
    """Pages, scrambled block tables and ragged ``ctx`` (numpy, seeded) as
    CUDA tensors.  With ``idle_row`` row 0 is an idle slot: ctx 1 over an
    all-trash table row."""
    mb = -(-int(max(ctx)) // page)
    n_pages = 1 + b * mb
    q = rng.standard_normal((b, kv, g, dh), dtype=np.float32)
    kp = rng.standard_normal((n_pages, page, kv, dh), dtype=np.float32)
    vp = rng.standard_normal((n_pages, page, kv, dh), dtype=np.float32)
    bt = rng.permutation(np.arange(1, n_pages)).reshape(b, mb).astype(np.int32)
    ctx = np.asarray(ctx, np.int32)
    if idle_row:
        bt[0] = 0
        ctx[0] = 1

    def dev(a, dt):
        return torch.from_numpy(a).to("cuda").to(dt).contiguous()

    return (dev(q, q_dtype), dev(kp, kv_dtype), dev(vp, kv_dtype),
            dev(bt, torch.int32), dev(ctx, torch.int32))


# ctx values at the edges of the split-K parts, +- 1, with 0 (a row with
# no live token) and 1: a 2048-token reach gives qwen2-1.5b's 8 x 2 rows 17
# parts (32 tokens each up to ctx 544, 64 from 545) and gemma3-1b's 4 x 1
# rows 64 parts of 32 tokens
SPLIT_EDGES = {"qwen2-1.5b": (17, [0, 1, 543, 544, 545, 1087, 1088, 2048]),
               "gemma3-1b": (64, [0, 31, 33, 2048])}

# the MoE models' paged decode at 8 slots: qwen2-moe-a2.7b MHA (G 1),
# granite-moe-1b-a400m GQA 16 over 8 (G 2); ragged ctx with an idle row
MOE_PAGED_SHAPES = {
    "qwen2-moe-a2.7b": dict(b=8, kv=16, g=1, dh=128, page=16),
    "granite-moe-1b-a400m": dict(b=8, kv=8, g=2, dh=64, page=16)}


def check_kernel(pa):
    """Phase 2: the CUDA kernel against its plain version on the card:
    ragged ctx with an idle row (ctx 1 over a trash page), then ctx at the
    split-K parts' edges (SPLIT_EDGES), windows 7, 100 and 512 crossing
    them."""
    shapes = {"qwen2-1.5b": dict(b=8, kv=2, g=6, dh=128, page=16),
              "gemma3-1b": dict(b=4, kv=1, g=4, dh=256, page=16),
              **MOE_PAGED_SHAPES}
    dts = (torch.float32, torch.bfloat16)
    err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    cases = 0
    runs = []
    for si, (arch, s) in enumerate(shapes.items()):
        rng = np.random.default_rng(si)
        ctx = rng.integers(1, 2049, size=s["b"])
        ctx[-1] = 2048
        runs.append((arch, s, ctx, True, (-1, 7, 512)))
        if arch in SPLIT_EDGES:
            splits, edges = SPLIT_EDGES[arch]
            runs.append((arch, s, np.asarray(edges), False,
                         (-1, 7, 100, 512)))
    for ri, (arch, s, ctx, idle_row, windows) in enumerate(runs):
        # the MoE decode shapes as their engines run them: bf16
        run_dts = (torch.bfloat16,) if arch in MOE_PAGED_SHAPES else dts
        for qd in run_dts:
            for kd in run_dts:
                inp = paged_inputs(np.random.default_rng(100 + ri), s["b"],
                                   s["kv"], s["g"], s["dh"], s["page"], ctx,
                                   qd, kd, idle_row=idle_row)
                if not idle_row and pa.split_plan(inp[0], inp[1], inp[3]) \
                        != SPLIT_EDGES[arch][0]:
                    raise AssertionError(f"{arch}: split_plan is not "
                                         f"{SPLIT_EDGES[arch][0]}")
                for window in windows:
                    for softcap in (None, 30.0):
                        out = pa.paged_attention(*inp, window=window,
                                                 softcap=softcap)
                        ref = pa.paged_attention_plain(*inp, window=window,
                                                       softcap=softcap)
                        torch.cuda.synchronize()
                        if out.dtype != qd or out.shape != ref.shape:
                            raise AssertionError(
                                f"kernel output {out.dtype}{tuple(out.shape)}"
                                f" vs {qd}{tuple(ref.shape)}")
                        e = (out.float() - ref.float()).abs().max().item()
                        if not e <= TOL[qd]:
                            raise AssertionError(
                                f"paged_attention {arch} ctx={list(ctx)} "
                                f"q={qd} pages={kd} window={window} "
                                f"softcap={softcap}: max abs err {e} > "
                                f"{TOL[qd]}")
                        err[qd] = max(err[qd], e)
                        cases += 1
    return {"cases": cases, "split_edges": {
                arch: {"splits": n, "ctx": c}
                for arch, (n, c) in SPLIT_EDGES.items()},
            "moe_shapes_bf16": MOE_PAGED_SHAPES,
            "max_abs_err_f32": err[torch.float32],
            "tol_f32": TOL[torch.float32],
            "max_abs_err_bf16": err[torch.bfloat16],
            "tol_bf16": TOL[torch.bfloat16]}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def requests(Request, rng, n, prompt_lo, prompt_hi, new_lo, new_hi, vocab):
    lens = rng.integers(prompt_lo, prompt_hi + 1, size=n)
    news = rng.integers(new_lo, new_hi + 1, size=n)
    return [Request(rid=i, prompt=rng.integers(0, vocab, size=int(lp))
                    .astype(np.int32), max_new_tokens=int(mn))
            for i, (lp, mn) in enumerate(zip(lens, news))]


def timed_engine(eng):
    """Wrap the engine's two model calls with synchronised host timers."""
    rec = {"prefill": [], "decode": []}

    def wrap(kind, fn, tok_arg):
        def run(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            rec[kind].append((time.perf_counter() - t,
                              int((args[tok_arg] >= 0).sum())))
            return out
        return run

    eng._prefill = wrap("prefill", eng._prefill, 1)  # positions ≥ 0
    eng._decode = wrap("decode", eng._decode, 1)
    return rec


def serve(pa, T, Engine, Request, cfg, smi, *, slots, max_seq, reqs, seed,
          after=None, params=None):
    """``Engine`` (the paged one) on ``reqs``; ``params`` made from ``seed``
    unless given."""
    if params is None:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        params = T.init_model(gen, cfg, device="cuda")
    eng = Engine(params, cfg, batch_slots=slots, max_seq=max_seq,
                 page_size=16, chunk_size=256, cache_dtype=cfg.compute_dtype,
                 device="cuda")
    del params
    rec = timed_engine(eng)
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pa.paged_attention.launches = 0
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pa.paged_attention.launches

    if len(done) != len(reqs):
        raise AssertionError(f"{len(done)} of {len(reqs)} requests finished")
    for r in done:
        if not r.done or r.preempted:
            raise AssertionError(f"request {r.rid} not done")
        if len(r.generated) != r.max_new_tokens:
            raise AssertionError(f"request {r.rid}: {len(r.generated)} of "
                                 f"{r.max_new_tokens} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r.generated):
            raise AssertionError(f"request {r.rid}: token outside the vocab")
    eng.kv.allocator.check()
    if eng.kv.allocator.num_allocated:
        raise AssertionError("page pool did not drain")
    if launches == 0 or launches != eng.decode_steps * cfg.num_layers:
        raise AssertionError(f"paged_attention launches {launches} != "
                             f"{eng.decode_steps} decode steps x "
                             f"{cfg.num_layers} layers")
    pf_s = sum(t for t, _ in rec["prefill"])
    dc_s = sum(t for t, _ in rec["decode"])
    out = {
        "phase": "serve", "arch": cfg.name, "layers": cfg.num_layers,
        "d_model": cfg.d_model, "dtype": cfg.compute_dtype,
        "slots": slots, "max_seq": max_seq, "requests": len(reqs),
        "prompt_tokens": sum(len(r.prompt) for r in reqs),
        "generated_tokens": sum(len(r.generated) for r in done),
        "prefill_steps": eng.prefill_steps, "decode_steps": eng.decode_steps,
        "paged_attention_launches": launches,
        "prefill_tok_per_s": sum(n for _, n in rec["prefill"]) / pf_s,
        "decode_tok_per_s": sum(n for _, n in rec["decode"]) / dc_s,
        "decode_step_ms_median":
            1e3 * statistics.median(t for t, _ in rec["decode"]),
        "wall_s": wall,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "card": smi,
    }
    if after is not None:
        out.update(after(eng))
    del eng
    torch.cuda.empty_cache()
    return out


def profile_decode(eng, ctx=1024, steps=5):
    """Where a decode step's time goes: ``steps`` decode calls with every
    slot at position ``ctx`` (the drained pool's pages, garbage contents,
    the same work), timed plain and then under torch.profiler."""
    b = eng.b
    tables = (1 + np.arange(b * eng.pages_per_seq, dtype=np.int32)) \
        .reshape(b, eng.pages_per_seq)
    toks = np.zeros(b, np.int32)
    pos = np.full(b, ctx, np.int32)
    decode = eng.__class__._decode.__get__(eng)  # untimed original

    def run():
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(steps):
            decode(toks, pos, tables)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / steps

    run()
    step_s = run()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        prof_step_s = run()
    # device-side kernel events only: a CPU op also carries the device time
    # of the kernels it launched, which would count them twice
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3 / steps
    paged = [e for e in events if "paged_attention" in e.key]
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:6]
    return {"profile": {
        "ctx": ctx, "slots": b, "step_ms": 1e3 * step_s,
        "step_ms_under_profiler": 1e3 * prof_step_s,
        "device_ms_per_step": dev_ms,
        "device_busy_share": dev_ms / (1e3 * step_s) if dev_ms else None,
        "device_kernels_per_step": sum(e.count for e in events) / steps,
        # both passes of the paged kernel (split and combine)
        "paged_attention_ms_per_step": sum(
            e.self_device_time_total for e in paged) / 1e3 / steps,
        "paged_attention_kernels_per_step": sum(
            e.count for e in paged) / steps,
        "top_device_ms_per_step": {
            e.key[:60]: e.self_device_time_total / 1e3 / steps for e in top},
    }}


def paged_side(get_config, dev):
    """``card_vs_cpu``'s runs on ``dev``: qwen2-1.5b cut to 2 layers, the
    first decode step's logits after one prefill chunk (on the host) and
    ``PagedDecodeEngine``'s greedy tokens."""
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import PagedDecodeEngine, Request

    cfg = dataclasses.replace(get_config("qwen2-1.5b"), num_layers=2)
    gen = torch.Generator(device="cpu").manual_seed(5)
    params = T.init_model(gen, cfg, device="cpu")

    # first decode step's logits, model level: one prefill chunk, one step
    rng = np.random.default_rng(5)
    b, page, mb = 4, 16, 8
    lens = rng.integers(16, 64, size=b)
    toks = np.zeros((b, 64), np.int32)
    poss = np.full((b, 64), -1, np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, size=n)
        poss[i, :n] = np.arange(n)
    bt = (1 + np.arange(b * mb, dtype=np.int32)).reshape(b, mb)
    nxt = rng.integers(0, cfg.vocab_size, size=b).astype(np.int32)

    def p(t):
        return t.to(dev)

    prm = _tree(params, p)
    cache = T.init_paged_cache(cfg, 1 + b * mb, page, device=dev)
    with torch.no_grad():
        T.prefill_chunk_paged(
            prm, cfg, p(torch.from_numpy(toks)), p(torch.from_numpy(poss)),
            cache, p(torch.from_numpy(bt)),
            p(torch.from_numpy((lens - 1).astype(np.int32))))
        logits = T.decode_step_paged(
            prm, cfg, p(torch.from_numpy(nxt)),
            p(torch.from_numpy(lens.astype(np.int32))), cache,
            p(torch.from_numpy(bt))).cpu()
    del prm, cache
    eng = PagedDecodeEngine(params, cfg, batch_slots=4, max_seq=256,
                            page_size=16, chunk_size=64, device=dev)
    for r in requests(Request, np.random.default_rng(6), 4, 16, 96, 8, 16,
                      cfg.vocab_size):
        eng.submit(r)
    gens = {r.rid: r.generated for r in eng.run()}
    return {"arch": cfg.name, "logits": logits, "gens": gens}


def card_vs_cpu(get_config, cpu):
    """Phase 5: the same weights and requests on the card and on the CPU
    (``cpu``: ``paged_side``'s CPU run, from the ``cpu_half`` worker)."""
    card = paged_side(get_config, "cuda")
    logit_err = (card["logits"] - cpu["logits"]).abs().max().item()
    if not logit_err <= 1e-3:
        raise AssertionError(f"card vs CPU first-step logits differ by "
                             f"{logit_err} > 1e-3")
    if card["gens"] != cpu["gens"]:
        raise AssertionError(f"card vs CPU greedy tokens differ: "
                             f"{card['gens']} vs {cpu['gens']}")
    torch.cuda.empty_cache()
    return {"phase": "card_vs_cpu", "arch": card["arch"], "layers": 2,
            "dtype": "float32", "first_step_logits_max_abs_err": logit_err,
            "tol": 1e-3, "tokens_identical": True,
            "tokens": sum(len(g) for g in card["gens"].values())}


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(tree)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------
def profiled_ms(fn, iters, flush, match):
    """Device time a call of the kernels ``fn`` launches whose names hold
    ``match``, from torch.profiler (``flush`` runs before each call):
    {kernel name: ms a call}.  Unlike events around a call, it leaves out
    the host's time and the gaps between kernels.  Each kernel's time is
    averaged over the launches the trace recorded: late in a long
    process a trace can drop kernel records (seen on the H100 as one
    turn of ``time_mamba`` reading half and a tenth of the other's
    time while CUDA events agreed), and a total divided by ``iters``
    would read the dropped ones as zero.  A trace that holds no such
    kernel is taken once more; if that one holds none either, the
    result is empty: not measured."""
    def run():
        for _ in range(iters):
            flush()
            fn()
        torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(2):
        with torch.profiler.profile(activities=acts) as prof:
            run()
        found = {e.key: e.self_device_time_total / 1e3 / e.count
                 for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and match in e.key and e.count}
        if found:
            break
    return found


# the decode shapes timed: (name, B, KV, G, Dh, ctx, window); qwen2-1.5b's
# is the serving phase's, gemma3-1b's its global and local (window 512)
# layers at 4 slots
PAGED_TIMING = [("qwen2-1.5b", 8, 2, 6, 128, 1024, -1),
                ("gemma3-1b", 4, 1, 4, 256, 1024, -1),
                ("gemma3-1b local", 4, 1, 4, 256, 1024, 512),
                ("qwen2-moe-a2.7b", 8, 16, 1, 128, 1024, -1),
                ("granite-moe-1b-a400m", 8, 8, 2, 64, 1024, -1)]


def time_kernel(pa, launches_per_step, smi):
    """Kernel, plain version and F.scaled_dot_product_attention at the
    decode shapes of PAGED_TIMING, bf16, page 16, every slot at ctx; the
    kernel's output held against the plain version's.  ``kernel_ms`` is
    CUDA events around a call (the gap between the two passes included),
    ``device_ms`` the profiler's sum of the call's two kernels.  The
    qwen2-1.5b shape's numbers are also the phase's top-level keys."""
    page = 16
    flush = l2_flush()

    sdpa = torch.nn.functional.scaled_dot_product_attention
    saved = pa.paged_attention.launches
    shapes = {}
    for name, b, kv, g, dh, ctx, w in PAGED_TIMING:
        q, kp, vp, bt, cl = paged_inputs(
            np.random.default_rng(7), b, kv, g, dh, page, [ctx] * b,
            torch.bfloat16, torch.bfloat16, idle_row=False)
        call = lambda: pa.paged_attention(q, kp, vp, bt, cl, window=w)  # noqa: E731
        kernel_ms = cuda_ms(call, 50, flush)
        by_kernel = profiled_ms(call, 20, flush, "paged_attention")
        plain_ms = cuda_ms(lambda: pa.paged_attention_plain(
            q, kp, vp, bt, cl, window=w), 20, flush)
        out = call()
        ref = pa.paged_attention_plain(q, kp, vp, bt, cl, window=w)
        err = (out.float() - ref.float()).abs().max().item()
        if not err <= TOL[torch.bfloat16]:
            raise AssertionError(f"paged_attention {name} (kernel_timing): "
                                 f"max abs err {err}")

        # one library call on the pre-gathered dense view (gather excluded)
        ks = kp[bt.long()].reshape(b, ctx, kv, dh).transpose(1, 2) \
            .contiguous()
        vs = vp[bt.long()].reshape(b, ctx, kv, dh).transpose(1, 2) \
            .contiguous()
        qh = q.reshape(b, kv * g, 1, dh)
        j = torch.arange(ctx, device="cuda")[None, :]
        pos = (cl.long() - 1)[:, None]
        mask = (j <= pos) & ((pos - j < w) if w > 0 else True)
        mask = mask[:, None, None, :]
        library_ms = cuda_ms(
            lambda: sdpa(qh, ks, vs, attn_mask=mask, enable_gqa=True), 50,
            flush)
        lib_out = sdpa(qh, ks, vs, attn_mask=mask, enable_gqa=True)
        lib_err = (lib_out.reshape(b, kv, g, dh).float() - ref.float()
                   ).abs().max().item()

        live = b * (min(ctx, w) if w > 0 else ctx)
        nbytes = (live * kv * dh * 2 * kp.element_size()    # k and v, once
                  + 2 * q.numel() * q.element_size()         # q in, out
                  + bt.numel() * 4 + cl.numel() * 4)
        shapes[name] = {
            "shape": {"B": b, "KV": kv, "G": g, "Dh": dh, "page": page,
                      "ctx": ctx, "window": w, "dtype": "bfloat16",
                      "splits": pa.split_plan(q, kp, bt)},
            "kernel_ms": kernel_ms,
            "device_ms": sum(by_kernel.values()) if by_kernel else None,
            "device_ms_by_kernel": {k[:60]: v for k, v in by_kernel.items()},
            "plain_ms": plain_ms, "max_abs_err_vs_plain": err,
            "library_ms": library_ms,
            "library_max_abs_err_vs_plain": lib_err,
            "bytes": nbytes, "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
            "bound_by": "bytes"}
        del q, kp, vp, bt, cl, ks, vs, lib_out
    pa.paged_attention.launches = saved  # timing launches are not the path's
    del flush
    torch.cuda.empty_cache()
    return {
        "phase": "kernel_timing", "name": "paged_attention",
        **{k: shapes["qwen2-1.5b"][k] for k in (
            "shape", "kernel_ms", "device_ms", "plain_ms", "library_ms",
            "library_max_abs_err_vs_plain", "bytes", "bound_ms",
            "bound_by")},
        "shapes": shapes,
        "library_note": "F.scaled_dot_product_attention on the pre-gathered "
                        "dense view (a window mask for gemma3-1b local), "
                        "gather excluded; never called by the port",
        "launches_per_decode_step": launches_per_step,
        "card": smi,
    }


# ---------------------------------------------------------------------------
# dense serving: the flash kernel, greedy_generate and DecodeEngine
# ---------------------------------------------------------------------------
BF16_OPS_PER_S = 989e12  # H100 SXM bf16 dense tensor-core peak, data sheet


def flash_inputs(rng, b, h, kv, l, d, dtype, model_layout, lk=None):
    """q (B, H, L, D) and k, v (B, KV, Lk, D) on the card, seeded numpy;
    Lk = L unless ``lk`` is given (cross attention).  With
    ``model_layout`` they are (B, L, H, D) tensors transposed, the strided
    views the prefill passes; else contiguous."""
    def dev(heads, n):
        a = rng.standard_normal((b, n, heads, d), dtype=np.float32)
        t = torch.from_numpy(a).to("cuda").to(dtype).transpose(1, 2)
        return t if model_layout else t.contiguous()
    lk = l if lk is None else lk
    return dev(h, l), dev(kv, lk), dev(kv, lk)


FLASH_VARIANTS = [  # (causal, window, H / KV)
    (True, -1, 1), (True, 32, 4), (False, -1, 5), (True, 100, 6),
    (True, 512, 4), (False, 100, 1)]

# the launches of the greedy_* phases' prefills: (name, H, KV, L, Dh,
# window), B 1, causal, the model's (B, L, H, Dh) tensors transposed
FLASH_PATH_SHAPES = [
    ("qwen2-1.5b", 12, 2, 2048, 128, -1),
    ("gemma3-1b local", 4, 1, 2048, 256, 512),
    ("gemma3-1b global", 4, 1, 2048, 256, -1),
    ("qwen2.5-14b", 40, 8, 1024, 128, -1),
    ("jamba-1.5-large", 64, 8, 2048, 128, -1),
    ("granite-moe-1b-a400m", 16, 8, 2048, 64, -1),
    ("qwen2-moe-a2.7b", 16, 16, 1024, 128, -1)]

# the MoE head layouts at L 2048 as well (qwen2-moe's prefill is 1024)
FLASH_MOE_CHECKS = [("granite-moe-1b-a400m", 16, 8, 2048, 64, -1),
                    ("qwen2-moe-a2.7b", 16, 16, 2048, 128, -1)]

# the encoder-decoder and vision paths: (name, B, H, KV, Lq, Lk, Dh,
# causal), no window, the model's (B, L, H, Dh) tensors transposed:
# seamless-m4t-medium's encoder layers and cross attention (a prefill's
# Lq 256, a decode step's Lq 1 at B 1 and at the engine's 8 slots, and a
# tail q tile of 37 rows), a GQA cross case with a ragged Lk, and
# pixtral-12b's causal prefill (the greedy_pixtral phase's L 1280)
FLASH_ENCDEC_SHAPES = [
    ("seamless-m4t-medium encoder", 1, 16, 16, 3072, 3072, 64, False),
    ("seamless-m4t-medium cross Lq 1", 1, 16, 16, 1, 3072, 64, False),
    ("seamless-m4t-medium cross Lq 37", 1, 16, 16, 37, 3072, 64, False),
    ("seamless-m4t-medium cross Lq 256", 1, 16, 16, 256, 3072, 64, False),
    ("seamless-m4t-medium cross B 8 Lq 1", 8, 16, 16, 1, 3072, 64, False),
    ("GQA cross Lq 37 Lk 300", 2, 32, 8, 37, 300, 128, False),
    ("pixtral-12b L 2048", 1, 32, 8, 2048, 2048, 128, True),
    ("pixtral-12b", 1, 32, 8, 1280, 1280, 128, True)]
FLASH_ENCDEC_TIMED = ("seamless-m4t-medium encoder",
                      "seamless-m4t-medium cross Lq 256",
                      "seamless-m4t-medium cross B 8 Lq 1", "pixtral-12b")


def flash_err(fl, q, k, v, causal, window, what):
    """Max abs error of the kernel against its plain version; raises past
    the dtype's tolerance or on a wrong dtype or shape."""
    dt = q.dtype
    out = fl.flash_attention(q, k, v, causal=causal, window=window)
    ref = fl.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    if out.dtype != dt or out.shape != ref.shape:
        raise AssertionError(f"flash output {out.dtype}{tuple(out.shape)} "
                             f"vs {dt}{tuple(ref.shape)} ({what})")
    e = (out.float() - ref.float()).abs().max().item()
    if not e <= TOL[dt]:
        raise AssertionError(f"flash_attention {dt} {what}: max abs err {e} "
                             f"> {TOL[dt]}")
    return e


def check_flash(fl):
    """The flash kernel against its plain version on the card: f32 and
    bf16; L 1, 37, 128, 300, 2048; Dh 64, 128, 256; causal and not; windows
    -1, 32, 100, 512; GQA groups 1, 4, 5, 6; model-layout views and
    contiguous tensors in turn; then every shape the greedy_* prefills
    launch (FLASH_PATH_SHAPES), the MoE layouts at L 2048
    (FLASH_MOE_CHECKS) and the encoder-decoder and vision shapes, non-causal
    with Lq != Lk among them (FLASH_ENCDEC_SHAPES), in both dtypes."""
    worst, path, cases = {}, {}, 0
    for dt in (torch.float32, torch.bfloat16):
        for l in (1, 37, 128, 300, 2048):
            for d in (64, 128, 256):
                b, kv = (1, 1) if l == 2048 else (2, 2)
                err = 0.0
                for vi, (causal, window, g) in enumerate(FLASH_VARIANTS):
                    rng = np.random.default_rng(1000 * l + d + vi)
                    q, k, v = flash_inputs(rng, b, kv * g, kv, l, d, dt,
                                           model_layout=vi % 2 == 0)
                    err = max(err, flash_err(
                        fl, q, k, v, causal, window,
                        f"L={l} D={d} causal={causal} window={window} G={g}"))
                    cases += 1
                worst[f"{str(dt)[6:]} L={l} D={d}"] = err
        for si, (name, h, kv, l, d, w) in enumerate(FLASH_PATH_SHAPES
                                                     + FLASH_MOE_CHECKS):
            q, k, v = flash_inputs(np.random.default_rng(77 + si), 1, h, kv,
                                   l, d, dt, model_layout=True)
            path[f"{str(dt)[6:]} {name} L={l}"] = flash_err(
                fl, q, k, v, True, w, f"{name} H={h} KV={kv} L={l} D={d} "
                f"window={w}")
            cases += 1
            del q, k, v
        for si, (name, b, h, kv, lq, lk, d, causal) in enumerate(
                FLASH_ENCDEC_SHAPES):
            q, k, v = flash_inputs(np.random.default_rng(177 + si), b, h, kv,
                                   lq, d, dt, model_layout=True, lk=lk)
            path[f"{str(dt)[6:]} {name}"] = flash_err(
                fl, q, k, v, causal, -1, f"{name} B={b} H={h} KV={kv} "
                f"Lq={lq} Lk={lk} D={d} causal={causal}")
            cases += 1
            del q, k, v
    torch.cuda.empty_cache()
    errs = {**worst, **path}
    f32 = max(e for k, e in errs.items() if k.startswith("float32"))
    bf16 = max(e for k, e in errs.items() if k.startswith("bfloat16"))
    return {"phase": "kernel_check_flash", "cases": cases,
            "variants": [list(v) for v in FLASH_VARIANTS],
            "max_abs_err_f32": f32, "tol_f32": TOL[torch.float32],
            "max_abs_err_bf16": bf16, "tol_bf16": TOL[torch.bfloat16],
            "max_abs_err_per_dtype_L_D": worst,
            "path_shapes": [list(x) for x in FLASH_PATH_SHAPES
                            + FLASH_MOE_CHECKS],
            "encdec_shapes": [list(x) for x in FLASH_ENCDEC_SHAPES],
            "max_abs_err_path_shapes": path}


def timed_calls(module, names):
    """Replace ``module.<name>`` by a wrapper that times each call with
    the card synchronised; returns the records and an undo function."""
    rec = {n: [] for n in names}
    saved = {n: getattr(module, n) for n in names}

    def wrap(name, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            rec[name].append((time.perf_counter() - t, out))
            return out
        return run

    for n in names:
        setattr(module, n, wrap(n, saved[n]))

    def undo():
        for n, fn in saved.items():
            setattr(module, n, fn)
    return rec, undo


def profile_dense(T, params, cfg, prompt, steps=5):
    """Where the time goes in one prefill of ``prompt`` and in ``steps``
    dense-cache decode steps after it (batch 1): each timed plain, then
    under torch.profiler (device kernels by name)."""
    tokens = torch.from_numpy(prompt)[None].to("cuda")
    lp = len(prompt)
    state = {}

    def prefill():
        with torch.no_grad():
            logits, cache = T.prefill(params, cfg, tokens, last_only=True)
        state["cache"] = T.pad_prefill_cache(cfg, cache, lp + steps)
        state["tok"] = logits[:, -1].argmax(-1)

    def decode():
        with torch.no_grad():
            for i in range(steps):
                T.decode_step(params, cfg, state["tok"], lp + i,
                              state["cache"])

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    out = {}
    for name, fn, n in (("prefill", prefill, 1), ("decode", decode, steps)):
        plain_s = timed(fn)
        with torch.profiler.profile(activities=acts) as prof:
            prof_s = timed(fn)
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_ms = sum(e.self_device_time_total for e in events) / 1e3 / n
        flash_ms = sum(e.self_device_time_total for e in events
                       if "flash_attention_kernel" in e.key) / 1e3 / n
        scan_ms = sum(e.self_device_time_total for e in events
                      if "mamba_scan_kernel" in e.key) / 1e3 / n
        top = sorted(events, key=lambda e: e.self_device_time_total,
                     reverse=True)[:6]
        ms = 1e3 * plain_s / n
        out[f"profile_{name}"] = {
            "calls": n, "ms_per_call": ms,
            "ms_per_call_under_profiler": 1e3 * prof_s / n,
            "device_ms_per_call": dev_ms,
            "device_busy_share": dev_ms / ms if dev_ms else None,
            "device_kernels_per_call": sum(e.count for e in events) / n,
            "flash_kernel_ms_per_call": flash_ms,
            "flash_share_of_device": flash_ms / dev_ms if dev_ms else None,
            "mamba_scan_kernel_ms_per_call": scan_ms,
            "mamba_scan_share_of_device": scan_ms / dev_ms if dev_ms
            else None,
            "top_device_ms_per_call": {
                e.key[:60]: e.self_device_time_total / 1e3 / n
                for e in top}}
    del state
    return out


def prefill_launches(cfg):
    """The kernel launches one prefill makes: one flash_attention per
    attention layer, one mamba_scan per Mamba layer."""
    specs, repeat = cfg.superblock()
    return {"flash_attention": repeat * sum(s.mixer == "attn" for s in specs),
            "mamba_scan": repeat * sum(s.mixer == "mamba" for s in specs)}


def greedy(kernels, T, E, cfg, smi, *, phase, prompt_len, new, seed,
           profile=False, params=None, after=None):
    """``greedy_generate``: one prefill (one flash launch per attention
    layer, one mamba_scan launch per Mamba layer) and ``new - 1``
    dense-cache decode steps; with ``profile``, one more prefill and a few
    decode steps under torch.profiler; for a model with Mamba layers, the
    scan kernel held against its plain version on the path's own tensors;
    ``after(params, prompt)``, when given, adds its dict to the result.
    ``kernels`` maps each kernel name to its wrapper; ``params`` are made
    from ``seed`` unless given (the caller then keeps them)."""
    if params is None:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        params = T.init_model(gen, cfg, device="cuda")
    prompt = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, prompt_len).astype(np.int32)
    rec, undo = timed_calls(T, ("prefill", "decode_step"))
    try:
        # the first prefill at a shape pays for the allocator's growth and
        # the GEMM heuristics: timed apart, as the cold time to first token
        E.greedy_generate(params, cfg, prompt, 2, device="cuda")
        (cold_s, _), = rec["prefill"]
        rec["prefill"].clear()
        rec["decode_step"].clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        toks = E.greedy_generate(params, cfg, prompt, new, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in kernels.items()}
    finally:
        undo()
    peak = torch.cuda.max_memory_allocated()
    (pf_s, (logits, cache)), = rec["prefill"]
    if launches != prefill_launches(cfg):
        raise AssertionError(f"greedy {cfg.name}: launches {launches}, "
                             f"expected {prefill_launches(cfg)}")
    if tuple(logits.shape) != (1, 1, cfg.vocab_size) \
            or not torch.isfinite(logits).all():
        raise AssertionError(f"greedy {cfg.name}: prefill logits "
                             f"{tuple(logits.shape)} not finite")
    if len(toks) != new or not all(0 <= t < cfg.vocab_size for t in toks):
        raise AssertionError(f"greedy {cfg.name}: tokens {toks}")
    dc_s = sum(t for t, _ in rec["decode_step"])
    del logits, cache, rec
    extra = {}
    saved = {k: fn.launches for k, fn in kernels.items()}
    if profile:
        extra = profile_dense(T, params, cfg, prompt)
    if prefill_launches(cfg)["mamba_scan"]:
        extra.update(scan_on_path(T, params, cfg, prompt))
    if after is not None:
        extra.update(after(params, prompt))
    for k, fn in kernels.items():  # not the path's run
        fn.launches = saved[k]
    del params
    torch.cuda.empty_cache()
    return {"phase": phase, "arch": cfg.name, "layers": cfg.num_layers,
            "d_model": cfg.d_model, "heads": cfg.num_heads,
            "kv_heads": cfg.num_kv_heads, "head_dim": cfg.resolved_head_dim,
            "dtype": cfg.compute_dtype, "prompt_tokens": prompt_len,
            "new_tokens": new,
            "flash_launches_per_prefill": launches["flash_attention"],
            "mamba_scan_launches_per_prefill": launches["mamba_scan"],
            "prefill_ms": 1e3 * pf_s, "prefill_tok_per_s": prompt_len / pf_s,
            "prefill_ms_first_call": 1e3 * cold_s,
            "decode_steps": new - 1,
            "decode_tok_per_s": (new - 1) / dc_s if new > 1 else None,
            "decode_step_ms_mean": 1e3 * dc_s / max(1, new - 1),
            "wall_s": wall, "peak_mem_gb": peak / 1e9, "tokens": toks[:8],
            **extra, "card": smi}


# dense_serve's short requests past its 8 slots, (prompt, new) tokens:
# each is admitted into a slot a finished request freed, beside the other
# slots' decode, mostly before the longest first request ends
DENSE_REFILL, DENSE_REFILL_TOKENS = 4, (8, 16)


def dense_serve(T, E, cfg, smi, phase="dense_serve", params=None,
                memory=None, prompt=(32, 160), new=(16, 48), flash=None):
    """``DecodeEngine``: 8 slots, max_seq 512, 8 requests of ``prompt``
    tokens (ingested one per step) and ``new`` new tokens, then
    DENSE_REFILL short ones, which the run must admit into freed slots
    (gated: a recurrent model's slot reset, a new prompt's ingest beside
    the other slots' decode); ``params`` made from seed 3 unless given.
    An encoder-decoder model's ``memory`` (8, S, D) goes to the engine
    (slot i reads row i), and then ``flash``, the kernel's wrapper, is
    counted from zero over the run and gated at one launch a decoder
    layer a step."""
    if params is None:
        gen = torch.Generator(device="cuda").manual_seed(3)
        params = T.init_model(gen, cfg, device="cuda")
    eng = E.DecodeEngine(params, cfg, batch_slots=8, max_seq=512,
                         device="cuda", memory=memory)
    del params
    rng = np.random.default_rng(3)
    reqs = requests(E.Request, rng, 8, *prompt, *new, cfg.vocab_size)
    for r in requests(E.Request, rng, DENSE_REFILL, *DENSE_REFILL_TOKENS,
                      *DENSE_REFILL_TOKENS, cfg.vocab_size):
        r.rid += len(reqs)
        reqs.append(r)
    steps, refills = [], []
    decode, admit = eng._decode, eng._admit

    def counted():  # the requests admitted after step 0: into freed slots
        queued = len(eng.queue)
        admit()
        if eng.steps:
            refills.extend([eng.steps] * (queued - len(eng.queue)))

    def timed(toks, pos):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = decode(toks, pos)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t)
        return out

    eng._decode, eng._admit = timed, counted
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    if flash is not None:
        flash.launches = 0
    t0 = time.perf_counter()
    done = eng.run()
    wall = time.perf_counter() - t0
    launches = {}
    if flash is not None:
        launches = {"flash_launches": flash.launches,
                    "flash_launches_expected": cfg.num_layers * eng.steps}
        if flash.launches != cfg.num_layers * eng.steps:
            raise AssertionError(f"{phase}: flash launches {flash.launches}, "
                                 f"expected {cfg.num_layers} a step x "
                                 f"{eng.steps} steps")
    if len(done) != len(reqs):
        raise AssertionError(f"{len(done)} of {len(reqs)} requests finished")
    if len(refills) != len(reqs) - 8:
        raise AssertionError(f"{phase}: {len(refills)} requests admitted "
                             f"into freed slots, {len(reqs) - 8} expected")
    for r in done:
        if not r.done or r.preempted or r.truncated \
                or len(r.generated) != r.max_new_tokens:
            raise AssertionError(f"dense request {r.rid} not done: "
                                 f"{len(r.generated)} of {r.max_new_tokens}")
        if not all(0 <= t < cfg.vocab_size for t in r.generated):
            raise AssertionError(f"dense request {r.rid}: token outside "
                                 "the vocab")
    gen_toks = sum(len(r.generated) for r in done)
    prompt_toks = sum(len(r.prompt) for r in done)
    out = {"phase": phase, "arch": cfg.name,
           "layers": cfg.num_layers, "dtype": cfg.compute_dtype,
           "slots": 8, "max_seq": 512, "requests": len(reqs),
           "admitted_into_freed_slots_at_steps": refills, **launches,
           "prompt_tokens": prompt_toks, "generated_tokens": gen_toks,
           "steps": eng.steps, "step_ms_median": 1e3 * statistics.median(steps),
           "decode_tok_per_s": gen_toks / sum(steps),
           "tok_per_s_prompt_and_decode": (gen_toks + prompt_toks)
           / sum(steps),
           "wall_s": wall, "peak_mem_gb": torch.cuda.max_memory_allocated()
           / 1e9, "card": smi}
    del eng
    torch.cuda.empty_cache()
    return out


DENSE_CASES = (("qwen2-1.5b", 200, 21), ("gemma3-1b", 600, 22))


def dense_side(get_config, dev):
    """``dense_card_vs_cpu``'s runs on ``dev``, by arch: the prefill's last
    logits (on the host) and ``greedy_generate``'s tokens; on the card
    also ``DecodeEngine``'s tokens for the same prompt."""
    from repro_torch.models import transformer as T
    from repro_torch.serve import engine as E

    out = {}
    for arch, lp, seed in DENSE_CASES:
        cfg = dataclasses.replace(get_config(arch), num_layers=2)
        params = T.init_model(torch.Generator().manual_seed(seed), cfg,
                              device="cpu")
        prompt = np.random.default_rng(seed).integers(
            0, cfg.vocab_size, lp).astype(np.int32)
        prm = _tree(params, lambda t: t.to(dev))
        with torch.no_grad():
            lg, _ = T.prefill(prm, cfg, torch.from_numpy(prompt)[None]
                              .to(dev), last_only=True)
        res = {"logits": lg.cpu(),
               "gens": E.greedy_generate(prm, cfg, prompt, 8, device=dev)}
        del prm, lg
        if dev == "cuda":
            eng = E.DecodeEngine(params, cfg, batch_slots=2,
                                 max_seq=lp + 16, device="cuda")
            eng.submit(E.Request(rid=0, prompt=prompt, max_new_tokens=8))
            res["engine_gens"] = eng.run()[0].generated
            del eng
        out[arch] = res
        del params
        torch.cuda.empty_cache()
    return out


def dense_card_vs_cpu(get_config, cpu):
    """qwen2-1.5b and gemma3-1b at full width cut to 2 layers, f32: the
    same weights and prompt on the card and on the CPU (prefill logits,
    greedy tokens; ``cpu``: ``dense_side``'s CPU run, from the
    ``cpu_half`` worker), and on the card greedy_generate's flash prefill
    against DecodeEngine's token-by-token ingestion of the same prompt."""
    out = {"phase": "dense_card_vs_cpu", "layers": 2, "dtype": "float32",
           "tol_logits": 1e-3, "archs": {}}
    card = dense_side(get_config, "cuda")
    for arch, lp, _ in DENSE_CASES:
        a, b = card[arch], cpu[arch]
        err = (a["logits"] - b["logits"]).abs().max().item()
        if not err <= 1e-3:
            raise AssertionError(f"{arch}: card vs CPU prefill logits differ "
                                 f"by {err} > 1e-3")
        if a["gens"] != b["gens"]:
            raise AssertionError(f"{arch}: card vs CPU greedy tokens "
                                 f"{a['gens']} vs {b['gens']}")
        if a["engine_gens"] != a["gens"]:
            raise AssertionError(f"{arch}: greedy_generate {a['gens']} vs "
                                 f"DecodeEngine {a['engine_gens']} on the "
                                 "card")
        cfg = dataclasses.replace(get_config(arch), num_layers=2)
        windows = sorted({int(w) for w in cfg.layer_windows()[0].ravel()})
        out["archs"][arch] = {
            "prompt_tokens": lp, "layer_windows": windows,
            "prefill_logits_max_abs_err": err,
            "tokens_card_eq_cpu": True, "tokens_generate_eq_engine": True,
            "tokens": a["gens"]}
    return out


def time_flash(fl, launches, smi):
    """The kernel, its plain version and F.scaled_dot_product_attention on
    the prefill's tensors (model-layout views, bf16) at every shape the
    greedy_* prefills launch (B 1, causal) and at the encoder-decoder and
    vision shapes of FLASH_ENCDEC_TIMED; the kernel's output is held
    against the plain version's on the same tensors.  L2 flushed before
    each launch."""
    flush = l2_flush()

    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    saved = fl.flash_attention.launches
    shapes = [(name, 1, h, kv, l, l, d, w, True)
              for name, h, kv, l, d, w in FLASH_PATH_SHAPES] + [
        (name, b, h, kv, lq, lk, d, -1, causal)
        for name, b, h, kv, lq, lk, d, causal in FLASH_ENCDEC_SHAPES
        if name in FLASH_ENCDEC_TIMED]
    for name, b, h, kv, l, lk, d, w, causal in shapes:
        q, k, v = flash_inputs(np.random.default_rng(h + d + l), b, h, kv, l,
                               d, torch.bfloat16, model_layout=True, lk=lk)

        def kernel():
            return fl.flash_attention(q, k, v, causal=causal, window=w)

        ms = cuda_ms(kernel, 30, flush)
        plain = cuda_ms(lambda: fl.flash_attention_plain(
            q, k, v, causal=causal, window=w), 5, flush)
        err = flash_err(fl, q, k, v, causal, w, f"{name} (time_flash)")
        if w > 0:
            i = torch.arange(l, device="cuda")
            mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < w)
            kw = {"attn_mask": mask}
            note = "SDPA with enable_gqa and an explicit window mask"
        elif causal:
            kw = {"is_causal": True}
            note = "SDPA with enable_gqa, is_causal"
        else:
            kw = {"is_causal": False}
            note = "SDPA with enable_gqa, is_causal=False"
        lib = cuda_ms(lambda: sdpa(q, k, v, enable_gqa=True, **kw), 30, flush)
        lib_out = sdpa(q, k, v, enable_gqa=True, **kw)
        lib_err = (lib_out.float() - kernel().float()).abs().max().item()
        # the pairs (i, j) the mask keeps, each 4 * D flops (QK and PV)
        if causal:
            ww = l if w <= 0 else w
            pairs = l * ww - ww * (ww - 1) // 2
        else:
            pairs = l * lk
        flops = 4 * d * pairs * h * b
        nbytes = 2 * b * (2 * h * l + 2 * kv * lk) * d  # q, out, k, v, bf16
        b_ms, o_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / \
            BF16_OPS_PER_S
        out[name] = {
            "shape": {"B": b, "L": l, "Lk": lk, "H": h, "KV": kv, "Dh": d,
                      "window": w, "causal": causal, "dtype": "bfloat16"},
            "ms": ms, "plain_ms": plain, "max_abs_err_vs_plain": err,
            "tol": TOL[torch.bfloat16], "library_ms": lib,
            "library_note": note + "; never called by the port",
            "library_max_abs_err_vs_kernel": lib_err,
            "flops": flops, "bytes": nbytes, "bound_ms": max(b_ms, o_ms),
            "bound_by": "operations" if o_ms >= b_ms else "bytes",
            "tflops_achieved": flops / (ms / 1e3) / 1e12}
        del q, k, v, lib_out
    fl.flash_attention.launches = saved  # timing launches are not the path's
    del flush
    torch.cuda.empty_cache()
    return {"phase": "time_flash", "kernels": out,
            "launches_on_main_path": launches, "card": smi}


# ---------------------------------------------------------------------------
# the recurrent families: the mamba_scan kernel, jamba and xLSTM serving
# ---------------------------------------------------------------------------
# exponentials a second: 16 exp2 a clock per SM (CUDA C++ Programming
# Guide, arithmetic-instruction throughput, compute capability 9.0) on the
# H100 SXM's 132 SMs at its 1.98 GHz maximum clock (NVIDIA data sheet)
SFU_EXP_PER_S = 132 * 16 * 1.98e9
# kernel against plain, atol = rtol: in f32 the JAX package's own Mamba
# tolerance (tests/test_kernels.py::test_mamba_scan_sweep); in bf16 both
# sum in f32 and agree to ~1e-6, but y is rounded to bf16 (8 significant
# bits), so a value on a rounding boundary may land one bf16 ulp (up to
# 2^-7 of it) away.  h_last is f32 in both dtypes and held at 1e-4.
MAMBA_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# (B, L, D, N): the reference's sweep (tests/test_kernels.py:166) and a
# long case whose D no block of 128 channels divides
MAMBA_SHAPES = [(2, 32, 64, 8), (1, 16, 128, 16), (2, 24, 96, 4),
                (2, 1000, 200, 16)]
# (B, L, D, N, B/C columns or None for the model's): shapes that take the
# kernel's narrow staging (``kVec`` false) in every piece width.  D 37,
# 38, 36 give u/delta rows of 148/152/144 bytes in f32 (4-, 8-, 16-byte
# pieces and y stores) and 74/76/72 in bf16 (2, 4, 8); B/C at columns 1
# and N + 3 of a (B, L, 2N + 4) tensor give 4-byte f32 and 2-byte bf16
# pieces, bf16 N 4 in the model's layout 8-byte C pieces
MAMBA_RAGGED = [(1, 50, 37, 4, None), (1, 50, 37, 8, None),
                (1, 50, 37, 16, None), (2, 40, 38, 16, (1, 19)),
                (2, 40, 36, 8, (1, 11)), (2, 40, 64, 4, (1, 7))]
# jamba-1.5-large's prefill scan: B 1, L 2048, d_inner 16384, N 16; B and
# C are slices of x_proj's (B, L, dt_rank + 2N) output, dt_rank 512
JAMBA_SCAN = (1, 2048, 16384, 16)
JAMBA_DT_RANK = 8192 // 16


def mamba_inputs(rng, b, l, d, n, dtype, dt_rank=0, bc_cols=None):
    """u, delta = softplus(.), a = -|.|, B, C and D as the reference's
    sweep draws them (seeded numpy), on the card; B and C are slices of one
    (B, L, dt_rank + 2N) tensor, as the model passes them, or with
    ``bc_cols`` (B's first column, C's) of a (B, L, 2N + 4) tensor."""
    def dev(shape, scale=1.0, dt=dtype):
        a = scale * rng.standard_normal(shape, dtype=np.float32)
        return torch.from_numpy(a).to("cuda").to(dt)

    u = dev((b, l, d), 0.5)
    delta = torch.nn.functional.softplus(dev((b, l, d), dt=torch.float32))
    a = -dev((d, n), dt=torch.float32).abs()
    ob, oc = bc_cols or (dt_rank, dt_rank + n)
    dbl = dev((b, l, 2 * n + (4 if bc_cols else dt_rank)), 0.5)
    return (u, delta.to(dtype), a, dbl[..., ob:ob + n], dbl[..., oc:oc + n],
            dev((d,)))


def mamba_err(ms, args, what):
    """Max abs errors of y and h_last, kernel against plain; raises outside
    MAMBA_TOL, when h_last is not bitwise the plain version's (the kernel
    rounds each state update as the plain version does), or on a wrong
    dtype or shape."""
    dt = args[0].dtype
    y, h = ms.mamba_scan(*args)
    yp, hp = ms.mamba_scan_plain(*args)
    torch.cuda.synchronize()
    if y.dtype != dt or y.shape != yp.shape or h.dtype != torch.float32 \
            or h.shape != hp.shape:
        raise AssertionError(f"mamba_scan {what}: y {y.dtype}"
                             f"{tuple(y.shape)}, h_last {h.dtype}"
                             f"{tuple(h.shape)}")
    errs = []
    for name, out, ref, tol in (("y", y, yp, MAMBA_TOL[dt]),
                                ("h_last", h, hp, MAMBA_TOL[torch.float32])):
        diff = (out.float() - ref.float()).abs()
        if (diff > tol + tol * ref.float().abs()).any():
            raise AssertionError(f"mamba_scan {dt} {what}: {name} leaves "
                                 f"atol = rtol = {tol} (max abs err "
                                 f"{diff.max().item()})")
        errs.append(diff.max().item())
    if not torch.equal(h, hp):
        raise AssertionError(f"mamba_scan {dt} {what}: h_last is not bitwise "
                             f"the plain version's (max abs err {errs[1]})")
    return errs


def check_mamba(ms):
    """The scan kernel against its plain version on the card, f32 and bf16:
    the reference's sweep shapes, a long case, the narrow-staging shapes of
    MAMBA_RAGGED and jamba's prefill tensors (B/C strided slices of the
    x_proj output)."""
    err = {}
    cases = 0
    for dt in (torch.float32, torch.bfloat16):
        shapes = [s + (0, None) for s in MAMBA_SHAPES] \
            + [JAMBA_SCAN + (JAMBA_DT_RANK, None)] \
            + [s[:4] + (0, s[4]) for s in MAMBA_RAGGED]
        for si, (b, l, d, n, r, cols) in enumerate(shapes):
            args = mamba_inputs(np.random.default_rng(40 + si), b, l, d, n,
                                dt, dt_rank=r, bc_cols=cols)
            what = f"B={b} L={l} D={d} N={n}" + (" model layout" if r else "") \
                + (f" B/C at columns {cols}" if cols else "")
            ey, eh = mamba_err(ms, args, what)
            err[f"{str(dt)[6:]} {what}"] = {"y": ey, "h_last": eh}
            cases += 1
            del args
    torch.cuda.empty_cache()
    worst = {str(dt)[6:]: max(max(e.values()) for k, e in err.items()
                             if k.startswith(str(dt)[6:]))
             for dt in MAMBA_TOL}
    return {"phase": "kernel_check_mamba", "cases": cases,
            "state_dims": list(ms.STATE_DIMS),
            "max_abs_err_f32": worst["float32"],
            "tol_f32": MAMBA_TOL[torch.float32],
            "max_abs_err_bf16": worst["bfloat16"],
            "tol_bf16": MAMBA_TOL[torch.bfloat16],
            "tol_h_last": MAMBA_TOL[torch.float32],
            "h_last_bitwise": True,
            "tol_note": "atol = rtol; bf16 y: one bf16 rounding; h_last "
                        "also bitwise (torch.equal)",
            "max_abs_err_per_case": err}


def scan_on_path(T, params, cfg, prompt):
    """One more prefill that records the first Mamba layer's scan inputs,
    then the kernel against its plain version on exactly those tensors."""
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import ops

    seen = []
    kernel = ops.mamba_scan

    def record(*args):
        if not seen:
            seen.append(args)
        return kernel(*args)

    ops.mamba_scan = record
    try:
        with torch.no_grad():
            T.prefill(params, cfg, torch.from_numpy(prompt)[None].to("cuda"),
                      last_only=True)
    finally:
        ops.mamba_scan = kernel
    args = seen[0]
    ey, eh = mamba_err(ms, args, f"{cfg.name} prefill, first Mamba layer")
    return {"scan_on_path": {
        "u": list(args[0].shape), "dtype": str(args[0].dtype)[6:],
        "b_strides": list(args[3].stride()),
        "max_abs_err_y": ey, "max_abs_err_h_last": eh,
        "h_last_bitwise": True, "tol": MAMBA_TOL[args[0].dtype]}}


def contractive_slstm(params, cfg):
    """Scale every sLSTM's recurrent weights R (H, dh, 4 dh) from the
    reference's init, drawn with fan-in H (``dense_init``'s first axis),
    to fan-in dh.  Drawn with fan-in 4 at xlstm-125m's dh of 192, R gives
    the recurrence a gain of ~7 a step and the model is chaotic: a change
    of one part in 1e7 in its embedding moves its logits about as far as
    their own size (``input_sensitivity``), so two devices' roundings
    cannot agree to 1e-3.  With fan-in dh the same code runs on weights
    whose outputs rounding does not scramble."""
    specs, _ = cfg.superblock()
    h, dh = cfg.num_heads, cfg.d_model // cfg.num_heads
    for i, spec in enumerate(specs):
        if spec.mixer == "slstm":
            params["stack"][str(i)]["slstm"]["R"] *= math.sqrt(h / dh)
    return params


def input_sensitivity(T, params, cfg, prompt):
    """Max change of the last prefill logits when the embedding is scaled
    by 1 + 1e-7 (about one f32 rounding), on the card."""
    tokens = torch.from_numpy(prompt)[None].to("cuda")
    with torch.no_grad():
        base, _ = T.prefill(params, cfg, tokens, last_only=True)
        moved, _ = T.prefill({**params, "embed": params["embed"]
                              * (1 + 1e-7)}, cfg, tokens, last_only=True)
    return (base - moved).abs().max().item()


def recurrent_cases(get_config):
    jamba = dataclasses.replace(
        get_config("jamba-1.5-large-398b").reduced(), num_experts=0,
        num_layers=8)
    xlstm = dataclasses.replace(get_config("xlstm-125m"), num_layers=4)
    return ((jamba, 300, 31), (xlstm, 200, 32))


def recurrent_side(get_config, dev):
    """``recurrent_card_vs_cpu``'s runs on ``dev``, by config name: the
    prefill's last logits (on the host) and ``greedy_generate``'s tokens;
    on the card also the logits' sensitivity to the embedding (before and
    after ``contractive_slstm``) and ``DecodeEngine``'s tokens with the
    prompt in a slot another request has used."""
    from repro_torch.models import transformer as T
    from repro_torch.serve import engine as E

    out = {}
    for cfg, lp, seed in recurrent_cases(get_config):
        params = T.init_model(torch.Generator().manual_seed(seed), cfg,
                              device="cpu")
        rng = np.random.default_rng(seed)
        prompt = rng.integers(0, cfg.vocab_size, lp).astype(np.int32)
        res = {}
        if dev == "cuda":
            res["sens"] = {"reference_init": input_sensitivity(
                T, _tree(params, lambda t: t.to("cuda")), cfg, prompt)}
        params = contractive_slstm(params, cfg)
        if dev == "cuda":
            res["sens"]["compared"] = input_sensitivity(
                T, _tree(params, lambda t: t.to("cuda")), cfg, prompt)
        prm = _tree(params, lambda t: t.to(dev))
        with torch.no_grad():
            lg, _ = T.prefill(prm, cfg, torch.from_numpy(prompt)[None]
                              .to(dev), last_only=True)
        res["logits"] = lg.cpu()
        res["gens"] = E.greedy_generate(prm, cfg, prompt, 8, device=dev)
        del prm, lg
        if dev == "cuda":
            # one slot: the other request runs first and leaves its state
            # there
            eng = E.DecodeEngine(params, cfg, batch_slots=1,
                                 max_seq=lp + 16, device="cuda")
            other = rng.integers(0, cfg.vocab_size, lp // 2).astype(np.int32)
            eng.submit(E.Request(rid=0, prompt=other, max_new_tokens=8))
            eng.submit(E.Request(rid=1, prompt=prompt, max_new_tokens=8))
            res["engine_gens"] = {r.rid: r.generated for r in eng.run()}[1]
            del eng
        out[cfg.name] = res
        del params
        torch.cuda.empty_cache()
    return out


def recurrent_card_vs_cpu(get_config, cpu):
    """f32, TF32 off: jamba at its reduced widths without experts, cut to
    one super-block (8 layers: one attention, seven Mamba), with a prompt
    longer than ssm_chunk, and xlstm-125m at full width cut to 4 of its
    12 layers (its sLSTM weights made contractive,
    ``contractive_slstm``).  The same weights and prompt on the card and
    on the CPU (prefill logits, greedy tokens; ``cpu``:
    ``recurrent_side``'s CPU run, from the ``cpu_half`` worker); on the
    card, ``greedy_generate``'s tokens against ``DecodeEngine``'s when the
    prompt goes into a slot another request has used (the recurrent state
    must be reset)."""
    out = {"phase": "recurrent_card_vs_cpu", "dtype": "float32",
           "tol_logits": 1e-3, "archs": {}}
    card = recurrent_side(get_config, "cuda")
    for cfg, lp, _ in recurrent_cases(get_config):
        a, b = card[cfg.name], cpu[cfg.name]
        err = (a["logits"] - b["logits"]).abs().max().item()
        if not err <= 1e-3:
            raise AssertionError(f"{cfg.name}: card vs CPU prefill logits "
                                 f"differ by {err} > 1e-3")
        if a["gens"] != b["gens"]:
            raise AssertionError(f"{cfg.name}: card vs CPU greedy tokens "
                                 f"{a['gens']} vs {b['gens']}")
        if a["engine_gens"] != a["gens"]:
            raise AssertionError(f"{cfg.name}: greedy_generate "
                                 f"{a['gens']} vs DecodeEngine "
                                 f"{a['engine_gens']} in a reused slot on "
                                 "the card")
        specs, repeat = cfg.superblock()
        out["archs"][cfg.name] = {
            "layers": cfg.num_layers, "d_model": cfg.d_model,
            "mixers": [s.mixer for s in specs] * repeat,
            "prompt_tokens": lp, "ssm_chunk": cfg.ssm_chunk,
            "prefill_logits_max_abs_err": err,
            "logit_change_from_1e-7_embed_change": a["sens"],
            "tokens_card_eq_cpu": True,
            "tokens_generate_eq_engine_reused_slot": True,
            "tokens": a["gens"]}
    return out


def build_source(src, subdir):
    """A kernel source (an earlier design, or a variant of a lane map)
    built with the port's nvcc flags, and ``csrc/`` on the include path for
    its headers, into ``build/kernels/<subdir>/``: (library, ptxas log)."""
    from repro_torch.kernels import _build

    out = _build.BUILD_ROOT / subdir
    out.mkdir(parents=True, exist_ok=True)
    lib = out / f"lib{Path(src).stem}.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                           str(_build.CSRC), "-o", str(lib), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, timeout=900)
    if proc.returncode:
        raise RuntimeError(f"build of {src}: nvcc exited {proc.returncode}"
                           f"\n{proc.stdout}")
    return lib, proc.stdout


@contextlib.contextmanager
def scan_kernel(ms, lib):
    """``ms.mamba_scan`` (its checks, outputs and count) launching the
    ``mamba_scan_fwd`` of the library ``lib``."""
    fn = ctypes.CDLL(str(lib)).mamba_scan_fwd
    fn.argtypes = ms._ARGTYPES
    fn.restype = ctypes.c_int
    saved = ms._kernel_fn
    ms._kernel_fn = lambda: fn
    try:
        yield
    finally:
        ms._kernel_fn = saved


def ptxas_functions(log):
    """{entry function: {"registers", "spill_bytes"}} from a ``-Xptxas -v``
    build log."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = {"registers": None, "spill_bytes": 0}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name]["spill_bytes"] += int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def bwd_spills(funcs):
    """Spill bytes of the backward library's kernels by N (both dtypes
    summed), from ``ptxas_functions``."""
    out = {}
    for name, f in funcs.items():
        m = re.search(r"mamba_scan_bwd_kernel.*?Li(\d+)E", name)
        if m:
            n = int(m.group(1))
            out[n] = out.get(n, 0) + f["spill_bytes"]
    return out


def scan_function(names, kernel="mamba_scan_kernel"):
    """The bf16, N = 16 instance of ``kernel`` among mangled names:
    jamba's (its widest-staging instance, ``kVec`` true, where the design
    has one)."""
    cands = [n for n in names if kernel + "I" in n
             and "__nv_bfloat16" in n and "Li16E" in n]
    vec = [n for n in cands if "Lb1E" in n]
    return (vec or cands or [None])[0]


def sass_functions(lib, nvcc):
    """{mangled function name: [(address, instruction)]} of a library's
    SASS (the ``cuobjdump`` beside ``nvcc``), or None without one."""
    sass = library_sass(lib, nvcc)
    if sass is None:
        return None
    funcs, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and name:
            funcs[name].append((int(m.group(1), 16), m.group(2)))
    return funcs


def mufu_loops(ins):
    """The loops of one function's SASS (a branch back to an earlier
    address) that hold MUFU.EX2 and no such loop inside them:
    [(instructions, MUFU.EX2, body)]."""
    loops = []
    for addr, text in ins:
        m = re.search(r"\bBRA\b[^;]*?0x([0-9a-f]+)", text)
        if m and int(m.group(1), 16) < addr:
            lo = int(m.group(1), 16)
            body = [(a, t) for a, t in ins if lo <= a <= addr]
            mufu = sum("MUFU.EX2" in t for _, t in body)
            if mufu:
                loops.append((lo, addr, mufu, body))
    inner = [x for x in loops if not any(
        y is not x and x[0] <= y[0] and y[1] <= x[1] for y in loops)]
    return [(len(body), mufu, body) for _, _, mufu, body in inner]


def sass_scan_loop(lib, nvcc):
    """The scan loop of the bf16, N = 16 kernel in a library's SASS: the
    innermost loop that holds MUFU.EX2, its static instruction count, its
    MUFU.EX2 count (one exponential a state-step) and their ratio, the
    instructions a lane issues a state-step, the loop's own overheads
    included.  Returns (stats, the loop's SASS text), or ("not
    available", "")."""
    funcs = sass_functions(lib, nvcc)
    name = scan_function(funcs or {})
    loops = mufu_loops(funcs[name]) if name else []
    if not loops:
        return "not available", ""
    n, mufu, body = min(loops, key=lambda x: x[0])
    ins = funcs[name]
    return ({"function": name, "loop_instructions": n, "mufu_ex2": mufu,
             "instructions_per_state_step": n / mufu,
             "mufu_ex2_in_function": sum("MUFU.EX2" in t for _, t in ins),
             "instructions_in_function": len(ins)},
            "\n".join(f"/*{a:04x}*/ {t}" for a, t in body))


def scan_build_stats(lib, log, nvcc):
    """Registers and spills (ptxas) of jamba's scan kernel and of the
    whole library, and its scan loop's SASS counts."""
    funcs = ptxas_functions(log)
    name = scan_function(funcs)
    sass, _ = sass_scan_loop(lib, nvcc)
    return {"registers": funcs[name]["registers"] if name else None,
            "spill_bytes": funcs[name]["spill_bytes"] if name else None,
            "max_registers": max((f["registers"] or 0
                                  for f in funcs.values()), default=None),
            "spill_bytes_library": sum(f["spill_bytes"]
                                       for f in funcs.values()),
            "sass": sass}


# the most two timing turns of one kernel may differ, as max / min - 1
TURN_SPREAD = 0.2


def turn_spread(times):
    return max(times) / min(times) - 1


def time_mamba(ms, launches, smi, before=None):
    """The kernel, its plain version and its bound at jamba's prefill scan
    (bf16, B/C slices of the x_proj output), L2 flushed before each
    launch; the kernel's output is held against the plain version's
    (h_last bitwise).  ``before``: the source of an earlier design of the
    kernel, built beside it and timed in the same call, in turns (plain,
    this, before, this); without it ``ms_before`` is null.  Each turn is
    timed with events around the call (``ms``) and by the profiler's
    device time of the kernel alone (``device_ms``), which leaves out any
    wait for the host.  The kernel's turns must agree within TURN_SPREAD
    by the device time (by events where the profiler saw no kernel); turns
    whose events disagree while their device times agree held a wait for
    the host, and are flagged so (``events_held_host_wait``)."""
    from repro_torch.kernels import _build

    b, l, d, n = JAMBA_SCAN
    args = mamba_inputs(np.random.default_rng(9), b, l, d, n, torch.bfloat16,
                        dt_rank=JAMBA_DT_RANK)
    flush = l2_flush()
    lib = _build.build_all()["mamba_scan"]
    stats = {"this": scan_build_stats(lib, lib.with_suffix(".log")
                                      .read_text(), _build._nvcc())}
    old = None
    if before is not None:
        old, blog = build_source(Path(before), "scan-before")
        stats["before"] = scan_build_stats(old, blog, _build._nvcc())

    def turn():
        def call():
            return ms.mamba_scan(*args)
        dev = profiled_ms(call, 10, flush, "mamba_scan_kernel")
        return (cuda_ms(call, 30, flush),
                sum(dev.values()) if dev else None)

    saved = ms.mamba_scan.launches
    plain_ms = cuda_ms(lambda: ms.mamba_scan_plain(*args), 2, flush)
    runs = [turn()]
    before_run, same_h = (None, None), None
    if old is not None:
        with scan_kernel(ms, old):
            before_run = turn()
            _, h_old = ms.mamba_scan(*args)
    runs.append(turn())
    kernel_ms = statistics.mean(r[0] for r in runs)
    device = [r[1] for r in runs if r[1] is not None]
    spread = {"events": turn_spread([r[0] for r in runs]),
              "device": turn_spread(device) if len(device) == len(runs)
              else None}
    judged = "device" if spread["device"] is not None else "events"
    if spread[judged] > TURN_SPREAD:
        raise AssertionError(f"mamba_scan: the timing turns disagree by "
                             f"{spread[judged]:.1%} ((events, device) ms: "
                             f"{runs}), more than "
                             f"{TURN_SPREAD:.0%}")
    ey, eh = mamba_err(ms, args, "jamba prefill shape (time_mamba)")
    if old is not None:
        same_h = torch.equal(h_old, ms.mamba_scan(*args)[1])
    ms.mamba_scan.launches = saved  # timing launches are not the path's
    # read u, delta (bf16), A (f32), B, C, D (bf16); write y (bf16), h_last
    nbytes = (3 * b * l * d * 2 + 2 * b * l * n * 2 + d * n * 4 + d * 2
              + b * d * n * 4)
    exps = b * l * d * n
    b_ms, o_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * exps / SFU_EXP_PER_S
    del args, flush
    torch.cuda.empty_cache()
    return {"phase": "time_mamba", "name": "mamba_scan",
            "shape": {"B": b, "L": l, "D": d, "N": n, "dtype": "bfloat16",
                      "b_c": "slices of a (B, L, dt_rank + 2N) tensor"},
            "ms": kernel_ms, "ms_runs": [r[0] for r in runs],
            "device_ms": statistics.mean(device) if device else None,
            "device_ms_runs": [r[1] for r in runs], "plain_ms": plain_ms,
            "turn_spread": spread, "turn_spread_limit": TURN_SPREAD,
            "events_held_host_wait": spread["events"] > TURN_SPREAD,
            "ms_before": before_run[0], "device_ms_before": before_run[1],
            "before": str(before) if before is not None else
            "not measured: pass --mamba-before with an earlier design's "
            "source",
            "h_last_equal_before": same_h,
            "max_abs_err_y": ey, "max_abs_err_h_last": eh,
            "h_last_bitwise": True,
            "tol": MAMBA_TOL[torch.bfloat16],
            "library_ms": None,
            "library_note": "no single PyTorch call computes a selective "
                            "scan",
            "bytes": nbytes, "exps": exps, "bound_ms": max(b_ms, o_ms),
            "bound_by": "operations" if o_ms >= b_ms else "bytes",
            "bytes_ms": b_ms, "exps_ms": o_ms,
            "exps_per_s_achieved": exps / (kernel_ms / 1e3),
            "build": stats,
            "launches_on_main_path": launches, "card": smi}


# ---------------------------------------------------------------------------
# training kernels against their plain versions
# ---------------------------------------------------------------------------
def code_rows(seed, nb, block):
    """(g, r) CUDA rows with the cases the encode kernels must get right:
    all-zero rows (a zero-padded tail block), a row with two nonzeros
    (fewer than k), tied magnitudes, -0.0 targets (taken and untaken)."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((nb, block), dtype=np.float32)
    r = 0.1 * rng.standard_normal((nb, block), dtype=np.float32)
    g[0:2], r[0:2] = 0.0, 0.0
    g[2], r[2] = 0.0, 0.0
    g[2, 5], g[2, block - 3] = 1.5, -2.5
    g[3], r[3] = 0.5, 0.0
    g[3, ::2] = -0.5
    g[4, ::3], r[4, ::3] = -0.0, -0.0
    g[5], r[5] = -0.0, -0.0  # every target -0.0: the taken ones too
    g[5, 1] = 3.0
    return (torch.from_numpy(g).to("cuda"), torch.from_numpy(r).to("cuda"))


def bitwise_equal(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def check_onebit(ob):
    """Packed bytes equal to the plain version's; scales equal or one bf16
    ulp apart (the f32 sum runs in another order); r' bitwise equal to
    t - sign * f32(the kernel's own scale)."""
    worst_ulp, off_rows, err, cases = 0, 0, 0.0, 0
    for block, nb in ((256, 20_011), (64, 5_003)):
        g, r = code_rows(block, nb, block)
        packed, scale, new_r = ob.onebit_quant_packed(g, r)
        pp, ps, pr = ob.onebit_quant_packed_plain(g, r)
        torch.cuda.synchronize()
        if not bitwise_equal(packed, pp):
            raise AssertionError(f"onebit block {block}: packed bytes differ")
        ulps = (scale.view(torch.int16).int()
                - ps.view(torch.int16).int()).abs()  # scales are >= 0
        worst_ulp = max(worst_ulp, int(ulps.max().item()))
        off_rows += int((ulps > 0).sum().item())
        t = g + r
        own = t - torch.where(t >= 0, 1.0, -1.0) * scale.float()
        if not bitwise_equal(new_r, own):
            raise AssertionError(f"onebit block {block}: r' is not "
                                 "t - sign * f32(scale)")
        err = max(err, (scale.float() - ps.float()).abs().max().item(),
                  (new_r - pr).abs().max().item())
        cases += 1
    if worst_ulp > 1:
        raise AssertionError(f"onebit scale {worst_ulp} bf16 ulps off")
    return {"phase": "kernel_check_onebit", "cases": cases,
            "packed": "bitwise", "residual_vs_own_scale": "bitwise",
            "scale_max_bf16_ulps": worst_ulp, "scale_rows_1ulp": off_rows,
            "max_abs_err_vs_plain": err,
            "tol": "packed exact; scale <= 1 bf16 ulp; r' exact vs own scale"}


# (block, k) of the adversarial top-k rows: both paths of the selection
TOPK_ADVERSARIAL = [(block, k) for block in (32, 64, 1024)
                    for k in sorted({1, 10, 32, 33, block}) if k <= block]
TOPK_ROW_KINDS = ("random", "all_equal", "all_zero", "fewer_than_k",
                  "signed_zeros", "nan_inf", "32_candidates", "33_candidates",
                  "small_ints")


def adversarial_rows(block, k, vec, seed):
    """(g, r) CUDA rows, one of each ``TOPK_ROW_KINDS``, for a kernel that
    reads ``vec`` columns a 16-byte vector (vector v in lane v % 32): 32
    and 33 equal magnitudes above the rest, one a lane in turn, are the
    candidates of the fast path (32) and the general one (33); ties and
    fewer than k nonzeros take the general path.  r is 0.1 N(0, 1) on the
    random row and zero elsewhere."""
    rng = np.random.default_rng(seed)
    g = np.zeros((len(TOPK_ROW_KINDS), block), np.float32)
    r = np.zeros_like(g)
    g[0] = rng.standard_normal(block)
    r[0] = 0.1 * rng.standard_normal(block)
    g[1] = 0.75 * rng.choice([-1.0, 1.0], block)
    g[3, rng.choice(block, size=k - 1, replace=False)] = \
        rng.standard_normal(k - 1)
    g[4] = rng.choice([-0.0, 0.0], block)
    g[4, rng.choice(block, size=3, replace=False)] = [1.5, -1.5, 0.25]
    g[5] = rng.standard_normal(block)
    g[5, rng.choice(block, size=6, replace=False)] = [
        np.nan, -np.nan, np.inf, -np.inf, np.inf, np.nan]
    lanes = min(32, block // vec)
    for row, n in ((6, 32), (7, 33)):
        g[row] = rng.uniform(-1.0, 1.0, block)
        for i in range(min(n, block)):
            lane, j = i % lanes, i // lanes
            g[row, vec * lane + 32 * vec * (j // vec) + j % vec] = \
                rng.choice([-4.0, 4.0])
    g[8] = rng.integers(-3, 4, block)
    return torch.from_numpy(g).to("cuda"), torch.from_numpy(r).to("cuda")


def sparse_rows(seed, nb, block, nnz):
    """(nb, block) f32 CUDA rows of nnz random nonzeros each: with nnz < k
    every row takes the top-k kernels' general path (its zeros tie)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.zeros(nb, block, device="cuda")
    cols = torch.randint(0, block, (nb, nnz), device="cuda", generator=gen)
    x.scatter_(1, cols, torch.randn(nb, nnz, device="cuda", generator=gen))
    return x


def encode_equal(tk, g, r, k, what):
    """The encode kernel against its plain version, bitwise."""
    got = tk.topk_encode_ef(g, r, k)
    want = tk.topk_encode_ef_plain(g, r, k)
    torch.cuda.synchronize()
    for name, a, b in zip(("vals", "idx", "r'"), got, want):
        if not bitwise_equal(a, b):
            raise AssertionError(f"topk_encode_ef {what}: {name} differ")


def check_topk(tk):
    """vals, idx and r' bitwise equal to the plain version's, on
    ``code_rows``, the adversarial rows and, at the timing size, rows that
    all take the general path (timed)."""
    cases = 0
    for block, k, nb in ((1024, 10, 5_003), (64, 5, 7_001)):
        g, r = code_rows(block + k, nb, block)
        encode_equal(tk, g, r, k, f"block {block} k {k}")
        cases += 1
    for block, k in TOPK_ADVERSARIAL:
        g, r = adversarial_rows(block, k, 4, 100 * block + k)
        encode_equal(tk, g, r, k, f"adversarial block {block} k {k}")
        cases += 1
    k, nb = 10, EMBED_ROWS // 4
    g = sparse_rows(41, nb, 1024, k // 2)
    r = torch.zeros_like(g)
    encode_equal(tk, g, r, k, "general path, timing size")
    ms = cuda_ms(lambda: tk.topk_encode_ef(g, r, k), 5, l2_flush())
    del g, r
    torch.cuda.empty_cache()
    return {"phase": "kernel_check_topk", "cases": cases + 1,
            "adversarial": {"block_k": TOPK_ADVERSARIAL,
                            "rows": TOPK_ROW_KINDS},
            "general_path": {"shape": [nb, 1024], "k": k,
                             "nonzeros_a_row": k // 2, "ms": ms},
            "vals_idx_residual": "bitwise", "max_abs_err_vs_plain": 0.0,
            "tol": "bitwise"}


def check_adam(fa):
    """rtol 1e-5, atol 1e-6: the JAX package's own kernel tolerance."""
    err, cases = 0.0, 0
    for n, dt in ((1_000_003, torch.float32), (65_537, torch.bfloat16)):
        gen = torch.Generator(device="cuda").manual_seed(n)
        p = torch.randn(n, device="cuda", generator=gen).to(dt)
        g = torch.randn(n, device="cuda", generator=gen)
        m = 0.1 * torch.randn(n, device="cuda", generator=gen)
        v = torch.rand(n, device="cuda", generator=gen)
        for t in (1, 7):
            tt = torch.tensor(float(t), device="cuda")
            consts = torch.stack([torch.tensor(1e-3, device="cuda"),
                                  1.0 - 0.9 ** tt, 1.0 - 0.999 ** tt])
            a = [x.clone() for x in (p, g, m, v)]
            b = [x.clone() for x in (p, g, m, v)]
            fa.fused_adam(a[0], a[1], a[2], a[3], consts)
            fa.fused_adam_plain(b[0], b[1], b[2], b[3], consts)
            torch.cuda.synchronize()
            for x, y in zip((a[0], a[2], a[3]), (b[0], b[2], b[3])):
                torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)
                err = max(err, (x.float() - y.float()).abs().max().item())
            cases += 1
    return {"phase": "kernel_check_adam", "cases": cases,
            "max_abs_err_vs_plain": err, "tol": "rtol 1e-5, atol 1e-6"}


def bf16_adam_err(a, b):
    """Fused Adam's outputs ``a = (p, m, v)`` held against the plain
    version's ``b`` with a bf16 p: m, v at check_adam's rtol 1e-5, atol
    1e-6; each element of p at most one bf16 ulp apart (both round an f32
    result to bf16; an f32 result one f32 ulp away can round the other
    way) or within atol 1e-6 where the two have opposite signs.  Returns
    (max |p - p_plain|, elements of p not bitwise equal)."""
    for x, y in zip(a[1:], b[1:]):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)
    pa, pb = a[0], b[0]
    ulps = (pa.view(torch.int16).int() - pb.view(torch.int16).int()).abs()
    diff = (pa.float() - pb.float()).abs()
    bad = ~((ulps <= 1) & (pa.signbit() == pb.signbit())) & (diff > 1e-6)
    if bool(bad.any()):
        raise AssertionError(
            f"fused_adam bf16 p: {int(bad.sum())} of {pa.numel()} elements "
            f"more than one bf16 ulp from the plain version (max |diff| "
            f"{diff.max().item()})")
    return diff.max().item(), int((ulps != 0).sum())


# ---------------------------------------------------------------------------
# the leaf-wise codec's kernels against their plain versions
# ---------------------------------------------------------------------------
EMBED_ROWS = (4 * 151936 * 1536) // 256  # qwen2-1.5b's stacked embedding
ONEBIT_SHAPES = [(1, 128), (17, 128), (64, 256), (4, 64),  # test_kernels.py
                 (9, 8), (5, 520), (3, 2048),  # any block % 8 == 0
                 (EMBED_ROWS, 256)]
TOPK_SHAPES = [(4, 128, 4), (37, 256, 8), (1, 64, 1), (8, 512, 32),
               (EMBED_ROWS // 4, 1024, 10)]


def card_rows(seed, nb, block):
    """(g, r) CUDA rows drawn on the card, the first ones ``code_rows``'s
    cases."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g = torch.randn(nb, block, device="cuda", generator=gen)
    r = 0.1 * torch.randn(nb, block, device="cuda", generator=gen)
    head = min(nb, 8)
    sg, sr = code_rows(seed, 8, block)
    g[:head], r[:head] = sg[:head], sr[:head]
    return g, r


def onebit_err(ob, g, r, what):
    """The unpacked kernel against its plain version: signs bitwise, the
    f32 scale within rtol 1e-6 (the f32 sum runs in another order), r'
    bitwise equal to t - sign * (the kernel's own scale).  Returns the
    largest |kernel - plain| over scale and r'."""
    sign, scale, new_r = ob.onebit_quant(g, r)
    ps, psc, pr = ob.onebit_quant_plain(g, r)
    torch.cuda.synchronize()
    if not bitwise_equal(sign, ps):
        raise AssertionError(f"onebit_quant {what}: signs differ")
    rel = ((scale - psc).abs() / psc.abs().clamp_min(1e-30)).max().item()
    if not rel <= 1e-6:
        raise AssertionError(f"onebit_quant {what}: scale rel err {rel}")
    own = (g + r) - sign.float() * scale
    if not bitwise_equal(new_r, own):
        raise AssertionError(f"onebit_quant {what}: r' is not "
                             "t - sign * scale")
    del own
    return max((scale - psc).abs().max().item(),
               (new_r - pr).abs().max().item()), rel


def topk_equal(tk, x, k, what):
    """The sparsify kernel against its plain version, bitwise."""
    got = tk.topk_sparsify(x, k)
    want = tk.topk_sparsify_plain(x, k)
    torch.cuda.synchronize()
    for name, a, b in zip(("vals", "idx", "dense"), got, want):
        if not bitwise_equal(a, b):
            raise AssertionError(f"topk_sparsify {what}: {name} differ")


def check_onebit_unpacked(ob):
    err, rel = 0.0, 0.0
    for nb, block in ONEBIT_SHAPES:
        g, r = card_rows(nb + block, nb, block)
        e, q = onebit_err(ob, g, r, f"({nb}, {block})")
        err, rel = max(err, e), max(rel, q)
        del g, r
    torch.cuda.empty_cache()
    return {"phase": "kernel_check_onebit_unpacked",
            "shapes": ONEBIT_SHAPES, "signs": "bitwise",
            "residual_vs_own_scale": "bitwise", "scale_max_rel_err": rel,
            "max_abs_err_vs_plain": err,
            "tol": "signs exact; scale rtol 1e-6; r' exact vs own scale"}


def check_topk_sparsify(tk):
    """vals, idx and dense bitwise equal to the plain version's, f32 and
    bf16, on ``TOPK_SHAPES``, the adversarial rows and, at the timing size
    in f32, rows that all take the general path (timed)."""
    for nb, block, k in TOPK_SHAPES:
        g, _ = card_rows(nb + block + k, nb, block)
        for dt in (torch.float32, torch.bfloat16):
            topk_equal(tk, g.to(dt), k, f"({nb}, {block}) k {k} {dt}")
        del g
    for block, k in TOPK_ADVERSARIAL:
        for dt, vec in ((torch.float32, 4), (torch.bfloat16, 8)):
            g, _ = adversarial_rows(block, k, vec, 100 * block + k + vec)
            topk_equal(tk, g.to(dt), k, f"adversarial block {block} k {k} "
                                        f"{dt}")
    k, nb = 10, EMBED_ROWS // 4
    x = sparse_rows(43, nb, 1024, k // 2)
    topk_equal(tk, x, k, "general path, timing size")
    ms = cuda_ms(lambda: tk.topk_sparsify(x, k), 5, l2_flush())
    del x
    torch.cuda.empty_cache()
    return {"phase": "kernel_check_topk_sparsify", "shapes": TOPK_SHAPES,
            "dtypes": ["float32", "bfloat16"],
            "adversarial": {"block_k": TOPK_ADVERSARIAL,
                            "rows": TOPK_ROW_KINDS},
            "general_path": {"shape": [nb, 1024], "k": k,
                             "nonzeros_a_row": k // 2, "dtype": "float32",
                             "ms": ms},
            "vals_idx_dense": "bitwise", "max_abs_err_vs_plain": 0.0,
            "tol": "bitwise"}


@contextlib.contextmanager
def plain_codec(ob, tk):
    """``ops.onebit_quant`` and ``ops.topk_sparsify`` pick their kernel
    module's attribute at call time: here that is the plain version, so
    the codec runs plain on CUDA tensors (and counts no launch)."""
    saved = ob.onebit_quant, tk.topk_sparsify
    ob.onebit_quant, tk.topk_sparsify = ob.onebit_quant_plain, \
        tk.topk_sparsify_plain
    try:
        yield
    finally:
        ob.onebit_quant, tk.topk_sparsify = saved


def codec_path(ob, tk, get_config, smi):
    """``ef_compress_tree`` and ``dgc_compress_tree`` with 1-bit and top-k
    on qwen2-1.5b's stacked gradient tree at full width (4 layers, W = 4,
    one backward of a seeded model on seeded tokens): one launch a leaf,
    the outputs held leaf by leaf against the codec run plain on the same
    CUDA tensors."""
    from repro_torch.core import compression as C
    from repro_torch.core import tree as TT
    from repro_torch.core.comm import LocalComm
    from repro_torch.data.pipeline import DataConfig, worker_batches
    from repro_torch.models import transformer as T
    from repro_torch.train.loop import _replica_grads, make_loss_fn

    cfg = dataclasses.replace(get_config("qwen2-1.5b"),
                              num_layers=TRAIN_LAYERS)
    comm = LocalComm(TRAIN_W)
    params = comm.replicate(T.init_model(
        torch.Generator(device="cuda").manual_seed(21), cfg, device="cuda"))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_L,
                      batch_per_worker=TRAIN_B, seed=21)
    loss_fn = make_loss_fn(cfg, remat=False)
    _, grads = _replica_grads(
        lambda p, x: loss_fn(p, {"tokens": x, "labels": x}), params,
        worker_batches(dcfg, TRAIN_W, 0, device="cuda"))
    del params
    n_leaves = len(TT.leaves(grads))
    comps = {"onebit": C.get_compressor("onebit"),
             "topk": C.get_compressor("topk", ratio=0.01)}
    counts = {"onebit_quant": ob.onebit_quant, "topk_sparsify": tk.topk_sparsify}
    for fn in counts.values():
        fn.launches = 0
    torch.cuda.synchronize()
    rec, state = {}, {}
    t0 = time.perf_counter()

    def held(what, name, call, plain_leaf, target, keep=None):
        """Run ``call()`` (one tree call of the codec, counting its
        launches), then hold each output leaf against ``plain_leaf(i)``
        (the codec run plain on leaf i alone), freeing the kernel's
        leaves as it goes but output ``keep``'s.  Top-k: every output
        bitwise.  1-bit: g_hat = ±scale with the signs bitwise and each
        element at rtol 1e-6 (the f32 scale's sum order), the residual
        (the last output) bitwise against ``target(i)`` − g_hat with the
        kernel's own g_hat, any other output (DGC's velocity) bitwise.
        Records the launches and the largest |kernel − plain|; returns
        the outputs' leaves."""
        before = {k: fn.launches for k, fn in counts.items()}
        outs = [TT.leaves(t) for t in call()]
        torch.cuda.synchronize()
        launched = {k: fn.launches - before[k] for k, fn in counts.items()}
        err = 0.0
        for i in range(n_leaves):
            got = [o[i] for o in outs]
            want = [TT.leaves(w)[0] for w in plain_leaf(i)]
            if name == "topk":
                exact = list(zip(got, want))
            else:
                a, b = got[0], want[0]
                if not torch.equal(torch.signbit(a), torch.signbit(b)):
                    raise AssertionError(f"{what}: leaf {i} signs differ")
                if not bool(((a - b).abs() <= 1e-6 * b.abs()).all()):
                    raise AssertionError(f"{what}: leaf {i} g_hat beyond "
                                         "rtol 1e-6 of the plain one")
                exact = ([(got[-1], target(i) - a.float())]
                         + list(zip(got[1:-1], want[1:-1])))
            for a, b in exact:
                if not bitwise_equal(a, b):
                    raise AssertionError(f"{what}: leaf {i} differs")
            err = max([err] + [(a.float() - b.float()).abs().max().item()
                               for a, b in zip(got, want)])
            del got, want, exact
            for j, leaves in enumerate(outs):
                if j != keep:
                    leaves[i] = None
        rec[what] = {"launches": launched, "max_abs_err_vs_plain": err}
        return outs

    def one(tree, i):
        return {"x": TT.leaves(tree)[i]}

    for name, comp in comps.items():
        zeros = C.ef_init(grads)

        def plain_ef(i, comp=comp):
            with plain_codec(ob, tk):
                return C.ef_compress_tree(comp, one(grads, i), one(zeros, i))

        def ef_target(i, zeros=zeros):
            return TT.leaves(grads)[i].float() + TT.leaves(zeros)[i]

        outs = held(f"ef_{name}", name,
                    lambda: C.ef_compress_tree(comp, grads, zeros), plain_ef,
                    ef_target, keep=1)
        state[name] = {"x": outs[1]}  # the new residuals, as a tree
        del outs, zeros, plain_ef, ef_target
    # DGC from a nonzero state: the two residuals just made
    dgc_state = {"velocity": state.pop("onebit"), "residual": state.pop("topk")}

    def dgc_target(i):  # r + u1, u1 = 0.9 u + g, as dgc_compress_tree
        u1 = 0.9 * TT.leaves(dgc_state["velocity"])[i] \
            + TT.leaves(grads)[i].float()
        return u1 + TT.leaves(dgc_state["residual"])[i]

    for name, comp in comps.items():
        def plain_dgc(i, comp=comp):
            with plain_codec(ob, tk):
                g_hat, new = C.dgc_compress_tree(comp, one(grads, i), {
                    k: one(v, i) for k, v in dgc_state.items()})
            return g_hat, new["velocity"], new["residual"]

        def call(comp=comp):
            g_hat, new = C.dgc_compress_tree(comp, grads, dgc_state)
            return g_hat, new["velocity"], new["residual"]

        held(f"dgc_{name}", name, call, plain_dgc, dgc_target)
    wall = time.perf_counter() - t0
    for what, r in rec.items():
        kernel = "onebit_quant" if what.endswith("onebit") else "topk_sparsify"
        want = {k: n_leaves if k == kernel else 0 for k in counts}
        if r["launches"] != want:
            raise AssertionError(f"codec {what}: launches {r['launches']}, "
                                 f"expected {want}")
    launches = {k: fn.launches for k, fn in counts.items()}
    del grads, dgc_state
    torch.cuda.empty_cache()
    return {"phase": "codec_path", "arch": cfg.name, "layers": TRAIN_LAYERS,
            "workers": TRAIN_W, "n_leaves": n_leaves, "calls": rec,
            "launches": launches, "wall_s": wall,
            "tol": "top-k bitwise; 1-bit g_hat signs bitwise and each "
                   "element at rtol 1e-6 (the f32 scale's sum order), the "
                   "residual bitwise against t - g_hat, DGC's velocity "
                   "bitwise",
            "card": smi}


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
# TRAIN_STEPS: 8 (10 until PR 28; local_sgd averages at step 7)
TRAIN_W, TRAIN_B, TRAIN_L, TRAIN_LAYERS, TRAIN_STEPS = 4, 4, 64, 4, 8


ZERO_STRATEGIES = ("sync_zero1", "sync_zero2", "sync_zero3")


def meta_partition(get_config, layers, w=TRAIN_W, arch="qwen2-1.5b",
                   cfg_over=None):
    """The ``PartitionedLayout`` of the stacked ``arch`` cut at full width
    (``cfg_over``: more config fields), built over meta tensors: shapes
    only, nothing allocated."""
    from repro_torch.core.comm import LocalComm
    from repro_torch.core.fabric import Fabric
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config(arch), num_layers=layers,
                              **(cfg_over or {}))
    comm = LocalComm(w)
    return Fabric(comm).partitioned_layout(comm.replicate(
        T.init_model(torch.Generator(), cfg, device="meta")))


def zero2_wire(flat, accum):
    """(wire bytes, comm events) of a ZeRO-2 boundary, in the train step's
    f32 order: the all-gather half plus the sum of ``accum``
    reduce-scatter halves."""
    half = np.float32(flat / 2)
    rs = np.float32(0.0)
    for _ in range(accum):
        rs = np.float32(rs + half)
    return float(np.float32(half + rs)), float(accum + 1)


# comm_events a step under the CLI's defaults (local_sgd averages every 8
# steps, easgd every 4, gossip mixes both ways every step, downpour pushes
# one replica in 4 a step)
def events_closed_form(strategy, t, workers=TRAIN_W):
    if strategy in ("local_sgd", "easgd"):
        return float((t + 1) % {"local_sgd": 8, "easgd": 4}[strategy] == 0)
    if strategy == "gossip":
        return 2.0
    if strategy == "downpour":
        return sum((t + w) % 4 == 0 for w in range(workers)) / workers
    return 1.0


def mamba_layers(cfg):
    """Mamba layers of a config's stack: one scan launch each a forward."""
    specs, repeat = cfg.superblock()
    return sum(s.mixer == "mamba" for s in specs) * repeat


def train_path(kernels, get_config, smi, strategy="sync", compressor="none",
               layers=TRAIN_LAYERS, precision="f32", accum=1, depth=2,
               steps=TRAIN_STEPS, phase=None, profile=True,
               arch="qwen2-1.5b", workers=TRAIN_W, batch=TRAIN_B,
               seq_len=TRAIN_L, optimizer="adam", cfg_over=None):
    """The trainer CLI's body on ``arch`` at full width, depth cut
    (``cfg_over``: more config fields), on the card: each kernel's launch
    count set to 0 just before and read just after.  Under the ZeRO
    strategies ``fused_adam`` runs once a shard bucket, on ``(W, chunk)``
    buckets.  A Mamba layer launches ``mamba_scan`` and ``mamba_scan_bwd``
    once a replica a step (the CLI trains without remat).  Returns (result, the profiled last step's summary or None)."""
    from repro_torch.core.comm import LocalComm
    from repro_torch.core.compression import get_compressor
    from repro_torch.core.fabric import Fabric
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_adam import fused_adam_plain as fa_plain
    from repro_torch.launch import train as CLI

    phase = phase or (f"train_{compressor}" if strategy == "sync" else
                      f"train_{strategy}")
    argv = ["--arch", arch, "--strategy", strategy, "--compressor",
            compressor, "--fused-adam", "--workers", str(workers),
            "--batch-per-worker", str(batch), "--seq-len", str(seq_len),
            "--steps", str(steps), "--log-every", "1",
            "--precision", precision, "--accum-steps", str(accum),
            "--prefetch-depth", str(depth), "--optimizer", optimizer,
            "--device", "cuda"]
    args = CLI.build_argparser().parse_args(argv)
    cfg = dataclasses.replace(get_config(arch), num_layers=layers,
                              **(cfg_over or {}))
    zero = strategy in ZERO_STRATEGIES
    play = meta_partition(get_config, layers, w=workers, arch=arch,
                          cfg_over=cfg_over)
    comp = None if compressor == "none" else (
        get_compressor("topk", ratio=0.01) if compressor == "topk"
        else get_compressor(compressor))
    rec = {"ms": [], "loss": [], "div": [], "wire": [], "events": [],
           "peak": [], "scale": [], "overflow": []}
    prof = {}
    mark = {}  # the host clock where the next step's time starts

    def on_step(t, state, m):
        torch.cuda.synchronize()
        if mark:  # step 0 also builds the state: not timed
            rec["ms"].append(1e3 * (time.perf_counter() - mark["t"]))
        rec["peak"].append(max(torch.cuda.max_memory_allocated() / 1e9,
                               leaf.pop("peak_before", 0.0)))
        torch.cuda.reset_peak_memory_stats()
        rec["loss"].append(float(m["loss"]))
        rec["div"].append(float(m["replica_divergence"]))
        rec["wire"].append(m["wire_bytes"].item())
        rec["events"].append(m["comm_events"].item())
        rec["scale"].append(float(m["loss_scale"]) if "loss_scale" in m
                            else None)
        rec["overflow"].append(float(m.get("overflow", 0.0)))
        if t == 0:
            # the closed form: the f32 layout's bytes; a narrow wire halves
            # the uncompressed exchange, the compressors keep their format
            fab = Fabric(LocalComm(workers))
            lay = play.layout
            f32 = fab.wire_bytes(lay, comp) if comp else fab.flat_bytes(lay)
            narrow = Fabric(LocalComm(workers), wire_dtype=torch.bfloat16)
            params = state["params"]
            rec["lay"] = (lay.n_buckets, lay.n_leaves, f32,
                          f32 / 2 if precision != "f32" and comp is None
                          else f32,
                          narrow.flat_bytes(lay) if comp is None else None,
                          str(params["embed"].dtype) if isinstance(
                              params, dict) else
                          f"shard buckets {params[0].dtype}")
        if profile and t == steps - 2:  # the last step runs profiled
            prof["p"] = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof["p"].__enter__()
        if profile and t == steps - 1:
            prof["p"].__exit__(None, None, None)
        mark["t"] = time.perf_counter()

    adam_dtypes = set()  # the dtype of p at each fused_adam call
    adam_sizes = set()  # and its element count
    orig_adam = ops.fused_adam
    leaf = {}  # one real leaf of a bf16 p held against the plain version

    def adam_spy(p, g, m, v, consts, **k):
        adam_dtypes.add(str(p.dtype))
        adam_sizes.add(p.numel())
        if p.dtype != torch.bfloat16 or leaf \
                or not 2 ** 20 <= p.numel() <= 2 ** 28:
            return orig_adam(p, g, m, v, consts, **k)
        # the first leaf of 2^20 to 2^28 elements, in step 0 (untimed):
        # the plain version runs on clones of the kernel's own inputs
        leaf["peak_before"] = torch.cuda.max_memory_allocated() / 1e9
        want = [x.clone() for x in (p, m, v)]
        fa_plain(want[0], g, want[1], want[2], consts, **k)
        out = orig_adam(p, g, m, v, consts, **k)
        torch.cuda.synchronize()
        err, differ = bf16_adam_err((p, m, v), want)
        leaf.update(shape=list(p.shape), max_abs_err_p=err,
                    p_elements_not_bitwise=differ)
        del want
        torch.cuda.reset_peak_memory_stats()  # the clones are not the path's
        return out

    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = io.StringIO()
    ops.fused_adam = adam_spy
    try:
        with contextlib.redirect_stdout(out):
            CLI.train(args, cfg, on_step=on_step)
    finally:
        ops.fused_adam = orig_adam
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in kernels.items()}
    wall = time.perf_counter() - t0
    peak = max(rec["peak"] + [torch.cuda.max_memory_allocated() / 1e9])

    n_buckets, n_leaves, f32_send, per_send, narrow_flat, pdtype = rec["lay"]
    applied = [o == 0.0 for o in rec["overflow"]]
    expect = {"fused_adam": (n_buckets if zero else n_leaves) * sum(applied)
              if optimizer == "adam" else 0,
              "mamba_scan": mamba_layers(cfg) * workers * accum * steps,
              "mamba_scan_bwd": mamba_layers(cfg) * workers * accum * steps}
    shard_sizes = {workers * c for c in play.shard_sizes}
    if zero and adam_sizes != shard_sizes:
        raise AssertionError(f"{phase}: fused_adam ran on {adam_sizes} "
                             f"elements, not the shard buckets "
                             f"{shard_sizes}")
    if comp is not None:  # sync, sync_dgc, downpour: one encode a bucket
        expect["onebit_quant_packed" if compressor == "onebit"
               else "topk_encode_ef"] = n_buckets * sum(applied)
    for name, n in launches.items():
        if n != expect.get(name, 0):
            raise AssertionError(f"{phase}: {name} launched {n} times, "
                                 f"expected {expect.get(name, 0)}")
    master_dtype = "torch.bfloat16" if precision == "bf16-pure" \
        else "torch.float32"
    if launches["fused_adam"] and adam_dtypes != {master_dtype}:
        raise AssertionError(f"{phase}: fused_adam ran on p of "
                             f"{adam_dtypes}, expected {master_dtype}")
    if "torch.bfloat16" in adam_dtypes and "shape" not in leaf:
        raise AssertionError(f"{phase}: no bf16 leaf held against the "
                             f"plain fused Adam")
    if narrow_flat is not None and precision != "f32" \
            and per_send != narrow_flat:
        raise AssertionError(f"{phase}: the bf16 wire {narrow_flat} is not "
                             f"half the f32 wire {f32_send}")
    if not all(math.isfinite(x) for x in rec["loss"]):
        raise AssertionError(f"{phase}: loss {rec['loss']}")
    zero_div = range(steps) \
        if strategy in ("sync", "sync_dgc") + ZERO_STRATEGIES else \
        [t for t in range(steps) if strategy == "local_sgd"
         and events_closed_form(strategy, t)]
    if any(rec["div"][t] != 0.0 for t in zero_div):
        raise AssertionError(f"{phase}: replica divergence {rec['div']} "
                             f"(must be 0 at steps {list(zero_div)})")
    # a skipped boundary ships nothing
    events = [events_closed_form(strategy, t, workers) * float(applied[t])
              for t in range(steps)]
    wire_closed = [float(np.float32(per_send) * np.float32(e))
                   for e in events]
    if strategy == "sync_zero2" and accum > 1:
        # a reduce-scatter a microbatch, an all-gather a boundary (f32)
        wire2, events2 = zero2_wire(f32_send, accum)
        wire_closed, events = [wire2] * steps, [events2] * steps
    if rec["events"] != events or rec["wire"] != wire_closed:
        raise AssertionError(f"{phase}: wire_bytes {rec['wire']}, events "
                             f"{rec['events']} != closed form "
                             f"{wire_closed}, {events}")
    timed = rec["ms"][:-1] if profile else rec["ms"]  # steps 1 .. steps-1
    step_ms = statistics.median(timed)
    result = {
        "phase": phase, "strategy": strategy, "compressor": compressor,
        "arch": cfg.name, "layers": layers, "d_model": cfg.d_model,
        "precision": precision, "params_dtype": pdtype,
        "fused_adam_p_dtypes": sorted(adam_dtypes),
        "fused_adam_p_elements": sorted(adam_sizes),
        **({"fused_adam_bf16_leaf_vs_plain": leaf} if leaf else {}),
        "workers": workers, "batch_per_worker": batch,
        "seq_len": seq_len, "accum_steps": accum, "prefetch_depth": depth,
        "steps": steps, "optimizer": optimizer,
        "fused_adam": optimizer == "adam",
        "params_per_replica": cfg.param_count(),
        "n_buckets": n_buckets, "n_leaves": n_leaves,
        "launches": launches, "launches_expected": expect,
        "launches_per_step": {k: v / steps for k, v in launches.items()},
        "step_ms_median": step_ms,
        "step_ms_all": rec["ms"],
        "tokens_per_s": workers * batch * seq_len * accum
        / (step_ms / 1e3),
        "loss": rec["loss"], "loss_scale": rec["scale"],
        "overflow": rec["overflow"], "wire_bytes": rec["wire"][0],
        "wire_bytes_all": rec["wire"], "comm_events": rec["events"],
        "wire_bytes_closed_form": wire_closed,
        "wire_bytes_f32_closed_form": f32_send,
        "replica_divergence": rec["div"],
        "replica_divergence_max": max(rec["div"]),
        # ZeRO's params are one storage behind a broadcast view: 0 then
        # holds by construction and is no evidence of agreement
        "replica_divergence_by_construction": zero,
        "peak_mem_gb": peak, "peak_mem_gb_by_step": rec["peak"],
        "mem_before_gb": before, "wall_s": wall,
        "cli_lines": out.getvalue().splitlines()[:3], "card": smi,
    }
    summary = profile_summary(prof["p"], rec["ms"][-1], phase) \
        if profile else None
    return result, summary


def skip_step(get_config, kernels, smi, strategy="sync"):
    """One boundary forced to overflow on the card: qwen2-1.5b at full
    width, 2 layers, W = 2, ``--precision bf16 --accum-steps 2``, fused
    Adam, ``sync`` with 1-bit or ``sync_zero1`` (no compressor; the f32
    master shards ride ``opt_state``).  A good step, then a step whose
    loss is multiplied by inf (its gradients inf or nan), then a good one.
    The overflow step must leave params, master, m, v and the 1-bit
    residual ``torch.equal`` to their values before it, launch neither
    ``fused_adam`` nor the encode, ship nothing and halve the scale."""
    from repro_torch.core import tree as TT
    from repro_torch.core.comm import LocalComm
    from repro_torch.core.compression import get_compressor
    from repro_torch.core.precision import apply_policy, get_policy
    from repro_torch.core.strategies import sync, sync_zero1
    from repro_torch.data.pipeline import DataConfig, microbatch_stack
    from repro_torch.models import transformer as T
    from repro_torch.optim import adam, warmup_cosine
    from repro_torch.train.loop import (init_train_state, make_loss_fn,
                                        make_replica_train_step)

    w, accum = 2, 2
    pol = get_policy("bf16")
    cfg = apply_policy(dataclasses.replace(get_config("qwen2-1.5b"),
                                           num_layers=2), pol)
    comm = LocalComm(w)
    strat = sync(get_compressor("onebit"), policy=pol) \
        if strategy == "sync" else sync_zero1(policy=pol)
    opt = adam(warmup_cosine(1e-3, 1, 3), fused=True)
    lf = make_loss_fn(cfg, remat=False)
    boom = {"on": False}

    def loss_fn(p, x):
        loss = lf(p, {"tokens": x, "labels": x})
        return loss * math.inf if boom["on"] else loss

    params = comm.replicate(T.init_model(
        torch.Generator(device="cuda").manual_seed(5), cfg, device="cuda"))
    state = init_train_state(params, opt, strat, comm, policy=pol)
    del params
    step = make_replica_train_step(loss_fn, opt, strat, comm, policy=pol,
                                   accum_steps=accum)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_L,
                      batch_per_worker=TRAIN_B, seed=5)
    for fn in kernels.values():
        fn.launches = 0
    rec = []
    keys = [k for k in ("params", "master", "opt_state", "comm_state")
            if k in state]
    checked = {"state_keys": keys}
    for t in range(3):
        batch = microbatch_stack(dcfg, w, t, accum, device="cuda")
        if t == 1:
            snap = [x.clone() for x in TT.leaves({k: state[k]
                                                   for k in keys})]
            scale0 = state["loss_scale"]["scale"].item()
            before = {k: fn.launches for k, fn in kernels.items()}
        boom["on"] = t == 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        boom["on"] = False
        rec.append({"step": t, "ms": ms,
                    "loss": json_floats([float(m["loss"])])[0],
                    "loss_scale": float(m["loss_scale"]),
                    "overflow": float(m["overflow"]),
                    "wire_bytes": m["wire_bytes"].item(),
                    "comm_events": m["comm_events"].item(),
                    "launches": {k: fn.launches for k, fn in
                                 kernels.items()}})
        if t == 1:
            now = TT.leaves({k: state[k] for k in keys})
            checked.update({
                "untouched_bitwise": len(now) == len(snap) and all(
                    torch.equal(a, b) for a, b in zip(now, snap)),
                "leaves_compared": len(snap),
                "launches_moved": {k: fn.launches - before[k]
                                   for k, fn in kernels.items()},
                "scale_before": scale0,
                "scale_after": state["loss_scale"]["scale"].item(),
                "good_steps_after": int(state["loss_scale"]["good_steps"])})
            del snap, now
    overflow = [r["overflow"] for r in rec]
    if strategy == "sync_zero1" and ("master" in keys or set(
            state["opt_state"]) != {"opt", "master"}):
        raise AssertionError(f"skip_step {strategy}: the f32 master must "
                             f"ride opt_state, state keys {keys}")
    if overflow != [0.0, 1.0, 0.0] or not checked["untouched_bitwise"] \
            or any(checked["launches_moved"].values()) \
            or checked["scale_after"] != checked["scale_before"] / 2 \
            or checked["good_steps_after"] != 0 \
            or rec[1]["wire_bytes"] != 0.0 or rec[1]["comm_events"] != 0.0 \
            or rec[2]["launches"]["fused_adam"] \
            <= rec[1]["launches"]["fused_adam"]:
        raise AssertionError(f"skip_step {strategy}: {checked} {rec}")
    del state
    torch.cuda.empty_cache()
    return {"phase": "skip_step" if strategy == "sync"
            else "skip_step_zero1", "strategy": strategy, "arch": cfg.name,
            "layers": 2, "workers": w, "precision": "bf16",
            "accum_steps": accum,
            "compressor": "onebit" if strategy == "sync" else "none",
            "fused_adam": True,
            "forced": "loss times inf on step 1", **checked, "steps": rec,
            "card": smi}


def finite_read_cost(get_config, smi, steps=8):
    """What the skip-step's host read costs a step: ``train_bf16``'s
    configuration (``sync`` 1-bit, ``--accum-steps 2``, fused Adam) under
    the bf16 policy and under the same policy without loss scaling (no
    finite check, no read back, no skip), in turns, ``steps`` steps each;
    median step ms over steps 1 .. steps-1."""
    from repro_torch.core.comm import LocalComm
    from repro_torch.core.compression import get_compressor
    from repro_torch.core.precision import apply_policy, get_policy
    from repro_torch.core.strategies import sync
    from repro_torch.data.pipeline import DataConfig, microbatch_stack
    from repro_torch.models import transformer as T
    from repro_torch.optim import adam, warmup_cosine
    from repro_torch.train.loop import (init_train_state, make_loss_fn,
                                        make_replica_train_step)

    pols = {"bf16": get_policy("bf16"),
            "bf16_unscaled": dataclasses.replace(
                get_policy("bf16"), name="bf16-unscaled",
                init_loss_scale=1.0, dynamic_scale=False)}
    out = {"phase": "finite_read_cost", "layers": TRAIN_LAYERS,
           "workers": TRAIN_W, "accum_steps": 2, "steps": steps,
           "step_ms_median": {}, "card": smi}
    for name in ("bf16", "bf16_unscaled", "bf16_unscaled", "bf16"):
        pol = pols[name]
        cfg = apply_policy(dataclasses.replace(get_config("qwen2-1.5b"),
                                               num_layers=TRAIN_LAYERS), pol)
        comm = LocalComm(TRAIN_W)
        strat = sync(get_compressor("onebit"), policy=pol)
        opt = adam(warmup_cosine(1e-3, 1, steps), fused=True)
        lf = make_loss_fn(cfg, remat=False)
        state = init_train_state(comm.replicate(T.init_model(
            torch.Generator(device="cuda").manual_seed(0), cfg,
            device="cuda")), opt, strat, comm, policy=pol)
        step = make_replica_train_step(
            lambda p, x: lf(p, {"tokens": x, "labels": x}), opt, strat, comm,
            policy=pol, accum_steps=2)
        dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_L,
                          batch_per_worker=TRAIN_B, seed=0)
        times = []
        for t in range(steps):
            batch = microbatch_stack(dcfg, TRAIN_W, t, 2, device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            if not math.isfinite(float(m["loss"])):
                raise AssertionError(f"finite_read_cost {name}: loss "
                                     f"{float(m['loss'])}")
        out["step_ms_median"].setdefault(name, []).append(
            statistics.median(times[1:]))
        del state, step
        torch.cuda.empty_cache()
    return out


def train_remat(get_config, smi):
    """One replica's loss and gradient of qwen2-1.5b at full width, 4
    layers, f32, 8 x 2048 tokens, with ``make_loss_fn(cfg, remat=True)``
    and ``remat=False``: the gradients of remat must be ``torch.equal`` to
    those without, except on a leaf whose two runs without remat
    themselves differ (an atomic sum in the backward), where rtol 1e-5
    holds."""
    from repro_torch.core import tree as TT
    from repro_torch.models import transformer as T
    from repro_torch.train.loop import make_loss_fn

    cfg = dataclasses.replace(get_config("qwen2-1.5b"), num_layers=4)
    gen = torch.Generator(device="cuda").manual_seed(7)
    params = T.init_model(gen, cfg, device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (8, 2048), generator=gen,
                         device="cuda", dtype=torch.int32)
    batch = {"tokens": toks, "labels": toks}
    names = [".".join(map(str, k)) for k in _paths(params)]
    runs, first = [], None
    differ, nondet, worst = set(), set(), 0.0
    # without, with (cold and warm), without again: each run's gradients
    # are held against the first run's, then dropped
    for remat in (False, True, True, False):
        torch.cuda.empty_cache()
        leaves = [x.detach().requires_grad_() for x in TT.leaves(params)]
        p = TT.unflatten(TT.flatten(params)[1], leaves)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() / 1e9
        t0 = time.perf_counter()
        loss = make_loss_fn(cfg, remat=remat)(p, batch)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        runs.append({"remat": remat, "ms": 1e3 * (time.perf_counter() - t0),
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "peak_above_params_gb":
                         torch.cuda.max_memory_allocated() / 1e9 - base,
                     "loss": loss.item()})
        del loss, leaves, p
        if first is None:
            first = grads
            continue
        for name, a, b in zip(names, grads, first):
            if torch.equal(a, b):
                continue
            if remat:
                differ.add(name)
                worst = max(worst, ((a - b).abs().max()
                                    / b.abs().max().clamp_min(1e-30)).item())
            else:
                nondet.add(name)
        del grads
    bad = [n for n in differ if n not in nondet]
    if bad or worst > 1e-5:
        raise AssertionError(f"train_remat: {bad or sorted(differ)} differ "
                             f"(rel {worst}); reproducible without remat: "
                             f"{bad}")
    del first, params
    torch.cuda.empty_cache()
    return {"phase": "train_remat", "arch": cfg.name, "layers": 4,
            "d_model": cfg.d_model, "dtype": "float32", "tokens": [8, 2048],
            "runs": runs,
            "loss_equal": all(r["loss"] == runs[0]["loss"] for r in runs),
            "leaves": len(names), "leaves_not_bitwise": sorted(differ),
            "leaves_nondeterministic_without_remat": sorted(nondet),
            "max_rel_diff": worst, "card": smi}


def _paths(tree, prefix=()):
    """Key paths of ``tree``'s leaves, in ``core/tree.py``'s order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k],
                                                          prefix + (k,))]
    return [prefix]


def prefetch(kernels, get_config, smi):
    """``--prefetch-depth 1`` and ``2`` on the ``train_bf16``
    configuration (5 steps each, no profiler) and the host's time to draw
    one boundary's microbatches.  A third arm repeats ``train_bf16``'s own
    call (depth 2, TRAIN_STEPS steps, the last profiled) after the others: it
    tells a slower main-path median that comes from the call's settings
    from one that comes from its place in the process.  One turn of the
    three arms, for the run's time budget."""
    from repro_torch.data import pipeline as DP

    out = {"phase": "prefetch", "card": smi, "depths": {},
           "train_bf16_repeat": []}
    for depth in (1, 2, "main"):
        main = depth == "main"
        result, _ = train_path(kernels, get_config, smi, compressor="onebit",
                               precision="bf16", accum=2,
                               depth=2 if main else depth,
                               steps=TRAIN_STEPS if main else 5,
                               phase=f"prefetch_depth{depth}", profile=main)
        if main:
            out["train_bf16_repeat"].append(result["step_ms_all"])
        else:
            out["depths"].setdefault(str(depth), []).append(
                result["step_ms_median"])
        torch.cuda.empty_cache()
    cfg = get_config("qwen2-1.5b")
    dcfg = DP.DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_L,
                         batch_per_worker=TRAIN_B, seed=0)
    times = []
    for t in range(20):
        t0 = time.perf_counter()
        DP._host_stack(dcfg, TRAIN_W, t, 2)
        times.append(1e3 * (time.perf_counter() - t0))
    out["host_synth_ms_median"] = statistics.median(times)
    out["host_synth_shape"] = [2, TRAIN_W, TRAIN_B, TRAIN_L]
    return out


def zero_vs_sync(get_config, smi, steps=3):
    """``sync`` and ZeRO-1/2/3 through the trainer CLI's body on the
    training cut (qwen2-1.5b full width, 4 layers, W = 4, f32, fused
    Adam), ``steps`` steps from one seed.  At ``--accum-steps 1`` every
    leaf of the final params, and of m and v after ``unpartition``, must
    be ``torch.equal`` to ``sync``'s (the reference's contract: the
    reduce-scatter mean is the all-reduce's f32 reduction, Adam is
    elementwise).  Under ZeRO the W rows of the params (and of m and v
    after ``unpartition``) are one storage behind a broadcast view, so
    their equality holds by construction: it is recorded, and gated on
    ``sync``'s stacked copies only.  Each run's peak memory beside
    ``sync``'s.

    ZeRO-2 at ``--accum-steps 2`` against ``sync`` at 2 sums the same
    eight f32 terms a gradient element (W replicas × 2 microbatches) in
    another order: ZeRO-2 the microbatches' means, ``sync`` each
    replica's microbatches, then the mean.  Under ``--optimizer sgd``
    (``steps`` steps) the params must be within 2e-6, the reference's
    bound.  Under fused Adam, one boundary: each element's gradient, read
    from m = (1 - b1) g, must be within the two sums' rounding bound
    2 γ7 Σ|terms| / 8 (γ7 = 7u / (1 - 7u), u = 2^-24; Σ|terms| recorded
    from the replica gradients as ``sync`` accumulates them); and each
    param's difference must be Adam's own response to the two gradients,
    predicted in float64 from each run's m and v with the kernel's
    constants, within f32 rounding.  A control run of ZeRO-2 fed a
    doubled microbatch (the second microbatch replaced by the first)
    must fail the SGD param gate and the gradient gate."""
    from repro_torch.core import tree as TT
    from repro_torch.core.comm import LocalComm
    from repro_torch.core.fabric import Fabric
    from repro_torch.data import pipeline
    from repro_torch.kernels import ops
    from repro_torch.launch import train as CLI

    play = meta_partition(get_config, TRAIN_LAYERS)
    fab = Fabric(LocalComm(TRAIN_W))
    cfg = dataclasses.replace(get_config("qwen2-1.5b"),
                              num_layers=TRAIN_LAYERS)

    def run(strategy, accum, optimizer="adam", n_steps=steps,
            doubled=False, abs_sum=False):
        """Replica 0 of the final params, m and v, the peak GB and the
        losses; ``abs_sum``: Σ|terms| of each gradient element, summed
        over the replicas' microbatch gradients; ``doubled``: the second
        microbatch of each boundary replaced by the first."""
        args = CLI.build_argparser().parse_args([
            "--arch", "qwen2-1.5b", "--strategy", strategy, "--fused-adam",
            "--optimizer", optimizer,
            "--workers", str(TRAIN_W), "--batch-per-worker", str(TRAIN_B),
            "--seq-len", str(TRAIN_L), "--steps", str(n_steps),
            "--accum-steps", str(accum), "--log-every", "1",
            "--device", "cuda"])
        out = {"peak": [], "loss": [], "consts": []}

        def on_step(t, state, m):
            torch.cuda.synchronize()
            # the run's own peak: what the earlier runs keep is not its
            out["peak"].append(torch.cuda.max_memory_allocated() / 1e9
                               - before)
            out["loss"].append(float(m["loss"]))
            if t < n_steps - 1:
                return
            params, opt = state["params"], state["opt_state"]
            if isinstance(params, list):  # ZeRO-3's shard buckets
                params = fab.unpartition(params, play)
            trees = {"params": params}
            for key in ("m", "v") if optimizer == "adam" else ():
                trees[key] = opt[key] if strategy == "sync" \
                    else fab.unpartition(opt[key], play)
            leaves = [x for tree in trees.values() for x in TT.leaves(tree)]
            out["rows_equal"] = all(torch.equal(x[i], x[0]) for x in leaves
                                    for i in range(1, x.shape[0]))
            out["one_storage"] = all(x.stride()[0] == 0 for x in leaves)
            out["tree"] = {k: TT.tree_map(lambda x: x[0].clone(), tree)
                           for k, tree in trees.items()}

        orig_adam, orig_acc = ops.fused_adam, Fabric.accumulate
        orig_stack = pipeline._host_stack

        def adam_spy(p, g, m, v, consts, **k):
            if not out["consts"]:
                out["consts"] = consts.double().tolist()
                out["adam_kw"] = dict(k)
            return orig_adam(p, g, m, v, consts, **k)

        def acc_spy(self, acc, tree, lay, replica=None):
            if replica is not None:  # one replica's microbatch gradient
                xs = TT.leaves(tree)
                if "abs" not in out:
                    out["abs"] = [torch.zeros_like(x) for x in xs]
                for s, x in zip(out["abs"], xs):
                    s.add_(x.abs())
            return orig_acc(self, acc, tree, lay, replica=replica)

        def doubled_stack(*a):
            toks = orig_stack(*a)
            toks[1] = toks[0]
            return toks

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated() / 1e9
        t0 = time.perf_counter()
        ops.fused_adam = adam_spy
        if abs_sum:
            Fabric.accumulate = acc_spy
        if doubled:
            pipeline._host_stack = doubled_stack
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                CLI.train(args, cfg, on_step=on_step)
        finally:
            ops.fused_adam, Fabric.accumulate = orig_adam, orig_acc
            pipeline._host_stack = orig_stack
        torch.cuda.synchronize()
        out["wall_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        return out

    ref = run("sync", 1)
    result = {"phase": "zero_vs_sync", "arch": cfg.name,
              "layers": TRAIN_LAYERS, "workers": TRAIN_W, "steps": steps,
              "precision": "f32", "fused_adam": True,
              "peak_gb": {"sync": max(ref["peak"])},
              "loss": {"sync": ref["loss"]}, "bitwise": {},
              "sync_rows_equal": ref["rows_equal"]}
    if not ref["rows_equal"]:
        raise AssertionError(f"zero_vs_sync: sync's rows differ: {result}")
    names = [".".join(map(str, k)) for k in _paths(ref["tree"]["params"])]
    for strategy in ZERO_STRATEGIES:
        got = run(strategy, 1)
        result["peak_gb"][strategy] = max(got["peak"])
        result["loss"][strategy] = got["loss"]
        differ = [f"{key}.{name}" for key in ("params", "m", "v")
                  for name, a, b in zip(names,
                                        TT.leaves(got["tree"][key]),
                                        TT.leaves(ref["tree"][key]))
                  if not torch.equal(a, b)]
        result["bitwise"][strategy] = {
            "leaves_compared": 3 * len(names), "leaves_not_equal": differ,
            # W rows of one storage: equal by construction, not a check
            "rows_one_storage": got["one_storage"]}
        del got
        if differ:
            raise AssertionError(f"zero_vs_sync {strategy}: {result}")
    del ref
    result["accum2"] = zero2_accum_check(run, fab, play, steps)
    result["card"] = smi
    return result


def zero2_accum_check(run, fab, play, steps, tol=2e-6):
    """ZeRO-2 against ``sync`` at ``--accum-steps 2`` (``zero_vs_sync``'s
    docstring): SGD params within ``tol`` after ``steps`` steps; under
    fused Adam, after one boundary, the gradient gate and Adam's predicted
    response; a doubled-microbatch control that both SGD and the
    gradient gate must fail.  Returns the record; raises on a failure."""
    from repro_torch.core import tree as TT

    def worst(a, b, key):
        return max((x - y).abs().max().item() for x, y in zip(
            TT.leaves(a["tree"][key]), TT.leaves(b["tree"][key])))

    rec = {"tol": tol, "sgd": {}}
    ref = run("sync", 2, "sgd")
    for name, doubled in (("sync_zero2", False), ("control", True)):
        got = run("sync_zero2", 2, "sgd", doubled=doubled)
        rec["sgd"][name] = {"steps": steps,
                            "params_max_abs_diff": worst(got, ref, "params")}
        del got
    del ref
    if not (rec["sgd"]["sync_zero2"]["params_max_abs_diff"] <= tol
            < rec["sgd"]["control"]["params_max_abs_diff"]):
        raise AssertionError(f"zero_vs_sync accum 2 sgd: {rec}")

    ref = run("sync", 2, "adam", n_steps=1, abs_sum=True)
    u = 2.0 ** -24
    gamma7 = 7 * u / (1 - 7 * u)
    lr, bc1, bc2 = ref["consts"]
    b1 = ref["adam_kw"].get("b1", 0.9)
    eps = ref["adam_kw"].get("eps", 1e-8)
    # m = fl(c1 g) from m = 0, with c1 = 1 - b1 in f32 as the kernel has it
    c1 = float(np.float32(1) - np.float32(b1))
    n_terms = TRAIN_W * 2

    def update(m, v):
        """Adam's step in float64 from an f32 m and v."""
        m, v = m.double(), v.double()
        return lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)

    def ulp(x):
        """The f32 ulp of each element of ``x`` (float64)."""
        _, e = torch.frexp(x.float())
        return torch.ldexp(torch.ones_like(x, dtype=torch.float64),
                           (e - 24).clamp_min(-149))

    names = [".".join(map(str, k)) for k in _paths(ref["tree"]["params"])]

    def check(got):
        """Counts of the elements failing the gradient gate and Adam's
        predicted response, and the five largest param differences with
        their gradients, the gradients' rounding bound and the updates."""
        out = {"grad_gate_failures": 0, "update_rule_failures": 0,
               "params_above_tol": 0}
        cand = []
        for name, ps, pz, ms, mz, vs, vz, sa in zip(names, *(
                TT.leaves(r["tree"][k]) for k in ("params", "m", "v")
                for r in (ref, got)), ref["abs"]):
            # the gradient gate: |g_z - g_s| <= 2 γ7 Σ|terms|/8, read
            # through m = fl(c1 g) (its rounding: one ulp of the larger);
            # Σ|terms| was itself summed in f32 (8 terms: 1 + 2^-20)
            gbound = 2 * gamma7 * sa.double() / n_terms * (1 + 2.0 ** -20)
            dm = (mz.double() - ms.double()).abs()
            mbound = c1 * gbound + ulp(torch.maximum(ms.abs(), mz.abs()))
            out["grad_gate_failures"] += int((dm > mbound).sum())
            # Adam's response: the param difference is the difference of
            # the two updates, within the f32 rounding of p and of u
            us, uz = update(ms, vs), update(mz, vz)
            obs = pz.double() - ps.double()
            miss = (obs + (uz - us)).abs() - (
                ulp(torch.maximum(ps.abs(), pz.abs()))
                + 8 * ulp(torch.maximum(us.abs(), uz.abs())))
            out["update_rule_failures"] += int((miss > 0).sum())
            out["params_above_tol"] += int((obs.abs() > tol).sum())
            top = obs.abs().flatten().topk(min(5, obs.numel())).indices
            for i in top.tolist():
                f = lambda x: x.flatten()[i].item()  # noqa: E731
                cand.append({"leaf": name, "index": i, "dp": f(obs),
                             "dp_predicted": -(f(uz) - f(us)),
                             "g_sync": f(ms) / c1, "g_zero2": f(mz) / c1,
                             "g_rounding_bound": f(gbound),
                             "mean_abs_term": f(sa) / n_terms,
                             "u_sync": f(us), "u_zero2": f(uz)})
            del us, uz, obs, miss, dm, mbound, gbound
        for key in ("params", "m", "v"):
            out[f"{key}_max_abs_diff"] = worst(got, ref, key)
        out["worst"] = sorted(cand, key=lambda c: -abs(c["dp"]))[:5]
        return out

    rec["adam"] = {"boundaries": 1, "consts_lr_bc1_bc2": [lr, bc1, bc2],
                   "gamma7": gamma7}
    for name, doubled in (("sync_zero2", False), ("control", True)):
        got = run("sync_zero2", 2, "adam", n_steps=1, doubled=doubled)
        if got["consts"] != ref["consts"]:
            raise AssertionError(f"zero_vs_sync accum 2: Adam's constants "
                                 f"{got['consts']} != {ref['consts']}")
        rec["adam"][name] = check(got)
        del got
    del ref
    z, c = rec["adam"]["sync_zero2"], rec["adam"]["control"]
    if z["grad_gate_failures"] or z["update_rule_failures"] \
            or not c["grad_gate_failures"]:
        raise AssertionError(f"zero_vs_sync accum 2 adam: {rec}")
    return rec


def ckpt_resume(get_config, smi):
    """Checkpoints on the card, at ``qwen2-1.5b --reduced`` (saving is host
    zlib: a full-width state would measure the host for minutes), W = 2,
    fused Adam, under ``build/ckpt_resume/``:

    * for ZeRO-1 under ``bf16`` and ZeRO-3 in f32, six uninterrupted steps
      against three, ``checkpoint_tree`` saved, a fresh state,
      ``resume_auto`` and three more (one schedule of 6 steps): every leaf
      ``torch.equal`` (the loss scale is not checkpointed, by either
      package: its value must match, its growth streak restarts);
    * a ZeRO-1 ``bf16`` save at W = 4 restored with ``repartition=True``
      at W = 2: m, v and the master after ``unpartition`` ``torch.equal``;
    * the CLI with ``--ckpt-dir`` and then ``--resume auto``, which prints
      ``resumed from step 2``;
    * ``verify_checkpoint`` on every step written; the bytes written and
      the seconds to save and to restore."""
    import shutil

    from repro_torch import checkpoint as CK
    from repro_torch.core import tree as TT
    from repro_torch.core.comm import LocalComm
    from repro_torch.core.fabric import Fabric
    from repro_torch.core.precision import apply_policy, get_policy
    from repro_torch.core.strategies import get_strategy
    from repro_torch.data.pipeline import DataConfig, worker_batches
    from repro_torch.launch import train as CLI
    from repro_torch.models import transformer as T
    from repro_torch.optim import adam, warmup_cosine
    from repro_torch.train.loop import (init_train_state, make_loss_fn,
                                        make_replica_train_step)

    root = ROOT / "build" / "ckpt_resume"
    shutil.rmtree(root, ignore_errors=True)
    base = get_config("qwen2-1.5b").reduced()
    total = 6

    def fresh(stage, precision, w):
        pol = None if precision == "f32" else get_policy(precision)
        cfg = base if pol is None else apply_policy(base, pol)
        comm = LocalComm(w)
        strat = get_strategy(f"sync_zero{stage}", policy=pol)
        opt = adam(warmup_cosine(1e-3, 1, total), fused=True)
        lf = make_loss_fn(cfg, remat=False)
        params = comm.replicate(T.init_model(
            torch.Generator(device="cuda").manual_seed(21), cfg,
            device="cuda"))
        state = init_train_state(params, opt, strat, comm, policy=pol)
        step = make_replica_train_step(
            lambda p, x: lf(p, {"tokens": x, "labels": x}), opt, strat,
            comm, policy=pol)
        return state, strat, comm, pol, step

    dcfg = DataConfig(vocab_size=base.vocab_size, seq_len=64,
                      batch_per_worker=2, seed=21)

    def steps(state, step, t0, t1, w=2):
        for t in range(t0, t1):
            state, _ = step(state, worker_batches(dcfg, w, t,
                                                  device="cuda"))
        return state

    out = {"phase": "ckpt_resume", "arch": base.name, "workers": 2,
           "fused_adam": True, "steps": total, "resume": {}}
    for stage, precision in ((1, "bf16"), (3, "f32")):
        name = f"sync_zero{stage}"
        d = str(root / f"{name}_{precision}")
        state, _, _, _, step = fresh(stage, precision, 2)
        ref = steps(state, step, 0, total)
        state, strat, comm, pol, step = fresh(stage, precision, 2)
        state = steps(state, step, 0, total // 2)
        tree, kw = CLI.checkpoint_tree(state, strat, comm, pol)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fname = CK.save_checkpoint(d, total // 2, tree, **kw)
        save_s = time.perf_counter() - t0
        del state, tree
        state, strat, comm, pol, step = fresh(stage, precision, 2)
        t0 = time.perf_counter()
        k = CLI.resume_auto(d, state, strat, comm, pol, "cuda")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        state = steps(state, step, k, total)
        scale_equal = True
        if "loss_scale" in ref:
            scale_equal = torch.equal(state.pop("loss_scale")["scale"],
                                      ref.pop("loss_scale")["scale"])
        a, b = TT.leaves(state), TT.leaves(ref)
        equal = len(a) == len(b) and all(torch.equal(x, y)
                                         for x, y in zip(a, b))
        verify = CK.verify_checkpoint(d, total // 2)
        out["resume"][f"{name}_{precision}"] = {
            "restored_step": k, "leaves_compared": len(b),
            "bitwise": equal, "loss_scale_equal": scale_equal,
            "verify": verify, "bytes": os.path.getsize(fname),
            "save_s": save_s, "restore_s": restore_s}
        del state, ref
        if not (equal and scale_equal and verify is None
                and k == total // 2):
            raise AssertionError(f"ckpt_resume {name}: {out}")

    # re-shard: a ZeRO-1 bf16 save at W = 4, restored at W = 2
    d = str(root / "reshard")
    state4, strat4, comm4, pol, step4 = fresh(1, "bf16", 4)
    state4 = steps(state4, step4, 0, 2, w=4)
    tree, kw = CLI.checkpoint_tree(state4, strat4, comm4, pol)
    CK.save_checkpoint(d, 2, tree, **kw)
    state2, strat2, comm2, _, _ = fresh(1, "bf16", 2)
    template, _ = CLI.checkpoint_tree(state2, strat2, comm2, pol)
    t0 = time.perf_counter()
    got = CK.restore_checkpoint(d, 2, template, device="cuda",
                                repartition=True)
    torch.cuda.synchronize()
    reshard_s = time.perf_counter() - t0
    # f32 layouts (meta): the master and m, v are compared at full width
    fab4, fab2 = Fabric(comm4), Fabric(comm2)
    play4, play2 = (fab.partitioned_layout(TT.tree_map(
        lambda x: torch.empty(x.shape, device="meta"), st["params"]))
        for fab, st in ((fab4, state4), (fab2, state2)))
    pairs = {"m": (got["opt_state"]["opt"]["m"],
                   state4["opt_state"]["opt"]["m"]),
             "v": (got["opt_state"]["opt"]["v"],
                   state4["opt_state"]["opt"]["v"]),
             "master": (got["opt_state"]["master"],
                        state4["opt_state"]["master"])}
    reshard = {}
    for key, (new, old) in pairs.items():
        x, y = fab2.unpartition(new, play2), fab4.unpartition(old, play4)
        reshard[key] = all(torch.equal(a[0], b[0]) for a, b in
                           zip(TT.leaves(x), TT.leaves(y)))
    out["reshard_w4_to_w2"] = {"bitwise": reshard, "restore_s": reshard_s,
                               "shard_shapes_w2": [list(t.shape) for t in
                                                   pairs["m"][0]]}
    del state4, state2, got
    if not all(reshard.values()):
        raise AssertionError(f"ckpt_resume re-shard: {out}")

    # the CLI: --ckpt-dir, then --resume auto
    d = str(root / "cli")
    argv = ["--arch", "qwen2-1.5b", "--reduced", "--workers", "2",
            "--batch-per-worker", "2", "--seq-len", "64", "--log-every",
            "1", "--zero-stage", "1", "--precision", "bf16", "--fused-adam",
            "--device", "cuda", "--ckpt-dir", d]
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        CLI.main(argv + ["--steps", "2"])
        hist = CLI.main(argv + ["--steps", "4", "--resume", "auto"])
    lines = text.getvalue().splitlines()
    out["cli"] = {"resumed": [x for x in lines if x.startswith("resumed")],
                  "steps_after_resume": [h["step"] for h in hist],
                  "verify": {s: CK.verify_checkpoint(d, s) for s in (2, 4)},
                  "loss": [h["loss"] for h in hist]}
    if not any("resumed from step 2" in x for x in lines) \
            or out["cli"]["steps_after_resume"] != [2, 3] \
            or any(out["cli"]["verify"].values()) \
            or not all(math.isfinite(x) for x in out["cli"]["loss"]):
        raise AssertionError(f"ckpt_resume CLI: {out['cli']}")
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    out["card"] = smi
    return out


# ---------------------------------------------------------------------------
# the elastic fleet
# ---------------------------------------------------------------------------
FLEET_BOUNDARIES = 24  # edge_async_sim's chaos act
FLEET_PROFILED = 22  # a boundary at W = 4, every member in the sync tier


def elastic_loss(cfg):
    from repro_torch.train.loop import make_loss_fn

    lf = make_loss_fn(cfg, remat=False)
    return lambda p, x: lf(p, {"tokens": x, "labels": x})


def member_batches(dcfg, device):
    """``batch_fn`` of ``ElasticFleet``: each member's ``sample_batch``,
    keyed by its stable id."""
    from repro_torch.data.pipeline import sample_batch

    return lambda view, t: torch.stack([sample_batch(dcfg, w, t,
                                                     device=device)
                                        for w in view.members])


def fleet_logs_equal(a, b):
    """Every log field of two fleet histories but the loss."""
    def strip(logs):
        return [{k: v for k, v in lg.items() if k != "loss"} for lg in logs]
    return strip(a) == strip(b)


def zero_resize_check(live, state, sizes, w_new, owns):
    """Every shard leaf of the live resize ``torch.equal`` (on the host)
    to ``repartition_tree``'s numpy path, the function
    ``restore_checkpoint(repartition=True)`` applies, on host copies of
    the old state.  Returns (leaves compared, leaves not equal)."""
    from repro_torch.core import resharding as RS
    from repro_torch.core import tree as TT

    keys = ["opt_state"] + (["params"] if owns else [])
    n, differ = 0, []
    for key in keys:
        host = TT.tree_map(lambda x: x.cpu().numpy(), state[key])
        want = TT.leaves(RS.repartition_tree(host, sizes, w_new))
        del host
        for i, (x, y) in enumerate(zip(TT.leaves(live[key]), want)):
            n += 1
            if not torch.equal(x.cpu(), torch.from_numpy(y)):
                differ.append(f"{key}.{i}")
    return n, differ


def elastic_resize(get_config, smi, adam_kernel):
    """The live W 4 → 2 → 4 resize of ZeRO-1 and ZeRO-3 train states at
    full width (qwen2-1.5b, 4 layers, f32, fused Adam, 2 steps at W = 4):
    at each transition every shard leaf ``torch.equal`` to the numpy
    re-shard on host copies; ZeRO-3's ``gather_params`` at W = 2 equal to
    W = 4's; 2 steps at W = 2 with the step remade there, ``fused_adam``
    once a shard bucket on ``(2, chunk')`` buckets and the wire the
    closed form at W = 2; ZeRO-1's params one storage throughout.  On
    ``qwen2-1.5b --reduced``, the disk round trip as well: a save at
    W = 4 and ``restore(repartition=True)`` at W = 2 bitwise the live
    resize, with the seconds of each."""
    import shutil

    from repro_torch import checkpoint as CK
    from repro_torch.core import tree as TT
    from repro_torch.core.comm import LocalComm
    from repro_torch.core.fabric import Fabric
    from repro_torch.core.strategies import get_strategy
    from repro_torch.data.pipeline import DataConfig, worker_batches
    from repro_torch.kernels import ops
    from repro_torch.launch.elastic import FleetView, resize_state
    from repro_torch.models import transformer as T
    from repro_torch.optim import adam
    from repro_torch.train.loop import (init_train_state,
                                        make_replica_train_step)

    def zero_state(cfg, stage, dcfg, steps=2, w=TRAIN_W, seed=31):
        comm = LocalComm(w)
        strat = get_strategy(f"sync_zero{stage}")
        opt = adam(1e-3, fused=True)
        loss = elastic_loss(cfg)
        params = comm.replicate(T.init_model(
            torch.Generator(device="cuda").manual_seed(seed), cfg,
            device="cuda"))
        state = init_train_state(params, opt, strat, comm)
        del params
        step = make_replica_train_step(loss, opt, strat, comm)
        for t in range(steps):
            state, _ = step(state, worker_batches(dcfg, w, t,
                                                  device="cuda"))
        return state, strat, comm, opt, loss

    def new_bytes(live, state):
        """Bytes the resize wrote: every leaf of new storage."""
        olds = {x.untyped_storage().data_ptr() for x in TT.leaves(state)
                if isinstance(x, torch.Tensor)}
        return sum(x.numel() * x.element_size() for x in TT.leaves(live)
                   if isinstance(x, torch.Tensor)
                   and x.untyped_storage().data_ptr() not in olds)

    def timed_resize(state, vf, vt, strat):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        live = resize_state(state, vf, vt, strategy=strat)
        torch.cuda.synchronize()
        return live, time.perf_counter() - t0

    cfg = dataclasses.replace(get_config("qwen2-1.5b"),
                              num_layers=TRAIN_LAYERS)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_L,
                      batch_per_worker=TRAIN_B, seed=31)
    sizes = meta_partition(get_config, TRAIN_LAYERS).layout.bucket_sizes
    total = sum(sizes)
    v4, v2 = FleetView(0, (0, 1, 2, 3)), FleetView(1, (0, 1))
    v4b = FleetView(2, (0, 1, 2, 3))
    out = {"phase": "elastic_resize", "arch": cfg.name,
           "layers": TRAIN_LAYERS, "precision": "f32", "fused_adam": True,
           "elements": total, "stages": {}}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for stage in (1, 3):
        rec = {}
        state, strat, comm4, opt, loss = zero_state(cfg, stage, dcfg)
        owns = stage == 3
        full4 = strat.gather_params(state["params"], comm4) if owns \
            else None
        live, s = timed_resize(state, v4, v2, strat)
        n, differ = zero_resize_check(live, state, sizes, 2, owns)
        rec["w4_to_w2"] = {"s": s, "bytes_written": new_bytes(live, state),
                           "leaves_compared": n, "leaves_not_equal": differ}
        if owns:  # the layout was re-primed for W = 2
            full2 = strat.gather_params(live["params"], LocalComm(2))
            rec["gather_w2_equals_w4"] = all(
                torch.equal(a[0], b[0]) for a, b in
                zip(TT.leaves(full2), TT.leaves(full4)))
            del full2, full4
        del state
        # two steps at W = 2, the step remade for LocalComm(2)
        comm2 = LocalComm(2)
        step2 = make_replica_train_step(loss, opt, strat, comm2)
        sizes_seen = set()
        orig = ops.fused_adam

        def spy(p, g, m, v, consts, **k):
            sizes_seen.add(tuple(p.shape))
            return orig(p, g, m, v, consts, **k)

        adam_kernel.launches = 0
        ops.fused_adam = spy
        wires = []
        try:
            for t in (2, 3):
                live, m = step2(live, worker_batches(dcfg, 2, t,
                                                     device="cuda"))
                wires.append(m["wire_bytes"].item())
        finally:
            ops.fused_adam = orig
        torch.cuda.synchronize()
        launches = adam_kernel.launches
        shapes = {(2 * c,) for c in meta_partition(get_config, TRAIN_LAYERS,
                                                   w=2).shard_sizes}
        closed = float(np.float32(4.0 * total * 2))
        one_storage = None if owns else all(
            x.stride(0) == 0 for x in TT.leaves(live["params"]))
        rec["steps_w2"] = {"fused_adam_launches": launches,
                           "expected": len(sizes) * 2,
                           "fused_adam_shapes": sorted(sizes_seen),
                           "wire_bytes": wires,
                           "wire_bytes_closed_form": closed,
                           "params_one_storage": one_storage}
        stepped = live
        back, s = timed_resize(stepped, v2, v4b, strat)
        n, differ2 = zero_resize_check(back, stepped, sizes, 4, owns)
        rec["w2_to_w4"] = {"s": s, "bytes_written": new_bytes(back, stepped),
                           "leaves_compared": n, "leaves_not_equal": differ2}
        if not owns:
            rec["params_one_storage_after_w4"] = all(
                x.stride(0) == 0 for x in TT.leaves(back["params"]))
        del live, stepped, back
        torch.cuda.empty_cache()
        out["stages"][f"sync_zero{stage}"] = rec
        if differ or differ2 or launches != len(sizes) * 2 \
                or sizes_seen != shapes \
                or any(w != closed for w in wires) \
                or rec.get("gather_w2_equals_w4") is False \
                or one_storage is False \
                or rec.get("params_one_storage_after_w4") is False:
            raise AssertionError(f"elastic_resize sync_zero{stage}: {out}")
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9

    # the disk round trip on --reduced, beside the live resize
    root = ROOT / "build" / "elastic_resize"
    shutil.rmtree(root, ignore_errors=True)
    red = get_config("qwen2-1.5b").reduced()
    rdcfg = DataConfig(vocab_size=red.vocab_size, seq_len=64,
                       batch_per_worker=2, seed=32)
    out["reduced"] = {}
    for stage in (1, 3):
        owns = stage == 3
        state, strat, comm4, *_ = zero_state(red, stage, rdcfg, seed=32)
        full = strat.gather_params(state["params"], comm4) if owns \
            else state["params"]
        play = Fabric(comm4).partitioned_layout(full)

        def shard_tree(st):
            tree = {"opt_state": st["opt_state"]}
            if owns:
                tree["param_shards"] = st["params"]
            return tree

        d = str(root / f"sync_zero{stage}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fname = CK.save_checkpoint(d, 2, shard_tree(state),
                                   partition=play.spec())
        save_s = time.perf_counter() - t0
        live, resize_s = timed_resize(state, v4, v2, strat)
        fresh, *_ = zero_state(red, stage, rdcfg, steps=0, w=2, seed=32)
        template = TT.tree_map(torch.zeros_like, shard_tree(fresh))
        del fresh
        t0 = time.perf_counter()
        got = CK.restore_checkpoint(d, 2, template, device="cuda",
                                    repartition=True)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        a, b = TT.leaves(shard_tree(live)), TT.leaves(got)
        equal = len(a) == len(b) and all(torch.equal(x, y)
                                         for x, y in zip(a, b))
        out["reduced"][f"sync_zero{stage}"] = {
            "bitwise_live_vs_disk": equal, "leaves_compared": len(b),
            "resize_s": resize_s, "save_s": save_s, "restore_s": restore_s,
            "bytes_on_disk": os.path.getsize(fname)}
        del state, live, got, template
        if not equal:
            raise AssertionError(f"elastic_resize --reduced: {out}")
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    out["card"] = smi
    return out


def elastic_fleet(get_config, smi, adam_kernel):
    """``ElasticFleet`` at full width (qwen2-1.5b, 4 layers, W = 4, f32,
    ``adam(fused=True)``) for 24 boundaries of ``edge_async_sim``'s
    schedule (slowdown, flake, kill, restore, rejoin), ``resync_every=4``,
    ``StragglerPolicy(patience=2, recovery=2)``, ``FleetClock(4,
    jitter=0)``.  Gates: the log but the loss equals a CPU run of the same
    schedule on the example's tiny cut; ``fused_adam`` 14 a boundary; the
    wire ``flat_bytes`` at each boundary's W; the sync-tier rows of the
    members never demoted ``torch.equal`` at every boundary (a promoted
    member's row is recorded: the resync pulls its params, not its Adam
    moments, as in the reference); a resynced demoted row within 1e-6
    relative of the sync rows (bitwise when the sync count is a power of
    two); after the rejoin's resize the joiner's row equal to the sync
    rows; the kill's boundary committed on 3 rows.  Times each boundary,
    each resize and one profiled boundary."""
    from repro_torch.core import tree as TT
    from repro_torch.core.chaos import FleetClock
    from repro_torch.core.staleness import StragglerPolicy
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.examples.edge_async_sim import SCHEDULE, edge_config
    from repro_torch.launch.elastic import ElasticFleet
    from repro_torch.models import transformer as T
    from repro_torch.optim import adam

    def make(cfg, dcfg, dev, opt, seed):
        base = T.init_model(torch.Generator(device=dev).manual_seed(seed),
                            cfg, device=dev)
        return ElasticFleet(base, elastic_loss(cfg), opt, workers=TRAIN_W,
                            straggler_policy=StragglerPolicy(patience=2,
                                                             recovery=2),
                            resync_every=4, chaos=SCHEDULE,
                            clock=FleetClock(TRAIN_W, jitter=0.0, seed=0),
                            retries=2, backoff_s=1e-4)

    # the controller's decisions on the CPU, the example's tiny cut
    tiny = edge_config()
    tdcfg = DataConfig(vocab_size=tiny.vocab_size, seq_len=32,
                       batch_per_worker=4)
    cpu = make(tiny, tdcfg, "cpu", adam(3e-3), 0)
    cpu_logs = cpu.run(FLEET_BOUNDARIES, member_batches(tdcfg, "cpu"))
    del cpu

    cfg = dataclasses.replace(get_config("qwen2-1.5b"),
                              num_layers=TRAIN_LAYERS)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_L,
                      batch_per_worker=TRAIN_B, seed=0)
    n_leaves = meta_partition(get_config, TRAIN_LAYERS).layout.n_leaves
    total = meta_partition(get_config, TRAIN_LAYERS).layout.total_elements
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fleet = make(cfg, dcfg, "cuda", adam(1e-3, fused=True), 0)
    batch_fn = member_batches(dcfg, "cuda")

    def sync_ranks(view):
        return [i for i, w in enumerate(view.members)
                if w not in view.demoted]

    resizes = []
    orig_resize = fleet.resize

    def timed_resize(new_view):
        old = fleet.view
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        orig_resize(new_view)
        torch.cuda.synchronize()
        rec = {"t": fleet._t, "from": list(old.members),
               "to": list(new_view.members),
               "demoted": list(new_view.demoted),
               "ms": 1e3 * (time.perf_counter() - t0)}
        joiners = [new_view.rank_of(w) for w in new_view.members
                   if w not in old.members]
        if joiners:  # each joiner copied a sync row
            ranks = sync_ranks(new_view)
            rec["joiner_rows_equal_sync_rows"] = all(
                torch.equal(x[r], x[ranks[0]])
                for x in TT.leaves(fleet.state["params"]) for r in ranks)
            rec["demoted_rows_max_abs_diff"] = max(
                (float((x[d] - x[ranks[0]]).abs().max())
                 for x in TT.leaves(fleet.state["params"])
                 for d in range(len(new_view.members)) if d not in ranks),
                default=None)
        resizes.append(rec)

    fleet.resize = timed_resize
    adam_kernel.launches = 0
    rows, prof = [], None
    ever_demoted = set()  # a promoted member keeps its own Adam moments
    for i in range(FLEET_BOUNDARIES):
        if i == FLEET_PROFILED:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg = fleet.run_boundary(batch_fn)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        if prof is not None and i == FLEET_PROFILED:
            prof.__exit__(None, None, None)
        m, view = fleet.last_metrics, fleet.view
        ever_demoted |= set(view.demoted)
        ranks = sync_ranks(view)
        # the sync rows of members never demoted must agree bitwise; a
        # promoted row took its own Adam steps while demoted: recorded
        kept = [r for r in ranks if view.members[r] not in ever_demoted]
        params = TT.leaves(fleet.state["params"])
        row = {"t": lg["t"], "w": view.size, "demoted": len(view.demoted),
               "ms": ms, "loss": lg["loss"],
               "wire_bytes": m["wire_bytes"].item(),
               "wire_closed_form": float(np.float32(4.0 * total
                                                    * view.size)),
               "resync": m["resync"],
               "resized": any(r["t"] == lg["t"] and r["from"] != r["to"]
                              for r in resizes),
               "rows": params[0].shape[0],
               "sync_rows_equal": all(torch.equal(x[r], x[kept[0]])
                                      for x in params for r in kept[1:]),
               "promoted_rows_max_abs_diff": max(
                   (float((x[r] - x[kept[0]]).abs().max())
                    for x in params for r in ranks if r not in kept),
                   default=None)}
        if m["resync"] and view.demoted:
            # each resynced row against the sync row, element by element
            row.update(nsync=len(ranks), resync_rel=0.0, resync_within=True,
                       resync_bitwise=True)
            for x in params:
                s = x[ranks[0]]
                for d in set(range(view.size)) - set(ranks):
                    diff = (x[d] - s).abs()
                    row["resync_rel"] = max(row["resync_rel"], float(
                        (diff / s.abs().clamp_min(1e-30)).max()))
                    row["resync_within"] &= bool(
                        (diff <= 1e-6 * s.abs()).all())
                    row["resync_bitwise"] &= torch.equal(x[d], s)
        rows.append(row)
    launches = adam_kernel.launches
    peak = torch.cuda.max_memory_allocated() / 1e9
    logs = fleet.history
    del fleet
    torch.cuda.empty_cache()

    bad = []
    if not fleet_logs_equal(logs, cpu_logs):
        bad.append("log differs from the CPU run's")
    if launches != n_leaves * FLEET_BOUNDARIES:
        bad.append(f"fused_adam launched {launches}")
    for r in rows:
        if r["wire_bytes"] != r["wire_closed_form"]:
            bad.append(f"t {r['t']}: wire {r['wire_bytes']}")
        if not r["sync_rows_equal"]:
            bad.append(f"t {r['t']}: sync rows differ")
        if "nsync" in r and (not r["resync_within"] or (
                r["nsync"] & (r["nsync"] - 1) == 0
                and not r["resync_bitwise"])):
            bad.append(f"t {r['t']}: resynced row {r['resync_rel']}")
        if not math.isfinite(r["loss"]):
            bad.append(f"t {r['t']}: loss {r['loss']}")
    kill = [lg for lg in logs if "dropped" in lg]
    if len(kill) != 1 or kill[0]["size_after"] != 3 \
            or rows[kill[0]["t"]]["rows"] != 3:
        bad.append(f"the kill's boundary: {kill}")
    joins = [r for r in resizes if "joiner_rows_equal_sync_rows" in r]
    if len(joins) != 1 or not joins[0]["joiner_rows_equal_sync_rows"]:
        bad.append(f"the rejoin's resize: {joins}")
    result = {"phase": "elastic_fleet", "arch": cfg.name,
              "layers": TRAIN_LAYERS, "workers": TRAIN_W,
              "batch_per_worker": TRAIN_B, "seq_len": TRAIN_L,
              "precision": "f32", "fused_adam": True,
              "boundaries": FLEET_BOUNDARIES, "resync_every": 4,
              "schedule": SCHEDULE.spec(), "fused_adam_launches": launches,
              "fused_adam_expected": n_leaves * FLEET_BOUNDARIES,
              "log_equals_cpu_run": fleet_logs_equal(logs, cpu_logs),
              "final_epoch": logs[-1]["epoch_after"],
              "resizes": resizes, "boundaries_detail": rows,
              "peak_gb": peak, "card": smi}
    steady = [r for r in rows if not r["resized"]
              and r["t"] not in (0, FLEET_PROFILED)]
    for key, pick in (("w4_all_sync", lambda r: r["w"] == 4
                       and not r["demoted"]),
                      ("w4_one_demoted", lambda r: r["w"] == 4
                       and r["demoted"]),
                      ("w3", lambda r: r["w"] == 3)):
        got = [r["ms"] for r in steady if pick(r)]
        result[f"boundary_ms_median_{key}"] = (statistics.median(got)
                                               if got else None)
    for what, r in (("kill", [x for x in resizes if len(x["to"]) == 3]),
                    ("rejoin", joins)):
        result[f"resize_ms_{what}"] = r[0]["ms"] if r else None
    result["profile"] = profile_summary(
        prof, rows[FLEET_PROFILED]["ms"], "elastic_fleet")
    if bad:
        raise AssertionError(f"elastic_fleet: {bad}: {result}")
    return result


def elastic_vs_sync(get_config, smi, boundaries=3):
    """An ``ElasticFleet`` with no schedule (an all-ones mask,
    ``resync_every=2``, so one resync fires) and the trainer's ``sync``
    step from one seed on the same batches (``sample_batch`` rows =
    ``worker_batches``), qwen2-1.5b at full width cut to 2 layers, W = 4,
    ``adam(fused=True)``: every leaf of the params, m and v
    ``torch.equal`` after ``boundaries`` boundaries."""
    from repro_torch.core import strategies as ST
    from repro_torch.core import tree as TT
    from repro_torch.core.comm import LocalComm
    from repro_torch.data.pipeline import DataConfig, worker_batches
    from repro_torch.launch.elastic import ElasticFleet
    from repro_torch.models import transformer as T
    from repro_torch.optim import adam
    from repro_torch.train.loop import (init_train_state,
                                        make_replica_train_step)

    cfg = dataclasses.replace(get_config("qwen2-1.5b"), num_layers=2)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_L,
                      batch_per_worker=TRAIN_B, seed=5)
    loss = elastic_loss(cfg)
    opt = adam(1e-3, fused=True)
    base = T.init_model(torch.Generator(device="cuda").manual_seed(5), cfg,
                        device="cuda")
    comm = LocalComm(TRAIN_W)
    strat = ST.sync()
    ref = init_train_state(comm.replicate(base), opt, strat, comm)
    step = make_replica_train_step(loss, opt, strat, comm)
    fleet = ElasticFleet(base, loss, opt, workers=TRAIN_W, resync_every=2)
    del base
    batch_fn = member_batches(dcfg, "cuda")
    same_batches, resyncs, losses = True, [], []
    for t in range(boundaries):
        b = worker_batches(dcfg, TRAIN_W, t, device="cuda")
        same_batches &= torch.equal(b, batch_fn(fleet.view, t))
        ref, m = step(ref, b)
        lg = fleet.run_boundary(batch_fn)
        resyncs.append(fleet.last_metrics["resync"])
        losses.append((float(m["loss"]), lg["loss"]))
    trees = {"params": (fleet.state["params"], ref["params"]),
             "m": (fleet.state["opt_state"]["m"], ref["opt_state"]["m"]),
             "v": (fleet.state["opt_state"]["v"], ref["opt_state"]["v"])}
    differ = [f"{k}.{i}" for k, (a, b) in trees.items()
              for i, (x, y) in enumerate(zip(TT.leaves(a), TT.leaves(b)))
              if not torch.equal(x, y)]
    out = {"phase": "elastic_vs_sync", "arch": cfg.name, "layers": 2,
           "workers": TRAIN_W, "boundaries": boundaries,
           "resync_every": 2, "resyncs": resyncs, "fused_adam": True,
           "same_batches": same_batches,
           "leaves_compared": 3 * len(TT.leaves(ref["params"])),
           "leaves_not_equal": differ,
           "loss_sync_vs_fleet": losses, "card": smi}
    del fleet, ref, trees
    torch.cuda.empty_cache()
    if differ or not same_batches or sum(resyncs) != 1:
        raise AssertionError(f"elastic_vs_sync: {out}")
    return out


def elastic_side(get_config, dev):
    """``elastic_card_vs_cpu``'s run on ``dev``: the fleet's log and its
    seconds."""
    from repro_torch.core import tree as TT
    from repro_torch.core.chaos import FleetClock
    from repro_torch.core.staleness import StragglerPolicy
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.examples.edge_async_sim import SCHEDULE
    from repro_torch.launch.elastic import ElasticFleet
    from repro_torch.models import transformer as T
    from repro_torch.optim import adam

    cfg = dataclasses.replace(get_config("qwen2-1.5b").reduced(),
                              num_layers=2)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                      batch_per_worker=2, seed=7)
    base = T.init_model(torch.Generator().manual_seed(7), cfg, device="cpu")
    fleet = ElasticFleet(TT.tree_map(lambda x: x.to(dev), base),
                         elastic_loss(cfg), adam(3e-3, fused=True),
                         workers=TRAIN_W,
                         straggler_policy=StragglerPolicy(patience=2,
                                                          recovery=2),
                         resync_every=4, chaos=SCHEDULE,
                         clock=FleetClock(TRAIN_W, jitter=0.0, seed=0),
                         retries=2, backoff_s=1e-4)
    t0 = time.perf_counter()
    log = fleet.run(FLEET_BOUNDARIES, member_batches(dcfg, dev))
    return {"arch": cfg.name, "log": log, "s": time.perf_counter() - t0}


def elastic_card_vs_cpu(get_config, smi, cpu):
    """``edge_async_sim``'s schedule through ``ElasticFleet`` on a 2-layer
    cut at ``qwen2-1.5b --reduced``'s widths, on the card and on the CPU
    (``cpu``: ``elastic_side``'s CPU run, from the ``cpu_half`` worker),
    from one init: the logs but the loss equal, the losses within 1e-4."""
    card = elastic_side(get_config, "cuda")
    cuda, host = card["log"], cpu["log"]
    rel = max(rel_diff(a["loss"], b["loss"]) for a, b in zip(cuda, host))
    out = {"phase": "elastic_card_vs_cpu", "arch": card["arch"],
           "layers": 2, "workers": TRAIN_W, "boundaries": FLEET_BOUNDARIES,
           "tol_rel": 1e-4, "logs_equal": fleet_logs_equal(cuda, host),
           "loss_max_rel_diff": rel,
           "loss_cuda": [lg["loss"] for lg in cuda],
           "loss_cpu": [lg["loss"] for lg in host],
           "cuda_s": card["s"], "cpu_s": cpu["s"], "card": smi}
    torch.cuda.empty_cache()
    if not out["logs_equal"] or not rel <= 1e-4:
        raise AssertionError(f"elastic_card_vs_cpu: {out}")
    return out


def profile_summary(prof, step_ms, phase):
    """Device-busy share, kernels per step, the top device ops and the time
    of the port's kernels, from one profiled train step."""
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    ours = {name: sum(e.self_device_time_total for e in events
                      if name in e.key) / 1e3
            for name in ("onebit_quant_packed_kernel",
                         "topk_encode_ef_kernel", "fused_adam_kernel",
                         "mamba_scan_kernel", "mamba_scan_bwd_kernel")}
    return {"phase": "profile_train", "train_phase": phase,
            "step_ms_under_profiler": step_ms,
            "device_ms_per_step": dev_ms,
            "device_busy_share": dev_ms / step_ms if step_ms else None,
            "device_kernels_per_step": sum(e.count for e in events),
            "port_kernels_ms": ours,
            "top_device_ms": {e.key[:70]: e.self_device_time_total / 1e3
                              for e in top}}


def json_floats(xs):
    """Floats for a JSON line: a non-finite value (a skipped boundary's
    loss) as its name, which strict JSON has no number for."""
    return [x if math.isfinite(x) else str(x) for x in xs]


def rel_diff(a, b):
    return abs(a - b) / abs(b) if b else abs(a)


def card_vs_cpu_steps(get_config, cpu_init, strategy, compressor, w=2,
                      steps=3, precision="f32", accum=1, batch=2,
                      boom_step=None, devices=("cuda", "cpu")):
    """The same initial state and batches through the train step on the
    card and on the CPU: qwen2-1.5b at full width cut to 2 layers, fused
    Adam, TF32 off, the strategy and policy as the CLI builds them,
    ``accum`` microbatches of ``batch`` sequences a replica a step.  At
    ``boom_step`` the loss is multiplied by inf (a boundary that must be
    skipped).  ``cpu_init`` keeps the replicated f32 parameters on the
    CPU by W: one draw serves every case.  Returns {device: (losses,
    divergences, wire bytes, seconds, loss scales, overflows)} for each
    of ``devices``."""
    from repro_torch.core import tree as TT
    from repro_torch.core.comm import LocalComm
    from repro_torch.core.precision import (apply_policy, get_policy,
                                            torch_dtype)
    from repro_torch.data.pipeline import DataConfig, microbatch_stack
    from repro_torch.launch import train as CLI
    from repro_torch.models import transformer as T
    from repro_torch.optim import adam, warmup_cosine
    from repro_torch.train.loop import (init_train_state, make_loss_fn,
                                        make_replica_train_step)

    pol = get_policy(precision)
    pol = None if pol.is_noop else pol
    cfg = dataclasses.replace(get_config("qwen2-1.5b"), num_layers=2)
    if pol is not None:
        cfg = apply_policy(cfg, pol)
    comm = LocalComm(w)
    strat = CLI.strategy_from_args(CLI.build_argparser().parse_args(
        ["--strategy", strategy, "--compressor", compressor]), pol)
    opt = adam(warmup_cosine(1e-3, 1, steps), fused=True)
    lf = make_loss_fn(cfg, remat=False)
    boom = {"on": False}

    def loss_fn(p, x):
        loss = lf(p, {"tokens": x, "labels": x})
        return loss * math.inf if boom["on"] else loss

    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                      batch_per_worker=batch, seed=3)
    if w not in cpu_init:  # every case starts from the same f32 draw
        cpu_init[w] = comm.replicate(T.init_model(
            torch.Generator().manual_seed(3), dataclasses.replace(
                get_config("qwen2-1.5b"), num_layers=2), device="cpu"))
    # init_model draws in f32 and casts: a bf16 policy's params are the
    # f32 draw cast, bit for bit
    pdt = torch_dtype(cfg.param_dtype)
    params = TT.tree_map(lambda x: x.to(pdt) if x.is_floating_point()
                         else x, cpu_init[w])
    runs = {}
    for dev in devices:
        # a copy on both devices: the fused Adam updates in place
        state = init_train_state(TT.tree_map(
            lambda x, d=dev: x.to(d, copy=True), params), opt, strat, comm,
            policy=pol)
        step = make_replica_train_step(loss_fn, opt, strat, comm,
                                       policy=pol, accum_steps=accum)
        losses, divs, wires, scales, overflows = [], [], [], [], []
        t0 = time.perf_counter()
        for t in range(steps):
            mb = microbatch_stack(dcfg, w, t, accum, device=dev)
            boom["on"] = t == boom_step
            state, m = step(state, mb if accum > 1 else mb[0])
            boom["on"] = False
            losses.append(float(m["loss"]))
            divs.append(float(m["replica_divergence"]))
            wires.append(m["wire_bytes"].item())
            scales.append(float(m["loss_scale"]) if "loss_scale" in m
                          else None)
            overflows.append(float(m.get("overflow", 0.0)))
        runs[dev] = (losses, divs, wires, time.perf_counter() - t0, scales,
                     overflows)
        del state
        torch.cuda.empty_cache()
    return runs


# card against CPU: losses and divergences at 1e-4 relative, f32 and bf16.
# The bf16 case reads a loss after an applied update (step 2 after step 0,
# step 1 skipped): measured 4.0e-7 relative on an H100, one step's own
# change in loss 3.6e-4, so 1e-4 sees a wrong update and leaves 250x room
# for cuBLAS's and the CPU's bf16 products summing in other orders
CARD_VS_CPU_TOL = {"f32": 1e-4, "bf16": 1e-4}


# the two phases' cases: (strategy, compressor, options of
# ``card_vs_cpu_steps``)
CARD_VS_CPU_CASES = {
    "train_card_vs_cpu": [
        ("sync", "onebit", {}),
        ("sync", "none", {"accum": 2, "batch": 1, "steps": 2}),
        ("sync", "onebit", {"precision": "bf16", "accum": 2, "batch": 1,
                            "boom_step": 1})],
    "strategies_card_vs_cpu": [("downpour", "onebit", {}),
                               ("ssp", "none", {})]}
# threads of the worker that runs the card-vs-CPU phases' CPU side; the
# card's phases keep the rest of the host's 8 cores
CPU_HALF_THREADS = 6
# the worker's jobs in the order the card's phases read them: each
# card-vs-CPU phase's CPU side (the ``*_side`` functions on "cpu", and the
# train cases' CPU runs)
CPU_HALVES = ("card_vs_cpu", "dense_card_vs_cpu", "recurrent_card_vs_cpu",
              "moe_card_vs_cpu", "encdec_card_vs_cpu", "elastic_card_vs_cpu",
              "recurrent_train_card_vs_cpu", "train_card_vs_cpu",
              "strategies_card_vs_cpu")
CPU_HALF_DIR = ROOT / "build" / "cpu_half"


def cpu_side(phase, get_config, cpu_init):
    """The CPU side of one card-vs-CPU phase."""
    if phase in CARD_VS_CPU_CASES:
        return [card_vs_cpu_steps(get_config, cpu_init, strategy, compressor,
                                  devices=("cpu",), **kw)["cpu"]
                for strategy, compressor, kw in CARD_VS_CPU_CASES[phase]]
    side = {"card_vs_cpu": paged_side, "dense_card_vs_cpu": dense_side,
            "recurrent_card_vs_cpu": recurrent_side,
            "moe_card_vs_cpu": moe_side, "encdec_card_vs_cpu": encdec_side,
            "elastic_card_vs_cpu": elastic_side,
            "recurrent_train_card_vs_cpu": recurrent_train_side}[phase]
    return side(get_config, "cpu")


def cpu_half(results, threads, phases):
    """Run in a spawned worker while the card's phases run: the CPU side
    of every phase of ``phases`` in order, each saved under CPU_HALF_DIR
    and announced on ``results`` as ("ok", phase, path) as it is done, or
    ("error", phase, traceback).  It runs at the lowest priority, so the
    card's phases' host threads go first, and reaches no CUDA call (it
    would make the worker a context on the card)."""
    phase = None
    try:
        os.nice(19)
        sys.path.insert(0, str(ROOT / "src"))
        from repro_torch.configs import get_config

        torch.set_num_threads(threads)
        CPU_HALF_DIR.mkdir(parents=True, exist_ok=True)
        cpu_init = {}
        for phase in phases:
            path = CPU_HALF_DIR / f"{phase}.pt"
            torch.save(cpu_side(phase, get_config, cpu_init), path)
            results.put(("ok", phase, str(path)))
    except Exception:  # the parent raises it
        results.put(("error", phase, traceback.format_exc()))


class CpuHalves:
    """The ``cpu_half`` worker over ``phases`` (daemonic: it ends with this
    process) and its answers; ``emit`` marks each line it runs beside."""

    def __init__(self, phases=CPU_HALVES):
        ctx = multiprocessing.get_context("spawn")
        self.phases = tuple(phases)
        self.results = ctx.Queue()
        self.proc = ctx.Process(target=cpu_half,
                                args=(self.results, CPU_HALF_THREADS,
                                      self.phases),
                                daemon=True)
        self.proc.start()
        _CPU_WORKER["proc"] = self.proc
        self.paths = {}

    def get(self, phase):
        """``phase``'s CPU side, waiting for it; raises on the worker's
        error or if it died without it.  The worker is joined once its
        last job is read."""
        while phase not in self.paths:
            try:
                status, done, value = self.results.get(timeout=10)
            except queue.Empty:
                if not self.proc.is_alive():
                    raise RuntimeError(f"the CPU worker exited with code "
                                       f"{self.proc.exitcode} before "
                                       f"{phase}'s CPU side") from None
                continue
            if status != "ok":
                raise RuntimeError(f"the CPU worker failed in {done}:\n"
                                   f"{value}")
            self.paths[done] = value
        if phase == self.phases[-1]:
            self.proc.join(timeout=60)
        return torch.load(self.paths[phase], weights_only=False)


def train_card_vs_cpu(get_config, phase, cpu_init, cpu_runs):
    """The cases of ``CARD_VS_CPU_CASES[phase]`` on the card, from the
    parameters ``cpu_init`` keeps, against ``cpu_runs``, their CPU side
    (``cpu_half``'s).  Wire bytes, loss scales and skipped boundaries must
    be identical."""
    out = {"phase": phase, "arch": "qwen2-1.5b", "layers": 2, "workers": 2,
           "fused_adam": True, "tol_rel": CARD_VS_CPU_TOL,
           "cpu_side": f"a spawned worker, {CPU_HALF_THREADS} threads at "
                       "nice 19, beside the card's phases", "cases": {}}
    for (strategy, compressor, kw), cpu in zip(CARD_VS_CPU_CASES[phase],
                                               cpu_runs):
        cuda = card_vs_cpu_steps(get_config, cpu_init, strategy, compressor,
                                 devices=("cuda",), **kw)["cuda"]
        what = f"{strategy}+{compressor}" + "".join(
            f" {k}={v}" for k, v in kw.items())
        tol = CARD_VS_CPU_TOL[kw.get("precision", "f32").split("-")[0]]
        if cuda[2] != cpu[2] or cuda[4] != cpu[4] or cuda[5] != cpu[5]:
            raise AssertionError(
                f"card vs CPU {what}: wire_bytes {cuda[2]} vs {cpu[2]}, "
                f"loss scales {cuda[4]} vs {cpu[4]}, overflows {cuda[5]} "
                f"vs {cpu[5]}")
        rel = {}
        for i, name in ((0, "losses"), (1, "divergences")):
            # a skipped boundary's loss is inf on both devices
            if [math.isfinite(x) for x in cuda[i]] \
                    != [math.isfinite(x) for x in cpu[i]]:
                raise AssertionError(f"card vs CPU {what} {name} {cuda[i]} "
                                     f"vs {cpu[i]}: not finite alike")
            rel[name] = max(rel_diff(a, b) for a, b in zip(cuda[i], cpu[i])
                            if math.isfinite(b))
            if not rel[name] <= tol:
                raise AssertionError(f"card vs CPU {what} {name} {cuda[i]} "
                                     f"vs {cpu[i]}: rel {rel[name]} > {tol}")
        out["cases"][what] = {
            "steps": len(cuda[0]), "tol_rel": tol,
            "loss_cuda": json_floats(cuda[0]),
            "loss_cpu": json_floats(cpu[0]),
            "loss_max_rel_diff": rel["losses"],
            "divergence_cuda": cuda[1], "divergence_cpu": cpu[1],
            "divergence_max_rel_diff": rel["divergences"],
            "wire_bytes": cuda[2], "loss_scale": cuda[4],
            "overflow": cuda[5], "cpu_s": cpu[3], "cuda_s": cuda[3]}
    return out


def time_train_kernels(ob, tk, fa, launches, get_config, smi):
    """Each training kernel on the largest bucket of the path, the tied
    embedding of W replicas (W x 151936 x 1536 elements for qwen2-1.5b),
    against its bound, its plain version and one PyTorch call where one
    exists."""
    cfg = get_config("qwen2-1.5b")
    n = TRAIN_W * cfg.vocab_size * cfg.d_model
    flush = l2_flush()

    def bound(nbytes, ops):
        b, o = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
        return 1e3 * max(b, o), "bytes" if b >= o else "operations"

    out = {}
    saved = {k: fn.launches for k, fn in
             (("ob", ob.onebit_quant_packed), ("tk", tk.topk_encode_ef),
              ("fa", fa.fused_adam))}
    gen = torch.Generator(device="cuda").manual_seed(11)
    g = torch.randn(n, device="cuda", generator=gen)
    r = 0.1 * torch.randn(n, device="cuda", generator=gen)

    # onebit: rows of 256; per element read g, r, write r' (12 B) + 1/8 B
    # of signs, + 2 B of scale per row; ~6 f32 ops per element
    gb, rb = g.view(-1, 256), r.view(-1, 256)
    rows = gb.shape[0]
    ms = cuda_ms(lambda: ob.onebit_quant_packed(gb, rb), 10, flush)
    plain = cuda_ms(lambda: ob.onebit_quant_packed_plain(gb, rb), 3, flush)
    bms, by = bound(12 * n + n // 8 + 2 * rows, 6 * n)
    out["onebit_quant_packed"] = {
        "shape": [rows, 256], "ms": ms, "plain_ms": plain, "bound_ms": bms,
        "bound_by": by, "library_ms": None,
        "library_note": "no single PyTorch call packs signs with a scale"}

    # topk: rows of 1024, k 10; per element 12 B, per row 8k B; k rounds
    # of a compare and a select per element
    k = 10
    gb, rb = g.view(-1, 1024), r.view(-1, 1024)
    rows = gb.shape[0]
    ms = cuda_ms(lambda: tk.topk_encode_ef(gb, rb, k), 10, flush)
    plain = cuda_ms(lambda: tk.topk_encode_ef_plain(gb, rb, k), 2, flush)
    tb = gb + rb
    lib = cuda_ms(lambda: torch.topk(tb.abs(), k, dim=-1), 5, flush)
    del tb
    bms, by = bound(12 * n + 8 * k * rows, 2 * k * n + 2 * n)
    out["topk_encode_ef"] = {
        "shape": [rows, 1024], "k": k, "ms": ms, "plain_ms": plain,
        "bound_ms": bms, "bound_by": by, "library_ms": lib,
        "library_note": "torch.topk(t.abs(), k): selection only, no error "
                        "feedback"}
    del gb, rb

    # adam: read p, g, m, v, write p, m, v (28 B with f32 p); ~15 ops
    p = torch.randn(n, device="cuda", generator=gen)
    m = torch.zeros(n, device="cuda")
    v = torch.zeros(n, device="cuda")
    consts = torch.tensor([1e-3, 0.1, 1e-3], device="cuda")
    ms = cuda_ms(lambda: fa.fused_adam(p, g, m, v, consts), 10, flush)
    plain = cuda_ms(lambda: fa.fused_adam_plain(p, g, m, v, consts), 3,
                    flush)
    del m, v
    lp = torch.nn.Parameter(p)
    lp.grad = g
    lib_opt = torch.optim.Adam([lp], lr=1e-3, fused=True)
    lib = cuda_ms(lib_opt.step, 5, flush)
    del lib_opt, lp, p
    bms, by = bound(28 * n, 15 * n)
    out["fused_adam"] = {
        "shape": [n], "ms": ms, "plain_ms": plain, "bound_ms": bms,
        "bound_by": by, "library_ms": lib,
        "library_note": "torch.optim.Adam(fused=True).step() on one "
                        "parameter; never called by the port"}
    # the bf16-p instance (the bf16-pure path): p read and written at 2 B,
    # g, m, v f32: 24 B an element.  Held against its plain version first,
    # on the same inputs at this size (the kernel on clones, the plain
    # version in place), at step 7's bias corrections
    pb = torch.randn(n, device="cuda", generator=gen).to(torch.bfloat16)
    m = 0.1 * torch.randn(n, device="cuda", generator=gen)
    v = torch.rand(n, device="cuda", generator=gen)
    c7 = torch.tensor([1e-3, 1.0 - 0.9 ** 7, 1.0 - 0.999 ** 7],
                      device="cuda")
    got = [x.clone() for x in (pb, m, v)]
    fa.fused_adam(got[0], g, got[1], got[2], c7)
    fa.fused_adam_plain(pb, g, m, v, c7)
    torch.cuda.synchronize()
    p_err, p_differ = bf16_adam_err(got, (pb, m, v))
    del got
    ms = cuda_ms(lambda: fa.fused_adam(pb, g, m, v, consts), 10, flush)
    plain = cuda_ms(lambda: fa.fused_adam_plain(pb, g, m, v, consts), 3,
                    flush)
    del pb, m, v
    bms, by = bound(24 * n, 15 * n)
    bf16_row = {
        "max_abs_err_p": p_err, "p_elements_not_bitwise": p_differ,
        "tol": "m, v rtol 1e-5, atol 1e-6; p within one bf16 ulp",
        "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
        "library_ms": None,
        "library_note": "torch.optim.Adam keeps m and v in the param's "
                        "dtype: no single call computes f32 m, v on bf16 p"}
    out["fused_adam"]["bf16_p"] = bf16_row
    del g, r
    out["fused_adam"]["shard_bucket"] = time_shard_adam(fa, get_config,
                                                        flush, bound)
    torch.cuda.empty_cache()
    ob.onebit_quant_packed.launches = saved["ob"]
    tk.topk_encode_ef.launches = saved["tk"]
    fa.fused_adam.launches = saved["fa"]
    for name, rec in out.items():
        rec["launches"] = launches[name]
    return {"phase": "time_train_kernels", "elements": n, "kernels": out,
            "card": smi}


def time_shard_adam(fa, get_config, flush, bound):
    """``fused_adam`` as the ZeRO strategies launch it: on one shard bucket
    of the training path, the largest bucket's ``(W, chunk)`` flattened,
    f32 p (the master shards under ``bf16``).  Held against the plain
    version on the same inputs at step 7's bias corrections (rtol 1e-5,
    atol 1e-6, ``check_adam``'s), then timed against its bound (28 B an
    element), the plain version and ``torch.optim.Adam(fused=True)`` on the
    same elements."""
    play = meta_partition(get_config, TRAIN_LAYERS)
    b = max(range(len(play.shard_sizes)), key=lambda i: play.shard_sizes[i])
    shape = [TRAIN_W, play.shard_sizes[b]]
    n = shape[0] * shape[1]
    gen = torch.Generator(device="cuda").manual_seed(17)
    p = torch.randn(n, device="cuda", generator=gen)
    g = torch.randn(n, device="cuda", generator=gen)
    m = 0.1 * torch.randn(n, device="cuda", generator=gen)
    v = torch.rand(n, device="cuda", generator=gen)
    c7 = torch.tensor([1e-3, 1.0 - 0.9 ** 7, 1.0 - 0.999 ** 7],
                      device="cuda")
    got = [x.clone() for x in (p, m, v)]
    fa.fused_adam(got[0], g, got[1], got[2], c7)
    want = [x.clone() for x in (p, m, v)]
    fa.fused_adam_plain(want[0], g, want[1], want[2], c7)
    torch.cuda.synchronize()
    err = 0.0
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)
        err = max(err, (x - y).abs().max().item())
    del got, want
    ms = cuda_ms(lambda: fa.fused_adam(p, g, m, v, c7), 10, flush)
    plain = cuda_ms(lambda: fa.fused_adam_plain(p, g, m, v, c7), 3, flush)
    lp = torch.nn.Parameter(p)
    lp.grad = g
    lib_opt = torch.optim.Adam([lp], lr=1e-3, fused=True)
    lib = cuda_ms(lib_opt.step, 5, flush)
    del lib_opt, lp, p, g, m, v
    torch.cuda.empty_cache()
    bms, by = bound(28 * n, 15 * n)
    return {"bucket": b, "shape": shape, "elements": n,
            "max_abs_err_vs_plain": err, "tol": "rtol 1e-5, atol 1e-6",
            "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "library_ms": lib,
            "library_note": "torch.optim.Adam(fused=True).step() on the "
                            "same elements; never called by the port"}


def time_codec_kernels(ob, tk, launches, get_config, smi):
    """The leaf-wise codec's kernels on the largest leaf of the codec path,
    the stacked embedding (W x 151936 x 1536 = 933.5 M f32 elements for
    qwen2-1.5b), against their bounds, their plain versions and one
    PyTorch call where one exists; each held against the plain output on
    the timed inputs first."""
    cfg = get_config("qwen2-1.5b")
    n = TRAIN_W * cfg.vocab_size * cfg.d_model
    flush = l2_flush()

    def bound(nbytes, ops):
        b, o = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
        return 1e3 * max(b, o), "bytes" if b >= o else "operations"

    saved = ob.onebit_quant.launches, tk.topk_sparsify.launches
    out = {}
    g, r = card_rows(31, n // 256, 256)
    err, _ = onebit_err(ob, g, r, "timing inputs")
    # per element: read g, r, write r' (12 B) and an int8 sign (1 B); per
    # row a 4 B scale; ~6 f32 ops per element
    rows = g.shape[0]
    ms = cuda_ms(lambda: ob.onebit_quant(g, r), 10, flush)
    plain = cuda_ms(lambda: ob.onebit_quant_plain(g, r), 3, flush)
    bms, by = bound(13 * n + 4 * rows, 6 * n)
    out["onebit_quant"] = {
        "shape": [rows, 256], "ms": ms, "plain_ms": plain, "bound_ms": bms,
        "bound_by": by, "library_ms": None, "max_abs_err_vs_plain": err,
        "library_note": "no single PyTorch call gives sign, scale and "
                        "residual"}
    del r
    x = g.view(-1, 1024)
    k = 10
    topk_equal(tk, x, k, "timing inputs")
    # per element: read x, write dense (8 B); per row k f32 values and k
    # int32 indices; k rounds of a compare and a select per element
    rows = x.shape[0]
    ms = cuda_ms(lambda: tk.topk_sparsify(x, k), 10, flush)
    plain = cuda_ms(lambda: tk.topk_sparsify_plain(x, k), 2, flush)
    lib = cuda_ms(lambda: torch.topk(x.abs(), k, dim=-1), 5, flush)
    bms, by = bound(8 * n + 8 * k * rows, 2 * k * n + 2 * n)
    out["topk_sparsify"] = {
        "shape": [rows, 1024], "k": k, "ms": ms, "plain_ms": plain,
        "bound_ms": bms, "bound_by": by, "library_ms": lib,
        "library_note": "torch.topk(x.abs(), k): selection only, no dense "
                        "output"}
    del g, x
    torch.cuda.empty_cache()
    ob.onebit_quant.launches, tk.topk_sparsify.launches = saved
    for name, rec in out.items():
        rec["launches"] = launches[name]
    return {"phase": "time_codec_kernels", "elements": n, "kernels": out,
            "card": smi}


# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# the MoE families: granite-moe-1b-a400m and qwen2-moe-a2.7b
# ---------------------------------------------------------------------------
MOE_SPLIT = ("router_sort", "dispatch_scatter", "expert_matmuls",
             "combine_gather", "shared_experts", "rest")


def tree_bytes(tree):
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def decode_floor(params, cfg):
    """The bytes a decode step must read and their time at the HBM rate:
    every weight once, the padded experts included (the capacity dispatch
    runs every expert on its slots), less the embedding table when the
    head has its own (a step reads only its rows); the KV cache is left
    out."""
    nbytes = tree_bytes(params) - (0 if cfg.tie_embeddings else
                                   tree_bytes(params["embed"]))
    return {"weight_bytes_per_step": nbytes,
            "floor_ms_per_step": 1e3 * nbytes / HBM_BYTES_PER_S}


def moe_split(prof):
    """Device time of one profiled step by where each kernel was launched
    (the ranges ``moe_decode_profile`` wraps around the layer's
    functions): ``_route`` (router and sort), ``_moe_dense`` before its
    experts (dispatch scatter) and after them (combine gather),
    ``_expert_ffn`` (the expert matmuls), ``moe`` outside ``_moe_dense``
    (the shared experts), and everything else (attention, norms, head)."""
    split = dict.fromkeys(MOE_SPLIT, 0.0)
    kernels = 0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CPU or not ev.kernels:
            continue
        names, a = {}, ev
        while a is not None:
            names.setdefault(a.name, a)
            a = a.cpu_parent
        if "moe:router" in names:
            key = "router_sort"
        elif "moe:experts" in names:
            key = "expert_matmuls"
        elif "moe:dense" in names:
            ffn = [c for c in names["moe:dense"].cpu_children
                   if c.name == "moe:experts"]
            key = ("dispatch_scatter" if not ffn or ev.time_range.start
                   < ffn[0].time_range.start else "combine_gather")
        elif "moe:layer" in names:
            key = "shared_experts"
        else:
            key = "rest"
        split[key] += sum(k.duration for k in ev.kernels) / 1e3
        kernels += len(ev.kernels)
    return split, kernels


def _ranged(label, fn):
    def run(*args, **kw):
        with torch.profiler.record_function(label):
            return fn(*args, **kw)
    return run


def split_decode_profile(params, cfg, step, ranges, split, steps=4):
    """Dense-cache decode steps: ``step(i)`` runs step i (step 0 a
    warm-up), steps 1 .. ``steps`` - 1 timed plain, then one more under
    torch.profiler with each ``(module, attribute, label)`` of ``ranges``
    wrapped in a range named ``label``; ``split(prof)`` divides its device
    time by those ranges.  Beside the floor of reading every weight once
    (``decode_floor``)."""
    labels = {label for *_, label in ranges}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.no_grad():
        step(0)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(1, steps):
            step(i)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t) / (steps - 1)
        saved = [(m, n, getattr(m, n)) for m, n, _ in ranges]
        for m, n, label in ranges:
            setattr(m, n, _ranged(label, getattr(m, n)))
        try:
            with torch.profiler.profile(activities=acts) as prof:
                torch.cuda.synchronize()
                t = time.perf_counter()
                step(steps)
                torch.cuda.synchronize()
                prof_ms = 1e3 * (time.perf_counter() - t)
        finally:
            for m, n, fn in saved:
                setattr(m, n, fn)
    # the device kernels, not the ranges' own device-side spans
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.key not in labels]
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    flash = [e for e in events if "flash_attention_kernel" in e.key]
    by_range, kernels = split(prof)
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:6]
    floor = decode_floor(params, cfg)
    return {"step_ms": wall_ms, "step_ms_under_profiler": prof_ms,
            "device_ms_per_step": dev_ms,
            "device_busy_share": dev_ms / wall_ms if dev_ms else None,
            "device_kernels_per_step": sum(e.count for e in events),
            "flash_kernels_per_step": sum(e.count for e in flash),
            "flash_ms_per_step": sum(e.self_device_time_total
                                     for e in flash) / 1e3,
            "kernels_attributed": kernels, "device_ms_split": by_range,
            "device_ms_attributed": sum(by_range.values()), **floor,
            "step_over_floor": wall_ms / floor["floor_ms_per_step"],
            "top_device_ms": {e.key[:60]: e.self_device_time_total / 1e3
                              for e in top}}


def moe_decode_profile(T, L, params, cfg, prompt, steps=4):
    """Dense-cache decode steps (batch 1) after a prefill of ``prompt``,
    profiled by ``split_decode_profile`` with ``L.moe``, ``_moe_dense``,
    ``_route`` and ``_expert_ffn`` wrapped in named ranges, the device
    time split by ``moe_split``."""
    lp = len(prompt)
    with torch.no_grad():
        logits, cache = T.prefill(params, cfg, torch.from_numpy(prompt)[None]
                                  .to("cuda"), last_only=True)
        cache = T.pad_prefill_cache(cfg, cache, lp + steps + 1)
        tok = logits[:, -1].argmax(-1)

    def step(i):
        T.decode_step(params, cfg, tok, lp + i, cache)

    ranges = ((L, "moe", "moe:layer"), (L, "_moe_dense", "moe:dense"),
              (L, "_route", "moe:router"), (L, "_expert_ffn", "moe:experts"))
    out = split_decode_profile(params, cfg, step, ranges, moe_split, steps)
    return {"moe_decode_profile": {"batch": 1, "ctx": lp, **out}}


# granite-moe-1b-a400m's depth in ``greedy_granite_moe``: 12 of its 24
# layers since PR 28 (the run's time budget)
GRANITE_MOE_LAYERS = 12


def greedy_granite_moe(kernels, T, E, L, cfg, smi):
    """granite-moe-1b-a400m at full width (cut in depth by the caller),
    bf16: a 2048-token prompt (a flash launch a layer), a profiled
    prefill and decode, and the MoE split of one decode step."""
    out = greedy(kernels, T, E, cfg, smi, phase="greedy_granite_moe",
                 prompt_len=2048, new=32, seed=14, profile=True,
                 after=lambda prm, prompt: moe_decode_profile(
                     T, L, prm, cfg, prompt))
    return {**out, "experts": cfg.num_experts, "top_k": cfg.top_k,
            "params_b": cfg.param_count() / 1e9}


def to_f32_in_place(tree):
    """Each leaf of ``tree`` replaced by its f32 copy, one leaf at a time
    with the cache emptied after each: the peak is the tree in f32 plus one
    bf16 leaf, not both trees."""
    for k, v in tree.items():
        if isinstance(v, dict):
            to_f32_in_place(v)
        else:
            tree[k] = v.float()
            del v
            torch.cuda.empty_cache()


def engines_agree(pa, T, E, params, cfg):
    """The same parameters in f32 (each bf16 weight exactly) through
    ``PagedDecodeEngine`` and ``DecodeEngine`` on 4 requests, tokens
    identical.  Capacity factor E_pad / k (nothing dropped): at the
    default the two engines route other token sets together (a prefill
    chunk against one token a slot), so capacity drops other rows in each,
    as in the reference."""
    cfg = dataclasses.replace(
        cfg, param_dtype="float32", compute_dtype="float32",
        capacity_factor=cfg.num_experts_padded / cfg.top_k)
    gc.collect()  # an engine's timing wrappers hold it, and its weights,
    torch.cuda.empty_cache()  # in a reference cycle
    t = time.perf_counter()
    to_f32_in_place(params)
    out = {"capacity_factor": cfg.capacity_factor, "requests": 4,
           "to_f32_s": time.perf_counter() - t}
    gens = {}
    for name, Engine, kw in (
            ("paged", E.PagedDecodeEngine,
             dict(page_size=16, chunk_size=256)),
            ("dense", E.DecodeEngine, {})):
        reqs = requests(E.Request, np.random.default_rng(15), 4, 64, 256, 16,
                        32, cfg.vocab_size)
        eng = Engine(params, cfg, batch_slots=4, max_seq=512, device="cuda",
                     **kw)
        for r in reqs:
            eng.submit(r)
        t = time.perf_counter()
        pa.paged_attention.launches = 0
        gens[name] = {r.rid: r.generated for r in eng.run()}
        torch.cuda.synchronize()
        out[f"{name}_s"] = time.perf_counter() - t
        if name == "paged":
            eng.kv.allocator.check()
            if eng.kv.allocator.num_allocated:
                raise AssertionError("f32 subset: the page pool did not "
                                     "drain")
            if pa.paged_attention.launches != eng.decode_steps \
                    * cfg.num_layers:
                raise AssertionError("f32 subset: paged launches")
        del eng
        torch.cuda.empty_cache()
    if gens["paged"] != gens["dense"]:
        raise AssertionError(f"{cfg.name}: PagedDecodeEngine "
                             f"{gens['paged']} vs DecodeEngine "
                             f"{gens['dense']} (f32, no drops)")
    return {**out, "paged_eq_dense_f32": True,
            "prompt_tokens": [len(r.prompt) for r in reqs],
            "tokens": sum(len(g) for g in gens["paged"].values()),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


# qwen2-moe-a2.7b's depth on the card: 8 of its 24 layers (the run's
# time budget; a layer is the same work at any depth)
QWEN2_MOE_LAYERS = 8


def qwen2_moe(kernels, pa, T, E, L, cfg, smi):
    """qwen2-moe-a2.7b at full width (cut in depth by the caller),
    initialised in bf16: the
    ``greedy_qwen2_moe`` phase (a 1024-token prompt, the MoE split of a
    profiled decode step) and ``paged_serve_qwen2_moe`` on the same
    parameters (8 slots, 16 requests, prompts of 64-1024 tokens, 32-128
    new ones; the pool drains clean, paged launches = decode steps x layers),
    then the engines' tokens on 4 requests in f32 (``engines_agree``);
    the parameters are freed at the end."""
    gc.collect()  # engines of earlier phases, held in reference cycles
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = T.init_model(torch.Generator(device="cuda").manual_seed(16),
                          cfg, device="cuda")
    torch.cuda.synchronize()
    init = {"init_s": time.perf_counter() - t,
            "init_peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "params_gb": tree_bytes(params) / 1e9,
            "params_b": sum(x.numel() for x in _leaves(params)) / 1e9}
    greedy_out = greedy(kernels, T, E, cfg, smi, phase="greedy_qwen2_moe",
                        prompt_len=1024, new=16, seed=16, params=params,
                        after=lambda prm, prompt: moe_decode_profile(
                            T, L, prm, cfg, prompt))
    greedy_out.update(init, experts=cfg.num_experts,
                      experts_padded=cfg.num_experts_padded,
                      shared_experts=cfg.num_shared_experts, top_k=cfg.top_k)
    serve_out = serve(
        pa, T, E.PagedDecodeEngine, E.Request, cfg, smi, slots=8,
        max_seq=2048, reqs=requests(E.Request, np.random.default_rng(17), 16,
                                    64, 1024, 32, 128, cfg.vocab_size),
        seed=17, params=params)
    floor = decode_floor(params, cfg)
    serve_out.update(phase="paged_serve_qwen2_moe", **floor,
                     step_over_floor=serve_out["decode_step_ms_median"]
                     / floor["floor_ms_per_step"])
    serve_out["engines_agree"] = engines_agree(pa, T, E, params, cfg)
    del params
    torch.cuda.empty_cache()
    return greedy_out, serve_out


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def one_batch(CLI):
    """Wrap ``CLI.prefetch_batches`` to yield its first batch at every step
    (the trainer fitting one batch); returns the undo function."""
    stream = CLI.prefetch_batches

    def repeat_first(*args, **kw):
        first = None
        for t, batch in stream(*args, **kw):
            first = batch if first is None else first
            yield t, first

    CLI.prefetch_batches = repeat_first

    def undo():
        CLI.prefetch_batches = stream
    return undo


def train_moe(kernels, L, T, get_config, smi):
    """The trainer path on granite-moe-1b-a400m at full width, 4 layers,
    W = 4, f32, ``sync --compressor onebit --fused-adam``, TRAIN_STEPS steps:
    ``train_path``'s gates, each forward's aux finite and > 0, and the
    share of (token, rank) rows capacity dropped in step 0 (a spy on
    ``L._route`` here; the package counts nothing).  On the stream's
    batches the loss cannot fall in so few steps: its tokens are uniform over
    49,155 ids, so the cross entropy starts at ln V and only the bigram
    map, which no 10 batches cover, lowers it.  So the trainer then fits
    one batch, repeated as often (``train_moe_one_batch``), and there
    the loss must fall."""
    from repro_torch.launch import train as CLI

    arch = "granite-moe-1b-a400m"
    step0 = TRAIN_W * TRAIN_LAYERS  # _route calls of step 0
    kept, auxes = [], []
    route, forward = L._route, T.forward

    def route_spy(*args):
        out = route(*args)
        if len(kept) < step0:
            kept.append(out[2].detach())
        return out

    def forward_spy(*args, **kw):
        logits, aux = forward(*args, **kw)
        auxes.append(aux.detach())
        return logits, aux

    L._route, T.forward = route_spy, forward_spy
    try:
        result, prof = train_path(kernels, get_config, smi,
                                  compressor="onebit", phase="train_moe",
                                  arch=arch)
    finally:
        L._route, T.forward = route, forward
    aux = torch.stack(auxes).cpu()
    if not (torch.isfinite(aux).all() and (aux > 0).all()):
        raise AssertionError(f"train_moe: aux {aux.tolist()}")
    undo = one_batch(CLI)
    try:
        fit, _ = train_path(kernels, get_config, smi, compressor="onebit",
                            phase="train_moe_one_batch", arch=arch,
                            profile=False)
    finally:
        undo()
    if not fit["loss"][-1] < fit["loss"][0]:
        raise AssertionError(f"train_moe: on one repeated batch the loss "
                             f"did not fall: {fit['loss']}")
    cfg = get_config(arch)
    keep = torch.cat(kept)
    result.update(
        experts=cfg.num_experts, top_k=cfg.top_k,
        aux_first_last=[aux[0].item(), aux[-1].item()],
        step0_rows=keep.numel(),
        step0_dropped_share=1.0 - keep.float().mean().item(),
        one_batch={k: fit[k] for k in ("loss", "step_ms_median",
                                       "launches", "wire_bytes",
                                       "replica_divergence_max")})
    return result, prof


def moe_cases(get_config):
    return [
        (dataclasses.replace(get_config("granite-moe-1b-a400m"),
                             num_layers=2, d_model=256), 200, 41),
        (dataclasses.replace(get_config("qwen2-moe-a2.7b"), num_layers=2,
                             d_model=256, head_dim=128), 200, 42),
        (dataclasses.replace(get_config("jamba-1.5-large-398b").reduced(),
                             num_layers=8), 300, 43)]


def moe_side(get_config, dev, kernels=None):
    """``moe_card_vs_cpu``'s runs on ``dev``, by config name: the prefill's
    last logits and each MoE layer's (flat_idx, slot, keep), on the host,
    and ``greedy_generate``'s tokens; on the card also the kernels'
    launches (``kernels``) and, at capacity factor E_pad / k,
    ``greedy_generate``'s and ``DecodeEngine``'s tokens (the prompt in a
    slot another request used)."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.serve import engine as E

    route = L._route
    out = {}
    for cfg, lp, seed in moe_cases(get_config):
        params = T.init_model(torch.Generator().manual_seed(seed), cfg,
                              device="cpu")
        rng = np.random.default_rng(seed)
        prompt = rng.integers(0, cfg.vocab_size, lp).astype(np.int32)
        prm = _tree(params, lambda t: t.to(dev))
        calls = []

        def spy(*args):
            res = route(*args)
            calls.append([x.cpu() for x in res[:3]])
            return res

        for fn in (kernels or {}).values():
            fn.launches = 0
        L._route = spy
        try:
            with torch.no_grad():
                lg, _ = T.prefill(prm, cfg, torch.from_numpy(prompt)[None]
                                  .to(dev), last_only=True)
        finally:
            L._route = route
        res = {"logits": lg.cpu(), "routes": calls,
               "gens": E.greedy_generate(prm, cfg, prompt, 8, device=dev)}
        res["launches"] = {k: fn.launches for k, fn in (kernels or {}).items()}
        del prm, lg
        if dev == "cuda":
            nodrop = dataclasses.replace(
                cfg, capacity_factor=cfg.num_experts_padded / cfg.top_k)
            res["nodrop_gens"] = E.greedy_generate(params, nodrop, prompt, 8,
                                                   device="cuda")
            eng = E.DecodeEngine(params, nodrop, batch_slots=1,
                                 max_seq=lp + 16, device="cuda")
            other = rng.integers(0, cfg.vocab_size, lp // 2).astype(np.int32)
            eng.submit(E.Request(rid=0, prompt=other, max_new_tokens=8))
            eng.submit(E.Request(rid=1, prompt=prompt, max_new_tokens=8))
            res["engine_gens"] = {r.rid: r.generated for r in eng.run()}[1]
            del eng
        out[cfg.name] = res
        del params
        torch.cuda.empty_cache()
    return out


def moe_card_vs_cpu(get_config, kernels, cpu):
    """f32, TF32 off: granite-moe-1b-a400m and qwen2-moe-a2.7b cut to 2
    layers at d_model 256 (every other width the config's) and jamba
    ``.reduced()`` with its experts cut to one super-block (8 layers, 4
    experts, top 2; 16 layers until PR 28) with a
    300-token prompt.  The same weights and prompt on the card and the
    CPU (``cpu``: ``moe_side``'s CPU run, from the ``cpu_half`` worker):
    prefill logits within 1e-3, each MoE layer's flat_idx, slot and
    keep of the prefill equal, greedy tokens identical, at the default
    capacity factor.  On the card, ``DecodeEngine`` with the prompt in a
    slot another request used against ``greedy_generate``, at capacity
    factor E_pad / k (nothing dropped: the engine routes one token a step
    and the prefill the whole prompt, so at the default capacity drops
    other rows in each, as in the reference).  Returns the phase line and
    the kernels' launches in the card's runs (the prefill and
    ``greedy_generate`` at the default capacity factor)."""
    out = {"phase": "moe_card_vs_cpu", "dtype": "float32",
           "tol_logits": 1e-3, "archs": {}}
    launches = dict.fromkeys(kernels, 0)
    card = moe_side(get_config, "cuda", kernels)
    for cfg, lp, _ in moe_cases(get_config):
        a, b = card[cfg.name], cpu[cfg.name]
        for k, n in a["launches"].items():
            launches[k] += n
        err = (a["logits"] - b["logits"]).abs().max().item()
        if not err <= 1e-3:
            raise AssertionError(f"{cfg.name}: card vs CPU prefill logits "
                                 f"differ by {err} > 1e-3")
        n_moe = sum(s.ffn == "moe" for s in cfg.superblock()[0]) \
            * cfg.superblock()[1]
        if len(a["routes"]) != n_moe or len(b["routes"]) != n_moe:
            raise AssertionError(f"{cfg.name}: {len(a['routes'])} routed "
                                 f"layers, expected {n_moe}")
        for li, (x_, y_) in enumerate(zip(a["routes"], b["routes"])):
            for name, x, y in zip(("flat_idx", "slot", "keep"), x_, y_):
                if not torch.equal(x, y):
                    raise AssertionError(f"{cfg.name}: MoE layer {li}'s "
                                         f"{name} differs card vs CPU")
        if a["gens"] != b["gens"]:
            raise AssertionError(f"{cfg.name}: card vs CPU greedy tokens "
                                 f"{a['gens']} vs {b['gens']}")
        if a["engine_gens"] != a["nodrop_gens"]:
            raise AssertionError(f"{cfg.name}: greedy_generate "
                                 f"{a['nodrop_gens']} vs DecodeEngine "
                                 f"{a['engine_gens']} in a reused slot on "
                                 "the card (no drops)")
        specs, repeat = cfg.superblock()
        out["archs"][cfg.name] = {
            "layers": cfg.num_layers, "d_model": cfg.d_model,
            "experts": cfg.num_experts, "experts_padded":
            cfg.num_experts_padded, "top_k": cfg.top_k,
            "shared_experts": cfg.num_shared_experts,
            "mixers": [s.mixer for s in specs] * repeat,
            "ffns": [s.ffn for s in specs] * repeat,
            "prompt_tokens": lp, "prefill_logits_max_abs_err": err,
            "moe_layers_routing_equal": n_moe,
            "prefill_rows_dropped": sum(int((~c[2]).sum())
                                        for c in a["routes"]),
            "prefill_rows": sum(c[2].numel() for c in a["routes"]),
            "tokens_card_eq_cpu": True,
            "tokens_generate_eq_engine_reused_slot_no_drops": True,
            "tokens": a["gens"]}
    out["launches_on_card"] = launches
    return out, launches


# ---------------------------------------------------------------------------
# the encoder-decoder and vision families: seamless-m4t-medium, pixtral-12b
# ---------------------------------------------------------------------------
ENCDEC_SPLIT = ("memory_kv_projection", "cross_attention", "self_attention",
                "mlp", "head", "rest")


def decode_split(prof):
    """Device time of one profiled decode step by where each kernel was
    launched (the ranges ``split_decode_profile`` wraps around the layers'
    functions): ``_qkv`` inside ``cross_attention`` (the memory's k and v
    projections, with the step's one-row q projection), the rest of
    ``cross_attention`` (the flash kernel, the layout copies, ``wo``),
    ``attention_decode`` (self attention with its cache write), ``mlp``,
    ``_logits`` (final norm and head) and everything else (embedding,
    norms, residual adds)."""
    split = dict.fromkeys(ENCDEC_SPLIT, 0.0)
    kernels = 0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CPU or not ev.kernels:
            continue
        names, a = set(), ev
        while a is not None:
            names.add(a.name)
            a = a.cpu_parent
        if "ed:cross" in names:
            key = ("memory_kv_projection" if "ed:qkv" in names
                   else "cross_attention")
        elif "ed:self" in names:
            key = "self_attention"
        elif "ed:mlp" in names:
            key = "mlp"
        elif "ed:head" in names:
            key = "head"
        else:
            key = "rest"
        split[key] += sum(k.duration for k in ev.kernels) / 1e3
        kernels += len(ev.kernels)
    return split, kernels


# the ranges of an encoder-decoder or decoder decode step, for decode_split
DECODE_RANGES = (("cross_attention", "ed:cross"), ("_qkv", "ed:qkv"),
                 ("attention_decode", "ed:self"), ("mlp", "ed:mlp"))


def encdec_decode_profile(T, L, params, cfg, step):
    """``split_decode_profile`` of ``step`` split by ``decode_split``: the
    layers' functions and ``T._logits`` in named ranges.  The flash
    kernel, launched through ctypes, is tied to no op of the trace: its
    device time is added to ``cross_attention``, the one place a decode
    step launches it."""
    ranges = tuple((L, n, label) for n, label in DECODE_RANGES) \
        + ((T, "_logits", "ed:head"),)
    out = split_decode_profile(params, cfg, step, ranges, decode_split)
    out["device_ms_split"]["cross_attention"] += out["flash_ms_per_step"]
    out["device_ms_attributed"] += out["flash_ms_per_step"]
    return out


SEAMLESS_PROMPT, SEAMLESS_NEW = 256, 64


def seamless(fl, T, E, L, cfg, smi):
    """seamless-m4t-medium at full width and depth in bf16, its source
    frames a seeded (1, 3072, 1024) × 0.02 (the reference's stub for the
    audio frontend): ``encode`` (one non-causal flash launch an encoder
    layer), then ``greedy_generate(memory=...)`` on a 256-token prompt
    with 64 new tokens (a prefill of one causal and one cross launch a
    decoder layer, Lq 256 against Lk 3072, then one cross launch a layer a
    decode step, Lq 1) with a profiled decode step split by
    ``decode_split`` (``greedy_seamless``); then ``DecodeEngine`` with 8
    slots over the memory of 8 seeded source rows, 8 + DENSE_REFILL
    requests (``dense_serve_seamless``).  The parameters are freed at the end."""
    gc.collect()
    torch.cuda.empty_cache()
    params = T.init_model(torch.Generator(device="cuda").manual_seed(23),
                          cfg, device="cuda")
    rng = np.random.default_rng(23)
    s_enc, d, v = cfg.encoder_seq_len, cfg.d_model, cfg.vocab_size
    n_enc, n_dec = cfg.num_encoder_layers, cfg.num_layers
    src = torch.from_numpy(0.02 * rng.standard_normal(
        (1, s_enc, d), dtype=np.float32)).to("cuda")
    prompt = rng.integers(0, v, SEAMLESS_PROMPT).astype(np.int32)
    lp, new = SEAMLESS_PROMPT, SEAMLESS_NEW
    with torch.no_grad():  # the allocator's growth and the GEMM heuristics
        memory = T.encode(params, cfg, embeds=src)
        t = time.perf_counter()
        E.greedy_generate(params, cfg, prompt, 2, device="cuda",
                          memory=memory)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t
    del memory
    rec, undo = timed_calls(T, ("prefill", "decode_step"))
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fl.flash_attention.launches = 0
        t0 = time.perf_counter()
        with torch.no_grad():
            memory = T.encode(params, cfg, embeds=src)
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - t0
        enc_launches = fl.flash_attention.launches
        toks = E.greedy_generate(params, cfg, prompt, new, device="cuda",
                                 memory=memory)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = fl.flash_attention.launches
    finally:
        undo()
    peak = torch.cuda.max_memory_allocated()
    want = n_enc + 2 * n_dec + n_dec * (new - 1)
    if enc_launches != n_enc or launches != want:
        raise AssertionError(f"greedy_seamless: flash launches {enc_launches}"
                             f" encode, {launches} in all; expected {n_enc}, "
                             f"{want}")
    if tuple(memory.shape) != (1, s_enc, d) or memory.dtype != torch.bfloat16 \
            or not torch.isfinite(memory).all():
        raise AssertionError(f"greedy_seamless: memory {memory.dtype}"
                             f"{tuple(memory.shape)} not finite")
    (pf_s, (logits, cache)), = rec["prefill"]
    if tuple(logits.shape) != (1, 1, v) or not torch.isfinite(logits).all():
        raise AssertionError("greedy_seamless: prefill logits "
                             f"{tuple(logits.shape)} not finite")
    if len(toks) != new or not all(0 <= x < v for x in toks):
        raise AssertionError(f"greedy_seamless: tokens {toks}")
    steps = [s for s, _ in rec["decode_step"]]
    del logits, cache, rec

    with torch.no_grad():
        logits, cache = T.prefill(params, cfg, torch.from_numpy(prompt)[None]
                                  .to("cuda"), last_only=True, memory=memory)
        cache = T.pad_prefill_cache(cfg, cache, lp + 8)
        tok = logits[:, -1].argmax(-1)

    def step(i):
        T.decode_step(params, cfg, tok, lp + i, cache, memory=memory)

    profile = encdec_decode_profile(T, L, params, cfg, step)
    # the memory's k and v a decode step: 2 products of S x D x (KV Dh) a
    # decoder layer
    kv_flops = 2 * 2 * s_enc * d * cfg.num_kv_heads \
        * cfg.resolved_head_dim * n_dec
    profile["memory_kv_flops_per_step"] = kv_flops
    profile["memory_kv_bound_ms"] = 1e3 * kv_flops / BF16_OPS_PER_S
    del cache, logits, memory
    greedy_out = {
        "phase": "greedy_seamless", "arch": cfg.name,
        "layers": n_dec, "encoder_layers": n_enc, "d_model": d,
        "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
        "head_dim": cfg.resolved_head_dim, "dtype": cfg.compute_dtype,
        "params_b": cfg.param_count() / 1e9,
        "params_gb": tree_bytes(params) / 1e9,
        "source_frames": s_enc, "prompt_tokens": lp, "new_tokens": new,
        "flash_launches_encode": enc_launches,
        "flash_launches": launches, "flash_launches_expected": want,
        "encode_ms": 1e3 * enc_s, "prefill_ms": 1e3 * pf_s,
        "first_call_ms": 1e3 * cold_s, "decode_steps": len(steps),
        "decode_step_ms_median": 1e3 * statistics.median(steps),
        "decode_tok_per_s": len(steps) / sum(steps),
        "wall_s": wall, "peak_mem_gb": peak / 1e9, "tokens": toks[:8],
        "profile_decode": profile, "card": smi}

    src8 = torch.from_numpy(0.02 * rng.standard_normal(
        (8, s_enc, d), dtype=np.float32)).to("cuda")
    fl.flash_attention.launches = 0
    with torch.no_grad():
        memory8 = T.encode(params, cfg, embeds=src8)
    enc8 = fl.flash_attention.launches
    if enc8 != n_enc:
        raise AssertionError(f"dense_serve_seamless: encode launched flash "
                             f"{enc8} times, expected {n_enc}")
    serve_out = dense_serve(T, E, cfg, smi, phase="dense_serve_seamless",
                            params=params, memory=memory8, prompt=(16, 256),
                            new=(16, 64), flash=fl.flash_attention)
    serve_out["flash_launches_encode"] = enc8
    serve_out["flash_launches"] += enc8
    serve_out["flash_launches_expected"] += enc8
    del params, memory8
    gc.collect()
    torch.cuda.empty_cache()
    return greedy_out, serve_out


PIXTRAL_PATCHES, PIXTRAL_TEXT, PIXTRAL_NEW = 1024, 256, 32


def greedy_pixtral(fl, T, L, cfg, smi):
    """pixtral-12b at full width and depth (40 layers), its parameters
    drawn in bf16 (24.5 GB; f32 would be 49 GB): ``prefill(embeds=...)``
    over 1024 seeded patch embeddings × 0.02 (the reference's stub for the
    vision frontend) followed by the ``embed`` rows of 256 text tokens
    (one flash launch a layer), ``pad_prefill_cache``, then 32 greedy
    ``decode_step``s on tokens, each beside the floor of reading every
    weight once, one of them profiled.  The parameters are freed at the
    end."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = T.init_model(torch.Generator(device="cuda").manual_seed(25),
                          cfg, device="cuda")
    torch.cuda.synchronize()
    init = {"init_s": time.perf_counter() - t,
            "init_peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "params_gb": tree_bytes(params) / 1e9,
            "params_b": sum(x.numel() for x in _leaves(params)) / 1e9}
    rng = np.random.default_rng(25)
    d, v = cfg.d_model, cfg.vocab_size
    patches = torch.from_numpy(0.02 * rng.standard_normal(
        (1, PIXTRAL_PATCHES, d), dtype=np.float32)).to("cuda")
    text = torch.from_numpy(rng.integers(0, v, PIXTRAL_TEXT)).to("cuda")
    embeds = torch.cat([patches.to(params["embed"].dtype),
                        params["embed"][text][None]], dim=1)
    lp, new = embeds.shape[1], PIXTRAL_NEW

    def run(n):
        """A prefill and ``n`` greedy decode steps, each timed."""
        with torch.no_grad():
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, cache = T.prefill(params, cfg, embeds=embeds,
                                      last_only=True)
            torch.cuda.synchronize()
            pf_s = time.perf_counter() - t
            if tuple(logits.shape) != (1, 1, v) \
                    or not torch.isfinite(logits).all():
                raise AssertionError("greedy_pixtral: prefill logits "
                                     f"{tuple(logits.shape)} not finite")
            cache = T.pad_prefill_cache(cfg, cache, lp + n)
            tok = logits[:, -1].argmax(-1)
            toks, steps = [int(tok[0])], []
            for i in range(n):
                t = time.perf_counter()
                logits = T.decode_step(params, cfg, tok, lp + i, cache)
                tok = logits.argmax(-1)
                toks.append(int(tok[0]))  # a host read: synchronises
                steps.append(time.perf_counter() - t)
        return pf_s, toks, steps, cache, tok

    cold_s = run(1)[0]
    torch.cuda.reset_peak_memory_stats()
    fl.flash_attention.launches = 0
    pf_s, toks, steps, cache, tok = run(new)
    launches = fl.flash_attention.launches
    peak = torch.cuda.max_memory_allocated()
    if launches != cfg.num_layers:
        raise AssertionError(f"greedy_pixtral: flash launches {launches}, "
                             f"expected {cfg.num_layers}")
    if len(toks) != new + 1 or not all(0 <= x < v for x in toks):
        raise AssertionError(f"greedy_pixtral: tokens {toks}")
    cache = T.pad_prefill_cache(cfg, cache, lp + new + 8)

    def step(i):
        T.decode_step(params, cfg, tok, lp + new + i, cache)

    profile = encdec_decode_profile(T, L, params, cfg, step)
    floor = decode_floor(params, cfg)
    out = {"phase": "greedy_pixtral", "arch": cfg.name,
           "layers": cfg.num_layers, "d_model": d, "heads": cfg.num_heads,
           "kv_heads": cfg.num_kv_heads, "head_dim": cfg.resolved_head_dim,
           "dtype": cfg.compute_dtype, **init,
           "patch_embeds": PIXTRAL_PATCHES, "text_tokens": PIXTRAL_TEXT,
           "prompt_positions": lp, "decode_steps": new,
           "flash_launches": launches, "prefill_ms": 1e3 * pf_s,
           "prefill_tok_per_s": lp / pf_s, "prefill_ms_first_call":
           1e3 * cold_s, "decode_step_ms_median":
           1e3 * statistics.median(steps),
           "decode_tok_per_s": len(steps) / sum(steps), **floor,
           "all_weights_read_ms": 1e3 * tree_bytes(params) / HBM_BYTES_PER_S,
           "step_over_floor": 1e3 * statistics.median(steps)
           / floor["floor_ms_per_step"],
           "peak_mem_gb": peak / 1e9, "tokens": toks[:8],
           "profile_decode": profile, "card": smi}
    del params, cache, embeds, tok
    gc.collect()
    torch.cuda.empty_cache()
    return out


def loss_and_grads(LOOP, TR, params, cfg, batch, remat=False):
    """``make_loss_fn``'s loss and the gradient of every leaf of
    ``params``, on their device; a leaf the loss does not read (pixtral's
    ``embed`` under ``embeds``) gets zeros, as ``jax.grad`` gives."""
    leaves = [x.detach().clone().requires_grad_() for x in TR.leaves(params)]
    p = TR.unflatten(TR.flatten(params)[1], leaves)
    loss = LOOP.make_loss_fn(cfg, remat=remat)(p, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.item(), [(torch.zeros_like(x) if g is None else g).cpu()
                         for x, g in zip(leaves, grads)]


GRAD_RTOL = 1e-4


def grads_close(name, paths, a, b):
    """Each leaf of the card's gradients ``a`` against the CPU's ``b``:
    max |a - b| within 1e-4 of the leaf's largest |g| (an element-wise
    rtol fails on the elements near 0 that every leaf has: the two
    devices sum in other orders).  Returns each leaf's max |a - b| /
    max |b|, by path."""
    ratios = {}
    for path, x, y in zip(paths, a, b):
        scale = y.abs().max().item()
        ratios[path] = (x - y).abs().max().item() / scale if scale else 0.0
    bad = {k: r for k, r in ratios.items() if not r <= GRAD_RTOL}
    if bad:
        raise AssertionError(f"{name}: gradients differ card vs CPU past "
                             f"{GRAD_RTOL} of the leaf's largest: {bad}")
    return ratios


def encdec_cases(get_config):
    seamless = dataclasses.replace(
        get_config("seamless-m4t-medium"), d_model=256, head_dim=64,
        num_layers=2, num_encoder_layers=2, encoder_seq_len=300)
    return seamless, get_config("pixtral-12b").reduced()


def encdec_side(get_config, dev):
    """``encdec_card_vs_cpu``'s runs on ``dev`` (on the host): the
    seamless cut's memory, prefill logits, ``greedy_generate``'s tokens
    (``DecodeEngine``'s checked equal to them here), loss and gradients;
    pixtral ``.reduced()``'s logits and tokens of a prefill from embeds
    and 8 decode steps, loss and gradients; on the card the flash
    kernel's launches, checked against the paths' counts."""
    from repro_torch.core import tree as TR
    from repro_torch.kernels import flash_attention as fl
    from repro_torch.models import transformer as T
    from repro_torch.serve import engine as E
    from repro_torch.train import loop as LOOP

    cfg, pix = encdec_cases(get_config)
    out = {"launches": 0}
    params = T.init_model(torch.Generator().manual_seed(26), cfg,
                          device="cpu")
    rng = np.random.default_rng(26)
    s, d, v = cfg.encoder_seq_len, cfg.d_model, cfg.vocab_size
    src = torch.from_numpy(0.02 * rng.standard_normal((4, s, d),
                                                      dtype=np.float32))
    prompts = [rng.integers(0, v, int(n)).astype(np.int32)
               for n in rng.integers(16, 48, 4)]
    news = [int(n) for n in rng.integers(4, 12, 4)]
    labels = torch.from_numpy(rng.integers(0, v, (2, 32)))
    batch = {"tokens": labels, "labels": labels, "source_embeds": src[:2]}
    prm = _tree(params, lambda t: t.to(dev))
    fl.flash_attention.launches = 0
    with torch.no_grad():
        mem = T.encode(prm, cfg, embeds=src.to(dev))
        lg, _ = T.prefill(prm, cfg, torch.from_numpy(prompts[0])[None]
                          .to(dev), last_only=True, memory=mem[:1])
    gens = [E.greedy_generate(prm, cfg, p, n, device=dev,
                              memory=mem[i:i + 1])
            for i, (p, n) in enumerate(zip(prompts, news))]
    eng = E.DecodeEngine(prm, cfg, batch_slots=4, max_seq=64, device=dev,
                         memory=mem)
    for i, (p, n) in enumerate(zip(prompts, news)):
        eng.submit(E.Request(rid=i, prompt=p, max_new_tokens=n))
    eng_gens = {r.rid: r.generated for r in eng.run()}
    if eng_gens != dict(enumerate(gens)):
        raise AssertionError(f"seamless cut on {dev}: DecodeEngine "
                             f"{eng_gens} vs greedy_generate {gens} with "
                             "memory row i in slot i")
    if dev == "cuda":
        want = (cfg.num_encoder_layers + 2 * cfg.num_layers
                + sum(2 * cfg.num_layers + cfg.num_layers * (n - 1)
                      for n in news) + cfg.num_layers * eng.steps)
        if fl.flash_attention.launches != want:
            raise AssertionError(f"seamless cut: flash launches "
                                 f"{fl.flash_attention.launches}, "
                                 f"expected {want}")
        out["launches"] += want
    loss, grads = loss_and_grads(LOOP, TR, prm, cfg, _tree(
        batch, lambda t: t.to(dev)))
    out[cfg.name] = {"memory": mem.cpu(), "logits": lg.cpu(), "gens": gens,
                     "loss": loss, "grads": grads, "steps": eng.steps,
                     "prompt_tokens": [len(p) for p in prompts],
                     "new_tokens": news,
                     "paths": [".".join(x) for x in _paths(params)]}
    del prm, mem, lg, eng, params

    cfg = pix
    params = T.init_model(torch.Generator().manual_seed(27), cfg,
                          device="cpu")
    rng = np.random.default_rng(27)
    d, v = cfg.d_model, cfg.vocab_size
    emb = torch.from_numpy(0.02 * rng.standard_normal((1, 48, d),
                                                      dtype=np.float32))
    labels = torch.from_numpy(rng.integers(0, v, (2, 32)))
    batch = {"embeds": torch.from_numpy(0.02 * rng.standard_normal(
        (2, 32, d), dtype=np.float32)), "labels": labels}
    prm = _tree(params, lambda t: t.to(dev))
    fl.flash_attention.launches = 0
    with torch.no_grad():
        lg, cache = T.prefill(prm, cfg, embeds=emb.to(dev), last_only=True)
        cache = T.pad_prefill_cache(cfg, cache, 48 + 8)
        logits, toks = [lg[:, -1].cpu()], [int(lg[0, -1].argmax())]
        for i in range(8):
            tok = torch.tensor(toks[-1:], device=dev)
            lg = T.decode_step(prm, cfg, tok, 48 + i, cache)
            logits.append(lg.cpu())
            toks.append(int(lg[0].argmax()))
    if dev == "cuda":
        if fl.flash_attention.launches != cfg.num_layers:
            raise AssertionError(f"pixtral reduced: flash launches "
                                 f"{fl.flash_attention.launches}")
        out["launches"] += cfg.num_layers
    loss, grads = loss_and_grads(LOOP, TR, prm, cfg, _tree(
        batch, lambda t: t.to(dev)))
    out[cfg.name] = {"logits": logits, "toks": toks, "loss": loss,
                     "grads": grads,
                     "paths": [".".join(x) for x in _paths(params)]}
    del prm, cache
    torch.cuda.empty_cache()
    return out


def encdec_card_vs_cpu(get_config, cpu):
    """f32, TF32 off, the same parameters on the card and the CPU
    (``cpu``: ``encdec_side``'s CPU run, from the ``cpu_half`` worker).
    seamless-m4t-medium cut to d_model 256 (Dh 64 and every other width
    the config's), 2 + 2 layers, 300 source frames (not a multiple of the
    64-row tile): ``encode`` of 4 rows within 1e-4, prefill logits within
    1e-3, ``greedy_generate`` tokens identical, and a 4-slot
    ``DecodeEngine`` given 4 requests (request i in slot i, memory row i)
    giving each request ``greedy_generate``'s tokens with memory row i, on
    both devices.  pixtral-12b ``.reduced()``: ``prefill(embeds=...)``
    then 8 decode steps, logits within 1e-3 and tokens identical.  Both:
    ``make_loss_fn``'s loss within 1e-4 and every leaf's gradient (the
    encoder and cross leaves included) within 1e-4 of the leaf's largest
    (``grads_close``).
    Returns the phase line and the flash launches of the card's runs."""
    out = {"phase": "encdec_card_vs_cpu", "dtype": "float32",
           "tol_encode": 1e-4, "tol_logits": 1e-3, "tol_loss": 1e-4,
           "grad_tol_of_leaf_max": GRAD_RTOL, "archs": {}}
    card = encdec_side(get_config, "cuda")
    cfg, pix = encdec_cases(get_config)
    a, b = card[cfg.name], cpu[cfg.name]
    enc_err = (a["memory"] - b["memory"]).abs().max().item()
    logit_err = (a["logits"] - b["logits"]).abs().max().item()
    loss_err = abs(a["loss"] - b["loss"])
    if not (enc_err <= 1e-4 and logit_err <= 1e-3 and loss_err <= 1e-4):
        raise AssertionError(f"seamless cut card vs CPU: encode {enc_err}, "
                             f"logits {logit_err}, loss {loss_err}")
    if a["gens"] != b["gens"]:
        raise AssertionError(f"seamless cut: card vs CPU greedy tokens "
                             f"{a['gens']} vs {b['gens']}")
    out["archs"][cfg.name] = {
        "d_model": cfg.d_model, "layers": cfg.num_layers,
        "encoder_layers": cfg.num_encoder_layers,
        "source_frames": cfg.encoder_seq_len,
        "heads": cfg.num_heads, "head_dim": cfg.resolved_head_dim,
        "prompt_tokens": a["prompt_tokens"], "new_tokens": a["new_tokens"],
        "encode_max_abs_err": enc_err, "prefill_logits_max_abs_err":
        logit_err, "loss": a["loss"], "loss_abs_err": loss_err,
        "grad_leaves": len(a["grads"]),
        "grad_max_err_over_leaf_max": grads_close(
            cfg.name, a["paths"], a["grads"], b["grads"]),
        "tokens_card_eq_cpu": True, "engine_slot_i_eq_generate_row_i": True,
        "engine_steps": a["steps"], "tokens": a["gens"]}

    cfg = pix
    a, b = card[cfg.name], cpu[cfg.name]
    logit_err = max((x - y).abs().max().item()
                    for x, y in zip(a["logits"], b["logits"]))
    loss_err = abs(a["loss"] - b["loss"])
    if not (logit_err <= 1e-3 and loss_err <= 1e-4):
        raise AssertionError(f"pixtral reduced card vs CPU: logits "
                             f"{logit_err}, loss {loss_err}")
    if a["toks"] != b["toks"]:
        raise AssertionError(f"pixtral reduced: card vs CPU tokens "
                             f"{a['toks']} vs {b['toks']}")
    out["archs"][cfg.name] = {
        "d_model": cfg.d_model, "layers": cfg.num_layers,
        "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
        "patch_embeds": 48, "decode_steps": 8,
        "logits_max_abs_err": logit_err, "loss": a["loss"],
        "loss_abs_err": loss_err, "grad_leaves": len(a["grads"]),
        "grad_max_err_over_leaf_max": grads_close(
            cfg.name, a["paths"], a["grads"], b["grads"]),
        "tokens_card_eq_cpu": True, "tokens": a["toks"]}
    out["flash_launches_on_card"] = card["launches"]
    return out, card["launches"]


# ---------------------------------------------------------------------------
# the scan's backward (a port-side kernel: the reference differentiates its
# jnp chunked scan) and the recurrent families on the trainer
# ---------------------------------------------------------------------------
# each output of the backward kernel against the plain version's, as a
# share of that output's largest |value|: f32 outputs (and the f32 dA, dD
# of a bf16 run) 1e-4, the JAX package's Mamba tolerance; bf16 outputs
# 1e-2, one bf16 rounding (2^-8 of the element) of values that agree in
# f32 to ~1e-6
MAMBA_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
BWD_NAMES = ("du", "ddelta", "da", "db", "dc", "dd")


def mamba_dy(rng, b, l, d, dtype):
    return torch.from_numpy(rng.standard_normal(
        (b, l, d), dtype=np.float32)).to("cuda").to(dtype)


def mamba_bwd_err(ms, args, dy, what):
    """Each output of the backward kernel against the plain version's:
    ({name: max |kernel - plain| / max |plain|}, {name: max |kernel -
    plain|}); raises outside MAMBA_BWD_TOL, on a wrong dtype or shape, or
    when a second call is not bitwise the first."""
    got = ms.mamba_scan_bwd(*args, dy)
    again = ms.mamba_scan_bwd(*args, dy)
    want = ms.mamba_scan_bwd_plain(*args, dy)
    torch.cuda.synchronize()
    errs, abs_errs = {}, {}
    for name, g, a2, w in zip(BWD_NAMES, got, again, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"mamba_scan_bwd {what}: {name} {g.dtype}"
                                 f"{tuple(g.shape)}, plain {w.dtype}"
                                 f"{tuple(w.shape)}")
        if not torch.equal(g, a2):
            raise AssertionError(f"mamba_scan_bwd {what}: {name} differs "
                                 "between two calls on the same inputs")
        scale = w.float().abs().max().item()
        err = (g.float() - w.float()).abs().max().item()
        errs[name] = err / scale if scale else err
        abs_errs[name] = err
        if not errs[name] <= MAMBA_BWD_TOL[g.dtype]:
            raise AssertionError(f"mamba_scan_bwd {what}: {name} leaves "
                                 f"{MAMBA_BWD_TOL[g.dtype]} of its largest "
                                 f"(max abs err {err}, largest {scale})")
    return errs, abs_errs


def check_mamba_bwd(ms):
    """The backward kernel against its plain version on the card, f32 and
    bf16: the reference's sweep shapes and the long case, the narrow B/C
    shapes of MAMBA_RAGGED (ragged D, B/C at odd columns) and jamba's
    prefill shape with B/C strided slices of the x_proj output; two calls
    bitwise equal."""
    err, abs_err = {}, {}
    for dt in (torch.float32, torch.bfloat16):
        shapes = [s + (0, None) for s in MAMBA_SHAPES] \
            + [JAMBA_SCAN + (JAMBA_DT_RANK, None)] \
            + [s[:4] + (0, s[4]) for s in MAMBA_RAGGED]
        for si, (b, l, d, n, r, cols) in enumerate(shapes):
            rng = np.random.default_rng(60 + si)
            args = mamba_inputs(rng, b, l, d, n, dt, dt_rank=r, bc_cols=cols)
            dy = mamba_dy(rng, b, l, d, dt)
            what = f"B={b} L={l} D={d} N={n}" + (" model layout" if r else "") \
                + (f" B/C at columns {cols}" if cols else "")
            key = f"{str(dt)[6:]} {what}"
            err[key], abs_err[key] = mamba_bwd_err(ms, args, dy, what)
            del args, dy
            torch.cuda.empty_cache()
    worst, worst_abs = {}, {}
    for dt in MAMBA_BWD_TOL:
        key = str(dt)[6:]
        worst[key] = max(max(e.values()) for k, e in err.items()
                         if k.startswith(key))
        worst_abs[key] = max(max(e.values()) for k, e in abs_err.items()
                             if k.startswith(key))
    return {"phase": "kernel_check_mamba_bwd", "cases": len(err),
            "state_dims": list(ms.STATE_DIMS),
            "max_rel_err_f32": worst["float32"],
            "tol_f32": MAMBA_BWD_TOL[torch.float32],
            "max_rel_err_bf16": worst["bfloat16"],
            "tol_bf16": MAMBA_BWD_TOL[torch.bfloat16],
            "max_abs_err": max(worst_abs.values()),
            "max_abs_err_by_dtype": worst_abs,
            "deterministic": True,
            "tol_note": "each output: max |kernel - plain| over its largest "
                        "|plain|; bf16 outputs 1e-2, f32 outputs (dA and dD "
                        "always) 1e-4; two calls torch.equal",
            "max_rel_err_per_case": err}


def bwd_geometry(text):
    """The lane map of a backward source: {"states": f(N) states a lane,
    "channels": f(N) channels a block (one dB/dC partial row), "chunk":
    steps between checkpoints}, from its ``constexpr int`` constants
    (the earlier one-state-a-lane design: ``kThreads`` lanes a block; the
    current one: at most ``kLaneStates`` and N / 2 states a lane)."""
    c = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);",
                                          text)}
    if "kThreads" in c:
        return {"states": lambda n: 1,
                "channels": lambda n: c["kThreads"] // n,
                "chunk": c["kChunk"]}
    return {"states": lambda n: min(c["kLaneStates"], n // 2),
            "channels": lambda n: c["kWarps"] * 32
            * min(c["kLaneStates"], n // 2) // n, "chunk": c["kChunk"]}


@contextlib.contextmanager
def scan_bwd_kernel(ms, lib, text):
    """``ms.mamba_scan_bwd`` (its checks, sums and count) launching the
    ``mamba_scan_bwd`` of the library ``lib``, its scratch sized by the
    lane map of the source ``text`` it was built from."""
    fn = ctypes.CDLL(str(lib)).mamba_scan_bwd
    fn.argtypes = ms._BWD_ARGTYPES
    fn.restype = ctypes.c_int
    geo = bwd_geometry(text)

    def shapes(bsz, length, dim, state):
        per = geo["channels"](state)
        return ((bsz, -(-dim // per), length, 2 * state),
                (bsz, -(-length // geo["chunk"]), dim, state))

    saved = ms._bwd_kernel_fn, ms.bwd_scratch_shapes
    ms._bwd_kernel_fn, ms.bwd_scratch_shapes = (lambda: fn), shapes
    try:
        yield
    finally:
        ms._bwd_kernel_fn, ms.bwd_scratch_shapes = saved


def bwd_build_stats(lib, log, nvcc, text):
    """Registers and spills (ptxas) of the backward's bf16, N = 16 kernel
    and of its library, and the SASS of that kernel's forward-sweep and
    reverse loops (the loops with MUFU.EX2 and none inside them): their
    instructions and MUFU.EX2 a state-step.  A turn of each loop covers
    chunk x states-a-lane state-steps of a lane."""
    funcs = ptxas_functions(log)
    name = scan_function(funcs, "mamba_scan_bwd_kernel")
    geo = bwd_geometry(text)
    per_turn = geo["chunk"] * geo["states"](16)
    sass = sass_functions(lib, nvcc)
    loops = mufu_loops(sass[name]) if sass and name in sass else []
    stats = {"registers": funcs[name]["registers"] if name else None,
             "spill_bytes": funcs[name]["spill_bytes"] if name else None,
             "max_registers": max((f["registers"] or 0
                                   for f in funcs.values()), default=None),
             "spill_bytes_library": sum(f["spill_bytes"]
                                        for f in funcs.values()),
             "spill_bytes_by_state": bwd_spills(funcs),
             "state_steps_a_loop_turn": per_turn}
    if loops:
        stats["sass"] = {
            "function": name,
            "loops": [{"instructions": n, "mufu_ex2": m} for n, m, _ in loops],
            "instructions_per_state_step": sum(n for n, _, _ in loops)
            / per_turn,
            "mufu_ex2_per_state_step": sum(m for _, m, _ in loops) / per_turn}
    else:
        stats["sass"] = "not available"
    return stats


def bwd_diff(got, ref, want):
    """Each output's max |got - ref| over the largest |plain| (``want``):
    how far two designs' gradients are apart."""
    out = {}
    for name, g, r, w in zip(BWD_NAMES, got, ref, want):
        scale = w.float().abs().max().item()
        err = (g.float() - r.float()).abs().max().item()
        out[name] = err / scale if scale else err
    return out


def time_mamba_bwd(ms, launches, smi, before=None):
    """The backward at jamba's scan (bf16, B/C slices of the x_proj
    output), L2 flushed before each call, and the plain version once.  Each
    turn times the wrapper (the kernel and the fixed-order sums of its
    partials) by events and the kernel alone by the profiler's device
    time.  ``before``: the source of an earlier design, built beside this
    one and timed in the same call, in turns (plain, this, before, this);
    without it ``ms_before`` is null.  The turns of this design must agree
    within TURN_SPREAD by events and, where the profiler saw the kernel in
    both, by device time.  The output is held against the plain version's,
    and the two designs' outputs against each other."""
    from repro_torch.kernels import _build

    b, l, d, n = JAMBA_SCAN
    rng = np.random.default_rng(10)
    args = mamba_inputs(rng, b, l, d, n, torch.bfloat16,
                        dt_rank=JAMBA_DT_RANK)
    dy = mamba_dy(rng, b, l, d, torch.bfloat16)
    flush = l2_flush()
    saved = ms.mamba_scan_bwd.launches
    lib = _build.build_all()["mamba_scan_bwd"]
    text = (_build.CSRC / "mamba_scan_bwd.cu").read_text()
    stats = {"this": bwd_build_stats(lib, lib.with_suffix(".log").read_text(),
                                     _build._nvcc(), text)}
    old = None
    if before is not None:
        old_text = Path(before).read_text()
        old, blog = build_source(Path(before), "scan-bwd-before")
        stats["before"] = bwd_build_stats(old, blog, _build._nvcc(), old_text)

    def call():
        return ms.mamba_scan_bwd(*args, dy)

    def turn():
        dev = profiled_ms(call, 5, flush, "mamba_scan_bwd_kernel")
        return cuda_ms(call, 20, flush), sum(dev.values()) if dev else None

    plain_ms = cuda_ms(lambda: ms.mamba_scan_bwd_plain(*args, dy), 1, flush)
    runs = [turn()]
    before_run, apart = (None, None), None
    if old is not None:
        with scan_bwd_kernel(ms, old, old_text):
            before_run = turn()
            got_old = call()
    runs.append(turn())
    device = [r[1] for r in runs if r[1] is not None]
    spread = {"events": turn_spread([r[0] for r in runs]),
              "device": turn_spread(device) if len(device) == len(runs)
              else None}
    wide = {k: v for k, v in spread.items() if v is not None
            and v > TURN_SPREAD}
    if wide:
        raise AssertionError(f"mamba_scan_bwd: the timing turns disagree by "
                             f"{wide} ((events, device) ms: {runs}), more "
                             f"than {TURN_SPREAD:.0%}")
    errs, _ = mamba_bwd_err(ms, args, dy, "jamba prefill shape (time)")
    if old is not None:
        apart = bwd_diff(call(), got_old, ms.mamba_scan_bwd_plain(*args, dy))
    ms.mamba_scan_bwd.launches = saved  # timing launches are not the path's
    # read u, delta, dy, B, C, D (bf16) and A (f32); write du, ddelta, dB,
    # dC (bf16), dA and dD (f32)
    nbytes = (5 * b * l * d * 2 + 4 * b * l * n * 2 + d * n * 4 + d * 2
              + d * n * 4 + d * 4)
    exps = b * l * d * n  # abar_t once for every state and step
    b_ms, o_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * exps / SFU_EXP_PER_S
    kernel_ms = statistics.mean(r[0] for r in runs)
    del args, dy, flush
    torch.cuda.empty_cache()
    return {"phase": "time_mamba_bwd", "name": "mamba_scan_bwd",
            "shape": {"B": b, "L": l, "D": d, "N": n, "dtype": "bfloat16",
                      "b_c": "slices of a (B, L, dt_rank + 2N) tensor"},
            "ms": kernel_ms, "ms_runs": [r[0] for r in runs],
            "device_ms": statistics.mean(device) if device else None,
            "device_ms_runs": [r[1] for r in runs], "plain_ms": plain_ms,
            "turn_spread": spread, "turn_spread_limit": TURN_SPREAD,
            "ms_before": before_run[0], "device_ms_before": before_run[1],
            "before": str(before) if before is not None else
            "not measured: pass --mamba-bwd-before with an earlier design's "
            "source",
            "max_rel_diff_before": apart,
            "max_rel_err": errs,
            "tol": {str(k)[6:]: v for k, v in MAMBA_BWD_TOL.items()},
            "library_ms": None,
            "library_note": "no single PyTorch call computes the gradient "
                            "of a selective scan",
            "bytes": nbytes, "exps": exps, "bound_ms": max(b_ms, o_ms),
            "bound_by": "operations" if o_ms >= b_ms else "bytes",
            "bytes_ms": b_ms, "exps_ms": o_ms,
            "design_exps_ms": 2 * o_ms,
            "design_note": "2 exps a state-step (the forward sweep and the "
                           "rebuild of each tile from its checkpoint), so "
                           "the design's floor is twice the bound; "
                           "reductions in registers and shuffles, one block "
                           "barrier a tile",
            "build": stats,
            "launches_on_main_path": launches, "card": smi}


# bytes a jamba trainer step holds at its peak, as counted before the run:
# params, the stacked gradient, autograd's own gradient and the optimizer's
# new params (SGD builds the new tree before the old one goes), all bf16
def jamba_train_bytes(cfg):
    return 4 * 2 * cfg.param_count()


def train_jamba(kernels, get_config, smi):
    """The trainer's body on jamba-1.5-large-398b without experts at full
    width, cut to one super-block (8 layers: 1 attention, 7 Mamba, 8 dense
    MLPs), ``--precision bf16-pure --optimizer sgd --workers 1``, 1 x 2048
    tokens, 3 steps.  ``local_sgd``: at W = 1 it is ``sync`` without the
    exchange, and within 3 steps it averages never; ``sync``'s exchange
    would hold every gradient again as f32 buckets, twice (the Fabric
    widens to f32, then rounds to the wire and back), 71 GB for these
    8.9 B parameters.  Gates: ``mamba_scan`` and ``mamba_scan_bwd`` 7
    launches a step each; the loss finite (``train_path``'s gates)."""
    arch = "jamba-1.5-large-398b"
    over = {"num_experts": 0}
    cfg = dataclasses.replace(get_config(arch), num_layers=8, **over)
    count = jamba_train_bytes(cfg)
    if count > 75e9:
        raise AssertionError(f"train_jamba: {count / 1e9:.1f} GB counted")
    result, prof = train_path(kernels, get_config, smi,
                              strategy="local_sgd", layers=8,
                              precision="bf16-pure", steps=3,
                              phase="train_jamba", arch=arch, workers=1,
                              batch=1, seq_len=2048, optimizer="sgd",
                              cfg_over=over)
    per_step = {k: v / 3 for k, v in result["launches"].items()}
    if per_step["mamba_scan"] != 7 or per_step["mamba_scan_bwd"] != 7:
        raise AssertionError(f"train_jamba: launches a step {per_step}")
    scan = prof["port_kernels_ms"]
    result.update(params_b=cfg.param_count() / 1e9,
                  mamba_layers=mamba_layers(cfg),
                  bytes_counted_gb=count / 1e9,
                  scan_bwd_share_of_device=scan["mamba_scan_bwd_kernel"]
                  / prof["device_ms_per_step"],
                  scan_fwd_share_of_device=scan["mamba_scan_kernel"]
                  / prof["device_ms_per_step"])
    return result, prof


def train_xlstm(kernels, get_config, smi):
    """xlstm-125m at full width cut to 6 of its 12 layers (3 mLSTM, 3
    sLSTM; 12 until PR 28, for the run's budget), f32,
    ``sync --compressor onebit --fused-adam``, W = 2, 2 x 256 tokens a
    replica, 3 steps (5 until the run's budget took the model axis's
    phases): ``train_path``'s wire, events, divergence and launch
    gates (no scan launch: xLSTM has no Mamba layer).  The host clock
    around each sLSTM layer's forward (no synchronize: the time its loop
    takes to launch its kernels) gives the loop's host share of a step.
    Not profiled: a step launches ~225,000 kernels, and reading such a
    trace took ~140 s on the H100's host."""
    from repro_torch.models import transformer as T

    layer = T._RECURRENT["slstm"]["layer"]
    host = {"s": 0.0, "calls": 0}

    def timed(*args, **kw):
        t0 = time.perf_counter()
        out = layer(*args, **kw)
        host["s"] += time.perf_counter() - t0
        host["calls"] += 1
        return out

    T._RECURRENT["slstm"]["layer"] = timed
    try:
        result, _ = train_path(kernels, get_config, smi,
                               compressor="onebit", layers=6, steps=3,
                               phase="train_xlstm", arch="xlstm-125m",
                               workers=2, batch=2, seq_len=256,
                               profile=False)
    finally:
        T._RECURRENT["slstm"]["layer"] = layer
    per_step = 1e3 * host["s"] / result["steps"]
    result.update(slstm_forward_calls=host["calls"],
                  slstm_forward_host_ms_per_step=per_step,
                  slstm_forward_share_of_step=per_step
                  / result["step_ms_median"],
                  slstm_note="the host time of the sLSTM layers' forward "
                  "(3 layers x 2 replicas x 256 steps a train step); their "
                  "backward runs in autograd's engine and is not timed")
    return result, None


def recurrent_train_cases(get_config):
    jamba = get_config("jamba-1.5-large-398b").reduced()
    return [("jamba_moe", jamba, 41),
            ("jamba", dataclasses.replace(jamba, num_experts=0,
                                          num_layers=8), 42),
            ("xlstm", dataclasses.replace(get_config("xlstm-125m"),
                                          num_layers=4), 43)]


def recurrent_train_side(get_config, dev):
    """``recurrent_train_card_vs_cpu``'s runs on ``dev``, by case: the
    loss and every leaf's gradient (on the host), 3 steps' losses and the
    seconds; on the card the scan kernels' launches, checked against one
    of each a Mamba layer a gradient, and on the jamba cut the remat
    check (``remat_equal``)."""
    from repro_torch.core import tree as TR
    from repro_torch.core.comm import LocalComm
    from repro_torch.core.strategies import get_strategy
    from repro_torch.data.pipeline import DataConfig, microbatch_stack
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.models import transformer as T
    from repro_torch.optim import sgd
    from repro_torch.train import loop as LOOP

    out = {}
    for name, cfg, seed in recurrent_train_cases(get_config):
        params = T.init_model(torch.Generator().manual_seed(seed), cfg,
                              device="cpu")
        params = contractive_slstm(params, cfg)
        rng = np.random.default_rng(seed)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64)))
        dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                          batch_per_worker=2, seed=seed)
        lf = LOOP.make_loss_fn(cfg, remat=False)
        prm = _tree(params, lambda t: t.to(dev))
        batch = {"tokens": toks.to(dev), "labels": toks.to(dev)}
        ms.mamba_scan.launches = ms.mamba_scan_bwd.launches = 0
        t0 = time.perf_counter()
        loss, grads = loss_and_grads(LOOP, TR, prm, cfg, batch)
        got = (ms.mamba_scan.launches, ms.mamba_scan_bwd.launches)
        want = (mamba_layers(cfg), mamba_layers(cfg)) \
            if dev == "cuda" else (0, 0)
        if got != want:
            raise AssertionError(f"{name} on {dev}: scan launches "
                                 f"(forward, backward) {got}, expected "
                                 f"{want}")
        comm = LocalComm(2)
        opt = sgd(1e-2)
        strat = get_strategy("sync")
        state = LOOP.init_train_state(comm.replicate(prm), opt, strat, comm)
        step = LOOP.make_replica_train_step(
            lambda p, x: lf(p, {"tokens": x, "labels": x}), opt, strat,
            comm)
        losses = []
        for t in range(3):
            state, m = step(state, microbatch_stack(dcfg, 2, t, 1,
                                                    device=dev)[0])
            losses.append(float(m["loss"]))
        res = {"loss": loss, "grads": grads, "losses": losses,
               "s": time.perf_counter() - t0,
               "launches": {"mamba_scan": ms.mamba_scan.launches,
                            "mamba_scan_bwd": ms.mamba_scan_bwd.launches},
               "paths": [".".join(x) for x in _paths(params)]}
        del prm, state, step
        if name == "jamba" and dev == "cuda":
            res["remat"] = remat_equal(LOOP, TR, ms, params, cfg, toks)
        out[name] = res
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return out


def recurrent_train_card_vs_cpu(get_config, smi, cpu):
    """f32, TF32 off, the same parameters and batches on the card and the
    CPU (``cpu``: ``recurrent_train_side``'s CPU run, from the
    ``cpu_half`` worker): jamba ``.reduced()`` with its experts (16
    layers) and without (one super-block, 8 layers), xlstm-125m at full
    width cut to 4 layers (its sLSTM weights made contractive,
    ``contractive_slstm``).  One ``make_loss_fn`` loss and gradient (2 x
    64 tokens): loss within 1e-4, every leaf within GRAD_RTOL of its
    largest |g|; then 3 steps of ``make_replica_train_step`` (``sync``,
    W = 2, SGD at lr 1e-2: Adam's first update, lr * sign(g), would turn
    last-bit differences on elements near 0 into whole steps,
    tests/test_torch_recurrent_train.py), each step's loss within 1e-4.
    On the card each Mamba layer launches the scan and its backward once
    a gradient; on the jamba cut the gradients with remat (the scan
    twice) must be ``torch.equal`` to those without, except on a leaf
    whose two runs without remat differ themselves (an atomic sum), where
    rtol 1e-5 holds."""
    out = {"phase": "recurrent_train_card_vs_cpu", "dtype": "float32",
           "tol_loss_rel": 1e-4, "grad_tol_of_leaf_max": GRAD_RTOL,
           "steps": 3, "workers": 2, "optimizer": "sgd lr 1e-2",
           "archs": {}}
    launches = {"mamba_scan": 0, "mamba_scan_bwd": 0}
    card = recurrent_train_side(get_config, "cuda")
    for name, cfg, _ in recurrent_train_cases(get_config):
        a, b = card[name], cpu[name]
        for k in launches:
            launches[k] += a["launches"][k]
        loss_rel = rel_diff(a["loss"], b["loss"])
        step_rel = max(rel_diff(x, y) for x, y in zip(a["losses"],
                                                      b["losses"]))
        if not (loss_rel <= 1e-4 and step_rel <= 1e-4):
            raise AssertionError(f"{name} card vs CPU: loss {a['loss']} vs "
                                 f"{b['loss']}, steps {a['losses']} vs "
                                 f"{b['losses']}")
        ratios = grads_close(name, a["paths"], a["grads"], b["grads"])
        entry = {"layers": cfg.num_layers, "d_model": cfg.d_model,
                 "experts": cfg.num_experts,
                 "mamba_layers": mamba_layers(cfg), "tokens": [2, 64],
                 "loss_card": a["loss"], "loss_cpu": b["loss"],
                 "loss_rel_diff": loss_rel, "step_losses_card": a["losses"],
                 "step_losses_cpu": b["losses"],
                 "step_loss_max_rel_diff": step_rel,
                 "grad_leaves": len(a["paths"]),
                 "grad_max_err_over_leaf_max": max(ratios.values()),
                 "worst_leaves": dict(sorted(ratios.items(),
                                             key=lambda kv: -kv[1])[:4]),
                 "cuda_s": a["s"], "cpu_s": b["s"]}
        if "remat" in a:
            entry["remat"] = a["remat"]
            launches["mamba_scan"] += a["remat"]["scan_launches"]
            launches["mamba_scan_bwd"] += a["remat"]["bwd_launches"]
        out["archs"][name] = entry
    out["launches_on_card"] = launches
    out["card"] = smi
    return out, launches


def remat_equal(LOOP, TR, ms, params, cfg, toks):
    """On the card: the gradients with remat (each Mamba layer's scan
    launched twice, its backward once) against those without, run twice
    without remat to tell an atomic sum's own spread from remat's."""
    prm = _tree(params, lambda t: t.to("cuda"))
    batch = {"tokens": toks.to("cuda"), "labels": toks.to("cuda")}
    runs, total = {}, [0, 0]
    for key, remat in (("plain", False), ("remat", True), ("again", False)):
        ms.mamba_scan.launches = ms.mamba_scan_bwd.launches = 0
        runs[key] = loss_and_grads(LOOP, TR, prm, cfg, batch, remat=remat)
        if key == "remat":
            scan = (ms.mamba_scan.launches, ms.mamba_scan_bwd.launches)
        total[0] += ms.mamba_scan.launches
        total[1] += ms.mamba_scan_bwd.launches
    n = mamba_layers(cfg)
    if scan != (2 * n, n):
        raise AssertionError(f"remat: scan launches (forward, backward) "
                             f"{scan}, expected {(2 * n, n)}")
    paths = [".".join(x) for x in _paths(params)]
    differ, nondet, worst = [], [], 0.0
    for path, a, b, c in zip(paths, runs["remat"][1], runs["plain"][1],
                             runs["again"][1]):
        if not torch.equal(c, b):
            nondet.append(path)
        if not torch.equal(a, b):
            differ.append(path)
            worst = max(worst, ((a - b).abs().max()
                                / b.abs().max().clamp_min(1e-30)).item())
    bad = [p for p in differ if p not in nondet]
    if bad or worst > 1e-5 or runs["remat"][0] != runs["plain"][0]:
        raise AssertionError(f"remat: {bad or differ} differ (rel {worst}); "
                             f"loss {runs['remat'][0]} vs "
                             f"{runs['plain'][0]}")
    return {"loss_equal": True, "leaves": len(paths),
            "leaves_not_bitwise": differ,
            "leaves_nondeterministic_without_remat": nondet,
            "max_rel_diff": worst, "remat_scan_launches": list(scan),
            "scan_launches": total[0], "bwd_launches": total[1]}


# ---------------------------------------------------------------------------
# the sharded path: rank processes sharing the card over gloo
# ---------------------------------------------------------------------------
SHARD_W = 2  # ranks of train_sharded and sharded_strategies
# the pool: shard_comm at 4 ranks; train_sharded's cases and the
# strategies on two meshes of 2 ranks at once (0-1 and 2-3, case i on
# mesh i % 2), since PR 28, for the run's time budget
SHARD_POOL = 4
SHARD_STEPS = 2  # 3 until PR 28 (the run's time budget)
SHARD_SEED = 25
SHARD_LR = 1e-3
# train_sharded: (zero stage, accum steps, compressor, precision)
SHARD_CASES = {
    "sync": (0, 1, None, "f32"),
    "accum2": (0, 2, None, "f32"),
    "onebit": (0, 1, "onebit", "f32"),
    "topk": (0, 1, "topk", "f32"),
    "zero1": (1, 1, None, "f32"),
    "zero2_accum2": (2, 2, None, "f32"),
    "zero3": (3, 1, None, "f32"),
    "zero1_bf16_accum2": (1, 2, None, "bf16"),
}
# sharded_strategies: (strategy kwargs, compressor)
SHARD_STRATEGIES = {"local_sgd": ({"sync_every": 2}, None),
                    "gossip": ({}, None),
                    "downpour": ({"push_every": 2}, "onebit")}
SHARD_LAYERS = 2  # train_sharded's and sharded_strategies' qwen2 cut
COMM_ROWS = (3, 40)  # the primitives' rows: 40 divides by 2 and 4


def shard_cfg(get_config, layers, precision="f32"):
    from repro_torch.core.precision import apply_policy, get_policy

    cfg = dataclasses.replace(get_config("qwen2-1.5b"), num_layers=layers)
    return cfg if precision == "f32" else apply_policy(
        cfg, get_policy(precision))


def shard_init(cfg):
    """The seeded full-width parameters, the same in every process."""
    from repro_torch.models import transformer as T

    gen = torch.Generator(device="cuda").manual_seed(SHARD_SEED)
    return T.init_model(gen, cfg, "cuda")


def shard_compressor(name):
    from repro_torch.core.compression import get_compressor

    if name is None:
        return None
    return get_compressor("topk", ratio=0.01) if name == "topk" \
        else get_compressor(name)


def shard_data(cfg):
    from repro_torch.data.pipeline import DataConfig

    return DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_L,
                      batch_per_worker=TRAIN_B)


def shard_strategy(name, comp_name):
    from repro_torch.core import strategies as ST

    kw, _ = SHARD_STRATEGIES[name]
    comp = shard_compressor(comp_name)
    return ST.get_strategy(name, **kw, **({"compressor": comp}
                                          if comp is not None else {}))


def leaf_digests(state):
    """sha256 of every leaf's bytes, in tree order, but the step counter:
    each leaf copied into pinned host memory and hashed in place, 8 leaves
    at a time (hashlib lets go of the interpreter lock)."""
    import hashlib

    from repro_torch.core import tree as TT

    def one(x):
        t = x.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
        host.copy_(t)
        return hashlib.sha256(
            memoryview(host.reshape(-1).numpy()).cast("B")).hexdigest()

    leaves = TT.leaves({k: v for k, v in state.items() if k != "step"})
    with ThreadPoolExecutor(8) as pool:
        return list(pool.map(one, leaves))


def comm_primitives(comm, x):
    """Every ``Comm`` op of one tensor, by name (a rank's row under
    ``ShardComm``, the stacked rows under ``LocalComm``)."""
    out = {"all_gather_tiled": comm.all_gather([x], tiled=True)[0],
           "ppermute_1": comm.ppermute([x], 1)[0],
           "ppermute_-1": comm.ppermute([x], -1)[0],
           "shard_chunk": comm.shard_chunk([x])[0],
           "all_sum": comm.all_sum([x])[0],
           "reduce_scatter_sum": comm.reduce_scatter([x])[0]}
    if x.is_floating_point():
        out["all_mean"] = comm.all_mean([x])[0]
        out["reduce_scatter_mean"] = comm.reduce_scatter([x], mean=True)[0]
    return out


def comm_rows(world):
    """(W, 3, 40) rows of f32, bf16 and uint8 on the card, from a seed."""
    rng = np.random.default_rng(world)
    f = torch.from_numpy(rng.standard_normal((world,) + COMM_ROWS)
                         .astype(np.float32))
    u = torch.from_numpy(rng.integers(0, 256, (world,) + COMM_ROWS)
                         .astype(np.uint8))
    return {"float32": f.cuda(), "bfloat16": f.to(torch.bfloat16).cuda(),
            "uint8": u.cuda()}


def comm_timing(comm, group):
    """ms (median of 5 after a warm-up, the ranks released together by a
    barrier) and GB/s of the bytes this rank hands to the backend, for
    one ``DEFAULT_BUCKET_BYTES`` f32 bucket."""
    import torch.distributed as dist

    from repro_torch.core.fabric import DEFAULT_BUCKET_BYTES

    n = DEFAULT_BUCKET_BYTES // 4
    x = torch.randn(n, device="cuda")
    shard = x[: n // comm.size].clone()
    ops = {"all_mean": lambda: comm.all_mean([x]),
           "gather_chunks": lambda: comm.gather_chunks([x]),
           "all_gather_shard": lambda: comm.all_gather([shard], tiled=True),
           "all_gather_bucket": lambda: comm.all_gather([x]),
           "ppermute": lambda: comm.ppermute([x], 1)}
    out = {}
    for name, fn in ops.items():
        times = []
        for i in range(6):
            dist.barrier(group=group)
            torch.cuda.synchronize()
            before = sum(v[1] for v in comm.stats.values())
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            if i:
                times.append(1e3 * (time.perf_counter() - t0))
            sent = sum(v[1] for v in comm.stats.values()) - before
        ms = statistics.median(times)
        out[name] = {"ms": ms, "bytes_sent": sent,
                     "gb_per_s": sent / ms / 1e6}
    return out


def rank_device_ms(prof):
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.self_device_time_total for e in events) / 1e3


def rank_train(mesh, rank, run, cfg, steps, accum, kernels):
    """``steps`` steps of one sharded-step case on this rank: the
    launches of each kernel (counts zeroed just before), the comm's
    counters a step, the host ms of each step, the device ms of the last
    (under the profiler), the peak GB, the losses and the final state's
    digests."""
    from repro_torch.data.pipeline import rank_batch

    state, step = run
    data = shard_data(cfg)
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, losses, stats = [], [], []
    prof = None
    for t in range(steps):
        x = rank_batch(data, rank, t, accum, "cuda")
        batch = {"tokens": x, "labels": x}
        torch.cuda.synchronize()
        if t == steps - 1:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        t0 = time.perf_counter()
        state, loss = step(state, batch)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        if t == steps - 1:
            prof.__exit__(None, None, None)
        losses.append(float(loss))
        stats.append({k: tuple(v) for k, v in step.comm.stats.items()})
    t0 = time.perf_counter()
    digests = leaf_digests(state)
    return {"launches": {k: fn.launches for k, fn in kernels.items()},
            "step_ms": ms, "device_ms_last": rank_device_ms(prof),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "losses": losses, "stats": stats, "digests": digests,
            "digest_s": time.perf_counter() - t0}


def shard_rank(rank, world):
    """One rank of the pool: ``shard_comm`` at 4 ranks, then on ranks 0
    and 1 (a 2-rank mesh of the pool) ``shard_comm`` at 2 ranks, then on
    two 2-rank meshes at once (0-1 and 2-3, ``shard_half``) the cases of
    ``train_sharded`` and ``sharded_strategies``, then on all 4 ranks as
    data 2 x model 2 ``train_tp`` and ``train_ep``
    (``model_axis_rank``), then the rest of the model axis
    (``axis_rank``).  Every kernel's launches are this process's
    counts."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core.comm import ShardComm
    from repro_torch.core.fabric import BucketLayout
    from repro_torch.core.precision import get_policy
    from repro_torch.kernels import fused_adam as fa
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import onebit_quant as ob
    from repro_torch.kernels import topk_sparsify as tk
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.optim import optimizers as TO
    from repro_torch.train import loop as LOOP

    torch.backends.cuda.matmul.allow_tf32 = False
    kernels = {"fused_adam": fa.fused_adam,
               "onebit_quant_packed": ob.onebit_quant_packed,
               "topk_encode_ef": tk.topk_encode_ef}
    out = {"comm": {}, "seconds": {}}
    t0 = time.perf_counter()
    comm4 = ShardComm()
    halves = [make_mesh((SHARD_W,), ("pod",), backend="gloo", ranks=rs)
              for rs in ((0, 1), (2, 3))]
    half = rank // SHARD_W
    mesh2 = halves[half]
    for w, comm in ((world, comm4),
                    (SHARD_W, mesh2.comm("pod") if half == 0 else None)):
        if comm is None:
            continue
        rows = comm_rows(w)
        res = {dt: {k: v.cpu() for k, v in comm_primitives(
            comm, x[rank]).items()} for dt, x in rows.items()}
        for dt, x in rows.items():
            res[dt]["all_gather"] = comm.all_gather([x[rank]])[0].cpu()
            res[dt]["gather_chunks"] = comm.gather_chunks([x[rank]])[0].cpu()
        out["comm"][w] = {
            "results": res, "transport": comm.transport("cuda"),
            "worker_index": int(comm.worker_index()),
            "timing": comm_timing(comm, comm.group)}
    out["seconds"]["shard_comm"] = time.perf_counter() - t0

    def model_axis():  # every rank of the pool, once the others are done
        dist.barrier()
        t0 = time.perf_counter()
        out["model_axis"] = model_axis_rank(rank, kernels)
        out["seconds"]["model_axis"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["axis"] = axis_rank(rank, {**kernels,
                                       "mamba_scan": ms.mamba_scan,
                                       "mamba_scan_bwd": ms.mamba_scan_bwd})
        out["seconds"]["axis"] = time.perf_counter() - t0
        return out

    t0 = time.perf_counter()
    out["train"] = {}
    for case, (zero, accum, comp_name, prec) in SHARD_CASES.items():
        if shard_half(case, SHARD_CASES) != half:
            continue
        cfg = shard_cfg(get_config, SHARD_LAYERS, prec)
        pol = None if prec == "f32" else get_policy(prec)
        comp = shard_compressor(comp_name)
        params = shard_init(cfg)
        opt = TO.adam(SHARD_LR, fused=True)
        state = LOOP.init_sharded_state(params, opt, mesh2, zero_stage=zero,
                                        pod_compressor=comp, policy=pol)
        template = T.init_model(torch.Generator(), cfg, "meta") \
            if zero >= 3 else None
        del params
        step = LOOP.make_sharded_train_step(
            cfg, opt, mesh2, remat=False, pod_compressor=comp,
            zero_stage=zero, accum_steps=accum, policy=pol,
            param_template=template)
        lay = BucketLayout.build(
            T.init_model(torch.Generator(), cfg, "meta"))
        res = rank_train(mesh2, mesh2.rank, (state, step), cfg,
                         SHARD_STEPS, accum, kernels)
        res["layout"] = {"n_buckets": lay.n_buckets,
                         "n_leaves": lay.n_leaves,
                         "bucket_sizes": list(lay.bucket_sizes)}
        out["train"][case] = res
        del state, step
        gc.collect()
        torch.cuda.empty_cache()
    out["seconds"]["train_sharded"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["strategies"] = {}
    cfg = shard_cfg(get_config, SHARD_LAYERS)
    for name, (_, comp_name) in SHARD_STRATEGIES.items():
        if shard_half(name, SHARD_STRATEGIES) != half:
            continue
        strat = shard_strategy(name, comp_name)
        comm = mesh2.comm("pod")
        opt = TO.adam(SHARD_LR, fused=True)
        state = LOOP.init_train_state(shard_init(cfg), opt, strat, comm)
        step = LOOP.make_sharded_train_step(cfg, opt, mesh2, strategy=strat,
                                            comm=comm, remat=False)
        out["strategies"][name] = rank_train(mesh2, mesh2.rank,
                                             (state, step), cfg, SHARD_STEPS,
                                             1, kernels)
        del state, step
        gc.collect()
        torch.cuda.empty_cache()
    out["seconds"]["sharded_strategies"] = time.perf_counter() - t0
    return model_axis()


def shard_half(case, cases):
    """The 2-rank mesh of the pool (0: ranks 0-1, 1: ranks 2-3) that runs
    one of ``cases``' keys."""
    return list(cases).index(case) % 2


def nccl_rank(rank, world):
    """One sync step of the sharded path over NCCL at world size 1."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import rank_batch
    from repro_torch.kernels import fused_adam as fa
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import optimizers as TO
    from repro_torch.train import loop as LOOP

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = shard_cfg(get_config, TRAIN_LAYERS)
    mesh = make_mesh((1,), ("pod",))
    opt = TO.adam(SHARD_LR, fused=True)
    state = LOOP.init_sharded_state(shard_init(cfg), opt, mesh)
    step = LOOP.make_sharded_train_step(cfg, opt, mesh, remat=False)
    x = rank_batch(shard_data(cfg), 0, 0, 1, "cuda")
    fa.fused_adam.launches = 0
    state, loss = step(state, {"tokens": x, "labels": x})
    return {"loss": float(loss), "digests": leaf_digests(state),
            "fused_adam_launches": fa.fused_adam.launches,
            "backend": str(step.comm.backend),
            "transport": step.comm.transport("cuda"),
            "stats": {k: tuple(v) for k, v in step.comm.stats.items()}}


# ---------------------------------------------------------------------------
# the model axis: tensor and expert parallelism on data 2 x model 2
# ---------------------------------------------------------------------------
MODEL_MESH = (2, 2)  # ("data", "model") over the pool's 4 ranks
TP_N = 2
# train_tp (qwen2-1.5b, 4 layers, fused Adam): (zero stage, compressor);
# each rank's unsplit params after SHARD_STEPS steps within (atol, share of
# the elements beyond 1e-6) of the one-process replica step at tp_degree
# 2, W = 2: the CPU tests' bounds under Adam
# (tests/test_torch_sharded_step.py::TP_BOUNDS)
TP_CASES = {"onebit": (0, "onebit"), "zero1": (1, None)}
TP_TOL = {"onebit": (2e-2, 2e-2), "zero1": (2e-3, 2e-3)}
# train_ep (granite-moe-1b-a400m, 4 layers): a data rank's rows, 4096
# tokens (8192 global, so the EP branch); step 0's loss and MoE gradients
# at capacity factor 8 against the one-device dispatch at
# tests/test_torch_ep.py's bounds (loss 1e-4 relative, each gradient
# within 1e-3 of its leaf's largest), with the router's aux coefficient 0
# there: the EP aux is the mean of each model rank's slice's aux (the
# reference's), which is not the one-device aux over the same tokens
EP_LAYERS, EP_B, EP_L, EP_SEED, EP_DENSE_CF = 4, 4, 1024, 26, 8.0
EP_TOL = {"loss": 1e-4, "grad_rel": 1e-3}
MODEL_REF_DIR = ROOT / "build" / "model_axis"


def tp_cfg(get_config):
    return dataclasses.replace(shard_cfg(get_config, TRAIN_LAYERS),
                               tp_degree=TP_N)


def ep_cfg(get_config, cf=None):
    """granite cut to EP_LAYERS; with ``cf`` the comparison's config: that
    capacity factor and no aux term."""
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m"),
                              num_layers=EP_LAYERS)
    return cfg if cf is None else dataclasses.replace(
        cfg, capacity_factor=cf, router_aux_coef=0.0)


def ep_init(cfg):
    from repro_torch.models import transformer as T

    gen = torch.Generator(device="cuda").manual_seed(EP_SEED)
    return T.init_model(gen, cfg, "cuda")


def ep_data(cfg):
    from repro_torch.data.pipeline import DataConfig

    return DataConfig(vocab_size=cfg.vocab_size, seq_len=EP_L,
                      batch_per_worker=EP_B)


def _moe_leaves(tree):
    """The MoE subtrees of a param (or gradient) tree, in its layout."""
    return {"stack": {k: {"moe": v["moe"]}
                      for k, v in tree["stack"].items() if "moe" in v}}


def tp_reference(get_config, case, strategy=None, steps=SHARD_STEPS):
    """``train_tp``'s one-process reference: the replica step at tp_degree
    2 and W = 2 (``LocalComm``), fused Adam, run per (model rank, part) as
    tests/_torch_model_ranks.py::tp_replica_run: each part's loss is the
    blocked form's on the full tree assembled from it and, from the
    batch, a copy of every other part before the step, so each part's
    buckets (and the 1-bit blocks) are the ranks'.  Saves each data
    replica's full params after ``steps`` steps for the ranks
    (``MODEL_REF_DIR``) and returns the losses.  With ``strategy`` (a
    ``TP_STRATEGIES`` key) that strategy's exchange instead of
    ``TP_CASES[case]``'s."""
    from repro_torch.core import strategies as ST
    from repro_torch.core import tree as TT
    from repro_torch.core.comm import LocalComm
    from repro_torch.data.pipeline import microbatch_stack
    from repro_torch.models import tensor_parallel as TP
    from repro_torch.optim import optimizers as TO
    from repro_torch.train import loop as LOOP

    zero, comp = TP_CASES[case] if strategy is None else (0, None)
    cfg = tp_cfg(get_config)
    comm = LocalComm(SHARD_W)
    lf = LOOP.make_loss_fn(cfg, remat=False)
    full = shard_init(cfg)
    runs = {}
    for m in range(TP_N):
        parts = TP._partition_replicated(TP.tp_rank_params(full, TP_N, m))
        for n, sub in zip(("rep", "split"), parts):
            strat = (shard_strategy_of(strategy) if strategy
                     else ST.get_strategy("sync_zero1") if zero
                     else ST.sync(shard_compressor(comp)))
            opt = TO.adam(SHARD_LR, fused=True)
            state = LOOP.init_train_state(comm.replicate(sub), opt, strat,
                                          comm)

            def loss(p, b, m=m, n=n):
                trees = [TP._merge_trees(
                    p if n == "rep" else b["others"][r]["rep"],
                    p if (n == "split" and r == m) else b["others"][r]["split"])
                    for r in range(TP_N)]
                return lf(TP.tp_unsplit_ranks(trees), b)

            runs[(m, n)] = [state, LOOP.make_replica_train_step(
                loss, opt, strat, comm)]
        del parts, sub
    del full
    data = shard_data(cfg)
    losses = []
    for t in range(steps):
        x = microbatch_stack(data, SHARD_W, t, 1, "cuda")[0]
        # copies: fused Adam updates the params in place
        others = [{n: TT.tree_map(torch.clone, runs[(r, n)][0]["params"])
                   for n in ("rep", "split")} for r in range(TP_N)]
        for run in runs.values():
            run[0], met = run[1](run[0], {"tokens": x, "labels": x,
                                          "others": others})
        losses.append(float(met["loss"]))
        del others
    MODEL_REF_DIR.mkdir(parents=True, exist_ok=True)
    for w in range(SHARD_W):
        trees = [TP._merge_trees(*(
            TT.tree_map(lambda v: v[w], runs[(r, n)][0]["params"])
            for n in ("rep", "split"))) for r in range(TP_N)]
        torch.save(TT.tree_map(lambda v: v.cpu(), TP.tp_unsplit_ranks(trees)),
                   MODEL_REF_DIR / f"tp_{case}_{w}.pt")
    del runs
    gc.collect()
    torch.cuda.empty_cache()
    return losses


def ep_reference(get_config):
    """``train_ep``'s one-process reference: the full model on one data
    rank's rows at capacity factor 8 without the aux term (no mesh:
    ``_moe_dense``, every expert whole), the loss and the MoE leaves'
    gradients, saved for the ranks; per data rank."""
    from repro_torch.core import tree as TT
    from repro_torch.data.pipeline import rank_batch
    from repro_torch.train import loop as LOOP

    cfg = ep_cfg(get_config, EP_DENSE_CF)
    params = ep_init(cfg)
    lf = LOOP.make_loss_fn(cfg, remat=False)
    MODEL_REF_DIR.mkdir(parents=True, exist_ok=True)
    losses = []
    for d in range(MODEL_MESH[0]):
        x = rank_batch(ep_data(cfg), d, 0, 1, "cuda")
        leaves, tdef = TT.flatten(params)
        pw = [v.detach().requires_grad_() for v in leaves]
        loss = lf(TT.unflatten(tdef, pw), {"tokens": x, "labels": x})
        grads = TT.unflatten(tdef, list(torch.autograd.grad(loss, pw)))
        losses.append(float(loss.detach()))
        torch.save(TT.tree_map(lambda v: v.cpu(), _moe_leaves(grads)),
                   MODEL_REF_DIR / f"ep_grads_{d}.pt")
        del pw, loss, grads
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return losses


def _held(got, ref):
    """Leaf by leaf on the card: (max |got - ref|, elements beyond 1e-6,
    elements, max over leaves of max |d| / max |ref|)."""
    from repro_torch.core import tree as TT

    worst, beyond, n, rel = 0.0, 0, 0, 0.0
    for a, b in zip(TT.leaves(got), TT.leaves(ref)):
        b = b.to(a.device)
        d = (a.float() - b.float()).abs()
        worst = max(worst, d.max().item())
        beyond += int((d > 1e-6).sum())
        n += d.numel()
        rel = max(rel, d.max().item() / max(b.abs().max().item(), 1e-30))
    return worst, beyond, n, rel


def model_axis_rank(rank, kernels):
    """``train_tp`` and ``train_ep`` on this rank of the pool's data 2 x
    model 2 mesh (every rank of the pool calls it).  Each case: the
    kernels' launches, step ms (host, after a synchronize), the last
    step's device ms (profiled), peak GB, the losses, the model group's
    collectives (count and payload bytes), the batch group's bytes a step,
    and each rank's final params held against the one-process reference
    saved under ``MODEL_REF_DIR`` (its model shard of them)."""
    from repro_torch.configs import get_config
    from repro_torch.core import tree as TT
    from repro_torch.data.pipeline import rank_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers as L
    from repro_torch.models import tensor_parallel as TP
    from repro_torch.optim import optimizers as TO
    from repro_torch.train import loop as LOOP

    mesh = make_mesh(MODEL_MESH, ("data", "model"), backend="gloo")
    d, m = mesh.coords["data"], mesh.coords["model"]
    mc = mesh.shared_comm("model")
    out = {"coords": (d, m), "tp": {}, "ep": {}}

    def run(step, state, cfg, data, steps):
        for fn in kernels.values():
            fn.launches = 0
        ops0 = {k: tuple(v) for k, v in mc.ops.items()}
        sent0 = sum(v[1] for v in mc.stats.values())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms, losses, stats, prof = [], [], [], None
        for t in range(steps):
            x = rank_batch(data, d, t, 1, "cuda")
            torch.cuda.synchronize()
            if t == steps - 1:
                prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
                prof.__enter__()
            t0 = time.perf_counter()
            state, loss = step(state, {"tokens": x, "labels": x})
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            if t == steps - 1:
                prof.__exit__(None, None, None)
            losses.append(float(loss))
            stats.append({k: tuple(v) for k, v in step.comm.stats.items()})
        model_ops = {k: [v[0] - ops0.get(k, (0, 0))[0],
                         v[1] - ops0.get(k, (0, 0))[1]]
                     for k, v in mc.ops.items()}
        res = {"launches": {k: fn.launches for k, fn in kernels.items()},
               "step_ms": ms, "device_ms_last": rank_device_ms(prof),
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "losses": losses, "model_ops": model_ops,
               "batch_bytes_per_step": [
                   sum(v[1] for v in stats[t].values())
                   - (sum(v[1] for v in stats[t - 1].values()) if t else 0)
                   for t in range(steps)],
               "model_bytes_per_step": (sum(v[1] for v in mc.stats.values())
                                        - sent0) / steps}
        return state, res

    for case, (zero, comp_name) in TP_CASES.items():
        cfg = tp_cfg(get_config)
        opt = TO.adam(SHARD_LR, fused=True)
        state = LOOP.init_sharded_state(shard_init(cfg), opt, mesh,
                                        zero_stage=zero,
                                        pod_compressor=shard_compressor(
                                            comp_name), cfg=cfg)
        step = LOOP.make_sharded_train_step(
            cfg, opt, mesh, remat=False, zero_stage=zero,
            pod_compressor=shard_compressor(comp_name))
        state, res = run(step, state, cfg, shard_data(cfg), SHARD_STEPS)
        ref = torch.load(MODEL_REF_DIR / f"tp_{case}_{d}.pt", mmap=True,
                         weights_only=True)
        mine = TP._merge_trees(*LOOP.model_shard(ref, mesh, cfg).values())
        res["held"] = _held(step.params_of(state), mine)
        res["leaves"] = {n: len(TT.leaves(state["params"][n]))
                         for n in ("rep", "split")} if not zero else None
        out["tp"][case] = res
        del state, step, ref, mine
        gc.collect()
        torch.cuda.empty_cache()

    # train_ep: step 0's gradients at capacity factor 8, then SHARD_STEPS
    # steps at the config's
    cfg8, cfg = ep_cfg(get_config, EP_DENSE_CF), ep_cfg(get_config)
    opt = TO.adam(SHARD_LR, fused=True)
    state = LOOP.init_sharded_state(ep_init(cfg), opt, mesh, cfg=cfg)
    ep_calls, kept = [], []
    route, moe_ep = L._route, L._moe_ep

    def route_spy(*args):
        res = route(*args)
        kept.append((int(res[2].sum()), res[2].numel()))
        return res

    def ep_spy(*args):
        ep_calls.append(1)
        return moe_ep(*args)

    L._route, L._moe_ep = route_spy, ep_spy
    try:
        x = rank_batch(ep_data(cfg), d, 0, 1, "cuda")
        step8 = LOOP.make_sharded_train_step(cfg8, opt, mesh, remat=False)
        loss8, grads = step8.local_grads(state, {"tokens": x, "labels": x})
        merged = TP._merge_trees(grads["rep"], grads["split"])
        ref = torch.load(MODEL_REF_DIR / f"ep_grads_{d}.pt", mmap=True,
                         weights_only=True)
        mine = TP.tp_rank_params(ref, TP_N, m, experts=True)
        out["ep"]["grads_held"] = _held(_moe_leaves(merged), mine)
        out["ep"]["loss_cf8"] = float(loss8)
        out["ep"]["ep_calls_cf8"] = len(ep_calls)
        del grads, merged, ref, mine, step8
        ep_calls.clear()
        kept.clear()
        step = LOOP.make_sharded_train_step(cfg, opt, mesh, remat=False)
        state, res = run(step, state, cfg, ep_data(cfg), SHARD_STEPS)
    finally:
        L._route, L._moe_ep = route, moe_ep
    res["ep_calls"] = len(ep_calls)
    res["kept_rows"] = kept
    res["leaves"] = {n: len(TT.leaves(state["params"][n]))
                     for n in ("rep", "split")}
    out["ep"]["train"] = res
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def sharded_references(get_config):
    """The stacked ``LocalComm`` runs the rank phases are held to, run in
    this process first: per case each replica's leaf digests and the
    losses (the replica step with the matching strategy, the same seeded
    parameters and batches).  Every state is freed after its digests."""
    from repro_torch.bridge import rank_state
    from repro_torch.core import strategies as ST
    from repro_torch.core.comm import LocalComm
    from repro_torch.core.precision import get_policy
    from repro_torch.data.pipeline import microbatch_stack
    from repro_torch.optim import optimizers as TO
    from repro_torch.train import loop as LOOP

    def run(cfg, strat, pol, accum, w=SHARD_W, steps=SHARD_STEPS):
        comm = LocalComm(w)
        opt = TO.adam(SHARD_LR, fused=True)
        state = LOOP.init_train_state(comm.replicate(shard_init(cfg)), opt,
                                      strat, comm, policy=pol)
        lf = LOOP.make_loss_fn(cfg, remat=False)
        step = LOOP.make_replica_train_step(
            lambda p, x: lf(p, {"tokens": x, "labels": x}), opt, strat,
            comm, policy=pol, accum_steps=accum)
        data = shard_data(cfg)
        losses = []
        for t in range(steps):
            x = microbatch_stack(data, w, t, accum, "cuda")
            state, m = step(state, x if accum > 1 else x[0])
            losses.append(float(m["loss"]))
        out = {"digests": [leaf_digests(rank_state(state, r))
                           for r in range(w)], "losses": losses}
        del state, step
        gc.collect()
        torch.cuda.empty_cache()
        return out

    refs = {"train": {}, "strategies": {}}
    for case, (zero, accum, comp, prec) in SHARD_CASES.items():
        pol = None if prec == "f32" else get_policy(prec)
        strat = (ST.get_strategy(f"sync_zero{zero}", policy=pol) if zero
                 else ST.sync(shard_compressor(comp), policy=pol))
        refs["train"][case] = run(shard_cfg(get_config, SHARD_LAYERS, prec),
                                  strat, pol, accum)
    cfg = shard_cfg(get_config, SHARD_LAYERS)
    for name, (_, comp) in SHARD_STRATEGIES.items():
        refs["strategies"][name] = run(cfg, shard_strategy(name, comp),
                                       None, 1)
    refs["nccl_world1"] = run(shard_cfg(get_config, TRAIN_LAYERS),
                              ST.sync(), None, 1, w=1, steps=1)
    t0 = time.perf_counter()
    refs["tp"] = {case: tp_reference(get_config, case) for case in TP_CASES}
    refs["ep"] = ep_reference(get_config)
    refs["model_axis_s"] = time.perf_counter() - t0
    refs["axis"] = axis_references(get_config)
    return refs


def shard_closed_form(case, lay, play):
    """(all-to-all, all-gather) (count, bytes) a step of one rank of a
    ``train_sharded`` case: the Fabric's reductions are an all-to-all of
    the padded bucket and an all-gather of the 1/W shard, a compressed
    exchange one all-gather of ``wire_nbytes`` a bucket, ZeRO-2 one
    all-to-all a bucket a microbatch; a bf16 wire ships 2 bytes an
    element."""
    from repro_torch.core.fabric import wire_nbytes

    zero, accum, comp_name, prec = SHARD_CASES[case]
    nb, item = lay.n_buckets, 2 if prec != "f32" else 4
    if comp_name is not None:
        comp = shard_compressor(comp_name)
        return (0, 0), (nb, sum(wire_nbytes(comp, n)
                                for n in lay.bucket_sizes))
    k = accum if zero >= 2 and accum > 1 else 1
    return ((k * nb, k * item * sum(play.padded_sizes)),
            (nb, item * sum(play.shard_sizes)))


def per_step(stats, t, op):
    now = stats[t].get(op, (0, 0))
    before = stats[t - 1].get(op, (0, 0)) if t else (0, 0)
    return now[0] - before[0], now[1] - before[1]


def sharded_phases(get_config, smi):
    """``shard_comm``, ``train_sharded``, ``sharded_strategies`` and
    ``nccl_world1``, then the model axis's phases: the stacked and
    one-process references in this process first (only their digests or
    saved trees kept, the card freed), then ONE pool of 4 rank processes
    sharing the card over gloo, then one NCCL rank.  Returns (the phases'
    JSON lines, the kernels' launches in the ranks)."""
    from repro_torch.core.comm import LocalComm
    from repro_torch.core.fabric import BucketLayout, PartitionedLayout
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models import transformer as T

    t0 = time.perf_counter()
    refs = sharded_references(get_config)
    ref_s = time.perf_counter() - t0
    rows = {w: comm_rows(w) for w in (SHARD_POOL, SHARD_W)}
    want = {w: {dt: {k: v.cpu() for k, v in comm_primitives(
        LocalComm(w), x).items()} for dt, x in rows[w].items()}
        for w in rows}
    on_cpu = {w: {dt: comm_primitives(LocalComm(w), x.cpu())
                  for dt, x in rows[w].items()} for w in rows}
    rows = {w: {dt: x.cpu() for dt, x in r.items()} for w, r in rows.items()}
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_ranks(shard_rank, SHARD_POOL, backend="gloo", device="cuda",
                      timeout=1000, collective_timeout=900)
    pool_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    (nccl,) = run_ranks(nccl_rank, 1, backend="nccl", device="cuda",
                        timeout=300)
    nccl_s = time.perf_counter() - t0

    # shard_comm: every primitive bitwise LocalComm's on the card; the
    # data-movement ops bitwise the CPU's too
    movement = ("all_gather_tiled", "ppermute_1", "ppermute_-1",
                "shard_chunk")
    comm_line = {"phase": "shard_comm", "pool_ranks": SHARD_POOL,
                 "worlds": {}, "card": smi}
    for w in (SHARD_POOL, SHARD_W):
        cpu_equal = {}
        for r in range(w):
            got = ranks[r]["comm"][w]
            if got["transport"] != "gloo+host" or got["worker_index"] != r:
                raise AssertionError(f"shard_comm W={w} rank {r}: "
                                     f"{got['transport']}, "
                                     f"{got['worker_index']}")
            for dt, ops in got["results"].items():
                stacked = rows[w][dt]
                c = stacked.shape[-1] // w
                extra = {"all_gather": stacked,
                         "gather_chunks": stacked[..., r * c:(r + 1) * c]}
                for op, x in ops.items():
                    ref = extra[op] if op in extra else want[w][dt][op][r]
                    if not torch.equal(x, ref) or x.dtype != ref.dtype:
                        raise AssertionError(f"shard_comm W={w} rank {r} "
                                             f"{dt} {op} differs from "
                                             "LocalComm on the card")
                    if op in extra:
                        continue
                    same = torch.equal(x, on_cpu[w][dt][op][r])
                    cpu_equal[f"{dt}/{op}"] = cpu_equal.get(
                        f"{dt}/{op}", True) and same
                    if op in movement and not same:
                        raise AssertionError(f"shard_comm W={w} {dt} {op}: "
                                             "the card's differs from the "
                                             "CPU's")
        comm_line["worlds"][w] = {
            "transport": ranks[0]["comm"][w]["transport"],
            "bitwise_local_comm_on_card": True,
            "bitwise_cpu": cpu_equal,
            "bucket_timing_by_rank": [ranks[r]["comm"][w]["timing"]
                                      for r in range(w)]}
    comm_line["rank_seconds"] = ranks[0]["seconds"]["shard_comm"]

    # train_sharded
    launches = {"fused_adam": 0, "onebit_quant_packed": 0,
                "topk_encode_ef": 0}
    train_line = {"phase": "train_sharded", "ranks": SHARD_W,
                  "transport": "gloo+host", "layers": SHARD_LAYERS,
                  "batch_per_worker": TRAIN_B, "seq_len": TRAIN_L,
                  "steps": SHARD_STEPS, "fused_adam": True, "cases": {},
                  "reference_s": ref_s, "pool_s": pool_s,
                  "rank_seconds": max(ranks[r]["seconds"]["train_sharded"]
                                      for r in range(SHARD_POOL)),
                  "card": smi,
                  "note": "gloo over host memory, W ranks sharing one "
                          "card, two cases at once on two meshes of W "
                          "ranks: no claim about NCCL over NVLink"}
    for case, (zero, accum, comp_name, prec) in SHARD_CASES.items():
        cfg = shard_cfg(get_config, SHARD_LAYERS, prec)
        lay = BucketLayout.build(T.init_model(torch.Generator(), cfg,
                                              "meta"))
        play = PartitionedLayout.build(lay, SHARD_W)
        a2a_want, ag_want = shard_closed_form(case, lay, play)
        ref = refs["train"][case]
        rec = {"zero_stage": zero, "accum_steps": accum,
               "compressor": comp_name, "precision": prec,
               "pool_ranks": [SHARD_W * shard_half(case, SHARD_CASES) + r
                              for r in range(SHARD_W)], "ranks": []}
        for r in range(SHARD_W):
            got = ranks[rec["pool_ranks"][r]]["train"][case]
            if got["digests"] != ref["digests"][r]:
                bad = sum(a != b for a, b in zip(got["digests"],
                                                 ref["digests"][r]))
                raise AssertionError(f"train_sharded {case} rank {r}: "
                                     f"{bad} of {len(got['digests'])} "
                                     "leaves differ from the stacked run")
            if got["losses"] != ref["losses"]:
                raise AssertionError(f"train_sharded {case}: losses "
                                     f"{got['losses']} != {ref['losses']}")
            applied = sum(math.isfinite(x) for x in got["losses"])
            expect = {"fused_adam": (len(play.shard_sizes) if zero
                                     else lay.n_leaves) * applied,
                      "onebit_quant_packed": lay.n_buckets * applied
                      if comp_name == "onebit" else 0,
                      "topk_encode_ef": lay.n_buckets * applied
                      if comp_name == "topk" else 0}
            if got["launches"] != expect:
                raise AssertionError(f"train_sharded {case} rank {r}: "
                                     f"launches {got['launches']} != "
                                     f"{expect}")
            for t in range(SHARD_STEPS):
                a2a = per_step(got["stats"], t, "all_to_all")
                ag = per_step(got["stats"], t, "all_gather")
                if (a2a, ag) != (a2a_want, ag_want):
                    raise AssertionError(
                        f"train_sharded {case} rank {r} step {t}: "
                        f"all-to-all {a2a}, all-gather {ag} != closed "
                        f"form {a2a_want}, {ag_want}")
            for k in launches:
                launches[k] += got["launches"][k]
            rec["ranks"].append({
                "step_ms": got["step_ms"], "device_ms_last_step":
                got["device_ms_last"], "peak_gb": got["peak_gb"],
                "launches": got["launches"], "digest_s": got["digest_s"]})
        rec.update(losses=ref["losses"], digests_equal_stacked=True,
                   leaves=len(ref["digests"][0]),
                   launches_expected_per_rank=expect,
                   all_to_all_per_step=a2a_want,
                   all_gather_per_step=ag_want,
                   collectives_per_step=a2a_want[0] + ag_want[0],
                   wire_bytes_per_step=a2a_want[1] + ag_want[1],
                   scalars_per_step=per_step(
                       ranks[rec["pool_ranks"][0]]["train"][case]["stats"],
                       1, "scalars"),
                   n_buckets=lay.n_buckets, n_leaves=lay.n_leaves)
        train_line["cases"][case] = rec

    # sharded_strategies
    strat_line = {"phase": "sharded_strategies", "ranks": SHARD_W,
                  "layers": SHARD_LAYERS, "steps": SHARD_STEPS,
                  "strategies": {}, "card": smi,
                  "rank_seconds": max(
                      ranks[r]["seconds"]["sharded_strategies"]
                      for r in range(SHARD_POOL))}
    cfg = shard_cfg(get_config, SHARD_LAYERS)
    lay = BucketLayout.build(T.init_model(torch.Generator(), cfg, "meta"))
    for name, (kw, comp_name) in SHARD_STRATEGIES.items():
        ref = refs["strategies"][name]
        expect = {"fused_adam": lay.n_leaves * SHARD_STEPS,
                  "onebit_quant_packed": lay.n_buckets * SHARD_STEPS
                  if comp_name == "onebit" else 0, "topk_encode_ef": 0}
        base = SHARD_W * shard_half(name, SHARD_STRATEGIES)
        for r in range(SHARD_W):
            got = ranks[base + r]["strategies"][name]
            if got["digests"] != ref["digests"][r] \
                    or got["losses"] != ref["losses"]:
                raise AssertionError(f"sharded_strategies {name} rank {r} "
                                     "differs from the stacked run")
            if got["launches"] != expect:
                raise AssertionError(f"sharded_strategies {name} rank {r}: "
                                     f"launches {got['launches']} != "
                                     f"{expect}")
            for k in launches:
                launches[k] += got["launches"][k]
        strat_line["strategies"][name] = {
            "kwargs": kw, "compressor": comp_name,
            "digests_equal_stacked": True, "losses": ref["losses"],
            "launches_per_rank": expect,
            "pool_ranks": [base + r for r in range(SHARD_W)],
            "step_ms_by_rank": [ranks[base + r]["strategies"][name]["step_ms"]
                                for r in range(SHARD_W)]}

    # nccl_world1
    ref = refs["nccl_world1"]
    launches["fused_adam"] += nccl["fused_adam_launches"]
    if nccl["loss"] != ref["losses"][0] or nccl["digests"] != \
            ref["digests"][0]:
        raise AssertionError(f"nccl_world1: loss {nccl['loss']} (stacked "
                             f"{ref['losses'][0]}) or the state differs")
    nccl_line = {"phase": "nccl_world1", "backend": nccl["backend"],
                 "transport": nccl["transport"], "loss": nccl["loss"],
                 "loss_equal_replica_step": True,
                 "state_equal_replica_step": True,
                 "comm_stats": nccl["stats"], "s": nccl_s, "card": smi}
    tp_line, ep_line = model_axis_lines(get_config, ranks, refs, launches,
                                        smi)
    lines = axis_lines(get_config, ranks, refs, launches, smi)
    shutil.rmtree(MODEL_REF_DIR, ignore_errors=True)  # the references
    return [comm_line, train_line, strat_line, nccl_line, tp_line,
            ep_line] + lines, launches


def model_axis_lines(get_config, ranks, refs, launches, smi):
    """``train_tp`` and ``train_ep`` from the pool's ranks: each gated
    against its one-process reference, its launches and its collectives;
    the kernels' launches added to ``launches``."""
    from repro_torch.core.fabric import BucketLayout
    from repro_torch.models import tensor_parallel as TP
    from repro_torch.models import transformer as T

    def layouts(cfg):
        meta = T.init_model(torch.Generator(), cfg, "meta")
        experts = TP.splits_experts(meta, TP_N)
        parts = TP._partition_replicated(
            TP.tp_rank_params(meta, TP_N, 0, experts=experts),
            experts=experts)
        return [BucketLayout.build(p) for p in parts]

    by = {r["model_axis"]["coords"]: r["model_axis"] for r in ranks}
    world = MODEL_MESH[0] * MODEL_MESH[1]
    cfg = tp_cfg(get_config)
    lays = layouts(cfg)
    leaves = sum(lay.n_leaves for lay in lays)
    buckets = sum(lay.n_buckets for lay in lays)
    act_bytes = TRAIN_B * TRAIN_L * cfg.d_model * 4
    tp_line = {"phase": "train_tp", "arch": "qwen2-1.5b",
               "mesh": {"data": MODEL_MESH[0], "model": MODEL_MESH[1]},
               "ranks": world, "transport": "gloo+host",
               "layers": TRAIN_LAYERS, "batch_per_data_rank": TRAIN_B,
               "seq_len": TRAIN_L, "steps": SHARD_STEPS, "fused_adam": True,
               "parts": {"rep_leaves": lays[0].n_leaves,
                         "split_leaves": lays[1].n_leaves,
                         "rep_buckets": lays[0].n_buckets,
                         "split_buckets": lays[1].n_buckets},
               "reference": "the replica step at tp_degree 2, W = 2, per "
                            "(model rank, part), one process",
               "cases": {}, "card": smi,
               "rank_seconds": ranks[0]["seconds"]["model_axis"],
               "reference_s": refs["model_axis_s"]}
    for case, (zero, comp_name) in TP_CASES.items():
        atol, share = TP_TOL[case]
        loss_rtol = 1e-4 if comp_name else 1e-6
        ref_losses = refs["tp"][case]
        steps = SHARD_STEPS
        expect = {"fused_adam": (buckets if zero else leaves) * steps,
                  "onebit_quant_packed": buckets * steps if comp_name
                  else 0, "topk_encode_ef": 0}
        psum = 2 * TRAIN_LAYERS * 2 * steps  # a sub-layer a layer, fwd+bwd
        rec = {"zero_stage": zero, "compressor": comp_name,
               "tol": {"atol": atol, "share_beyond_1e-6": share,
                       "loss_rtol": loss_rtol},
               "losses_reference": ref_losses, "ranks": {}}
        for key, got in sorted(by.items()):
            res = got["tp"][case]
            worst, beyond, n, _ = res["held"]
            if worst > atol or beyond > share * n:
                raise AssertionError(f"train_tp {case} rank {key}: params "
                                     f"max |d| {worst}, {beyond} of {n} "
                                     f"beyond 1e-6 (tol {atol}, {share})")
            if res["losses"] != by[(0, 0)]["tp"][case]["losses"]:
                raise AssertionError(f"train_tp {case}: the ranks' losses "
                                     "differ")
            for a, b in zip(res["losses"], ref_losses):
                if abs(a - b) > loss_rtol * abs(b):
                    raise AssertionError(f"train_tp {case}: losses "
                                         f"{res['losses']} vs {ref_losses}")
            if res["launches"] != expect:
                raise AssertionError(f"train_tp {case} rank {key}: launches "
                                     f"{res['launches']} != {expect}")
            if res["model_ops"].get("psum", [0])[0] != psum or \
                    res["model_ops"]["psum"][1] != psum * act_bytes:
                raise AssertionError(f"train_tp {case} rank {key}: model "
                                     f"group {res['model_ops']}, {psum} "
                                     f"all-sums of {act_bytes} B expected")
            for k in launches:
                launches[k] += res["launches"][k]
            rec["ranks"]["%d,%d" % key] = {
                "step_ms": res["step_ms"],
                "device_ms_last_step": res["device_ms_last"],
                "peak_gb": res["peak_gb"],
                "model_all_sum": res["model_ops"]["psum"],
                "model_wire_bytes_per_step": res["model_bytes_per_step"],
                "batch_wire_bytes_per_step": res["batch_bytes_per_step"],
                "params_max_abs_diff": worst,
                "params_beyond_1e-6": [beyond, n]}
        rec.update(losses=by[(0, 0)]["tp"][case]["losses"],
                   launches_expected_per_rank=expect,
                   all_sums_per_rank=psum, all_sum_bytes_each=act_bytes)
        tp_line["cases"][case] = rec

    ecfg = ep_cfg(get_config)
    elays = layouts(ecfg)
    e_leaves = sum(lay.n_leaves for lay in elays)
    ep_line = {"phase": "train_ep", "arch": "granite-moe-1b-a400m",
               "mesh": {"data": MODEL_MESH[0], "model": MODEL_MESH[1]},
               "layers": EP_LAYERS, "batch_per_data_rank": EP_B,
               "seq_len": EP_L, "global_tokens": EP_B * EP_L * MODEL_MESH[0],
               "experts": ecfg.num_experts,
               "experts_padded": ecfg.num_experts_padded,
               "experts_per_rank": ecfg.num_experts_padded // TP_N,
               "top_k": ecfg.top_k, "capacity_factor": ecfg.capacity_factor,
               "steps": SHARD_STEPS, "fused_adam": True,
               "tol": EP_TOL, "reference": "_moe_dense at capacity factor "
               f"{EP_DENSE_CF}, one process, the data rank's rows",
               "ranks": {}, "card": smi}
    dropped, rows = 0, 0
    for key, got in sorted(by.items()):
        ep = got["ep"]
        res = ep["train"]
        worst, _, _, rel = ep["grads_held"]
        ref_loss = refs["ep"][key[0]]
        if rel > EP_TOL["grad_rel"] or \
                abs(ep["loss_cf8"] - ref_loss) > EP_TOL["loss"] * ref_loss:
            raise AssertionError(f"train_ep rank {key}: loss "
                                 f"{ep['loss_cf8']} vs {ref_loss}, MoE "
                                 f"gradients {rel} of their largest")
        if ep["ep_calls_cf8"] != EP_LAYERS or \
                res["ep_calls"] != EP_LAYERS * SHARD_STEPS:
            raise AssertionError(f"train_ep rank {key}: _moe_ep taken "
                                 f"{ep['ep_calls_cf8']} and "
                                 f"{res['ep_calls']} times")
        if not all(math.isfinite(x) for x in res["losses"]):
            raise AssertionError(f"train_ep: losses {res['losses']}")
        expect = {"fused_adam": e_leaves * SHARD_STEPS,
                  "onebit_quant_packed": 0, "topk_encode_ef": 0}
        if res["launches"] != expect:
            raise AssertionError(f"train_ep rank {key}: launches "
                                 f"{res['launches']} != {expect}")
        for k in launches:
            launches[k] += res["launches"][k]
        kept = sum(a for a, _ in res["kept_rows"])
        total = sum(b for _, b in res["kept_rows"])
        dropped, rows = dropped + total - kept, rows + total
        a2a = res["model_ops"].get("all_to_all", [0, 0])
        ep_line["ranks"]["%d,%d" % key] = {
            "step_ms": res["step_ms"],
            "device_ms_last_step": res["device_ms_last"],
            "peak_gb": res["peak_gb"], "losses": res["losses"],
            "loss_cf8": ep["loss_cf8"], "loss_cf8_reference": ref_loss,
            "moe_grads_max_abs_diff": worst, "moe_grads_rel": rel,
            "ep_taken": res["ep_calls"],
            "dropped_share": (total - kept) / total,
            "all_to_all_per_layer_step": [
                a2a[0] / (EP_LAYERS * SHARD_STEPS),
                a2a[1] / (EP_LAYERS * SHARD_STEPS)],
            "model_ops": res["model_ops"],
            "model_wire_bytes_per_step": res["model_bytes_per_step"],
            "batch_wire_bytes_per_step": res["batch_bytes_per_step"]}
    ep_line["dropped_share"] = dropped / rows
    ep_line["launches_expected_per_rank"] = expect
    return tp_line, ep_line


# ---------------------------------------------------------------------------
# the model axis for the recurrent and encoder-decoder families, a strategy
# on it, and context parallelism (cp)
# ---------------------------------------------------------------------------
AXIS_SEED, AXIS_LR, AXIS_STEPS = 28, 1e-3, 1
# train_tp_<family>: (arch, the config's cut, the pool's ranks of its data
# 1 x model 2 mesh, rows, tokens, source frames, optimizer); f32,
# AXIS_STEPS steps, in AXIS_ROUNDS: jamba on ranks 0-1 beside xlstm on
# ranks 2-3 (~33 GB a jamba rank, ~1 GB an xlstm one), then seamless
# (~7 GB a rank: not beside jamba).  xlstm-125m's gradients at its random
# init reach 1e17
# (its exponential gates): SGD at any rate gives NaN a step later, so it
# steps with Adam.
AXIS_FAMILIES = {
    "train_tp_jamba": ("jamba-1.5-large-398b",
                       dict(num_experts=0, num_layers=2, attn_every=2),
                       (0, 1), 1, 2048, 0, "sgd"),
    "train_tp_xlstm": ("xlstm-125m", dict(num_layers=2), (2, 3), 2, 128, 0,
                       "adam"),
    "train_tp_seamless": ("seamless-m4t-medium",
                          dict(num_layers=4, num_encoder_layers=4), (2, 3),
                          2, 256, 512, "sgd"),
}
AXIS_ROUNDS = (("train_tp_jamba", "train_tp_xlstm"), ("train_tp_seamless",))
# step 0's gradients of each rank (split leaves: its slice; replicated
# ones: completed over the model group) against the one-process blocked
# form's: each leaf within AXIS_GRAD_RTOL of its largest |g| (GRAD_RTOL,
# the card's gradient bound elsewhere here), or within AXIS_FLOOR_MULT
# times the same leaf's distance between the blocked form and the single
# path (its noise from regrouping the sums).  The floor serves leaves
# whose gradient cancels: cross attention's and the bidirectional
# encoder's wk (softmax is invariant to a shift shared by every key), at
# full width 2.3e-4 of their largest apart on the card.
AXIS_GRAD_RTOL, AXIS_FLOOR_MULT = 1e-4, 10
# the params after the step against the interval that this gradient gate
# leaves them (``axis_params_held``), widened by AXIS_PARAM_ULPS f32 ulps
# of |p0| + lr for the update's own rounding
AXIS_PARAM_ULPS = 8
# train_tp_strategies (qwen2-1.5b, 4 layers, fused Adam, data 2 x model 2):
# (strategy kwargs, compressor) and (atol, share of the elements beyond
# 1e-6) against the replica step at tp_degree 2 per (model rank, part):
# TP_TOL's Adam bounds, 1-bit's for downpour
TP_STRATEGIES = {"local_sgd": ({"sync_every": 2}, None),
                 "downpour": ({"push_every": 2}, "onebit")}
TP_STRATEGY_STEPS = 2
TP_STRATEGY_TOL = {"local_sgd": (2e-3, 2e-3), "downpour": (2e-2, 2e-2)}
# the cp phases on data 2 x model 2, CP_STEPS fused-Adam steps each: step
# 0's loss (relative) and each leaf of the all-summed gradients (of its
# largest |g|) within CP_TOL of the unsharded step of the same rows on
# the card.  train_cp: qwen2-1.5b, 4 layers, CP_B x CP_L tokens a data
# rank (CP_L / 2 a model rank); train_cp_moe: granite-moe, EP_LAYERS
# layers, the same tokens (4096 global, so _moe_ep on every rank), step
# 0's gradients at capacity factor EP_DENSE_CF without the aux term
# (nothing dropped, as train_ep) and the step at the config's;
# train_cp_seamless: train_tp_seamless's cut, rows and frames, its
# cancelling wk leaves held to AXIS_FLOOR_MULT times a second ordering of
# the unsharded step (the blocked form at tp_degree 2)
CP_B, CP_L, CP_STEPS = 1, 2048, 1
CP_TOL = {"loss": 1e-5, "grad_rel": 1e-4}
CP_PHASES = ("train_cp", "train_cp_moe", "train_cp_seamless")


def axis_cfg(get_config, phase):
    arch, over, *_ = AXIS_FAMILIES[phase]
    return dataclasses.replace(get_config(arch), **over, tp_degree=TP_N)


def axis_init(cfg):
    from repro_torch.models import transformer as T

    gen = torch.Generator(device="cuda").manual_seed(AXIS_SEED)
    return T.init_model(gen, cfg, "cuda")


def axis_batch(cfg, phase, d, t):
    """Data rank d's rows of step t: tokens of the pipeline and, for an
    encoder-decoder, seeded source frames (normal x 0.02, the reference's
    stub), the same in every process."""
    from repro_torch.data.pipeline import DataConfig, rank_batch

    _, _, _, b, l, s, _ = AXIS_FAMILIES[phase]
    x = rank_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=l,
                              batch_per_worker=b), d, t, 1, "cuda")
    out = {"tokens": x, "labels": x}
    if s:
        gen = torch.Generator(device="cuda").manual_seed(
            AXIS_SEED + 100 * d + t)
        out["source_embeds"] = 0.02 * torch.randn(
            (b, s, cfg.d_model), generator=gen, device="cuda")
    return out


def cp_batch(cfg, d, t):
    from repro_torch.data.pipeline import DataConfig, rank_batch

    x = rank_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=CP_L,
                              batch_per_worker=CP_B), d, t, 1, "cuda")
    return {"tokens": x, "labels": x}


def cp_phase_cfg(get_config, phase, grad_gate=False):
    """A ``CP_PHASES`` phase's config under ``cp``; with ``grad_gate``
    its step-0 gradient gate's (train_cp_moe: capacity factor
    EP_DENSE_CF, no aux term)."""
    if phase == "train_cp":
        cfg = shard_cfg(get_config, TRAIN_LAYERS)
    elif phase == "train_cp_moe":
        cfg = ep_cfg(get_config, EP_DENSE_CF if grad_gate else None)
    else:
        arch, over, *_ = AXIS_FAMILIES["train_tp_seamless"]
        cfg = dataclasses.replace(get_config(arch), **over)
    return dataclasses.replace(cfg, sharding_mode="cp")


def cp_init(cfg, phase):
    return {"train_cp": shard_init, "train_cp_moe": ep_init,
            "train_cp_seamless": axis_init}[phase](cfg)


def cp_phase_batch(cfg, phase, d, t):
    return (axis_batch(cfg, "train_tp_seamless", d, t)
            if phase == "train_cp_seamless" else cp_batch(cfg, d, t))


def cp_gathers(cfg):
    """The model group's all-gathers of one cp step (no remat): k and v a
    self-attention layer (the encoder's too), x a MoE layer and
    ``_moe_ep``'s combine (every MoE layer of these phases takes it), the
    memory once."""
    specs, repeat = cfg.superblock()
    moe = sum(sp.ffn == "moe" for sp in specs) * repeat
    attn = sum(sp.mixer == "attn" for sp in specs) * repeat
    return 2 * (attn + cfg.num_encoder_layers) + 2 * moe \
        + (1 if cfg.is_encoder_decoder else 0)


def axis_optimizer(phase):
    from repro_torch.optim import optimizers as TO

    name = AXIS_FAMILIES[phase][6]
    return TO.sgd(AXIS_LR) if name == "sgd" else TO.adam(SHARD_LR,
                                                         fused=True)


def _named(tree):
    """{"a/b/c": leaf} of ``tree``."""
    from repro_torch.core import tree as TT

    return {"/".join(p): x for p, x in zip(_paths(tree), TT.leaves(tree))}


def leaf_errors(got, ref):
    """{path: (max |got - ref|, max |ref|)} over ``got``'s leaves (``ref``
    may hold more; it is moved to ``got``'s device leaf by leaf)."""
    want = _named(ref)
    out = {}
    for k, a in _named(got).items():
        b = want[k].to(a.device)
        out[k] = ((a.float() - b.float()).abs().max().item(),
                  b.float().abs().max().item())
    return out


def axis_allowed(errs, floors):
    """Each leaf's bound on step 0's gradient error in a
    ``train_tp_<family>`` phase (``errs``: ``leaf_errors``' pairs):
    AXIS_GRAD_RTOL of its largest |g|, or AXIS_FLOOR_MULT times its
    blocked-vs-single distance in ``floors``."""
    return {k: max(AXIS_GRAD_RTOL * big, AXIS_FLOOR_MULT * floors[k])
            for k, (_, big) in errs.items()}


def axis_params_held(p1, p0, grads, allow, phase):
    """The rank's params after a ``train_tp_<family>`` phase's one step
    (``p1``, from ``p0``) against the interval that step 0's gradient
    gate leaves them.  A gradient within ``allow`` of the blocked form's
    ``grads`` (g) takes p0 to p0 - u(g'), u the optimizer's first update
    in its plain form (SGD: lr·g; Adam: lr·m̂ / (sqrt(v̂) + eps) with its
    f32 bias corrections), both increasing in g: so each element lies in
    [p0 - u(g + allow), p0 - u(g - allow)], here widened by
    AXIS_PARAM_ULPS f32 ulps of |p0| + lr.  On the card in chunks of 2^26
    elements.  Returns {"outside": elements outside, "elements": n,
    "excess_max": the largest distance outside, "dev_over_lr_max": the
    largest |p1 - (p0 - u(g))| / lr}."""
    from repro_torch.optim import optimizers as TO

    adam = AXIS_FAMILIES[phase][6] == "adam"
    lr = SHARD_LR if adam else AXIS_LR
    opt = TO.adam(lr) if adam else TO.sgd(lr)
    ulp = AXIS_PARAM_ULPS * torch.finfo(torch.float32).eps

    def u(g):  # the first step from p = 0 is exactly -u(g)
        zero = {"x": torch.zeros_like(g)}
        new, _ = opt.update({"x": g}, opt.init(zero), zero, 0)
        return -new["x"]

    start, ref = _named(p0), _named(grads)
    out = {"outside": 0, "elements": 0, "excess_max": 0.0,
           "dev_over_lr_max": 0.0}
    for k, a in _named(p1).items():
        a, x0, g = (t.reshape(-1) for t in (a, start[k], ref[k]))
        for i in range(0, a.numel(), 1 << 26):
            ai = a[i:i + (1 << 26)].float()
            xi = x0[i:i + (1 << 26)].to(ai.device).float()
            gi = g[i:i + (1 << 26)].to(ai.device).float()
            slack = ulp * (xi.abs() + lr)
            excess = torch.maximum(xi - u(gi + allow[k]) - slack - ai,
                                   ai - (xi - u(gi - allow[k])) - slack)
            out["outside"] += int((excess > 0).sum())
            out["excess_max"] = max(out["excess_max"],
                                    excess.max().clamp_min(0).item())
            out["dev_over_lr_max"] = max(
                out["dev_over_lr_max"],
                (ai - (xi - u(gi))).abs().max().item() / lr)
            del ai, xi, gi, slack, excess
        out["elements"] += a.numel()
    return out


def axis_family_reference(get_config, phase):
    """The one-process blocked form (``tp_degree`` 2, no context) of a
    ``train_tp_<family>`` phase on the rows of step 0: the loss and the
    gradients, and each leaf's distance from the single path's gradients
    (the floor of ``AXIS_FLOOR_MULT``), the last two saved for the ranks;
    returns the loss, the floors and the seconds."""
    from repro_torch.core import tree as TT
    from repro_torch.train import loop as LOOP

    t0 = time.perf_counter()
    cfg = axis_cfg(get_config, phase)
    params = axis_init(cfg)
    batch = axis_batch(cfg, phase, 0, 0)
    loss, grads = LOOP._local_grads(LOOP.make_loss_fn(cfg, remat=False),
                                    params, batch)
    single = dataclasses.replace(cfg, tp_degree=1)
    _, grads1 = LOOP._local_grads(LOOP.make_loss_fn(single, remat=False),
                                  params, batch)
    floors = {k: e for k, (e, _) in leaf_errors(grads1, grads).items()}
    del grads1, params
    MODEL_REF_DIR.mkdir(parents=True, exist_ok=True)
    torch.save(TT.tree_map(lambda v: v.cpu(), grads),
               MODEL_REF_DIR / f"{phase}_grads.pt")
    (MODEL_REF_DIR / f"{phase}_floors.json").write_text(json.dumps(floors))
    del grads
    gc.collect()
    torch.cuda.empty_cache()
    return {"loss": float(loss), "floors": floors,
            "s": time.perf_counter() - t0}


def cp_reference(get_config, phase):
    """A ``CP_PHASES`` phase's one-process reference on the card: the
    unsharded loss and gradients of each data rank's rows of step 0 (the
    gate's config), saved for the ranks; train_cp_seamless also each
    leaf's distance to the blocked form's (tp_degree 2) gradients, the
    floor of its cancelling leaves."""
    from repro_torch.core import tree as TT
    from repro_torch.train import loop as LOOP

    t0 = time.perf_counter()
    cfg = cp_phase_cfg(get_config, phase, grad_gate=True)
    params = cp_init(cfg, phase)
    MODEL_REF_DIR.mkdir(parents=True, exist_ok=True)
    losses, floors = [], []
    for d in range(MODEL_MESH[0]):
        batch = cp_phase_batch(cfg, phase, d, 0)
        loss, grads = LOOP._local_grads(LOOP.make_loss_fn(cfg, remat=False),
                                        params, batch)
        losses.append(float(loss))
        if cfg.is_encoder_decoder:
            blocked = dataclasses.replace(cfg, tp_degree=TP_N)
            _, grads2 = LOOP._local_grads(
                LOOP.make_loss_fn(blocked, remat=False), params, batch)
            floors.append({k: e for k, (e, _) in
                           leaf_errors(grads2, grads).items()})
            del grads2
        torch.save(TT.tree_map(lambda v: v.cpu(), grads),
                   MODEL_REF_DIR / f"{phase}_grads_{d}.pt")
        del grads, batch
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "floors": floors,
            "s": time.perf_counter() - t0}


def axis_references(get_config):
    """Every new model-axis phase's one-process reference, run in this
    process before the pool (only the saved trees kept)."""
    refs = {phase: axis_family_reference(get_config, phase)
            for phase in AXIS_FAMILIES}
    for name in TP_STRATEGIES:
        t0 = time.perf_counter()
        refs[f"strategy_{name}"] = {
            "losses": tp_reference(get_config, name, strategy=name,
                                   steps=TP_STRATEGY_STEPS),
            "s": time.perf_counter() - t0}
    for phase in CP_PHASES:
        refs[phase] = cp_reference(get_config, phase)
    return refs


def fingerprints(tree):
    """One 64-bit sum a leaf of its bit patterns weighted by position
    (mod a prime), on the card: equal trees give equal lists, and a
    single changed element changes its leaf's."""
    from repro_torch.core import tree as TT

    out = []
    for x in TT.leaves(tree):
        v = x.detach().reshape(-1)
        v = v.view(torch.int32) if v.element_size() == 4 else \
            v.view(torch.int16)
        total = torch.zeros((), dtype=torch.int64, device=v.device)
        for i in range(0, v.numel(), 1 << 24):
            c = v[i:i + (1 << 24)].to(torch.int64)
            w = torch.arange(i, i + c.numel(), device=c.device) % 65521 + 1
            total = total + (c * w).sum()
        out.append(int(total))
    return out


def axis_run(step, state, batch_of, mc, kernels, steps, rep_prints=False):
    """``steps`` steps of one phase on this rank: the kernels' launches
    (counts zeroed just before, read just after), host step ms after a
    synchronize, the last step's device ms (profiled), peak GB, the
    losses, the model group's collectives and bytes to gloo a step, the
    batch group's bytes a step and, with ``rep_prints``, the replicated
    leaves' fingerprints after every step."""
    for fn in kernels.values():
        fn.launches = 0
    ops0 = {k: tuple(v) for k, v in mc.ops.items()}
    sent0 = sum(v[1] for v in mc.stats.values())
    batch0 = sum(v[1] for v in step.comm.stats.values())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, losses, prints, prof = [], [], [], None
    for t in range(steps):
        batch = batch_of(t)
        torch.cuda.synchronize()
        if t == steps - 1:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        t0 = time.perf_counter()
        state, loss = step(state, batch)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        if t == steps - 1:
            prof.__exit__(None, None, None)
        losses.append(float(loss))
        if rep_prints:
            prints.append(fingerprints(state["params"]["rep"]))
        del batch
    launches = {k: fn.launches for k, fn in kernels.items()}
    return state, {
        "launches": launches, "step_ms": ms,
        "device_ms_last": rank_device_ms(prof),
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "losses": losses, "rep_prints": prints,
        "model_ops": {k: [v[0] - ops0.get(k, (0, 0))[0],
                          v[1] - ops0.get(k, (0, 0))[1]]
                      for k, v in mc.ops.items()},
        "model_bytes_per_step": (sum(v[1] for v in mc.stats.values())
                                 - sent0) / steps,
        "batch_bytes_per_step": (sum(v[1] for v in step.comm.stats.values())
                                 - batch0) / steps}


def split_scan_inputs():
    """The scan's inputs (and the backward's cotangent) at a TP rank's
    Mamba shape: B 1, L 2048, d_in/T = 8192 channels, N 16, f32, B/C
    slices of the x_proj output."""
    b, l, d, n = JAMBA_SCAN[0], JAMBA_SCAN[1], JAMBA_SCAN[2] // TP_N, \
        JAMBA_SCAN[3]
    rng = np.random.default_rng(11)
    args = mamba_inputs(rng, b, l, d, n, torch.float32,
                        dt_rank=JAMBA_DT_RANK)
    return (b, l, d, n), args, mamba_dy(rng, b, l, d, torch.float32)


def split_scan_check(ms):
    """The scan and its backward against their plain versions at a TP
    rank's Mamba shape."""
    (b, l, d, n), args, dy = split_scan_inputs()
    ey, eh = mamba_err(ms, args, "a TP rank's Mamba shape")
    rel, absd = mamba_bwd_err(ms, args, dy, "a TP rank's Mamba shape")
    del args, dy
    torch.cuda.empty_cache()
    return {"shape": {"B": b, "L": l, "D": d, "N": n, "dtype": "float32"},
            "max_abs_err_y": ey, "max_abs_err_h_last": eh,
            "bwd_max_rel_err": rel, "bwd_max_abs_err": absd,
            "tol": MAMBA_TOL[torch.float32],
            "tol_bwd": MAMBA_BWD_TOL[torch.float32]}


def split_scan_time(ms):
    """Both kernels timed at a TP rank's Mamba shape (L2 flushed) beside
    their plain versions and bounds: the forward's L·D·N exps at the
    card's exp rate or its bytes, the backward's bytes (u, delta, dy, B,
    C, D, A read, du, ddelta, dB, dC, dA, dD written once) or exps."""
    (b, l, d, n), args, dy = split_scan_inputs()
    flush = l2_flush()
    exps_ms = 1e3 * b * l * d * n / SFU_EXP_PER_S
    nbytes = {"fwd": (3 * b * l * d + 2 * b * l * n + d * n + d
                      + b * d * n) * 4,
              "bwd": (3 * b * l * d + 2 * b * l * n + 2 * d * n + d) * 4
              + (2 * b * l * d + 2 * b * l * n + d * n + d) * 4}
    calls = {"fwd": (lambda: ms.mamba_scan(*args),
                     lambda: ms.mamba_scan_plain(*args), 20),
             "bwd": (lambda: ms.mamba_scan_bwd(*args, dy),
                     lambda: ms.mamba_scan_bwd_plain(*args, dy), 10)}
    out = {}
    for k, (kernel, plain, iters) in calls.items():
        bytes_ms = 1e3 * nbytes[k] / HBM_BYTES_PER_S
        out[k] = {"ms": cuda_ms(kernel, iters, flush),
                  "plain_ms": cuda_ms(plain, 1, flush),
                  "bound_ms": max(exps_ms, bytes_ms),
                  "bound_by": "operations" if exps_ms >= bytes_ms
                  else "bytes"}
    del args, dy, flush
    torch.cuda.empty_cache()
    return out


def axis_family_rank(phase, mesh, kernels):
    """One ``train_tp_<family>`` phase on this rank of its data 1 x model
    2 ``mesh``: the seeded full params cut to the rank's model shard;
    step 0's loss and gradients (``step.local_grads``: the split leaves'
    slices, the replicated leaves completed over the model group) held
    against the one-process blocked form's, leaf by leaf; then
    AXIS_STEPS steps of the sharded step through ``local_sgd``, which
    averages never within them (at one data rank ``sync``'s f32 buckets
    would hold every gradient again, 7.8 GB a jamba rank, for a mean over
    one rank), on step 0's rows; the params after it held against the
    blocked form's gradients through the optimizer's update
    (``axis_params_held``, from the seeded init made again); the
    replicated leaves' fingerprints.  jamba's ranks then hold the scan
    kernels against their plain versions at the split shape."""
    from repro_torch.configs import get_config
    from repro_torch.core import strategies as ST
    from repro_torch.core import tree as TT
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.models import tensor_parallel as TP
    from repro_torch.train import loop as LOOP

    t0 = time.perf_counter()
    m = mesh.coords["model"]
    cfg = axis_cfg(get_config, phase)
    opt = axis_optimizer(phase)
    strat, comm = ST.local_sgd(), mesh.comm("data")
    state = LOOP.init_sharded_state(axis_init(cfg), opt, mesh,
                                    strategy=strat, comm=comm, cfg=cfg)
    gc.collect()
    torch.cuda.empty_cache()
    step = LOOP.make_sharded_train_step(cfg, opt, mesh, strategy=strat,
                                        comm=comm, remat=False)
    loss0, grads = step.local_grads(state, axis_batch(cfg, phase, 0, 0))
    ref = TP._merge_trees(*LOOP.model_shard(
        torch.load(MODEL_REF_DIR / f"{phase}_grads.pt", mmap=True,
                   weights_only=True), mesh, cfg).values())
    errors = leaf_errors(TP._merge_trees(grads["rep"], grads["split"]),
                         ref)
    allow = axis_allowed(errors, json.loads(
        (MODEL_REF_DIR / f"{phase}_floors.json").read_text()))
    del grads
    gc.collect()
    torch.cuda.empty_cache()
    state, res = axis_run(step, state,
                          lambda t: axis_batch(cfg, phase, 0, t),
                          mesh.shared_comm("model"), kernels, AXIS_STEPS)
    res.update(coords=(0, m), loss0=float(loss0), grad_errors=errors,
               rep_prints=fingerprints(state["params"]["rep"]),
               leaves={n: len(TT.leaves(state["params"][n]))
                       for n in ("rep", "split")})
    p1 = step.params_of(state)
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    p0 = axis_init(cfg)
    p0 = TP._merge_trees(*LOOP.model_shard(p0, mesh, cfg).values())
    res["params_held"] = axis_params_held(p1, p0, ref, allow, phase)
    del p1, p0, ref
    gc.collect()
    torch.cuda.empty_cache()
    if phase == "train_tp_jamba":
        res["split_scan"] = split_scan_check(ms)
    res["rank_s"] = time.perf_counter() - t0
    return res


def axis_strategy_rank(name, rank, kernels):
    """``train_tp_strategies``' run of one strategy on this rank of data 2
    x model 2: qwen2-1.5b's cut at tp_degree 2, fused Adam,
    TP_STRATEGY_STEPS steps through the strategy path over the batch
    group; the replicated
    leaves' fingerprints after every step, the final params held against
    the replica step at tp_degree 2 per (model rank, part)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import tensor_parallel as TP
    from repro_torch.optim import optimizers as TO
    from repro_torch.train import loop as LOOP

    t0 = time.perf_counter()
    mesh = make_mesh(MODEL_MESH, ("data", "model"), backend="gloo")
    d, m = mesh.coords["data"], mesh.coords["model"]
    cfg = tp_cfg(get_config)
    strat, comm = shard_strategy_of(name), mesh.comm("data")
    opt = TO.adam(SHARD_LR, fused=True)
    state = LOOP.init_sharded_state(shard_init(cfg), opt, mesh,
                                    strategy=strat, comm=comm, cfg=cfg)
    step = LOOP.make_sharded_train_step(cfg, opt, mesh, strategy=strat,
                                        comm=comm, remat=False)
    data = shard_data(cfg)
    state, res = axis_run(step, state, lambda t: token_batch(data, d, t),
                          mesh.shared_comm("model"), kernels,
                          TP_STRATEGY_STEPS, rep_prints=True)
    res["coords"] = (d, m)
    ref = torch.load(MODEL_REF_DIR / f"tp_{name}_{d}.pt", mmap=True,
                     weights_only=True)
    mine = TP._merge_trees(*LOOP.model_shard(ref, mesh, cfg).values())
    res["held"] = _held(step.params_of(state), mine)
    del state, step, ref, mine
    gc.collect()
    torch.cuda.empty_cache()
    res["rank_s"] = time.perf_counter() - t0
    return res


def token_batch(data, d, t):
    from repro_torch.data.pipeline import rank_batch

    x = rank_batch(data, d, t, 1, "cuda")
    return {"tokens": x, "labels": x}


def shard_strategy_of(name):
    from repro_torch.core import strategies as ST

    kw, comp = TP_STRATEGIES[name]
    comp = shard_compressor(comp)
    return ST.get_strategy(name, **kw, **({"compressor": comp}
                                          if comp is not None else {}))


def axis_cp_rank(phase, kernels):
    """A ``CP_PHASES`` phase on this rank of data 2 x model 2: step 0's
    loss and all-summed gradients (``step.local_grads``, the gate's
    config) against the unsharded ones of the data rank's rows, leaf by
    leaf; then CP_STEPS fused-Adam steps at the phase's config; the MoE
    branches taken and each routing's kept rows (spies on
    ``layers._moe_ep`` and ``layers._route``)."""
    from repro_torch.configs import get_config
    from repro_torch.core import tree as TT
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers as L
    from repro_torch.optim import optimizers as TO
    from repro_torch.train import loop as LOOP

    t0 = time.perf_counter()
    mesh = make_mesh(MODEL_MESH, ("data", "model"), backend="gloo")
    d, m = mesh.coords["data"], mesh.coords["model"]
    cfg = cp_phase_cfg(get_config, phase)
    gate = cp_phase_cfg(get_config, phase, grad_gate=True)
    opt = TO.adam(SHARD_LR, fused=True)
    state = LOOP.init_sharded_state(cp_init(cfg, phase), opt, mesh, cfg=cfg)
    mc = mesh.shared_comm("model")
    ep_calls, kept = [], []
    route, moe_ep = L._route, L._moe_ep

    def route_spy(*args):
        res = route(*args)
        kept.append((int(res[2].sum()), res[2].numel()))
        return res

    def ep_spy(*args):
        ep_calls.append(1)
        return moe_ep(*args)

    L._route, L._moe_ep = route_spy, ep_spy
    try:
        step0 = LOOP.make_sharded_train_step(gate, opt, mesh, remat=False)
        loss0, grads = step0.local_grads(
            state, cp_phase_batch(cfg, phase, d, 0))
        ref = torch.load(MODEL_REF_DIR / f"{phase}_grads_{d}.pt", mmap=True,
                         weights_only=True)
        errors = leaf_errors(grads["rep"], ref)
        gate_calls, gate_kept = len(ep_calls), kept[:]
        del grads, ref, step0
        gc.collect()
        torch.cuda.empty_cache()
        ep_calls.clear()
        kept.clear()
        step = LOOP.make_sharded_train_step(cfg, opt, mesh, remat=False)
        state, res = axis_run(step, state,
                              lambda t: cp_phase_batch(cfg, phase, d, t),
                              mc, kernels, CP_STEPS)
    finally:
        L._route, L._moe_ep = route, moe_ep
    res.update(coords=(d, m), loss0=float(loss0), grad_errors=errors,
               parts=sorted(state["params"]),
               leaves=len(TT.leaves(state["params"]["rep"])),
               ep_calls_gate=gate_calls, kept_gate=gate_kept,
               ep_calls=len(ep_calls), kept=kept[:])
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    res["rank_s"] = time.perf_counter() - t0
    return res


def axis_rank(rank, kernels):
    """Every new model-axis phase on this rank of the pool: the families
    on their pairs of ranks, round by round (``AXIS_ROUNDS``), the split
    scan timed on rank 0 after the first while the others wait, then the
    strategies and cp on all 4."""
    import torch.distributed as dist

    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.launch.mesh import make_mesh

    pairs = {r: make_mesh((1, TP_N), ("data", "model"), backend="gloo",
                          ranks=r) for r in ((0, 1), (2, 3))}
    out = {}
    for i, phases in enumerate(AXIS_ROUNDS):
        for phase in phases:
            mesh = pairs[AXIS_FAMILIES[phase][2]]
            out[phase] = (axis_family_rank(phase, mesh, kernels)
                          if mesh is not None else None)
        dist.barrier()
        if i == 0:  # the card is rank 0's alone while it times
            if rank == 0:
                out["train_tp_jamba"]["split_scan"].update(
                    split_scan_time(ms))
            dist.barrier()
    out["strategies"] = {name: axis_strategy_rank(name, rank, kernels)
                         for name in TP_STRATEGIES}
    for phase in CP_PHASES:
        out[phase] = axis_cp_rank(phase, kernels)
    return out


def tp_combines(cfg):
    """The model group's all-sums of one TP forward (the encoder's
    included): one a layer for attention (self and cross) and the dense
    MLP, two for Mamba and mLSTM (the x_proj partial or the out-norm's
    statistic, and out_proj), none for the sLSTM."""
    specs, repeat = cfg.superblock()
    per = {"attn": 1, "mamba": 2, "mlstm": 2, "slstm": 0}
    n = sum(per[s.mixer] + (s.ffn == "mlp") + cfg.is_encoder_decoder
            for s in specs) * repeat
    return n + (2 * cfg.num_encoder_layers if cfg.is_encoder_decoder else 0)


def axis_lines(get_config, ranks, refs, launches, smi):
    """The new model-axis phases' lines from the pool's ranks, each gated
    against its one-process reference, its launches and its collectives;
    the kernels' launches added to ``launches``."""
    from repro_torch.core import tree as TT
    from repro_torch.core.fabric import BucketLayout
    from repro_torch.models import tensor_parallel as TP
    from repro_torch.models import transformer as T

    for k in ("mamba_scan", "mamba_scan_bwd"):
        launches.setdefault(k, 0)

    def add(got):
        for k, n in got.items():
            launches[k] += n

    def per_rank(res):
        return {"step_ms": res["step_ms"],
                "device_ms_last_step": res["device_ms_last"],
                "peak_gb": res["peak_gb"], "losses": res["losses"],
                "launches": res["launches"],
                "model_ops": res["model_ops"],
                "model_gloo_bytes_per_step": res["model_bytes_per_step"],
                "batch_gloo_bytes_per_step": res["batch_bytes_per_step"]}

    axis = [r["axis"] for r in ranks]
    lines = []
    for phase, (arch, over, pair, b, l, s, opt) in AXIS_FAMILIES.items():
        cfg = axis_cfg(get_config, phase)
        ref = refs["axis"][phase]
        got = {r[phase]["coords"]: r[phase] for r in axis
               if r[phase] is not None}
        meta = T.init_model(torch.Generator(), cfg, "meta")
        leaves = sum(BucketLayout.build(p).n_leaves for p in
                     TP._partition_replicated(TP.tp_rank_params(meta, TP_N,
                                                                0)))
        psum = 2 * tp_combines(cfg) * AXIS_STEPS
        mamba = sum(sp.mixer == "mamba" for sp in cfg.superblock()[0]) \
            * cfg.superblock()[1]
        expect = {"fused_adam": leaves * AXIS_STEPS if opt == "adam" else 0,
                  "onebit_quant_packed": 0, "topk_encode_ef": 0,
                  "mamba_scan": mamba * AXIS_STEPS,
                  "mamba_scan_bwd": mamba * AXIS_STEPS}
        line = {"phase": phase, "arch": arch, "cut": over,
                "mesh": {"data": 1, "model": TP_N}, "pool_ranks": pair,
                "rows": b, "seq_len": l, "source_frames": s or None,
                "steps": AXIS_STEPS,
                "optimizer": f"sgd lr {AXIS_LR}" if opt == "sgd"
                else f"fused adam lr {SHARD_LR}", "precision": "f32",
                "params_b": cfg.param_count() / 1e9,
                "reference": "the blocked form (tp_degree 2) on the rows "
                             "of step 0, one process: the loss and the "
                             "gradients; the params after the step "
                             "within the interval its gradient bound "
                             "gives through the optimizer's first update",
                "loss_reference_step0": ref["loss"],
                "tol": {"grad_rel": AXIS_GRAD_RTOL,
                        "floor_mult": AXIS_FLOOR_MULT,
                        "params_f32_ulps": AXIS_PARAM_ULPS},
                "ranks": {}, "card": smi, "transport": "gloo+host"}
        for key, res in sorted(got.items()):
            errs = res["grad_errors"]
            allow = axis_allowed(errs, ref["floors"])
            bad = {k: e for k, (e, _) in errs.items() if e > allow[k]}
            if bad or len(errs) != sum(res["leaves"].values()):
                raise AssertionError(f"{phase} rank {key}: step 0's "
                                     f"gradients beyond their bound: {bad}")
            held = res["params_held"]
            if held["outside"] or held["elements"] != sum(
                    x.numel() for x in TT.leaves(TP.tp_rank_params(
                        meta, TP_N, key[1]))):
                raise AssertionError(f"{phase} rank {key}: the params "
                                     "after the step outside the bound of "
                                     f"step 0's gradient gate: {held}")
            if res["loss0"] != ref["loss"]:
                raise AssertionError(f"{phase} rank {key}: step 0's loss "
                                     f"{res['loss0']} is not the blocked "
                                     f"form's {ref['loss']}")
            mate = got[(key[0], 0)]
            if res["rep_prints"] != mate["rep_prints"] \
                    or res["losses"] != mate["losses"] \
                    or not all(math.isfinite(x) for x in res["losses"]):
                raise AssertionError(f"{phase} rank {key}: the replicated "
                                     "leaves or the losses differ from "
                                     f"model rank 0's: {res['losses']}")
            if res["launches"] != expect:
                raise AssertionError(f"{phase} rank {key}: launches "
                                     f"{res['launches']} != {expect}")
            if res["model_ops"].get("psum", [0])[0] != psum:
                raise AssertionError(f"{phase} rank {key}: model group "
                                     f"{res['model_ops']}, {psum} all-sums "
                                     "expected")
            add(res["launches"])
            rel = {k: e / big if big else e for k, (e, big) in errs.items()}
            worst = sorted(rel, key=rel.get)[-3:]
            line["ranks"]["%d,%d" % key] = {
                **per_rank(res), "loss0": res["loss0"],
                "grads_rel_worst": {k: rel[k] for k in worst},
                "grads_over_allowed_max": max(
                    e / allow[k] for k, (e, _) in errs.items()),
                "leaves_held_by_floor": sorted(
                    k for k, (e, big) in errs.items()
                    if e > AXIS_GRAD_RTOL * big),
                "params_after_step": held,
                "leaves": res["leaves"], "rank_s": res["rank_s"]}
            if "fwd" in res.get("split_scan", {}):  # timed on rank 0
                line["split_scan"] = res["split_scan"]
        line.update(
            launches_expected_per_rank=expect, all_sums_per_rank=psum,
            step0_loss_bitwise_blocked=True,
            params_after_step_within_gradient_bound=True,
            replicated_leaves_equal_across_model_ranks=True,
            reference_s=ref["s"],
            phase_cost_s=ref["s"] + max(r["rank_s"] for r in got.values()))
        lines.append(line)

    cfg = tp_cfg(get_config)
    meta = T.init_model(torch.Generator(), cfg, "meta")
    lays = [BucketLayout.build(p) for p in TP._partition_replicated(
        TP.tp_rank_params(meta, TP_N, 0))]
    leaves = sum(lay.n_leaves for lay in lays)
    buckets = sum(lay.n_buckets for lay in lays)
    line = {"phase": "train_tp_strategies", "arch": "qwen2-1.5b",
            "mesh": {"data": MODEL_MESH[0], "model": MODEL_MESH[1]},
            "layers": TRAIN_LAYERS, "batch_per_data_rank": TRAIN_B,
            "seq_len": TRAIN_L, "steps": TP_STRATEGY_STEPS,
            "fused_adam": True,
            "reference": "the replica step at tp_degree 2, W = 2, with the "
                         "same strategy, per (model rank, part), one process",
            "strategies": {}, "card": smi, "transport": "gloo+host"}
    cost = 0.0
    for name, (kw, comp) in TP_STRATEGIES.items():
        atol, share = TP_STRATEGY_TOL[name]
        ref = refs["axis"][f"strategy_{name}"]
        loss_rtol = 1e-4 if comp else 1e-6
        got = {r["strategies"][name]["coords"]: r["strategies"][name]
               for r in axis}
        expect = {"fused_adam": leaves * TP_STRATEGY_STEPS,
                  "onebit_quant_packed": buckets * TP_STRATEGY_STEPS
                  if comp else 0,
                  "topk_encode_ef": 0, "mamba_scan": 0, "mamba_scan_bwd": 0}
        rec = {"kwargs": kw, "compressor": comp,
               "tol": {"atol": atol, "share_beyond_1e-6": share,
                       "loss_rtol": loss_rtol},
               "losses_reference": ref["losses"], "ranks": {}}
        for key, res in sorted(got.items()):
            worst, beyond, n, _ = res["held"]
            if worst > atol or beyond > share * n:
                raise AssertionError(f"train_tp_strategies {name} rank {key}:"
                                     f" params max |d| {worst}, {beyond} of "
                                     f"{n} beyond 1e-6 (tol {atol}, {share})")
            mate = got[(key[0], 0)]
            if res["rep_prints"] != mate["rep_prints"]:
                raise AssertionError(f"train_tp_strategies {name} rank {key}:"
                                     " the replicated leaves differ from "
                                     "model rank 0's after a step")
            if res["losses"] != got[(0, 0)]["losses"] or any(
                    abs(a - b) > loss_rtol * abs(b)
                    for a, b in zip(res["losses"], ref["losses"])):
                raise AssertionError(f"train_tp_strategies {name}: losses "
                                     f"{res['losses']} vs {ref['losses']}")
            if res["launches"] != expect:
                raise AssertionError(f"train_tp_strategies {name} rank {key}"
                                     f": launches {res['launches']} != "
                                     f"{expect}")
            add(res["launches"])
            rec["ranks"]["%d,%d" % key] = {
                **per_rank(res), "params_max_abs_diff": worst,
                "params_beyond_1e-6": [beyond, n], "rank_s": res["rank_s"]}
        rec.update(launches_expected_per_rank=expect,
                   replicated_leaves_equal_every_step=True,
                   reference_s=ref["s"])
        cost += ref["s"] + max(r["rank_s"] for r in got.values())
        line["strategies"][name] = rec
    line["phase_cost_s"] = cost
    lines.append(line)

    for phase in CP_PHASES:
        lines.append(cp_line(get_config, phase, axis, refs["axis"][phase],
                             add, per_rank, smi))
    return lines


def cp_line(get_config, phase, axis, ref, add, per_rank, smi):
    """A ``CP_PHASES`` phase's line from the pool's ranks: step 0's loss
    within CP_TOL of the unsharded one and every leaf's gradient within
    CP_TOL of its largest (or, on train_cp_seamless, AXIS_FLOOR_MULT
    times its second-ordering floor), the losses and the one part the
    same on every rank, ``fused_adam`` leaves x steps and no other
    kernel, the all-gathers a step the closed form; on train_cp_moe
    ``_moe_ep`` taken at every MoE layer of every pass, nothing dropped
    in the gate's pass, and each rank's drop share at the config's
    capacity factor."""
    from repro_torch.core.fabric import BucketLayout
    from repro_torch.models import transformer as T

    cfg = cp_phase_cfg(get_config, phase)
    leaves = BucketLayout.build(T.init_model(torch.Generator(), cfg,
                                             "meta")).n_leaves
    got = {r[phase]["coords"]: r[phase] for r in axis}
    expect = {"fused_adam": leaves * CP_STEPS, "onebit_quant_packed": 0,
              "topk_encode_ef": 0, "mamba_scan": 0, "mamba_scan_bwd": 0}
    gathers = cp_gathers(cfg) * CP_STEPS
    specs, repeat = cfg.superblock()
    moe_layers = sum(sp.ffn == "moe" for sp in specs) * repeat
    arch = {"train_cp": "qwen2-1.5b", "train_cp_moe": "granite-moe-1b-a400m",
            "train_cp_seamless": "seamless-m4t-medium"}[phase]
    b, l, s = (AXIS_FAMILIES["train_tp_seamless"][3:6]
               if phase == "train_cp_seamless" else (CP_B, CP_L, 0))
    line = {"phase": phase, "arch": arch,
            "mesh": {"data": MODEL_MESH[0], "model": MODEL_MESH[1]},
            "layers": cfg.num_layers,
            "encoder_layers": cfg.num_encoder_layers or None,
            "rows_per_data_rank": b, "seq_len": l,
            "seq_per_model_rank": l // TP_N, "source_frames": s or None,
            "steps": CP_STEPS, "fused_adam": True, "precision": "f32",
            "params_b": cfg.param_count() / 1e9,
            "tol": {**CP_TOL, "floor_mult": AXIS_FLOOR_MULT
                    if cfg.is_encoder_decoder else None},
            "reference": "the unsharded loss and gradients of the data "
                         "rank's rows, one process, the same config"
                         + (" at capacity factor %g without the aux term"
                            % EP_DENSE_CF if moe_layers else ""),
            "losses_reference_step0": ref["losses"], "ranks": {},
            "card": smi, "transport": "gloo+host"}
    for key, res in sorted(got.items()):
        ref_loss = ref["losses"][key[0]]
        errs = res["grad_errors"]
        floors = ref["floors"][key[0]] if ref["floors"] else {}
        allow = {k: max(CP_TOL["grad_rel"] * big,
                        AXIS_FLOOR_MULT * floors.get(k, 0.0))
                 for k, (_, big) in errs.items()}
        bad = {k: e for k, (e, _) in errs.items() if e > allow[k]}
        if abs(res["loss0"] - ref_loss) > CP_TOL["loss"] * abs(ref_loss) \
                or bad or len(errs) != leaves:
            raise AssertionError(f"{phase} rank {key}: loss {res['loss0']} "
                                 f"vs {ref_loss}, gradients beyond their "
                                 f"bound: {bad}")
        if res["parts"] != ["rep"] or res["losses"] != \
                got[(0, 0)]["losses"] or not all(
                    math.isfinite(x) for x in res["losses"]):
            raise AssertionError(f"{phase} rank {key}: parts "
                                 f"{res['parts']}, losses {res['losses']}")
        if res["launches"] != expect:
            raise AssertionError(f"{phase} rank {key}: launches "
                                 f"{res['launches']} != {expect}")
        ag = res["model_ops"].get("all_gather", [0, 0])
        if ag[0] != gathers:
            raise AssertionError(f"{phase} rank {key}: {ag[0]} all-gathers,"
                                 f" {gathers} expected")
        if res["ep_calls_gate"] != moe_layers \
                or res["ep_calls"] != moe_layers * CP_STEPS:
            raise AssertionError(f"{phase} rank {key}: _moe_ep taken "
                                 f"{res['ep_calls_gate']} + "
                                 f"{res['ep_calls']} times, "
                                 f"{moe_layers} a pass expected")
        if any(k != n for k, n in res["kept_gate"]):
            raise AssertionError(f"{phase} rank {key}: rows dropped at "
                                 f"capacity factor {EP_DENSE_CF}: "
                                 f"{res['kept_gate']}")
        add(res["launches"])
        rel = {k: e / big if big else e for k, (e, big) in errs.items()}
        worst = sorted(rel, key=rel.get)[-3:]
        rows = sum(n for _, n in res["kept"])
        line["ranks"]["%d,%d" % key] = dict(
            per_rank(res), loss0=res["loss0"],
            grads_rel_worst={k: rel[k] for k in worst},
            grads_over_allowed_max=max(e / allow[k]
                                       for k, (e, _) in errs.items()),
            leaves_held_by_floor=sorted(
                k for k, (e, big) in errs.items()
                if e > CP_TOL["grad_rel"] * big),
            all_gather_bytes_per_step=ag[1] / CP_STEPS,
            moe_ep_calls=res["ep_calls"],
            drop_share=(1 - sum(k for k, _ in res["kept"]) / rows
                        if rows else None),
            rank_s=res["rank_s"])
    line.update(launches_expected_per_rank=expect,
                all_gathers_per_step=gathers // CP_STEPS,
                moe_ep_every_layer=True if moe_layers else None,
                reference_s=ref["s"],
                phase_cost_s=ref["s"] + max(r["rank_s"]
                                            for r in got.values()))
    return line


# ---------------------------------------------------------------------------
# the lint tier (repro_torch.analysis) on the card
# ---------------------------------------------------------------------------
LINT_K = 256  # the lint rigs' top-k: ratio 0.25 of a 1024-element block


def lint_gated_every_step(policy, bucket_bytes):
    """The lint phase's negative: a strategy that declares ``gated`` with
    ``sync_every`` 4 and averages every step, keeping the mean at a
    firing step only (a where-style gate); ``cond-gating`` must fail it.
    The pool's ranks import it by name."""
    from repro_torch.core import strategies as ST
    from repro_torch.core import tree as TT
    from repro_torch.core.fabric import Fabric

    base = ST.local_sgd(sync_every=4, bucket_bytes=bucket_bytes,
                        policy=policy)

    def update(params, grads, opt_state, cstate, t, opt, comm):
        fab = Fabric(comm, bucket_bytes,
                     wire_dtype=policy.wire_dt if policy else None)
        params, opt_state = opt.update(grads, opt_state, params, t)
        mean = fab.all_mean(params)
        if (t + 1) % 4 == 0:
            params = TT.tree_map(lambda x: x.contiguous(), mean)
        return params, opt_state, cstate, {}

    return dataclasses.replace(base, update=update)


def lint_phase(smi):
    """``python -m repro_torch.launch.lint --smoke`` on the card: the 80
    cells of the smoke slice (gemma3-1b and qwen2-1.5b × 10 strategies ×
    f32/bf16 × accum 1/4), the exchange and TP rigs in ONE pool of 4 gloo
    ranks on cuda:0, the rest in this process on CUDA tensors.  Gates:
    zero ``fail`` and ``validate``; in every ``sync_dgc`` cell the fused
    encode entered once a bucket and ``topk_encode_ef`` launched once a
    bucket; every loop rig's count of kernel libraries flat after step
    0; two negatives fail: ``Fabric(fused=False)``'s dgc exchange
    (``fused-dispatch``, 0 launches) and ``lint_gated_every_step``
    (``cond-gating``).  The kernel at the rigs' k 256 is held bitwise
    against its plain version (``encode_equal``).  Returns (the line, the
    parent's ``topk_encode_ef`` launches)."""
    from repro_torch.analysis import report as R
    from repro_torch.analysis import rigs, rules
    from repro_torch.analysis import sweep as SW
    from repro_torch.kernels import _build
    from repro_torch.kernels import topk_sparsify as tk

    arch = SW.SMOKE_CONFIGS[0]
    stub = rigs.exchange_spec(arch, lint_gated_every_step, "f32")
    t0 = time.perf_counter()
    cache = SW.prepare(SW.SMOKE_CONFIGS, SW.LINT_STRATEGIES,
                       SW.LINT_PRECISIONS, "cuda", extra_specs=[stub])
    pool_s = time.perf_counter() - t0
    tk.topk_encode_ef.launches = 0
    rep = SW.run(smoke=True, device="cuda", cache=cache)
    launches = tk.topk_encode_ef.launches
    R.validate(rep)
    rules_of = [(c, {r["rule"]: r for r in c["rules"]}) for c in rep["cells"]]
    fused = [rr["fused-dispatch"]["details"] for c, rr in rules_of
             if c["strategy"] == "sync_dgc"]
    bad = [d for d in fused if not (d["launches"] == d["fused_calls"]
                                    == d["n_buckets"] > 0
                                    and d["codec_calls"] == 0)]
    if len(fused) != 2 * 2 * len(SW.SMOKE_CONFIGS) or bad:
        raise AssertionError(f"lint: sync_dgc's fused dispatch {bad or fused}")
    sizes = [rr["retrace-detector"]["details"]["cache_sizes"]
             for _, rr in rules_of]
    if any(len(set(s_)) != 1 for s_ in sizes):
        raise AssertionError(f"lint: a library built after step 0: {sizes}")

    # the negatives: an unfused dgc wire, a where-gated strategy
    unfused = rigs.fused_artifacts(rigs.init_params(arch, None), "f32",
                                   fused=False, device="cuda")
    neg_fused = rules.fused_dispatch(unfused["fused_calls"],
                                     unfused["codec_calls"],
                                     unfused["n_buckets"], unfused["launches"])
    gate = rigs.exchange_artifacts(cache[stub["key"]], lint_gated_every_step,
                                   "f32")
    neg_gate = rules.cond_gating(gate["logs"], gate["strategy"].gated,
                                 gate["strategy"].sync_every)
    if neg_fused.status != "fail" or unfused["launches"] != 0:
        raise AssertionError(f"lint: the unfused dgc rig passed "
                             f"fused-dispatch: {neg_fused}, {unfused}")
    if neg_gate.status != "fail":
        raise AssertionError(f"lint: the where-gated stub passed cond-gating:"
                             f" {neg_gate}")
    # the kernel at the rigs' row shape, against its plain version
    g, r = code_rows(31, 64, 1024)
    encode_equal(tk, g, r, LINT_K, f"at the lint rigs' k {LINT_K}")
    del g, r
    torch.cuda.empty_cache()
    s = rep["summary"]
    return {"phase": "lint", "cells": s["cells"], "pass": s["pass"],
            "skip": s["skip"], "fail": s["fail"],
            "rigs_built": rep["meta"]["rigs_built"], "pool_s": pool_s,
            "launches": {"topk_encode_ef": launches},
            "sync_dgc_fused": [{k: d[k] for k in ("n_buckets", "fused_calls",
                                                   "launches")}
                               for d in fused],
            "libraries_built": sorted({n for s_ in sizes for n in s_}),
            "process_libraries": _build.libraries_built(),
            "negatives": {"unfused_dgc": {"status": neg_fused.status,
                                          "launches": unfused["launches"],
                                          "findings": neg_fused.findings},
                          "gated_every_step": {
                              "status": neg_gate.status,
                              "findings": neg_gate.findings[:2]}},
            "kernel_check_k": LINT_K, "card": smi}, launches


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--mamba-before", type=Path, default=None,
                        help="an earlier design's csrc/mamba_scan.cu, built "
                             "and timed beside this one (ms_before)")
    parser.add_argument("--mamba-bwd-before", type=Path, default=None,
                        help="an earlier design's csrc/mamba_scan_bwd.cu, "
                             "built and timed beside this one (ms_before)")
    opts = parser.parse_args(argv)
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fl
    from repro_torch.kernels import fused_adam as fa
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import onebit_quant as ob
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import topk_sparsify as tk
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.serve import engine as E
    from repro_torch.serve.engine import PagedDecodeEngine, Request

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t = time.perf_counter()
    libs = _build.build_all()
    # ptxas -v: registers and spill bytes (stores + loads) of each library
    per_lib, per_func = {}, {}
    # each library's SASS read by cuobjdump, all at once
    with ThreadPoolExecutor(len(libs)) as pool:
        tc = dict(zip(sorted(libs), pool.map(
            lambda p: tensor_core_instructions(p, _build._nvcc()),
            [libs[n] for n in sorted(libs)])))
    for name, path in sorted(libs.items()):
        log = path.with_suffix(".log")
        funcs = per_func[name] = ptxas_functions(
            log.read_text() if log.exists() else "")
        per_lib[name] = {"kernels": len(funcs),
                         "max_registers": max((f["registers"] or 0
                                               for f in funcs.values()),
                                              default=None),
                         "spill_bytes": sum(f["spill_bytes"]
                                            for f in funcs.values()),
                         "tensor_core_instructions": tc[name]}
    # the CPU side of the two largest card-vs-CPU phases runs from here on
    # in a worker of its own, beside the card's phases
    cpu = CpuHalves()
    emit({"phase": "build", "libs": sorted(libs),
          "s": time.perf_counter() - t,
          "kernels_compiled": sum(v["kernels"] for v in per_lib.values()),
          "max_registers": max((v["max_registers"] or 0
                                for v in per_lib.values()), default=None),
          "spill_bytes": sum(v["spill_bytes"] for v in per_lib.values()),
          "per_library": per_lib})
    if per_lib["mamba_scan"]["spill_bytes"]:
        raise AssertionError("the scan library spills: "
                             f"{per_lib['mamba_scan']}")
    # the backward's instances for every N (every config's N is 16, the
    # reference's sweep takes 4 and 8)
    spills = bwd_spills(per_func["mamba_scan_bwd"])
    if set(spills) != set(ms.STATE_DIMS) or any(spills.values()):
        raise AssertionError(f"the backward's kernels spill, or are "
                             f"missing: {spills}")
    tc = per_lib["flash_attention"]["tensor_core_instructions"]
    if isinstance(tc, dict) and not tc["HGMMA"] + tc["HMMA"]:
        raise AssertionError("the flash library's SASS holds no tensor-core "
                             f"instruction: {tc}")

    check = check_kernel(pa)
    emit({"phase": "kernel_check", **check})
    checks = {"onebit_quant_packed": check_onebit(ob),
              "topk_encode_ef": check_topk(tk), "fused_adam": check_adam(fa),
              "onebit_quant": check_onebit_unpacked(ob),
              "topk_sparsify": check_topk_sparsify(tk)}
    for c in checks.values():
        emit(c)
    check_fl = check_flash(fl)
    emit(check_fl)
    check_ms = check_mamba(ms)
    emit(check_ms)
    check_mb = check_mamba_bwd(ms)
    emit(check_mb)

    def bf16(name):
        return dataclasses.replace(get_config(name), param_dtype="bfloat16",
                                   compute_dtype="bfloat16")

    qwen = bf16("qwen2-1.5b")
    serve_qwen = serve(
        pa, T, PagedDecodeEngine, Request, qwen, smi, slots=8, max_seq=2048,
        reqs=requests(Request, np.random.default_rng(0), 12, 64, 1536, 32,
                      128, qwen.vocab_size), seed=0, after=profile_decode)
    emit(serve_qwen)
    main_path_launches = serve_qwen["paged_attention_launches"]

    gemma = bf16("gemma3-1b")
    windows = sorted({int(w) for w in gemma.layer_windows()[0].ravel()})
    serve_gemma = serve(
        pa, T, PagedDecodeEngine, Request, gemma, smi, slots=4, max_seq=2048,
        reqs=requests(Request, np.random.default_rng(1), 6, 600, 1200, 32, 32,
                      gemma.vocab_size), seed=1)
    emit({**serve_gemma, "layer_windows": windows})

    emit(card_vs_cpu(get_config, cpu.get("card_vs_cpu")))

    # dense serving: greedy_generate (flash prefill) and DecodeEngine
    prefill_kernels = {"flash_attention": fl.flash_attention,
                       "mamba_scan": ms.mamba_scan}
    flash_launches = 0
    for phase, name, lp, new in (("greedy_qwen2", "qwen2-1.5b", 2048, 32),
                                 ("greedy_gemma3", "gemma3-1b", 2048, 32),
                                 ("greedy_qwen25_14b", "qwen2.5-14b", 1024,
                                  16)):
        result = greedy(prefill_kernels, T, E, bf16(name), smi, phase=phase,
                        prompt_len=lp, new=new, seed=len(phase),
                        profile=name != "qwen2.5-14b")
        if name == "gemma3-1b":
            result["layer_windows"] = windows
        emit(result)
        flash_launches += result["flash_launches_per_prefill"]
    emit(dense_serve(T, E, qwen, smi))
    emit(dense_card_vs_cpu(get_config, cpu.get("dense_card_vs_cpu")))

    # the recurrent families on the dense serving path: jamba without
    # experts cut to two super-blocks (2 attention, 14 Mamba layers) at full
    # width, and xlstm-125m whole
    jamba = dataclasses.replace(bf16("jamba-1.5-large-398b"), num_experts=0,
                                num_layers=16)
    result = greedy(prefill_kernels, T, E, jamba, smi, phase="greedy_jamba",
                    prompt_len=2048, new=16, seed=12, profile=True)
    emit({**result, "num_experts": 0,
          "params_b": jamba.param_count() / 1e9})
    flash_launches += result["flash_launches_per_prefill"]
    mamba_launches = result["mamba_scan_launches_per_prefill"]
    # not profiled: reading the trace of its sLSTM loop took most of the
    # phase's 88-120 s, which the model-axis phases need (PERF.md keeps
    # the profile of earlier runs)
    result = greedy(prefill_kernels, T, E, bf16("xlstm-125m"), smi,
                    phase="greedy_xlstm", prompt_len=1024, new=32, seed=13,
                    profile=False)
    emit(result)
    emit(dense_serve(T, E, jamba, smi, phase="dense_serve_jamba"))
    emit(recurrent_card_vs_cpu(get_config,
                               cpu.get("recurrent_card_vs_cpu")))

    # the MoE families at full width in bf16 (granite at full depth,
    # qwen2-moe-a2.7b cut to QWEN2_MOE_LAYERS, also through the paged
    # engine), then f32 cuts card against CPU, jamba's reduced cut with
    # its experts among them
    result = greedy_granite_moe(
        prefill_kernels, T, E, L,
        dataclasses.replace(bf16("granite-moe-1b-a400m"),
                            num_layers=GRANITE_MOE_LAYERS), smi)
    emit(result)
    flash_launches += result["flash_launches_per_prefill"]
    greedy_moe, serve_moe = qwen2_moe(
        prefill_kernels, pa, T, E, L,
        dataclasses.replace(bf16("qwen2-moe-a2.7b"),
                            num_layers=QWEN2_MOE_LAYERS), smi)
    emit(greedy_moe)
    emit(serve_moe)
    flash_launches += greedy_moe["flash_launches_per_prefill"]
    paged_launches = main_path_launches + serve_moe["paged_attention_launches"]
    moe_cmp, moe_launches = moe_card_vs_cpu(get_config, prefill_kernels,
                                            cpu.get("moe_card_vs_cpu"))
    emit(moe_cmp)
    flash_launches += moe_launches["flash_attention"]
    mamba_launches += moe_launches["mamba_scan"]

    # the encoder-decoder and vision families at full width and depth in
    # bf16: the encoder's and the cross attention's attention on the flash
    # kernel, non-causal; then f32 cuts card against CPU
    greedy_s2s, serve_s2s = seamless(fl, T, E, L, bf16("seamless-m4t-medium"),
                                     smi)
    emit(greedy_s2s)
    emit(serve_s2s)
    flash_launches += greedy_s2s["flash_launches"] + serve_s2s["flash_launches"]
    result = greedy_pixtral(fl, T, L, bf16("pixtral-12b"), smi)
    emit(result)
    flash_launches += result["flash_launches"]
    encdec_cmp, encdec_launches = encdec_card_vs_cpu(
        get_config, cpu.get("encdec_card_vs_cpu"))
    emit(encdec_cmp)
    flash_launches += encdec_launches

    # the leaf-wise codec (its counts zeroed inside, read just after)
    codec = codec_path(ob, tk, get_config, smi)
    emit(codec)

    train_kernels = {"onebit_quant_packed": ob.onebit_quant_packed,
                     "topk_encode_ef": tk.topk_encode_ef,
                     "fused_adam": fa.fused_adam,
                     "onebit_quant": ob.onebit_quant,
                     "topk_sparsify": tk.topk_sparsify}
    train_launches = dict.fromkeys(train_kernels, 0)
    # (strategy, compressor, layers): sync first, then the spectrum; ssp's
    # ring of 4 gradients fits at 2 layers
    for strategy, comp, layers in (
            ("sync", "onebit", TRAIN_LAYERS), ("sync", "topk", TRAIN_LAYERS),
            ("local_sgd", "none", TRAIN_LAYERS),
            ("easgd", "none", TRAIN_LAYERS),
            ("gossip", "none", TRAIN_LAYERS),
            ("downpour", "onebit", TRAIN_LAYERS),
            ("sync_dgc", "topk", TRAIN_LAYERS), ("ssp", "none", 2)):
        result, prof = train_path(train_kernels, get_config, smi,
                                  strategy=strategy, compressor=comp,
                                  layers=layers)
        emit(result)
        emit(prof)
        for k, n in result["launches"].items():
            train_launches[k] += n
        torch.cuda.empty_cache()
    # an MoE model on the trainer: granite-moe-1b-a400m, 4 layers, W = 4
    result, prof = train_moe(train_kernels, L, T, get_config, smi)
    emit(result)
    emit(prof)
    for k in train_launches:
        train_launches[k] += (result["launches"][k]
                              + result["one_batch"]["launches"][k])
    torch.cuda.empty_cache()
    # the recurrent families on the trainer: jamba without experts at full
    # width (one super-block), xlstm-125m whole; the scan's backward is a
    # kernel of its own
    rec_kernels = {**train_kernels, "mamba_scan": ms.mamba_scan,
                   "mamba_scan_bwd": ms.mamba_scan_bwd}
    bwd_launches = 0
    for run in (train_jamba, train_xlstm):
        result, prof = run(rec_kernels, get_config, smi)
        emit(result)
        if prof is not None:
            emit(prof)
        for k in train_launches:
            train_launches[k] += result["launches"][k]
        mamba_launches += result["launches"]["mamba_scan"]
        bwd_launches += result["launches"]["mamba_scan_bwd"]
        gc.collect()
        torch.cuda.empty_cache()
    # the rest of the replica trainer: the bf16 policies with an f32
    # master (onebit) and without (bf16 p under fused Adam), microbatch
    # accumulation (each boundary one encode a bucket)
    for phase, comp, precision, accum in (
            ("train_bf16", "onebit", "bf16", 2),
            ("train_bf16_pure", "none", "bf16-pure", 2),
            ("train_accum_topk", "topk", "f32", 4)):
        result, prof = train_path(train_kernels, get_config, smi,
                                  compressor=comp, precision=precision,
                                  accum=accum, phase=phase)
        emit(result)
        emit(prof)
        for k, n in result["launches"].items():
            train_launches[k] += n
        torch.cuda.empty_cache()
    # ZeRO-1/2/3 on the same cut, fused_adam once a shard bucket, after
    # their baseline: sync without a compressor
    for phase, strategy, precision, accum in (
            ("train_sync", "sync", "f32", 1),
            ("train_zero1", "sync_zero1", "f32", 1),
            ("train_zero2", "sync_zero2", "f32", 2),
            ("train_zero3", "sync_zero3", "f32", 1),
            ("train_zero1_bf16", "sync_zero1", "bf16", 2)):
        result, prof = train_path(train_kernels, get_config, smi,
                                  strategy=strategy, precision=precision,
                                  accum=accum, phase=phase)
        emit(result)
        emit(prof)
        for k, n in result["launches"].items():
            train_launches[k] += n
        torch.cuda.empty_cache()
    emit(zero_vs_sync(get_config, smi))
    emit(skip_step(get_config, train_kernels, smi))
    emit(skip_step(get_config, train_kernels, smi, strategy="sync_zero1"))
    emit(ckpt_resume(get_config, smi))
    # the elastic fleet: fused_adam on (W', chunk') shard buckets after a
    # ZeRO resize and on (W', ...) leaves as the fleet's width changes
    resize = elastic_resize(get_config, smi, fa.fused_adam)
    emit(resize)
    fleet = elastic_fleet(get_config, smi, fa.fused_adam)
    emit({k: v for k, v in fleet.items() if k != "profile"})
    emit(fleet["profile"])
    train_launches["fused_adam"] += fleet["fused_adam_launches"] + sum(
        st["steps_w2"]["fused_adam_launches"]
        for st in resize["stages"].values())
    emit(elastic_vs_sync(get_config, smi))
    emit(elastic_card_vs_cpu(get_config, smi,
                             cpu.get("elastic_card_vs_cpu")))
    emit(finite_read_cost(get_config, smi, steps=5))
    emit(prefetch(train_kernels, get_config, smi))
    emit(train_remat(get_config, smi))
    result, rec_launches = recurrent_train_card_vs_cpu(
        get_config, smi, cpu.get("recurrent_train_card_vs_cpu"))
    emit(result)
    mamba_launches += rec_launches["mamba_scan"]
    bwd_launches += rec_launches["mamba_scan_bwd"]

    # the sharded path: rank processes sharing the card over gloo, and one
    # NCCL rank; each rank counts its own kernels' launches
    gc.collect()
    torch.cuda.empty_cache()
    lines, shard_launches = sharded_phases(get_config, smi)
    for line in lines:
        emit(line)
    mamba_launches += shard_launches.pop("mamba_scan")
    bwd_launches += shard_launches.pop("mamba_scan_bwd")
    for k, n in shard_launches.items():
        train_launches[k] += n
    split_scan = next(line for line in lines
                      if line["phase"] == "train_tp_jamba")["split_scan"]
    gc.collect()
    torch.cuda.empty_cache()

    # the card-vs-CPU train cases: their CPU side has run in the worker
    # beside the phases above
    cpu_init = {}
    for phase in CARD_VS_CPU_CASES:
        emit(train_card_vs_cpu(get_config, phase, cpu_init, cpu.get(phase)))
    del cpu_init

    # the lint tier's smoke slice on the card (its counts zeroed inside)
    lint, lint_launches = lint_phase(smi)
    emit(lint)
    train_launches["topk_encode_ef"] += lint_launches

    timing = time_kernel(pa, main_path_launches / serve_qwen["decode_steps"],
                         smi)
    emit(timing)
    train_timing = time_train_kernels(ob, tk, fa, train_launches, get_config,
                                      smi)
    emit(train_timing)
    codec_timing = time_codec_kernels(ob, tk, codec["launches"],
                                      get_config, smi)
    emit(codec_timing)
    flash_timing = time_flash(fl, flash_launches, smi)
    emit(flash_timing)
    mamba_timing = time_mamba(ms, mamba_launches, smi,
                              before=opts.mamba_before)
    emit(mamba_timing)
    bwd_timing = time_mamba_bwd(ms, bwd_launches, smi,
                                before=opts.mamba_bwd_before)
    emit(bwd_timing)

    sources = {"onebit_quant_packed": ("onebit_quant.cu",
                                       "src/repro/kernels/onebit_quant.py:101"),
               "topk_encode_ef": ("topk_sparsify.cu",
                                  "src/repro/kernels/topk_sparsify.py:113"),
               "fused_adam": ("fused_adam.cu",
                              "src/repro/kernels/fused_adam.py:35"),
               "onebit_quant": ("onebit_quant.cu",
                                "src/repro/kernels/onebit_quant.py:45"),
               "topk_sparsify": ("topk_sparsify.cu",
                                 "src/repro/kernels/topk_sparsify.py:56")}
    rows = []
    for name, (src, replaces) in sources.items():
        tim = {**train_timing["kernels"],
               **codec_timing["kernels"]}[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": tim["launches"],
            "max_abs_err": checks[name]["max_abs_err_vs_plain"],
            "tol": checks[name]["tol"], "ms": tim["ms"],
            "plain_ms": tim["plain_ms"], "bound_ms": tim["bound_ms"],
            "bound_by": tim["bound_by"], "library_ms": tim["library_ms"],
            **({"general_path_ms": checks[name]["general_path"]["ms"]}
               if "general_path" in checks[name] else {}),
            **({"bf16_p": tim["bf16_p"]} if "bf16_p" in tim else {}),
            **({"shard_bucket": tim["shard_bucket"]}
               if "shard_bucket" in tim else {})})

    emit({"kernels": [{
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:97",
        "launches": paged_launches,
        "max_abs_err": max(check["max_abs_err_f32"],
                           check["max_abs_err_bf16"]),
        "max_abs_err_f32": check["max_abs_err_f32"],
        "tol_f32": check["tol_f32"],
        "max_abs_err_bf16": check["max_abs_err_bf16"],
        "tol_bf16": check["tol_bf16"],
        "ms": timing["kernel_ms"], "device_ms": timing["device_ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": "bytes",
        "library_ms": timing["library_ms"],
        "other_shapes": {
            name: {k: timing["shapes"][name][k]
                   for k in ("kernel_ms", "device_ms", "plain_ms",
                             "bound_ms", "bound_by", "library_ms")}
            for name, *_ in PAGED_TIMING[1:]},
    }] + rows + [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:85",
        "launches": flash_launches,
        "max_abs_err": max(check_fl["max_abs_err_f32"],
                           check_fl["max_abs_err_bf16"]),
        "max_abs_err_f32": check_fl["max_abs_err_f32"],
        "tol_f32": check_fl["tol_f32"],
        "max_abs_err_bf16": check_fl["max_abs_err_bf16"],
        "tol_bf16": check_fl["tol_bf16"],
        "ms": flash_timing["kernels"]["qwen2-1.5b"]["ms"],
        "plain_ms": flash_timing["kernels"]["qwen2-1.5b"]["plain_ms"],
        "bound_ms": flash_timing["kernels"]["qwen2-1.5b"]["bound_ms"],
        "bound_by": flash_timing["kernels"]["qwen2-1.5b"]["bound_by"],
        "library_ms": flash_timing["kernels"]["qwen2-1.5b"]["library_ms"],
        "other_shapes": {
            name: {k: flash_timing["kernels"][name][k]
                   for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms")}
            for name in [n for n, *_ in FLASH_PATH_SHAPES[1:]]
            + list(FLASH_ENCDEC_TIMED)},
    }, {
        "name": "mamba_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mamba_scan.cu",
        "replaces": "src/repro/kernels/mamba_scan.py:51",
        "launches": mamba_launches,
        "max_abs_err": max(check_ms["max_abs_err_f32"],
                           check_ms["max_abs_err_bf16"]),
        "max_abs_err_f32": check_ms["max_abs_err_f32"],
        "tol_f32": check_ms["tol_f32"],
        "max_abs_err_bf16": check_ms["max_abs_err_bf16"],
        "tol_bf16": check_ms["tol_bf16"],
        **{k: mamba_timing[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms",
                                        "ms_before", "device_ms",
                                        "device_ms_before",
                                        "h_last_bitwise")},
        "tp_rank_shape": {"shape": split_scan["shape"],
                          **split_scan["fwd"]},
        "registers": mamba_timing["build"]["this"]["registers"],
        "spill_bytes": mamba_timing["build"]["this"]["spill_bytes"],
        "sass": mamba_timing["build"]["this"]["sass"],
        "sass_before": mamba_timing["build"].get("before", {}).get("sass"),
    }, {
        "name": "mamba_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mamba_scan_bwd.cu",
        "replaces": "src/repro/models/ssm.py:83",
        "replaces_note": "no pallas_call: the gradient of the reference's "
                         "jnp chunked scan, which jax.grad differentiates",
        "launches": bwd_launches,
        "max_abs_err": check_mb["max_abs_err"],
        "max_rel_err_f32": check_mb["max_rel_err_f32"],
        "tol_f32": check_mb["tol_f32"],
        "max_rel_err_bf16": check_mb["max_rel_err_bf16"],
        "tol_bf16": check_mb["tol_bf16"],
        **{k: bwd_timing[k] for k in ("ms", "device_ms", "plain_ms",
                                      "bound_ms", "bound_by", "library_ms",
                                      "design_exps_ms", "ms_before",
                                      "device_ms_before")},
        "tp_rank_shape": {"shape": split_scan["shape"],
                          **split_scan["bwd"]},
        "registers": per_lib["mamba_scan_bwd"]["max_registers"],
        "spill_bytes": per_lib["mamba_scan_bwd"]["spill_bytes"],
        "spill_bytes_by_state": bwd_spills(per_func["mamba_scan_bwd"]),
        "sass": bwd_timing["build"]["this"]["sass"],
        "sass_before": bwd_timing["build"].get("before", {}).get("sass"),
    }], "total_s": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}},
         phase_s=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
