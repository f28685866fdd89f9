"""Serving demo: the dense engine against the paged engine.

    PYTHONPATH=src python -m repro_torch.examples.serve_decode \
        [--cache-dtype bfloat16|float32|int8] [--device cpu]

Port of ``examples/serve_decode.py``.  Runs one batch of requests through
``DecodeEngine`` (one token per slot per step, a (B, max_seq) KV arena)
and ``PagedDecodeEngine`` (token pages behind block tables, whole prompt
chunks per step) on reduced gemma3-1b (sliding-window and global layers),
checks token parity, and reports the step counts and the page pool's
bytes.  int8 pages quantize K/V per token and head and are dequantized on
the gather path, so they agree with the dense engine only approximately;
f32 and bf16 pages are attended in their stored dtype.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import transformer as T
from repro_torch.serve.engine import DecodeEngine, PagedDecodeEngine, Request


def _requests(cfg):
    rng = np.random.default_rng(0)
    return [Request(rid=i,
                    prompt=rng.integers(1, cfg.vocab_size,
                                        int(rng.integers(4, 40)))
                    .astype(np.int32),
                    max_new_tokens=int(rng.integers(4, 9)))
            for i in range(10)]


def _serve(engine, cfg):
    # warm both phases outside the timed region, then reset the counters
    engine.submit(Request(rid=-1, prompt=np.full(20, 1, np.int32),
                          max_new_tokens=2))
    engine.run()
    engine.finished.clear()
    engine.steps = 0
    for r in _requests(cfg):
        engine.submit(r)
    t0 = time.perf_counter()
    done = engine.run()
    dt = time.perf_counter() - t0
    return done, sum(len(r.generated) for r in done), engine.steps, dt


def _nbytes(tree):
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cache-dtype", default="bfloat16",
                    choices=["float32", "bfloat16", "int8"],
                    help="page-pool dtype (int8 adds per-token scale pools "
                         "and takes the gather/dequant path)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--chunk-size", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("gemma3-1b").reduced()  # sliding-window + global mix
    params = T.init_model(torch.Generator(device=dev).manual_seed(0), cfg,
                          device=dev)
    dense = DecodeEngine(params, cfg, batch_slots=args.slots,
                         max_seq=args.max_seq, device=dev)
    paged = PagedDecodeEngine(params, cfg, batch_slots=args.slots,
                              max_seq=args.max_seq,
                              page_size=args.page_size,
                              chunk_size=args.chunk_size,
                              cache_dtype=args.cache_dtype, device=dev)
    print(f"paged pool: {paged.kv.allocator.num_pages} pages x "
          f"{args.page_size} tokens, dtype={paged.cache_dtype}, "
          f"{_nbytes(paged.cache):,} bytes (dense {dense.cache_dtype} "
          f"arena: {_nbytes(dense.cache):,} bytes)")
    path = ("CUDA paged-attention kernel" if dev.type == "cuda"
            else "plain PyTorch")
    print(f"decode attention path: {path} (device={dev})")

    d_done, d_toks, d_steps, d_dt = _serve(dense, cfg)
    p_done, p_toks, p_steps, p_dt = _serve(paged, cfg)
    print(f"dense: {d_toks} tokens in {d_steps} steps, {d_dt:.2f}s "
          f"({d_toks / d_dt:.1f} tok/s)")
    print(f"paged: {p_toks} tokens in {p_steps} steps, {p_dt:.2f}s "
          f"({p_toks / p_dt:.1f} tok/s)  [chunked prefill: "
          f"{d_steps / p_steps:.1f}x fewer steps]")
    print(f"page pool drained clean: "
          f"{paged.kv.allocator.num_allocated == 0}")

    gens_d = {r.rid: r.generated for r in d_done}
    gens_p = {r.rid: r.generated for r in p_done}
    same = gens_d == gens_p
    if args.cache_dtype != "int8":
        exact = paged.cache_dtype == dense.cache_dtype
        print(f"paged == dense token-for-token: {same}"
              + ("" if exact else f"  (paged pages are {args.cache_dtype}; "
                 "rounding may flip ties vs the dense "
                 f"{dense.cache_dtype} arena)"))
    else:
        agree = np.mean([a == b for rid in gens_d
                         for a, b in zip(gens_d[rid], gens_p[rid])])
        print(f"int8 pages vs dense {dense.cache_dtype}: "
              f"{agree:.0%} token agreement (lossy quantization)")
    for r in p_done[:3]:
        print(f"  req {r.rid}: prompt[{len(r.prompt)}] -> {r.generated}")
    return gens_d, gens_p


if __name__ == "__main__":
    main()
