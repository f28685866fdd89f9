#!/usr/bin/env python3
"""Drive the PyTorch port's paged serving path on one CUDA card.

    python3 chip_smoke.py

Builds every CUDA kernel of the path from ``src/repro_torch/kernels/csrc``
(into ``build/kernels/``), holds each kernel against its plain PyTorch
version, serves qwen2-1.5b at full width and depth and gemma3-1b at full
width through ``repro_torch.serve.engine.PagedDecodeEngine``, checks the
card's greedy tokens against the CPU's on a two-layer cut of qwen2-1.5b,
and times the kernel against its bound, its plain version and one PyTorch
call.  Each line of output is a JSON object, except the raw
``nvidia-smi --query-gpu=name,power.limit`` line just before the last;
the last line is ``{"ok": true, "device": {...}}``.  Any failed phase
raises and the script exits non-zero without that line.  It needs one
card and exits non-zero when ``torch.cuda.is_available()`` is false.
"""

from __future__ import annotations

import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory, NVIDIA data sheet
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters, flush=None):
    """Median device time of ``fn`` over ``iters`` calls after warm-up,
    one pair of CUDA events around each call; ``flush`` (untimed) runs
    before each call to evict the L2 cache."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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


def check_kernel(pa):
    """Phase 2: the CUDA kernel against its plain version on the card."""
    shapes = {"qwen2-1.5b": dict(b=8, kv=2, g=6, dh=128, page=16),
              "gemma3-1b": dict(b=4, kv=1, g=4, dh=256, page=16)}
    dts = (torch.float32, torch.bfloat16)
    err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    cases = 0
    for si, (arch, s) in enumerate(shapes.items()):
        rng = np.random.default_rng(si)
        ctx = rng.integers(1, 2049, size=s["b"])
        ctx[-1] = 2048
        for qd in dts:
            for kd in dts:
                inp = paged_inputs(np.random.default_rng(100 + si), s["b"],
                                   s["kv"], s["g"], s["dh"], s["page"], ctx,
                                   qd, kd, idle_row=True)
                for window in (-1, 7, 512):
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
                                f"paged_attention {arch} q={qd} pages={kd} "
                                f"window={window} softcap={softcap}: max "
                                f"abs err {e} > {TOL[qd]}")
                        err[qd] = max(err[qd], e)
                        cases += 1
    return {"cases": cases, "max_abs_err_f32": err[torch.float32],
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
          after=None):
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
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:6]
    return {"profile": {
        "ctx": ctx, "slots": b, "step_ms": 1e3 * step_s,
        "step_ms_under_profiler": 1e3 * prof_step_s,
        "device_ms_per_step": dev_ms,
        "device_busy_share": dev_ms / (1e3 * step_s) if dev_ms else None,
        "device_kernels_per_step": sum(e.count for e in events) / steps,
        "top_device_ms_per_step": {
            e.key[:60]: e.self_device_time_total / 1e3 / steps for e in top},
    }}


def card_vs_cpu(T, Engine, Request, get_config):
    """Phase 5: the same weights and requests on the card and on the CPU."""
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
    logits = {}
    for dev in ("cuda", "cpu"):
        def p(t, dev=dev):
            return t.to(dev)
        prm = _tree(params, p)
        cache = T.init_paged_cache(cfg, 1 + b * mb, page, device=dev)
        with torch.no_grad():
            T.prefill_chunk_paged(
                prm, cfg, p(torch.from_numpy(toks)),
                p(torch.from_numpy(poss)), cache, p(torch.from_numpy(bt)),
                p(torch.from_numpy((lens - 1).astype(np.int32))))
            logits[dev] = T.decode_step_paged(
                prm, cfg, p(torch.from_numpy(nxt)),
                p(torch.from_numpy(lens.astype(np.int32))), cache,
                p(torch.from_numpy(bt))).cpu()
        del prm, cache
    logit_err = (logits["cuda"] - logits["cpu"]).abs().max().item()
    if not logit_err <= 1e-3:
        raise AssertionError(f"card vs CPU first-step logits differ by "
                             f"{logit_err} > 1e-3")

    gens = {}
    for dev in ("cuda", "cpu"):
        eng = Engine(params, cfg, batch_slots=4, max_seq=256, page_size=16,
                     chunk_size=64, device=dev)
        for r in requests(Request, np.random.default_rng(6), 4, 16, 96, 8,
                          16, cfg.vocab_size):
            eng.submit(r)
        gens[dev] = {r.rid: r.generated for r in eng.run()}
        del eng
    if gens["cuda"] != gens["cpu"]:
        raise AssertionError(f"card vs CPU greedy tokens differ: "
                             f"{gens['cuda']} vs {gens['cpu']}")
    torch.cuda.empty_cache()
    return {"phase": "card_vs_cpu", "arch": cfg.name, "layers": 2,
            "dtype": "float32", "first_step_logits_max_abs_err": logit_err,
            "tol": 1e-3, "tokens_identical": True,
            "tokens": sum(len(g) for g in gens["cuda"].values())}


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(tree)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------
def time_kernel(pa, launches_per_step, smi):
    """Kernel, plain version and F.scaled_dot_product_attention at the
    qwen2-1.5b decode shapes of the serving phase: B=8, ctx 1024, bf16."""
    b, kv, g, dh, page, ctx = 8, 2, 6, 128, 16, 1024
    q, kp, vp, bt, cl = paged_inputs(
        np.random.default_rng(7), b, kv, g, dh, page, [ctx] * b,
        torch.bfloat16, torch.bfloat16, idle_row=False)
    flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")

    def flush():
        flush_buf.zero_()  # 256 MB > the 50 MB L2: each call starts cold

    saved = pa.paged_attention.launches
    kernel_ms = cuda_ms(lambda: pa.paged_attention(q, kp, vp, bt, cl), 50,
                        flush)
    pa.paged_attention.launches = saved  # timing launches are not the path's
    plain_ms = cuda_ms(lambda: pa.paged_attention_plain(q, kp, vp, bt, cl),
                       20, flush)

    # one library call on the pre-gathered dense view (gather excluded)
    s = ctx
    ks = kp[bt.long()].reshape(b, s, kv, dh).transpose(1, 2).contiguous()
    vs = vp[bt.long()].reshape(b, s, kv, dh).transpose(1, 2).contiguous()
    qh = q.reshape(b, kv * g, 1, dh)
    mask = (torch.arange(s, device="cuda")[None, :]
            <= (cl.long() - 1)[:, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_ms(
        lambda: sdpa(qh, ks, vs, attn_mask=mask, enable_gqa=True), 50, flush)
    lib_out = sdpa(qh, ks, vs, attn_mask=mask, enable_gqa=True)
    lib_err = (lib_out.reshape(b, kv, g, dh).float()
               - pa.paged_attention_plain(q, kp, vp, bt, cl).float()
               ).abs().max().item()

    live = int(cl.sum().item())
    nbytes = (live * kv * dh * 2 * kp.element_size()    # k and v, once
              + 2 * q.numel() * q.element_size()         # q in, out
              + bt.numel() * 4 + cl.numel() * 4)
    return {
        "phase": "kernel_timing", "name": "paged_attention",
        "shape": {"B": b, "KV": kv, "G": g, "Dh": dh, "page": page,
                  "ctx": ctx, "dtype": "bfloat16"},
        "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "library_ms": library_ms,
        "library_note": "F.scaled_dot_product_attention on the pre-gathered "
                        "dense view, gather excluded; never called by the "
                        "port",
        "library_max_abs_err_vs_plain": lib_err,
        "bytes": nbytes, "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
        "bound_by": "bytes", "launches_per_decode_step": launches_per_step,
        "card": smi,
    }


# ---------------------------------------------------------------------------
def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import PagedDecodeEngine, Request

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t = time.perf_counter()
    libs = _build.build_all()
    # ptxas -v: registers and spills of every compiled kernel
    regs, spills = [], []
    for path in libs.values():
        log = path.with_suffix(".log")
        text = log.read_text() if log.exists() else ""
        regs += [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spills += [int(s) for s in re.findall(r"(\d+) bytes spill", text)]
    emit({"phase": "build", "libs": sorted(libs),
          "s": time.perf_counter() - t, "kernels_compiled": len(regs),
          "max_registers": max(regs, default=None),
          "spill_bytes": sum(spills)})

    check = check_kernel(pa)
    emit({"phase": "kernel_check", **check})

    def bf16(name):
        return dataclasses.replace(get_config(name), param_dtype="bfloat16",
                                   compute_dtype="bfloat16")

    qwen = bf16("qwen2-1.5b")
    serve_qwen = serve(
        pa, T, PagedDecodeEngine, Request, qwen, smi, slots=8, max_seq=2048,
        reqs=requests(Request, np.random.default_rng(0), 16, 64, 1536, 32,
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

    emit(card_vs_cpu(T, PagedDecodeEngine, Request, get_config))

    timing = time_kernel(pa, main_path_launches / serve_qwen["decode_steps"],
                         smi)
    emit(timing)

    emit({"kernels": [{
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:97",
        "launches": main_path_launches,
        "max_abs_err": max(check["max_abs_err_f32"],
                           check["max_abs_err_bf16"]),
        "max_abs_err_f32": check["max_abs_err_f32"],
        "tol_f32": check["tol_f32"],
        "max_abs_err_bf16": check["max_abs_err_bf16"],
        "tol_bf16": check["tol_bf16"],
        "ms": timing["kernel_ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": "bytes",
        "library_ms": timing["library_ms"],
    }], "total_s": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
