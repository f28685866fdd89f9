"""Trainer CLI: W stacked model replicas under any strategy of the
spectrum (``sync``, ``sync_dgc``, ``local_sgd``, ``easgd``, ``ssp``,
``downpour``, ``gossip``) with optional compression, on one card.

Port of ``repro/launch/train.py`` (its replica-simulator mode), with the
reference's flags, printed fields, ``--out`` JSON and exit-2 messages, and
one more flag, ``--device`` (default ``cuda``).  As in the reference,
``--compressor`` goes to ``sync``, ``ssp``, ``downpour`` and ``sync_dgc``
(which needs one); ``--precision bf16|bf16-pure`` trains under that
precision policy (bf16 weights, compute and uncompressed wire; ``bf16``
keeps an f32 master and scales the loss, skipping a step that
overflows); ``--accum-steps K`` accumulates K microbatches an optimizer
step (one exchange a boundary, global batch W × B × K); and
``--prefetch-depth D`` keeps D batches in flight (``1`` is synchronous).
Flags whose machinery is a later slice of the port exit 2 with a
one-line message that names it: ``--zero-stage`` and the ``sync_zero*``
strategies, ``--ckpt-dir`` and ``--resume``.

Example:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --reduced --device cpu --strategy sync --compressor onebit \\
      --precision bf16 --accum-steps 2 --fused-adam --steps 20
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, list_configs
from repro_torch.core import tree as T
from repro_torch.core.comm import LocalComm
from repro_torch.core.compression import get_compressor
from repro_torch.core.precision import apply_policy, get_policy
from repro_torch.core.strategies import REGISTRY, get_strategy
from repro_torch.data.pipeline import (DataConfig, bayes_entropy,
                                       prefetch_batches)
from repro_torch.models import transformer as TM
from repro_torch.optim import adam, sgd, warmup_cosine
from repro_torch.train.loop import (init_train_state, make_loss_fn,
                                    make_replica_train_step)

# the reference's strategy and precision names, so that a strategy of a
# later slice parses and then exits 2 with a message naming what it needs
REFERENCE_STRATEGIES = ("downpour", "easgd", "gossip", "local_sgd", "ssp",
                        "sync", "sync_dgc", "sync_zero1", "sync_zero2",
                        "sync_zero3")
REFERENCE_PRECISIONS = ("bf16", "bf16-pure", "f32")


def build_argparser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale variant of the arch")
    ap.add_argument("--strategy", default="sync", choices=REFERENCE_STRATEGIES)
    ap.add_argument("--zero-stage", type=int, default=0, choices=[0, 1, 2, 3],
                    help="ZeRO partitioning stage (a later slice: only 0)")
    ap.add_argument("--compressor", default="none",
                    choices=["none", "onebit", "int8", "topk"])
    ap.add_argument("--precision", default="f32", choices=REFERENCE_PRECISIONS,
                    help="precision policy (core/precision.py): f32 | bf16 "
                         "(bf16 compute/wire, f32 master, dynamic loss "
                         "scaling) | bf16-pure")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--steps", type=int, default=100,
                    help="OPTIMIZER steps (accumulation boundaries)")
    ap.add_argument("--batch-per-worker", type=int, default=4)
    ap.add_argument("--accum-steps", type=int, default=1,
                    help="microbatches accumulated per optimizer step: the "
                         "exchange fires once per boundary; global batch = "
                         "workers x batch-per-worker x accum-steps")
    ap.add_argument("--prefetch-depth", type=int, default=2,
                    help="batches kept in flight by the device prefetch "
                         "(1 = synchronous)")
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--optimizer", default="adam", choices=["adam", "sgd"])
    ap.add_argument("--fused-adam", action="store_true",
                    help="route the Adam update through the fused CUDA "
                         "kernel (its plain version on --device cpu)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", default=None, choices=["auto"])
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--out", default=None, help="JSON metrics file")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (cpu runs the kernels' "
                         "plain PyTorch versions)")
    return ap


def _exit2(msg):
    print(msg, file=sys.stderr)
    raise SystemExit(2)


def check_ported(args):
    """Exit 2 for a flag whose machinery is not ported yet."""
    if args.zero_stage:
        _exit2(f"--zero-stage {args.zero_stage}: ZeRO partitioning is a "
               "later slice of the port")
    if args.strategy not in REGISTRY:
        _exit2(f"--strategy {args.strategy}: ZeRO partitioning is a later "
               f"slice of the port; ported: {', '.join(sorted(REGISTRY))}")
    if args.ckpt_dir or args.resume:
        _exit2("--ckpt-dir/--resume: checkpoints are a later slice of the "
               "port")


def resolve_config(args):
    """The model config the flags name, or exit 2."""
    try:
        cfg = get_config(args.arch)
    except KeyError:
        _exit2(f"unknown arch {args.arch!r}; valid names: "
               + ", ".join(sorted(list_configs())))
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.is_encoder_decoder or cfg.modality is not None:
        raise SystemExit("trainer CLI supports decoder-only text archs")
    return cfg


def strategy_from_args(args, policy=None):
    comp = None
    if args.compressor != "none":
        comp = get_compressor(args.compressor) if args.compressor != "topk" \
            else get_compressor("topk", ratio=0.01)
    kw = {}
    if args.strategy in ("sync", "ssp", "downpour"):
        kw["compressor"] = comp
    if args.strategy == "sync_dgc":
        if comp is None:
            _exit2("sync_dgc needs --compressor (onebit | int8 | topk)")
        kw["compressor"] = comp
    if policy is not None:
        kw["policy"] = policy
    return get_strategy(args.strategy, **kw)


def train(args, cfg, on_step=None):
    """The CLI's body for a resolved config: prints the reference's fields
    and returns the logged history.  ``on_step(t, state, metrics)``, when
    given, runs after every step."""
    policy = get_policy(args.precision)
    if policy.is_noop:
        policy = None  # f32: the policy-less path, bitwise
    else:
        cfg = apply_policy(cfg, policy)
    strategy = strategy_from_args(args, policy)
    dev = resolve_device(args.device)
    comm = LocalComm(args.workers)
    sched = warmup_cosine(args.lr, warmup=max(1, args.steps // 20),
                          total_steps=args.steps)
    opt = (adam(sched, fused=args.fused_adam) if args.optimizer == "adam"
           else sgd(sched))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                      batch_per_worker=args.batch_per_worker, seed=args.seed)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = comm.replicate(TM.init_model(gen, cfg, device=dev))
    state = init_train_state(params, opt, strategy, comm, policy=policy)
    del params

    loss_fn_single = make_loss_fn(cfg, remat=False)

    def loss_fn(p, toks):
        return loss_fn_single(p, {"tokens": toks, "labels": toks})

    step_fn = make_replica_train_step(loss_fn, opt, strategy, comm,
                                      policy=policy,
                                      accum_steps=args.accum_steps)

    n_params = sum(x.numel() for x in T.leaves(state["params"])) \
        // args.workers
    # one optimizer step consumes accum_steps microbatches of workers x
    # batch_per_worker samples each, but ships the bytes of ONE exchange
    samples_per_step = args.workers * args.batch_per_worker * args.accum_steps
    print(f"arch={cfg.name} params={n_params:,} strategy={strategy.name} "
          f"precision={args.precision} workers={args.workers} "
          f"accum_steps={args.accum_steps} "
          f"global_batch={samples_per_step} "
          f"prefetch_depth={args.prefetch_depth} "
          f"entropy_floor={bayes_entropy(dcfg):.3f}", flush=True)

    history = []
    t0 = time.time()
    for t, batches in prefetch_batches(dcfg, args.workers, args.steps,
                                       accum_steps=args.accum_steps,
                                       depth=args.prefetch_depth, device=dev):
        state, m = step_fn(state, batches)
        if on_step is not None:
            on_step(t, state, m)
        if t % args.log_every == 0 or t == args.steps - 1:
            rec = {"step": t, "loss": float(m["loss"]),
                   "divergence": float(m["replica_divergence"]),
                   "wire_bytes": float(m["wire_bytes"]),
                   "wire_bytes_per_sample":
                       float(m["wire_bytes"]) / samples_per_step,
                   "elapsed_s": round(time.time() - t0, 2)}
            if "loss_scale" in m:
                rec["loss_scale"] = float(m["loss_scale"])
            history.append(rec)
            print(f"step {t:5d} loss {rec['loss']:.4f} "
                  f"div {rec['divergence']:.2e} wireB {rec['wire_bytes']:.0f}"
                  f" wireB/sample {rec['wire_bytes_per_sample']:.1f}",
                  flush=True)
    return history


def main(argv=None):
    args = build_argparser().parse_args(argv)
    cfg = resolve_config(args)
    check_ported(args)
    history = train(args, cfg)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(history, f, indent=1)
    return history


if __name__ == "__main__":
    main()
