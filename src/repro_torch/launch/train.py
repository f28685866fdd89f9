"""Trainer CLI: W stacked model replicas under any strategy of the
spectrum (``sync``, ``sync_zero1``/``2``/``3``, ``sync_dgc``,
``local_sgd``, ``easgd``, ``ssp``, ``downpour``, ``gossip``) with optional
compression, on one card.  ``--arch`` takes every decoder-only text
model of the registry, as the reference's does: the attention models,
the MoE ones (granite-moe-1b-a400m, qwen2-moe-a2.7b; the router and the
expert leaves are buckets like any other, and the loss adds the router's
aux loss) and the recurrent ones (jamba-1.5-large-398b, whose Mamba
layers' scan and its gradient are CUDA kernels on the card, with or
without its experts; xlstm-125m).  Encoder-decoder and vision models
exit as the reference's do.

Port of ``repro/launch/train.py`` (its replica-simulator mode), with the
reference's flags, printed fields, ``--out`` JSON and exit-2 messages, and
one more flag, ``--device`` (default ``cuda``).  As in the reference,
``--compressor`` goes to ``sync``, ``ssp``, ``downpour`` and ``sync_dgc``
(which needs one); ``--zero-stage N`` is ``--strategy sync_zeroN`` (exit 2
beside another strategy); ``--precision bf16|bf16-pure`` trains under
that precision policy (bf16 weights, compute and uncompressed wire;
``bf16`` keeps an f32 master and scales the loss, skipping a step that
overflows); ``--accum-steps K`` accumulates K microbatches an optimizer
step (one exchange a boundary, global batch W × B × K); and
``--prefetch-depth D`` keeps D batches in flight (``1`` is synchronous).
``--ckpt-dir DIR`` saves the state at the end of the run (replica 0's
params, the master, and for the ZeRO strategies the shard-bucket
optimizer state, ZeRO-3's param shards and the partition spec), in the
reference's format; ``--resume auto`` restores the newest valid step of
``DIR`` first, re-sharded when the save's worker count differs, and
skips the batches before it (exit 2 when there is none, or when it does
not fit the run).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --reduced --device cpu --zero-stage 1 --precision bf16 \\
      --accum-steps 2 --fused-adam --steps 20 --ckpt-dir /tmp/ck
  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \\
      --reduced --device cpu --compressor onebit --fused-adam --steps 10
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import (latest_valid_step, read_meta,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.configs import get_config, list_configs
from repro_torch.core import tree as T
from repro_torch.core.comm import LocalComm
from repro_torch.core.compression import get_compressor
from repro_torch.core.fabric import Fabric
from repro_torch.core.precision import POLICIES, apply_policy, get_policy
from repro_torch.core.strategies import REGISTRY, get_strategy
from repro_torch.data.pipeline import (DataConfig, bayes_entropy,
                                       prefetch_batches)
from repro_torch.models import transformer as TM
from repro_torch.optim import adam, sgd, warmup_cosine
from repro_torch.train.loop import (init_train_state, make_loss_fn,
                                    make_replica_train_step)


def build_argparser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale variant of the arch")
    ap.add_argument("--strategy", default="sync", choices=sorted(REGISTRY))
    ap.add_argument("--zero-stage", type=int, default=0, choices=[0, 1, 2, 3],
                    help="ZeRO partitioning stage (shorthand for --strategy "
                         "sync_zero{N}): 1 shards optimizer state, 2 also "
                         "reduce-scatters per-microbatch gradients into a "
                         "1/W accumulator, 3 also shards the parameters "
                         "(gathered per step)")
    ap.add_argument("--compressor", default="none",
                    choices=["none", "onebit", "int8", "topk"])
    ap.add_argument("--precision", default="f32", choices=sorted(POLICIES),
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
    ap.add_argument("--resume", default=None, choices=["auto"],
                    help="auto: resume from the latest VALID checkpoint in "
                         "--ckpt-dir (corrupt or partial steps are checked "
                         "against the per-leaf checksums and skipped); exit "
                         "2 when the dir holds no valid step")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--out", default=None, help="JSON metrics file")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (cpu runs the kernels' "
                         "plain PyTorch versions)")
    return ap


def _exit2(msg):
    print(msg, file=sys.stderr)
    raise SystemExit(2)


def resolve_config(args):
    """The model config the flags name, or exit 2."""
    try:
        cfg = get_config(args.arch)
    except KeyError:
        _exit2(f"unknown arch {args.arch!r}; valid names: "
               + ", ".join(sorted(list_configs())))
    if args.reduced:
        cfg = cfg.reduced()
    if args.zero_stage:
        if args.strategy not in ("sync", f"sync_zero{args.zero_stage}"):
            _exit2(f"--zero-stage {args.zero_stage} conflicts with "
                   f"--strategy {args.strategy}")
        args.strategy = f"sync_zero{args.zero_stage}"
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


def checkpoint_tree(state, strategy, comm, policy):
    """What ``--ckpt-dir`` saves, as the reference builds it: replica 0's
    params (gathered under ZeRO-3, so the checkpoint is portable across
    worker counts) and master, the step, and for the ZeRO strategies the
    shard-bucket optimizer state, ZeRO-3's param shards and the partition
    spec (the CLI's strategies bucket by the default ``bucket_bytes``).
    Returns (tree, save keywords).  The loss scale is not saved (nor is it
    by the reference): a resumed run restarts its growth streak."""
    full = strategy.gather_params(state["params"], comm) \
        if strategy.owns_params else state["params"]
    tree = {"params": comm.replica(full, 0), "step": state["step"]}
    kw = {}
    if policy is not None:
        kw["precision"] = policy.spec()
        if "master" in state:
            tree["master"] = comm.replica(state["master"], 0)
    if strategy.name.startswith("sync_zero"):
        tree["opt_state"] = state["opt_state"]
        if strategy.owns_params:
            tree["param_shards"] = state["params"]
        kw["partition"] = Fabric(comm).partitioned_layout(full).spec()
    return tree, kw


def resume_auto(ckpt_dir, state, strategy, comm, policy, device):
    """Restore the newest valid checkpoint of ``ckpt_dir`` into ``state``
    (in place): the template mirrors ``checkpoint_tree``, and shard-bucket
    leaves are re-sharded when the save recorded a partition.  Returns the
    restored step; exits 2 when the dir holds no valid step or the
    checkpoint does not fit this run."""
    step0 = latest_valid_step(ckpt_dir)
    if step0 is None:
        _exit2(f"--resume auto: no valid checkpoint step in {ckpt_dir!r}")
    template, _ = checkpoint_tree(state, strategy, comm, policy)
    has_part = str(step0) in read_meta(ckpt_dir).get("partitions", {})
    try:
        restored = restore_checkpoint(ckpt_dir, step0, template,
                                      device=device, repartition=has_part)
    except (KeyError, ValueError) as e:
        _exit2(f"--resume auto: checkpoint step {step0} does not match "
               f"this run's strategy/layout ({e})")
    if strategy.owns_params:
        state["params"] = restored["param_shards"]
    else:
        state["params"] = comm.replicate(restored["params"])
    if "master" in template:
        state["master"] = comm.replicate(restored["master"])
    if "opt_state" in template:
        state["opt_state"] = restored["opt_state"]
    # a new step tensor: the train step reads its value back once
    state["step"] = restored["step"].to(torch.int32)
    return int(restored["step"])


def train(args, cfg, on_step=None):
    """The CLI's body for a resolved config: prints the reference's fields,
    resumes and saves as ``--resume``/``--ckpt-dir`` say, and returns the
    logged history.  ``on_step(t, state, metrics)``, when given, runs
    after every step."""
    if args.resume and not args.ckpt_dir:
        _exit2("--resume auto requires --ckpt-dir")
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
    n_params = sum(x.numel() for x in T.leaves(params)) // args.workers
    state = init_train_state(params, opt, strategy, comm, policy=policy)
    del params

    loss_fn_single = make_loss_fn(cfg, remat=False)

    def loss_fn(p, toks):
        return loss_fn_single(p, {"tokens": toks, "labels": toks})

    step_fn = make_replica_train_step(loss_fn, opt, strategy, comm,
                                      policy=policy,
                                      accum_steps=args.accum_steps)

    # one optimizer step consumes accum_steps microbatches of workers x
    # batch_per_worker samples each, but ships the bytes of ONE exchange
    samples_per_step = args.workers * args.batch_per_worker * args.accum_steps
    print(f"arch={cfg.name} params={n_params:,} strategy={strategy.name} "
          f"precision={args.precision} workers={args.workers} "
          f"accum_steps={args.accum_steps} "
          f"global_batch={samples_per_step} "
          f"prefetch_depth={args.prefetch_depth} "
          f"entropy_floor={bayes_entropy(dcfg):.3f}", flush=True)

    start_step = 0
    if args.resume:
        start_step = resume_auto(args.ckpt_dir, state, strategy, comm,
                                 policy, dev)
        print(f"resumed from step {start_step} ({args.ckpt_dir})",
              flush=True)

    history = []
    t0 = time.time()
    for t, batches in prefetch_batches(dcfg, args.workers, args.steps,
                                       accum_steps=args.accum_steps,
                                       depth=args.prefetch_depth, device=dev):
        if t < start_step:
            # the data stream of an uninterrupted run: the boundaries
            # before the restored step are drawn, not trained on
            continue
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
    if args.ckpt_dir:
        tree, kw = checkpoint_tree(state, strategy, comm, policy)
        save_checkpoint(args.ckpt_dir, args.steps, tree, **kw)
        print(f"checkpoint saved to {args.ckpt_dir}", flush=True)
    return history


def main(argv=None):
    args = build_argparser().parse_args(argv)
    cfg = resolve_config(args)
    history = train(args, cfg)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(history, f, indent=1)
    return history


if __name__ == "__main__":
    main()
