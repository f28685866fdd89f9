"""PyTorch port of the JAX package ``repro``, for one NVIDIA H100.

Module names mirror ``src/repro/`` so each port file names its reference.
The port imports torch and numpy only: nothing of JAX and nothing of
``repro``.  It covers these paths, with their kernels written in CUDA C++
for ``sm_90a`` (``kernels/csrc/``):

  * paged serving: ``serve.engine.PagedDecodeEngine`` →
    ``models.transformer`` → ``models.layers.attention_paged`` →
    ``kernels.ops.paged_attention``;
  * dense serving: ``serve.engine.greedy_generate`` and ``DecodeEngine`` →
    ``models.transformer.prefill`` (``models.layers.attention_prefill`` →
    ``kernels.ops.flash_attention``) and ``decode_step`` over a dense
    cache, for attention stacks and for the recurrent families: jamba
    without experts (each Mamba layer's prefill scan ``models.ssm.mamba``
    → ``kernels.ops.mamba_scan``) and xLSTM (``models.ssm.mlstm``,
    ``slstm``); ``DecodeEngine`` zeroes a slot's recurrent state when it
    admits a request;
  * the MoE families (granite-moe-1b-a400m, qwen2-moe-a2.7b, jamba's
    reduced cut with its experts) on those serving paths and the trainer:
    ``models.layers.moe``, the reference's capacity dispatch on one
    device (no kernel of its own; the experts are batched matmuls);
  * data-parallel training: ``launch.train`` → ``train.loop`` (microbatch
    accumulation, the bf16 precision policies with loss scaling and
    skip-step) → the strategies of the spectrum →
    ``core.fabric.Fabric.exchange`` (``kernels.ops.onebit_quant_packed``,
    ``topk_encode_ef``) → ``optim.adam`` (``kernels.ops.fused_adam``, f32
    or bf16 params); ZeRO-1/2/3 (``sync_zero1``/``2``/``3``:
    ``Fabric.exchange_partitioned``'s reduce-scatter, ``fused_adam`` on
    the 1/W shard buckets, ``unpartition``'s all-gather), and the npz
    checkpointer with re-sharding across worker counts
    (``checkpoint``, ``core.resharding``; ``--ckpt-dir``, ``--resume
    auto``), whose files the JAX package reads and writes too;
  * the elastic fleet: ``launch.elastic.ElasticFleet`` (membership as a
    ``FleetView``, the chaos harness ``core.chaos``, straggler demotion,
    retries, graceful degradation) → the masked boundary step
    (``make_elastic_replica_step``: ``Fabric.all_sum`` a bucket, then
    ``optim.adam``'s ``kernels.ops.fused_adam`` on ``(W′, …)`` leaves),
    and ``resize_state``, the live W → W′ re-partition of dense and
    ZeRO-1/2/3 state (``core.resharding`` on tensors, bitwise the
    checkpoint restore's re-shard);
  * data-parallel training across processes: ``launch.mesh.run_ranks``
    starts W rank processes, ``launch.mesh.make_mesh`` lays "pod"/"data"
    axes over them, and ``train.loop.make_sharded_train_step`` runs one
    replica a rank through ``core.fabric.Fabric`` over
    ``core.comm.ShardComm`` (a ``torch.distributed`` group): sync,
    accumulation, the pod compressor (the encode kernels on the rank's
    buckets), ZeRO-1/2/3 (``fused_adam`` on the rank's shard buckets)
    and the strategies, bitwise the stacked replica step (but for the
    bf16 microbatch wire of ZeRO-2/3 under accumulation).

Every entry point takes an explicit ``device``, defaulting to ``"cuda"``.
With no card a ``"cuda"`` default raises; nothing moves quietly to the
CPU.  Pass ``device="cpu"`` to run the plain PyTorch versions, as the
tests do.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for CUDA without a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch path")
    return dev
