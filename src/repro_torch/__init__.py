"""PyTorch port of the JAX package ``repro``, for one NVIDIA H100.

Module names mirror ``src/repro/`` so each port file names its reference.
The port imports torch and numpy only: nothing of JAX and nothing of
``repro``.  This slice covers the paged serving path
(``serve.engine.PagedDecodeEngine`` → ``models.transformer`` →
``models.layers.attention_paged`` → ``kernels.ops.paged_attention``), with
the paged-attention decode kernel written in CUDA C++ for ``sm_90a``
(``kernels/csrc/paged_attention.cu``).

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
