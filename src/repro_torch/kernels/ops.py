"""Dispatch to the kernels by the device of the tensors they are given.

A CUDA tensor goes to the hand-written kernel (which raises on what it does
not take); a CPU tensor goes to the kernel's plain PyTorch version.  There
is no switch and no fallback: the device decides.  Counterpart of
``repro/kernels/ops.py``, whose ``default_interpret`` policy has no
equivalent here.
"""

from __future__ import annotations

from repro_torch.kernels.paged_attention import (
    paged_attention as _paged_kernel,
)
from repro_torch.kernels.paged_attention import paged_attention_plain


def paged_attention(q, k_pages, v_pages, block_tables, ctx_lens, *,
                    window=None, softcap=None):
    if q.device.type == "cuda":
        fn = _paged_kernel
    elif q.device.type == "cpu":
        fn = paged_attention_plain
    else:
        raise ValueError(f"paged_attention: no kernel for device {q.device}")
    return fn(q, k_pages, v_pages, block_tables, ctx_lens, window=window,
              softcap=softcap)
