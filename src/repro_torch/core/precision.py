"""Dtype names the configs accept, and their torch dtypes.

Counterpart of ``repro/core/precision.py:40`` (``ALLOWED_DTYPES``); the
port keeps its own copy because the reference module imports JAX.  The
precision policy itself (loss scaling, master weights) belongs to training
and is not ported yet.
"""

from __future__ import annotations

import torch

ALLOWED_DTYPES = ("float32", "bfloat16", "float16")

_TORCH = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "int8": torch.int8,  # KV page pools only
}


def torch_dtype(dtype) -> torch.dtype:
    """A dtype name (``"bfloat16"``) or a ``torch.dtype`` as a ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype not in _TORCH:
        raise ValueError(f"unsupported dtype {dtype!r}; choose one of "
                         f"{sorted(_TORCH)}")
    return _TORCH[dtype]
