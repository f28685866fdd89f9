"""Parameters between the JAX package's tree and the port's tensors.

Both packages use the same nested-dict layout (``models/transformer.py``),
so the conversion is a pure copy, leaf by leaf, through numpy.  bfloat16
leaves go through a 16-bit integer view: ``torch.from_numpy`` rejects
ml_dtypes' ``bfloat16``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.precision import torch_dtype


def _leaf_to_torch(a, device, dtype):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree, device="cuda", dtype=None):
    """Nested dict of numpy arrays (the JAX package's parameters after
    ``np.asarray``) → the same dict of tensors on ``device``.  ``dtype``
    optionally casts the floating leaves."""
    dev = resolve_device(device)
    dt = None if dtype is None else torch_dtype(dtype)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return _leaf_to_torch(x, dev, dt)

    return conv(tree)


def params_to_numpy(tree):
    """Inverse of ``params_from_numpy``: tensors → numpy arrays on the host;
    bfloat16 leaves come back as ml_dtypes' ``bfloat16``."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # installed with JAX; only this direction needs it

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()
