"""Block-local top-k sparsification with error feedback.

Port of ``repro/kernels/topk_sparsify.py::topk_encode_ef`` (the Pallas TPU
kernel on the Fabric's default compressed path).  One fused round per row
of a flat f32 bucket folded into ``(nb, block)`` rows:

    t = g + r
    k rounds of (max |t|, LOWEST index achieving it, mask it out)
    vals   t at the selected indices, in selection order   (nb, k) f32
    idx    the selected in-row indices                      (nb, k) int32
    new_r  t − dense(selected)                              (nb, block) f32

The rounds give ``lax.top_k``'s order and stable tie-break, so a row with
fewer than k nonzeros (the zero-padded tail block of a replica) takes its
lowest free zero columns.  ``vals`` keeps t's sign, ``-0.0`` included, as
the reference's jnp codec does (``take_along_axis``); the Pallas kernel
reads a selected ``-0.0`` back as ``+0.0`` through a masked sum, the one
corner where the two references differ.  ``new_r`` is computed literally
as ``t − dense``, so a sent entry leaves ``+0.0`` and an unsent ``-0.0``
stays ``-0.0``, bit for bit.

``topk_encode_ef`` launches the CUDA kernel (``csrc/topk_sparsify.cu``) and
counts its launches in ``topk_encode_ef.launches``; ``topk_encode_ef_plain``
is the plain PyTorch version.  ``kernels.ops.topk_encode_ef`` picks between
them by the tensors' device.
"""

from __future__ import annotations

import ctypes

import torch

NEG = -1.0
MAX_BLOCK = 1024  # the kernel keeps a row in one warp's registers


def topk_encode_ef_plain(g, r, k: int):
    """g, r: (nb, block) f32 → (vals (nb, k) f32, idx (nb, k) int32,
    new_r (nb, block) f32), by the kernel's k rounds of masked argmax."""
    nb, block = g.shape
    if not 1 <= k <= block:
        raise ValueError(f"topk_encode_ef: need 1 <= k <= block, got k={k}, "
                         f"block={block}")
    t = g.float() + r
    mag = t.abs()
    taken = torch.zeros_like(t, dtype=torch.bool)
    cols = torch.arange(block, device=t.device).expand(nb, block)
    idx = torch.empty((nb, k), dtype=torch.int64, device=t.device)
    for i in range(k):
        m = mag.amax(dim=-1, keepdim=True)
        first = torch.where(mag == m, cols, block).amin(dim=-1)
        idx[:, i] = first
        sel = cols == first[:, None]
        taken |= sel
        mag = torch.where(sel, NEG, mag)
    vals = torch.gather(t, 1, idx)
    dense = torch.where(taken, t, 0.0)
    return vals, idx.to(torch.int32), t - dense


# the C prototype of topk_encode_ef_fwd in csrc/topk_sparsify.cu:
# g, r, vals, idx, new_r; rows; block, k; stream
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong]
             + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def _kernel_fn():
    from repro_torch.kernels import _build

    fn = _build.load("topk_sparsify").topk_encode_ef_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check(g, r, k):
    for name, t in (("g", g), ("r", r)):
        if t.device.type != "cuda":
            raise ValueError(f"topk_encode_ef: {name} is on {t.device}; the "
                             "kernel takes CUDA tensors only")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"topk_encode_ef: {name} must be contiguous "
                             f"float32, got {t.dtype}")
    if g.device != r.device or g.shape != r.shape or g.dim() != 2:
        raise ValueError(f"topk_encode_ef: g{tuple(g.shape)} on {g.device} "
                         f"and r{tuple(r.shape)} on {r.device} must be one "
                         "(nb, block) shape on one device")
    nb, block = g.shape
    if nb < 1 or block % 32 or not 32 <= block <= MAX_BLOCK:
        raise ValueError(f"topk_encode_ef: the kernel takes nb >= 1 and a "
                         f"block that is a multiple of 32 up to {MAX_BLOCK}, "
                         f"got ({nb}, {block})")
    if not 1 <= k <= block:
        raise ValueError(f"topk_encode_ef: need 1 <= k <= block, got k={k}")


def topk_encode_ef(g, r, k: int):
    """Launch the CUDA kernel on the current stream (CUDA tensors only;
    raises on anything the kernel does not take)."""
    _check(g, r, k)
    nb, block = g.shape
    vals = torch.empty((nb, k), dtype=torch.float32, device=g.device)
    idx = torch.empty((nb, k), dtype=torch.int32, device=g.device)
    new_r = torch.empty_like(g)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel_fn()(g.data_ptr(), r.data_ptr(), vals.data_ptr(),
                           idx.data_ptr(), new_r.data_ptr(), nb, block,
                           int(k), stream)
    if err:
        raise RuntimeError(f"topk_encode_ef kernel launch failed: CUDA error "
                           f"{err}")
    topk_encode_ef.launches += 1
    return vals, idx, new_r


topk_encode_ef.launches = 0
