"""Block-local top-k sparsification, with error feedback and plain.

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
lowest free zero columns.  They order |t| by its bit pattern, so a NaN
sorts above +inf, as ``lax.top_k`` sorts it.  ``vals`` keeps t's sign,
``-0.0`` included, as the reference's jnp codec does
(``take_along_axis``); the Pallas kernel reads a selected ``-0.0`` back
as ``+0.0`` through a masked sum, and takes no column for a NaN.
``new_r`` is computed literally as ``t − dense``, so a sent entry leaves
``+0.0`` and an unsent ``-0.0`` stays ``-0.0``, bit for bit.

Port of ``repro/kernels/topk_sparsify.py::topk_sparsify``, one round of
the leaf-wise codec (``core/compression.py``): for ``(nb, block)`` rows x
in f32 or bf16, the same k rounds over ``|x|`` in f32, then

    vals   x at the selected indices, in x's dtype        (nb, k)
    idx    the selected in-row indices, selection order  (nb, k) int32
    dense  x where selected, +0.0 elsewhere, x's dtype   (nb, block)

``vals`` are taken as ``take_along_axis`` takes them (``topk_sparsify_ref``),
so a selected ``-0.0`` stays ``-0.0``.

``topk_encode_ef`` and ``topk_sparsify`` launch the CUDA kernels
(``csrc/topk_sparsify.cu``; rows read as 16-byte vectors, so the tensors
start 16-byte aligned) and count their launches in ``.launches``;
``topk_encode_ef_plain`` and ``topk_sparsify_plain`` are the plain PyTorch
versions.  ``kernels.ops`` picks between them by the tensors' device.
"""

from __future__ import annotations

import ctypes

import torch

MAX_BLOCK = 1024  # the kernel keeps a row in one warp's registers


def _select(t, k: int, name: str):
    """The kernels' k rounds of masked argmax over (nb, block) f32 rows t:
    (idx (nb, k) int64 in selection order, taken mask).  A column's key is
    the int32 bit pattern of |t| (the sign bit cleared), under which
    magnitudes order as numbers and a NaN above +inf, as ``lax.top_k``
    orders them; the lowest column wins a tie."""
    nb, block = t.shape
    if not 1 <= k <= block:
        raise ValueError(f"{name}: need 1 <= k <= block, got k={k}, "
                         f"block={block}")
    key = t.contiguous().view(torch.int32) & 0x7FFFFFFF
    taken = torch.zeros_like(t, dtype=torch.bool)
    cols = torch.arange(block, dtype=torch.int32,
                        device=t.device).expand(nb, block)
    idx = torch.empty((nb, k), dtype=torch.int64, device=t.device)
    for i in range(k):
        m = key.amax(dim=-1, keepdim=True)
        first = torch.where(key == m, cols, block).amin(dim=-1)
        idx[:, i] = first
        sel = cols == first[:, None]
        taken |= sel
        key = torch.where(sel, -1, key)
    return idx, taken


def _take(x, idx):
    """x at idx along its rows, bit for bit: gathered as integers, since a
    gather of bf16 on the CPU returns every NaN as one pattern."""
    ints = {4: torch.int32, 2: torch.int16}[x.element_size()]
    return torch.gather(x.view(ints), 1, idx).view(x.dtype)


def topk_encode_ef_plain(g, r, k: int):
    """g, r: (nb, block) f32 → (vals (nb, k) f32, idx (nb, k) int32,
    new_r (nb, block) f32), by the kernel's k rounds of masked argmax."""
    t = g.float() + r
    idx, taken = _select(t, k, "topk_encode_ef")
    vals = _take(t, idx)
    dense = torch.where(taken, t, 0.0)
    return vals, idx.to(torch.int32), t - dense


def topk_sparsify_plain(x, k: int):
    """x: (nb, block) f32 or bf16 → (vals (nb, k), idx (nb, k) int32,
    dense (nb, block)), vals and dense in x's dtype, by the kernel's k
    rounds of masked argmax over |x| in f32."""
    idx, taken = _select(x.float(), k, "topk_sparsify")
    vals = _take(x, idx)
    dense = torch.where(taken, x, torch.zeros((), dtype=x.dtype))
    return vals, idx.to(torch.int32), dense


# the C prototypes in csrc/topk_sparsify.cu.  topk_encode_ef_fwd: g, r,
# vals, idx, new_r; rows; block, k; stream.  topk_sparsify_fwd: x, vals,
# idx, dense; rows; block, k, is_bf16; stream
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong]
             + [ctypes.c_int] * 2 + [ctypes.c_void_p])
_SPARSIFY_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                      + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def _kernel_fn(name, argtypes):
    from repro_torch.kernels import _build

    fn = getattr(_build.load("topk_sparsify"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _check_rows(name, x, k):
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel reads rows as 16-byte vectors; "
                         f"got a tensor at address {x.data_ptr():#x}")
    nb, block = x.shape
    if nb < 1 or block % 32 or not 32 <= block <= MAX_BLOCK:
        raise ValueError(f"{name}: the kernel takes nb >= 1 and a block that "
                         f"is a multiple of 32 up to {MAX_BLOCK}, got "
                         f"({nb}, {block})")
    if not 1 <= k <= block:
        raise ValueError(f"{name}: need 1 <= k <= block, got k={k}")


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
    _check_rows("topk_encode_ef", g, k)
    _check_rows("topk_encode_ef", r, k)


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
        err = _kernel_fn("topk_encode_ef_fwd", _ARGTYPES)(
            g.data_ptr(), r.data_ptr(), vals.data_ptr(), idx.data_ptr(),
            new_r.data_ptr(), nb, block, int(k), stream)
    if err:
        raise RuntimeError(f"topk_encode_ef kernel launch failed: CUDA error "
                           f"{err}")
    topk_encode_ef.launches += 1
    return vals, idx, new_r


def topk_sparsify(x, k: int):
    """Launch the CUDA kernel on the current stream (contiguous f32 or bf16
    CUDA rows only; raises on anything the kernel does not take)."""
    if x.device.type != "cuda":
        raise ValueError(f"topk_sparsify: x is on {x.device}; the kernel "
                         "takes CUDA tensors only")
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 2 \
            or not x.is_contiguous():
        raise ValueError(f"topk_sparsify: x must be contiguous (nb, block) "
                         f"float32 or bfloat16, got {x.dtype} "
                         f"{tuple(x.shape)}")
    _check_rows("topk_sparsify", x, k)
    nb, block = x.shape
    vals = torch.empty((nb, k), dtype=x.dtype, device=x.device)
    idx = torch.empty((nb, k), dtype=torch.int32, device=x.device)
    dense = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel_fn("topk_sparsify_fwd", _SPARSIFY_ARGTYPES)(
            x.data_ptr(), vals.data_ptr(), idx.data_ptr(), dense.data_ptr(),
            nb, block, int(k), int(x.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"topk_sparsify kernel launch failed: CUDA error "
                           f"{err}")
    topk_sparsify.launches += 1
    return vals, idx, dense


topk_encode_ef.launches = 0
topk_sparsify.launches = 0
