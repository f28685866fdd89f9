"""Fused Adam update over one flat leaf, in place.

Port of ``repro/kernels/fused_adam.py::fused_adam`` (the Pallas TPU kernel
behind ``adam(fused=True)``) and of its oracle
``repro/kernels/ref.py::fused_adam_ref``:

    m' = b1·m + (1−b1)·g
    v' = b2·v + (1−b2)·g·g
    p' = p − lr·(m'/bc1) / (sqrt(v'/bc2) + eps)

over flat ``(N,)`` p (float32 or bfloat16; p' keeps p's dtype), g, m and v
(float32).  ``consts`` is the 3-vector ``(lr, bc1, bc2)`` as a float32
tensor on p's device, so no step reads a value back to the host.

Unlike the reference, which returns new arrays, both versions here write
p', m' and v' INTO p, m and v (what a donated JAX step does to its
buffers) and return them: the update then needs no second copy of the
optimizer state.

``fused_adam`` launches the CUDA kernel (``csrc/fused_adam.cu``) and counts
its launches in ``fused_adam.launches``; ``fused_adam_plain`` is the plain
PyTorch version.  ``kernels.ops.fused_adam`` picks between them by the
tensors' device.
"""

from __future__ import annotations

import ctypes

import torch


def fused_adam_plain(p, g, m, v, consts, *, b1=0.9, b2=0.999, eps=1e-8):
    """The update in the order of the kernel body, written into p, m, v."""
    lr, bc1, bc2 = consts[0], consts[1], consts[2]
    gf = g.float()
    m1 = b1 * m + (1 - b1) * gf
    v1 = b2 * v + (1 - b2) * gf * gf
    p1 = p.float() - lr * (m1 / bc1) / (torch.sqrt(v1 / bc2) + eps)
    p.copy_(p1)  # rounds to p's dtype
    m.copy_(m1)
    v.copy_(v1)
    return p, m, v


# the C prototype of fused_adam_fwd in csrc/fused_adam.cu:
# p, g, m, v, consts; n; b1, 1-b1, b2, 1-b2, eps; p_bf16; stream
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong]
             + [ctypes.c_float] * 5 + [ctypes.c_int, ctypes.c_void_p])


def _kernel_fn():
    from repro_torch.kernels import _build

    fn = _build.load("fused_adam").fused_adam_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check(p, g, m, v, consts):
    named = {"p": p, "g": g, "m": m, "v": v, "consts": consts}
    for name, t in named.items():
        if t.device.type != "cuda":
            raise ValueError(f"fused_adam: {name} is on {t.device}; the "
                             "kernel takes CUDA tensors only")
        if t.device != p.device:
            raise ValueError(f"fused_adam: {name} is on {t.device}, p on "
                             f"{p.device}")
        if not t.is_contiguous() or t.dim() != 1:
            raise ValueError(f"fused_adam: {name} must be a contiguous flat "
                             f"tensor, got shape {tuple(t.shape)}")
    if p.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_adam: p must be float32 or bfloat16, got "
                         f"{p.dtype}")
    for name in ("g", "m", "v", "consts"):
        if named[name].dtype != torch.float32:
            raise ValueError(f"fused_adam: {name} must be float32")
    n = p.numel()
    if n < 1 or g.numel() != n or m.numel() != n or v.numel() != n:
        raise ValueError(f"fused_adam: p, g, m, v sizes {n}, {g.numel()}, "
                         f"{m.numel()}, {v.numel()} must agree and be > 0")
    if consts.numel() != 3:
        raise ValueError("fused_adam: consts must be (lr, bc1, bc2)")


def fused_adam(p, g, m, v, consts, *, b1=0.9, b2=0.999, eps=1e-8):
    """Launch the CUDA kernel on the current stream (CUDA tensors only;
    raises on anything the kernel does not take).  Updates p, m, v in
    place and returns them."""
    _check(p, g, m, v, consts)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel_fn()(p.data_ptr(), g.data_ptr(), m.data_ptr(),
                           v.data_ptr(), consts.data_ptr(), p.numel(),
                           b1, 1 - b1, b2, 1 - b2, eps,
                           int(p.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"fused_adam kernel launch failed: CUDA error "
                           f"{err}")
    fused_adam.launches += 1
    return p, m, v


fused_adam.launches = 0
