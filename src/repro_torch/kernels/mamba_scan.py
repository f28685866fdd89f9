"""Selective scan (Mamba S6) with the discretisation fused in.

Port of ``repro/kernels/mamba_scan.py::mamba_scan`` (the Pallas TPU kernel)
and of its oracle ``repro/kernels/ref.py::mamba_scan_ref``.

  u, delta (B, L, D)  f32 or bf16
  a        (D, N)     the continuous-time A (``-exp(A_log)``), f32
  b, c     (B, L, N)  u's dtype; slices with a contiguous last dim are read
                      in place (the model passes slices of ``x_proj``'s
                      output)
  d_skip   (D,)
  h_t = exp(delta_t * A) * h_{t-1} + (delta_t * u_t) * B_t,  h_0 = 0
  y_t = h_t . C_t + d_skip * u_t
  → (y (B, L, D) in u's dtype, h_last (B, D, N) f32), all arithmetic in f32

``mamba_scan`` launches the CUDA kernel (``csrc/mamba_scan.cu``) and counts
its launches in ``mamba_scan.launches``.  ``mamba_scan_plain`` is the plain
PyTorch version.  ``kernels.ops.mamba_scan`` picks between them by the
tensors' device.
"""

from __future__ import annotations

import ctypes

import torch

# the state sizes the kernel is built for: the reference's sweep
# (tests/test_kernels.py) and every config's ssm_state_dim (16)
STATE_DIMS = (4, 8, 16)


def mamba_scan_plain(u, delta, a, b, c, d_skip):
    """The recurrence step by step over L in f32, as ``mamba_scan_ref``."""
    bsz, l, d = u.shape
    uf, df, bf, cf = (t.float() for t in (u, delta, b, c))
    af, ds = a.float(), d_skip.float()
    h = torch.zeros((bsz, d, a.shape[1]), dtype=torch.float32,
                    device=u.device)
    ys = torch.empty((bsz, l, d), dtype=torch.float32, device=u.device)
    for t in range(l):
        abar = torch.exp(df[:, t, :, None] * af)
        h = abar * h + (df[:, t] * uf[:, t])[..., None] * bf[:, t, None, :]
        ys[:, t] = torch.einsum("bdn,bn->bd", h, cf[:, t]) + ds * uf[:, t]
    return ys.to(u.dtype), h


# the C prototype of mamba_scan_fwd in csrc/mamba_scan.cu: u, delta, a, b,
# c, d_skip, y, h_last; batch, length, dim, state; the (b, l) element
# strides of b and c; bf16; stream
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
             + [ctypes.c_longlong] * 4 + [ctypes.c_int] + [ctypes.c_void_p])


def _kernel_fn():
    from repro_torch.kernels import _build

    fn = _build.load("mamba_scan").mamba_scan_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check(u, delta, a, b, c, d_skip):
    named = (("u", u), ("delta", delta), ("a", a), ("b", b), ("c", c),
             ("d_skip", d_skip))
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"mamba_scan: {name} is on {t.device}; the "
                             "kernel takes CUDA tensors only")
        if t.device != u.device:
            raise ValueError(f"mamba_scan: {name} is on {t.device}, u on "
                             f"{u.device}")
    if u.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"mamba_scan: dtype {u.dtype} is not float32 or "
                         "bfloat16")
    for name, t in (("delta", delta), ("b", b), ("c", c)):
        if t.dtype != u.dtype:
            raise ValueError(f"mamba_scan: {name} is {t.dtype}, u "
                             f"{u.dtype}; the kernel takes one dtype")
    if u.dim() != 3 or delta.shape != u.shape:
        raise ValueError(f"mamba_scan: u {tuple(u.shape)} and delta "
                         f"{tuple(delta.shape)} must be one (B, L, D)")
    bsz, l, d = u.shape
    if a.dim() != 2 or a.shape[0] != d:
        raise ValueError(f"mamba_scan: a {tuple(a.shape)} is not (D={d}, N)")
    n = a.shape[1]
    for name, t in (("b", b), ("c", c)):
        if tuple(t.shape) != (bsz, l, n):
            raise ValueError(f"mamba_scan: {name} {tuple(t.shape)} is not "
                             f"(B, L, N) = {(bsz, l, n)}")
    if tuple(d_skip.shape) != (d,):
        raise ValueError(f"mamba_scan: d_skip {tuple(d_skip.shape)} is not "
                         f"(D,) = {(d,)}")
    if n not in STATE_DIMS:
        raise ValueError(f"mamba_scan: kernel is built for N in {STATE_DIMS};"
                         f" got {n}")
    if min(bsz, l, d) < 1 or bsz > 65535:
        raise ValueError(f"mamba_scan: shape {tuple(u.shape)} is empty or "
                         "too large")


def mamba_scan(u, delta, a, b, c, d_skip):
    """Launch the CUDA kernel on the current stream (CUDA tensors only;
    raises on anything the kernel does not take).  u and delta are made
    contiguous, b and c only if their last dim is not; a and d_skip go in
    as f32."""
    _check(u, delta, a, b, c, d_skip)
    bsz, l, d = u.shape
    n = a.shape[1]
    u, delta = u.contiguous(), delta.contiguous()
    b = b if b.stride(-1) == 1 else b.contiguous()
    c = c if c.stride(-1) == 1 else c.contiguous()
    a = a.float().contiguous()
    d_skip = d_skip.float().contiguous()
    y = torch.empty_like(u)
    h_last = torch.empty((bsz, d, n), dtype=torch.float32, device=u.device)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel_fn()(
            u.data_ptr(), delta.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), d_skip.data_ptr(), y.data_ptr(), h_last.data_ptr(),
            bsz, l, d, n, b.stride(0), b.stride(1), c.stride(0), c.stride(1),
            int(u.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"mamba_scan kernel launch failed: CUDA error "
                           f"{err}")
    mamba_scan.launches += 1
    return y, h_last


mamba_scan.launches = 0
