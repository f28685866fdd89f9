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

The gradient.  The reference has no backward kernel: its Pallas scan is
forward only, and its training differentiates the jnp chunked scan
(``repro/models/ssm.py::_selective_scan_chunk``).  Here ``MambaScan`` is
the ``torch.autograd.Function`` around the scan, and its backward is a
port-side kernel, ``mamba_scan_bwd`` (``csrc/mamba_scan_bwd.cu``, launches
in ``mamba_scan_bwd.launches``), with ``mamba_scan_bwd_plain`` beside it.
With abar_t = exp(delta_t A) and g_{L+1} = 0, walking t from L down to 1:

  g_t      = dy_t C_t + abar_{t+1} g_{t+1}                  (per d, n)
  dC_t     = sum_d dy_t h_t              dB_t = sum_d g_t delta_t u_t
  ddelta_t = sum_n g_t (A abar_t h_{t-1} + u_t B_t)
  du_t     = sum_n g_t delta_t B_t + D dy_t
  dA       = sum_{b,t} g_t delta_t abar_t h_{t-1}     dD = sum_{b,t} dy_t u_t

  → (du, ddelta in u's dtype; dA (D, N) f32; dB, dC (B, L, N) in b's
  dtype; dD (D,) f32), all arithmetic in f32
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


def _check(u, delta, a, b, c, d_skip, what="mamba_scan", dy=None):
    """Raise on what the kernel does not take: dtypes and shapes first,
    then devices."""
    if u.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: dtype {u.dtype} is not float32 or "
                         "bfloat16")
    for name, t in (("delta", delta), ("b", b), ("c", c)):
        if t.dtype != u.dtype:
            raise ValueError(f"{what}: {name} is {t.dtype}, u "
                             f"{u.dtype}; the kernel takes one dtype")
    if u.dim() != 3 or delta.shape != u.shape:
        raise ValueError(f"{what}: u {tuple(u.shape)} and delta "
                         f"{tuple(delta.shape)} must be one (B, L, D)")
    bsz, l, d = u.shape
    if a.dim() != 2 or a.shape[0] != d:
        raise ValueError(f"{what}: a {tuple(a.shape)} is not (D={d}, N)")
    n = a.shape[1]
    for name, t in (("b", b), ("c", c)):
        if tuple(t.shape) != (bsz, l, n):
            raise ValueError(f"{what}: {name} {tuple(t.shape)} is not "
                             f"(B, L, N) = {(bsz, l, n)}")
    if tuple(d_skip.shape) != (d,):
        raise ValueError(f"{what}: d_skip {tuple(d_skip.shape)} is not "
                         f"(D,) = {(d,)}")
    if n not in STATE_DIMS:
        raise ValueError(f"{what}: kernel is built for N in {STATE_DIMS};"
                         f" got {n}")
    if min(bsz, l, d) < 1 or bsz > 65535:
        raise ValueError(f"{what}: shape {tuple(u.shape)} is empty or "
                         "too large")
    named = [("u", u), ("delta", delta), ("a", a), ("b", b), ("c", c),
             ("d_skip", d_skip)]
    if dy is not None:
        if dy.dtype != u.dtype or dy.shape != u.shape:
            raise ValueError(f"{what}: dy {dy.dtype}{tuple(dy.shape)} is "
                             f"not u's {u.dtype}{tuple(u.shape)}")
        named.append(("dy", dy))
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"{what}: {name} is on {t.device}; the "
                             "kernel takes CUDA tensors only")
        if t.device != u.device:
            raise ValueError(f"{what}: {name} is on {t.device}, u on "
                             f"{u.device}")


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


def mamba_scan_bwd_plain(u, delta, a, b, c, d_skip, dy):
    """The gradient step by step in f32: a forward loop that keeps every
    state, then the reverse loop of the formulas above."""
    bsz, l, d = u.shape
    uf, df, bf, cf, gy = (t.float() for t in (u, delta, b, c, dy))
    af, ds = a.float(), d_skip.float()
    h = torch.zeros((bsz, d, a.shape[1]), dtype=torch.float32,
                    device=u.device)
    hs = [h]  # hs[t] = h_t, the state after step t (h_0 = 0)
    for t in range(l):
        abar = torch.exp(df[:, t, :, None] * af)
        h = abar * h + (df[:, t] * uf[:, t])[..., None] * bf[:, t, None, :]
        hs.append(h)
    du, ddelta = torch.empty_like(uf), torch.empty_like(uf)
    db, dc = torch.empty_like(bf), torch.empty_like(cf)
    da = torch.zeros_like(af)
    g_next = torch.zeros_like(h)  # abar_{t+1} g_{t+1}
    for t in reversed(range(l)):
        abar = torch.exp(df[:, t, :, None] * af)
        g = gy[:, t, :, None] * cf[:, t, None, :] + g_next
        dc[:, t] = torch.einsum("bdn,bd->bn", hs[t + 1], gy[:, t])
        db[:, t] = torch.einsum("bdn,bd->bn", g, df[:, t] * uf[:, t])
        decay = af * abar * hs[t]  # d h_t / d delta_t, its A term
        ddelta[:, t] = (g * (decay + uf[:, t, :, None]
                             * bf[:, t, None, :])).sum(-1)
        du[:, t] = (g * bf[:, t, None, :]).sum(-1) * df[:, t] \
            + ds * gy[:, t]
        da += (g * df[:, t, :, None] * abar * hs[t]).sum(0)
        g_next = abar * g
    dd = (gy * uf).sum((0, 1))
    return (du.to(u.dtype), ddelta.to(delta.dtype), da, db.to(b.dtype),
            dc.to(c.dtype), dd)


# the C prototype of mamba_scan_bwd in csrc/mamba_scan_bwd.cu: u, delta, a,
# b, c, d_skip, dy, du, ddelta, da_part, dd_part, bc_part, ckpt; batch,
# length, dim, state; the (b, l) element strides of b and c; bf16; the
# blocks bc_part holds; the checkpoints ckpt holds a batch row; stream
_BWD_ARGTYPES = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 4
                 + [ctypes.c_longlong] * 4 + [ctypes.c_int]
                 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])
# csrc/mamba_scan_bwd.cu's lane map: a lane holds BWD_LANE_STATES states of
# one channel (N / 2 where less), a block has BWD_WARPS warps and one
# dB/dC partial row, and the states are checkpointed every BWD_CHUNK steps;
# the C side refuses a partial or a checkpoint buffer of another shape
BWD_LANE_STATES = 8
BWD_CHUNK = 8
BWD_WARPS = 2


def bwd_blocks(dim, state):
    """Blocks along D of the backward kernel, one partial row of dB and dC
    each: a warp owns 32 / (N / states a lane) channels."""
    per = BWD_WARPS * 32 * min(BWD_LANE_STATES, state // 2) // state
    return (dim + per - 1) // per


def bwd_scratch_shapes(bsz, length, dim, state):
    """The backward kernel's f32 scratch: the dB/dC partials (B, blocks, L,
    2N) and the checkpoints (B, chunks, D, N), the states before every
    BWD_CHUNK-step tile."""
    return ((bsz, bwd_blocks(dim, state), length, 2 * state),
            (bsz, (length + BWD_CHUNK - 1) // BWD_CHUNK, dim, state))


def _bwd_kernel_fn():
    from repro_torch.kernels import _build

    fn = _build.load("mamba_scan_bwd").mamba_scan_bwd
    if fn.argtypes is None:
        fn.argtypes = _BWD_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def mamba_scan_bwd(u, delta, a, b, c, d_skip, dy):
    """Launch the backward kernel on the current stream (CUDA tensors only;
    raises on anything the kernel does not take), then sum its per-block
    partials of dB, dC (over the blocks along D) and of dA, dD (over B) in
    a fixed order: the same inputs give bitwise the same gradients.
    Returns (du, ddelta, da, db, dc, dd) as ``mamba_scan_bwd_plain``."""
    _check(u, delta, a, b, c, d_skip, "mamba_scan_bwd", dy)
    bsz, l, d = u.shape
    n = a.shape[1]
    u, delta, dy = u.contiguous(), delta.contiguous(), dy.contiguous()
    b = b if b.stride(-1) == 1 else b.contiguous()
    c = c if c.stride(-1) == 1 else c.contiguous()
    a = a.float().contiguous()
    d_skip = d_skip.float().contiguous()
    f32 = dict(dtype=torch.float32, device=u.device)
    part_shape, ckpt_shape = bwd_scratch_shapes(bsz, l, d, n)
    du, ddelta = torch.empty_like(u), torch.empty_like(u)
    da_part = torch.empty((bsz, d, n), **f32)
    dd_part = torch.empty((bsz, d), **f32)
    bc_part = torch.empty(part_shape, **f32)
    ckpt = torch.empty(ckpt_shape, **f32)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bwd_kernel_fn()(
            u.data_ptr(), delta.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), d_skip.data_ptr(), dy.data_ptr(), du.data_ptr(),
            ddelta.data_ptr(), da_part.data_ptr(), dd_part.data_ptr(),
            bc_part.data_ptr(), ckpt.data_ptr(), bsz, l, d, n, b.stride(0),
            b.stride(1), c.stride(0), c.stride(1),
            int(u.dtype == torch.bfloat16), part_shape[1], ckpt_shape[1],
            stream)
    if err:
        raise RuntimeError(f"mamba_scan_bwd kernel launch failed: CUDA error "
                           f"{err}")
    mamba_scan_bwd.launches += 1
    del ckpt
    bc = bc_part.sum(1)  # (B, L, 2N), blocks in order
    return (du, ddelta, da_part.sum(0), bc[..., :n].to(b.dtype).contiguous(),
            bc[..., n:].to(c.dtype).contiguous(), dd_part.sum(0))


mamba_scan_bwd.launches = 0


class MambaScan(torch.autograd.Function):
    """``kernels.ops.mamba_scan`` with a gradient: the forward is the scan
    (the kernel on CUDA tensors, the plain version on CPU tensors), the
    backward ``kernels.ops.mamba_scan_bwd`` (likewise).  ``h_last`` is not
    differentiable.  Each gradient comes back in its input's dtype; dB and
    dC as full (B, L, N) tensors, which autograd scatters into the
    projection output that b and c were sliced from.  Under
    ``torch.utils.checkpoint`` the forward runs again in the backward
    pass: a remat step launches the scan twice."""

    @staticmethod
    def forward(ctx, u, delta, a, b, c, d_skip):
        from repro_torch.kernels import ops

        y, h_last = ops.mamba_scan(u, delta, a, b, c, d_skip)
        ctx.mark_non_differentiable(h_last)
        if any(ctx.needs_input_grad):  # every input enters every gradient
            ctx.save_for_backward(u, delta, a, b, c, d_skip)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, _dh_last):
        from repro_torch.kernels import ops

        inputs = ctx.saved_tensors
        grads = ops.mamba_scan_bwd(*inputs, dy)
        return tuple(g.to(x.dtype) if need else None for g, x, need in
                     zip(grads, inputs, ctx.needs_input_grad))
