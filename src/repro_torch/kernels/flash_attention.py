"""Flash attention: full-sequence attention with an online softmax.

Port of ``repro/kernels/flash_attention.py::flash_attention`` (the Pallas
TPU kernel) and of its oracle ``repro/kernels/ref.py::flash_attention_ref``.

  q      (B, H, Lq, D)  f32 or bf16
  k, v   (B, KV, Lk, D) q's dtype, KV dividing H: query head h reads kv
         head h // (H / KV), what the model's ``repeat`` of the kv heads
         computes, without the copy
  causal mask j <= i (absolute indices, both from 0)
  window sliding window i - j < window; <= 0 is full attention
  → (B, H, Lq, D) in q's dtype; logits and softmax in f32, scale D^-0.5
    on the f32 logits; a row with no visible key is 0

The inputs may be strided views with a contiguous last dim, such as
``x.transpose(1, 2)`` of the model's (B, L, H, D) tensors: the kernel reads
them in place, and the output has q's strides (``torch.empty_like``), so
transposing it back gives a contiguous (B, L, H, D) tensor.

``flash_attention`` launches the CUDA kernel (``csrc/flash_attention.cu``)
and counts its launches in ``flash_attention.launches``.  The kernel has
two designs, picked by dtype: bf16 runs on the tensor cores (``wgmma``,
BLOCK_Q query rows a block, BLOCK_K keys a tile), with P rounded to bf16
before the f32-accumulated PV, as the model's own attention rounds it; f32
runs a SIMT kernel with PV in f32.  ``flash_attention_plain`` is the plain
PyTorch version (PV in f32).  ``kernels.ops.flash_attention`` picks between
them by the tensors' device.
"""

from __future__ import annotations

import ctypes

import torch

NEG_INF = -2.0e38
# the head dims the kernel is built for: the registered configs use 256 and
# 128 (64 reduced), the quickstart example 32
HEAD_DIMS = (32, 64, 128, 256)
# the bf16 (tensor-core) kernel's tiles: query rows a block, keys a kv tile
BLOCK_Q = 64
BLOCK_K = 64


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = -1):
    """Masked dense attention with f32 logits, softmax and PV, as
    ``flash_attention_ref``; the kv heads are indexed per query head
    (grouped einsum, no copy).  Masked probabilities are zeroed, as the
    kernel zeroes them, so a fully masked row gives 0 (the reference has no
    such row: its Lq equals Lk and every row sees its own key)."""
    b, h, lq, d = q.shape
    kvh, lk = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, kvh, h // kvh, lq, d)
    logits = torch.einsum("bkgid,bkjd->bkgij", qg, k.float()) * (d ** -0.5)
    i = torch.arange(lq, device=q.device)[:, None]
    j = torch.arange(lk, device=q.device)[None, :]
    mask = torch.ones((lq, lk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= j <= i
    if window > 0:
        mask &= (i - j) < window
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.where(mask, torch.softmax(logits, dim=-1), 0.0)
    out = torch.einsum("bkgij,bkjd->bkgid", probs, v.float())
    return out.reshape(b, h, lq, d).to(q.dtype)


# the C prototype of flash_attention_fwd in csrc/flash_attention.cu:
# q, k, v, out; batch, heads, kv_heads, q_len, kv_len, head_dim; the (b, h,
# l) element strides of q, k, v and out; causal, window; scale; bf16; stream
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 2
             + [ctypes.c_float] + [ctypes.c_int] + [ctypes.c_void_p])


def _kernel_fn():
    from repro_torch.kernels import _build

    fn = _build.load("flash_attention").flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention: {name} is on {t.device}; "
                             "the kernel takes CUDA tensors only")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, "
                             f"q on {q.device}")
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be (B, H, L, D), "
                             f"got {tuple(t.shape)}")
        if t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype}, q "
                             f"{q.dtype}; the kernel takes one dtype")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name}'s last dim is not "
                             "contiguous")
        # every row starts on a 16-byte boundary: the kernel reads rows
        # with 16-byte loads (a stride of a size-1 dim is never applied)
        strides = [s for s, n in zip(t.stride()[:3], t.shape[:3]) if n > 1]
        if t.data_ptr() % 16 or any(s * t.element_size() % 16
                                    for s in strides):
            raise ValueError(f"flash_attention: {name}'s rows are not 16-byte "
                             "aligned")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention: dtype {q.dtype} is not float32 "
                         "or bfloat16")
    b, h, lq, d = q.shape
    kvh, lk = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if kvh < 1 or h % kvh:
        raise ValueError(f"flash_attention: {kvh} kv heads do not divide "
                         f"{h} heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: kernel is built for D in "
                         f"{HEAD_DIMS}; got {d}")
    if min(b, h, lq, lk) < 1 or max(b, h) > 65535:
        raise ValueError(f"flash_attention: shape q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} is empty or too large")


def flash_attention(q, k, v, *, causal: bool = True, window: int = -1):
    """Launch the CUDA kernel on the current stream (CUDA tensors only;
    raises on anything the kernel does not take)."""
    _check(q, k, v)
    b, h, lq, d = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, k.shape[1], lq, k.shape[2], d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], int(bool(causal)), int(window), d ** -0.5,
            int(q.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error "
                           f"{err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
