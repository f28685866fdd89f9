"""Paged attention: one decode token per sequence over a paged KV cache.

Port of ``repro/kernels/paged_attention.py::paged_attention`` (the Pallas
TPU kernel) and of its oracle ``repro/kernels/ref.py::paged_attention_ref``.

  q             (B, KV, G, Dh) grouped queries, f32 or bf16
  k/v_pages     (num_pages, page_size, KV, Dh), f32 or bf16
  block_tables  (B, max_blocks) int32 physical page ids
  ctx_lens      (B,) int32 live context per sequence (query position + 1)
  window        sliding window in tokens; None or <= 0 is full attention
  softcap       optional logit softcap
  → (B, KV, G, Dh) in q's dtype

``paged_attention`` launches the CUDA kernel (``csrc/paged_attention.cu``:
a split-K pass over parts of each row's context, then a pass that combines
the parts) and counts its calls in ``paged_attention.launches``.
``split_plan`` picks the number of parts from the static shapes alone.
``paged_attention_plain`` is the plain PyTorch version: it gathers the
pages into a dense view, masks, and runs softmax and PV in f32.
``kernels.ops.paged_attention`` picks between them by the tensors' device.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

NEG_INF = -2.0e38
MAX_GROUPS = 16
MAX_HEAD_DIM = 256
# split-K: each (sequence, kv head) row's live context is cut into at most
# MAX_SPLITS parts, each a whole number of SPLIT_TILE tokens, so that a
# decode step launches at least TARGET_BLOCKS blocks: two for each of the
# H100's 132 SMs
MAX_SPLITS = 64
SPLIT_TILE = 32
TARGET_BLOCKS = 2 * 132


def paged_attention_plain(q, k_pages, v_pages, block_tables, ctx_lens, *,
                          window: Optional[int] = None,
                          softcap: Optional[float] = None):
    """Gather the pages into a dense (B, MB·page_size, KV, Dh) view and
    attend with the mask ``j <= ctx - 1`` (and ``ctx - 1 - j < window``
    when ``window > 0``); f32 logits, softmax and PV, as
    ``paged_attention_ref``."""
    b, kv, g, dh = q.shape
    bt = block_tables.long()
    ks = k_pages[bt].reshape(b, -1, kv, dh)
    vs = v_pages[bt].reshape(b, -1, kv, dh)
    logits = torch.einsum("bkgd,bskd->bkgs", q.float(), ks.float()) \
        * (dh ** -0.5)
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    j = torch.arange(ks.shape[1], device=q.device)[None, None, None, :]
    pos = (ctx_lens.long() - 1)[:, None, None, None]
    mask = j <= pos
    if window is not None and window > 0:
        mask = mask & ((pos - j) < window)
    logits = torch.where(mask, logits, NEG_INF)
    # masked probabilities are zeroed, as the kernels zero them, so a row
    # with no live token (ctx <= 0) gives 0; every other row is unchanged
    probs = torch.where(mask, torch.softmax(logits, dim=-1), 0.0)
    out = torch.einsum("bkgs,bskd->bkgd", probs, vs.float())
    return out.to(q.dtype)


def split_plan(q, k_pages, block_tables):
    """The number of parts S each row's context is split into, from the
    tensors' shapes alone: B·KV·S ≥ TARGET_BLOCKS where the table's reach
    (max_blocks · page_size tokens) gives every part at least one
    SPLIT_TILE, and S ≤ MAX_SPLITS.  It reads no tensor values, so a decode
    step never waits on ``ctx_lens``."""
    rows = q.shape[0] * q.shape[1]
    reach = block_tables.shape[1] * k_pages.shape[1]
    want = -(-TARGET_BLOCKS // rows)
    return max(1, min(want, reach // SPLIT_TILE, MAX_SPLITS))


def split_range(ctx, reach, window, splits, s):
    """The tokens [begin, end) that part ``s`` of ``splits`` covers in a
    row whose ``ctx_lens`` entry is ``ctx`` and whose table reaches
    ``reach`` tokens (ints): the s-th of ``splits`` equal parts of the live
    range [lo, min(ctx, reach)), rounded up to SPLIT_TILE tokens, as the
    kernel's first pass cuts it; the window's edge lo is the query's."""
    lo = max(ctx - window, 0) if window is not None and window > 0 else 0
    hi = min(ctx, reach)
    per = -(-max(hi - lo, 0) // splits)  # ceil(live / splits)
    part = -(-per // SPLIT_TILE) * SPLIT_TILE
    begin = lo + s * part
    return begin, min(begin + part, hi)


# the C prototype of paged_attention_fwd in csrc/paged_attention.cu:
# q, k_pages, v_pages, block_tables, ctx_lens, out, scratch; batch, num_kv,
# groups, head_dim, page_size, max_blocks, window, splits, split_tile;
# scale, softcap; q_bf16, kv_bf16; stream
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
             + [ctypes.c_float] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def _kernel_fn():
    from repro_torch.kernels import _build

    fn = _build.load("paged_attention").paged_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check(q, k_pages, v_pages, block_tables, ctx_lens, softcap):
    named = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
             "block_tables": block_tables, "ctx_lens": ctx_lens}
    for name, t in named.items():
        if t.device.type != "cuda":
            raise ValueError(f"paged_attention: {name} is on {t.device}; "
                             "the kernel takes CUDA tensors only")
        if t.device != q.device:
            raise ValueError(f"paged_attention: {name} is on {t.device}, "
                             f"q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} is not contiguous")
    floats = (torch.float32, torch.bfloat16)
    if q.dtype not in floats:
        raise ValueError(f"paged_attention: q dtype {q.dtype} not in {floats}")
    if k_pages.dtype not in floats or v_pages.dtype != k_pages.dtype:
        raise ValueError("paged_attention: k/v pages must both be float32 or "
                         f"bfloat16, got {k_pages.dtype}/{v_pages.dtype} "
                         "(int8 pools take the gather path)")
    if block_tables.dtype != torch.int32 or ctx_lens.dtype != torch.int32:
        raise ValueError("paged_attention: block_tables and ctx_lens must be "
                         "int32")
    if q.dim() != 4 or k_pages.dim() != 4 or block_tables.dim() != 2:
        raise ValueError(f"paged_attention: bad ranks q{tuple(q.shape)} "
                         f"k{tuple(k_pages.shape)} bt{tuple(block_tables.shape)}")
    b, kv, g, dh = q.shape
    if k_pages.shape != v_pages.shape or k_pages.shape[2:] != (kv, dh):
        raise ValueError(f"paged_attention: pages {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not fit q {tuple(q.shape)}")
    if block_tables.shape[0] != b or tuple(ctx_lens.shape) != (b,):
        raise ValueError("paged_attention: block_tables/ctx_lens batch differs "
                         "from q's")
    if dh % 32 or not 32 <= dh <= MAX_HEAD_DIM or not 1 <= g <= MAX_GROUPS:
        raise ValueError(f"paged_attention: kernel takes Dh a multiple of 32 "
                         f"up to {MAX_HEAD_DIM} and G <= {MAX_GROUPS}; got "
                         f"Dh={dh}, G={g}")
    if b < 1 or kv < 1 or block_tables.shape[1] < 1:
        raise ValueError("paged_attention: empty batch, heads or tables")
    if max(b, kv) > 65535:
        raise ValueError(f"paged_attention: B={b} or KV={kv} above the "
                         "kernel's grid limit 65535")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged_attention: k/v pages must be 16-byte aligned "
                         "(the kernel reads them with 16-byte loads)")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"paged_attention: softcap must be > 0, got {softcap}")


def paged_attention(q, k_pages, v_pages, block_tables, ctx_lens, *,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None):
    """Launch the CUDA kernel on the current stream (CUDA tensors only;
    raises on anything the kernel does not take).  ``block_tables`` must
    hold valid page ids: the engine's allocator guarantees it, and checking
    on the device would cost a synchronisation per layer."""
    _check(q, k_pages, v_pages, block_tables, ctx_lens, softcap)
    b, kv, g, dh = q.shape
    splits = split_plan(q, k_pages, block_tables)
    out = torch.empty_like(q)
    # the first pass's partial acc, m and l of every (b, h, part, g) row
    scratch = torch.empty(b * kv * splits * g * (dh + 2),
                          dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel_fn()(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), ctx_lens.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), b, kv, g, dh, k_pages.shape[1],
            block_tables.shape[1], -1 if window is None else int(window),
            splits, SPLIT_TILE, dh ** -0.5,
            0.0 if softcap is None else float(softcap),
            int(q.dtype == torch.bfloat16),
            int(k_pages.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA error "
                           f"{err}")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
