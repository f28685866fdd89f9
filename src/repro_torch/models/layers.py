"""Transformer layers: norms, RoPE, GQA attention (bias, qk-norm, softcap,
sliding window, bidirectional, cross) for training, for prefill and decode
over a dense KV cache and over a paged KV cache, the SwiGLU MLP and the
capacity-dispatch MoE.

Port of the training and serving paths of ``repro/models/layers.py``.
Layers are plain functions on tensors over parameter dicts with the
reference's tree layout.  Precision contract as in the reference:
matmuls run in the dtype the inputs carry, while ``rms_norm`` statistics,
RoPE angles, attention logits and softmax are f32.

Tensor parallelism (``models/tensor_parallel.py``), as the reference:
the training attention, the cross attention and the dense MLP take one
of three branches.
Under an active ``tp_context`` (a rank process of a mesh's "model" axis)
the params hold this rank's head block or d_ff columns and the partial
is combined by ONE ``all_sum``; with ``cfg.tp_degree = T > 1`` and no
context, the blocked form computes the T blocks' subgraphs and sums them
with ``torch.stack(parts).sum(0)`` (what a TP run computes, bit for
bit, in its forward); otherwise the single path, which
``cfg.tp_degree == 1`` keeps bit for bit.  A width that does not divide
by T stays whole (shared-expert MLPs).  The MoE's shared experts are
replicated over "model" and run the single path under a context
(``mlp(..., replicated=True)``): an all-sum would count them T times.
The prefill, decode and paged paths keep the single path, as in the
reference; cross attention takes the three branches in both its forms
(``_sdpa`` for the loss, the flash kernel for serving).

Context parallelism (``models/context_parallel.py``, the reference's
``cp`` mode): under a ``cp_context`` the training attention takes q from
this rank's sequence chunk and all-gathers k and v over "model", and
``moe`` routes the all-gathered rows and keeps its chunk of the output;
with ``cfg.sharding_mode == "cp"`` ``_sdpa`` is the reference's grouped
einsum (KV heads not expanded), on one device too.

Expert parallelism: ``moe`` takes ``_moe_ep`` under a current mesh
(``launch/mesh.py::use_mesh``) whose "model" axis divides the padded
experts, when the GLOBAL token count (a rank's rows times the batch
axes' ranks) is 4096 or more and the rank's tokens divide by the axis,
as the reference's rule over its global batch.

Differences from the reference, none of which changes a result:
  * the ``shard(...)`` calls are gone (no-ops on one device; the
    reference's ``cp`` placement of k and v is the explicit all-gather in
    ``attention``'s head block, which takes the masked path only: the
    banded one would need the neighbour's chunk);
  * the page pools and the dense cache are updated IN PLACE
    (``index_put_``) instead of returning a new cache, which halves the
    cache's peak memory;
  * the reference's ``attention(..., collect_cache=True)`` (prefill) is
    ``attention_prefill`` here, and its single-token decode branch is
    ``attention_decode``; the prefill's full-sequence attention goes
    through ``kernels.ops.flash_attention``, which computes what the
    reference's ``_sdpa`` does there except that PV stays in f32 (the
    reference casts the probabilities to v's dtype first): the same in
    f32, within bf16 rounding in bf16;
  * the reference's cross-attention branch (``attention(..., memory=)``)
    is ``cross_attention`` here, which serving runs on the same kernel
    (``kernel=True``, no mask) and the loss on ``_sdpa`` (``kernel=False``);
  * paged single-token decode always goes through
    ``kernels.ops.paged_attention``; chunked prefill and int8 pools take
    the gather path, as in the reference (``layers.py:457-465``).
  * ``_moe_ep`` runs in each rank process of the mesh (the reference's
    ``shard_map`` body): the collectives are ``core/comm.py``'s autograd
    ones over the mesh's "model" ``ShardComm``.  Each model rank holds
    its E/ep experts whole; the reference's FSDP ``all_gather`` of the
    expert weights over "data" (a pjit placement) falls away, ZeRO-3 of
    the sharded step taking its role.  Its aux is pmeaned over "model"
    only: the sharded step already means the ranks' losses and
    gradients over the batch axes.  Where the banks are split over
    "model" but the dense dispatch is taken (too few tokens), the banks
    are all-gathered first: the reference's dense path under its mesh;
  * the top-k of the routing is a stable descending sort
    (``lax.top_k``'s order: the lowest index first on a tie), not
    ``torch.topk``, which orders ties arbitrarily.

``kernels.ops`` sends CUDA tensors to the hand-written kernels and CPU
tensors to their plain PyTorch versions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import FULL_ATTENTION, ModelConfig
from repro_torch.core.comm import all_gather, all_to_all, pmean
from repro_torch.kernels import ops
from repro_torch.launch.mesh import BATCH_AXES, current_mesh
from repro_torch.models.context_parallel import current_cp
from repro_torch.models.tensor_parallel import current_tp

NEG_INF = -2.0e38
INT32_MAX = 2**31 - 1


def dense_init(gen, shape, dtype, device, lead=(), in_axis=0,
               by_row=False):
    """Normal weights scaled by ``shape[in_axis] ** -0.5`` (the fan-in, as
    the reference's ``dense_init``), drawn in f32 from the
    ``torch.Generator`` ``gen`` (which lives on ``device``).  ``lead`` is a
    shape prefix such as ``(repeat,)`` for a stacked layer.  ``by_row``
    draws one ``shape`` at a time into a preallocated tensor of ``dtype``,
    so the f32 transient is one row of the lead axes, not the whole leaf
    twice (the experts of a large MoE stack)."""
    scale = 1.0 / max(1, shape[in_axis]) ** 0.5
    full = tuple(lead) + tuple(shape)
    if not by_row:
        w = torch.randn(full, generator=gen, device=device,
                        dtype=torch.float32)
        return (w * scale).to(dtype)
    out = torch.empty(full, dtype=dtype, device=device)
    for row in out.view((-1,) + tuple(shape)):
        row.copy_(torch.randn(shape, generator=gen, device=device,
                              dtype=torch.float32) * scale)
    return out


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def rms_norm(x, p, eps):
    # statistics in f32; cast back to x's dtype BEFORE the scale multiply,
    # as the reference does (the other order drifts in bf16)
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return out.to(x.dtype) * p["scale"].to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope(x, positions, theta):
    """Half-split (not interleaved) rotary embedding.  x: (..., L, H, Dh),
    positions: (..., L) int, theta: the layer's base."""
    dh = x.shape[-1]
    half = dh // 2
    freq = torch.arange(half, dtype=torch.float32, device=x.device) \
        * (2.0 / dh)
    # a Python base keeps theta off the device: a device scalar built here
    # would be a host-to-device copy, and a synchronisation, per call
    inv = torch.pow(float(theta), -freq)
    ang = positions[..., None].float() * inv
    sin, cos = ang.sin()[..., None, :], ang.cos()[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def init_attention(gen, cfg: ModelConfig, dtype, device, lead=()):
    d, h, kv, dh = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    lead = tuple(lead)

    def const(shape, fill):
        return torch.full(lead + shape, fill, dtype=dtype, device=device)

    p = {
        "wq": dense_init(gen, (d, h, dh), dtype, device, lead=lead),
        "wk": dense_init(gen, (d, kv, dh), dtype, device, lead=lead),
        "wv": dense_init(gen, (d, kv, dh), dtype, device, lead=lead),
        "wo": dense_init(gen, (h, dh, d), dtype, device, lead=lead),
    }
    if cfg.qkv_bias:
        p["bq"], p["bk"], p["bv"] = (const((h, dh), 0.0), const((kv, dh), 0.0),
                                     const((kv, dh), 0.0))
    if cfg.qk_norm:
        p["q_norm"] = {"scale": const((dh,), 1.0)}
        p["k_norm"] = {"scale": const((dh,), 1.0)}
    return p


def _qkv(p, cfg, x, xkv=None):
    """q from ``x``, k and v from ``xkv`` (the encoder's memory for cross
    attention; ``x`` when None); bias and qk-norm on both, as the
    reference's ``_qkv(p, cfg, xq, xkv)``."""
    xkv = x if xkv is None else xkv
    q = torch.einsum("bld,dhk->blhk", x, p["wq"])
    k = torch.einsum("bld,dhk->blhk", xkv, p["wk"])
    v = torch.einsum("bld,dhk->blhk", xkv, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _softcap(cfg, logits):
    if cfg.attn_logit_softcap:
        c = cfg.attn_logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def _einsum(eq, a, b):
    """``torch.einsum`` with ``jnp.einsum``'s type promotion (a bf16 pool
    read by f32 activations computes in f32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def _sdpa(cfg: ModelConfig, q, k, v, mask):
    """Full-sequence attention.  q: (B,Lq,H,Dh), k/v: (B,Lk,KV,Dh), mask:
    (B,1,Lq,Lk).  The KV heads are repeated to H first, as the reference's
    head-sharded ``tp`` path does; under ``sharding_mode="cp"`` the
    grouped einsum of its ``cp`` branch instead (KV not expanded).
    Logits and softmax in f32, PV in v's dtype."""
    if cfg.sharding_mode == "cp":
        return _sdpa_decode(cfg, q, k, v, mask)
    h, dh = q.shape[2], q.shape[3]
    kvh = k.shape[2]
    if kvh != h:
        k = torch.repeat_interleave(k, h // kvh, dim=2)
        v = torch.repeat_interleave(v, h // kvh, dim=2)
    logits = torch.einsum("blhd,bshd->bhls", q, k).float()
    logits = logits * dh ** -0.5
    logits = _softcap(cfg, logits)
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhls,bshd->blhd", probs, v)


def _sdpa_banded(cfg: ModelConfig, q, k, v, window: int):
    """Block-banded sliding-window attention (exact for window <= block):
    q, k, v (B, L, H|KV, Dh) in blocks of ``window``; each q block attends
    to the (previous, own) k blocks with the in-band mask."""
    b, l, h, dh = q.shape
    kvh = k.shape[2]
    if kvh != h:
        k = torch.repeat_interleave(k, h // kvh, dim=2)
        v = torch.repeat_interleave(v, h // kvh, dim=2)
        kvh = h
    w = window
    nb = l // w
    qb = q.reshape(b, nb, w, h, dh)
    kb = k.reshape(b, nb, w, kvh, dh)
    vb = v.reshape(b, nb, w, kvh, dh)
    kprev = torch.cat([torch.zeros_like(kb[:, :1]), kb[:, :-1]], dim=1)
    vprev = torch.cat([torch.zeros_like(vb[:, :1]), vb[:, :-1]], dim=1)
    kk = torch.cat([kprev, kb], dim=2)  # (B, nb, 2w, KV, Dh)
    vv = torch.cat([vprev, vb], dim=2)

    g = h // kvh
    qg = qb.reshape(b, nb, w, kvh, g, dh)
    logits = torch.einsum("bnikgd,bnjkd->bnkgij", qg, kk).float()
    logits = logits * dh ** -0.5
    logits = _softcap(cfg, logits)
    # in-band mask: global i = n·w + ii, global j = n·w − w + jj
    ii = torch.arange(w, device=q.device)[:, None]
    jj = torch.arange(2 * w, device=q.device)[None, :]
    rel = ii + w - jj  # = i − j
    first = torch.arange(nb, device=q.device) == 0  # block 0 has no prev
    valid = (rel >= 0) & (rel < w)  # causal ∧ window
    valid = valid[None, :, :] & ~(first[:, None, None] & (jj < w)[None])
    logits = torch.where(valid[None, :, None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(vv.dtype)
    out = torch.einsum("bnkgij,bnjkd->bnikgd", probs, vv)
    return out.reshape(b, l, h, dh)


def _attn_slice(p, i: int, t: int):
    """Head block i of t of an attention param dict: what
    ``tensor_parallel.tp_rank_params`` gives rank i, each slice a
    contiguous copy as the rank's own tensors are."""
    h, kv = p["wq"].shape[1], p["wk"].shape[1]
    hb, kb = h // t, kv // t
    out = dict(p)
    out["wq"] = p["wq"][:, i * hb:(i + 1) * hb].contiguous()
    out["wk"] = p["wk"][:, i * kb:(i + 1) * kb].contiguous()
    out["wv"] = p["wv"][:, i * kb:(i + 1) * kb].contiguous()
    out["wo"] = p["wo"][i * hb:(i + 1) * hb].contiguous()
    if "bq" in p:
        out["bq"] = p["bq"][i * hb:(i + 1) * hb].contiguous()
        out["bk"] = p["bk"][i * kb:(i + 1) * kb].contiguous()
        out["bv"] = p["bv"][i * kb:(i + 1) * kb].contiguous()
    return out


def attention(p, cfg: ModelConfig, x, positions, window: int, theta: float,
              static_window: bool = False, causal: bool = True):
    """Training self-attention over the full sequence: causal (every key
    visible with ``causal=False``, the encoder's), plus the sliding window
    when ``window > 0``.  x: (B, L, D); positions: (B, L).

    ``static_window`` says whether the reference would see ``window`` as a
    Python int (``cfg.scan_layers=False``, the unrolled stack) or as a
    traced array (under ``lax.scan``, the default).  Only a static window
    takes the block-banded path, and only when L is a multiple of it and
    spans two blocks or more; everything else is the masked path.

    Tensor parallelism (the module docstring): under a ``tp_context`` this
    rank's head block and one all-sum; with ``cfg.tp_degree`` T > 1 the
    blocked form, when T divides the heads and the kv heads."""
    lq = x.shape[1]
    cp = current_cp()

    def head_block(p_):
        """One head block's subgraph: qkv → RoPE → attention over its
        heads → the out-projection's partial.  Under a ``cp_context`` x is
        this rank's chunk at its global ``positions``, and k and v after
        RoPE are all-gathered over "model" (the whole sequence, positions
        0..T·c − 1 in rank order) onto the masked path."""
        q, k, v = _qkv(p_, cfg, x)
        q = rope(q, positions, theta)
        k = rope(k, positions, theta)
        if cp is not None:
            k, v = cp.gather_seq(k), cp.gather_seq(v)
        if (cp is None and static_window and window > 0 and causal
                and lq % window == 0 and lq // window >= 2):
            out = _sdpa_banded(cfg, q, k, v, window)
        else:
            i = positions[:, :, None].long()  # (B, L, 1)
            j = (positions[:, None, :].long() if cp is None  # (B, 1, L)
                 else torch.arange(k.shape[1], device=x.device)[None, None])
            w = INT32_MAX if window == FULL_ATTENTION else window
            mask = (j <= i) if causal else torch.ones_like(j <= i)
            mask = mask & (i - j < w)
            out = _sdpa(cfg, q, k, v, mask[:, None])
        return torch.einsum("blhk,hkd->bld", out, p_["wo"])

    if cp is not None:  # every head on this rank: no combine
        return head_block(p)
    return _heads_combined(p, cfg, head_block)


def _heads_combined(p, cfg, head_block):
    """``head_block`` (an attention param dict → its out-projection's
    partial) under the three TP branches: this rank's heads and one
    all-sum under a ``tp_context``; the blocked form over ``_attn_slice``
    blocks with ``cfg.tp_degree`` T > 1 dividing the heads and the kv
    heads; else the single path."""
    tp = current_tp()
    t = cfg.tp_degree
    if tp is not None:  # this rank's head block, combined over the ranks
        return tp.all_sum(head_block(p))
    if t > 1 and p["wq"].shape[1] % t == 0 and p["wk"].shape[1] % t == 0:
        parts = [head_block(_attn_slice(p, i, t)) for i in range(t)]
        return torch.stack(parts).sum(0)
    return head_block(p)


def _sdpa_decode(cfg: ModelConfig, q, k, v, mask):
    """Grouped attention of q (B,Lq,H,Dh) against k/v (B,S,KV,Dh) with
    mask (B,1,Lq,S); logits and softmax in f32, PV in v's dtype."""
    b, lq, h, dh = q.shape
    kvh = k.shape[2]
    q = q.reshape(b, lq, kvh, h // kvh, dh)
    logits = _einsum("blkgd,bskd->bkgls", q, k).float()
    logits = logits * dh ** -0.5
    logits = _softcap(cfg, logits)
    logits = torch.where(mask[:, :, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgls,bskd->blkgd", probs, v)
    return out.reshape(b, lq, h, dh)


# ---------------------------------------------------------------------------
# dense KV cache: prefill and single-token decode
# ---------------------------------------------------------------------------
def init_attn_cache(cfg: ModelConfig, batch, max_seq, dtype, device,
                    lead=()):
    """``lead + (batch, max_seq, KV, Dh)`` zero k/v caches."""
    shape = tuple(lead) + (batch, max_seq, cfg.num_kv_heads,
                           cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attention_prefill(p, cfg: ModelConfig, x, window: int, theta: float,
                      causal: bool = True):
    """Prefill self-attention over a whole prompt at positions 0..L-1:
    causal (bidirectional with ``causal=False``: the encoder's layers),
    plus the sliding window when ``window > 0``.  x: (B, L, D).
    Returns (out (B, L, D), {"k", "v"}): the post-RoPE k and v at KV heads,
    (B, L, KV, Dh), the populated decode cache, as the reference's
    ``collect_cache`` branch.

    The attention is ``kernels.ops.flash_attention`` on the (B, H, L, Dh)
    views of the model's (B, L, H, Dh) tensors: the kernel reads them in
    place and reads kv head h // G for query head h, so nothing is copied
    or repeated.  The kernel has no softcap: a config that sets one
    raises."""
    if cfg.attn_logit_softcap:
        raise ValueError(
            f"prefill attention runs the flash kernel, which has no logit "
            f"softcap; {cfg.name} sets attn_logit_softcap="
            f"{cfg.attn_logit_softcap}")
    b, lq = x.shape[:2]
    positions = torch.arange(lq, dtype=torch.int32,
                             device=x.device).expand(b, lq)
    q, k, v = _qkv(p, cfg, x)
    q = rope(q, positions, theta)
    k = rope(k, positions, theta)
    v = v.contiguous()
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal, window=window)
    out = torch.einsum("blhk,hkd->bld", out.transpose(1, 2), p["wo"])
    return out, {"k": k, "v": v}


def cross_attention(p, cfg: ModelConfig, x, memory, kernel: bool):
    """Cross attention of x (B, Lq, D) over the encoder's ``memory`` (B, S,
    D), the reference's ``attention(..., memory=memory)``: q from x, k and
    v from the memory, no RoPE, every query sees every memory position,
    then ``wo``.  k and v are computed from the memory on every call (no
    cross-attention cache, as in the reference).

    ``kernel=True`` runs ``kernels.ops.flash_attention(..., causal=False)``
    on the (B, H, L, Dh) views: one launch a call (a head block) on CUDA
    tensors, for any Lq, the plain version on CPU tensors; PV stays in
    f32 and there is no softcap (a config that sets one raises).
    ``kernel=False`` runs ``_sdpa`` with an all-ones mask, the reference's
    path, which autograd differentiates.  The caller picks: serving the
    kernel, the loss not.  Either takes attention's TP branches
    (``_heads_combined``): this rank's heads and one all-sum under a
    ``tp_context``, the blocked form at ``cfg.tp_degree`` T > 1."""
    if kernel and cfg.attn_logit_softcap:
        raise ValueError(
            f"cross attention runs the flash kernel, which has no logit "
            f"softcap; {cfg.name} sets attn_logit_softcap="
            f"{cfg.attn_logit_softcap}")

    def head_block(p_):
        q, k, v = _qkv(p_, cfg, x, memory)
        if not kernel:
            mask = torch.ones((1, 1, x.shape[1], memory.shape[1]),
                              dtype=torch.bool, device=x.device)
            out = _sdpa(cfg, q, k, v, mask)
        else:
            # einsum may hand back permuted strides: the kernel reads rows
            # of the (B, L, H, Dh) layout
            out = ops.flash_attention(
                q.contiguous().transpose(1, 2),
                k.contiguous().transpose(1, 2),
                v.contiguous().transpose(1, 2), causal=False).transpose(1, 2)
        return torch.einsum("blhk,hkd->bld", out, p_["wo"])

    return _heads_combined(p, cfg, head_block)


def attention_decode(p, cfg: ModelConfig, x, pos, window: int, theta: float,
                     cache):
    """Single-token decode against a dense (B, S, KV, Dh) cache, written
    IN PLACE at ``pos`` before attending (write-then-attend).  x: (B, 1, D);
    pos: a Python int, every row at that position (``greedy_generate``),
    or a (B,) int tensor of ragged positions (``DecodeEngine``).

    An out-of-range write lands on position S - 1: the reference clamps a
    scalar position the same way (``dynamic_update_slice``) and drops a
    ragged one.  Only an idle engine slot makes such a write, into its
    own row, and a request admitted there rewrites every position before
    it reads it."""
    q, k, v = _qkv(p, cfg, x)
    b = x.shape[0]
    s = cache["k"].shape[1]
    ragged = isinstance(pos, torch.Tensor)
    if ragged:
        pos_b = pos.long()[:, None]
    else:
        pos_b = torch.full((b, 1), int(pos), dtype=torch.long,
                           device=x.device)
    q = rope(q, pos_b, theta)
    k = rope(k, pos_b, theta)
    dt = cache["k"].dtype
    if ragged:
        rows = torch.arange(b, device=x.device)
        at = pos.long().clamp_max(s - 1)
        cache["k"].index_put_((rows, at), k[:, 0].to(dt))
        cache["v"].index_put_((rows, at), v[:, 0].to(dt))
        p_ = pos.long()[:, None, None]                      # (B, 1, 1)
    else:
        at = min(int(pos), s - 1)
        cache["k"][:, at] = k[:, 0].to(dt)
        cache["v"][:, at] = v[:, 0].to(dt)
        p_ = int(pos)
    j = torch.arange(s, device=x.device)[None, None, :]     # (1, 1, S)
    w = INT32_MAX if window == FULL_ATTENTION else window
    mask = (j <= p_) & (p_ - j < w)                         # (B|1, 1, S)
    out = _sdpa_decode(cfg, q, cache["k"], cache["v"], mask[:, None])
    return _einsum("blhk,hkd->bld", out, p["wo"])


# ---------------------------------------------------------------------------
# paged attention (serving tier — block KV cache, DESIGN.md §10)
# ---------------------------------------------------------------------------
def init_paged_attn_cache(cfg: ModelConfig, num_pages, page_size, dtype,
                          device, lead=()):
    """``lead + (num_pages, page_size, KV, Dh)`` k/v page pools; page 0 is
    the reserved trash page.  int8 pools add per-token-per-head f32
    scales."""
    kv, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    shape = tuple(lead) + (num_pages, page_size, kv, dh)
    c = {"k_pages": torch.zeros(shape, dtype=dtype, device=device),
         "v_pages": torch.zeros(shape, dtype=dtype, device=device)}
    if dtype == torch.int8:
        c["k_scale"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                   device=device)
        c["v_scale"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                   device=device)
    return c


def _quant_kv_int8(x):
    """Per-token-per-head symmetric int8: x (..., Dh) → (int8, f32 scale)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = amax.clamp_min(1e-8) / 127.0
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def _paged_write(cache, block_tables, positions, k, v):
    """Scatter a chunk's KV (B, C, KV, Dh) into the pages IN PLACE.
    positions: (B, C) int with -1 ⇒ pad/idle.  Every pad write goes to
    (trash page 0, offset 0): the duplicate indices are harmless only
    because no live table references that page."""
    bs = cache["k_pages"].shape[1]
    rows = torch.arange(positions.shape[0], device=positions.device)[:, None]
    valid = positions >= 0
    pc = positions.clamp_min(0).long()
    zero = torch.zeros((), dtype=torch.long, device=positions.device)
    blk = torch.where(valid, block_tables[rows, pc // bs].long(), zero)
    off = torch.where(valid, pc % bs, zero)
    if cache["k_pages"].dtype == torch.int8:
        kq, ksc = _quant_kv_int8(k)
        vq, vsc = _quant_kv_int8(v)
        cache["k_pages"].index_put_((blk, off), kq)
        cache["v_pages"].index_put_((blk, off), vq)
        cache["k_scale"].index_put_((blk, off), ksc)
        cache["v_scale"].index_put_((blk, off), vsc)
    else:
        dt = cache["k_pages"].dtype
        cache["k_pages"].index_put_((blk, off), k.to(dt))
        cache["v_pages"].index_put_((blk, off), v.to(dt))


def _paged_gather(cache, block_tables, dtype):
    """Dense (B, MB·page_size, KV, Dh) view of each sequence's pages;
    f32/bf16 pages keep their stored dtype, int8 pages dequantize into
    ``dtype``."""
    bt = block_tables.long()
    ks = cache["k_pages"][bt]  # (B, MB, bs, KV, Dh)
    vs = cache["v_pages"][bt]
    if cache["k_pages"].dtype == torch.int8:
        ks = (ks.float() * cache["k_scale"][bt][..., None]).to(dtype)
        vs = (vs.float() * cache["v_scale"][bt][..., None]).to(dtype)
    b = bt.shape[0]
    kv, dh = ks.shape[-2:]
    return ks.reshape(b, -1, kv, dh), vs.reshape(b, -1, kv, dh)


def attention_paged(p, cfg: ModelConfig, x, positions, window, theta,
                    cache, block_tables):
    """Attention over a paged KV cache — decode (C=1) and chunked prefill
    (C>1) through one code path, write-then-attend.

    x: (B, C, D); positions: (B, C) int32 (-1 ⇒ pad/idle: the KV write
    goes to trash page 0 and the output row is garbage, which callers
    mask); window: this layer's window (``FULL_ATTENTION`` = -1 is full);
    block_tables: (B, pages_per_seq) int32.  Updates ``cache`` in place.
    """
    q, k, v = _qkv(p, cfg, x)
    b, c = x.shape[0], x.shape[1]
    pc = positions.clamp_min(0)
    q = rope(q, pc, theta)
    k = rope(k, pc, theta)
    _paged_write(cache, block_tables, positions, k, v)

    h, dh = q.shape[2], q.shape[3]
    kvh = cfg.num_kv_heads
    if c == 1 and cache["k_pages"].dtype != torch.int8:
        # grouped (kv, g) order: query head i reads kv head i // G
        qg = q[:, 0].reshape(b, kvh, h // kvh, dh)
        ctx = (pc[:, 0] + 1).to(torch.int32)
        out = ops.paged_attention(
            qg, cache["k_pages"], cache["v_pages"], block_tables, ctx,
            window=window, softcap=cfg.attn_logit_softcap)
        out = out.reshape(b, 1, h, dh)
    else:
        ks, vs = _paged_gather(cache, block_tables, x.dtype)
        s = ks.shape[1]
        i = pc[:, :, None].long()                              # (B, C, 1)
        j = torch.arange(s, device=x.device)[None, None, :]    # (1, 1, S)
        w = INT32_MAX if window == FULL_ATTENTION else window
        mask = (j <= i) & (i - j < w)                          # (B, C, S)
        out = _sdpa_decode(cfg, q, ks, vs, mask[:, None])
    return _einsum("blhk,hkd->bld", out, p["wo"])


# ---------------------------------------------------------------------------
# dense MLP (SwiGLU)
# ---------------------------------------------------------------------------
def init_mlp(gen, cfg: ModelConfig, dtype, device, lead=(), d_ff=None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "w_gate": dense_init(gen, (d, f), dtype, device, lead=lead),
        "w_up": dense_init(gen, (d, f), dtype, device, lead=lead),
        "w_down": dense_init(gen, (f, d), dtype, device, lead=lead),
    }


def _act(name):
    # jax.nn.gelu defaults to the tanh approximation
    return {"silu": F.silu,
            "gelu": lambda t: F.gelu(t, approximate="tanh"),
            "relu": F.relu}[name]


def mlp(p, cfg: ModelConfig, x, replicated: bool = False):
    """SwiGLU.  Under a ``tp_context`` this rank's d_ff columns and one
    all-sum, unless ``replicated`` (weights whole on every rank: the
    MoE's shared experts), which runs the single path; with
    ``cfg.tp_degree`` T > 1 and no context the blocked form, when T
    divides d_ff (a width that does not divide stays whole)."""
    def ffn_block(wg, wu, wd):
        return (_act(cfg.act)(x @ wg) * (x @ wu)) @ wd

    tp = current_tp()
    if tp is not None:
        out = ffn_block(p["w_gate"], p["w_up"], p["w_down"])
        return out if replicated else tp.all_sum(out)
    t = cfg.tp_degree
    f = p["w_down"].shape[0]
    if t == 1 or f % t:
        return ffn_block(p["w_gate"], p["w_up"], p["w_down"])
    blk = f // t
    parts = [ffn_block(p["w_gate"][:, i * blk:(i + 1) * blk].contiguous(),
                       p["w_up"][:, i * blk:(i + 1) * blk].contiguous(),
                       p["w_down"][i * blk:(i + 1) * blk].contiguous())
             for i in range(t)]
    return torch.stack(parts).sum(0)


# ---------------------------------------------------------------------------
# Mixture of Experts: capacity-based scatter/gather dispatch
# ---------------------------------------------------------------------------
def init_moe(gen, cfg: ModelConfig, dtype, device, lead=()):
    """``router`` (D, E) over the active experts; ``w_gate``/``w_up``
    (E_pad, D, F) and ``w_down`` (E_pad, F, D) over the padded experts
    (the dummies are never routed), each scaled by its fan-in D or F and
    drawn a layer at a time; ``shared`` an MLP of ``num_shared_experts``
    times the expert width, where the config has shared experts."""
    d, f, e = cfg.d_model, cfg.expert_d_ff, cfg.num_experts_padded

    def expert(shape):
        return dense_init(gen, shape, dtype, device, lead=lead, in_axis=1,
                          by_row=True)

    p = {"router": dense_init(gen, (d, cfg.num_experts), dtype, device,
                              lead=lead),
         "w_gate": expert((e, d, f)), "w_up": expert((e, d, f)),
         "w_down": expert((e, f, d))}
    if cfg.num_shared_experts:
        p["shared"] = init_mlp(gen, cfg, dtype, device, lead,
                               d_ff=cfg.num_shared_experts * f)
    return p


def _route(p, cfg: ModelConfig, xt, e_pad, cap):
    """xt (T, D) → (flat_idx, slot, keep, flat_gate, aux), each of the
    first four over the T·k (token, rank) rows in token-major order.

    The router logits are formed in xt's dtype and the softmax, gates and
    aux in f32.  The top k are the first k of a stable descending sort:
    ``lax.top_k``'s order, the lowest expert first on a tie.  A row's slot
    is its position among the rows routed to the same expert before it;
    a row at or past ``cap`` is dropped (``keep`` false) and parked in the
    dump slot ``cap``.  Nothing here synchronises with the host."""
    t = xt.shape[0]
    e, k = cfg.num_experts, cfg.top_k
    logits = (xt @ p["router"]).float()  # (T, E) active experts
    probs = torch.softmax(logits, dim=-1)
    top, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, idx = top[:, :k], order[:, :k]  # (T, k), idx < E <= E_pad
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    onehot = F.one_hot(idx, e_pad).float()  # (T, k, E_pad), no gradient
    f_e = onehot[..., :e].sum(dim=1).mean(dim=0)
    p_e = probs.mean(dim=0)
    aux = e * (f_e * p_e).sum() * cfg.router_aux_coef

    flat_idx = idx.reshape(t * k)
    flat_gate = gate_vals.reshape(t * k)
    # the (T·k, E_pad) one-hot stored expert-major, so that the cumsum runs
    # along contiguous rows (a scan down a column of T·k rows is one
    # sequential pass a column on the card); integer-valued f32, exact
    oh = onehot.reshape(t * k, e_pad).t().contiguous()
    pos_in_e = oh.cumsum(dim=1) - oh  # exclusive: same-expert rows before
    slot = (pos_in_e * oh).sum(dim=0).to(torch.int32)
    keep = slot < cap
    slot = torch.where(keep, slot, cap)  # overflow → dump slot
    return flat_idx, slot, keep, flat_gate, aux


def _expert_ffn(cfg, buf, w_gate, w_up, w_down):
    """Every expert's SwiGLU over its (cap + 1) slots: batched products of
    buf (E_pad, C, D) with the expert leaves."""
    h = _act(cfg.act)(torch.bmm(buf, w_gate))
    h = h * torch.bmm(buf, w_up)
    return torch.bmm(h, w_down)


def _moe_dense(p, cfg: ModelConfig, x):
    """Capacity dispatch on one device: each (token, rank) row is written
    to its expert's slot of an (E_pad, cap + 1, D) buffer, every expert
    runs on its whole buffer, and each row's output is gathered back,
    zeroed where capacity dropped it and weighted by its gate.  ``cap``
    comes from the shapes alone (the reference's formula, Python's
    ``round``).  x: (B, L, D) → (out, aux)."""
    b, l, d = x.shape
    e_pad, k = cfg.num_experts_padded, cfg.top_k
    t = b * l
    xt = x.reshape(t, d)
    cap = int(max(k, round(t * k / e_pad * cfg.capacity_factor)))
    flat_idx, slot, keep, flat_gate, aux = _route(p, cfg, xt, e_pad, cap)

    src = xt.repeat_interleave(k, dim=0) if k > 1 else xt  # (T·k, D)
    at = (flat_idx, slot.long())
    buf = x.new_zeros((e_pad, cap + 1, d)).index_put(at, src.to(x.dtype))
    out_buf = _expert_ffn(cfg, buf, p["w_gate"], p["w_up"], p["w_down"])

    gathered = out_buf[at]  # (T·k, D)
    # a select, not a product: an inf in the dump slot must not give NaN
    gathered = torch.where(keep[:, None], gathered, 0.0)
    combined = (gathered * flat_gate[:, None].to(gathered.dtype)) \
        .reshape(t, k, d).sum(dim=1)
    return combined.reshape(b, l, d), aux


def _moe_ep(p, cfg: ModelConfig, x, mesh):
    """Expert-parallel MoE, one model rank's part (the reference's
    ``shard_map`` body over "model"): x (b, L, D) is this rank's batch
    rows, the same on every model rank.  The rank routes its 1/ep slice
    of the tokens with capacity ``cap = ceil8(max(k, round(t_slice · k /
    E_pad · cf)))``, fills the dispatch buffer without its dump slot, an
    all-to-all sends each expert's slots to the rank that holds it
    ((E_loc, ep·cap, D)), the rank's experts run, an all-to-all brings
    the outputs back, and the combined slice is all-gathered over
    "model"; the aux is pmeaned over "model".  The banks are this rank's
    E_loc experts, or whole banks, of which it takes its rows."""
    b, l, d = x.shape
    e_pad, k = cfg.num_experts_padded, cfg.top_k
    comm = mesh.shared_comm("model")
    ep, r = comm.size, comm.rank
    t_loc = b * l
    t_slice = t_loc // ep
    e_loc = e_pad // ep
    cap = int(max(k, round(t_slice * k / e_pad * cfg.capacity_factor)))
    cap = -(-cap // 8) * 8  # tile-align
    wg, wu, wd = p["w_gate"], p["w_up"], p["w_down"]
    if wg.shape[0] == e_pad:
        wg, wu, wd = (w[r * e_loc:(r + 1) * e_loc] for w in (wg, wu, wd))
    xt = x.reshape(t_loc, d)[r * t_slice:(r + 1) * t_slice]
    flat_idx, slot, keep, flat_gate, aux = _route(
        {"router": p["router"]}, cfg, xt, e_pad, cap)
    src = xt.repeat_interleave(k, dim=0) if k > 1 else xt
    at = (flat_idx, slot.long())
    buf = x.new_zeros((e_pad, cap + 1, d)).index_put(at, src.to(x.dtype))
    buf = buf[:, :cap]  # the dump slot stays off the wire
    recv = all_to_all(buf, comm, 0, 1)  # (E_loc, ep·cap, D)
    out_loc = _expert_ffn(cfg, recv, wg, wu, wd)
    back = all_to_all(out_loc, comm, 1, 0)  # (E_pad, cap, D)
    back = torch.cat([back, back.new_zeros((e_pad, 1, d))], dim=1)
    gathered = torch.where(keep[:, None], back[at], 0.0)
    combined = (gathered * flat_gate[:, None].to(gathered.dtype)) \
        .reshape(t_slice, k, d).sum(dim=1)
    combined = all_gather(combined, comm, 0)  # every slice, rank order
    return combined.reshape(b, l, d), pmean(aux, comm)


def _axsize(mesh, name):
    return 1 if mesh is None else mesh.sizes.get(name, 1)


def _global_tokens(mesh, x):
    """The token count of the reference's global x: a rank's rows times
    the ranks of the batch axes, times L.  The reference's
    ``_fit_batch_axes`` picks the batch axes that divide its global batch;
    the port's ranks split the batch over every batch axis by
    construction, so each of them counts."""
    n = 1
    for a in BATCH_AXES:
        n *= _axsize(mesh, a)
    return x.shape[0] * n * x.shape[1]


def moe(p, cfg: ModelConfig, x):
    """x: (B, L, D) → (out, aux loss): ``_moe_ep`` under a current mesh
    whose "model" axis divides the padded experts, with 4096 global
    tokens or more (and this rank's tokens divisible by the axis), else
    the one-device capacity dispatch ``_moe_dense`` (the banks
    all-gathered over "model" first where they are split); plus the
    shared experts' MLP, replicated, where the layer has one.

    Under a ``cp_context`` x is this rank's chunk: the routed experts run
    on the data rank's whole rows (x all-gathered over "model", the rule
    read on them) and the output is narrowed back to the chunk; the
    shared experts run on the chunk (``context_parallel.py``)."""
    mesh = current_mesh()
    cp = current_cp()
    xr = x if cp is None else cp.gather_seq(x)
    e_pad = cfg.num_experts_padded
    ep = _axsize(mesh, "model")
    b, l = xr.shape[:2]
    if (ep > 1 and e_pad % ep == 0 and (b * l) % ep == 0
            and _global_tokens(mesh, xr) >= 4096):
        out, aux = _moe_ep(p, cfg, xr, mesh)
    else:
        if p["w_gate"].shape[0] != e_pad:  # banks split over "model"
            comm = mesh.shared_comm("model")
            p = dict(p, **{n: all_gather(p[n], comm, 0)
                           for n in ("w_gate", "w_up", "w_down")})
        out, aux = _moe_dense(p, cfg, xr)
    if cp is not None:
        out = cp.chunk(out)
    if "shared" in p:
        out = out + mlp(p["shared"], cfg, x, replicated=True)
    return out, aux
