"""State-space and recurrent mixers: Mamba (selective SSM) and xLSTM's
mLSTM and sLSTM blocks.

Port of ``repro/models/ssm.py``.  Parameters keep the reference's tree
layout and every layer is a plain function over a parameter dict.

Precision contract, as in the reference: every carried state is f32
whatever the compute dtype (the Mamba discretisation and scan, the mLSTM
(C, n, m) memory and its log-space stabilisers, the sLSTM cell state);
only the projections in and out run in the compute dtype.  Decode caches
keep their recurrent leaves f32 even when the cache dtype is bf16
(``init_*_cache`` takes the narrow dtype for the conv state only).

Every layer trains: the full-sequence branches are differentiable, as in
the reference, whose ``forward`` runs them under ``jax.grad``.  mLSTM's
parallel form and sLSTM's loop are plain tensor code that autograd
differentiates (the sLSTM loop launches its ~40 small kernels a step in
both directions, where the reference runs ``lax.scan``).

Differences from the reference:
  * Mamba's full-sequence scan is ``kernels.ops.mamba_scan``: on a CUDA
    tensor the hand-written kernel (one launch per Mamba layer), on a CPU
    tensor its plain version.  It goes through
    ``kernels.mamba_scan.MambaScan``, whose backward is the hand-written
    ``mamba_scan_bwd`` kernel on the card (one launch per Mamba layer a
    backward pass) and its plain version on the CPU; without a graph
    (serving) it records and saves nothing.  The reference sums the
    recurrence with a chunked associative scan (``_selective_scan_chunk``,
    ``ssm_chunk`` steps a chunk) and differentiates that; the port sums it
    step by step.  The kernel forms
    ``delta * u`` in f32, where the reference's model forms it in the
    compute dtype before its f32 cast: the same in f32, within bf16
    rounding in a bf16 model.  The single-token decode update keeps the
    reference's order, ``delta * u`` in the compute dtype.
  * the decode branches update the layer's cache slice IN PLACE (and
    return it) instead of returning a new cache.

Tensor parallelism (``models/tensor_parallel.py``): the training branch
of Mamba (the ``d_in`` channels in T blocks, combined twice: the x_proj
partial before dt, B and C are sliced out, and the out_proj partial) and
of mLSTM (the heads in T blocks, combined twice: the out-norm's sum of
squares and the out_proj partial) takes one of three branches, as
attention and the MLP do: under a ``tp_context`` this rank's block and
one all-sum a combine; with ``cfg.tp_degree = T > 1`` and no context the
blocked form, the T blocks' subgraphs stack-summed at each combine (a TP
forward is bitwise it); otherwise the single path, which
``cfg.tp_degree == 1`` keeps bit for bit.  The reference has neither
form (its explicit-TP module covers attention and the MLP; pjit places
the rest), so the blocked forms are held to its unsharded forward.  The
sLSTM runs whole on every model rank (its leaves are replicated), and
prefill and decode keep the single path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.mamba_scan import MambaScan
from repro_torch.models.layers import dense_init, rms_norm
from repro_torch.models.tensor_parallel import current_tp

NEG_INF = -2.0e38


def _full(shape, fill, dtype, device, lead):
    return torch.full(tuple(lead) + tuple(shape), fill, dtype=dtype,
                      device=device)


# ===========================================================================
# Mamba (S6) block
# ===========================================================================
def init_mamba(gen, cfg: ModelConfig, dtype, device, lead=()):
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    n = cfg.ssm_state_dim
    kconv = cfg.ssm_conv_dim
    dt_rank = max(1, d // 16)
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                   device=device)).expand(d_in, n)
    return {
        "in_proj": dense_init(gen, (d, 2 * d_in), dtype, device, lead),
        "conv_w": dense_init(gen, (kconv, d_in), dtype, device, lead),
        "conv_b": _full((d_in,), 0.0, dtype, device, lead),
        "x_proj": dense_init(gen, (d_in, dt_rank + 2 * n), dtype, device,
                             lead),
        "dt_proj": dense_init(gen, (dt_rank, d_in), dtype, device, lead),
        "dt_bias": _full((d_in,), 0.0, dtype, device, lead),
        "A_log": a_log.to(dtype).expand(tuple(lead) + (d_in, n))
        .contiguous(),
        "D": _full((d_in,), 1.0, dtype, device, lead),
        "out_proj": dense_init(gen, (d_in, d), dtype, device, lead),
    }


def _mamba_bcdt(p, cfg, u):
    """u: (..., d_in) → (delta, B, C) of shapes (..., d_in), (..., N),
    (..., N); B and C are slices of one projection."""
    n = cfg.ssm_state_dim
    dbl = u @ p["x_proj"]  # (..., dt_rank + 2N)
    dt_rank = dbl.shape[-1] - 2 * n
    dt, b, c = (dbl[..., :dt_rank], dbl[..., dt_rank:dt_rank + n],
                dbl[..., dt_rank + n:])
    delta = F.softplus(dt @ p["dt_proj"] + p["dt_bias"])  # (..., d_in)
    return delta, b, c


def _causal_conv(p, u, conv_state=None):
    """Depthwise causal conv over time.  u: (B, L, d_in).  Returns
    (silu(conv + bias), the last k - 1 inputs)."""
    k = p["conv_w"].shape[0]
    if conv_state is None:
        pad = torch.zeros((u.shape[0], k - 1, u.shape[2]), dtype=u.dtype,
                          device=u.device)
    else:
        pad = conv_state.to(u.dtype)
    full = torch.cat([pad, u], dim=1)  # (B, L + k - 1, d_in)
    l = u.shape[1]
    out = full[:, 0:l] * p["conv_w"][0]
    for i in range(1, k):
        out = out + full[:, i:i + l] * p["conv_w"][i]
    new_state = full[:, -(k - 1):] if k > 1 else None
    return F.silu(out + p["conv_b"]), new_state


def _split_blocks(cfg, width):
    """(blocks, combine) of a training branch: under a ``tp_context`` one
    block (this rank's) and its ``all_sum``; with ``cfg.tp_degree`` T > 1
    dividing ``width`` T blocks stack-summed; else None (the single
    path)."""
    tp = current_tp()
    if tp is not None:
        return 1, lambda parts: tp.all_sum(parts[0])
    t = cfg.tp_degree
    if t > 1 and width % t == 0:
        return t, lambda parts: torch.stack(parts).sum(0)
    return None, lambda parts: parts[0]


def _mamba_slice(p, i: int, t: int):
    """Channel block i of t of a Mamba param dict: what
    ``tensor_parallel.tp_rank_params`` gives rank i (``in_proj``'s block
    of each half side by side), each a contiguous copy."""
    d_in = p["in_proj"].shape[-1] // 2
    b = d_in // t
    lo, hi = i * b, (i + 1) * b
    w = p["in_proj"]
    return {"in_proj": torch.cat([w[:, lo:hi], w[:, d_in + lo:d_in + hi]],
                                 dim=1),
            "conv_w": p["conv_w"][:, lo:hi].contiguous(),
            "conv_b": p["conv_b"][lo:hi].contiguous(),
            "x_proj": p["x_proj"][lo:hi].contiguous(),
            "dt_proj": p["dt_proj"][:, lo:hi].contiguous(),
            "dt_bias": p["dt_bias"][lo:hi].contiguous(),
            "A_log": p["A_log"][lo:hi].contiguous(),
            "D": p["D"][lo:hi].contiguous(),
            "out_proj": p["out_proj"][lo:hi].contiguous()}


def _mamba_blocks(blocks, cfg, x, combine):
    """The training Mamba over channel blocks: each block's in_proj, conv
    and x_proj partial, ONE combine of the partials, then each block's
    dt, scan (``MambaScan``, on the block's channels), gate and out_proj
    partial, and ONE combine of those.  One block with the identity
    combine is the single path."""
    n = cfg.ssm_state_dim
    pre = []
    for p in blocks:
        xz = x @ p["in_proj"]
        b = xz.shape[-1] // 2
        u, _ = _causal_conv(p, xz[..., :b])
        pre.append((u, xz[..., b:]))
    dbl = combine([u @ p["x_proj"] for (u, _), p in zip(pre, blocks)])
    dt_rank = dbl.shape[-1] - 2 * n
    dt, bb, cc = (dbl[..., :dt_rank], dbl[..., dt_rank:dt_rank + n],
                  dbl[..., dt_rank + n:])
    parts = []
    for (u, z), p in zip(pre, blocks):
        delta = F.softplus(dt @ p["dt_proj"] + p["dt_bias"])
        a_mat = -torch.exp(p["A_log"].float())
        y, _ = MambaScan.apply(u, delta, a_mat, bb, cc, p["D"])
        parts.append((y.to(x.dtype) * F.silu(z)) @ p["out_proj"])
    return combine(parts)


def mamba(p, cfg: ModelConfig, x, cache=None, collect_cache=False):
    """x: (B, L, D) → (out, cache).  Without ``cache``: the full-sequence
    pass; the returned cache is {"conv", "ssm"} with ``collect_cache``,
    else None.  With ``cache`` ({"conv": (B, k-1, d_in), "ssm": (B, d_in,
    N) f32}, L = 1): the O(1) decode update, written into ``cache`` in
    place and returned.  The training branch (no cache, none collected)
    takes the TP or blocked form (the module docstring); ``d_in`` is the
    params' own (a TP rank's block)."""
    d_in = p["in_proj"].shape[-1] // 2
    if cache is None and not collect_cache:
        t, combine = _split_blocks(cfg, d_in)
        blocks = [p] if t in (None, 1) else [_mamba_slice(p, i, t)
                                            for i in range(t)]
        return _mamba_blocks(blocks, cfg, x, combine), None
    xz = x @ p["in_proj"]  # (B, L, 2 d_in)
    u, z = xz[..., :d_in], xz[..., d_in:]
    a_mat = -torch.exp(p["A_log"].float())  # (d_in, N)

    if cache is None:  # the prefill: the scan's final state kept
        u_pre = u  # pre-conv activations: their tail is the conv state
        u, _ = _causal_conv(p, u)
        delta, bb, cc = _mamba_bcdt(p, cfg, u)
        y, h_last = MambaScan.apply(u, delta, a_mat, bb, cc, p["D"])
        kconv = cfg.ssm_conv_dim
        conv = u_pre[:, -(kconv - 1):] if kconv > 1 else u_pre[:, :0]
        # a copy: a view would keep the whole (B, L, 2 d_in) xz alive
        new_cache = {"conv": conv.clone(), "ssm": h_last}
    else:
        u1, conv_state = _causal_conv(p, u, cache["conv"])
        delta, bb, cc = _mamba_bcdt(p, cfg, u1)
        abar = torch.exp(delta.float()[..., None] * a_mat)[:, 0]
        bu = (delta * u1).float()[..., None] * bb.float()[..., None, :]
        h = abar * cache["ssm"] + bu[:, 0]  # (B, d_in, N)
        y = torch.einsum("bdn,bn->bd", h, cc[:, 0].float())[:, None]
        y = y + p["D"].float() * u1.float()
        cache["conv"].copy_(conv_state)
        cache["ssm"].copy_(h)
        new_cache = cache

    y = y.to(x.dtype) * F.silu(z)
    return y @ p["out_proj"], new_cache


def init_mamba_cache(cfg: ModelConfig, batch, dtype, device, lead=()):
    d_in = cfg.ssm_expand * cfg.d_model
    lead = tuple(lead)
    return {
        "conv": torch.zeros(lead + (batch, cfg.ssm_conv_dim - 1, d_in),
                            dtype=dtype, device=device),
        "ssm": torch.zeros(lead + (batch, d_in, cfg.ssm_state_dim),
                           dtype=torch.float32, device=device),
    }


# ===========================================================================
# mLSTM block (xLSTM): matrix memory, exponential gating
# ===========================================================================
def init_mlstm(gen, cfg: ModelConfig, dtype, device, lead=()):
    d, h = cfg.d_model, cfg.num_heads
    dh = (cfg.ssm_expand * d) // h
    return {
        "wq": dense_init(gen, (d, h, dh), dtype, device, lead),
        "wk": dense_init(gen, (d, h, dh), dtype, device, lead),
        "wv": dense_init(gen, (d, h, dh), dtype, device, lead),
        "w_igate": dense_init(gen, (d, h), dtype, device, lead),
        "w_fgate": dense_init(gen, (d, h), dtype, device, lead),
        "fgate_bias": _full((h,), 3.0, dtype, device, lead),
        "out_norm": {"scale": _full((h * dh,), 1.0, dtype, device, lead)},
        "out_proj": dense_init(gen, (h * dh, d), dtype, device, lead),
    }


def _mlstm_slice(p, i: int, t: int):
    """Head block i of t of an mLSTM param dict: what
    ``tensor_parallel.tp_rank_params`` gives rank i, each a contiguous
    copy (``out_norm.scale`` and ``out_proj``'s rows head-major)."""
    h = p["wq"].shape[1]
    hb = h // t
    w = p["out_proj"].shape[0] // t
    heads = slice(i * hb, (i + 1) * hb)
    rows = slice(i * w, (i + 1) * w)
    return {"wq": p["wq"][:, heads].contiguous(),
            "wk": p["wk"][:, heads].contiguous(),
            "wv": p["wv"][:, heads].contiguous(),
            "w_igate": p["w_igate"][:, heads].contiguous(),
            "w_fgate": p["w_fgate"][:, heads].contiguous(),
            "fgate_bias": p["fgate_bias"][heads].contiguous(),
            "out_norm": {"scale": p["out_norm"]["scale"][rows].contiguous()},
            "out_proj": p["out_proj"][rows].contiguous()}


def _mlstm_gates(p, cfg, x):
    """(q, k, v (B, h, L, dh), log input gate, log forget gate (B, h, L)
    f32) over the params' heads (a TP rank's block)."""
    dh = (cfg.ssm_expand * x.shape[-1]) // cfg.num_heads
    q = torch.einsum("bld,dhk->bhlk", x, p["wq"]) * dh ** -0.5
    k = torch.einsum("bld,dhk->bhlk", x, p["wk"]) * dh ** -0.5
    v = torch.einsum("bld,dhk->bhlk", x, p["wv"])
    logi = (x @ p["w_igate"]).transpose(1, 2).float()  # (B, H, L)
    logf = F.logsigmoid((x @ p["w_fgate"]).transpose(1, 2).float()
                        + p["fgate_bias"].float()[None, :, None])
    return q, k, v, logi, logf


def _mlstm_parallel(q, k, v, logi, logf, collect_cache):
    """The parallel (quadratic) form: (out (B, h, L, dh) f32, the final
    state {"C", "n", "m"} with ``collect_cache`` else None)."""
    l = q.shape[2]
    # D_ij = sum_{s=j+1..i} logf_s + logi_j  (j <= i)
    cumf = torch.cumsum(logf, dim=-1)  # (B, H, L)
    dmat = cumf[..., :, None] - cumf[..., None, :] + logi[..., None, :]
    causal = torch.ones((l, l), dtype=torch.bool, device=q.device).tril()
    dmat = torch.where(causal, dmat, NEG_INF)
    m = dmat.amax(dim=-1, keepdim=True)  # (B, H, L, 1) stabiliser
    dexp = torch.exp(dmat - m)
    s = torch.einsum("bhlk,bhsk->bhls", q.float(), k.float()) * dexp
    norm = torch.maximum(s.sum(dim=-1, keepdim=True).abs(), torch.exp(-m))
    out = torch.einsum("bhls,bhsk->bhlk", s / norm, v.float())
    if not collect_cache:
        return out, None
    # d_j = sum_{s>j} logf_s + logi_j;  C_L = sum_j e^{d_j - m} v_j k_j^T
    dj = cumf[..., -1:] - cumf + logi  # (B, H, L)
    m_fin = dj.amax(dim=-1)  # (B, H)
    w = torch.exp(dj - m_fin[..., None])
    kf, vf = k.float(), v.float()
    return out, {"C": torch.einsum("bhl,bhlv,bhlk->bhvk", w, vf, kf),
                 "n": torch.einsum("bhl,bhlk->bhk", w, kf), "m": m_fin}


def _mlstm_blocks(blocks, cfg, x, combine):
    """The training mLSTM over head blocks: each block's parallel form,
    ONE combine of the out-norm's per-block sums of squares (the RMS norm
    is over all H·dh), each block normalised and projected, and ONE
    combine of the out_proj partials."""
    b, l, d = x.shape
    width = (cfg.ssm_expand * d // cfg.num_heads) * cfg.num_heads
    outs = []
    for p in blocks:
        out, _ = _mlstm_parallel(*_mlstm_gates(p, cfg, x), False)
        outs.append(out.transpose(1, 2).reshape(b, l, -1).to(x.dtype)
                    .float())
    sq = combine([o.square().sum(dim=-1, keepdim=True) for o in outs])
    inv = torch.rsqrt(sq / width + cfg.norm_eps)
    return combine([
        ((o * inv).to(x.dtype) * p["out_norm"]["scale"].to(x.dtype))
        @ p["out_proj"] for o, p in zip(outs, blocks)])


def mlstm(p, cfg: ModelConfig, x, cache=None, collect_cache=False):
    """x: (B, L, D) → (out, cache).  Without ``cache``: the parallel
    (quadratic) form; with ``collect_cache`` the final state {"C", "n",
    "m"} comes from the parallel form.  With ``cache`` (L = 1): the
    recurrent form, the state updated in place and returned.  The
    training branch (no cache, none collected) takes the TP or blocked
    form (the module docstring)."""
    b, l, d = x.shape
    h = p["wq"].shape[1]
    dh = (cfg.ssm_expand * d) // cfg.num_heads
    if cache is None and not collect_cache:
        t, combine = _split_blocks(cfg, h)
        if t is not None:
            blocks = [p] if t == 1 else [_mlstm_slice(p, i, t)
                                         for i in range(t)]
            return _mlstm_blocks(blocks, cfg, x, combine), None
    q, k, v, logi, logf = _mlstm_gates(p, cfg, x)

    if cache is None:
        out, new_cache = _mlstm_parallel(q, k, v, logi, logf, collect_cache)
    else:
        # C ← f C + i v kᵀ ; n ← f n + i k ; h = (Cᵀ q) / max(|n·q|, e⁻ᵐ)
        c_mat, nvec, m0 = cache["C"], cache["n"], cache["m"]
        logi0, logf0 = logi[..., 0], logf[..., 0]  # (B, H)
        m1 = torch.maximum(logf0 + m0, logi0)
        fp = torch.exp(logf0 + m0 - m1)[..., None]
        ip = torch.exp(logi0 - m1)[..., None]
        k0, v0, q0 = (t[:, :, 0].float() for t in (k, v, q))
        c_new = fp[..., None] * c_mat \
            + ip[..., None] * (v0[..., :, None] * k0[..., None, :])
        n_new = fp * nvec + ip * k0
        num = torch.einsum("bhvk,bhk->bhv", c_new, q0)
        den = torch.maximum((n_new * q0).sum(dim=-1).abs(), torch.exp(-m1))
        out = (num / den[..., None])[:, :, None, :]  # (B, H, 1, dh)
        c_mat.copy_(c_new)
        nvec.copy_(n_new)
        m0.copy_(m1)
        new_cache = cache

    out = out.transpose(1, 2).reshape(b, -1, h * dh).to(x.dtype)
    return rms_norm(out, p["out_norm"], cfg.norm_eps) @ p["out_proj"], \
        new_cache


def init_mlstm_cache(cfg: ModelConfig, batch, dtype, device, lead=()):
    h = cfg.num_heads
    dh = (cfg.ssm_expand * cfg.d_model) // h
    lead = tuple(lead)

    def z(*shape):
        return torch.zeros(lead + shape, dtype=torch.float32, device=device)

    return {"C": z(batch, h, dh, dh), "n": z(batch, h, dh), "m": z(batch, h)}


# ===========================================================================
# sLSTM block (xLSTM): scalar memory, recurrent weights, sequential
# ===========================================================================
def init_slstm(gen, cfg: ModelConfig, dtype, device, lead=()):
    d, h = cfg.d_model, cfg.num_heads
    dh = d // h
    lead = tuple(lead)
    bias = torch.cat([torch.zeros(lead + (d,)), torch.full(lead + (d,), 3.0),
                      torch.zeros(lead + (2 * d,))], dim=-1)
    return {
        "W": dense_init(gen, (d, 4 * d), dtype, device, lead),  # i, f, z, o
        "R": dense_init(gen, (h, dh, 4 * dh), dtype, device, lead),
        "b": bias.to(dtype=dtype, device=device),
        "out_proj": dense_init(gen, (d, d), dtype, device, lead),
    }


def _slstm_cell(p, cfg, xw, state):
    """xw: (B, 4D) = x @ W + b; state: dict of (B, D) f32.  Returns the
    next state."""
    b = xw.shape[0]
    d, h = cfg.d_model, cfg.num_heads
    dh = d // h
    c, n, hid, m = state["c"], state["n"], state["h"], state["m"]
    rec = torch.einsum("bhk,hkj->bhj", hid.reshape(b, h, dh).float(),
                       p["R"].float()).reshape(b, 4 * d)
    g = xw.float() + rec
    gi, gf, gz, go = torch.chunk(g, 4, dim=-1)
    logf = F.logsigmoid(gf)
    m1 = torch.maximum(logf + m, gi)
    ip = torch.exp(gi - m1)
    fp = torch.exp(logf + m - m1)
    c1 = fp * c + ip * torch.tanh(gz)
    n1 = fp * n + ip
    h1 = torch.sigmoid(go) * c1 / torch.clamp_min(n1, 1.0)
    return {"c": c1, "n": n1, "h": h1, "m": m1}


def slstm(p, cfg: ModelConfig, x, cache=None, collect_cache=False):
    """x: (B, L, D) → (out, cache).  Without ``cache``: a step-by-step
    loop over L from the zero state, returning the final state with
    ``collect_cache``.  With ``cache`` (L = 1): one step, the state updated
    in place and returned."""
    b, l, d = x.shape
    xw = x @ p["W"] + p["b"]  # (B, L, 4D)
    if cache is None:
        state = init_slstm_cache(cfg, b, torch.float32, x.device)
        hs = []
        for t in range(l):
            state = _slstm_cell(p, cfg, xw[:, t], state)
            hs.append(state["h"])
        out = torch.stack(hs, dim=1).to(x.dtype)  # (B, L, D)
        new_cache = state if collect_cache else None
    else:
        st = _slstm_cell(p, cfg, xw[:, 0], cache)
        for name, t in st.items():
            cache[name].copy_(t)
        out = st["h"][:, None].to(x.dtype)
        new_cache = cache
    return out @ p["out_proj"], new_cache


def init_slstm_cache(cfg: ModelConfig, batch, dtype, device, lead=()):
    shape = tuple(lead) + (batch, cfg.d_model)
    return {name: torch.zeros(shape, dtype=torch.float32, device=device)
            for name in ("c", "n", "h", "m")}
