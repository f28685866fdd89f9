"""Decoder-only transformer: the training forward, prefill and decode over
a dense KV cache, and the steps over a paged KV cache.

Port of the training and serving paths of ``repro/models/transformer.py``.
Parameters keep the reference's tree layout: ``embed (V, D)``,
``final_norm``, and ``stack`` holding the super-block's layers ``"0"``,
``"1"``, ... with every leaf stacked over the ``repeat`` axis, so
``bridge.params_from_numpy`` is a pure copy.  The reference's ``lax.scan`` over that axis is a Python loop
here, with each layer's window and RoPE theta from ``cfg.layer_windows()``.

The step functions expect parameters already in ``cfg.compute_dtype``
(``cast_compute``): the reference casts on every call inside ``jit``, the
port casts once when the engine is built.  The numerics are the same.

Public API:
    init_model(gen, cfg, device)                          → params
    forward(params, cfg, tokens, positions=None)          → (logits, aux)
    init_paged_cache(cfg, num_pages, page_size, dtype, device) → cache
    decode_step_paged(params, cfg, token, pos, cache, block_tables) → logits
    prefill_chunk_paged(params, cfg, tokens, positions, cache, block_tables,
                        last_idx)                           → logits
    init_cache(cfg, batch, max_seq, dtype, device)        → cache
    prefill(params, cfg, tokens, last_only=False)         → (logits, cache)
    pad_prefill_cache(cfg, cache, total)                  → cache
    decode_step(params, cfg, token, pos, cache)           → logits
The step functions update ``cache`` in place and return f32 logits; the
reference returns a new cache instead.
"""

from __future__ import annotations

import math

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.precision import torch_dtype
from repro_torch.models import layers as L


def _check_stack(cfg: ModelConfig):
    specs, _ = cfg.superblock()
    if cfg.is_encoder_decoder:
        raise ValueError("the port serves decoder-only models; encoder-"
                         "decoder stacks are a later slice")
    for spec in specs:
        if spec.mixer != "attn" or spec.ffn != "mlp":
            raise ValueError(
                f"the port supports attention-only stacks with dense MLPs; "
                f"got mixer {spec.mixer!r}, ffn {spec.ffn!r}")
    return specs


def _index(tree, r):
    return {k: _index(v, r) if isinstance(v, dict) else v[r]
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# model init
# ---------------------------------------------------------------------------
def init_model(gen: torch.Generator, cfg: ModelConfig, device="cuda"):
    """Random parameters in ``cfg.param_dtype``, drawn from ``gen`` (a
    ``torch.Generator`` on ``device``), in the reference's tree layout."""
    dev = resolve_device(device)
    specs = _check_stack(cfg)
    _, repeat = cfg.superblock()
    pdt = torch_dtype(cfg.param_dtype)
    lead = (repeat,)

    def norm(shape):
        return {"scale": torch.ones(shape, dtype=pdt, device=dev)}

    stack = {str(i): {"pre_norm": norm(lead + (cfg.d_model,)),
                      "attn": L.init_attention(gen, cfg, pdt, dev, lead),
                      "ffn_norm": norm(lead + (cfg.d_model,)),
                      "mlp": L.init_mlp(gen, cfg, pdt, dev, lead)}
             for i in range(len(specs))}
    params = {
        "embed": L.dense_init(gen, (cfg.vocab_size, cfg.d_model), pdt, dev),
        "stack": stack,
        "final_norm": norm((cfg.d_model,)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                         pdt, dev)
    return params


def cast_compute(params, cfg: ModelConfig):
    """Floating weights → ``cfg.compute_dtype`` (identity when the param
    and compute dtypes agree)."""
    cdt = torch_dtype(cfg.compute_dtype)

    def cast(t):
        if isinstance(t, dict):
            return {k: cast(v) for k, v in t.items()}
        return t.to(cdt) if t.is_floating_point() else t

    return cast(params)


# ---------------------------------------------------------------------------
# stack traversal
# ---------------------------------------------------------------------------
def _run_stack(params, cfg: ModelConfig, h, attend):
    """The layer stack: pre-norm residual (attention → MLP) layers.  The
    reference's ``lax.scan`` over the repeat axis is a loop here; there is
    no rematerialisation (the trainer CLI runs with ``remat=False``).

    ``attend(p_attn, x, window, theta, key, r)`` is the attention of layer
    ``key`` of super-block ``r`` (its window and RoPE theta from
    ``cfg.layer_windows()``): the caller picks the training, prefill,
    dense-cache or paged-cache attention and the layer's cache slice."""
    specs, repeat = cfg.superblock()
    windows, thetas = cfg.layer_windows()  # (repeat, S) numpy arrays
    for r in range(repeat):
        for i in range(len(specs)):
            key = str(i)
            p = _index(params["stack"][key], r)
            x = L.rms_norm(h, p["pre_norm"], cfg.norm_eps)
            h = h + attend(p["attn"], x, int(windows[r, i]),
                           float(thetas[r, i]), key, r)
            x = L.rms_norm(h, p["ffn_norm"], cfg.norm_eps)
            h = h + L.mlp(p["mlp"], cfg, x)
    return h


def _logits(params, cfg, h):
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = torch.einsum("bld,vd->blv", h, params["embed"])
    else:
        logits = torch.einsum("bld,dv->blv", h, params["lm_head"])
    return logits.float()


def _embed(params, cfg, tokens):
    h = params["embed"][tokens.long()].to(torch_dtype(cfg.compute_dtype))
    if cfg.qk_norm:
        # sqrt(d_model) rounded to h's dtype first, as the reference does;
        # a 0-dim CPU tensor multiplies a CUDA tensor without a copy
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype)
    return h


def forward(params, cfg: ModelConfig, tokens, positions=None):
    """Training forward pass over (B, L) tokens.  Returns (logits (B, L, V)
    f32, aux loss); aux is 0 for the dense stacks ported so far."""
    _check_stack(cfg)
    params = cast_compute(params, cfg)
    h = _embed(params, cfg, tokens)
    b, l = h.shape[:2]
    if positions is None:
        positions = torch.arange(l, dtype=torch.int32,
                                 device=h.device).expand(b, l)
    static = not cfg.scan_layers

    def attend(p, x, window, theta, key, r):
        return L.attention(p, cfg, x, positions, window, theta,
                           static_window=static)

    h = _run_stack(params, cfg, h, attend)
    return _logits(params, cfg, h), torch.zeros((), dtype=torch.float32,
                                                device=h.device)


# ---------------------------------------------------------------------------
# paged cache and steps
# ---------------------------------------------------------------------------
def init_paged_cache(cfg: ModelConfig, num_pages, page_size, dtype=None,
                     device="cuda"):
    """Per-layer k/v page pools stacked over ``repeat``; page 0 is the
    reserved trash page.  ``dtype`` defaults to ``cfg.compute_dtype``."""
    dev = resolve_device(device)
    specs = _check_stack(cfg)
    _, repeat = cfg.superblock()
    dt = torch_dtype(dtype if dtype is not None else cfg.compute_dtype)
    return {str(i): L.init_paged_attn_cache(cfg, num_pages, page_size, dt,
                                            dev, lead=(repeat,))
            for i in range(len(specs))}


def _paged(cfg, positions, cache, block_tables):
    def attend(p, x, window, theta, key, r):
        return L.attention_paged(p, cfg, x, positions, window, theta,
                                 _index(cache[key], r), block_tables)
    return attend


def decode_step_paged(params, cfg: ModelConfig, token, pos, cache,
                      block_tables):
    """One decode token per slot.  token: (B,) int32; pos: (B,) int32 token
    position per slot, -1 ⇒ idle (the write goes to trash page 0 and the
    logits row is garbage, which the caller masks); block_tables:
    (B, pages_per_seq) int32.  Returns logits (B, V) f32."""
    h = _embed(params, cfg, token.clamp_min(0)[:, None])
    h = _run_stack(params, cfg, h, _paged(cfg, pos[:, None].to(torch.int32),
                                          cache, block_tables))
    return _logits(params, cfg, h)[:, 0]


def prefill_chunk_paged(params, cfg: ModelConfig, tokens, positions, cache,
                        block_tables, last_idx):
    """Chunked prefill of a (B, C) window of prompt tokens, written straight
    into the pages.  positions: (B, C) int32, -1 ⇒ pad; last_idx: (B,)
    index of each row's last real token in the chunk.  Returns the
    next-token logits at ``last_idx``, (B, V) f32."""
    h = _embed(params, cfg, tokens.clamp_min(0))
    h = _run_stack(params, cfg, h, _paged(cfg, positions.to(torch.int32),
                                          cache, block_tables))
    rows = torch.arange(tokens.shape[0], device=h.device)
    hl = h[rows, last_idx.clamp_min(0).long()][:, None]
    return _logits(params, cfg, hl)[:, 0]


# ---------------------------------------------------------------------------
# dense cache: prefill and decode
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch, max_seq, dtype=None, device="cuda"):
    """Dense decode cache: per layer ``{"k", "v"}`` of shape
    (repeat, batch, max_seq, KV, Dh), the reference's stacked layout.
    ``dtype`` defaults to ``cfg.compute_dtype``."""
    dev = resolve_device(device)
    specs = _check_stack(cfg)
    _, repeat = cfg.superblock()
    dt = torch_dtype(dtype if dtype is not None else cfg.compute_dtype)
    return {str(i): L.init_attn_cache(cfg, batch, max_seq, dt, dev,
                                      lead=(repeat,))
            for i in range(len(specs))}


def prefill(params, cfg: ModelConfig, tokens, last_only=False):
    """Full-sequence forward over (B, L) prompt tokens that also returns the
    populated decode cache (S = L), as the reference's ``prefill``.  Each
    layer's attention is one ``flash_attention`` launch on a CUDA tensor.
    Returns (logits f32, (B, 1, V) with ``last_only`` else (B, L, V),
    cache)."""
    _check_stack(cfg)
    params = cast_compute(params, cfg)
    h = _embed(params, cfg, tokens)
    collected = {}

    def attend(p, x, window, theta, key, r):
        out, kv = L.attention_prefill(p, cfg, x, window, theta)
        collected.setdefault(key, []).append(kv)
        return out

    h = _run_stack(params, cfg, h, attend)
    if last_only:
        h = h[:, -1:]
    cache = {key: {name: torch.stack([kv[name] for kv in kvs])
                   for name in ("k", "v")}
             for key, kvs in collected.items()}
    return _logits(params, cfg, h), cache


def pad_prefill_cache(cfg: ModelConfig, cache, total):
    """Grow a ``prefill``-collected cache (S = prompt length) to ``total``
    sequence slots with zeros.  Keyed off the layer specs, as the
    reference: only attention layers' k/v leaves are padded, along their
    sequence axis (axis 2 of the stacked (repeat, B, S, KV, Dh))."""
    specs, _ = cfg.superblock()
    out = dict(cache)
    for i, spec in enumerate(specs):
        if spec.mixer != "attn":
            continue
        out[str(i)] = {name: x if x.shape[2] >= total else
                       torch.nn.functional.pad(
                           x, (0, 0, 0, 0, 0, total - x.shape[2]))
                       for name, x in cache[str(i)].items()}
    return out


def decode_step(params, cfg: ModelConfig, token, pos, cache):
    """One decode token per row against the dense cache, updated in place.
    token: (B,) int; pos: a Python int write position for every row, or a
    (B,) int tensor of ragged positions (continuous batching).  Expects
    parameters in ``cfg.compute_dtype`` (``cast_compute``), as the paged
    steps.  Returns logits (B, V) f32."""
    h = _embed(params, cfg, token[:, None])

    def attend(p, x, window, theta, key, r):
        return L.attention_decode(p, cfg, x, pos, window, theta,
                                  _index(cache[key], r))

    h = _run_stack(params, cfg, h, attend)
    return _logits(params, cfg, h)[:, 0]
