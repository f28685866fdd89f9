"""Decoder-only and encoder-decoder models: the training forward, the
encoder, prefill and decode over a dense cache, and the steps over a paged
KV cache.

Port of the training and serving paths of ``repro/models/transformer.py``.
Parameters keep the reference's tree layout: ``embed (V, D)``,
``final_norm``, and ``stack`` holding the super-block's layers ``"0"``,
``"1"``, ... with every leaf stacked over the ``repeat`` axis, so
``bridge.params_from_numpy`` is a pure copy.  The reference's ``lax.scan``
over that axis is a Python loop here, with each layer's window and RoPE
theta from ``cfg.layer_windows()``.  An encoder-decoder model adds
``cross_norm`` and ``cross_attn`` to every decoder layer and
``encoder = {"stack", "final_norm"}``, whose ``stack`` is ONE attention +
MLP layer's dict with every leaf stacked over ``num_encoder_layers`` (no
``"0"`` key), as the reference's ``vmap``-ed encoder init.

Which stacks run where:
  * dense-cache serving (``init_model``, ``init_cache``, ``prefill``,
    ``decode_step``) takes attention, Mamba, mLSTM and sLSTM mixers with a
    dense MLP, an MoE or no FFN: the dense and MoE models, jamba with or
    without experts and xLSTM.  A layer's cache is per mixer, as the
    reference's: attention ``{"k", "v"}``, Mamba ``{"conv", "ssm"}``,
    mLSTM ``{"C", "n", "m"}``, sLSTM ``{"c", "n", "h", "m"}``, the
    recurrent leaves f32 whatever the cache dtype;
  * the training ``forward`` takes every stack dense-cache serving
    takes: attention, Mamba (its scan through ``MambaScan``, whose
    backward is the ``mamba_scan_bwd`` kernel on the card), mLSTM and
    sLSTM mixers, with dense MLP, MoE or no FFN;
  * the paged cache takes attention-only stacks, MoE FFNs included
    (recurrent state lives per slot on the dense engine, as in the
    reference);
  * encoder-decoder stacks (any of those mixers) run ``encode`` and the
    dense-cache entry points, whose decoder layers run mixer → cross
    attention → FFN; the paged cache rejects them, as the reference's.

Cross attention (``layers.cross_attention``) runs only where a layer has
``cross_attn`` AND ``memory`` is given, the reference's condition: a
``prefill`` or ``decode_step`` of an encoder-decoder model without
``memory`` skips it, as in the reference, while ``forward`` raises.
Serving (``encode``'s default, ``prefill``, ``decode_step``) runs the
encoder's and the cross attention through the flash kernel,
``causal=False``; the training ``forward`` (and the loss's
``encode(kernel=False)``) through ``_sdpa`` with an all-ones mask, the
reference's path.  ``decode_step`` recomputes the memory's k and v on
every step (no cross-attention cache, as in the reference).  Inputs may be
``embeds`` (B, L, D) instead of tokens (the vision and audio frontends are
stubs in both packages): cast to the compute dtype and not scaled, except
that ``decode_step`` takes them as given, without a cast, as the
reference does.  ``memory`` and ``decode_step``'s ``embeds`` must be in
the compute dtype (``encode`` returns it): torch's einsum does not promote
a mixed pair, where ``jnp.einsum`` would.

An MoE layer routes every token its step is given, pad rows and idle
slots included, so capacity is shared over the same token set as in the
reference and the same real tokens are dropped.

The step functions expect parameters already in ``cfg.compute_dtype``
(``cast_compute``): the reference casts on every call inside ``jit``, the
port casts once when the engine is built.  The numerics are the same.

Public API:
    init_model(gen, cfg, device)                          → params
    forward(params, cfg, tokens=None, positions=None, remat=False,
            embeds=None, memory=None)                     → (logits, aux)
    encode(params, cfg, embeds=None, tokens=None, kernel=True) → memory
    init_paged_cache(cfg, num_pages, page_size, dtype, device) → cache
    decode_step_paged(params, cfg, token, pos, cache, block_tables) → logits
    prefill_chunk_paged(params, cfg, tokens, positions, cache, block_tables,
                        last_idx)                           → logits
    init_cache(cfg, batch, max_seq, dtype, device)        → cache
    prefill(params, cfg, tokens=None, last_only=False, embeds=None,
            memory=None)                                  → (logits, cache)
    pad_prefill_cache(cfg, cache, total)                  → cache
    decode_step(params, cfg, token, pos, cache, memory=None,
                embeds=None)                              → logits
The step functions update ``cache`` in place and return f32 logits; the
reference returns a new cache instead.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import FULL_ATTENTION, LayerSpec, ModelConfig
from repro_torch.core.precision import torch_dtype
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.context_parallel import check_cp, current_cp

# the recurrent mixers: parameter init, layer, layer-cache init
_RECURRENT = {
    "mamba": {"init": S.init_mamba, "layer": S.mamba,
              "cache": S.init_mamba_cache},
    "mlstm": {"init": S.init_mlstm, "layer": S.mlstm,
              "cache": S.init_mlstm_cache},
    "slstm": {"init": S.init_slstm, "layer": S.slstm,
              "cache": S.init_slstm_cache},
}


def _check_stack(cfg: ModelConfig, attention_only=None):
    """The layer specs, if the port runs this stack: dense MLP, MoE or no
    FFN, attention or recurrent mixers, decoder-only or encoder-decoder.
    ``attention_only`` is ``(entry point, hint)`` for an entry point that
    takes attention mixers only."""
    specs, _ = cfg.superblock()
    for spec in specs:
        if spec.ffn not in ("mlp", "moe", "none"):
            raise ValueError(f"the port has no ffn {spec.ffn!r}")
        if spec.mixer != "attn" and spec.mixer not in _RECURRENT:
            raise ValueError(f"the port has no mixer {spec.mixer!r}")
        if spec.mixer != "attn" and attention_only:
            what, hint = attention_only
            raise ValueError(f"{what} supports attention-only stacks; got "
                             f"mixer {spec.mixer!r} ({hint})")
    return specs


def _index(tree, r):
    return {k: _index(v, r) if isinstance(v, dict) else v[r]
            for k, v in tree.items()}


# the encoder's layer, as the reference's: bidirectional attention, MLP
_ENC_SPEC = LayerSpec(mixer="attn", ffn="mlp")


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

    def layer(spec, lead, cross):  # the reference's _init_layer
        p = {"pre_norm": norm(lead + (cfg.d_model,))}
        if spec.mixer == "attn":
            p["attn"] = L.init_attention(gen, cfg, pdt, dev, lead)
        else:
            p[spec.mixer] = _RECURRENT[spec.mixer]["init"](gen, cfg, pdt,
                                                           dev, lead)
        if cross:
            p["cross_norm"] = norm(lead + (cfg.d_model,))
            p["cross_attn"] = L.init_attention(gen, cfg, pdt, dev, lead)
        if spec.ffn != "none":
            p["ffn_norm"] = norm(lead + (cfg.d_model,))
            if spec.ffn == "moe":
                p["moe"] = L.init_moe(gen, cfg, pdt, dev, lead)
            else:
                p["mlp"] = L.init_mlp(gen, cfg, pdt, dev, lead)
        return p

    stack = {str(i): layer(spec, lead, cfg.is_encoder_decoder)
             for i, spec in enumerate(specs)}
    params = {
        "embed": L.dense_init(gen, (cfg.vocab_size, cfg.d_model), pdt, dev),
        "stack": stack,
        "final_norm": norm((cfg.d_model,)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                         pdt, dev)
    if cfg.is_encoder_decoder:
        params["encoder"] = {
            "stack": layer(_ENC_SPEC, (cfg.num_encoder_layers,), False),
            "final_norm": norm((cfg.d_model,))}
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
def _run_stack(params, cfg: ModelConfig, h, attend, recur=None,
               remat: bool = False, memory=None, cross_kernel: bool = False):
    """The layer stack: pre-norm residual (mixer → [cross attention] → MLP
    or MoE) layers, the reference's ``_apply_layer`` per layer; returns
    (h, aux).  The reference's ``lax.scan`` over the repeat axis is a loop
    here.
    ``remat=True`` runs each super-block's body (one layer of a dense
    stack) under ``torch.utils.checkpoint``, where the reference wraps its
    scan body in ``jax.checkpoint``: its activations are recomputed in the
    backward pass instead of kept, with the same values.

    ``attend(p_attn, x, window, theta, key, r)`` is the attention of layer
    ``key`` of super-block ``r`` (its window and RoPE theta from
    ``cfg.layer_windows()``): the caller picks the training, prefill,
    dense-cache or paged-cache attention and the layer's cache slice.
    ``recur(mixer, p_mixer, x, key, r)`` is a recurrent mixer (``"mamba"``,
    ``"mlstm"``, ``"slstm"``) with the layer's cache slice, for the
    entry points that run them.  A layer with ffn ``"none"`` (xLSTM) has
    no MLP.  A layer with ``cross_attn`` runs ``layers.cross_attention``
    over ``memory`` (through the flash kernel with ``cross_kernel``) after
    its mixer, when ``memory`` is given, and skips it when it is not, as
    the reference does.

    ``aux`` sums, over the super-blocks, the MoE aux loss of each
    super-block's LAST layer only (0 when that layer has no MoE), as the
    reference's scan body does: it rebinds ``aux`` for every layer of the
    super-block and adds the last binding.  For the uniform MoE stacks (a
    super-block of one layer) that is every layer; for jamba's 8-layer
    super-block it is layer 7's, and layers 1, 3 and 5 add nothing."""
    specs, repeat = cfg.superblock()
    windows, thetas = cfg.layer_windows()  # (repeat, S) numpy arrays

    def superblock(h, r):
        for i, spec in enumerate(specs):
            key = str(i)
            p = _index(params["stack"][key], r)
            x = L.rms_norm(h, p["pre_norm"], cfg.norm_eps)
            if spec.mixer == "attn":
                h = h + attend(p["attn"], x, int(windows[r, i]),
                               float(thetas[r, i]), key, r)
            else:
                h = h + recur(spec.mixer, p[spec.mixer], x, key, r)
            if "cross_attn" in p and memory is not None:
                x = L.rms_norm(h, p["cross_norm"], cfg.norm_eps)
                h = h + L.cross_attention(p["cross_attn"], cfg, x, memory,
                                          cross_kernel)
            aux = None  # the layer's aux: None where it has no MoE
            if spec.ffn != "none":
                x = L.rms_norm(h, p["ffn_norm"], cfg.norm_eps)
                if spec.ffn == "moe":
                    out, aux = L.moe(p["moe"], cfg, x)
                else:
                    out = L.mlp(p["mlp"], cfg, x)
                h = h + out
        return h, aux

    aux_acc = torch.zeros((), dtype=torch.float32, device=h.device)
    for r in range(repeat):
        h, aux = (checkpoint(superblock, h, r, use_reentrant=False) if remat
                  else superblock(h, r))
        if aux is not None:
            aux_acc = aux_acc + aux
    return h, aux_acc


def _logits(params, cfg, h):
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = torch.einsum("bld,vd->blv", h, params["embed"])
    else:
        logits = torch.einsum("bld,dv->blv", h, params["lm_head"])
    return logits.float()


def _embed(params, cfg, tokens=None, embeds=None):
    """``embeds`` cast to the compute dtype, not scaled; else the tokens'
    rows of ``embed``, scaled by sqrt(d_model) under qk-norm."""
    if embeds is not None:
        return embeds.to(torch_dtype(cfg.compute_dtype))
    h = params["embed"][tokens.long()].to(torch_dtype(cfg.compute_dtype))
    if cfg.qk_norm:
        # sqrt(d_model) rounded to h's dtype first, as the reference does;
        # a 0-dim CPU tensor multiplies a CUDA tensor without a copy
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype)
    return h


def forward(params, cfg: ModelConfig, tokens=None, positions=None,
            remat: bool = False, embeds=None, memory=None):
    """Training forward pass over (B, L) tokens or (B, L, D) ``embeds``.
    Returns (logits (B, L, V) f32, aux loss): the MoE router's
    load-balancing loss as ``_run_stack`` sums it, 0 for a dense stack.
    ``remat=True`` recomputes each super-block's activations in the
    backward pass (``_run_stack``): a Mamba layer's scan kernel then runs
    twice a step.  Recurrent mixers run their full-sequence branch from
    the zero state.  An encoder-decoder model needs the
    encoder's ``memory`` (B, S, D); its cross attention runs on ``_sdpa``,
    which autograd differentiates.

    Under a ``cp_context`` (``models/context_parallel.py``) the tokens or
    embeds are the data rank's whole rows and the forward runs this model
    rank's sequence chunk at its global positions: the logits are the
    chunk's (B, L/T, V).  The ``memory`` is the whole (B, S, D) there
    too: cross attention reads every position of it."""
    _check_stack(cfg)
    cp = current_cp()
    if cp is not None:
        check_cp(cfg)
        if positions is not None:
            raise ValueError("cp: the forward places the chunk at its own "
                             "global positions")
        tokens = None if tokens is None else cp.chunk(tokens)
        embeds = None if embeds is None else cp.chunk(embeds)
    params = cast_compute(params, cfg)
    h = _embed(params, cfg, tokens, embeds)
    b, l = h.shape[:2]
    if cp is not None:
        positions = cp.positions(b, l, h.device)
    elif positions is None:
        positions = torch.arange(l, dtype=torch.int32,
                                 device=h.device).expand(b, l)
    if cfg.is_encoder_decoder and memory is None:
        raise ValueError("encoder-decoder model requires encoder `memory`")
    static = not cfg.scan_layers

    def attend(p, x, window, theta, key, r):
        return L.attention(p, cfg, x, positions, window, theta,
                           static_window=static)

    def recur(mixer, p, x, key, r):  # no cache: the full-sequence branch
        return _RECURRENT[mixer]["layer"](p, cfg, x)[0]

    h, aux = _run_stack(params, cfg, h, attend, recur, remat=remat,
                        memory=memory)
    return _logits(params, cfg, h), aux


def encode(params, cfg: ModelConfig, embeds=None, tokens=None,
           kernel: bool = True):
    """The encoder of an encoder-decoder model over (B, S, D) ``embeds``
    (or (B, S) tokens): ``num_encoder_layers`` pre-norm layers of
    bidirectional attention (no window, RoPE at ``cfg.rope_theta``,
    positions 0..S-1) and MLP, then the encoder's ``final_norm``.  Returns
    the memory (B, S, D) in the compute dtype.  ``kernel=True`` runs each
    layer's attention as one flash launch (``causal=False``) on CUDA
    tensors, its plain version on CPU tensors; ``kernel=False`` the
    reference's masked ``_sdpa``, for the loss.

    Under a ``cp_context`` (``kernel=False`` only) the source is chunked
    on its sequence axis: the layers run this rank's chunk at its global
    positions, each attention on the k/v all-gather, and the memory's
    chunk (B, S/T, D) comes back (``make_loss_fn`` gathers it)."""
    cp = current_cp()
    if cp is not None:
        if kernel:
            raise ValueError("cp: encode runs the loss's path "
                             "(kernel=False) on a rank's chunk")
        tokens = None if tokens is None else cp.chunk(tokens)
        embeds = None if embeds is None else cp.chunk(embeds)
    params = cast_compute(params, cfg)
    enc = params["encoder"]
    h = _embed(params, cfg, tokens, embeds)
    b, l = h.shape[:2]
    positions = (torch.arange(l, dtype=torch.int32,
                              device=h.device).expand(b, l) if cp is None
                 else cp.positions(b, l, h.device))
    for r in range(cfg.num_encoder_layers):
        p = _index(enc["stack"], r)
        x = L.rms_norm(h, p["pre_norm"], cfg.norm_eps)
        if kernel:
            out, _ = L.attention_prefill(p["attn"], cfg, x, FULL_ATTENTION,
                                         cfg.rope_theta, causal=False)
        else:
            out = L.attention(p["attn"], cfg, x, positions, FULL_ATTENTION,
                              cfg.rope_theta, causal=False)
        h = h + out
        x = L.rms_norm(h, p["ffn_norm"], cfg.norm_eps)
        h = h + L.mlp(p["mlp"], cfg, x)
    return L.rms_norm(h, enc["final_norm"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# paged cache and steps
# ---------------------------------------------------------------------------
def init_paged_cache(cfg: ModelConfig, num_pages, page_size, dtype=None,
                     device="cuda"):
    """Per-layer k/v page pools stacked over ``repeat``; page 0 is the
    reserved trash page.  ``dtype`` defaults to ``cfg.compute_dtype``.
    Attention-only stacks: recurrent mixers keep per-slot dense state and
    stay on the dense ``DecodeEngine``, as in the reference."""
    dev = resolve_device(device)
    if cfg.is_encoder_decoder:
        raise ValueError("paged cache does not support encoder-decoder models")
    specs = _check_stack(cfg, ("paged cache", "use the dense DecodeEngine"))
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
    h, _ = _run_stack(params, cfg, h, _paged(cfg,
                                             pos[:, None].to(torch.int32),
                                             cache, block_tables))
    return _logits(params, cfg, h)[:, 0]


def prefill_chunk_paged(params, cfg: ModelConfig, tokens, positions, cache,
                        block_tables, last_idx):
    """Chunked prefill of a (B, C) window of prompt tokens, written straight
    into the pages.  positions: (B, C) int32, -1 ⇒ pad; last_idx: (B,)
    index of each row's last real token in the chunk.  Returns the
    next-token logits at ``last_idx``, (B, V) f32."""
    h = _embed(params, cfg, tokens.clamp_min(0))
    h, _ = _run_stack(params, cfg, h, _paged(cfg, positions.to(torch.int32),
                                             cache, block_tables))
    rows = torch.arange(tokens.shape[0], device=h.device)
    hl = h[rows, last_idx.clamp_min(0).long()][:, None]
    return _logits(params, cfg, hl)[:, 0]


# ---------------------------------------------------------------------------
# dense cache: prefill and decode
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch, max_seq, dtype=None, device="cuda"):
    """Dense decode cache in the reference's stacked layout: per layer,
    attention ``{"k", "v"}`` of shape (repeat, batch, max_seq, KV, Dh), or
    the recurrent mixer's state (repeat, batch, ...).  ``dtype`` (default
    ``cfg.compute_dtype``) is that of the k/v and Mamba conv leaves; the
    recurrent states are f32."""
    dev = resolve_device(device)
    specs = _check_stack(cfg)
    _, repeat = cfg.superblock()
    dt = torch_dtype(dtype if dtype is not None else cfg.compute_dtype)

    def one(spec):  # the reference's _init_layer_cache
        if spec.mixer == "attn":
            return L.init_attn_cache(cfg, batch, max_seq, dt, dev,
                                     lead=(repeat,))
        return _RECURRENT[spec.mixer]["cache"](cfg, batch, dt, dev,
                                               lead=(repeat,))

    return {str(i): one(spec) for i, spec in enumerate(specs)}


def prefill(params, cfg: ModelConfig, tokens=None, last_only=False,
            embeds=None, memory=None):
    """Full-sequence forward over (B, L) prompt tokens or (B, L, D)
    ``embeds`` that also returns the populated decode cache (S = L for
    attention; the recurrent layers' final states), as the reference's
    ``prefill``.  On CUDA tensors each attention layer is one
    ``flash_attention`` launch, each cross attention over ``memory`` one
    more, and each Mamba layer one ``mamba_scan`` launch.  Returns (logits
    f32, (B, 1, V) with ``last_only`` else (B, L, V), cache)."""
    _check_stack(cfg)
    params = cast_compute(params, cfg)
    h = _embed(params, cfg, tokens, embeds)
    collected = {}

    def attend(p, x, window, theta, key, r):
        out, kv = L.attention_prefill(p, cfg, x, window, theta)
        collected.setdefault(key, []).append(kv)
        return out

    def recur(mixer, p, x, key, r):
        out, state = _RECURRENT[mixer]["layer"](p, cfg, x,
                                                collect_cache=True)
        collected.setdefault(key, []).append(state)
        return out

    h, _ = _run_stack(params, cfg, h, attend, recur, memory=memory,
                      cross_kernel=True)
    if last_only:
        h = h[:, -1:]
    cache = {key: {name: torch.stack([c[name] for c in per_r])
                   for name in per_r[0]}
             for key, per_r in collected.items()}
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


def decode_step(params, cfg: ModelConfig, token, pos, cache, memory=None,
                embeds=None):
    """One decode token per row against the dense cache, updated in place.
    token: (B,) int, or None with ``embeds`` (B, 1, D), taken as given
    (no cast, as the reference); pos: a Python int write position for
    every row, or a (B,) int tensor of ragged positions (continuous
    batching); recurrent layers advance their state one step whatever the
    position.  Each cross attention attends over ``memory`` (B, S, D),
    one flash launch on CUDA tensors, its k and v recomputed from the
    memory.  Expects parameters in ``cfg.compute_dtype``
    (``cast_compute``), as the paged steps.  Returns logits (B, V) f32."""
    h = embeds if embeds is not None else _embed(params, cfg, token[:, None])

    def attend(p, x, window, theta, key, r):
        return L.attention_decode(p, cfg, x, pos, window, theta,
                                  _index(cache[key], r))

    def recur(mixer, p, x, key, r):
        return _RECURRENT[mixer]["layer"](p, cfg, x,
                                          cache=_index(cache[key], r))[0]

    h, _ = _run_stack(params, cfg, h, attend, recur, memory=memory,
                      cross_kernel=True)
    return _logits(params, cfg, h)[:, 0]
