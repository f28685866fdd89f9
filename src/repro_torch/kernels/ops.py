"""Dispatch to the kernels by the device of the tensors they are given.

A CUDA tensor goes to the hand-written kernel (which raises on what it does
not take); a CPU tensor goes to the kernel's plain PyTorch version.  There
is no switch and no fallback: the device decides.  Counterpart of
``repro/kernels/ops.py``, whose ``default_interpret`` policy has no
equivalent here.
"""

from __future__ import annotations

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import fused_adam as _adam
from repro_torch.kernels import mamba_scan as _mamba
from repro_torch.kernels import onebit_quant as _onebit
from repro_torch.kernels import paged_attention as _paged
from repro_torch.kernels import topk_sparsify as _topk


def _pick(name, x, kernel, plain):
    if x.device.type == "cuda":
        return kernel
    if x.device.type == "cpu":
        return plain
    raise ValueError(f"{name}: no kernel for device {x.device}")


def paged_attention(q, k_pages, v_pages, block_tables, ctx_lens, *,
                    window=None, softcap=None):
    fn = _pick("paged_attention", q, _paged.paged_attention,
               _paged.paged_attention_plain)
    return fn(q, k_pages, v_pages, block_tables, ctx_lens, window=window,
              softcap=softcap)


def flash_attention(q, k, v, *, causal=True, window=-1):
    fn = _pick("flash_attention", q, _flash.flash_attention,
               _flash.flash_attention_plain)
    return fn(q, k, v, causal=causal, window=window)


def mamba_scan(u, delta, a, b, c, d_skip):
    fn = _pick("mamba_scan", u, _mamba.mamba_scan, _mamba.mamba_scan_plain)
    return fn(u, delta, a, b, c, d_skip)


def mamba_scan_bwd(u, delta, a, b, c, d_skip, dy):
    fn = _pick("mamba_scan_bwd", u, _mamba.mamba_scan_bwd,
               _mamba.mamba_scan_bwd_plain)
    return fn(u, delta, a, b, c, d_skip, dy)


def onebit_quant_packed(g, r):
    fn = _pick("onebit_quant_packed", g, _onebit.onebit_quant_packed,
               _onebit.onebit_quant_packed_plain)
    return fn(g, r)


def onebit_quant(g, r):
    fn = _pick("onebit_quant", g, _onebit.onebit_quant,
               _onebit.onebit_quant_plain)
    return fn(g, r)


def topk_sparsify(x, k):
    fn = _pick("topk_sparsify", x, _topk.topk_sparsify,
               _topk.topk_sparsify_plain)
    return fn(x, k)


def topk_encode_ef(g, r, k):
    fn = _pick("topk_encode_ef", g, _topk.topk_encode_ef,
               _topk.topk_encode_ef_plain)
    return fn(g, r, k)


def fused_adam(p, g, m, v, consts, *, b1=0.9, b2=0.999, eps=1e-8):
    fn = _pick("fused_adam", p, _adam.fused_adam, _adam.fused_adam_plain)
    return fn(p, g, m, v, consts, b1=b1, b2=b2, eps=eps)
