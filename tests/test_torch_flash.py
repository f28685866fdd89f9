"""The port's flash-attention kernel module against the JAX package.

``flash_attention_plain`` (PyTorch, CPU) is held against the Pallas kernel
in interpret mode, on the shape, window and non-causal cases of
tests/test_kernels.py and on cross attention's (Lq != Lk), against the oracle ``flash_attention_ref`` on
grouped (GQA) heads, and against the model's dense attention.  Inputs are
made with numpy from a seed.  Tolerances are the JAX package's own: 2e-5
in f32 and 2e-2 in bf16.  The CUDA kernel itself runs only on a card: its
test skips here, and ``chip_smoke.py`` holds it against the plain version
on the H100.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.ref import flash_attention_ref
from repro.models.layers import _sdpa
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops

pytestmark = pytest.mark.torch

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _qkv(seed, b, h, l, d, kv=None):
    """q (B, H, L, D) and k, v (B, KV, L, D) as f32 numpy arrays."""
    rng = np.random.default_rng(seed)
    kv = h if kv is None else kv
    return (rng.standard_normal((b, h, l, d)).astype(np.float32),
            rng.standard_normal((b, kv, l, d)).astype(np.float32),
            rng.standard_normal((b, kv, l, d)).astype(np.float32))


def _jax(arrs, jdt):
    return [jnp.asarray(a, jdt) for a in arrs]


def _torch(arrs, tdt, device="cpu"):
    return [torch.from_numpy(a).to(device).to(tdt) for a in arrs]


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32), np.float32)


def _close(out, ref, tol):
    np.testing.assert_allclose(_np(out), _np(ref), atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# against the Pallas kernel in interpret mode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,h,l,d", [
    (1, 1, 128, 64), (2, 3, 256, 64), (1, 2, 300, 128), (2, 1, 64, 256),
])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_matches_interpret_kernel_shapes(b, h, l, d, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    arrs = _qkv(0, b, h, l, d)
    ref = pallas_flash(*_jax(arrs, jdt), interpret=True)
    out = fa.flash_attention_plain(*_torch(arrs, tdt))
    assert out.dtype == tdt and tuple(out.shape) == ref.shape
    _close(out, ref, tol)


@pytest.mark.parametrize("window", [32, 64, 100])
def test_plain_matches_interpret_kernel_window(window):
    arrs = _qkv(1, 1, 2, 256, 64)
    ref = pallas_flash(*_jax(arrs, jnp.float32), window=window,
                       interpret=True)
    out = fa.flash_attention_plain(*_torch(arrs, torch.float32),
                                   window=window)
    _close(out, ref, 2e-5)


def test_plain_matches_interpret_kernel_noncausal():
    arrs = _qkv(2, 1, 1, 128, 64)
    ref = pallas_flash(*_jax(arrs, jnp.float32), causal=False,
                       interpret=True)
    out = fa.flash_attention_plain(*_torch(arrs, torch.float32),
                                   causal=False)
    _close(out, ref, 2e-5)


@pytest.mark.parametrize("lq,lk", [(1, 300), (37, 300), (64, 130)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_matches_interpret_kernel_cross(lq, lk, dtype):
    """Cross attention's shapes: non-causal, Lq != Lk, a single query row
    and ragged key tails (the Pallas kernel pads the keys and masks past
    kv_len)."""
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(lq + lk)
    arrs = [rng.standard_normal((2, 4, n, 64)).astype(np.float32)
            for n in (lq, lk, lk)]
    ref = pallas_flash(*_jax(arrs, jdt), causal=False, interpret=True)
    out = fa.flash_attention_plain(*_torch(arrs, tdt), causal=False)
    assert tuple(out.shape) == (2, 4, lq, 64)
    _close(out, ref, tol)


# ---------------------------------------------------------------------------
# against the oracle: grouped heads, windows, tails
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("h,kv", [(4, 1), (10, 2), (12, 2)])
@pytest.mark.parametrize("causal,window", [(True, -1), (True, 17),
                                           (False, 9)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_gqa_matches_ref_on_repeated_heads(h, kv, causal, window,
                                                 dtype):
    """KV < H: query head i reads kv head i // (H / KV), what the
    reference computes after repeating each kv head H / KV times."""
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v = _qkv(3, 2, h, 37, 32, kv=kv)
    g = h // kv
    ref = flash_attention_ref(*_jax((q, np.repeat(k, g, 1),
                                     np.repeat(v, g, 1)), jdt),
                              causal=causal, window=window)
    out = fa.flash_attention_plain(*_torch((q, k, v), tdt), causal=causal,
                                   window=window)
    _close(out, ref, tol)


def test_plain_single_token_and_window_of_one():
    for l, window in ((1, -1), (5, 1)):
        arrs = _qkv(4, 1, 2, l, 64)
        ref = flash_attention_ref(*_jax(arrs, jnp.float32), window=window)
        out = fa.flash_attention_plain(*_torch(arrs, torch.float32),
                                       window=window)
        _close(out, ref, 2e-5)
    # window 1 sees only the diagonal: the output is v itself
    np.testing.assert_allclose(_np(out), arrs[2], atol=1e-6)


def test_plain_fully_masked_rows_are_zero():
    """Lq > Lk under the causal window: rows that see no key give 0, as
    the kernel's max(l, 1e-30) denominator does, not NaN."""
    q = torch.from_numpy(_qkv(5, 1, 1, 8, 32)[0])
    k, v = (torch.from_numpy(a[:, :, :3]) for a in _qkv(6, 1, 1, 8, 32)[1:])
    out = fa.flash_attention_plain(q, k, v, window=2)
    assert torch.isfinite(out).all()
    assert not out[0, 0, 4:].any()  # rows 4.. see no key j < 3 with i-j < 2
    assert out[0, 0, :4].abs().sum() > 0


def test_plain_takes_strided_model_layout_views():
    """The model passes (B, L, H, D) tensors transposed to (B, H, L, D)."""
    q, k, v = _qkv(7, 2, 4, 40, 32, kv=2)
    views = [torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3)))
             .transpose(1, 2) for a in (q, k, v)]
    assert not views[0].is_contiguous()
    out = fa.flash_attention_plain(*views, window=16)
    want = fa.flash_attention_plain(*_torch((q, k, v), torch.float32),
                                    window=16)
    assert torch.equal(out, want)


def test_plain_matches_model_attention():
    """As tests/test_kernels.py: the flash function equals the model's
    dense-masked ``_sdpa`` in the model's (B, L, H, D) layout."""
    cfg = ModelConfig(num_heads=4, num_kv_heads=4)
    b, h, l, d = 2, 4, 128, 64
    rng = np.random.default_rng(8)
    q, k, v = (rng.standard_normal((b, l, h, d)).astype(np.float32)
               for _ in range(3))
    mask = (np.arange(l)[None, :] <= np.arange(l)[:, None])[None, None]
    dense = _sdpa(cfg, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  jnp.asarray(mask))
    out = fa.flash_attention_plain(
        *(torch.from_numpy(a).transpose(1, 2) for a in (q, k, v)))
    np.testing.assert_allclose(_np(out.transpose(1, 2)), _np(dense),
                               atol=3e-5, rtol=3e-5)


# ---------------------------------------------------------------------------
# the bf16 tensor-core kernel's numerics, emulated on the CPU
# ---------------------------------------------------------------------------
def _tensor_core_emulation(q, k, v, causal, window):
    """The bf16 kernel's arithmetic: per BLOCK_Q-row q tile, the BLOCK_K-key
    tiles from the first its first row can see to the last its last row
    can see; S = q . k in f32 (bf16 products are exact in f32), scaled by
    D^-0.5 log2(e) in f32; masks on edge tiles only (asserted all-true on
    the others); the online max and sum in log2 units; P rounded to bf16
    before an f32-accumulated PV; acc / max(l, 1e-30) rounded to bf16."""
    bq, bk = fa.BLOCK_Q, fa.BLOCK_K
    b, h, lq, d = q.shape
    kvh, lk = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(h // kvh, dim=1)
    vf = v.float().repeat_interleave(h // kvh, dim=1)
    scale_log2 = d ** -0.5 * math.log2(math.e)
    out = torch.empty(b, h, lq, d)
    for q0 in range(0, lq, bq):
        rows = torch.arange(q0, min(q0 + bq, lq))
        k_hi = min(lk, int(rows[-1]) + 1) if causal else lk
        k_lo = max(0, q0 - window + 1) if window > 0 else 0
        m = torch.full((b, h, len(rows)), fa.NEG_INF)
        l_sum = torch.zeros(b, h, len(rows))
        acc = torch.zeros(b, h, len(rows), d)
        for k0 in range(k_lo // bk * bk, k_hi, bk):
            j = torch.arange(k0, min(k0 + bk, lk))
            s = torch.einsum("bhid,bhjd->bhij", q.float()[:, :, rows],
                             kf[:, :, j]) * scale_log2
            i_, j_ = rows[:, None], j[None, :]
            mask = torch.ones(len(rows), len(j), dtype=torch.bool)
            if causal:
                mask &= j_ <= i_
            if window > 0:
                mask &= (i_ - j_) < window
            edge = (k0 + bk > lk or (causal and k0 + bk - 1 > q0)
                    or (window > 0 and q0 + bq - 1 - k0 >= window))
            assert edge or mask.all()
            x = torch.where(mask, s, fa.NEG_INF)
            m_new = torch.maximum(m, x.amax(-1))
            alpha = torch.exp2(m - m_new)
            p = torch.where(mask, torch.exp2(x - m_new[..., None]), 0.0)
            l_sum = l_sum * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhij,bhjd->bhid", p.bfloat16().float(), vf[:, :, j])
            m = m_new
        out[:, :, rows] = acc / l_sum.clamp_min(1e-30)[..., None]
    return out.to(q.dtype)


@pytest.mark.parametrize("b,h,kv,l,d,causal,window", [
    (1, 4, 2, 200, 64, True, -1),     # GQA, a causal edge in every q tile
    (2, 6, 2, 150, 32, True, 50),     # window narrower than a tile
    (1, 5, 1, 130, 128, False, -1),   # non-causal, ragged Lk tail
    (1, 4, 1, 300, 64, False, 100),   # non-causal window
    (1, 2, 1, 257, 256, True, 130),   # gemma3's head dim, window > a tile
])
def test_tensor_core_numerics_match_plain_within_bf16_gate(b, h, kv, l, d,
                                                           causal, window):
    """P rounded to bf16 before PV moves the output by far less than the
    bf16 gate (2e-2) the card holds the kernel to against the plain
    version."""
    q, k, v = _torch(_qkv(20 + d, b, h, l, d, kv=kv), torch.bfloat16)
    out = _tensor_core_emulation(q, k, v, causal, window)
    ref = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert out.dtype == torch.bfloat16
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2


@pytest.mark.parametrize("b,h,kv,lq,lk,d", [
    (1, 4, 4, 1, 300, 64),     # a decode step's cross attention
    (2, 4, 2, 37, 130, 64),    # a tail q tile, GQA, ragged Lk
    (1, 2, 1, 70, 200, 128),   # two q tiles, the second ragged
])
def test_tensor_core_numerics_cross_match_plain_within_bf16_gate(b, h, kv,
                                                                 lq, lk, d):
    """The bf16 kernel's tiles at Lq != Lk, non-causal: every q tile reads
    every key tile, only the last edged by Lk."""
    rng = np.random.default_rng(lq * lk)
    q, k, v = _torch([rng.standard_normal(s).astype(np.float32) for s in
                      ((b, h, lq, d), (b, kv, lk, d), (b, kv, lk, d))],
                     torch.bfloat16)
    out = _tensor_core_emulation(q, k, v, False, -1)
    ref = fa.flash_attention_plain(q, k, v, causal=False)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2


# ---------------------------------------------------------------------------
# dispatch and the kernel wrapper
# ---------------------------------------------------------------------------
def test_ops_dispatch_cpu_takes_plain_without_launch():
    arrs = _torch(_qkv(9, 1, 4, 33, 64, kv=2), torch.float32)
    before = fa.flash_attention.launches
    out = ops.flash_attention(*arrs, window=8)
    assert fa.flash_attention.launches == before
    assert torch.equal(out, fa.flash_attention_plain(*arrs, window=8))


def test_kernel_wrapper_rejects_cpu_tensors():
    """The kernel wrapper never runs the plain version itself."""
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fa.flash_attention(*_torch(_qkv(0, 1, 1, 8, 32), torch.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_kernel_matches_plain(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100; chip_smoke.py also "
                    "covers this)")
    _, tdt, tol = DTYPES[dtype]
    for (b, h, kv, l, d) in ((2, 4, 2, 37, 64), (1, 12, 2, 300, 128),
                             (1, 4, 1, 130, 256)):
        arrs = _torch(_qkv(10, b, h, l, d, kv=kv), tdt, device="cuda")
        for causal, window in ((True, -1), (True, 32), (False, 100)):
            out = fa.flash_attention(*arrs, causal=causal, window=window)
            ref = fa.flash_attention_plain(*arrs, causal=causal,
                                           window=window)
            torch.cuda.synchronize()
            assert out.dtype == tdt
            assert (out.float() - ref.float()).abs().max().item() <= tol
