"""The port's leaf-wise error-feedback codec and its two kernels' plain
versions against the JAX package.

Inputs are made with numpy from a seed and handed to both packages.  The
JAX kernels run in interpret mode, as the JAX package's own tests run them
on the CPU.  Tolerances: top-k values, indices and dense outputs bitwise
(the same k rounds of masked argmax, the lowest column on a tie); 1-bit
signs bitwise, the scale at rtol 1e-6 (the JAX package's own tolerance,
``tests/test_kernels.py``: the f32 sum of |t| may run in another order),
and the residual bitwise against t − sign·scale with the port's own scale;
the codec's outputs therefore bitwise for top-k and at rtol 1e-6 (g_hat,
±scale) and atol 1e-6 (the residual, t ∓ scale) for 1-bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as JC
from repro.kernels.onebit_quant import onebit_quant as pallas_onebit
from repro.kernels.ref import onebit_quant_ref, topk_sparsify_ref
from repro.kernels.topk_sparsify import topk_sparsify as pallas_topk
from repro_torch.core import compression as C
from repro_torch.core import tree as TT
from repro_torch.kernels import onebit_quant as ob
from repro_torch.kernels import ops
from repro_torch.kernels import topk_sparsify as tk

pytestmark = pytest.mark.torch


def bits(a):
    """Bit pattern of a float array (tells -0.0 from +0.0)."""
    a = np.asarray(a.float() if isinstance(a, torch.Tensor) else a)
    a = np.ascontiguousarray(a.astype(np.float32))
    return a.view(np.uint32)


def special_rows(seed, nb, block, scale=0.1):
    """(g, r) rows with an all-zero row, a row of two nonzeros, tied
    magnitudes and -0.0 targets, then random rows."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((nb, block)).astype(np.float32)
    r = (scale * rng.standard_normal((nb, block))).astype(np.float32)
    if nb >= 4:
        g[0], r[0] = 0.0, 0.0
        g[1], r[1] = 0.0, 0.0
        g[1, 5], g[1, block - 3] = 1.5, -2.5
        g[2], r[2] = 0.5, 0.0
        g[2, ::2] = -0.5
        g[3, ::3], r[3, ::3] = -0.0, -0.0
    return g, r


# ---------------------------------------------------------------------------
# onebit_quant (the unpacked variant)
# ---------------------------------------------------------------------------
ONEBIT_SWEEP = [(1, 128), (17, 128), (64, 256), (4, 64)]  # test_kernels.py


@pytest.mark.parametrize("nb,block", ONEBIT_SWEEP)
def test_onebit_quant_plain_matches_interpret_kernel_and_ref(nb, block):
    g, r = special_rows(nb * block, nb, block)
    sign, scale, new_r = ob.onebit_quant_plain(torch.from_numpy(g),
                                               torch.from_numpy(r))
    assert (sign.dtype, scale.dtype, new_r.dtype) == \
        (torch.int8, torch.float32, torch.float32)
    assert tuple(scale.shape) == (nb, 1)
    t = torch.from_numpy(g) + torch.from_numpy(r)
    np.testing.assert_array_equal(bits(new_r),
                                  bits(t - sign.float() * scale))
    for want in (pallas_onebit(jnp.asarray(g), jnp.asarray(r),
                               interpret=True),
                 onebit_quant_ref(jnp.asarray(g), jnp.asarray(r))):
        np.testing.assert_array_equal(sign.numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(scale.numpy(), np.asarray(want[1]),
                                   rtol=1e-6)
        np.testing.assert_allclose(new_r.numpy(), np.asarray(want[2]),
                                   rtol=1e-5, atol=1e-6)


def test_onebit_quant_plain_signs_negative_zero_as_plus_one():
    g = np.full((1, 64), -0.0, np.float32)
    sign, scale, new_r = ob.onebit_quant_plain(torch.from_numpy(g),
                                               torch.zeros(1, 64))
    assert sign.tolist() == [[1] * 64] and scale.item() == 0.0


# ---------------------------------------------------------------------------
# topk_sparsify
# ---------------------------------------------------------------------------
TOPK_SWEEP = [(4, 128, 4), (37, 256, 8), (1, 64, 1), (8, 512, 32),
              (13, 1024, 10)]  # test_kernels.py's shapes and the codec's
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _same_bits(a, b):
    np.testing.assert_array_equal(bits(a), bits(b))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("nb,block,k", TOPK_SWEEP)
def test_topk_sparsify_plain_matches_ref_and_interpret_kernel(nb, block, k,
                                                              dtype):
    jdt, tdt = DTYPES[dtype]
    g, _ = special_rows(nb + block + k, nb, block)
    x = torch.from_numpy(g).to(tdt)
    jx = jnp.asarray(g).astype(jdt)
    vals, idx, dense = tk.topk_sparsify_plain(x, k)
    assert (vals.dtype, idx.dtype, dense.dtype) == (tdt, torch.int32, tdt)
    rvals, ridx, rdense = topk_sparsify_ref(jx, k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    _same_bits(vals, np.asarray(rvals, np.float32))  # -0.0 stays -0.0
    _same_bits(dense, np.asarray(rdense, np.float32))
    pvals, pidx, pdense = pallas_topk(jx, k, interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(pidx))
    _same_bits(dense, np.asarray(pdense, np.float32))
    # the Pallas kernel reads a taken -0.0 back as +0.0 (a masked sum)
    np.testing.assert_array_equal(vals.float().numpy(),
                                  np.asarray(pvals, np.float32))


def test_topk_sparsify_plain_keeps_a_taken_negative_zero():
    x = np.zeros((1, 64), np.float32)
    x[0, 2] = -0.0
    x[0, 9] = 3.0
    vals, idx, dense = tk.topk_sparsify_plain(torch.from_numpy(x), 4)
    assert idx.tolist() == [[9, 0, 1, 2]]
    assert bits(vals).tolist() == [[bits(np.float32(3.0)).item(), 0, 0,
                                    0x80000000]]
    assert bits(dense)[0, 2] == 0x80000000 and dense[0, 9].item() == 3.0


def _nan_inf_rows(seed, block=64):
    """Rows with NaN, -NaN, +-inf, -0.0 and ties: random with specials;
    zeros but NaN at 3, 2.0 at 5 and inf at 9; zeros and -0.0 with one
    NaN and one inf; tied magnitudes with -inf."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, block)).astype(np.float32)
    x[0, [2, 7, 11, 20, 33]] = [np.nan, -np.inf, np.inf, -np.nan, -0.0]
    x[1] = 0.0
    x[1, [3, 5, 9]] = [np.nan, 2.0, np.inf]
    x[2] = rng.choice([-0.0, 0.0], block)
    x[2, [6, 40]] = [np.inf, -np.nan]
    x[3] = rng.choice([-1.0, 1.0], block)
    x[3, [4, 50]] = -np.inf
    return x


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_topk_sparsify_plain_orders_nan_and_inf_as_lax_top_k(dtype):
    """idx, vals and dense bitwise equal to ``topk_sparsify_ref``
    (``lax.top_k``: |NaN| above +inf, the lowest column on a tie)."""
    jdt, tdt = DTYPES[dtype]
    jx = jnp.asarray(_nan_inf_rows(1)).astype(jdt)
    # one cast for both: torch and JAX round a NaN to bf16 as other bits
    ints = np.array(jx).view(np.int32 if dtype == "float32" else np.int16)
    x = torch.from_numpy(ints).view(tdt)
    vals, idx, dense = tk.topk_sparsify_plain(x, 6)
    rvals, ridx, rdense = topk_sparsify_ref(jx, 6)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    assert idx[1, :3].tolist() == [3, 9, 5]
    _same_bits(vals, np.asarray(rvals, np.float32))
    _same_bits(dense, np.asarray(rdense, np.float32))
    # the reference's own difference: its Pallas kernel takes no column on
    # a row with a NaN (idx = block every round); it agrees elsewhere
    pidx = np.asarray(pallas_topk(jx, 6, interpret=True)[1])
    assert (pidx[:3] == x.shape[1]).all()
    np.testing.assert_array_equal(pidx[3], idx[3].numpy())


def test_topk_encode_ef_plain_orders_nan_and_inf_as_lax_top_k():
    """idx and vals bitwise equal to ``topk_sparsify_ref`` on t = g + r,
    and the residual to t - its dense."""
    g = _nan_inf_rows(2)
    r = np.where(np.isfinite(g), 0.1 * np.random.default_rng(3)
                 .standard_normal(g.shape), 0.0).astype(np.float32)
    r[1:3] = 0.0  # keep the zeros and -0.0 of rows 1 and 2
    vals, idx, new_r = tk.topk_encode_ef_plain(torch.from_numpy(g),
                                               torch.from_numpy(r), 6)
    t = jnp.asarray(g) + jnp.asarray(r)
    rvals, ridx, rdense = topk_sparsify_ref(t, 6)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    assert idx[1, :3].tolist() == [3, 9, 5]
    _same_bits(vals, np.asarray(rvals))
    _same_bits(new_r, np.asarray(t - rdense))


def test_new_ops_dispatch_cpu_to_plain_without_launch():
    g, r = (torch.from_numpy(a) for a in special_rows(0, 9, 256))
    before = (ob.onebit_quant.launches, tk.topk_sparsify.launches)
    for a, b in zip(ops.onebit_quant(g, r), ob.onebit_quant_plain(g, r)):
        assert torch.equal(a, b)
    for a, b in zip(ops.topk_sparsify(g, 3), tk.topk_sparsify_plain(g, 3)):
        assert torch.equal(a, b)
    assert (ob.onebit_quant.launches, tk.topk_sparsify.launches) == before


def test_new_kernel_wrappers_reject_what_the_kernels_do_not_take():
    g, r = (torch.from_numpy(a) for a in special_rows(0, 9, 256))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ob.onebit_quant(g, r)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tk.topk_sparsify(g, 3)


# ---------------------------------------------------------------------------
# the leaf-wise codec: ef_compress_tree, dgc_compress_tree
# ---------------------------------------------------------------------------
CODECS = [("onebit", {}), ("onebit", {"block": 64}),
          ("onebit", {"block": 512}),
          ("int8", {}), ("topk", {"ratio": 0.01}),
          ("topk", {"ratio": 0.1, "block": 64}),
          # a block past the card's top-k kernel (it raises there): the
          # plain version still runs it on the CPU
          ("topk", {"ratio": 0.01, "block": 2048})]


def _tree(seed, scale=1.0):
    """A stacked tree: replica axes, a tail that pads, a scalar-ish leaf,
    and -0.0 entries."""
    rng = np.random.default_rng(seed)
    t = {"a": rng.standard_normal((3, 700)), "b": {
        "w": rng.standard_normal((3, 4, 129)), "z": np.zeros((3, 5))},
        "c": rng.standard_normal((3, 1030))}
    t = jax.tree.map(lambda x: (scale * x).astype(np.float32), t)
    t["b"]["z"][:, 1] = -0.0
    return t


def _both(tree):
    return (jax.tree.map(jnp.asarray, tree),
            TT.tree_map(torch.from_numpy, tree))


def _jcomp(name, kw):
    return dataclasses.replace(JC.get_compressor(name, **kw),
                               fused_encode=None)


def _check_round(name, got, want, target):
    """got/want: (g_hat, new_r) leaves; target the round's t."""
    g_hat, new_r = (np.asarray(x) for x in got)
    w_hat, w_r = (np.asarray(x) for x in want)
    if name == "onebit":
        np.testing.assert_array_equal(np.signbit(g_hat), np.signbit(w_hat))
        np.testing.assert_allclose(g_hat, w_hat, rtol=1e-6)
        np.testing.assert_allclose(new_r, w_r, rtol=0, atol=1e-6)
        _same_bits(new_r, np.asarray(target, np.float32) - g_hat)
    else:
        _same_bits(g_hat, w_hat)
        _same_bits(new_r, w_r)


def _counting(monkeypatch):
    """Count the calls of the two kernels' plain versions (what ops picks
    on the CPU)."""
    calls = {"onebit_quant": 0, "topk_sparsify": 0}
    for mod, name in ((ob, "onebit_quant"), (tk, "topk_sparsify")):
        plain = getattr(mod, f"{name}_plain")

        def wrap(*a, _plain=plain, _name=name):
            calls[_name] += 1
            return _plain(*a)

        monkeypatch.setattr(mod, f"{name}_plain", wrap)
    return calls


@pytest.mark.parametrize("name,kw", CODECS)
def test_ef_compress_tree_equals_reference(name, kw, monkeypatch):
    calls = _counting(monkeypatch)
    g, r = _tree(1), _tree(2, 0.1)
    jg, tg = _both(g)
    jr, tr = _both(r)
    jc, tc = _jcomp(name, kw), C.get_compressor(name, **kw)
    jhat, jres = JC.ef_compress_tree(jc, jg, jr)
    t_hat, tres = C.ef_compress_tree(tc, tg, tr)
    for a, b, c, d, gg, rr in zip(TT.leaves(t_hat), TT.leaves(tres),
                                  jax.tree.leaves(jhat),
                                  jax.tree.leaves(jres),
                                  jax.tree.leaves(g), jax.tree.leaves(r)):
        assert a.shape == c.shape and b.shape == d.shape
        _check_round(name, (a, b), (c, d), gg + rr)
    _assert_one_call_a_leaf(name, calls, len(jax.tree.leaves(g)))


def _assert_one_call_a_leaf(name, calls, leaves):
    """1-bit and top-k run each leaf's round as one call of their kernel's
    plain version (on the CPU), whatever the block; none and int8 none."""
    kernel = {"onebit": "onebit_quant", "topk": "topk_sparsify"}.get(name)
    assert calls == {n: leaves if n == kernel else 0 for n in calls}


@pytest.mark.parametrize("name,kw", CODECS)
def test_dgc_compress_tree_equals_reference(name, kw, monkeypatch):
    calls = _counting(monkeypatch)
    g = _tree(3)
    state = {"velocity": _tree(4, 0.5), "residual": _tree(5, 0.1)}
    jg, tg = _both(g)
    jstate, tstate = _both(state)
    jc, tc = _jcomp(name, kw), C.get_compressor(name, **kw)
    assert set(C.dgc_init(tg)) == {"velocity", "residual"}
    jhat, jnew = JC.dgc_compress_tree(jc, jg, jstate, momentum=0.9)
    t_hat, tnew = C.dgc_compress_tree(tc, tg, tstate, momentum=0.9)
    u1 = jax.tree.map(lambda u, x: np.float32(0.9) * u + x,
                      state["velocity"], g)
    targets = jax.tree.map(lambda r, u: r + u, state["residual"], u1)
    for a, b, c, d, t in zip(TT.leaves(t_hat), TT.leaves(tnew["residual"]),
                             jax.tree.leaves(jhat),
                             jax.tree.leaves(jnew["residual"]),
                             jax.tree.leaves(targets)):
        _check_round(name, (a, b), (c, d), t)
    # what was sent leaves the velocity: exactly where g_hat is nonzero
    for a, c in zip(TT.leaves(tnew["velocity"]),
                    jax.tree.leaves(jnew["velocity"])):
        _same_bits(a, np.asarray(c))
    _assert_one_call_a_leaf(name, calls, len(jax.tree.leaves(g)))


def test_codec_kernels_match_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100; chip_smoke.py also "
                    "covers this)")
    g, r = (torch.from_numpy(a).cuda() for a in special_rows(0, 64, 256))
    sign, scale, new_r = ob.onebit_quant(g, r)
    want = ob.onebit_quant_plain(g, r)
    assert torch.equal(sign, want[0])
    torch.testing.assert_close(scale, want[1], rtol=1e-6, atol=0)
    t = g + r
    assert torch.equal(new_r.view(torch.int32),
                       (t - sign.float() * scale).view(torch.int32))
    for dt in (torch.float32, torch.bfloat16):
        x = g.reshape(-1, 1024).contiguous().to(dt)
        for a, b in zip(tk.topk_sparsify(x, 10), tk.topk_sparsify_plain(x, 10)):
            assert a.dtype == b.dtype
            assert torch.equal(a.contiguous().view(torch.uint8),
                               b.contiguous().view(torch.uint8))
