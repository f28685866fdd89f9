"""The port's compression codec, its kernels' plain versions and the
stacked-replica comm against the JAX package.

Inputs are made with numpy from a seed and handed to both packages.  The
JAX kernels run in interpret mode, as the JAX package's own tests run them
on the CPU.  Bitwise: the onebit packed bytes, scales and residuals, the
top-k values, indices and residuals, the packed wire buffers and the
closed-form ``packed_nbytes``.  Adam: rtol 1e-5, atol 1e-6, the JAX
package's own kernel tolerance (``tests/test_kernels.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as JC
from repro.core.comm import LocalComm as JLocalComm
from repro.kernels.fused_adam import fused_adam as pallas_adam
from repro.kernels.onebit_quant import onebit_quant_packed as pallas_onebit
from repro.kernels.ref import fused_adam_ref
from repro.kernels.topk_sparsify import topk_encode_ef as pallas_topk
from repro_torch.core import compression as C
from repro_torch.core import tree as TT
from repro_torch.core.comm import LocalComm
from repro_torch.kernels import fused_adam as fa
from repro_torch.kernels import onebit_quant as ob
from repro_torch.kernels import ops
from repro_torch.kernels import topk_sparsify as tk

pytestmark = pytest.mark.torch


def bits(a):
    """Bit pattern of a float array (tells -0.0 from +0.0)."""
    a = np.ascontiguousarray(np.asarray(a, np.float32))
    return a.view(np.uint32)


def rows(seed, nb, block):
    """(g, r) rows with the cases the kernels must get right: an all-zero
    row (a zero-padded tail block), a row with two nonzeros (fewer than
    k), a row of tied magnitudes, and a row holding -0.0 targets."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((nb, block)).astype(np.float32)
    r = (0.1 * rng.standard_normal((nb, block))).astype(np.float32)
    g[0], r[0] = 0.0, 0.0
    g[1], r[1] = 0.0, 0.0
    g[1, 5], g[1, block - 3] = 1.5, -2.5
    g[2], r[2] = 0.5, 0.0
    g[2, ::2] = -0.5
    g[3, ::3], r[3, ::3] = -0.0, -0.0
    return g, r


ROW_SHAPES = [(13, 256), (11, 64), (9, 1024)]


@pytest.mark.parametrize("nb,block", ROW_SHAPES)
def test_onebit_plain_matches_interpret_kernel_bitwise(nb, block):
    g, r = rows(nb, nb, block)
    want = pallas_onebit(jnp.asarray(g), jnp.asarray(r), interpret=True)
    got = ob.onebit_quant_packed_plain(torch.from_numpy(g),
                                       torch.from_numpy(r))
    assert got[0].dtype == torch.uint8 and got[1].dtype == torch.bfloat16
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(bits(got[1].float()),
                                  bits(np.asarray(want[1], np.float32)))
    np.testing.assert_array_equal(bits(got[2]), bits(want[2]))


@pytest.mark.parametrize("nb,block,k", [(13, 1024, 10), (11, 64, 5),
                                        (9, 256, 3)])
def test_topk_plain_matches_interpret_kernel_bitwise(nb, block, k):
    g, r = rows(nb + block, nb, block)
    want = pallas_topk(jnp.asarray(g), jnp.asarray(r), k, interpret=True)
    got = tk.topk_encode_ef_plain(torch.from_numpy(g), torch.from_numpy(r), k)
    assert got[1].dtype == torch.int32
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(bits(got[0]), bits(want[0]))
    np.testing.assert_array_equal(bits(got[2]), bits(want[2]))


def test_topk_plain_keeps_negative_zero_as_the_codec_does():
    """A taken -0.0 keeps its sign in vals (the jnp codec's
    take_along_axis); the residual of a taken entry is +0.0 and of an
    untaken -0.0 is -0.0."""
    block, k = 64, 4
    t = np.zeros(block, np.float32)
    t[1], t[5], t[40] = -0.0, 1.0, -0.0
    g = torch.from_numpy(t.copy())[None]
    r = torch.from_numpy(np.where(np.signbit(t), -0.0, 0.0)
                         .astype(np.float32))[None]
    vals, idx, new_r = tk.topk_encode_ef_plain(g, r, k)
    comp = JC.get_compressor("topk", ratio=k / block, block=block)
    (taken, jidx), _ = comp.compress(jnp.asarray(t))
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(jidx)[0])
    np.testing.assert_array_equal(bits(vals[0]), bits(np.asarray(taken)[0]))
    assert np.signbit(vals[0, 2].item()) and not np.signbit(new_r[0, 1].item())
    assert np.signbit(new_r[0, 40].item())


@pytest.mark.parametrize("n,p_dtype", [(1000, "float32"), (4099, "float32"),
                                       (300, "bfloat16")])
def test_fused_adam_plain_matches_interpret_kernel(n, p_dtype):
    rng = np.random.default_rng(n)
    p, g, m = (rng.standard_normal(n).astype(np.float32) for _ in range(3))
    v = rng.random(n).astype(np.float32)
    lr, t = 1e-3, 3
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[p_dtype]
    want = pallas_adam(jnp.asarray(p, jdt), jnp.asarray(g), jnp.asarray(m),
                       jnp.asarray(v), lr, float(t), interpret=True)
    ref = fused_adam_ref(jnp.asarray(p, jdt), jnp.asarray(g), jnp.asarray(m),
                         jnp.asarray(v), lr, t=t)
    tt = torch.tensor(float(t))
    consts = torch.stack([torch.tensor(lr, dtype=torch.float32),
                          1.0 - 0.9 ** tt, 1.0 - 0.999 ** tt])
    # every numpy input is copied before the in-place update: on the CPU
    # ``jnp.asarray`` of an f32 numpy array shares its buffer, and JAX's
    # dispatch is asynchronous, so writing into ``p`` could reach the
    # reference's operands before they are read
    tp = torch.from_numpy(p.copy()).to(getattr(torch, p_dtype))
    tg, tm, tv = (torch.from_numpy(a.copy()) for a in (g, m, v))
    out = fa.fused_adam_plain(tp, tg, tm, tv, consts)
    assert out[0] is tp and out[1] is tm and out[2] is tv  # in place
    assert tp.dtype == getattr(torch, p_dtype)
    for o, w, x in zip(out, want, ref):
        np.testing.assert_allclose(o.float().numpy(),
                                   np.asarray(w, np.float32),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(o.float().numpy(),
                                   np.asarray(x, np.float32),
                                   rtol=1e-5, atol=1e-6)


def test_ops_dispatch_cpu_takes_plain_without_launch():
    g, r = (torch.from_numpy(a) for a in rows(0, 9, 256))
    before = (ob.onebit_quant_packed.launches, tk.topk_encode_ef.launches,
              fa.fused_adam.launches)
    for a, b in zip(ops.onebit_quant_packed(g, r),
                    ob.onebit_quant_packed_plain(g, r)):
        assert torch.equal(a, b)
    for a, b in zip(ops.topk_encode_ef(g, r, 3),
                    tk.topk_encode_ef_plain(g, r, 3)):
        assert torch.equal(a, b)
    p, m, v = (torch.ones(7) for _ in range(3))
    ops.fused_adam(p, torch.ones(7), m, v, torch.tensor([1e-3, 0.1, 1e-3]))
    assert (ob.onebit_quant_packed.launches, tk.topk_encode_ef.launches,
            fa.fused_adam.launches) == before


def test_kernel_wrappers_reject_cpu_tensors():
    """The kernel wrappers never run the plain versions themselves."""
    g, r = (torch.from_numpy(a) for a in rows(0, 9, 256))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ob.onebit_quant_packed(g, r)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tk.topk_encode_ef(g, r, 3)
    x = torch.ones(5)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fa.fused_adam(x, x, x, x, torch.ones(3))


# ---------------------------------------------------------------------------
# codec
# ---------------------------------------------------------------------------
CODECS = [("onebit", {}), ("onebit", {"block": 64}), ("int8", {}),
          ("topk", {"ratio": 0.01}), ("topk", {"ratio": 0.1, "block": 64})]
SIZES = [1, 7, 255, 256, 257, 300, 1023, 1024, 1025, 4103]


def _pair(name, kw):
    return JC.get_compressor(name, **kw), C.get_compressor(name, **kw)


@pytest.mark.parametrize("name,kw", CODECS)
def test_packed_nbytes_closed_form_equals_reference(name, kw):
    jc, tc = _pair(name, kw)
    for n in SIZES + [65_536, 1_000_003]:
        assert C.packed_nbytes(tc, n) == JC.packed_nbytes(jc, n), n
    assert C.packed_nbytes(C.none_compressor(), 300) \
        == JC.packed_nbytes(JC.none_compressor(), 300) == 1200
    assert tc.name == jc.name
    assert tc.wire_bits_per_element == jc.wire_bits_per_element


@pytest.mark.parametrize("name,kw", CODECS)
@pytest.mark.parametrize("n", [1, 255, 256, 300, 1025])
def test_codec_wire_bytes_and_decode_equal_reference(name, kw, n):
    jc, tc = _pair(name, kw)
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    x[::7] = 0.0
    jwire, _ = jc.compress(jnp.asarray(x))
    twire, _ = tc.compress(torch.from_numpy(x))
    jarrs, jwiden = JC._narrow_wire(jc.name, jwire)
    tarrs, twiden = C._narrow_wire(tc.name, twire)
    jbuf, jspecs = JC._pack(jarrs)
    tbuf, tspecs = C._pack(tarrs)
    assert tbuf.dtype == torch.uint8
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    assert tbuf.numel() == C.packed_nbytes(tc, n)
    jdec = jc.decompress(jwiden(JC._unpack(jbuf, jspecs)), None, (n,),
                         jnp.float32)
    tdec = tc.decompress(twiden(C._unpack(tbuf, tspecs)), None, (n,),
                         torch.float32)
    np.testing.assert_array_equal(bits(tdec), bits(jdec))


def test_pack_unpack_signs_equal_reference():
    s = np.where(np.random.default_rng(0).random(80) < 0.5, 1, -1) \
        .astype(np.int8)
    tp = C.pack_signs(torch.from_numpy(s))
    np.testing.assert_array_equal(tp.numpy(),
                                  np.asarray(JC.pack_signs(jnp.asarray(s))))
    np.testing.assert_array_equal(C.unpack_signs(tp, 77).numpy(),
                                  np.asarray(JC.unpack_signs(
                                      JC.pack_signs(jnp.asarray(s)), 77)))


@pytest.mark.parametrize("name,kw", CODECS)
def test_ef_compress_tree_and_wire_bytes_equal_reference(name, kw):
    jc, tc = _pair(name, kw)
    rng = np.random.default_rng(3)
    tree = {"w": rng.standard_normal((5, 60)).astype(np.float32),
            "b": rng.standard_normal(300).astype(np.float32)}
    res = {k: (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
           for k, v in tree.items()}
    jg, jr = JC.ef_compress_tree(jc, jax.tree.map(jnp.asarray, tree),
                                 jax.tree.map(jnp.asarray, res))
    tg, tr = C.ef_compress_tree(tc, TT.tree_map(torch.from_numpy, tree),
                                TT.tree_map(torch.from_numpy, res))
    for k in tree:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(tr[k].numpy(), np.asarray(jr[k]),
                                   rtol=0, atol=1e-6)
    assert C.wire_bytes(tc, TT.tree_map(torch.from_numpy, tree)) \
        == JC.wire_bytes(jc, jax.tree.map(jnp.asarray, tree))


def test_fused_encode_matches_codec_round_bitwise():
    """The fused round (plain kernels on the CPU) ships the codec's bytes
    and leaves its residual, replica by replica, padded tail included."""
    for name, kw in [("onebit", {"block": 64}),
                     ("topk", {"ratio": 0.1, "block": 64})]:
        tc = C.get_compressor(name, **kw)
        rng = np.random.default_rng(5)
        g = torch.from_numpy(rng.standard_normal((4, 300))
                             .astype(np.float32))
        r = torch.from_numpy((0.1 * rng.standard_normal((4, 300)))
                             .astype(np.float32))
        arrs, widen, new_r = tc.fused_encode(g, r)
        for w in range(4):
            t = g[w] + r[w]
            wire, _ = tc.compress(t)
            want, _ = C._narrow_wire(tc.name, wire)
            for a, b in zip(arrs, want):
                assert torch.equal(a[w].reshape(-1).view(torch.uint8),
                                   b.reshape(-1).contiguous()
                                   .view(torch.uint8))
            dec = tc.decompress(widen([a[w] for a in arrs]), None, (300,),
                                torch.float32)
            np.testing.assert_array_equal(bits(new_r[w]), bits(t - dec))


# ---------------------------------------------------------------------------
# tree order and the stacked comm
# ---------------------------------------------------------------------------
def test_tree_flatten_order_is_jax_order():
    keys = ["stack", "embed", "final_norm"]
    inner = {str(i): {"wv": i, "bq": i, "wo": i, "bk": i} for i in
             (2, 11, 0, 10, 1)}
    tree = {k: (inner if k == "stack" else {"scale": k}) for k in keys}
    tree["lst"] = [{"b": 1, "a": 2}, (3, 4)]
    leaves, tdef = TT.flatten(tree)
    jleaves = jax.tree.leaves(tree)
    assert leaves == jleaves
    assert TT.unflatten(tdef, leaves) == tree
    assert TT.tree_map(lambda a, b: (a, b), tree, tree)["lst"][1] \
        == ((3, 3), (4, 4))


def test_local_comm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 3, 8)).astype(np.float32)
    jc, tc = JLocalComm(4), LocalComm(4)
    jx, tx = [jnp.asarray(x)], [torch.from_numpy(x)]
    for fn in ("all_mean", "all_sum", "ppermute"):
        np.testing.assert_allclose(getattr(tc, fn)(tx)[0].numpy(),
                                   np.asarray(getattr(jc, fn)(jx)[0]),
                                   rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tc.all_gather(tx, tiled=True)[0].numpy(),
                                  np.asarray(jc.all_gather(jx, tiled=True)[0]))
    np.testing.assert_allclose(tc.reduce_scatter(tx, mean=True)[0].numpy(),
                               np.asarray(jc.reduce_scatter(jx, mean=True)[0]),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tc.shard_chunk(tx)[0].numpy(),
                                  np.asarray(jc.shard_chunk(jx)[0]))
    np.testing.assert_array_equal(tc.worker_index().numpy(),
                                  np.asarray(jc.worker_index()))
    rep = tc.replicate({"a": torch.arange(3.0)})
    assert rep["a"].shape == (4, 3) and torch.equal(rep["a"][2],
                                                    torch.arange(3.0))
    assert torch.equal(tc.replica(rep, 1)["a"], torch.arange(3.0))
    with pytest.raises(NotImplementedError):
        tc.all_gather(tx)
