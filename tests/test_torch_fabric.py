"""The port's bucketed exchange fabric against the JAX package, W = 4.

The tree's sorted-key order differs from its insertion order, and the
small bucket caps give multi-leaf buckets and tails padded to the
compression block.  The JAX side runs its jnp codec path
(``Fabric(fused=False)``), which the JAX package's own tests hold bitwise
equal to its fused kernels; the port runs both its fused round (the plain
kernels on the CPU) and its codec path.  Bitwise: layouts, residuals and
``wire_bytes``.  The mean over replicas: atol 1e-6 (only the order of a
4-term f32 sum can differ).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.comm import LocalComm as JLocalComm
from repro.core.compression import get_compressor as jget_compressor
from repro.core.fabric import BucketLayout as JBucketLayout
from repro.core.fabric import Fabric as JFabric
from repro_torch.core import tree as TT
from repro_torch.core.comm import LocalComm
from repro_torch.core.compression import get_compressor
from repro_torch.core.fabric import BucketLayout, Fabric, wire_nbytes

pytestmark = pytest.mark.torch

W = 4
COMPRESSORS = [("none", {}), ("onebit", {}), ("onebit", {"block": 64}),
               ("int8", {"block": 64}), ("topk", {"ratio": 0.1, "block": 64}),
               ("topk", {})]


def np_tree(seed=0, scale=1.0):
    """Insertion order z, a, m{10, 2}: jax.tree order is a, m{10, 2}, z.
    "a" (8*16) divides the blocks; the others leave padded tails."""
    rng = np.random.default_rng(seed)

    def a(*shape):
        return (scale * rng.standard_normal((W,) + shape)).astype(np.float32)

    return {"z": a(300), "a": a(8, 16), "m": {"10": a(50), "2": a(70)}}


def both(tree):
    return (jax.tree.map(jnp.asarray, tree),
            TT.tree_map(torch.from_numpy, tree))


def bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


@pytest.mark.parametrize("bucket_bytes", [1 << 9, 1 << 12, 4 << 20])
def test_bucket_layout_equals_reference(bucket_bytes):
    jt, tt = both(np_tree())
    jl = JBucketLayout.build(jt, bucket_bytes, lead_axes=1)
    tl = BucketLayout.build(tt, bucket_bytes, lead_axes=1)
    for f in ("lead_shape", "shapes", "sizes", "bucket_of", "offsets",
              "bucket_sizes"):
        assert getattr(tl, f) == getattr(jl, f), f
    assert tl.n_buckets == jl.n_buckets and tl.n_leaves == jl.n_leaves
    for jb, tb in zip(jl.bucketize(jt), tl.bucketize(tt)):
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    back = tl.debucketize(tl.bucketize(tt))
    for k in ("z", "a"):
        assert torch.equal(back[k], tt[k])
    assert torch.equal(back["m"]["10"], tt["m"]["10"])


@pytest.mark.parametrize("name,kw", COMPRESSORS)
@pytest.mark.parametrize("bucket_bytes", [1 << 9, 4 << 20])
def test_exchange_equals_reference(name, kw, bucket_bytes):
    jcomp = None if name == "none" else jget_compressor(name, **kw)
    tcomp = None if name == "none" else get_compressor(name, **kw)
    jg, tg = both(np_tree(1))
    jr, tr = both(np_tree(2, scale=0.1))
    jmean, jres, jm = JFabric(JLocalComm(W), bucket_bytes, fused=False) \
        .exchange(jg, jr if jcomp else None, jcomp)
    for fused in (True, False):
        fab = Fabric(LocalComm(W), bucket_bytes, fused=fused)
        tmean, tres, tm = fab.exchange(tg, tr if tcomp else None, tcomp)
        assert tm["wire_bytes"].dtype == torch.float32
        assert tm["wire_bytes"].item() == float(jm["wire_bytes"])
        assert tm["comm_events"].item() == float(jm["comm_events"])
        for a, b in zip(TT.leaves(tmean), jax.tree.leaves(jmean)):
            assert tuple(a.shape) == b.shape
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-6)
            # every replica receives the same mean
            assert (a == a[0:1]).all()
        if tcomp is None:
            assert tres is None
            continue
        for a, b in zip(TT.leaves(tres), jax.tree.leaves(jres)):
            np.testing.assert_array_equal(bits(a), bits(b))


@pytest.mark.parametrize("name,kw", COMPRESSORS)
def test_wire_bytes_equal_reference(name, kw):
    jcomp = None if name == "none" else jget_compressor(name, **kw)
    tcomp = None if name == "none" else get_compressor(name, **kw)
    jt, tt = both(np_tree())
    for bb in (1 << 9, 1 << 12, 4 << 20):
        jf, tf = JFabric(JLocalComm(W), bb), Fabric(LocalComm(W), bb)
        assert tf.wire_bytes(tt, tcomp) == jf.wire_bytes(jt, jcomp)
        assert tf.flat_bytes(tt) == jf.flat_bytes(jt)
    from repro.core.fabric import wire_nbytes as jwire_nbytes

    for n in (1, 300, 1025):
        assert wire_nbytes(tcomp, n) == jwire_nbytes(jcomp, n)


def test_fabric_all_mean_and_all_sum_equal_reference():
    jt, tt = both(np_tree(4))
    jf, tf = JFabric(JLocalComm(W), 1 << 9), Fabric(LocalComm(W), 1 << 9)
    for op in ("all_mean", "all_sum"):
        for a, b in zip(TT.leaves(getattr(tf, op)(tt)),
                        jax.tree.leaves(getattr(jf, op)(jt))):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-5)


def test_fused_round_is_bitwise_the_codec_round():
    """The port's fused dispatch equals its own codec path bit for bit,
    mean and residual, on padded and unpadded buckets."""
    tg = TT.tree_map(torch.from_numpy, np_tree(6))
    tr = TT.tree_map(torch.from_numpy, np_tree(7, scale=0.1))
    for name, kw in COMPRESSORS[1:]:
        comp = get_compressor(name, **kw)
        a = Fabric(LocalComm(W), 1 << 9, fused=True).exchange(tg, tr, comp)
        b = Fabric(LocalComm(W), 1 << 9, fused=False).exchange(tg, tr, comp)
        for x, y in zip(TT.leaves(a[:2]), TT.leaves(b[:2])):
            np.testing.assert_array_equal(bits(x), bits(y))

