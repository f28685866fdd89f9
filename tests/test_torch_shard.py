"""The port's per-rank comm (``core/comm.py::ShardComm``,
``ShardHierComm``), its meshes and launcher (``launch/mesh.py``) and the
``Fabric``'s ``ShardComm`` branches, across gloo rank processes on the
CPU.

One pool of W = 2 and one of W = 4 rank processes (``tests/_torch_ranks.py
::comm_cases``) run every case; the tests read their results:

  * every ``ShardComm`` primitive (tiled and untiled all-gather, ring
    shifts both ways, ``shard_chunk``, ``gather_chunks``, all-sum,
    all-mean, reduce-scatter sum and mean) on f32, bf16 and uint8 rows
    made with numpy, against the port's ``LocalComm`` on the stacked rows:
    bitwise at W = 2 and at W = 4, as ``ShardComm``'s docstring states
    (the reductions are ``LocalComm``'s reduction over a stacked rank
    axis); the hierarchy's tiers on 2 x 2 ranks against
    ``LocalHierComm(2, 2)``, bitwise;
  * the ``Fabric`` over ``ShardComm``: ``exchange`` with none, int8,
    onebit and top-k, fused and unfused, bitwise with each other (the
    reference's ``test_shardcomm_fused_parity_bitwise``) and with the
    port's ``LocalComm`` ``Fabric``; one all-gather a bucket of exactly
    ``wire_nbytes`` bytes; the bf16 narrow wire (partitioned exchange,
    all-mean, all-sum, ring shift, all-gather) against ``LocalComm``
    (bitwise where both round alike, the dense reductions within the one
    bf16 rounding of the result that ``ShardComm`` adds) and all of it
    against the JAX package's ``ShardComm`` ``Fabric`` under
    ``shard_map`` on 4 forced host devices, in ONE subprocess;
  * ``make_mesh``'s groups and coordinates, ``make_production_mesh``'s
    check, the launcher's error paths and the backend checks.
"""

import os
import pickle
import subprocess
import sys
import tempfile

import _torch_ranks as R
import numpy as np
import pytest
import torch

from repro_torch.core import tree as T
from repro_torch.core.comm import LocalComm, LocalHierComm
from repro_torch.core.compression import get_compressor
from repro_torch.core.fabric import BucketLayout, Fabric, wire_nbytes
from repro_torch.launch import mesh as M

pytestmark = pytest.mark.torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 4)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rows(world, seed=0):
    """(W, 3, 40) rows of each dtype: 40 divides by W, so every op is
    defined on them."""
    rng = np.random.default_rng(seed + world)
    f = rng.standard_normal((world, 3, 40)).astype(np.float32)
    return {"float32": f, "bfloat16": f,
            "uint8": rng.integers(0, 256, (world, 3, 40)).astype(np.uint8)}


def grads(world, seed=1):
    """A gradient tree of several buckets (buckets of 1024 f32: 1500 and
    300 elements, a 64-element block a tail)."""
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((world, 10, 150)).astype(np.float32),
            "c": rng.standard_normal((world, 300)).astype(np.float32),
            "b": rng.standard_normal((world, 7, 16)).astype(np.float32)}


JAX_SCRIPT = r'''
import pickle, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.core.comm import ShardComm
from repro.core.compression import get_compressor
from repro.core.fabric import Fabric
from repro.core.jax_compat import make_mesh, set_mesh, shard_map

inp = pickle.load(open(sys.argv[1], "rb"))
W, BB = 4, inp["bb"]
mesh = make_mesh((W,), ("w",))
g = jax.tree.map(jnp.asarray, inp["grads"])
r = jax.tree.map(jnp.zeros_like, g)
out = {}

def run(body, *args):
    fn = shard_map(body, mesh=mesh, axis_names={"w"},
                   in_specs=tuple(P("w") for _ in args), out_specs=P("w"),
                   check_vma=False)
    with set_mesh(mesh):
        return jax.tree.map(np.asarray, jax.jit(fn)(*args))

for name in ("none", "int8", "onebit", "topk"):
    comp = None if name == "none" else get_compressor(name, **inp["kw"][name])
    for fused in (True, False):
        def body(gg, rr):
            fab = Fabric(ShardComm("w", W), BB, fused=fused)
            m, nr, _ = fab.exchange(gg, rr, comp)
            return {"mean": m, "residual": nr}
        out[f"{name}/{fused}"] = run(body, g, r)

def narrow(gg):
    fab = Fabric(ShardComm("w", W), BB, wire_dtype=jnp.bfloat16)
    play = fab.partitioned_layout(gg)
    shards, _ = fab.exchange_partitioned(gg, play)
    return {"rs": shards, "all_mean": fab.all_mean(gg),
            "all_sum": fab.all_sum(gg), "ppermute": fab.ppermute(gg, 1),
            "unpartition": fab.unpartition(shards, play)}
out["bf16"] = run(narrow, g)
pickle.dump(out, open(sys.argv[2], "wb"))
print("JAX_SIDE_OK")
'''


@pytest.fixture(scope="module")
def runs():
    """The JAX subprocess and the two rank pools, run at the same time."""
    tmp = tempfile.mkdtemp(prefix="shard-")
    src, dst = os.path.join(tmp, "in.pkl"), os.path.join(tmp, "out.pkl")
    with open(src, "wb") as f:
        pickle.dump({"bb": R.BB_FABRIC, "kw": R.FABRIC_KW,
                     "grads": grads(4)}, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=os.environ.get("XLA_FLAGS", "")
               + " --xla_force_host_platform_device_count=4")
    proc = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, src, dst],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        pools = {w: M.run_ranks(R.comm_cases, w,
                                args=({"rows": rows(w),
                                       "grads": grads(w)},),
                                device="cpu", timeout=300)
                 for w in WORLDS}
        out, err = proc.communicate(timeout=400)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0 and "JAX_SIDE_OK" in out, err[-3000:]
    with open(dst, "rb") as f:
        jax_out = pickle.load(f)
    return {"pools": pools, "jax": jax_out}


def _eq(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


# ---------------------------------------------------------------------------
# the primitives against LocalComm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", sorted(R.DTYPES))
@pytest.mark.parametrize("world", WORLDS)
def test_primitives_bitwise_local_comm(runs, world, dtype):
    stacked = torch.from_numpy(rows(world)[dtype]).to(R.DTYPES[dtype])
    want = R.primitives(LocalComm(world), stacked)
    for r in range(world):
        got = runs["pools"][world][r]["prims"][dtype]
        assert set(want) <= set(got)
        for op, w in want.items():
            assert _eq(got[op], w[r]), (op, r)
        # untiled gather: every rank's row; gather_chunks: chunk r of each
        assert _eq(got["ag"], stacked)
        c = stacked.shape[-1] // world
        assert _eq(got["gather_chunks"], stacked[..., r * c:(r + 1) * c])


@pytest.mark.parametrize("world", WORLDS)
def test_rank_scalars_and_transport(runs, world):
    for r in range(world):
        got = runs["pools"][world][r]
        assert got["transport"] == "gloo"
        assert got["worker_index"] == r
        assert got["all_min"] == 3.0


@pytest.mark.parametrize("tier", ["inner", "outer"])
def test_hierarchy_tiers_bitwise_local_hier_comm(runs, tier):
    stacked = torch.from_numpy(rows(4)["float32"]).reshape(2, 2, 3, 40)
    hier = LocalHierComm(2, 2)
    want = R.primitives(getattr(hier, tier), stacked)
    for r in range(4):
        got = runs["pools"][4][r]["hier"][tier]
        for op, w in want.items():
            assert _eq(got[op], w[r // 2, r % 2]), (op, r)


def test_mesh_groups_and_coordinates(runs):
    for r in range(4):
        got = runs["pools"][4][r]["mesh"]
        assert got["coords"] == {"pod": r // 2, "data": r % 2}
        assert got["sizes"] == {"pod": 2, "data": 2}
        assert got["groups"]["pod/data"] == [0, 1, 2, 3]
        assert got["groups"]["data"] == [2 * (r // 2), 2 * (r // 2) + 1]
        assert got["groups"]["pod"] == [r % 2, r % 2 + 2]


# ---------------------------------------------------------------------------
# the Fabric over ShardComm
# ---------------------------------------------------------------------------
def _local_fabric(world):
    g = T.tree_map(torch.from_numpy, grads(world))
    res = T.tree_map(torch.zeros_like, g)
    return R.fabric_cases(LocalComm(world), g, res)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", R.FABRIC_COMPRESSORS)
def test_exchange_fused_unfused_and_local_comm_bitwise(runs, world, name):
    local = _local_fabric(world)
    for r in range(world):
        got = runs["pools"][world][r]["fabric"]
        for key in ("mean", "residual"):
            if name == "none" and key == "residual":
                continue
            f, u = got[f"{name}/True"][key], got[f"{name}/False"][key]
            for a, b, c in zip(T.leaves(f), T.leaves(u),
                               T.leaves(local[f"{name}/True"][key])):
                assert _eq(a, b) and _eq(a, c[r]), (key, r)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["int8", "onebit", "topk"])
def test_compressed_exchange_gathers_wire_nbytes_a_bucket(runs, world, name):
    g = T.tree_map(torch.from_numpy, grads(world))
    lay = BucketLayout.build(T.tree_map(lambda x: x[0], g), R.BB_FABRIC)
    comp = get_compressor(name, **R.FABRIC_KW[name])
    for r in range(world):
        stats = runs["pools"][world][r]["fabric_gathers"][name]
        assert set(stats) == {"all_gather"}  # nothing else crossed
        assert stats["all_gather"] == (
            lay.n_buckets, sum(wire_nbytes(comp, n)
                               for n in lay.bucket_sizes))
    assert lay.n_buckets >= 2


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("op", ["rs", "unpartition", "ppermute", "all_mean",
                                "all_sum"])
def test_narrow_wire_against_local_comm(runs, world, op):
    """The partitioned exchange, the ring shift and the gather are bitwise
    ``LocalComm``'s: the same bf16 image, reduced in f32 the same way.
    The dense reductions hand back the bf16 image of ``LocalComm``'s f32
    result (the gather ships 16 bits)."""
    local = _local_fabric(world)["bf16"][op]
    for r in range(world):
        got = runs["pools"][world][r]["fabric"]["bf16"][op]
        for a, b in zip(T.leaves(got), T.leaves(local)):
            want = b[r]
            if op in ("all_mean", "all_sum"):
                want = want.to(torch.bfloat16).float()
            assert _eq(a, want), (op, r)


# ---------------------------------------------------------------------------
# against the JAX package's ShardComm Fabric (W = 4, shard_map)
# ---------------------------------------------------------------------------
def _stacked(runs, key, part):
    ranks = [runs["pools"][4][r]["fabric"][key][part] for r in range(4)]
    return T.tree_map(lambda *xs: torch.stack(xs), *ranks)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("name", R.FABRIC_COMPRESSORS)
def test_exchange_matches_jax_shard_comm(runs, name, fused):
    want = runs["jax"][f"{name}/{fused}"]
    for part in ("mean", "residual"):
        if name == "none" and part == "residual":
            continue
        got = _stacked(runs, f"{name}/{fused}", part)
        for key in want[part]:
            a = got[key].numpy()
            b = np.asarray(want[part][key], np.float32).reshape(a.shape)
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("op", ["rs", "unpartition", "ppermute", "all_mean",
                                "all_sum"])
def test_narrow_wire_matches_jax_shard_comm(runs, op):
    want = runs["jax"]["bf16"][op]
    ranks = [runs["pools"][4][r]["fabric"]["bf16"][op] for r in range(4)]
    if op == "rs":  # (chunk,) a rank: JAX's global is the ranks' concat
        got = [torch.cat(xs) for xs in zip(*ranks)]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        return
    for key in want:
        a = torch.stack([rk[key] for rk in ranks]).float().numpy()
        b = np.asarray(want[key]).astype(np.float32).reshape(a.shape)
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# meshes, the launcher and the backends
# ---------------------------------------------------------------------------
def test_production_mesh_checks_tp_degree():
    with pytest.raises(ValueError, match="tp_degree must divide 256"):
        M.make_production_mesh(tp_degree=3)
    with pytest.raises(ValueError, match="tp_degree must divide 256"):
        M.production_mesh_shape(multi_pod=True, tp_degree=0)
    assert M.production_mesh_shape(tp_degree=16) == ((16, 16),
                                                     ("data", "model"))
    assert M.production_mesh_shape(multi_pod=True, tp_degree=8) == (
        (2, 32, 8), ("pod", "data", "model"))


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        M.make_mesh((2,), ("pod",), device="cpu")


def test_backend_checks(monkeypatch):
    assert M.default_backend("cpu") == "gloo"
    assert M.default_backend("cuda") == "nccl"
    with pytest.raises(ValueError, match="takes CUDA ranks"):
        M.check_backend("nccl", 1, "cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="one card a rank"):
        M.check_backend("nccl", 2, "cuda")
    M.check_backend("nccl", 1, "cuda")
    M.check_backend("gloo", 2, "cuda")
    with pytest.raises(ValueError, match="backend must be"):
        M.check_backend("mpi", 2, "cpu")


def test_a_rank_that_raises_fails_the_run():
    with pytest.raises(Exception, match="rank 1 fails"):
        M.run_ranks(R.fails_on_rank_one, 2, device="cpu", timeout=120)


def test_fabric_narrow_flags():
    fab = Fabric(LocalComm(2), 64, wire_dtype="bfloat16")
    assert not fab._narrow_sharded and not fab._sharded

