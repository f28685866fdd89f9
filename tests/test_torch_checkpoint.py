"""The port's npz checkpointer, its re-sharding and the CLI's
``--ckpt-dir``/``--resume auto``, against the JAX package on the CPU.

The format on disk is the reference's, so checkpoints cross packages in
both directions: a ZeRO-1 state under ``bf16`` (its partition and
precision specs, the f32 master shards in ``opt_state``) and a ZeRO-3
state (param shards) saved by one package restore in the other with
every leaf bitwise equal.  bf16 leaves go to disk widened to f32 and come
back by torch's round to nearest even, bitwise the reference's
``ml_dtypes`` cast.  A ZeRO state saved at W = 4 restores at W = 2 with
``repartition=True``: the full state after ``unpartition`` bitwise.  The
copy of ``core/resharding.py`` is held bitwise against the reference's
on the same numpy arrays.  Resuming is bitwise: three steps, a save, a
fresh state, ``resume_auto`` and three more equal six uninterrupted
steps (the schedule restarts at the restored step).
"""

import io
import json
import os
import warnings
import zipfile

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import checkpoint as JCK
from repro.core import resharding as JRS
from repro.core import strategies as JST
from repro.core.comm import LocalComm as JLocalComm
from repro.core.precision import get_policy as jget_policy
from repro.optim import optimizers as JO
from repro.train import loop as JLOOP
from repro_torch import checkpoint as CK
from repro_torch.bridge import train_state_from_numpy, train_state_to_numpy
from repro_torch.core import resharding as RS
from repro_torch.core import strategies as ST
from repro_torch.core import tree as TT
from repro_torch.core.comm import LocalComm
from repro_torch.core.fabric import DEFAULT_BUCKET_BYTES, Fabric
from repro_torch.core.precision import get_policy
from repro_torch.launch import train as CLI
from repro_torch.optim import optimizers as TO
from repro_torch.train import loop as TLOOP

pytestmark = pytest.mark.torch

BB = 4 * 40  # small buckets, so the tiny trees span several
# the CLI's strategies (and so ``checkpoint_tree``) use the default buckets
DEF = DEFAULT_BUCKET_BYTES


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(x):
    """A leaf's dtype name, shape and bytes (bf16 as its 16-bit image)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return "bfloat16", tuple(t.shape), t.view(torch.int16).numpy() \
                .tobytes()
        return str(t.dtype).removeprefix("torch."), tuple(t.shape), \
            t.numpy().tobytes()
    a = np.asarray(x)
    return a.dtype.name, a.shape, a.tobytes()


def assert_bitwise(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert _bits(x) == _bits(y)


def _flip_member(npz_path, member):
    """Flip the last byte of one array member inside the .npz (re-zipped,
    so only that leaf's payload is corrupt)."""
    with zipfile.ZipFile(npz_path) as z:
        blobs = {n: z.read(n) for n in z.namelist()}
    raw = bytearray(blobs[member])
    raw[-1] ^= 0xFF
    blobs[member] = bytes(raw)
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as z:
        for n, b in blobs.items():
            z.writestr(n, b)
    with open(npz_path, "wb") as f:
        f.write(buf.getvalue())


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(3, 5, generator=g),
            "h": torch.randn(4, 6, generator=g).to(torch.bfloat16),
            "n": torch.arange(7, dtype=torch.int32),
            "l": [torch.randn(2, generator=g), torch.randn(3, generator=g)],
            "step": torch.tensor(9, dtype=torch.int32)}


# ---------------------------------------------------------------------------
# the format and the integrity checks
# ---------------------------------------------------------------------------
def test_round_trip_of_f32_bf16_and_int_leaves(tmp_path):
    d = str(tmp_path)
    tree = _tree()
    fname = CK.save_checkpoint(d, 3, tree)
    assert os.path.basename(fname) == "ckpt_00000003.npz"
    with np.load(fname) as data:
        assert sorted(data.files) == ["h", "l.0", "l.1", "n", "step", "w"]
        assert data["h"].dtype == np.float32  # widened on disk
        assert data["step"].shape == () and data["step"].dtype == np.int32
    template = TT.tree_map(lambda x: torch.zeros_like(x, device="meta"),
                           tree)
    got = CK.restore_checkpoint(d, 3, template)
    assert_bitwise(got, tree)
    assert got["h"].dtype == torch.bfloat16 and got["l"][1].device.type \
        == "cpu"
    # the casted restore: the f32 leaf into a bf16 template, and back
    cast = CK.restore_checkpoint(d, 3, {**template, "w": template["w"].to(
        torch.bfloat16)})
    assert torch.equal(cast["w"], tree["w"].to(torch.bfloat16))
    assert CK.read_meta(d)["latest"] == 3 and CK.latest_step(d) == 3


def test_bf16_on_disk_matches_ml_dtypes_bitwise():
    """Widening bf16 to f32 and rounding f32 to bf16 (nearest even, ties
    and the neighbours of the largest finite bf16 included): torch's bits
    are the reference's ``ml_dtypes`` bits."""
    rng = np.random.default_rng(0)
    base = rng.standard_normal(4096).astype(np.float32) \
        * np.float32(2.0) ** rng.integers(-30, 30, 4096).astype(np.float32)
    bits = base.view(np.uint32)
    ties = ((bits & ~np.uint32(0xFFFF)) | np.uint32(0x8000)).view(np.float32)
    edge = np.array([0.0, -0.0, 1.0, 3.3895314e38, 3.3961776e38, 1e-40,
                     -1e-45, np.inf, -np.inf], np.float32)
    x = np.concatenate([base, ties, edge])
    ours = torch.from_numpy(x).to(torch.bfloat16)
    ref = x.astype(ml_dtypes.bfloat16)
    assert ours.view(torch.int16).numpy().tobytes() \
        == ref.view(np.int16).tobytes()
    assert ours.float().numpy().tobytes() \
        == ref.astype(np.float32).tobytes()


def test_atomic_write_leaves_the_latest_intact(tmp_path, monkeypatch):
    d = str(tmp_path)
    CK.save_checkpoint(d, 1, {"w": torch.arange(6.0)})
    assert not CK.stray_tmp_files(d)

    def boom(fobj, **kw):  # a crash mid-save: partial bytes, then death
        fobj.write(b"partial garbage")
        raise RuntimeError("disk full")

    monkeypatch.setattr(np, "savez_compressed", boom)
    with pytest.raises(RuntimeError):
        CK.save_checkpoint(d, 2, {"w": torch.arange(6.0) * 2})
    assert CK.read_meta(d)["latest"] == 1
    assert CK.stray_tmp_files(d) == ["ckpt_00000002.npz.tmp"]
    with pytest.warns(UserWarning, match="stray tmp file"):
        assert CK.latest_step(d) == 1
    with pytest.warns(UserWarning, match="stray tmp file"):
        got = CK.restore_checkpoint(d, 1, {"w": torch.zeros(6)})
    assert torch.equal(got["w"], torch.arange(6.0))


def test_crc32_mismatch_names_the_leaf(tmp_path):
    d = str(tmp_path)
    tree = {"a": torch.arange(6.0), "b": {"c": torch.ones(3, 3)}}
    CK.save_checkpoint(d, 0, tree)
    assert CK.verify_checkpoint(d, 0) is None
    _flip_member(str(tmp_path / "ckpt_00000000.npz"), "b.c.npy")
    reason = CK.verify_checkpoint(d, 0)
    assert "b.c" in reason and "crc32" in reason
    with pytest.raises(ValueError, match=r"leaf 'b\.c' is corrupt"):
        CK.restore_checkpoint(d, 0, tree)


def test_latest_valid_step_skips_corrupt_and_partial_steps(tmp_path):
    d = str(tmp_path)
    for s in (1, 2, 3):
        CK.save_checkpoint(d, s, {"a": torch.arange(6.0) * s})
    _flip_member(str(tmp_path / "ckpt_00000003.npz"), "a.npy")
    (tmp_path / "ckpt_00000002.npz").write_bytes(
        (tmp_path / "ckpt_00000002.npz").read_bytes()[:40])  # truncated
    assert CK.latest_step(d) == 3
    with pytest.warns(UserWarning, match="skipping step 3"):
        assert CK.latest_valid_step(d) == 1
    assert "unreadable" in CK.verify_checkpoint(d, 2)
    assert CK.verify_checkpoint(d, 4) == "ckpt_00000004.npz missing"
    _flip_member(str(tmp_path / "ckpt_00000001.npz"), "a.npy")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert CK.latest_valid_step(d) is None
    assert CK.latest_valid_step(str(tmp_path / "nowhere")) is None


# ---------------------------------------------------------------------------
# partitioned (ZeRO) state and re-sharding
# ---------------------------------------------------------------------------
def _mlp_base(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": (0.3 * rng.standard_normal((9, 7))).astype(np.float32),
            "b": (0.3 * rng.standard_normal(23)).astype(np.float32)}


def _mlp_loss(p, x):
    h = torch.tanh(x.to(p["w"].dtype) @ p["w"])
    return torch.mean((h.float().sum(-1) - p["b"].float().sum()) ** 2)


def _jmlp_loss(p, x):
    h = jnp.tanh(x.astype(p["w"].dtype) @ p["w"])
    return jnp.mean((h.astype(jnp.float32).sum(-1)
                     - p["b"].astype(jnp.float32).sum()) ** 2)


def _batch(w, t):
    rng = np.random.default_rng(100 + t)
    return rng.standard_normal((w, 4, 9)).astype(np.float32)


def _port_state(stage, w, precision="f32", steps=2, opt=None, bb=BB):
    """A port train state of ``sync_zero<stage>`` after ``steps`` steps."""
    pol = None if precision == "f32" else get_policy(precision)
    comm = LocalComm(w)
    strat = ST.get_strategy(f"sync_zero{stage}", bucket_bytes=bb, policy=pol)
    opt = opt or TO.adam(TO.warmup_cosine(1e-2, 1, 8))
    params = comm.replicate(TT.tree_map(torch.from_numpy, _mlp_base()))
    if pol is not None:
        params = pol.cast_to_param(params)
    state = TLOOP.init_train_state(params, opt, strat, comm, policy=pol)
    step = TLOOP.make_replica_train_step(_mlp_loss, opt, strat, comm,
                                         policy=pol, bucket_bytes=bb)
    for t in range(steps):
        state, _ = step(state, torch.from_numpy(_batch(w, t)))
    return state, strat, comm, pol, step


@pytest.mark.parametrize("stage", [1, 3])
def test_reshard_w4_to_w2_is_bitwise(tmp_path, stage):
    """A ZeRO state saved at W = 4 restores at W = 2 with
    ``repartition=True``: m, v, the master (ZeRO-1 bf16) or the param
    shards (ZeRO-3) after ``unpartition`` bitwise the saved ones."""
    d = str(tmp_path)
    precision = "bf16" if stage == 1 else "f32"
    state4, strat4, comm4, pol, _ = _port_state(stage, 4, precision)
    full4 = strat4.gather_params(state4["params"], comm4) \
        if stage == 3 else state4["params"]

    def shard_tree(state):  # the CLI's save tree, at this file's buckets
        tree = {"opt_state": state["opt_state"]}
        if stage == 3:
            tree["param_shards"] = state["params"]
        return tree

    CK.save_checkpoint(d, 2, shard_tree(state4), partition=Fabric(
        comm4, BB).partitioned_layout(full4).spec())
    assert CK.read_meta(d)["partitions"]["2"]["n_parts"] == 4
    state2, _, comm2, _, _ = _port_state(stage, 2, precision, steps=0)
    got = CK.restore_checkpoint(d, 2, shard_tree(state2), repartition=True)
    # f32 layouts: the master is compared at its own width
    fab4, fab2 = Fabric(comm4, BB), Fabric(comm2, BB)
    play4 = fab4.partitioned_layout(TT.tree_map(lambda x: x.float(), full4))
    play2 = fab2.partitioned_layout(comm2.replicate(
        TT.tree_map(lambda x: x[0].float(), full4)))
    assert play2.layout.bucket_sizes == play4.layout.bucket_sizes
    inner4 = state4["opt_state"]["opt"] if stage == 1 \
        else state4["opt_state"]
    inner2 = got["opt_state"]["opt"] if stage == 1 else got["opt_state"]
    pairs = [(inner2["m"], inner4["m"]), (inner2["v"], inner4["v"])]
    pairs.append((got["opt_state"]["master"], state4["opt_state"]["master"])
                 if stage == 1 else (got["param_shards"], state4["params"]))
    for new, old in pairs:
        assert all(x.shape[0] == 2 for x in new)
        a = fab2.unpartition(new, play2)
        b = fab4.unpartition(old, play4)
        for k in a:
            assert torch.equal(a[k][0], b[k][0]), k


def test_partition_spec_survives_later_saves_and_bad_layouts_rejected(
        tmp_path):
    d = str(tmp_path)
    state, strat, comm, pol, _ = _port_state(1, 4, opt=TO.momentum(0.1))
    play = Fabric(comm, BB).partitioned_layout(state["params"])
    CK.save_checkpoint(d, 5, {"opt_state": state["opt_state"]},
                       partition=play.spec())
    CK.save_checkpoint(d, 9, {"params": state["params"]})
    assert CK.read_meta(d)["latest"] == 9
    assert CK.read_meta(d)["partitions"]["5"] == play.spec()
    got = CK.restore_checkpoint(
        d, 5, {"opt_state": TT.tree_map(torch.zeros_like,
                                        state["opt_state"])},
        repartition=True)
    assert_bitwise(got["opt_state"], state["opt_state"])
    # a template of another bucket layout (one big bucket) is rejected
    big = Fabric(LocalComm(2), 1 << 20).shard_params(
        LocalComm(2).replicate(TT.tree_map(torch.from_numpy, _mlp_base())))
    with pytest.raises(ValueError, match="bucket"):
        CK.restore_checkpoint(d, 5, {"opt_state": {"m": big}},
                              repartition=True)
    with pytest.raises(ValueError, match="no partition spec"):
        CK.restore_checkpoint(d, 9, {"params": state["params"]},
                              repartition=True)


def test_resharding_copy_matches_reference():
    """``reshard_bucket`` and ``repartition_tree`` on the same numpy arrays
    (stacked (W, C) and global flat shards) bitwise the reference's."""
    rng = np.random.default_rng(3)
    sizes = [37, 64, 5]
    for w, w2 in ((4, 2), (2, 3), (3, 1)):
        stacked = [rng.standard_normal((w, -(-n // w))).astype(np.float32)
                   for n in sizes]
        flat = [rng.standard_normal(-(-n // w) * w).astype(np.float32)
                for n in sizes]
        tree = {"m": stacked, "x": {"master": flat},
                "dense": rng.standard_normal(3).astype(np.float32)}
        ours = RS.repartition_tree(tree, sizes, w2)
        ref = JRS.repartition_tree(tree, sizes, w2)
        assert_bitwise(ours, ref)
        for a, n in zip(stacked, sizes):
            target = (w2, -(-n // w2))
            want = JRS.reshard_bucket(a, n, target)
            assert _bits(RS.reshard_bucket(a, n, target)) == _bits(want)
    assert CK.reshard_bucket is RS.reshard_bucket


# ---------------------------------------------------------------------------
# checkpoints cross packages
# ---------------------------------------------------------------------------
def _jax_state(stage, w, precision, steps=2):
    pol = None if precision == "f32" else jget_policy(precision)
    comm = JLocalComm(w)
    strat = JST.get_strategy(f"sync_zero{stage}", policy=pol)
    opt = JO.adam(JO.warmup_cosine(1e-2, 1, 8))
    params = comm.replicate(jax.tree.map(jnp.asarray, _mlp_base()))
    if pol is not None:
        params = pol.cast_to_param(params)
    state = JLOOP.init_train_state(params, opt, strat, comm, policy=pol)
    step = JLOOP.make_replica_train_step(_jmlp_loss, opt, strat, comm,
                                         policy=pol)
    for t in range(steps):
        state, _ = step(state, jnp.asarray(_batch(w, t)))
    return state, strat, comm, pol


def _jax_tree(state, strat, comm, pol, stage):
    """The JAX CLI's save tree (``repro/launch/train.py``)."""
    from repro.core.fabric import Fabric as JFabric

    owns = stage == 3
    full = strat.gather_params(state["params"], comm) if owns \
        else state["params"]
    tree = {"params": comm.replica(full, 0), "step": state["step"],
            "opt_state": state["opt_state"]}
    if owns:
        tree["param_shards"] = state["params"]
    kw = {"partition": JFabric(comm).partitioned_layout(full).spec()}
    if pol is not None:
        kw["precision"] = pol.spec()
    return tree, kw


CROSS = [(1, "bf16"), (3, "f32")]


@pytest.mark.parametrize("stage,precision", CROSS)
def test_jax_checkpoint_restores_in_the_port(tmp_path, stage, precision):
    d = str(tmp_path)
    jstate, jstrat, jcomm, jpol = _jax_state(stage, 2, precision)
    jtree, kw = _jax_tree(jstate, jstrat, jcomm, jpol, stage)
    JCK.save_checkpoint(d, 2, jtree, **kw)
    state, strat, comm, pol, _ = _port_state(stage, 2, precision, steps=0,
                                             bb=DEF)
    template, tkw = CLI.checkpoint_tree(state, strat, comm, pol)
    assert tkw["partition"] == CK.read_meta(d)["partitions"]["2"]
    assert tkw.get("precision") == CK.read_precision(d, 2)
    got = CK.restore_checkpoint(d, 2, template, repartition=True)
    assert_bitwise(got, jax.tree.map(np.asarray, jtree))
    if precision == "bf16":
        assert got["params"]["w"].dtype == torch.bfloat16


@pytest.mark.parametrize("stage,precision", CROSS)
def test_port_checkpoint_restores_in_jax(tmp_path, stage, precision):
    d = str(tmp_path)
    state, strat, comm, pol, _ = _port_state(stage, 2, precision, bb=DEF)
    tree, kw = CLI.checkpoint_tree(state, strat, comm, pol)
    CK.save_checkpoint(d, 2, tree, **kw)
    jstate, jstrat, jcomm, jpol = _jax_state(stage, 2, precision, steps=0)
    jtemplate, jkw = _jax_tree(jstate, jstrat, jcomm, jpol, stage)
    assert jkw["partition"] == JCK.read_meta(d)["partitions"]["2"]
    assert jkw.get("precision") == JCK.read_precision(d, 2)
    got = JCK.restore_checkpoint(d, 2, jtemplate, repartition=True)
    assert_bitwise(got, tree)


# ---------------------------------------------------------------------------
# resuming: the state, the bridge, the step counter
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("stage,precision", CROSS)
def test_resume_is_bitwise_an_uninterrupted_run(tmp_path, stage, precision):
    """Six steps against three, ``checkpoint_tree`` saved, a fresh state,
    ``resume_auto`` and three more: every leaf bitwise; the schedule
    resumes at the restored step, which the step reads back once."""
    d = str(tmp_path)
    ref, *_ = _port_state(stage, 2, precision, steps=6, bb=DEF)
    state, strat, comm, pol, _ = _port_state(stage, 2, precision, steps=3,
                                             bb=DEF)
    tree, kw = CLI.checkpoint_tree(state, strat, comm, pol)
    CK.save_checkpoint(d, 3, tree, **kw)
    fresh, strat, comm, pol, step = _port_state(stage, 2, precision,
                                                steps=0, bb=DEF)
    assert CLI.resume_auto(d, fresh, strat, comm, pol, "cpu") == 3
    for t in range(3, 6):
        fresh, _ = step(fresh, torch.from_numpy(_batch(2, t)))
    assert int(fresh["step"]) == 6
    # the loss scale is not checkpointed (nor by the reference): its value
    # is the uninterrupted run's, its growth streak restarted at the resume
    if precision == "bf16":
        assert torch.equal(fresh.pop("loss_scale")["scale"],
                           ref["loss_scale"]["scale"])
        assert int(ref.pop("loss_scale")["good_steps"]) == 6
    assert_bitwise(fresh, ref)


def test_zero1_state_through_bridge_and_checkpoint_restores_into_sync(
        tmp_path):
    """ZeRO-1's replicated params are broadcast views: through the bridge,
    a save and a restore into ``sync`` they become W rows of their own,
    and ``sync``'s fused Adam (which writes params in place) steps them."""
    d = str(tmp_path)
    state, strat, comm, pol, _ = _port_state(1, 2, "f32", bb=DEF)
    assert state["params"]["w"].stride()[0] == 0
    back = train_state_from_numpy(train_state_to_numpy(state), "cpu")
    assert_bitwise(back, state)
    assert back["params"]["w"].stride()[0] != 0
    tree, kw = CLI.checkpoint_tree(back, strat, comm, pol)
    CK.save_checkpoint(d, 2, tree, **kw)
    opt = TO.adam(TO.warmup_cosine(1e-2, 1, 8), fused=True)
    sync = ST.sync(bucket_bytes=BB)
    dense = TLOOP.init_train_state(comm.replicate(TT.tree_map(
        torch.from_numpy, _mlp_base())), opt, sync, comm)
    restored = CK.restore_checkpoint(d, 2, {"params": TT.tree_map(
        lambda x: x[0], dense["params"])})
    dense["params"] = comm.replicate(restored["params"])
    for k in dense["params"]:
        assert torch.equal(dense["params"][k], state["params"][k])
    step = TLOOP.make_replica_train_step(_mlp_loss, opt, sync, comm,
                                         bucket_bytes=BB)
    before = dense["params"]["w"].clone()
    dense, m = step(dense, torch.from_numpy(_batch(2, 2)))
    assert not torch.equal(dense["params"]["w"], before)
    assert float(m["replica_divergence"]) == 0.0


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
CLI_ARGS = ["--arch", "qwen2-1.5b", "--reduced", "--workers", "2",
            "--seq-len", "16", "--batch-per-worker", "2", "--log-every",
            "1"]


def _port_cli(tmp_path, steps, extra=()):
    return CLI.main(CLI_ARGS + ["--device", "cpu", "--steps", str(steps),
                                "--ckpt-dir", str(tmp_path / "ck"),
                                *extra])


def _jax_cli(tmp_path, steps, extra=()):
    from repro.launch import train as JCLI

    return JCLI.main(CLI_ARGS + ["--steps", str(steps), "--ckpt-dir",
                                 str(tmp_path / "ck"), *extra])


def test_cli_resume_auto_continues_from_the_saved_step(tmp_path, capsys):
    h1 = _port_cli(tmp_path, 2, ("--zero-stage", "1"))
    h2 = _port_cli(tmp_path, 4, ("--zero-stage", "1", "--resume", "auto"))
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "checkpoint saved to" in out
    assert [r["step"] for r in h1] == [0, 1]
    assert [r["step"] for r in h2] == [2, 3]
    meta = CK.read_meta(str(tmp_path / "ck"))
    assert sorted(meta["checksums"]) == ["2", "4"]
    assert CK.verify_checkpoint(str(tmp_path / "ck"), 4) is None


@pytest.mark.parametrize("first", ["port", "jax"])
def test_cli_checkpoints_resume_across_packages(tmp_path, capsys, first):
    """A checkpoint of one package's CLI (ZeRO-3 under ``bf16``) resumes
    in the other's, which then saves one that the first resumes."""
    runs = {"port": _port_cli, "jax": _jax_cli}
    second = "jax" if first == "port" else "port"
    flags = ("--zero-stage", "3", "--precision", "bf16")
    runs[first](tmp_path, 1, flags)
    h = runs[second](tmp_path, 2, flags + ("--resume", "auto"))
    h3 = runs[first](tmp_path, 3, flags + ("--resume", "auto"))
    out = capsys.readouterr().out
    assert "resumed from step 1" in out and "resumed from step 2" in out
    assert [r["step"] for r in h] == [1] and [r["step"] for r in h3] == [2]
    assert all(np.isfinite(r["loss"]) for r in h + h3)
    meta = json.loads((tmp_path / "ck" / "meta.json").read_text())
    assert sorted(meta["precision"]) == ["1", "2", "3"]
