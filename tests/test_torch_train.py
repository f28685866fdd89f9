"""The port's training path against the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages:
parameters in ``init_model``'s tree layout, the JAX package's own data
batches, and one initial train state (through ``bridge``).  The JAX side
runs its jnp codec path (the compressor without its fused encode, which
the JAX package's tests hold bitwise equal to its kernels) and, for fused
Adam, its kernel's oracle ``fused_adam_ref``; the port runs its own
default path, the kernels' plain versions.

Tolerances: model logits atol 1e-4 and loss rtol 1e-5 (two layers and a
512-wide tied head in f32); gradients atol 2e-5 against ``jax.grad``;
schedules rtol 1e-6 (XLA's f32 cos is 1 ulp off the correctly rounded
one, and the cosine's ``1 + cos`` magnifies that to a few ulps);
optimizer updates atol 1e-6; train histories
exact in ``wire_bytes`` and divergence, and loss within rtol 1e-4 over 5
steps (sums run in other orders, and a 1-bit sign or a top-k choice near
a tie can flip on a last-bit difference).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_layers import np_params, to_jax

import repro.kernels.ops as jops
from repro.configs import get_config as jax_config
from repro.core.comm import LocalComm as JLocalComm
from repro.core.compression import get_compressor as jget_compressor
from repro.core.strategies import sync as jsync
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import bayes_entropy as jbayes_entropy
from repro.data.pipeline import worker_batches as jworker_batches
from repro.kernels.ref import fused_adam_ref
from repro.optim import optimizers as JO
from repro.train import loop as JLOOP
from repro_torch.bridge import (params_from_numpy, train_state_from_numpy,
                                train_state_to_numpy)
from repro_torch.configs import get_config as torch_config
from repro_torch.core import tree as TT
from repro_torch.core.comm import LocalComm
from repro_torch.core.compression import get_compressor
from repro_torch.core.strategies import get_strategy, sync
from repro_torch.data.pipeline import (DataConfig, bayes_entropy,
                                       worker_batches)
from repro_torch.launch import train as CLI
from repro_torch.models import transformer as TM
from repro_torch.optim import optimizers as TO
from repro_torch.train import loop as TLOOP

pytestmark = pytest.mark.torch

W = 4


def cfgs(arch, **over):
    return (dataclasses.replace(jax_config(arch).reduced(), **over),
            dataclasses.replace(torch_config(arch).reduced(), **over))


def batch_np(cfg, b=2, l=32, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=(b, l)).astype(np.int32)


# ---------------------------------------------------------------------------
# model forward and backward
# ---------------------------------------------------------------------------
# gemma3 reduced: window 16 on layer 0, global layer 1.  Under the default
# scan_layers the reference's window is traced, so both take the masked
# path; unrolled (scan_layers=False) at L=32 layer 0 takes the banded one.
MODEL_CASES = [("qwen2-1.5b", {}), ("gemma3-1b", {}),
               ("gemma3-1b", {"scan_layers": False}),
               ("qwen2-1.5b", {"scan_layers": False}),
               ("deepseek-67b", {})]


@pytest.mark.parametrize("arch,over", MODEL_CASES)
def test_forward_loss_and_grads_match_jax(arch, over):
    jcfg, tcfg = cfgs(arch, **over)
    params = np_params(jcfg, seed=1)
    toks = batch_np(jcfg)
    jloss_fn = JLOOP.make_loss_fn(jcfg, remat=False)
    tloss_fn = TLOOP.make_loss_fn(tcfg, remat=False)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    tbatch = {"tokens": torch.from_numpy(toks),
              "labels": torch.from_numpy(toks)}

    from repro.models import transformer as JT

    jlogits, _ = JT.forward(to_jax(params), jcfg, tokens=jbatch["tokens"])
    tp = params_from_numpy(params, "cpu")
    with torch.no_grad():
        tlogits, aux = TM.forward(tp, tcfg, tbatch["tokens"])
    assert float(aux) == 0.0
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=0, atol=1e-4)

    jl, jg = jax.value_and_grad(jloss_fn)(to_jax(params), jbatch)
    leaves = TT.leaves(tp)
    for x in leaves:
        x.requires_grad_()
    tl = tloss_fn(tp, tbatch)
    tg = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    jleaves = jax.tree.leaves(jg)
    assert len(tg) == len(jleaves)
    for a, b in zip(tg, jleaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=2e-5)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gemma3-1b"])
def test_remat_gradients_equal_no_remat(arch):
    """``make_loss_fn(cfg, remat=True)`` (each layer under
    ``torch.utils.checkpoint``) recomputes the same activations: loss and
    gradients bitwise those of ``remat=False``, on a 2-layer cut."""
    _, tcfg = cfgs(arch)
    params = params_from_numpy(np_params(cfgs(arch)[0], seed=3), "cpu")
    toks = torch.from_numpy(batch_np(tcfg))
    batch = {"tokens": toks, "labels": toks}
    leaves = TT.leaves(params)
    for x in leaves:
        x.requires_grad_()
    out = {}
    for remat in (False, True):
        loss = TLOOP.make_loss_fn(tcfg, remat=remat)(params, batch)
        out[remat] = (loss.detach(), torch.autograd.grad(loss, leaves))
    assert tcfg.num_layers == 2
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(out[True][1], out[False][1]):
        assert torch.equal(a, b)


def test_banded_path_is_taken_only_when_the_window_is_static():
    from repro_torch.models import layers as TL

    calls = []
    orig = TL._sdpa_banded

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    _, tcfg = cfgs("gemma3-1b")
    params = params_from_numpy(np_params(cfgs("gemma3-1b")[0]), "cpu")
    toks = torch.from_numpy(batch_np(tcfg))
    TL._sdpa_banded = spy
    try:
        with torch.no_grad():
            TM.forward(params, tcfg, toks)
            assert calls == []  # scan_layers: traced window, masked path
            TM.forward(params, dataclasses.replace(tcfg, scan_layers=False),
                       toks)
            assert calls == [1]  # the one local layer, L=32 = 2 windows
    finally:
        TL._sdpa_banded = orig


# ---------------------------------------------------------------------------
# optimizers and schedules
# ---------------------------------------------------------------------------
def test_schedules_match_jax_in_f32():
    for sched, jsched in [
            (TO.warmup_cosine(1e-3, 2, 20), JO.warmup_cosine(1e-3, 2, 20)),
            (TO.cosine_schedule(3e-4, 7), JO.cosine_schedule(3e-4, 7)),
            (TO.constant_schedule(0.5), JO.constant_schedule(0.5))]:
        for t in range(25):
            got = sched(torch.tensor(t, dtype=torch.int32))
            want = np.float32(jsched(jnp.asarray(t, jnp.int32)))
            assert got.dtype == torch.float32
            # XLA's f32 cos is 1 ulp off the correctly rounded one that
            # PyTorch returns; 1 + cos near -1 magnifies it to a few ulps
            np.testing.assert_allclose(np.float32(got.item()), want,
                                       rtol=1e-6, atol=0)


def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((3, 5)).astype(np.float32),
            "b": rng.standard_normal(7).astype(np.float32)}


@pytest.mark.parametrize("name", ["sgd", "momentum", "adam", "adam_fused"])
def test_optimizer_updates_match_jax(name, monkeypatch):
    monkeypatch.setattr(jops, "fused_adam", _jax_fused_adam_oracle)
    sched = (TO.warmup_cosine(1e-2, 1, 5), JO.warmup_cosine(1e-2, 1, 5))
    make = {"sgd": lambda m, s: m.sgd(s, weight_decay=0.01),
            "momentum": lambda m, s: m.momentum(s, nesterov=True),
            "adam": lambda m, s: m.adam(s, weight_decay=0.01),
            "adam_fused": lambda m, s: m.adam(s, fused=True)}[name]
    topt, jopt = make(TO, sched[0]), make(JO, sched[1])
    params = _opt_tree(0)
    tp = TT.tree_map(lambda a: torch.from_numpy(a.copy()), params)
    jp = jax.tree.map(jnp.asarray, params)
    ts, js = topt.init(tp), jopt.init(jp)
    for t in range(3):
        g = _opt_tree(10 + t)
        tp, ts = topt.update(TT.tree_map(torch.from_numpy, g), ts, tp,
                             torch.tensor(t, dtype=torch.int32))
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp,
                             jnp.asarray(t, jnp.int32))
    for a, b in zip(TT.leaves((tp, ts)), jax.tree.leaves((jp, js))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)


def test_fused_adam_rejects_weight_decay_and_template_is_meta():
    with pytest.raises(ValueError, match="weight_decay"):
        TO.adam(1e-3, weight_decay=0.1, fused=True)
    params = {"w": torch.zeros(3, 4, dtype=torch.bfloat16)}
    tmpl = TO.state_template(TO.adam(1e-3), params)
    assert tmpl["m"]["w"].device.type == "meta"
    assert tmpl["v"]["w"].shape == (3, 4)
    assert tmpl["v"]["w"].dtype == torch.float32
    assert TO.state_template(TO.sgd(1e-3), params) == {}


# ---------------------------------------------------------------------------
# the train step against the JAX step
# ---------------------------------------------------------------------------
def _jax_fused_adam_oracle(p, g, m, v, lr, t, b1=0.9, b2=0.999, eps=1e-8):
    """The JAX fused-Adam kernel's oracle, in place of the kernel (its
    interpret mode would unroll thousands of grid steps at trace time)."""
    return fused_adam_ref(p, g, m, v, lr, b1=b1, b2=b2, eps=eps, t=t)


def _jax_comp(name):
    if name == "none":
        return None
    kw = {"ratio": 0.01} if name == "topk" else {}
    return dataclasses.replace(jget_compressor(name, **kw), fused_encode=None)


STEPS = 5


@pytest.mark.parametrize("fused_adam", [False, True])
@pytest.mark.parametrize("comp", ["none", "onebit", "topk"])
def test_train_history_matches_jax(comp, fused_adam, monkeypatch):
    monkeypatch.setattr(jops, "fused_adam", _jax_fused_adam_oracle)
    jcfg, tcfg = cfgs("qwen2-1.5b")
    jcomm, tcomm = JLocalComm(W), LocalComm(W)
    jsched = JO.warmup_cosine(1e-3, 1, STEPS)
    tsched = TO.warmup_cosine(1e-3, 1, STEPS)
    jopt = JO.adam(jsched, fused=fused_adam)
    topt = TO.adam(tsched, fused=fused_adam)
    jstrat = jsync(compressor=_jax_comp(comp))
    tstrat = sync(compressor=None if comp == "none" else get_compressor(
        comp, **({"ratio": 0.01} if comp == "topk" else {})))

    params = jcomm.replicate(to_jax(np_params(jcfg, seed=2)))
    jstate = JLOOP.init_train_state(params, jopt, jstrat, jcomm)
    tstate = train_state_from_numpy(
        jax.tree.map(np.asarray, jstate), "cpu")

    jloss = JLOOP.make_loss_fn(jcfg, remat=False)
    tloss = TLOOP.make_loss_fn(tcfg, remat=False)
    jstep = JLOOP.make_replica_train_step(
        lambda p, x: jloss(p, {"tokens": x, "labels": x}), jopt, jstrat,
        jcomm)
    tstep = TLOOP.make_replica_train_step(
        lambda p, x: tloss(p, {"tokens": x, "labels": x}), topt, tstrat,
        tcomm)
    dcfg = JDataConfig(vocab_size=jcfg.vocab_size, seq_len=32,
                       batch_per_worker=2)
    for t in range(STEPS):
        toks = np.array(jworker_batches(dcfg, W, t))
        jstate, jm = jstep(jstate, jnp.asarray(toks))
        tstate, tm = tstep(tstate, torch.from_numpy(toks))
        assert tm["wire_bytes"].item() == float(jm["wire_bytes"])
        assert tm["replica_divergence"].item() == 0.0
        assert float(jm["replica_divergence"]) == 0.0
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   rtol=1e-4)
    assert int(tstate["step"]) == STEPS
    assert set(tstate["comm_state"]) == set(jstate["comm_state"])


def test_step_mutates_fused_state_like_a_donated_step():
    _, tcfg = cfgs("qwen2-1.5b")
    tcfg = dataclasses.replace(tcfg, num_layers=1, d_model=32, head_dim=8,
                               d_ff=64, vocab_size=64)
    comm = LocalComm(2)
    params = comm.replicate(TM.init_model(torch.Generator().manual_seed(0),
                                          tcfg, "cpu"))
    opt = TO.adam(1e-3, fused=True)
    state = TLOOP.init_train_state(params, opt, sync(), comm)
    before = state["params"]["embed"].clone()
    loss = TLOOP.make_loss_fn(tcfg, remat=False)
    step = TLOOP.make_replica_train_step(
        lambda p, x: loss(p, {"tokens": x, "labels": x}), opt, sync(), comm)
    new, m = step(state, torch.zeros((2, 2, 8), dtype=torch.int32))
    assert new["params"]["embed"] is state["params"]["embed"]
    assert not torch.equal(before, new["params"]["embed"])
    assert set(m) == {"wire_bytes", "comm_events", "loss",
                      "replica_divergence"}


def test_strategy_registry_holds_what_is_ported():
    from repro.core.strategies import REGISTRY as JREGISTRY
    from repro_torch.core.strategies import REGISTRY

    assert get_strategy("sync").name == "sync"
    assert get_strategy("sync", compressor=get_compressor("onebit")) \
        .wire_profile == "compressed"
    assert get_strategy("gossip").name == "gossip"
    assert sorted(REGISTRY) == sorted(JREGISTRY)  # every strategy ported
    z3 = get_strategy("sync_zero3")
    assert z3.owns_params and z3.partitioned_accum
    assert get_strategy("sync_zero1").wire_profile == "partitioned"
    with pytest.raises(KeyError):
        get_strategy("sync_zero4")


def test_bridge_round_trips_a_bf16_train_state_with_master_and_scale():
    """A train state of the JAX package under the bf16 policy (bf16
    params, f32 master, loss scale {"scale" f32, "good_steps" int32})
    through the bridge and back, bitwise."""
    from repro.core.precision import get_policy as jget_policy

    jcfg, _ = cfgs("qwen2-1.5b")
    jcomm, pol = JLocalComm(2), jget_policy("bf16")
    opt = JO.adam(1e-3)
    strat = jsync(compressor=jget_compressor("onebit"), policy=pol)
    state = JLOOP.init_train_state(
        jcomm.replicate(pol.cast_to_param(to_jax(np_params(jcfg)))), opt,
        strat, jcomm, policy=pol)
    np_state = jax.tree.map(np.asarray, state)
    np_state["loss_scale"]["good_steps"] = np.asarray(7, np.int32)
    tstate = train_state_from_numpy(np_state, "cpu")
    assert tstate["params"]["embed"].dtype == torch.bfloat16
    assert tstate["master"]["embed"].dtype == torch.float32
    assert tstate["loss_scale"]["scale"].dtype == torch.float32
    assert tstate["loss_scale"]["good_steps"].dtype == torch.int32
    back = train_state_to_numpy(tstate)
    assert jax.tree.structure(back) == jax.tree.structure(np_state)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_state)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                      b.reshape(-1).view(np.uint8))


def test_bridge_round_trips_a_train_state():
    jcfg, _ = cfgs("qwen2-1.5b")
    jcomm = JLocalComm(2)
    opt, strat = JO.adam(1e-3), jsync(
        compressor=jget_compressor("onebit"))
    state = JLOOP.init_train_state(
        jcomm.replicate(to_jax(np_params(jcfg))), opt, strat, jcomm)
    np_state = jax.tree.map(np.asarray, state)
    back = train_state_to_numpy(train_state_from_numpy(np_state, "cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(np_state)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_state)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------
def test_worker_batches_are_reproducible_affine_streams():
    cfg = DataConfig(vocab_size=97, seq_len=64, batch_per_worker=3, seed=5)
    a = worker_batches(cfg, 4, 7, device="cpu")
    assert a.shape == (4, 3, 64) and a.dtype == torch.int32
    assert torch.equal(a, worker_batches(cfg, 4, 7, device="cpu"))
    assert not torch.equal(a, worker_batches(cfg, 4, 8, device="cpu"))
    assert int(a.min()) >= 0 and int(a.max()) < 97
    succ = (cfg.a * a[..., :-1].long() + cfg.b) % 97 == a[..., 1:].long()
    assert 0.8 < succ.float().mean().item() < 0.97  # structure 0.9
    jcfg = JDataConfig(vocab_size=97, seq_len=64, batch_per_worker=3)
    assert bayes_entropy(cfg) == jbayes_entropy(jcfg)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
def _misfit_checkpoint(tmp_path):
    """A directory whose newest valid step is a ZeRO-1 save at W = 2 with
    the port's default buckets, which a ``--zero-stage 3`` run (param
    shards expected) cannot take."""
    d = tmp_path / "misfit"
    CLI.main(["--reduced", "--device", "cpu", "--steps", "1", "--workers",
              "2", "--batch-per-worker", "1", "--seq-len", "8",
              "--zero-stage", "1", "--ckpt-dir", str(d)])
    return ["--workers", "2", "--batch-per-worker", "1", "--seq-len", "8",
            "--steps", "2", "--zero-stage", "3", "--ckpt-dir", str(d),
            "--resume", "auto"]


@pytest.mark.parametrize("argv,msg", [
    (["--arch", "bogus"], "unknown arch 'bogus'"),
    (["--zero-stage", "1", "--strategy", "local_sgd"],
     "--zero-stage 1 conflicts with --strategy local_sgd"),
    (["--resume", "auto"], "--resume auto requires --ckpt-dir"),
    ("empty", "--resume auto: no valid checkpoint step in"),
    ("misfit", "--resume auto: checkpoint step 1 does not match this run's "
               "strategy/layout"),
])
def test_cli_exit_2_paths(argv, msg, capsys, tmp_path):
    if argv == "empty":
        (tmp_path / "empty").mkdir()
        argv = ["--steps", "1", "--ckpt-dir", str(tmp_path / "empty"),
                "--resume", "auto"]
    elif argv == "misfit":
        argv = _misfit_checkpoint(tmp_path)
        capsys.readouterr()
    with pytest.raises(SystemExit) as e:
        CLI.main(["--reduced", "--device", "cpu"] + argv)
    assert e.value.code == 2
    err = capsys.readouterr().err.strip()
    assert msg in err and len(err.splitlines()) == 1


@pytest.mark.parametrize("argv,strategy,wire", [
    (["--zero-stage", "1"], "sync_zero1", 4 * 2 * 1_313_024),
    # 2 reduce-scatters and 1 all-gather, each half the flat bytes
    (["--strategy", "sync_zero2", "--accum-steps", "2"], "sync_zero2",
     1.5 * 4 * 2 * 1_313_024),
    (["--zero-stage", "3", "--strategy", "sync_zero3", "--precision",
      "bf16"], "sync_zero3", 2 * 2 * 1_313_024),
])
def test_cli_runs_the_zero_strategies_on_cpu(argv, strategy, wire, capsys):
    """``--zero-stage N`` and ``--strategy sync_zeroN`` train; the printed
    params count the model, not ZeRO-3's shards; wire bytes are the dense
    all-reduce's (W = 2, 1,313,024 params), halved on the bf16 wire."""
    hist = CLI.main(["--reduced", "--device", "cpu", "--steps", "2",
                     "--log-every", "1", "--workers", "2",
                     "--batch-per-worker", "2", "--seq-len", "16",
                     "--fused-adam"] + argv)
    text = capsys.readouterr().out
    assert f"params=1,313,024 strategy={strategy} " in text
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    assert all(h["divergence"] == 0.0 for h in hist)
    assert hist[-1]["wire_bytes"] == wire


@pytest.mark.parametrize("argv,fields", [
    (["--precision", "bf16"], "precision=bf16 workers=2 accum_steps=1 "
                              "global_batch=4 prefetch_depth=2"),
    (["--accum-steps", "2", "--prefetch-depth", "1"],
     "precision=f32 workers=2 accum_steps=2 global_batch=8 "
     "prefetch_depth=1"),
])
def test_cli_runs_precision_and_accum_flags_on_cpu(argv, fields, capsys):
    """The flags that exited 2 before this slice now train."""
    hist = CLI.main(["--reduced", "--device", "cpu", "--steps", "2",
                     "--log-every", "1", "--workers", "2",
                     "--batch-per-worker", "2", "--seq-len", "16"] + argv)
    text = capsys.readouterr().out
    assert fields in text and len(hist) == 2
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert ("loss_scale" in hist[-1]) == ("bf16" in argv)
    if "bf16" in argv:
        assert hist[-1]["loss_scale"] == 2.0 ** 15
        assert hist[-1]["wire_bytes"] == 2 * 2 * 1_313_024  # 2 B, W = 2


def test_cli_flag_choices_are_the_reference_names():
    from repro.launch.train import build_argparser as jbuild

    def table(ap):
        return {a.dest: (a.default, a.choices) for a in ap._actions}

    ours, ref = table(CLI.build_argparser()), table(jbuild())
    assert ours.pop("device") == ("cuda", None)
    assert ours == ref


def test_cli_trains_on_cpu_and_writes_history(tmp_path, capsys):
    out = tmp_path / "h.json"
    hist = CLI.main(["--reduced", "--device", "cpu", "--steps", "2",
                     "--log-every", "1", "--workers", "2",
                     "--batch-per-worker", "2", "--seq-len", "16",
                     "--compressor", "onebit", "--fused-adam",
                     "--out", str(out)])
    text = capsys.readouterr().out
    assert text.startswith("arch=qwen2-1.5b-reduced params=1,313,024 "
                           "strategy=sync precision=f32 workers=2 ")
    assert "step     1 loss " in text and " wireB 348772 " in text
    assert json.loads(out.read_text()) == hist and len(hist) == 2
    assert hist[-1]["divergence"] == 0.0
    assert hist[-1]["wire_bytes_per_sample"] == 348772 / 4
    assert np.isfinite(hist[-1]["loss"])


def test_cli_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda.is_available"):
        CLI.main(["--reduced", "--steps", "1"])
