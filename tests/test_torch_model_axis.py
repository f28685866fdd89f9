"""The "model" mesh axis for the recurrent and encoder-decoder families, a
strategy on a data x model mesh, and context parallelism (``cp``), on the
CPU against the port's own blocked forms and one-rank steps and against
the JAX package's unsharded forward and ``jax.grad``.

Inputs are numpy from a seed (``test_torch_layers.np_params``) handed to
both packages.  One pool of 4 gloo ranks (``tests/_torch_axis_ranks.py``)
runs every rank case while this process runs the references:

  * the blocked forms at ``tp_degree`` 2 (Mamba's channel blocks with its
    two combines, mLSTM's head blocks with the out-norm's, cross
    attention's head blocks) on jamba ``.reduced()`` without experts cut
    to one attention and one Mamba layer, xlstm-125m ``.reduced()`` and
    seamless-m4t-medium ``.reduced()``, against the reference's unsharded
    forward and ``jax.grad`` of its loss (the reference has no blocked
    form for these: its pjit placement is held to its unsharded forward
    by its own test);
  * the TP ranks (model 2) against the blocked form: forward, memory and
    loss bitwise; gradients within measured bounds (the residual stream's
    cotangent sums in another association, ``tensor_parallel.py``);
  * a strategy on data 2 x model 2 (and the hierarchy on pod 2 x data 1
    x model 2): bitwise the strategy's stacked exchange fed the ranks'
    own gradients, part by part; the replicated leaves equal on both
    model ranks after every step; and within ``STRATEGY_BOUNDS`` of the
    replica step at ``tp_degree`` 2 run per (model rank, part);
  * ``cp`` on data 2 x model 2 against the unsharded loss and gradients
    (the port's and JAX's) and the port's one-rank step, the boundary
    targets included;
  * ``cp`` for the MoE families and the encoder-decoder on data 2 x
    model 2: the MoE's dense branch (granite and qwen2-moe ``.reduced()``
    with its shared expert) and seamless ``.reduced()`` against JAX's
    unsharded forward and ``jax.grad`` of each data rank's rows; the
    ``_moe_ep`` branch (granite at 4096 global tokens) against the JAX
    package's own ``cp`` program (``T.forward`` and ``jax.grad`` jitted
    under a (2, 2) ("data", "model") mesh of host devices, in a
    subprocess), whose drops and aux are ``_moe_ep``'s slice-local ones
    and not its unsharded forward's; each rank's MoE output against the
    port's tp-mode ``_moe_ep`` on the same whole rows; the collectives
    against their closed form.
"""

import dataclasses
import os
import pickle
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import _torch_axis_ranks as AR
import _torch_ranks as R
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_layers import np_params

from repro.configs import get_config as jax_config
from repro.models import transformer as JT
from repro.train import loop as JLOOP
from repro_torch.bridge import params_from_numpy, rank_state
from repro_torch.core import tree as T
from repro_torch.data import pipeline as P
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import tensor_parallel as TP
from repro_torch.models import transformer as TT
from repro_torch.train import loop as TL
from repro_torch.train.losses import cross_entropy

pytestmark = pytest.mark.torch

TP_N = AR.TP_N
# the blocked forms against the reference's unsharded forward, f32: the
# logits within LOGITS_ATOL, the loss at rtol 1e-5 and every leaf's
# gradient within LEAF_RTOL of its largest |g| (the recurrent training
# tests' bound: the packages sum in other orders, and the blocked forms
# regroup the combines' sums).  Readings on the CPU: logits ≤ 8.4e-6,
# the loss 1.4e-7 relative, gradients ≤ 5.9e-6 of their leaf's largest.
LOGITS_ATOL, LEAF_RTOL = 2e-5, 1e-4
# the TP ranks' gradients against the blocked form's: split leaves
# within SPLIT_RTOL of each leaf's largest |g|, the replicated partials
# summing within REP_RTOL of it (readings: 1.0e-6 and 8.0e-7, xlstm's)
SPLIT_RTOL, REP_RTOL = 4e-6, 4e-6
# a strategy on the model axis against the replica step at tp_degree 2,
# run per (model rank, part), under momentum: (every element within atol,
# share of elements beyond 1e-6, losses at rtol) beside the CPU readings
# [max |d|, share, loss |d| relative].  Uncompressed, the ulps of the
# gradients travel linearly; a 1-bit or top-k block can flip a sign or a
# pick on another run's ulps (none did here), so those two keep the
# 1-bit bounds of tests/test_torch_sharded_step.py::TP_BOUNDS.
STRATEGY_BOUNDS = {
    "local_sgd": (5e-7, 0.0, 1e-6),        # [6.0e-8, 0, 1.1e-7]
    "easgd": (5e-7, 0.0, 1e-6),            # [1.2e-7, 0, 1.2e-7]
    "gossip": (5e-7, 0.0, 1e-6),           # [1.2e-7, 0, 1.2e-7]
    "ssp": (5e-7, 0.0, 1e-6),              # [3.0e-8, 0, 1.2e-7]
    "downpour_onebit": (2e-3, 2e-2, 1e-4),  # [0, 0, 0]
    "sync_dgc_topk": (2e-3, 2e-2, 1e-4),    # [6.0e-8, 0, 0]
}
# cp against the unsharded loss and gradients: the loss at rtol 1e-6,
# every leaf within CP_RTOL of its largest |g| (the port's and JAX's);
# the steps' params within CP_STEP_ATOL (readings: loss 1.3e-7 relative,
# gradients 3.3e-7 of the port's, 5.9e-7 of JAX's, params 3.0e-8)
CP_RTOL, CP_STEP_ATOL = 4e-6, 3e-7
# cp's _moe_ep branch against the JAX package's cp program (the same
# routing and drops, f32 sums in other orders and across devices): the
# logits chunk within CP_EP_LOGITS_ATOL, the loss and the aux (the mean
# over the data ranks) at rtol 1e-6, each leaf's gradient (the mean over
# the data ranks) within CP_RTOL of its largest (readings on the CPU:
# logits 8.1e-6, loss 1.4e-7 and aux 4.0e-8 relative, gradients 1.9e-6
# of the leaf's largest)
CP_EP_LOGITS_ATOL = 2e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg(case, tp_degree=1):
    arch, over, *_ = AR.FAMILIES[case]
    return dataclasses.replace(jax_config(arch).reduced(), **over,
                               tp_degree=tp_degree)


def _family_batch(case, seed):
    _, _, b, l, s = AR.FAMILIES[case]
    cfg = _jcfg(case)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, l)).astype(np.int32)
    out = {"tokens": toks, "labels": toks}
    if s:
        out["source_embeds"] = (0.02 * rng.standard_normal(
            (b, s, cfg.d_model))).astype(np.float32)
    return out


def _strategy_tokens(world=2):
    d = P.DataConfig(vocab_size=R.CUT["vocab_size"], seq_len=R.SEQ,
                     batch_per_worker=R.BPW)
    return [P.worker_batches(d, world, t, "cpu").numpy()
            for t in range(R.STEPS)]


def _cp_family_jcfg(case):
    return dataclasses.replace(jax_config(AR.CP_FAMILIES[case][0]).reduced(),
                               sharding_mode="cp")


def _cp_family_batch(case, seed):
    """Two rows (one a data rank) of tokens and, for the encoder-decoder,
    source frames (normal x 0.02)."""
    _, l, s = AR.CP_FAMILIES[case]
    cfg = _cp_family_jcfg(case)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (2, l)).astype(np.int32)
    out = {"tokens": toks, "labels": toks}
    if s:
        out["source_embeds"] = (0.02 * rng.standard_normal(
            (2, s, cfg.d_model))).astype(np.float32)
    return out


JAX_CP_SCRIPT = r'''
import dataclasses, pickle, sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_config
from repro.core.jax_compat import make_mesh, set_mesh
from repro.models import layers as L
from repro.models import transformer as T
from repro.train import loop as LOOP

inp = pickle.load(open(sys.argv[1], "rb"))
cfg = dataclasses.replace(get_config(inp["arch"]).reduced(),
                          sharding_mode="cp")
p = jax.tree.map(jnp.asarray, inp["params"])
toks = jnp.asarray(inp["tokens"])
mesh = make_mesh((2, 2), ("data", "model"))
xs, moe = [], L.moe


def spy(pm, c, x):  # each MoE layer's input, gathered to the host
    jax.debug.callback(lambda v: xs.append(np.asarray(v)), x)
    return moe(pm, c, x)


L.moe = spy
with set_mesh(mesh):
    logits, aux = jax.jit(lambda p, t: T.forward(p, cfg, tokens=t))(p, toks)
    logits = np.asarray(logits)
L.moe = moe
with set_mesh(mesh):
    loss, g = jax.jit(jax.value_and_grad(LOOP.make_loss_fn(cfg, remat=False)))(
        p, {"tokens": toks, "labels": toks})
# the rows each (data, model) slice keeps, as _moe_ep routes them: the
# data rank's row, the model rank's half of its tokens
b, l, d = xs[0].shape
t_slice = (b // 2) * l // 2
k, e_pad = cfg.top_k, cfg.num_experts_padded
cap = int(max(k, round(t_slice * k / e_pad * cfg.capacity_factor)))
cap = -(-cap // 8) * 8
kept = []
for i, x in enumerate(xs):
    pm = jax.tree.map(lambda a: a[i], p["stack"]["0"]["moe"])
    per = {}
    for di in range(2):
        xt = jnp.asarray(x[di * (b // 2):(di + 1) * (b // 2)]).reshape(-1, d)
        for mi in range(2):
            sl = xt[mi * t_slice:(mi + 1) * t_slice]
            per[(di, mi)] = int(jnp.sum(L._route(pm, cfg, sl, e_pad, cap)[2]))
    kept.append(per)
pickle.dump({"logits": logits, "aux": float(aux), "loss": float(loss),
             "grads": jax.tree.map(np.asarray, g), "kept": kept,
             "slice_rows": t_slice * k}, open(sys.argv[2], "wb"))
print("JAX_CP_OK")
'''


def _start_jax_cp(params_np, batch):
    """The JAX package's cp program on ``granite_ep`` in a subprocess on 4
    forced host devices: (the process, its output pickle)."""
    tmp = tempfile.mkdtemp(prefix="cp-")
    src, dst = os.path.join(tmp, "in.pkl"), os.path.join(tmp, "out.pkl")
    with open(src, "wb") as f:
        pickle.dump({"arch": AR.CP_FAMILIES["granite_ep"][0],
                     "params": params_np, "tokens": batch["tokens"]}, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=os.environ.get("XLA_FLAGS", "")
               + " --xla_force_host_platform_device_count=4")
    proc = subprocess.Popen([sys.executable, "-c", JAX_CP_SCRIPT, src, dst],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, dst


def _finish_jax_cp(proc, dst):
    try:
        out, err = proc.communicate(timeout=500)
        assert proc.returncode == 0 and "JAX_CP_OK" in out, err[-3000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    with open(dst, "rb") as f:
        return pickle.load(f)


def _cp_tokens():
    d = P.DataConfig(vocab_size=R.CUT["vocab_size"], seq_len=AR.CP_L,
                     batch_per_worker=R.BPW)
    return [P.worker_batches(d, 2, t, "cpu").numpy() for t in range(R.STEPS)]


def _port_grads(cfg, params, batch, remat=False):
    leaves, tdef = T.flatten(params)
    pw = [x.detach().clone().requires_grad_() for x in leaves]
    loss = TL.make_loss_fn(cfg, remat=remat)(T.unflatten(tdef, pw), batch)
    return loss.detach(), T.unflatten(tdef, list(torch.autograd.grad(loss,
                                                                     pw)))


def _jax_grads(jcfg, params_np, batch):
    jl, jg = jax.value_and_grad(JLOOP.make_loss_fn(jcfg, remat=False))(
        jax.tree.map(jnp.asarray, params_np),
        {k: jnp.asarray(v) for k, v in batch.items()})
    return float(jl), jg


def _named(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_named(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _jnamed(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _ratio(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    scale = float(np.abs(b).max())
    return float(np.abs(a - b).max()) / scale if scale else \
        float(np.abs(a).max())


@pytest.fixture(scope="module")
def runs():
    params = {case: np_params(_jcfg(case), seed=40 + i)
              for i, case in enumerate(AR.FAMILIES)}
    batches = {case: _family_batch(case, 50 + i)
               for i, case in enumerate(AR.FAMILIES)}
    jstrat = dataclasses.replace(jax_config("qwen2-1.5b").reduced(),
                                 **dict(R.CUT, num_heads=4, num_kv_heads=2))
    params["strategy"] = np_params(jstrat, seed=60)
    params["cp"] = np_params(dataclasses.replace(jstrat, sharding_mode="cp"),
                             seed=61)
    for i, case in enumerate(AR.CP_FAMILIES):
        params[case] = np_params(_cp_family_jcfg(case), seed=70 + i)
    cp_batch = {case: _cp_family_batch(case, 80 + i)
                for i, case in enumerate(AR.CP_FAMILIES)}
    s_tokens, cp_tokens = _strategy_tokens(), _cp_tokens()
    inputs = {"params": params, "batch": batches,
              "strategy_tokens": s_tokens, "cp_tokens": cp_tokens,
              "cp_batch": cp_batch}
    jax_cp = _start_jax_cp(params["granite_ep"], cp_batch["granite_ep"])
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(run_ranks, AR.axis_pool, 4, args=(inputs,),
                          device="cpu", timeout=600)
        blocked, jaxs = {}, {}
        for case in AR.FAMILIES:
            cfg = AR.family_cfg(case)
            tp_ = params_from_numpy(params[case], "cpu")
            batch = {k: torch.from_numpy(v) for k, v in batches[case].items()}
            with torch.no_grad():
                memory = (TT.encode(tp_, cfg, embeds=batch["source_embeds"],
                                    kernel=False)
                          if cfg.is_encoder_decoder else None)
                logits, _ = TT.forward(tp_, cfg, tokens=batch["tokens"],
                                       memory=memory)
            loss, grads = _port_grads(cfg, tp_, batch)
            blocked[case] = {"logits": logits, "memory": memory,
                             "loss": loss, "grads": grads}
            jcfg = _jcfg(case)
            jp = jax.tree.map(jnp.asarray, params[case])
            jmem = (JT.encode(jp, jcfg,
                              embeds=jnp.asarray(batches[case]["source_embeds"]))
                    if jcfg.is_encoder_decoder else None)
            jlog = JT.forward(jp, jcfg, jnp.asarray(batches[case]["tokens"]),
                              memory=jmem)[0]
            jl, jg = _jax_grads(jcfg, params[case], batches[case])
            jaxs[case] = {"logits": np.asarray(jlog), "loss": jl,
                          "grads": _jnamed(jg)}
        s_replica = {c: AR.strategy_replica_run(params["strategy"], c,
                                                s_tokens)
                     for c in AR.STRATEGIES}
        cp_ref = {"port": [], "jax": []}
        ccfg = AR.cp_cfg()
        jccfg = dataclasses.replace(jstrat, sharding_mode="cp")
        for d in range(2):
            b = {"tokens": cp_tokens[0][d], "labels": cp_tokens[0][d]}
            cp_ref["port"].append(_port_grads(
                ccfg, params_from_numpy(params["cp"], "cpu"),
                {k: torch.from_numpy(v) for k, v in b.items()}))
            jl, jg = _jax_grads(jccfg, params["cp"], b)
            cp_ref["jax"].append((jl, _jnamed(jg)))
        cp_ref["steps"] = AR.cp_replica_run(params["cp"], cp_tokens)
        cp_family_ref = {
            case: [_jax_grads(_cp_family_jcfg(case), params[case],
                              {k: v[d:d + 1]
                               for k, v in cp_batch[case].items()})
                   for d in range(2)]
            for case in AR.CP_FAMILIES if case != "granite_ep"}
        ranks = fut.result()
    jax_cp = _finish_jax_cp(*jax_cp)
    by = {r["coords"]: r for r in ranks}
    exchange = {}
    for case in AR.STRATEGIES:
        grads = {key: by[key]["strategies"][case]["grads"] for key in by}
        exchange[case] = AR.exchange_reference(params["strategy"], case,
                                               grads)
    hgrads = {(key[0], key[1]): by[key]["hier"]["grads"] for key in by}
    exchange[AR.HIER] = AR.exchange_reference(params["strategy"], AR.HIER,
                                              hgrads)
    return {"params": params, "batches": batches, "blocked": blocked,
            "jax": jaxs, "by": by, "s_replica": s_replica,
            "exchange": exchange, "cp_ref": cp_ref,
            "cp_family_ref": cp_family_ref, "jax_cp": jax_cp}


FAMILY_CASES = sorted(AR.FAMILIES)


# ---------------------------------------------------------------------------
# the split: path-aware, round trips, every split leaf has its combine
# ---------------------------------------------------------------------------
# the split leaves of each mixer (a path inside the mixer's subtree)
SPLIT_BY_MIXER = {
    "attn": {"wq", "wk", "wv", "wo"},
    "cross_attn": {"wq", "wk", "wv", "wo"},
    "mlp": {"w_gate", "w_up", "w_down"},
    "mamba": {"in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias",
              "A_log", "D", "out_proj"},
    "mlstm": {"wq", "wk", "wv", "w_igate", "w_fgate", "fgate_bias",
              "out_norm/scale", "out_proj"},
    "slstm": set(),
}


@pytest.mark.parametrize("case", FAMILY_CASES)
def test_split_round_trips_and_follows_the_mixer(runs, case):
    """``tp_unsplit_ranks(tp_rank_params(p))`` and the stacked pair give
    back every leaf bitwise; the split leaves of each mixer are exactly
    its table's (an mLSTM or cross-attention leaf is split only where its
    layer combines; the sLSTM stays whole); Mamba's ``in_proj`` block of
    each half sits side by side."""
    full = params_from_numpy(runs["params"][case], "cpu")
    ranks = [TP.tp_rank_params(full, TP_N, r) for r in range(TP_N)]
    for a, b in zip(T.leaves(TP.tp_unsplit_ranks(ranks)), T.leaves(full)):
        assert torch.equal(a, b)
    for a, b in zip(T.leaves(TP.tp_unsplit_params(
            TP.tp_split_params(full, TP_N))), T.leaves(full)):
        assert torch.equal(a, b)
    _, split = TP._partition_replicated(ranks[0])
    seen = {}
    for path in _named(split):
        parts = path.split("/")
        mixer = next(p for p in parts if p in SPLIT_BY_MIXER)
        inner = "/".join(parts[parts.index(mixer) + 1:])
        seen.setdefault(mixer, set()).add(inner)
    mixers = {s.mixer for s in AR.family_cfg(case).superblock()[0]}
    for mixer in mixers | {"mlp"} & set(seen):
        assert seen.get(mixer, set()) == SPLIT_BY_MIXER[mixer], mixer
    if case == "seamless":
        assert seen["cross_attn"] == SPLIT_BY_MIXER["cross_attn"]
        assert any(p.startswith("encoder/") for p in _named(split))
    if case == "xlstm":
        assert "slstm" not in seen
    if case == "jamba":
        w = full["stack"]["1"]["mamba"]["in_proj"]  # (1, D, 2 d_in)
        d_in = w.shape[-1] // 2
        b = d_in // TP_N
        for r in range(TP_N):
            got = ranks[r]["stack"]["1"]["mamba"]["in_proj"]
            assert torch.equal(got[..., :b], w[..., r * b:(r + 1) * b])
            assert torch.equal(got[..., b:],
                               w[..., d_in + r * b:d_in + (r + 1) * b])


# ---------------------------------------------------------------------------
# the blocked forms against the reference's unsharded forward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", FAMILY_CASES)
def test_blocked_form_matches_jax_unsharded(runs, case):
    got, want = runs["blocked"][case], runs["jax"][case]
    np.testing.assert_allclose(got["logits"].numpy(), want["logits"],
                               rtol=0, atol=LOGITS_ATOL)
    np.testing.assert_allclose(float(got["loss"]), want["loss"], rtol=1e-5)
    names = _named(got["grads"])
    assert set(names) == set(want["grads"])
    bad = {k: r for k in names
           if (r := _ratio(names[k].numpy(), want["grads"][k])) > LEAF_RTOL}
    assert not bad, bad
    # the blocked form is not the single path: it regroups the sums
    single = dataclasses.replace(AR.family_cfg(case), tp_degree=1)
    tp_ = params_from_numpy(runs["params"][case], "cpu")
    batch = {k: torch.from_numpy(v) for k, v in runs["batches"][case].items()}
    with torch.no_grad():
        loss1 = TL.make_loss_fn(single, remat=False)(tp_, batch)
    np.testing.assert_allclose(float(loss1), float(got["loss"]), rtol=1e-5)


# ---------------------------------------------------------------------------
# the TP ranks against the blocked form
# ---------------------------------------------------------------------------
def _model_ranks(runs):
    return [runs["by"][(0, m)]["families"] for m in range(TP_N)]


def _forward_combines(case):
    """All-sums of one forward (the encoder's included): one a layer for
    attention (self and cross) and the MLP, two for Mamba and mLSTM, none
    for the sLSTM."""
    cfg = AR.family_cfg(case)
    specs, repeat = cfg.superblock()
    per = {"attn": 1, "mamba": 2, "mlstm": 2, "slstm": 0}
    n = 0
    for s in specs:
        n += per[s.mixer] + (1 if s.ffn == "mlp" else 0)
        n += 1 if cfg.is_encoder_decoder else 0  # cross attention
    n *= repeat
    if cfg.is_encoder_decoder:
        n += 2 * cfg.num_encoder_layers
    return n


@pytest.mark.parametrize("case", FAMILY_CASES)
def test_tp_rank_forward_memory_and_loss_bitwise_blocked(runs, case):
    want = runs["blocked"][case]
    for m, fam in enumerate(_model_ranks(runs)):
        got = fam[case]
        assert torch.equal(got["logits"], want["logits"]), m
        if want["memory"] is not None:  # the memory on every model rank
            assert torch.equal(got["memory"], want["memory"]), m
        for remat in (False, True):
            assert torch.equal(got[remat]["loss"], want["loss"]), (m, remat)
        assert got["fwd_psums"] == _forward_combines(case)


@pytest.mark.parametrize("case", FAMILY_CASES)
def test_tp_rank_gradients_against_the_blocked_form(runs, case):
    """Split leaves: the blocked form's slices; replicated leaves: the
    ranks' partials sum to it, ``finalize_grads`` gives it on every rank;
    remat's gradients bitwise those without on each rank."""
    fams = _model_ranks(runs)
    ref = runs["blocked"][case]["grads"]
    ref_named = _named(ref)
    want_split = _named(TP.tp_split_params(ref, TP_N))
    rep_names = set(_named(TP._partition_replicated(ref)[0]))
    got = [_named(f[case][False]["grads"]) for f in fams]
    final = [_named(f[case][False]["final"]) for f in fams]
    for f in fams:
        for a, b in zip(T.leaves(f[case][True]["grads"]),
                        T.leaves(f[case][False]["grads"])):
            assert torch.equal(a, b)
    split_err = rep_err = 0.0
    for k, r in ref_named.items():
        if k in rep_names:
            total = sum(g[k] for g in got)
            rep_err = max(rep_err, _ratio(total.numpy(), r.numpy()))
            for m in range(1, TP_N):
                assert torch.equal(final[m][k], final[0][k]), k
            assert _ratio(final[0][k].numpy(), r.numpy()) <= REP_RTOL, k
        else:
            for m in range(TP_N):
                split_err = max(split_err, _ratio(got[m][k].numpy(),
                                                  want_split[k][m].numpy()))
                assert torch.equal(final[m][k], got[m][k]), k
    assert split_err <= SPLIT_RTOL, split_err
    assert rep_err <= REP_RTOL, rep_err


# ---------------------------------------------------------------------------
# a strategy on the model axis
# ---------------------------------------------------------------------------
def _strategy_result(runs, case, key):
    r = runs["by"][key]
    return r["hier"] if case == AR.HIER else r["strategies"][case]


@pytest.mark.parametrize("case", AR.STRATEGIES + [AR.HIER])
def test_strategy_exchange_bitwise_the_stacked_exchange(runs, case):
    """Each rank's params and optimizer state, part by part, bitwise the
    strategy's stacked exchange (``LocalComm`` over the batch group) fed
    the ranks' own gradients; the replicated leaves equal on both model
    ranks of a batch rank after every step, and the loss equal on every
    rank."""
    ref = runs["exchange"][case]
    losses = None
    for (b, m), r in runs["by"].items():
        got = _strategy_result(runs, case, (b, m))
        assert got["parts"] == ["rep", "split"]
        for n in ("rep", "split"):
            st = ref[(m, n)]
            if case == AR.HIER:
                st = {k: T.tree_map(lambda x: x.reshape((2,) + x.shape[2:]),
                                    v) for k, v in st.items()}
            want = rank_state(st, b)
            for k in ("params", "opt_state"):
                la, lb = T.leaves(got["state"][k][n]), T.leaves(want[k])
                assert len(la) == len(lb) and la
                assert all(torch.equal(x, y) for x, y in zip(la, lb)), \
                    (case, b, m, n, k)
        if m == 1:
            mate = _strategy_result(runs, case, (b, 0))
            for t in range(R.STEPS):
                for x, y in zip(T.leaves(got["reps"][t]),
                                T.leaves(mate["reps"][t])):
                    assert torch.equal(x, y), (case, b, t)
        if losses is None:
            losses = got["losses"]
        assert all(torch.equal(x, y) for x, y in zip(got["losses"], losses))


@pytest.mark.parametrize("case", AR.STRATEGIES)
def test_strategy_matches_the_replica_step(runs, case):
    """Each data rank's unsplit params against the replica step at
    ``tp_degree`` 2 with the same strategy, run per (model rank, part),
    within ``STRATEGY_BOUNDS``."""
    atol, share, loss_rtol = STRATEGY_BOUNDS[case]
    rep = runs["s_replica"][case]
    n = beyond = 0
    for b in range(2):
        got = TP.tp_unsplit_ranks([
            TP._merge_trees(*(runs["by"][(b, m)]["strategies"][case]["state"]
                              ["params"][p] for p in ("rep", "split")))
            for m in range(TP_N)])
        for x, y in zip(T.leaves(got), T.leaves(rep["params"][b])):
            d = (x - y).abs()
            assert float(d.max()) <= atol, (case, float(d.max()))
            n, beyond = n + d.numel(), beyond + int((d > 1e-6).sum())
    assert beyond <= share * n, (beyond, n)
    np.testing.assert_allclose(
        [float(x) for x in runs["by"][(0, 0)]["strategies"][case]["losses"]],
        [float(x) for x in rep["losses"]], rtol=loss_rtol)


# ---------------------------------------------------------------------------
# context parallelism
# ---------------------------------------------------------------------------
def test_cp_loss_and_gradients_match_unsharded(runs):
    """Each rank's loss and all-summed gradients (with and without remat)
    against the unsharded step of its data rank's rows: the port's and
    the reference's; one all-gather of k and one of v a layer forward
    (again in remat's recomputation) and their reduce-scatters backward,
    the loss's all-sum forward and backward; the state one part."""
    cfg = AR.cp_cfg()
    for (d, m), r in runs["by"].items():
        port_loss, port_grads = runs["cp_ref"]["port"][d]
        jl, jg = runs["cp_ref"]["jax"][d]
        for remat in (False, True):
            got = r["cp"][remat]
            np.testing.assert_allclose(float(got["loss"]), float(port_loss),
                                       rtol=1e-6)
            np.testing.assert_allclose(float(got["loss"]), jl, rtol=1e-6)
            names = _named(got["grads"]["rep"])
            pn = _named(port_grads)
            assert set(names) == set(pn) == set(jg)
            for k, g in names.items():
                assert _ratio(g.numpy(), pn[k].numpy()) <= CP_RTOL, k
                assert _ratio(g.numpy(), jg[k]) <= CP_RTOL, k
            ops = got["ops"]
            gathers = 2 * cfg.num_layers
            assert ops["all_gather"][0] == gathers * (2 if remat else 1)
            assert ops["reduce_scatter"][0] == gathers, ops
            assert ops["psum"][0] == 2, ops
        assert r["cp"]["steps"]["parts"] == ["rep"]


def test_cp_boundary_targets_count(runs):
    """The loss's tolerance sees a dropped boundary target: the last
    position of rank 0's chunk predicts rank 1's first token.  Dropping
    those targets moves the unsharded loss by far more than the cp ranks'
    distance from it."""
    cfg = AR.cp_cfg()
    params = params_from_numpy(runs["params"]["cp"], "cpu")
    toks = torch.from_numpy(_cp_tokens()[0][0])
    with torch.no_grad():
        logits, _ = TT.forward(params, cfg, tokens=toks)
    c = AR.CP_L // TP_N
    mask = torch.ones(toks.shape[0], AR.CP_L - 1)
    mask[:, c - 1] = 0.0  # position c - 1 predicts token c
    dropped = cross_entropy(logits[:, :-1], toks[:, 1:], mask)
    full = cross_entropy(logits[:, :-1], toks[:, 1:])
    got = float(runs["by"][(0, 0)]["cp"][False]["loss"])
    assert abs(got - float(full)) <= 1e-6 * abs(float(full))
    assert abs(float(dropped) - float(full)) > 100 * 1e-6 * abs(float(full))


def test_cp_steps_match_the_one_rank_step(runs):
    """3 sync steps under momentum with remat on data 2 x model 2: each
    data rank's params within ``CP_STEP_ATOL`` of the replica step's over
    the same rows with the unsharded loss, equal on both model ranks; the
    losses at rtol 1e-6."""
    ref = runs["cp_ref"]["steps"]
    for (d, m), r in runs["by"].items():
        got = r["cp"]["steps"]
        for x, y in zip(T.leaves(got["params"]), T.leaves(ref["params"][d])):
            assert float((x - y).abs().max()) <= CP_STEP_ATOL
        mate = runs["by"][(d, 0)]["cp"]["steps"]["params"]
        assert all(torch.equal(x, y) for x, y in zip(T.leaves(got["params"]),
                                                     T.leaves(mate)))
        np.testing.assert_allclose([float(x) for x in got["losses"]],
                                   [float(x) for x in ref["losses"]],
                                   rtol=1e-6)


CP_JAX_UNSHARDED = ["granite_dense", "qwen2_moe_dense", "seamless"]


def _moe_layers(case):
    specs, repeat = AR.cp_family_cfg(case).superblock()
    return sum(s.ffn == "moe" for s in specs) * repeat


@pytest.mark.parametrize("case", CP_JAX_UNSHARDED)
def test_cp_family_matches_jax_unsharded(runs, case):
    """The MoE's dense branch (512 global tokens) and the encoder under
    ``cp``: each rank's loss and all-summed gradients against JAX's
    unsharded forward and ``jax.grad`` of its data rank's row (loss rtol
    1e-6, each leaf within CP_RTOL of its largest; CPU readings: loss
    ≤ 7.3e-8 relative, gradients ≤ 2.6e-6 of the leaf's largest).
    Every MoE layer takes ``_moe_dense`` on the data rank's gathered
    rows, at the config's capacity factor, and drops rows there."""
    cfg = AR.cp_family_cfg(case)
    tokens = AR.CP_FAMILIES[case][1]
    for (d, m), r in runs["by"].items():
        got = r["cp_families"][case]
        jl, jg = runs["cp_family_ref"][case][d]
        np.testing.assert_allclose(float(got["loss"]), jl, rtol=1e-6)
        names = _named(got["grads"])
        assert set(names) == set(_jnamed(jg))
        want = _jnamed(jg)
        bad = {k: x for k, g in names.items()
               if (x := _ratio(g.numpy(), want[k])) > CP_RTOL}
        assert not bad, (d, m, bad)
        assert got["parts"] == ["rep"]
        assert got["branch"] == ["dense"] * _moe_layers(case)
        if _moe_layers(case):  # rows dropped
            rows = tokens * cfg.top_k
            assert len(got["kept"]) == _moe_layers(case)
            assert all(k <= rows for k in got["kept"])
            assert sum(got["kept"]) < rows * len(got["kept"]), got["kept"]


def test_cp_moe_ep_matches_the_jax_cp_program(runs):
    """granite ``.reduced()`` at 2048 tokens a data rank (4096 global):
    every rank takes ``_moe_ep`` on its data rank's gathered rows, as the
    JAX package's cp program does; its logits chunk, its kept rows at
    each (data, model) slice (drops > 0), and over the data ranks the
    mean loss, aux and gradients against that program's."""
    want = runs["jax_cp"]
    cfg = AR.cp_family_cfg("granite_ep")
    n = _moe_layers("granite_ep")
    by = {key: r["cp_families"]["granite_ep"] for key, r in runs["by"].items()}
    dropped = 0
    for (d, m), got in by.items():
        assert got["branch"] == ["ep"] * n
        c = got["logits"].shape[1]
        np.testing.assert_allclose(
            got["logits"].numpy(), want["logits"][d:d + 1, m * c:(m + 1) * c],
            rtol=0, atol=CP_EP_LOGITS_ATOL)
        assert got["kept"] == [want["kept"][i][(d, m)] for i in range(n)]
        dropped += sum(want["slice_rows"] - k for k in got["kept"])
        assert got["loss"] == by[(d, 0)]["loss"]
    assert dropped > 0
    mean = [by[(d, 0)] for d in range(2)]
    np.testing.assert_allclose(np.mean([float(g["loss"]) for g in mean]),
                               want["loss"], rtol=1e-6)
    np.testing.assert_allclose(np.mean([g["aux"] for g in mean]),
                               want["aux"], rtol=1e-6)
    assert cfg.router_aux_coef > 0 and want["aux"] > 0
    grads = {k: (a + b) / 2 for (k, a), b in zip(
        _named(mean[0]["grads"]).items(), _named(mean[1]["grads"]).values())}
    jg = _jnamed(want["grads"])
    assert set(grads) == set(jg)
    bad = {k: x for k, g in grads.items()
           if (x := _ratio(g.numpy(), jg[k])) > CP_RTOL}
    assert not bad, bad


def test_cp_moe_equals_the_tp_mode_moe_ep_chunk(runs):
    """On each rank of the ``_moe_ep`` case every MoE layer's output
    under ``cp`` is bitwise the rank's chunk of the port's tp-mode
    ``moe`` (``_moe_ep``, no context) on the layer's whole rows."""
    n = _moe_layers("granite_ep")
    for key, r in runs["by"].items():
        tp = r["cp_families"]["granite_ep"]["tp_mode"]
        assert tp["branch"] == ["ep"] * n, key
        assert tp["bitwise"] == [True] * n, key
        assert tp["kept"] == r["cp_families"]["granite_ep"]["kept"], key


@pytest.mark.parametrize("case", sorted(AR.CP_FAMILIES))
def test_cp_family_collectives_closed_form(runs, case):
    """The model group's collectives of one step's local gradients: the
    autograd ones (``ShardComm.ops``) equal ``cp_closed_form``, and the
    backend's all-gathers that ``ShardComm.record`` saw are those
    gathers, one for each all-sum and all-mean (a reduce-scatter and an
    all-gather), and one a bucket of ``finalize_grads``."""
    want = AR.cp_closed_form(AR.cp_family_cfg(case), case == "granite_ep")
    for key, r in runs["by"].items():
        got = r["cp_families"][case]
        assert got["ops"] == {k: v for k, v in want.items() if v}, key
        assert got["backend_gathers"] == (want["all_gather"] + want["psum"]
                                          + want["pmean"] + got["buckets"])


def test_state_parts_follow_the_cfg():
    """The placement has one owner, ``cfg.sharding_mode``: ``model_shard``
    gives ``cp`` one part and ``tp`` two, ``init_sharded_state`` on a
    model axis needs the cfg, and a step refuses a state of the other
    mode's parts before any collective."""
    import types

    class _Mesh:  # no collective is reached
        sizes = {"data": 2, "model": 2}
        axes = ("data", "model")
        coords = {"data": 0, "model": 0}

        def comm(self, axes):
            return types.SimpleNamespace(size=2)

        shared_comm = comm

    tp_cfg, cp_cfg = AR.strategy_cfg(), AR.cp_cfg()
    params = TT.init_model(torch.Generator().manual_seed(0), tp_cfg, "cpu")
    assert list(TL.model_shard(params, _Mesh(), cp_cfg)) == ["rep"]
    shard = TL.model_shard(params, _Mesh(), tp_cfg)
    assert sorted(shard) == ["rep", "split"] and shard["split"]
    with pytest.raises(ValueError, match="cfg"):
        TL.init_sharded_state(params, R.optimizer(), _Mesh())
    for cfg, parts in ((cp_cfg, shard), (tp_cfg, {"rep": params})):
        step = TL.make_sharded_train_step(cfg, R.optimizer(), _Mesh())
        with pytest.raises(ValueError, match="parts"):
            step({"params": parts, "step": 0}, None)
