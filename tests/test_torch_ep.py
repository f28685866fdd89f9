"""The port's expert parallelism (``models/layers.py::_moe_ep`` and
``moe``'s dispatch rule) across gloo rank processes on the CPU, against
the JAX package's ``_moe_ep`` and the port's own ``_moe_dense``.

The reference's ``test_moe_ep_matches_dense`` setting: d_model 64, 8
experts (padded to a multiple of 4), top-2, expert d_ff 128, x (4, 2048,
64) × 0.5 from a seed, parameters from a seed, handed to both packages.
The port runs ONE pool of 4 ranks, a data 2 x model 2 mesh
(``tests/_torch_model_ranks.py::ep_rank``): each data rank holds 2 rows
(4096 tokens; 8192 global, so the EP branch), each model rank its 4
experts and a 2048-token slice to dispatch.  The JAX package runs
``moe`` under a (2, 2) ("data", "model") mesh of forced host devices in
a subprocess beside the pool.  Cases: capacity factor 8 (nothing
dropped), the config's own 1.25 (rows dropped), and one shared expert
(qwen2-moe's replicated ``shared`` MLP, counted once).
"""

import os
import pickle
import subprocess
import sys
import tempfile

import _torch_model_ranks as MR
import numpy as np
import pytest
import torch

from repro_torch.bridge import params_from_numpy
from repro_torch.core import tree as T
from repro_torch.launch.mesh import run_ranks, use_mesh
from repro_torch.models import layers as L

pytestmark = pytest.mark.torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the port's _moe_ep against the JAX package's: the same routing, the
# same slots, f32 products in another order (measured on the CPU: out
# within 5.4e-7, each gradient within 3.7e-7 of its leaf's largest, aux
# 9.3e-8 relative)
JAX_OUT_ATOL, JAX_GRAD_RTOL = 1e-5, 1e-5
# against the one-device dispatch: the reference's own EP-vs-dense bounds
# (measured: out bitwise, gradients within 3.1e-7 of the leaf's largest)
DENSE_OUT_ATOL, DENSE_GRAD_RTOL = 1e-4, 1e-3
BANKS = ("w_gate", "w_up", "w_down")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


JAX_SCRIPT = r'''
import pickle, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs.base import ModelConfig
from repro.core.jax_compat import set_mesh
from repro.models import layers as L

inp = pickle.load(open(sys.argv[1], "rb"))
mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
x = jnp.asarray(inp["x"])
out = {}
for case, kw in inp["cfgs"].items():
    cfg = ModelConfig(**kw)
    p = jax.tree.map(jnp.asarray, inp["params"][case])

    def loss(p):
        o, a = L.moe(p, cfg, x)
        return jnp.sum(o ** 2) + a

    with set_mesh(mesh):
        o, a = jax.jit(lambda p: L.moe(p, cfg, x))(p)
        g = jax.jit(jax.grad(loss))(p)
    # the rows each (data, model) slice keeps, as _moe_ep routes them
    b, l, d = x.shape
    t_slice = (b // 2) * l // 2
    k, e_pad = cfg.top_k, cfg.num_experts_padded
    cap = int(max(k, round(t_slice * k / e_pad * cfg.capacity_factor)))
    cap = -(-cap // 8) * 8
    kept = {}
    for di in range(2):
        xt = x[di * (b // 2):(di + 1) * (b // 2)].reshape(-1, d)
        for mi in range(2):
            sl = xt[mi * t_slice:(mi + 1) * t_slice]
            kept[(di, mi)] = int(jnp.sum(L._route(p, cfg, sl, e_pad, cap)[2]))
    out[case] = {"out": np.asarray(o), "aux": float(a),
                 "grads": jax.tree.map(np.asarray, g), "kept": kept}
pickle.dump(out, open(sys.argv[2], "wb"))
print("JAX_EP_OK")
'''


def _np_moe(cfg, seed, skew=1.0):
    """Seeded numpy MoE params in ``init_moe``'s layout (fan-in scaled;
    the first expert's router column times ``skew``, which sends it more
    than its share of the rows)."""
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.expert_d_ff, cfg.num_experts_padded

    def w(shape, fan):
        return (rng.standard_normal(shape) / np.sqrt(fan)).astype(np.float32)

    p = {"router": w((d, cfg.num_experts), d),
         "w_gate": w((e, d, f), d), "w_up": w((e, d, f), d),
         "w_down": w((e, f, d), f)}
    if cfg.num_shared_experts:
        fs = cfg.num_shared_experts * f
        p["shared"] = {"w_gate": w((d, fs), d), "w_up": w((d, fs), d),
                       "w_down": w((fs, d), fs)}
    p["router"][:, 0] *= np.float32(skew)
    return p


def _dense(p_np, cfg, x_np):
    """The port's one-device dispatch (no mesh) on the global batch: out,
    aux and the gradient of sum(out²) + aux."""
    p = params_from_numpy(p_np, "cpu")
    leaves, tdef = T.flatten(p)
    pw = [v.detach().requires_grad_() for v in leaves]
    o, a = L.moe(T.unflatten(tdef, pw), cfg, torch.from_numpy(x_np))
    g = torch.autograd.grad((o ** 2).sum() + a, pw)
    return {"out": o.detach(), "aux": float(a.detach()),
            "grads": T.unflatten(tdef, list(g))}


@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(11)
    x = (rng.standard_normal(MR.EP_X) * 0.5).astype(np.float32)
    # the config's capacity factor with a skewed router: rows overflow
    params = {c: _np_moe(MR.ep_cfg(c), 20 + i,
                         2.0 if c == "cf_config" else 1.0)
              for i, c in enumerate(MR.EP_CASES)}
    tmp = tempfile.mkdtemp(prefix="ep-")
    src, dst = os.path.join(tmp, "in.pkl"), os.path.join(tmp, "out.pkl")
    cfgs = {c: dict(MR.EP_CFG, capacity_factor=cf, num_shared_experts=sh)
            for c, (cf, sh) in MR.EP_CASES.items()}
    with open(src, "wb") as f:
        pickle.dump({"x": x, "params": params, "cfgs": cfgs}, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=os.environ.get("XLA_FLAGS", "")
               + " --xla_force_host_platform_device_count=8")
    proc = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, src, dst],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        ranks = run_ranks(MR.ep_rank, 4, args=({"x": x, "params": params},),
                          device="cpu", timeout=400)
        dense = {c: _dense(params[c], MR.ep_cfg(c), x)
                 for c in ("cf8", "shared")}
        out, err = proc.communicate(timeout=500)
        assert proc.returncode == 0 and "JAX_EP_OK" in out, err[-3000:]
        with open(dst, "rb") as f:
            jax_out = pickle.load(f)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    return {"x": x, "ranks": ranks, "jax": jax_out, "dense": dense}


def _global_out(runs, case):
    """The global (4, 2048, 64) output: data rank d's rows from its model
    rank 0 (both model ranks hold the same, checked)."""
    by = {r["coords"]: r[case]["out"] for r in runs["ranks"]}
    for d in range(2):
        assert torch.equal(by[(d, 0)], by[(d, 1)])
    return torch.cat([by[(0, 0)], by[(1, 0)]]).numpy()


def _global_grads(runs, case):
    """The global gradient: the replicated leaves from rank 0 (every rank
    holds the same, checked), the banks concatenated over the model
    ranks (each data rank holds the same, checked)."""
    by = {r["coords"]: r[case]["grads"] for r in runs["ranks"]}
    g0 = by[(0, 0)]
    for key, g in by.items():
        for k, v in g.items():
            if k in BANKS:
                assert torch.equal(v, by[(0, key[1])][k]), (key, k)
            else:
                for a, b in zip(T.leaves(v), T.leaves(g0[k])):
                    assert torch.equal(a, b), (key, k)
    out = {k: v for k, v in g0.items() if k not in BANKS}
    for k in BANKS:
        out[k] = torch.cat([by[(0, 0)][k], by[(0, 1)][k]])
    return out


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


@pytest.mark.parametrize("case", sorted(MR.EP_CASES))
def test_ep_ranks_take_the_ep_branch_and_match_jax(runs, case):
    for r in runs["ranks"]:
        assert r[case]["ep"]
    want = runs["jax"][case]
    np.testing.assert_allclose(_global_out(runs, case), want["out"],
                               rtol=0, atol=JAX_OUT_ATOL)
    auxes = [float(r[case]["aux"]) for r in runs["ranks"]]
    # each data rank's aux is its model slices' mean; the global one (the
    # reference's, pmeaned over the batch axes too) is their mean
    np.testing.assert_allclose(np.mean(auxes), want["aux"], rtol=1e-5)
    got = _global_grads(runs, case)
    for k, v in got.items():
        for a, b in zip(T.leaves(v), T.leaves(want["grads"][k])):
            assert _rel(a.numpy(), b) <= JAX_GRAD_RTOL, (k, _rel(a, b))


@pytest.mark.parametrize("case", sorted(MR.EP_CASES))
def test_ep_drops_match_jax_at_each_slice(runs, case):
    want = runs["jax"][case]["kept"]
    for r in runs["ranks"]:
        (kept,) = r[case]["kept"]  # one routing: the rank's slice
        assert kept == want[r["coords"]], (r["coords"], kept)
    total = 2048 * MR.EP_CFG["top_k"]
    dropped = sum(total - v for v in want.values())
    if case == "cf_config":  # the config's capacity factor drops rows
        assert dropped > 0
    else:
        assert dropped == 0


@pytest.mark.parametrize("case", ["cf8", "shared"])
def test_ep_matches_the_one_device_dispatch(runs, case):
    """The reference's test_moe_ep_matches_dense on the port: at capacity
    factor 8 nothing drops, so the EP branch is the dense dispatch's
    function; the shared expert is counted once (an all-sum over the
    model ranks would double it)."""
    want = runs["dense"][case]
    np.testing.assert_allclose(_global_out(runs, case), want["out"].numpy(),
                               rtol=0, atol=DENSE_OUT_ATOL)
    got = _global_grads(runs, case)
    for k in want["grads"]:
        for a, b in zip(T.leaves(got[k]), T.leaves(want["grads"][k])):
            assert _rel(a, b) < DENSE_GRAD_RTOL, (k, _rel(a, b))


def test_ep_collectives_a_layer(runs):
    """Per case on a model rank: two all-to-alls (dispatch, combine) and
    one all-gather forward; backward the combine's reverse all-to-all (the
    dispatch's only where x takes a gradient, not here), a reduce-scatter
    for the all-gather; one pmean of the aux each way; the shared MLP's
    all-sum never runs."""
    ops = runs["ranks"][0]["ops"]
    n = len(MR.EP_CASES)
    assert ops["all_to_all"][0] == 3 * n
    assert ops["all_gather"][0] == n and ops["reduce_scatter"][0] == n
    assert ops["pmean"][0] == 2 * n
    assert "psum" not in ops


class _Mesh:
    def __init__(self, **sizes):
        self.sizes = sizes


@pytest.mark.parametrize("sizes,b,l,ep", [
    ({"data": 2, "model": 2}, 2, 1024, True),     # 4096 global tokens
    ({"data": 2, "model": 2}, 2, 1023, False),    # 4092
    ({"data": 2, "model": 2}, 1, 2048, True),
    ({"pod": 2, "data": 2, "model": 2}, 1, 1024, True),
    ({"pod": 2, "data": 2, "model": 2}, 1, 1022, False),
    ({"data": 4, "model": 3}, 4, 1024, False),    # 3 does not divide 8
    ({"model": 2}, 4, 1024, True),
    ({"model": 2}, 1, 4095, False),
    ({"data": 8}, 8, 1024, False),                # no model axis
])
def test_dispatch_rule_is_the_references_on_the_global_batch(
        monkeypatch, sizes, b, l, ep):
    """``moe`` takes ``_moe_ep`` exactly when the reference's rule does on
    its global x: a rank's b rows times the batch axes' ranks, L tokens
    each; the reference's condition evaluated on that x beside it."""
    cfg = MR.ep_cfg("cf8")
    n_dp = sizes.get("pod", 1) * sizes.get("data", 1)
    model = sizes.get("model", 1)
    ref = (model > 1 and cfg.num_experts_padded % model == 0
           and (b * n_dp) * l >= 4096)
    assert ref == ep
    seen = []
    monkeypatch.setattr(L, "_moe_ep",
                        lambda p, c, x, m: seen.append("ep") or (x, 0.0))
    monkeypatch.setattr(L, "_moe_dense",
                        lambda p, c, x: seen.append("dense") or (x, 0.0))
    p = {"w_gate": torch.zeros(cfg.num_experts_padded, 1, 1)}
    with use_mesh(_Mesh(**sizes)):
        L.moe(p, cfg, torch.zeros(b, l, 1))
    assert seen == (["ep"] if ep else ["dense"])
