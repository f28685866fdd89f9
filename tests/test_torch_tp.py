"""The port's tensor parallelism (``models/tensor_parallel.py``, the
blocked and the TP branches of ``models/layers.py``) against the JAX
package's, on ``tests/test_tp.py``'s tiny config (qwen2-1.5b reduced, 2
layers, d_model 32, 4 heads over 2 kv heads, d_ff 64, vocab 64) at
T = 2, on numpy parameters from a seed handed to both packages.

  * ``tp_split_params``/``tp_unsplit_params`` exactly the reference's,
    leaf for leaf, and ``tp_rank_params`` rank r's row of them;
  * the blocked form (``tp_degree`` 2, no context): forward and loss
    against JAX's ``T.forward`` / ``_loss_of`` with the same config at
    f32 tolerance (``JAX_ATOL``);
  * the port's TP ranks (2 gloo processes, ``tests/_torch_model_ranks.py``)
    against the port's blocked form, the reference's TP contract: forward
    and loss bitwise, split-leaf gradients within 1e-7, the replicated
    partials summing within 2e-7, ``finalize_grads`` equal on every rank;
    and against the reference's vmap rig (``tests/test_tp.py``) at f32
    tolerance;
  * ``tp_degree == 1`` keeps the single path bit for bit.
"""

import dataclasses

import _torch_model_ranks as MR
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_layers import np_params

from repro.configs import get_config as jax_config
from repro.models import tensor_parallel as JTP
from repro.models import transformer as JT
from repro_torch.bridge import params_from_numpy
from repro_torch.core import tree as T
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import layers as L
from repro_torch.models import tensor_parallel as TP
from repro_torch.models import transformer as TT

pytestmark = pytest.mark.torch

TP_N = MR.TP_DEGREE
# the blocked form against the JAX package's, f32: the two packages'
# matmuls and softmax round differently (measured on the CPU: logits
# within 1.4e-6, the loss equal; the TP ranks' gradients within 1.1e-6 of
# each leaf's largest from the reference's vmap rig's; split gradients
# within 4.5e-8 of the blocked form's slices, replicated partials summing
# within 1.2e-7)
JAX_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_cfg(tp_degree=TP_N):
    return dataclasses.replace(jax_config("qwen2-1.5b").reduced(),
                               **MR.TINY, tp_degree=tp_degree)


def _jax_loss(cfg, p, tokens, targets):
    logits, _ = JT.forward(p, cfg, tokens)
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    return -jnp.mean(jnp.take_along_axis(logp, targets[..., None], axis=-1))


def _named(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _tnamed(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_tnamed(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v.detach().numpy()
    return out


@pytest.fixture(scope="module")
def setup():
    """The numpy inputs, the port's blocked form, the JAX package's blocked
    form and vmap rig, and the port's two TP ranks."""
    jcfg = jax_cfg()
    params = np_params(jcfg, seed=7)
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    targets = rng.integers(0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    ranks = run_ranks(MR.tp_rank, TP_N, args=(
        {"params": params, "tokens": tokens, "targets": targets},),
        device="cpu", timeout=300)

    # the port's blocked form
    cfg = MR.tiny_cfg()
    tp_ = params_from_numpy(params, "cpu")
    tt, tg = torch.from_numpy(tokens), torch.from_numpy(targets)
    logits, _ = TT.forward(tp_, cfg, tokens=tt)
    leaves, tdef = T.flatten(tp_)
    pw = [x.detach().requires_grad_() for x in leaves]
    loss = MR.loss_of(cfg, T.unflatten(tdef, pw), tt, tg)
    grads = T.unflatten(tdef, list(torch.autograd.grad(loss, pw)))

    # the JAX package's blocked form and its vmap rig (tests/test_tp.py)
    jp = jax.tree.map(jnp.asarray, params)
    jl = JT.forward(jp, jcfg, jnp.asarray(tokens))[0]
    jloss = _jax_loss(jcfg, jp, tokens, targets)
    shards = JTP.tp_split_params(jp, TP_N)

    def rig_loss(sh):
        with JTP.tp_context(TP_N):
            return jnp.mean(jax.vmap(
                lambda p: _jax_loss(jcfg, p, tokens, targets),
                axis_name="model")(sh))

    def rig_fwd(sh):
        with JTP.tp_context(TP_N):
            return jax.vmap(lambda p: JT.forward(p, jcfg, tokens)[0],
                            axis_name="model")(sh)

    def rig_final(sh):
        # finalize_grads on each rank's gradient of the MEAN of the
        # ranks' losses, the pairing of test_end_to_end_grads
        g = jax.grad(rig_loss)(sh)
        with JTP.tp_context(TP_N):
            return jax.vmap(lambda x: JTP.current_tp().finalize_grads(x),
                            axis_name="model")(g)

    rl, rgrads = jax.jit(jax.value_and_grad(rig_loss))(shards)
    return {"params": params, "tokens": tokens, "targets": targets,
            "ranks": ranks, "cfg": cfg,
            "blocked": {"logits": logits.detach(), "loss": loss.detach(),
                        "grads": grads},
            "jax": {"logits": np.asarray(jl), "loss": float(jloss),
                    "rig_logits": np.asarray(jax.jit(rig_fwd)(shards)),
                    "rig_loss": float(rl), "rig_grads": _named(rgrads),
                    "rig_final": _named(jax.jit(rig_final)(shards))}}


# ---------------------------------------------------------------------------
# the split
# ---------------------------------------------------------------------------
def test_split_unsplit_match_reference_leaf_for_leaf(setup):
    params = setup["params"]
    want = _named(JTP.tp_split_params(jax.tree.map(jnp.asarray, params),
                                      TP_N))
    full = params_from_numpy(params, "cpu")
    got = _tnamed(TP.tp_split_params(full, TP_N))
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    back = _tnamed(TP.tp_unsplit_params(TP.tp_split_params(full, TP_N)))
    ref = _tnamed(full)
    assert set(back) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(back[k], ref[k], err_msg=k)
    # each rank's tree is its row of the stacked split, contiguous
    ranks = [TP.tp_rank_params(full, TP_N, r) for r in range(TP_N)]
    for r in range(TP_N):
        for k, v in _tnamed(ranks[r]).items():
            np.testing.assert_array_equal(v, want[k][r], err_msg=k)
    for k, v in _tnamed(TP.tp_unsplit_ranks(ranks)).items():
        np.testing.assert_array_equal(v, ref[k], err_msg=k)
    # the partition of the replicated leaves is the reference's
    jrep, jkeep = JTP._partition_replicated(params, "stack")
    rep, keep = TP._partition_replicated(full)
    assert set(_tnamed(rep)) == set(_named(jrep))
    assert set(_tnamed(keep)) == set(_named(jkeep))
    assert len(_named(jkeep)) >= 7


def test_split_indivisible_and_degree_one_raise(setup):
    full = params_from_numpy(setup["params"], "cpu")
    with pytest.raises(ValueError, match="divisible"):
        TP.tp_split_params(full, 3)
    with pytest.raises(ValueError, match="divisible"):
        TP.tp_rank_params(full, 3, 0)
    with pytest.raises(ValueError, match="divisible"):
        JTP.tp_split_params(jax.tree.map(jnp.asarray, setup["params"]), 3)
    with pytest.raises(ValueError):
        with TP.tp_context(1):
            pass
    with pytest.raises(ValueError):
        with JTP.tp_context(1):
            pass


def test_expert_banks_split_on_the_expert_axis():
    """With ``experts`` the MoE banks split on their expert axis (the
    stacked layout's axis 1) and are split leaves; the router and the
    shared experts stay replicated; the reference's split keeps the
    whole ``moe`` subtree replicated."""
    rng = np.random.default_rng(0)
    tree = {"stack": {"0": {"moe": {
        "router": rng.standard_normal((2, 8, 4)).astype(np.float32),
        "w_gate": rng.standard_normal((2, 4, 8, 6)).astype(np.float32),
        "w_up": rng.standard_normal((2, 4, 8, 6)).astype(np.float32),
        "w_down": rng.standard_normal((2, 4, 6, 8)).astype(np.float32),
        "shared": {"w_gate": rng.standard_normal((2, 8, 6))
                   .astype(np.float32),
                   "w_up": rng.standard_normal((2, 8, 6)).astype(np.float32),
                   "w_down": rng.standard_normal((2, 6, 8))
                   .astype(np.float32)}}}}}
    full = params_from_numpy(tree, "cpu")
    assert TP.splits_experts(full, 2) and TP.splits_experts(full, 4)
    assert not TP.splits_experts(full, 3)
    r1 = TP.tp_rank_params(full, 2, 1, experts=True)["stack"]["0"]["moe"]
    src = full["stack"]["0"]["moe"]
    assert torch.equal(r1["w_gate"], src["w_gate"][:, 2:])
    assert torch.equal(r1["w_down"], src["w_down"][:, 2:])
    assert r1["router"] is src["router"]
    assert r1["shared"]["w_gate"] is src["shared"]["w_gate"]
    rep, keep = TP._partition_replicated(full, experts=True)
    assert sorted(keep["stack"]["0"]["moe"]) == ["w_down", "w_gate", "w_up"]
    assert sorted(rep["stack"]["0"]["moe"]) == ["router", "shared"]
    ranks = [TP.tp_rank_params(full, 2, r, experts=True) for r in range(2)]
    back = TP.tp_unsplit_ranks(ranks, experts=True)
    for a, b in zip(T.leaves(back), T.leaves(full)):
        assert torch.equal(a, b)
    # the reference's split leaves every moe leaf whole
    for k, v in _tnamed(TP.tp_split_params(full, 2)).items():
        assert v.shape[1:] == _tnamed(full)[k].shape, k


# ---------------------------------------------------------------------------
# the blocked form against the JAX package's
# ---------------------------------------------------------------------------
def test_blocked_forward_and_loss_match_jax(setup):
    got, want = setup["blocked"], setup["jax"]
    np.testing.assert_allclose(got["logits"].numpy(), want["logits"],
                               rtol=0, atol=JAX_ATOL)
    np.testing.assert_allclose(float(got["loss"]), want["loss"], rtol=1e-6)
    # the blocked form is the single path's sum regrouped: f32-close
    single, _ = TT.forward(params_from_numpy(setup["params"], "cpu"),
                           MR.tiny_cfg(1),
                           tokens=torch.from_numpy(setup["tokens"]))
    np.testing.assert_allclose(got["logits"].numpy(), single.numpy(),
                               rtol=0, atol=JAX_ATOL)


# ---------------------------------------------------------------------------
# the TP ranks against the blocked form: the reference's TP contract
# ---------------------------------------------------------------------------
def test_rank_forward_and_loss_bitwise_blocked(setup):
    for r in range(TP_N):
        got = setup["ranks"][r]
        assert torch.equal(got["logits"], setup["blocked"]["logits"]), r
        assert torch.equal(got["loss"], setup["blocked"]["loss"]), r
    # one combine a sub-layer a layer in each of the rank's two forwards
    # (the logits, the loss) and in the loss's backward
    n = 2 * MR.TINY["num_layers"] * 3
    assert setup["ranks"][0]["ops"]["psum"][0] == n


def test_rank_grads_split_slices_and_replicated_partials(setup):
    ref = _tnamed(setup["blocked"]["grads"])
    want_split = _tnamed(TP.tp_split_params(setup["blocked"]["grads"],
                                            TP_N))
    rep_names = set(_tnamed(TP._partition_replicated(
        setup["blocked"]["grads"])[0]))
    got = [_tnamed(setup["ranks"][r]["grads"]) for r in range(TP_N)]
    split_err, rep_err = 0.0, 0.0
    for k in ref:
        if k in rep_names:
            total = sum(g[k] for g in got)
            rep_err = max(rep_err, float(np.abs(total - ref[k]).max()))
        else:
            for r in range(TP_N):
                split_err = max(split_err, float(
                    np.abs(got[r][k] - want_split[k][r]).max()))
    assert split_err <= 1e-7, split_err
    assert rep_err <= 2e-7, rep_err


def test_finalize_grads_equal_on_every_rank(setup):
    rep_names = set(_tnamed(TP._partition_replicated(
        setup["blocked"]["grads"])[0]))
    final = [_tnamed(setup["ranks"][r]["final"]) for r in range(TP_N)]
    grads = [_tnamed(setup["ranks"][r]["grads"]) for r in range(TP_N)]
    ref = _tnamed(setup["blocked"]["grads"])
    for k in final[0]:
        if k in rep_names:
            for r in range(1, TP_N):
                np.testing.assert_array_equal(final[r][k], final[0][k], k)
            np.testing.assert_allclose(final[0][k], ref[k], rtol=0,
                                       atol=2e-7, err_msg=k)
        else:  # split leaves pass through
            for r in range(TP_N):
                np.testing.assert_array_equal(final[r][k], grads[r][k], k)


def test_ranks_match_the_reference_vmap_rig(setup):
    want = setup["jax"]
    for r in range(TP_N):
        got = setup["ranks"][r]
        np.testing.assert_allclose(got["logits"].numpy(),
                                   want["rig_logits"][r], rtol=0,
                                   atol=JAX_ATOL)
        np.testing.assert_allclose(float(got["loss"]), want["rig_loss"],
                                   rtol=1e-6)
        for name, per in (("grads", "rig_grads"), ("final", "rig_final")):
            g = _tnamed(got[name])
            assert set(g) == set(want[per])
            for k, v in g.items():
                np.testing.assert_allclose(v, want[per][k][r], rtol=1e-4,
                                           atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# tp_degree == 1: the single path, bit for bit
# ---------------------------------------------------------------------------
def _single_attention(p, cfg, x, positions, theta):
    """The single path as it stood before the blocked and TP branches."""
    q, k, v = L._qkv(p, cfg, x)
    q = L.rope(q, positions, theta)
    k = L.rope(k, positions, theta)
    i = positions[:, :, None].long()
    j = positions[:, None, :].long()
    mask = (j <= i) & (i - j < L.INT32_MAX)
    out = L._sdpa(cfg, q, k, v, mask[:, None])
    return torch.einsum("blhk,hkd->bld", out, p["wo"])


def test_tp_degree_one_is_the_single_path_bitwise(setup):
    cfg1 = MR.tiny_cfg(1)
    full = params_from_numpy(setup["params"], "cpu")
    blk = T.tree_map(lambda v: v[0], full["stack"]["0"])
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 8, cfg1.d_model)).astype(np.float32))
    pos = torch.arange(8, dtype=torch.int32).expand(2, 8)
    got = L.attention(blk["attn"], cfg1, x, pos, -1, cfg1.rope_theta)
    assert torch.equal(got, _single_attention(blk["attn"], cfg1, x, pos,
                                              cfg1.rope_theta))
    p = blk["mlp"]
    want = (torch.nn.functional.silu(x @ p["w_gate"]) * (x @ p["w_up"])) \
        @ p["w_down"]
    assert torch.equal(L.mlp(p, cfg1, x), want)
    # the blocked form differs from it (it regroups the sums)
    cfg2 = MR.tiny_cfg(2)
    assert not torch.equal(L.mlp(p, cfg2, x), want)
    # a d_ff that T does not divide stays whole under tp_degree 2
    odd = {k: v[..., :63] if k != "w_down" else v[:63]
           for k, v in p.items()}
    one = (torch.nn.functional.silu(x @ odd["w_gate"]) * (x @ odd["w_up"])) \
        @ odd["w_down"]
    assert torch.equal(L.mlp(odd, cfg2, x), one)
