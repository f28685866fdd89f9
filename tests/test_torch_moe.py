"""The port's MoE layers and the MoE families against the JAX package, on
the CPU: ``_route``, ``moe``, the model's forward, gradients, prefill and
decode steps, the three engines, jamba ``.reduced()`` with its experts,
and the trainer step on an MoE cut.

Inputs are made with numpy from a seed and handed to both packages.  The
models are 2-layer, d_model 64 cuts of granite-moe-1b-a400m (8 experts,
top 4, GQA) and qwen2-moe-a2.7b (6 experts padded to 8, top 2, one shared
expert, qkv bias) at the default capacity factor 1.25, so the prefills
drop rows.  Tolerances: ``_route``'s indices, slots and keep equal, gates
and aux atol 1e-6; one ``moe`` layer atol 1e-5; logits atol 1e-4 (two
layers and a 64-wide head); gradients rtol 1e-4 with an atol of 1e-6;
greedy tokens identical in f32; train histories: loss rtol 1e-4 over 5
steps, wire bytes exact.  bf16: one layer within 5e-2 + 2e-2 |out|, as
the recurrent layers in tests/test_torch_ssm.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_layers import close, make_requests, np_params, tiny_cfgs, to_jax, tokens

import repro.launch.train as JCLI
from repro.configs import get_config as jax_config
from repro.core.comm import LocalComm as JLocalComm
from repro.core.compression import get_compressor as jget_compressor
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import worker_batches as jworker_batches
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.optim import optimizers as JO
from repro.serve import engine as JE
from repro.train import loop as JLOOP
from repro_torch.bridge import params_from_numpy, train_state_from_numpy
from repro_torch.configs import get_config as torch_config
from repro_torch.core import tree as TREE
from repro_torch.core.comm import LocalComm
from repro_torch.launch import train as CLI
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.optim import optimizers as TO
from repro_torch.serve import engine as TE
from repro_torch.train import loop as TLOOP

pytestmark = pytest.mark.torch

MOE = ["granite-moe-1b-a400m", "qwen2-moe-a2.7b"]
JAMBA = "jamba-1.5-large-398b"
L_PROMPT = 40


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny models: one intra-op thread, as in test_torch_decode.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def routed(monkeypatch):
    """Every ``_route`` call of the port: (flat_idx, slot, keep) each."""
    calls = []
    inner = TL._route

    def spy(*args):
        out = inner(*args)
        calls.append(tuple(x.detach().clone() for x in out[:3]))
        return out

    monkeypatch.setattr(TL, "_route", spy)
    return calls


def _dropped(calls):
    return sum(int((~keep).sum()) for _, _, keep in calls)


def _setup(arch, seed, **over):
    jcfg, tcfg = tiny_cfgs(arch, **over)
    npp = np_params(jcfg, seed)
    return jcfg, tcfg, to_jax(npp), params_from_numpy(npp, "cpu")


def _layer(tree):
    """Layer 0 of a stacked subtree."""
    return jax.tree.map(lambda a: a[0], tree)


def _gens(finished):
    return {r.rid: list(r.generated) for r in finished}


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------
# (config overrides of the granite cut, what the case forces); T 40 tokens
ROUTE_CASES = {
    "overflow": dict(num_experts=8, top_k=2),
    "no_overflow": dict(num_experts=8, top_k=2, capacity_factor=8.0),
    # router columns 1, 2 and 4 identical and dominant: exact ties, which
    # lax.top_k breaks to the lowest index
    "ties": dict(num_experts=8, top_k=2),
    "padded": dict(num_experts=6, expert_pad_to=16, top_k=2),
}


def _route_case(case):
    jcfg, tcfg = tiny_cfgs("granite-moe-1b-a400m", **ROUTE_CASES[case])
    rng = np.random.default_rng(len(case))
    t, d = 40, jcfg.d_model
    router = (rng.standard_normal((d, jcfg.num_experts))
              / np.sqrt(d)).astype(np.float32)
    if case == "ties":
        router[:, [2, 4]] = router[:, [1]]
        router[:, [1, 2, 4]] *= 4.0
    xt = rng.standard_normal((t, d)).astype(np.float32)
    e_pad, k = jcfg.num_experts_padded, jcfg.top_k
    cap = int(max(k, round(t * k / e_pad * jcfg.capacity_factor)))
    return jcfg, tcfg, router, xt, e_pad, cap


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_route_matches_jax(case):
    jcfg, tcfg, router, xt, e_pad, cap = _route_case(case)
    want = JL._route({"router": jnp.asarray(router)}, jcfg, jnp.asarray(xt),
                     e_pad, cap)
    got = TL._route({"router": torch.from_numpy(router)}, tcfg,
                    torch.from_numpy(xt), e_pad, cap)
    for name, g, w in zip(("flat_idx", "slot", "keep"), got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    close(got[3], want[3], atol=1e-6)
    close(got[4], want[4], atol=1e-6)
    flat_idx, _, keep = (x.numpy() for x in got[:3])
    if case == "overflow":
        assert not keep.all()
    if case == "no_overflow":
        assert keep.all()
    if case == "ties":  # the lowest of the tied experts first: 1, then 2
        pairs = flat_idx.reshape(-1, 2)
        tied = np.isin(pairs, [1, 2, 4]).sum(axis=1)
        assert (pairs[tied == 2] == [1, 2]).all() and (tied == 2).sum() > 10
        assert (pairs[tied == 1] == 1).any(axis=1).all()
        assert not (pairs == 4).any()
    if case == "padded":
        assert e_pad == 16 and flat_idx.max() < 6


def test_route_gradient_reaches_the_router_through_gates_and_p_e():
    """The router's gradient is JAX's, through the gathered gates and the
    aux loss's mean probabilities."""
    jcfg, tcfg, router, xt, e_pad, cap = _route_case("overflow")
    w = np.random.default_rng(3).standard_normal(40 * 2).astype(np.float32)

    def jloss(r):
        *_, gate, aux = JL._route({"router": r}, jcfg, jnp.asarray(xt),
                                  e_pad, cap)
        return jnp.sum(gate * jnp.asarray(w)) + aux

    tr = torch.from_numpy(router).requires_grad_()
    *_, gate, aux = TL._route({"router": tr}, tcfg, torch.from_numpy(xt),
                              e_pad, cap)
    (gate * torch.from_numpy(w)).sum().add(aux).backward()
    np.testing.assert_allclose(tr.grad.numpy(),
                               np.asarray(jax.grad(jloss)(
                                   jnp.asarray(router))),
                               rtol=1e-4, atol=1e-6)


def test_moe_runs_without_a_host_synchronisation():
    """On meta tensors no value exists, so a step that read one back to
    the host (``.item()``, ``nonzero``, a data-dependent shape) would
    raise; the layer's output keeps the input's shape."""
    _, tcfg = tiny_cfgs("qwen2-moe-a2.7b")
    p = TL.init_moe(torch.Generator(), tcfg, torch.float32, "meta")
    x = torch.empty((2, 24, tcfg.d_model), device="meta")
    out, aux = TL.moe(p, tcfg, x)
    assert out.shape == x.shape and aux.shape == ()


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE)  # without and with a shared expert
def test_moe_layer_matches_jax(arch):
    jcfg, tcfg = tiny_cfgs(arch)
    p = _layer(np_params(jcfg, 1)["stack"]["0"]["moe"])
    assert ("shared" in p) == (arch == "qwen2-moe-a2.7b")
    x = np.random.default_rng(1).standard_normal(
        (2, 24, jcfg.d_model)).astype(np.float32)
    jout, jaux = JL.moe(to_jax(p), jcfg, jnp.asarray(x))
    tout, taux = TL.moe(params_from_numpy(p, "cpu"), tcfg,
                        torch.from_numpy(x))
    close(tout, jout, atol=1e-5)
    close(taux, jaux, atol=1e-6)


@pytest.mark.parametrize("arch", MOE)
def test_moe_layer_bf16(arch):
    """bf16 weights and activations: the router logits, the dispatch and
    the expert products in bf16, the softmax and gates in f32."""
    jcfg, tcfg = tiny_cfgs(arch, param_dtype="bfloat16",
                           compute_dtype="bfloat16")
    p = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                     _layer(np_params(jcfg, 2)["stack"]["0"]["moe"]))
    x = np.asarray(jnp.asarray(np.random.default_rng(2).standard_normal(
        (2, 24, jcfg.d_model)), jnp.bfloat16))
    jout, _ = JL.moe(to_jax(p), jcfg, jnp.asarray(x))
    tout, _ = TL.moe(params_from_numpy(p, "cpu"), tcfg,
                     torch.from_numpy(np.array(x, np.float32)).bfloat16())
    assert tout.dtype == torch.bfloat16
    j, t = np.asarray(jout, np.float32), tout.float().numpy()
    assert np.all(np.abs(t - j) <= 5e-2 + 2e-2 * np.abs(j))


def test_init_moe_scales_each_leaf_by_its_fan_in():
    """The expert leaves are drawn a layer at a time in the param dtype and
    scaled by D (gate, up) and F (down); the router by D."""
    cfg = dataclasses.replace(torch_config("qwen2-moe-a2.7b").reduced(),
                              d_model=128, moe_d_ff=32, num_experts=6,
                              expert_pad_to=8, param_dtype="bfloat16")
    p = TL.init_moe(torch.Generator().manual_seed(0), cfg, torch.bfloat16,
                    "cpu", lead=(3,))
    d, f = cfg.d_model, cfg.expert_d_ff
    want = {"router": ((3, d, 6), d), "w_gate": ((3, 8, d, f), d),
            "w_up": ((3, 8, d, f), d), "w_down": ((3, 8, f, d), f)}
    for name, (shape, fan_in) in want.items():
        w = p[name]
        assert tuple(w.shape) == shape and w.dtype == torch.bfloat16
        assert abs(w.float().std().item() * fan_in ** 0.5 - 1) < 0.05, name
    # one draw a layer: no two layers alike
    assert not torch.equal(p["w_gate"][0], p["w_gate"][1])
    assert tuple(p["shared"]["w_gate"].shape) == (3, d, f)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE)
def test_init_model_layout_matches_reference(arch):
    jcfg, tcfg = tiny_cfgs(arch)
    shapes = jax.eval_shape(lambda k: JT.init_model(k, jcfg),
                            jax.random.PRNGKey(0))
    ours = TT.init_model(torch.Generator().manual_seed(0), tcfg, "cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(shapes)[0]
    flat_t = jax.tree_util.tree_flatten_with_path(jax.tree.map(
        lambda t: jax.ShapeDtypeStruct(tuple(t.shape), np.float32), ours,
        is_leaf=lambda t: isinstance(t, torch.Tensor)))[0]
    assert [(jax.tree_util.keystr(k), v.shape) for k, v in flat_j] \
        == [(jax.tree_util.keystr(k), v.shape) for k, v in flat_t]


@pytest.mark.parametrize("arch", MOE)
def test_forward_logits_and_aux_match_jax(arch, routed):
    jcfg, tcfg, jp, tp = _setup(arch, 3)
    toks = tokens(3, 2, 24)
    jlogits, jaux = JT.forward(jp, jcfg, tokens=jnp.asarray(toks))
    with torch.no_grad():
        tlogits, taux = TT.forward(tp, tcfg, torch.from_numpy(toks))
    close(tlogits, jlogits, atol=1e-4)
    close(taux, jaux, atol=1e-6)
    assert float(taux) > 0
    assert len(routed) == jcfg.num_layers and _dropped(routed) > 0


@pytest.mark.parametrize("arch", MOE)
def test_loss_gradients_match_jax(arch):
    """``jax.grad`` of the training loss (cross entropy + aux) against
    autograd, every leaf, the router and the padded experts included."""
    jcfg, tcfg, jp, tp = _setup(arch, 4)
    toks = tokens(4, 2, 24)
    jloss = JLOOP.make_loss_fn(jcfg, remat=False)
    tloss = TLOOP.make_loss_fn(tcfg, remat=False)
    jl, jg = jax.value_and_grad(jloss)(
        jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)})
    leaves = TREE.leaves(tp)
    for x in leaves:
        x.requires_grad_()
    tl = tloss(tp, {"tokens": torch.from_numpy(toks),
                    "labels": torch.from_numpy(toks)})
    tg = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    paths = [jax.tree_util.keystr(k)
             for k, _ in jax.tree_util.tree_flatten_with_path(jg)[0]]
    assert any("router" in k for k in paths) and len(tg) == len(paths)
    for path, a, b in zip(paths, tg, jax.tree.leaves(jg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-6, err_msg=path)
        if "router" in path:
            assert np.abs(np.asarray(b)).max() > 1e-4


@pytest.mark.parametrize("arch", MOE)
def test_remat_gradients_equal_no_remat(arch):
    _, tcfg, _, tp = _setup(arch, 5)
    toks = torch.from_numpy(tokens(5, 2, 16))
    grads = []
    for remat in (False, True):
        leaves = [x.detach().clone().requires_grad_()
                  for x in TREE.leaves(tp)]
        p = TREE.unflatten(TREE.flatten(tp)[1], leaves)
        loss = TLOOP.make_loss_fn(tcfg, remat=remat)(
            p, {"tokens": toks, "labels": toks})
        grads.append(torch.autograd.grad(loss, leaves))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", MOE)
def test_prefill_and_decode_step_logits_match_jax(arch):
    jcfg, tcfg, jp, tp = _setup(arch, 6)
    b, lp, total = 2, 24, 30
    toks = tokens(6, b, lp)
    jl, jcache = JT.prefill(jp, jcfg, tokens=jnp.asarray(toks))
    with torch.no_grad():
        tl, tcache = TT.prefill(tp, tcfg, torch.from_numpy(toks))
    close(tl, jl, atol=1e-4)
    jcache = JT.pad_prefill_cache(jcfg, jcache, total)
    tcache = TT.pad_prefill_cache(tcfg, tcache, total)
    tok = np.array(jnp.argmax(jl[:, -1], -1), np.int32)
    for pos in range(lp, lp + 4):
        jl, jcache = JT.decode_step(jp, jcfg, token=jnp.asarray(tok),
                                    pos=jnp.int32(pos), cache=jcache)
        with torch.no_grad():
            tl = TT.decode_step(tp, tcfg, torch.from_numpy(tok), pos, tcache)
        close(tl, jl, atol=1e-4)
        tok = np.array(jnp.argmax(jl, -1), np.int32)


@pytest.mark.parametrize("arch", MOE)
def test_paged_chunk_and_decode_logits_match_jax(arch, routed):
    """A prefill chunk with pad rows and a decode step with an idle slot:
    the pads and the idle slot are routed and take capacity, as in the
    reference, so the live rows' logits agree."""
    jcfg, tcfg, jp, tp = _setup(arch, 7)
    b, ps, mb, chunk = 3, 4, 8, 20
    bt = (1 + np.arange(b * mb, dtype=np.int32)).reshape(b, mb)
    jcache = JT.init_paged_cache(jcfg, 1 + b * mb, ps)
    tcache = TT.init_paged_cache(tcfg, 1 + b * mb, ps, device="cpu")
    lens = np.asarray([20, 13, 6], np.int32)
    toks = tokens(7, b, chunk)
    poss = np.where(np.arange(chunk)[None] < lens[:, None],
                    np.arange(chunk)[None], -1).astype(np.int32)
    jl, jcache = JT.prefill_chunk_paged(jp, jcfg, jnp.asarray(toks),
                                        jnp.asarray(poss), jcache,
                                        jnp.asarray(bt),
                                        jnp.asarray(lens - 1))
    with torch.no_grad():
        tl = TT.prefill_chunk_paged(tp, tcfg, torch.from_numpy(toks),
                                    torch.from_numpy(poss), tcache,
                                    torch.from_numpy(bt),
                                    torch.from_numpy(lens - 1))
    close(tl, jl, atol=1e-4)
    assert routed[0][0].numel() == b * chunk * tcfg.top_k
    pos = lens.copy()
    pos[2] = -1  # an idle slot
    for _ in range(3):
        tok = np.array(jnp.argmax(jl, -1), np.int32)
        jl, jcache = JT.decode_step_paged(jp, jcfg, jnp.asarray(tok),
                                          jnp.asarray(pos), jcache,
                                          jnp.asarray(bt))
        with torch.no_grad():
            tl = TT.decode_step_paged(tp, tcfg, torch.from_numpy(tok),
                                      torch.from_numpy(pos), tcache,
                                      torch.from_numpy(bt))
        close(tl[:2], np.asarray(jl)[:2], atol=1e-4)
        pos[:2] += 1


# ---------------------------------------------------------------------------
# the engines: tokens identical to JAX in f32, with capacity drops
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE)
def test_greedy_generate_tokens_match_jax(arch, routed):
    jcfg, tcfg, jp, tp = _setup(arch, 8)
    prompt = tokens(8, 1, L_PROMPT)[0]
    want = JE.greedy_generate(jp, jcfg, prompt, max_new_tokens=8)
    got = TE.greedy_generate(tp, tcfg, prompt, max_new_tokens=8,
                             device="cpu")
    assert got == want and len(got) == 8
    assert _dropped(routed) > 0  # the prefill dropped rows


@pytest.mark.parametrize("arch", MOE)
def test_decode_engine_reuses_slots_like_jax(arch):
    """Seven requests through three slots, every slot reused."""
    jcfg, tcfg, jp, tp = _setup(arch, 9)
    jeng = JE.DecodeEngine(jp, jcfg, batch_slots=3, max_seq=48)
    teng = TE.DecodeEngine(tp, tcfg, batch_slots=3, max_seq=48, device="cpu")
    for eng, mod in ((jeng, JE), (teng, TE)):
        for r in make_requests(mod.Request, 9, 7, 2, 30):
            eng.submit(r)
    assert _gens(teng.run()) == _gens(jeng.run())
    assert teng.steps == jeng.steps


@pytest.mark.parametrize("arch", MOE)
def test_paged_engine_matches_jax(arch, routed):
    """Chunks of 8 with pad rows and idle slots, capacity shared over the
    whole chunk: the port's paged engine against the reference's."""
    jcfg, tcfg, jp, tp = _setup(arch, 10)
    kw = dict(batch_slots=3, max_seq=48, page_size=4, chunk_size=8)
    jeng = JE.PagedDecodeEngine(jp, jcfg, use_kernel=False, **kw)
    teng = TE.PagedDecodeEngine(tp, tcfg, device="cpu", **kw)
    for eng, mod in ((jeng, JE), (teng, TE)):
        for r in make_requests(mod.Request, 10, 7, 3, 30):
            eng.submit(r)
    assert _gens(teng.run()) == _gens(jeng.run())
    assert teng.steps == jeng.steps
    assert _dropped(routed) > 0


# ---------------------------------------------------------------------------
# jamba .reduced() with its experts: MoE inside a hybrid Mamba stack
# ---------------------------------------------------------------------------
def _jamba(seed):
    """16 layers (2 super-blocks of 1 attention and 7 Mamba layers, an MoE
    FFN on layers 1, 3, 5, 7 of each: 4 experts, top 2), ssm_chunk 16."""
    jcfg = dataclasses.replace(jax_config(JAMBA).reduced(), ssm_chunk=16)
    tcfg = dataclasses.replace(torch_config(JAMBA).reduced(), ssm_chunk=16)
    assert jcfg.num_experts == 4 and jcfg.num_layers == 16
    npp = np_params(jcfg, seed)
    return jcfg, tcfg, to_jax(npp), params_from_numpy(npp, "cpu")


def test_jamba_with_experts_prefill_and_decode_match_jax():
    jcfg, tcfg, jp, tp = _jamba(11)
    toks = tokens(11, 2, 48, vocab=512)
    jl, jcache = JT.prefill(jp, jcfg, tokens=jnp.asarray(toks),
                            last_only=True)
    with torch.no_grad():
        tl, tcache = TT.prefill(tp, tcfg, torch.from_numpy(toks),
                                last_only=True)
    close(tl, jl, atol=1e-4)
    jcache = JT.pad_prefill_cache(jcfg, jcache, 52)
    tcache = TT.pad_prefill_cache(tcfg, tcache, 52)
    tok = np.array(jnp.argmax(jl[:, -1], -1), np.int32)
    for pos in range(48, 51):
        jl, jcache = JT.decode_step(jp, jcfg, token=jnp.asarray(tok),
                                    pos=jnp.int32(pos), cache=jcache)
        with torch.no_grad():
            tl = TT.decode_step(tp, tcfg, torch.from_numpy(tok), pos, tcache)
        close(tl, jl, atol=1e-4)
        tok = np.array(jnp.argmax(jl, -1), np.int32)


def test_jamba_aux_is_each_superblocks_last_layer_as_in_jax(monkeypatch):
    """The reference's scan body adds only the last layer's aux of each
    super-block: layer 7's of jamba's eight, so layers 1, 3 and 5 add
    nothing.  The port's ``_run_stack`` does the same, and its aux is the
    JAX forward's."""
    jcfg, tcfg, jp, tp = _jamba(12)
    toks = tokens(12, 2, 32, vocab=512)
    _, jaux = JT.forward(jp, jcfg, tokens=jnp.asarray(toks))
    per_layer = []
    inner = TL.moe

    def spy(p, cfg, x):
        out, aux = inner(p, cfg, x)
        per_layer.append(float(aux))
        return out, aux

    monkeypatch.setattr(TL, "moe", spy)

    def attend(p, x, window, theta, key, r):
        return TL.attention_prefill(p, tcfg, x, window, theta)[0]

    def recur(mixer, p, x, key, r):
        return TT._RECURRENT[mixer]["layer"](p, tcfg, x)[0]

    with torch.no_grad():
        h = TT._embed(tp, tcfg, torch.from_numpy(toks))
        _, taux = TT._run_stack(tp, tcfg, h, attend, recur)
    assert len(per_layer) == 8  # layers 1, 3, 5, 7 of two super-blocks
    last = per_layer[3] + per_layer[7]
    np.testing.assert_allclose(float(taux), last, rtol=1e-6)
    assert abs(sum(per_layer) - last) > 10 * abs(float(jaux) - last)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-4)


def test_jamba_with_experts_tokens_match_jax():
    jcfg, tcfg, jp, tp = _jamba(13)
    prompt = tokens(13, 1, 30, vocab=512)[0]
    want = JE.greedy_generate(jp, jcfg, prompt, max_new_tokens=6)
    got = TE.greedy_generate(tp, tcfg, prompt, max_new_tokens=6,
                             device="cpu")
    assert got == want
    jeng = JE.DecodeEngine(jp, jcfg, batch_slots=2, max_seq=40)
    teng = TE.DecodeEngine(tp, tcfg, batch_slots=2, max_seq=40, device="cpu")
    for eng, mod in ((jeng, JE), (teng, TE)):
        for r in make_requests(mod.Request, 13, 4, 2, 20, max_new=(2, 6),
                               vocab=512):
            eng.submit(r)
    assert _gens(teng.run()) == _gens(jeng.run())


# ---------------------------------------------------------------------------
# the trainer step on an MoE cut
# ---------------------------------------------------------------------------
STEPS = 5


def _jcomp(name, **kw):
    return dataclasses.replace(jget_compressor(name, **kw), fused_encode=None)


@pytest.mark.parametrize("strategy,comp", [("sync", "onebit"),
                                           ("sync_zero1", "none")])
def test_trainer_history_matches_jax(strategy, comp, monkeypatch):
    """Both CLIs' strategies and Adam (fused in the port) from one initial
    state over the JAX package's batches: the router and the expert
    leaves are buckets like any other."""
    monkeypatch.setattr(JCLI, "get_compressor", _jcomp)
    jcfg, tcfg = tiny_cfgs("granite-moe-1b-a400m", vocab_size=256)
    w = 4
    argv = ["--strategy", strategy, "--compressor", comp, "--fused-adam",
            "--steps", str(STEPS), "--workers", str(w)]
    jstrat = JCLI.strategy_from_args(JCLI.build_argparser().parse_args(argv))
    tstrat = CLI.strategy_from_args(CLI.build_argparser().parse_args(
        argv + ["--device", "cpu"]))
    jopt = JO.adam(JO.warmup_cosine(1e-3, 1, STEPS))
    topt = TO.adam(TO.warmup_cosine(1e-3, 1, STEPS), fused=True)
    jcomm, tcomm = JLocalComm(w), LocalComm(w)
    params = jcomm.replicate(to_jax(np_params(jcfg, seed=2)))
    jstate = JLOOP.init_train_state(params, jopt, jstrat, jcomm)
    tstate = TLOOP.init_train_state(
        params_from_numpy(jax.tree.map(np.asarray, params), "cpu"), topt,
        tstrat, tcomm)
    if strategy == "sync":  # the comm state through the bridge as well
        tstate = train_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                        "cpu")
    jloss = JLOOP.make_loss_fn(jcfg, remat=False)
    tloss = TLOOP.make_loss_fn(tcfg, remat=False)
    jstep = JLOOP.make_replica_train_step(
        lambda p, x: jloss(p, {"tokens": x, "labels": x}), jopt, jstrat,
        jcomm)
    tstep = TLOOP.make_replica_train_step(
        lambda p, x: tloss(p, {"tokens": x, "labels": x}), topt, tstrat,
        tcomm)
    dcfg = JDataConfig(vocab_size=jcfg.vocab_size, seq_len=16,
                       batch_per_worker=2)
    for t in range(STEPS):
        toks = np.array(jworker_batches(dcfg, w, t))
        jstate, jm = jstep(jstate, jnp.asarray(toks))
        tstate, tm = tstep(tstate, torch.from_numpy(toks))
        assert tm["wire_bytes"].item() == float(jm["wire_bytes"]), t
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   rtol=1e-4)
        assert tm["replica_divergence"].item() == 0.0


@pytest.mark.parametrize("flags", [
    ["--compressor", "onebit"],
    ["--zero-stage", "3", "--precision", "bf16", "--accum-steps", "2"],
    ["--strategy", "downpour", "--compressor", "onebit"]])
def test_cli_trains_a_moe_arch_on_cpu(flags, capsys):
    CLI.main(["--arch", "granite-moe-1b-a400m", "--reduced", "--device",
              "cpu", "--fused-adam", "--steps", "3", "--log-every", "1",
              "--batch-per-worker", "2", "--seq-len", "16"] + flags)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=granite-moe-1b-a400m-reduced ")
    steps = [line.split() for line in out if line.startswith("step ")]
    assert len(steps) == 3
    assert all(np.isfinite(float(s[3])) for s in steps)
    if "downpour" not in flags:
        assert all(s[5] == "0.00e+00" for s in steps)
