"""The encoder-decoder and vision families against the JAX package, on the
CPU: ``cross_attention``, ``encode``, the forward with ``memory`` and with
``embeds``, the loss and its gradients, prefill and decode steps, and the
dense engines with an encoder's memory.

Inputs are made with numpy from a seed and handed to both packages.  The
models are 2-layer, d_model 64 cuts of seamless-m4t-medium (2 encoder
layers, MHA, tied head, encoder length 64 once reduced; 20 frames here)
and pixtral-12b (GQA 4 over 2, untied head, fed patch embeddings), and
jamba ``.reduced()`` made an encoder-decoder.  On the CPU the serving
path's flash attention (``kernel=True``) is ``flash_attention_plain``.
Tolerances: a layer, ``encode`` and the forward logits atol 1e-5;
prefill and decode logits 1e-4; gradients rtol 1e-4 with an atol of 1e-6;
greedy tokens identical in f32.  bf16: one cross-attention layer within
5e-2 + 2e-2 |out| of the reference's bf16 layer.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_layers import close, make_requests, np_params, tiny_cfgs, to_jax, tokens

from repro.configs import get_config as jax_config
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serve import engine as JE
from repro.train import loop as JLOOP
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as torch_config
from repro_torch.core import tree as TREE
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.serve import engine as TE
from repro_torch.train import loop as TLOOP

pytestmark = pytest.mark.torch

SEAMLESS, PIXTRAL = "seamless-m4t-medium", "pixtral-12b"
S_ENC = 20  # source frames: not a multiple of any tile


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny models: one intra-op thread, as in test_torch_decode.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(arch, seed, **over):
    jcfg, tcfg = tiny_cfgs(arch, **over)
    npp = np_params(jcfg, seed)
    return jcfg, tcfg, to_jax(npp), params_from_numpy(npp, "cpu")


def _embeds(seed, b, l, d):
    """Frame or patch embeddings, the reference's stub: normal × 0.02."""
    return (0.02 * np.random.default_rng(seed).standard_normal(
        (b, l, d))).astype(np.float32)


def _memory(jcfg, tcfg, jp, tp, seed, b):
    """The encoder's output for ``b`` seeded source rows, from each
    package: (JAX memory, the port's memory)."""
    src = _embeds(seed, b, S_ENC, jcfg.d_model)
    with torch.no_grad():
        tm = TT.encode(tp, tcfg, embeds=torch.from_numpy(src))
    return JT.encode(jp, jcfg, embeds=jnp.asarray(src)), tm


def _gens(finished):
    return {r.rid: list(r.generated) for r in finished}


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", [SEAMLESS, PIXTRAL])
def test_init_model_layout_matches_reference(arch):
    """Every leaf's path and shape, the decoder's cross leaves and the
    encoder's (n_enc, ...) stack without a "0" key included."""
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
    enc_dec = arch == SEAMLESS
    assert ("encoder" in ours) == enc_dec
    assert ("cross_attn" in ours["stack"]["0"]) == enc_dec
    if enc_dec:
        assert list(ours["stack"]["0"]) == ["pre_norm", "attn", "cross_norm",
                                            "cross_attn", "ffn_norm", "mlp"]
        assert list(ours["encoder"]["stack"]) == ["pre_norm", "attn",
                                                  "ffn_norm", "mlp"]
        assert ours["encoder"]["stack"]["attn"]["wq"].shape[0] \
            == tcfg.num_encoder_layers == 2


# (config overrides, what the case brings): MHA without bias, MHA with
# qkv bias, and qk-norm on a GQA cut
CROSS_CASES = {"plain": dict(), "bias": dict(qkv_bias=True),
               "qk_norm_gqa": dict(qk_norm=True, num_kv_heads=2)}


@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("case", list(CROSS_CASES))
def test_cross_attention_matches_jax(case, kernel):
    """``cross_attention`` against the reference's ``attention(...,
    memory=)``: the masked ``_sdpa`` and the flash path's plain version."""
    jcfg, tcfg = tiny_cfgs(SEAMLESS, **CROSS_CASES[case])
    npp = np_params(jcfg, 1)
    p = jax.tree.map(lambda a: a[0], npp["stack"]["0"]["cross_attn"])
    assert ("bq" in p) == (case == "bias")
    assert ("q_norm" in p) == (case == "qk_norm_gqa")
    rng = np.random.default_rng(len(case))
    x = rng.standard_normal((2, 7, jcfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, S_ENC, jcfg.d_model)).astype(np.float32)
    pos = jnp.broadcast_to(jnp.arange(7, dtype=jnp.int32), (2, 7))
    jout, _ = JL.attention(to_jax(p), jcfg, jnp.asarray(x), pos, -1,
                           jcfg.rope_theta, memory=jnp.asarray(mem))
    tout = TL.cross_attention(params_from_numpy(p, "cpu"), tcfg,
                              torch.from_numpy(x), torch.from_numpy(mem),
                              kernel)
    close(tout, jout, atol=1e-5)


def test_cross_attention_kernel_path_is_one_flash_call(monkeypatch):
    """The serving path's cross attention is one ``flash_attention`` call,
    non-causal, on the (B, H, L, Dh) views with Lq != Lk; the loss's makes
    none."""
    jcfg, tcfg = tiny_cfgs(SEAMLESS)
    p = params_from_numpy(jax.tree.map(
        lambda a: a[0], np_params(jcfg, 2)["stack"]["0"]["cross_attn"]),
        "cpu")
    calls = []
    inner = fa.flash_attention_plain

    def spy(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), kw))
        return inner(q, k, v, **kw)

    monkeypatch.setattr(fa, "flash_attention_plain", spy)
    x = torch.randn(3, 1, jcfg.d_model)
    mem = torch.randn(3, S_ENC, jcfg.d_model)
    TL.cross_attention(p, tcfg, x, mem, kernel=False)
    assert calls == []
    TL.cross_attention(p, tcfg, x, mem, kernel=True)
    h, dh = jcfg.num_heads, jcfg.resolved_head_dim
    assert calls == [((3, h, 1, dh), (3, jcfg.num_kv_heads, S_ENC, dh),
                      {"causal": False, "window": -1})]


def test_cross_attention_kernel_path_raises_on_a_softcap():
    jcfg, tcfg = tiny_cfgs(SEAMLESS, attn_logit_softcap=50.0)
    p = params_from_numpy(jax.tree.map(
        lambda a: a[0], np_params(jcfg, 2)["stack"]["0"]["cross_attn"]),
        "cpu")
    x, mem = torch.randn(1, 2, 64), torch.randn(1, 5, 64)
    with pytest.raises(ValueError, match="softcap"):
        TL.cross_attention(p, tcfg, x, mem, kernel=True)
    TL.cross_attention(p, tcfg, x, mem, kernel=False)  # _sdpa caps


def test_cross_attention_bf16():
    """bf16 weights and activations: the port's flash path (PV in f32)
    within 5e-2 + 2e-2 |out| of the reference's bf16 layer (P rounded to
    bf16 before PV)."""
    jcfg, tcfg = tiny_cfgs(SEAMLESS, param_dtype="bfloat16",
                           compute_dtype="bfloat16")
    p = jax.tree.map(lambda a: np.asarray(jnp.asarray(a[0], jnp.bfloat16)),
                     np_params(jcfg, 3)["stack"]["0"]["cross_attn"])
    rng = np.random.default_rng(3)
    x, mem = (np.asarray(jnp.asarray(rng.standard_normal(
        (2, n, jcfg.d_model)), jnp.bfloat16)) for n in (7, S_ENC))
    pos = jnp.broadcast_to(jnp.arange(7, dtype=jnp.int32), (2, 7))
    jout, _ = JL.attention(to_jax(p), jcfg, jnp.asarray(x), pos, -1,
                           jcfg.rope_theta, memory=jnp.asarray(mem))
    tp = params_from_numpy(p, "cpu")
    j = np.asarray(jout, np.float32)
    for kernel in (True, False):
        tout = TL.cross_attention(
            tp, tcfg, torch.from_numpy(np.array(x, np.float32)).bfloat16(),
            torch.from_numpy(np.array(mem, np.float32)).bfloat16(), kernel)
        assert tout.dtype == torch.bfloat16
        t = tout.float().numpy()
        assert np.all(np.abs(t - j) <= 5e-2 + 2e-2 * np.abs(j)), kernel


@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("source", ["embeds", "tokens"])
def test_encode_matches_jax(source, kernel):
    """The encoder from frame embeddings (cast, not scaled) and from
    tokens, on the loss's ``_sdpa`` path and the serving path."""
    jcfg, tcfg, jp, tp = _setup(SEAMLESS, 4)
    if source == "embeds":
        src = _embeds(4, 2, S_ENC, jcfg.d_model)
        jm = JT.encode(jp, jcfg, embeds=jnp.asarray(src))
        tm = TT.encode(tp, tcfg, embeds=torch.from_numpy(src), kernel=kernel)
    else:
        src = tokens(4, 2, S_ENC)
        jm = JT.encode(jp, jcfg, tokens=jnp.asarray(src))
        tm = TT.encode(tp, tcfg, tokens=torch.from_numpy(src), kernel=kernel)
    assert tuple(tm.shape) == (2, S_ENC, jcfg.d_model)
    close(tm.detach(), jm, atol=1e-5)


# ---------------------------------------------------------------------------
# the model: forward, loss, prefill and decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", [SEAMLESS, PIXTRAL])
def test_forward_logits_match_jax(arch):
    """seamless decodes tokens over its memory; pixtral reads embeddings."""
    jcfg, tcfg, jp, tp = _setup(arch, 5)
    if arch == SEAMLESS:
        toks = tokens(5, 2, 12)
        jmem, tmem = _memory(jcfg, tcfg, jp, tp, 5, 2)
        jl, _ = JT.forward(jp, jcfg, tokens=jnp.asarray(toks), memory=jmem)
        with torch.no_grad():
            tl, _ = TT.forward(tp, tcfg, torch.from_numpy(toks), memory=tmem)
    else:
        emb = _embeds(5, 2, 12, jcfg.d_model)
        jl, _ = JT.forward(jp, jcfg, embeds=jnp.asarray(emb))
        with torch.no_grad():
            tl, _ = TT.forward(tp, tcfg, embeds=torch.from_numpy(emb))
    assert tuple(tl.shape) == (2, 12, jcfg.vocab_size)
    close(tl, jl, atol=1e-5)


def test_forward_without_memory_raises_as_the_reference():
    jcfg, tcfg, jp, tp = _setup(SEAMLESS, 6)
    toks = tokens(6, 1, 4)
    with pytest.raises(ValueError, match="requires encoder `memory`"):
        JT.forward(jp, jcfg, tokens=jnp.asarray(toks))
    with pytest.raises(ValueError, match="requires encoder `memory`"):
        TT.forward(tp, tcfg, torch.from_numpy(toks))


@pytest.mark.parametrize("arch", [SEAMLESS, PIXTRAL])
def test_loss_gradients_match_jax(arch):
    """``jax.grad`` of ``make_loss_fn`` against autograd on every leaf:
    seamless's encoder stack and cross leaves through ``source_embeds``,
    pixtral's through ``embeds``."""
    jcfg, tcfg, jp, tp = _setup(arch, 7)
    labels = tokens(7, 2, 10)
    if arch == SEAMLESS:
        batch = {"tokens": labels, "labels": labels,
                 "source_embeds": _embeds(7, 2, S_ENC, jcfg.d_model)}
    else:
        batch = {"embeds": _embeds(7, 2, 10, jcfg.d_model), "labels": labels}
    jl, jg = jax.value_and_grad(JLOOP.make_loss_fn(jcfg, remat=False))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = TREE.leaves(tp)
    for x in leaves:
        x.requires_grad_()
    tl = TLOOP.make_loss_fn(tcfg, remat=False)(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    # pixtral reads no row of ``embed``: JAX's gradient there is zeros
    tg = [torch.zeros_like(x) if g is None else g for x, g in zip(
        leaves, torch.autograd.grad(tl, leaves, allow_unused=True))]
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    paths = [jax.tree_util.keystr(k)
             for k, _ in jax.tree_util.tree_flatten_with_path(jg)[0]]
    assert len(tg) == len(paths)
    if arch == SEAMLESS:
        assert any("encoder" in k for k in paths)
        assert any("cross_attn" in k for k in paths)
    for path, a, b in zip(paths, tg, jax.tree.leaves(jg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-6, err_msg=path)
        if "encoder" in path and "scale" not in path:
            assert np.abs(np.asarray(b)).max() > 1e-6, path


def test_remat_gradients_equal_no_remat_with_memory():
    _, tcfg, _, tp = _setup(SEAMLESS, 8)
    toks = torch.from_numpy(tokens(8, 2, 10))
    src = torch.from_numpy(_embeds(8, 2, S_ENC, tcfg.d_model))
    grads = []
    for remat in (False, True):
        leaves = [x.detach().clone().requires_grad_()
                  for x in TREE.leaves(tp)]
        p = TREE.unflatten(TREE.flatten(tp)[1], leaves)
        loss = TLOOP.make_loss_fn(tcfg, remat=remat)(
            p, {"tokens": toks, "labels": toks, "source_embeds": src})
        grads.append(torch.autograd.grad(loss, leaves))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", [SEAMLESS, PIXTRAL])
def test_prefill_matches_forward_as_in_jax(arch):
    """The reference's ``test_prefill_matches_forward`` on both packages:
    prefill over L - 1 positions, then one ``decode_step`` (pixtral's from
    ``embeds``), each against the JAX functions at 1e-4."""
    jcfg, tcfg, jp, tp = _setup(arch, 9)
    b, l = 2, 12
    toks = tokens(9, b, l)
    jmem = tmem = emb = None
    if arch == SEAMLESS:
        jmem, tmem = _memory(jcfg, tcfg, jp, tp, 9, b)
    else:
        emb = _embeds(9, b, l, jcfg.d_model)
    jref, _ = JT.forward(jp, jcfg, tokens=None if emb is not None
                         else jnp.asarray(toks), embeds=None if emb is None
                         else jnp.asarray(emb), memory=jmem)
    jpf, jcache = JT.prefill(
        jp, jcfg, tokens=None if emb is not None else jnp.asarray(toks)[:, :-1],
        embeds=None if emb is None else jnp.asarray(emb)[:, :-1], memory=jmem)
    with torch.no_grad():
        tpf, tcache = TT.prefill(
            tp, tcfg, None if emb is not None
            else torch.from_numpy(toks)[:, :-1],
            embeds=None if emb is None else torch.from_numpy(emb)[:, :-1],
            memory=tmem)
    close(tpf, jpf, atol=1e-4)
    close(tpf, jref[:, :-1], atol=1e-4)
    jcache = JT.pad_prefill_cache(jcfg, jcache, l)
    tcache = TT.pad_prefill_cache(tcfg, tcache, l)
    jl, _ = JT.decode_step(
        jp, jcfg, token=jnp.asarray(toks[:, -1]) if emb is None else None,
        embeds=None if emb is None else jnp.asarray(emb[:, -1:]),
        pos=jnp.int32(l - 1), cache=jcache, memory=jmem)
    with torch.no_grad():
        tl = TT.decode_step(
            tp, tcfg, torch.from_numpy(toks[:, -1]) if emb is None else None,
            l - 1, tcache, memory=tmem,
            embeds=None if emb is None else torch.from_numpy(emb[:, -1:]))
    close(tl, jl, atol=1e-4)
    close(tl, jref[:, -1], atol=1e-4)


def test_prefill_and_decode_without_memory_skip_cross_attention():
    """The reference's quirk, mirrored: an encoder-decoder ``prefill`` or
    ``decode_step`` given no memory runs no cross attention."""
    jcfg, tcfg, jp, tp = _setup(SEAMLESS, 10)
    toks = tokens(10, 1, 8)
    jl, jcache = JT.prefill(jp, jcfg, tokens=jnp.asarray(toks))
    with torch.no_grad():
        tl, tcache = TT.prefill(tp, tcfg, torch.from_numpy(toks))
    close(tl, jl, atol=1e-4)
    jcache = JT.pad_prefill_cache(jcfg, jcache, 9)
    tcache = TT.pad_prefill_cache(tcfg, tcache, 9)
    jl, _ = JT.decode_step(jp, jcfg, token=jnp.asarray(toks[:, -1]),
                           pos=jnp.int32(8), cache=jcache)
    with torch.no_grad():
        tl = TT.decode_step(tp, tcfg, torch.from_numpy(toks[:, -1]), 8,
                            tcache)
    close(tl, jl, atol=1e-4)


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------
def test_greedy_generate_with_memory_tokens_match_jax():
    jcfg, tcfg, jp, tp = _setup(SEAMLESS, 11)
    jmem, tmem = _memory(jcfg, tcfg, jp, tp, 11, 1)
    prompt = tokens(11, 1, 16)[0]
    want = JE.greedy_generate(jp, jcfg, prompt, max_new_tokens=8,
                              memory=jmem)
    got = TE.greedy_generate(tp, tcfg, prompt, max_new_tokens=8,
                             device="cpu", memory=tmem)
    assert got == want and len(got) == 8


def test_decode_engine_with_memory_reuses_slots_like_jax():
    """Seven requests through three slots, every slot reused; slot i
    attends to memory row i whatever request it holds."""
    jcfg, tcfg, jp, tp = _setup(SEAMLESS, 12)
    jmem, tmem = _memory(jcfg, tcfg, jp, tp, 12, 3)
    jeng = JE.DecodeEngine(jp, jcfg, batch_slots=3, max_seq=40,
                           memory=jmem)
    teng = TE.DecodeEngine(tp, tcfg, batch_slots=3, max_seq=40,
                           device="cpu", memory=tmem)
    for eng, mod in ((jeng, JE), (teng, TE)):
        for r in make_requests(mod.Request, 12, 7, 2, 24):
            eng.submit(r)
    got = _gens(teng.run())
    assert got == _gens(jeng.run()) and len(got) == 7
    assert teng.steps == jeng.steps


def test_hybrid_encoder_decoder_runs_as_in_jax():
    """jamba ``.reduced()`` (16 layers: attention, Mamba and MoE) made an
    encoder-decoder with 2 encoder layers: ``encode``, ``prefill`` with
    memory and ``decode_step`` with memory, as the reference runs them
    (its ``_apply_layer`` runs mixer → cross → FFN whatever the mixer)."""
    arch = "jamba-1.5-large-398b"
    over = dict(ssm_chunk=16, is_encoder_decoder=True, num_encoder_layers=2)
    jcfg = dataclasses.replace(jax_config(arch).reduced(), **over)
    tcfg = dataclasses.replace(torch_config(arch).reduced(), **over)
    npp = np_params(jcfg, 13)
    jp, tp = to_jax(npp), params_from_numpy(npp, "cpu")
    assert "cross_attn" in tp["stack"]["1"] and "mamba" in tp["stack"]["1"]
    src = _embeds(13, 2, S_ENC, jcfg.d_model)
    jmem = JT.encode(jp, jcfg, embeds=jnp.asarray(src))
    toks = tokens(13, 2, 24, vocab=512)
    jl, jcache = JT.prefill(jp, jcfg, tokens=jnp.asarray(toks), memory=jmem,
                            last_only=True)
    with torch.no_grad():
        tmem = TT.encode(tp, tcfg, embeds=torch.from_numpy(src))
        close(tmem, jmem, atol=1e-5)
        tl, tcache = TT.prefill(tp, tcfg, torch.from_numpy(toks),
                                last_only=True, memory=tmem)
    close(tl, jl, atol=1e-4)
    jcache = JT.pad_prefill_cache(jcfg, jcache, 27)
    tcache = TT.pad_prefill_cache(tcfg, tcache, 27)
    tok = np.array(jnp.argmax(jl[:, -1], -1), np.int32)
    for pos in range(24, 27):
        jl, jcache = JT.decode_step(jp, jcfg, token=jnp.asarray(tok),
                                    pos=jnp.int32(pos), cache=jcache,
                                    memory=jmem)
        with torch.no_grad():
            tl = TT.decode_step(tp, tcfg, torch.from_numpy(tok), pos, tcache,
                                memory=tmem)
        close(tl, jl, atol=1e-4)
        tok = np.array(jnp.argmax(jl, -1), np.int32)
