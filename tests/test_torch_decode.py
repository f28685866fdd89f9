"""The port's dense serving path against the JAX package, on the CPU:
``prefill`` (whose attention is ``flash_attention_plain`` here), the dense
cache's ``decode_step`` with a scalar and a ragged position,
``pad_prefill_cache``, ``greedy_generate`` and ``DecodeEngine``.

Inputs are made with numpy from a seed and handed to both packages; one
prefilled cache goes to both ``decode_step``s through
``bridge.cache_from_numpy``.  Tolerances: logits and caches atol 1e-4 in
f32 (two layers and a 64-wide tied head; the flash path sums PV in
another order than the reference's ``_sdpa``); greedy tokens identical in
f32.  In bf16 the reference casts the probabilities to v's dtype before
PV and the port's prefill keeps PV in f32, so there the logits are held
within atol 5e-2, as the bf16 pools in tests/test_torch_serving.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_layers import ARCHS, close, np_params, tiny_cfgs, to_jax
from test_torch_layers import make_requests as _requests
from test_torch_layers import tokens as _tokens

from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serve import engine as JE
from repro_torch.bridge import (cache_from_numpy, cache_to_numpy,
                                params_from_numpy)
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.serve import engine as TE

pytestmark = pytest.mark.torch

L_PROMPT = 48  # three times the reduced window of 16: the window masks


@pytest.fixture(autouse=True)
def one_torch_thread():
    """These models are tiny: one intra-op thread runs them as fast as
    many, and does not slow down by orders of magnitude when parallel test
    workers, each at the default thread count, share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(arch, seed):
    jcfg, tcfg = tiny_cfgs(arch)
    npp = np_params(jcfg, seed)
    return jcfg, tcfg, to_jax(npp), params_from_numpy(npp, "cpu")


def _gens(finished):
    return {r.rid: list(r.generated) for r in finished}


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_attention_prefill_layer(arch):
    """One layer's prefill attention and its collected k/v against the
    reference's ``attention(..., collect_cache=True)``, at every (window,
    theta) the config's layers use."""
    jcfg, tcfg = tiny_cfgs(arch)
    attn = jax.tree.map(lambda a: a[0],
                        np_params(jcfg, 1)["stack"]["0"]["attn"])
    x = np.random.default_rng(1).standard_normal(
        (2, L_PROMPT, jcfg.d_model)).astype(np.float32)
    pos = jnp.broadcast_to(jnp.arange(L_PROMPT, dtype=jnp.int32),
                           (2, L_PROMPT))
    windows, thetas = jcfg.layer_windows()
    pairs = {(int(w), float(t)) for w, t in zip(windows.ravel(),
                                                thetas.ravel())}
    assert len(pairs) == (2 if arch == "gemma3-1b" else 1)
    for w, th in pairs:
        jout, jkv = JL.attention(to_jax(attn), jcfg, jnp.asarray(x), pos,
                                 jnp.int32(w), jnp.float32(th),
                                 collect_cache=True)
        tout, tkv = TL.attention_prefill(params_from_numpy(attn, "cpu"), tcfg,
                                         torch.from_numpy(x), w, th)
        close(tout, jout)
        close(tkv["k"], jkv["k"])
        close(tkv["v"], jkv["v"])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_cache(arch):
    jcfg, tcfg, jp, tp = _setup(arch, 2)
    toks = _tokens(2, 2, L_PROMPT)
    jl, jcache = JT.prefill(jp, jcfg, tokens=jnp.asarray(toks))
    before = fa.flash_attention.launches
    tl, tcache = TT.prefill(tp, tcfg, torch.from_numpy(toks))
    assert fa.flash_attention.launches == before  # CPU: the plain version
    assert tuple(tl.shape) == (2, L_PROMPT, jcfg.vocab_size)
    close(tl, jl, atol=1e-4)
    assert sorted(tcache) == sorted(jcache)
    for key in jcache:
        for name in ("k", "v"):
            assert tuple(tcache[key][name].shape) == jcache[key][name].shape
            close(tcache[key][name], jcache[key][name], atol=1e-4)
    jlast, _ = JT.prefill(jp, jcfg, tokens=jnp.asarray(toks), last_only=True)
    tlast, _ = TT.prefill(tp, tcfg, torch.from_numpy(toks), last_only=True)
    assert tuple(tlast.shape) == (2, 1, jcfg.vocab_size)
    close(tlast, jlast, atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_bf16(arch):
    """bf16 weights and activations: the port's PV stays in f32."""
    jcfg, tcfg = tiny_cfgs(arch, param_dtype="bfloat16",
                           compute_dtype="bfloat16")
    npp = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                       np_params(jcfg, 3))
    toks = _tokens(3, 2, L_PROMPT)
    jl, _ = JT.prefill(to_jax(npp), jcfg, tokens=jnp.asarray(toks))
    tl, tcache = TT.prefill(params_from_numpy(npp, "cpu"), tcfg,
                            torch.from_numpy(toks))
    assert tcache["0"]["k"].dtype == torch.bfloat16
    close(tl, jl, atol=5e-2)


def test_prefill_raises_for_a_logit_softcap():
    """The flash kernel has no softcap; prefill refuses such a config
    rather than take another path."""
    _, tcfg = tiny_cfgs("qwen2-1.5b", attn_logit_softcap=30.0)
    params = TT.init_model(torch.Generator().manual_seed(0), tcfg, "cpu")
    with pytest.raises(ValueError, match="softcap"):
        TT.prefill(params, tcfg, torch.zeros((1, 4), dtype=torch.int32))


# ---------------------------------------------------------------------------
# dense cache: pad and decode
# ---------------------------------------------------------------------------
def test_pad_prefill_cache_matches_reference():
    jcfg, tcfg, jp, tp = _setup("gemma3-1b", 4)
    toks = _tokens(4, 2, 20)
    _, jcache = JT.prefill(jp, jcfg, tokens=jnp.asarray(toks))
    _, tcache = TT.prefill(tp, tcfg, torch.from_numpy(toks))
    jpad = JT.pad_prefill_cache(jcfg, jcache, 32)
    tpad = TT.pad_prefill_cache(tcfg, tcache, 32)
    for key in jpad:
        for name in ("k", "v"):
            t = tpad[key][name]
            assert tuple(t.shape) == jpad[key][name].shape
            assert tuple(t.shape)[2] == 32
            assert not t[:, :, 20:].any()
            close(t, jpad[key][name], atol=1e-4)
    same = TT.pad_prefill_cache(tcfg, tcache, 20)  # already long enough
    assert same["0"]["k"] is tcache["0"]["k"]


def test_init_cache_layout_matches_reference():
    jcfg, tcfg = tiny_cfgs("qwen2-1.5b")
    jc = JT.init_cache(jcfg, 3, 16)
    tc = TT.init_cache(tcfg, 3, 16, device="cpu")
    assert sorted(tc) == sorted(jc)
    for key in jc:
        for name in ("k", "v"):
            assert tuple(tc[key][name].shape) == jc[key][name].shape
            assert tc[key][name].dtype == torch.float32
            assert not tc[key][name].any()
    assert TT.init_cache(tcfg, 1, 4, dtype="bfloat16", device="cpu")["0"][
        "v"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("ragged", [False, True])
def test_decode_step_from_one_prefilled_cache(arch, ragged):
    """The JAX package's prefilled and padded cache goes to both
    ``decode_step``s through the bridge; logits and caches agree step by
    step, with one position for every row or ragged positions."""
    jcfg, tcfg, jp, tp = _setup(arch, 5)
    b, lp, total = 3, 24, 40
    toks = _tokens(5, b, lp)
    jl, jcache = JT.prefill(jp, jcfg, tokens=jnp.asarray(toks),
                            last_only=True)
    jcache = JT.pad_prefill_cache(jcfg, jcache, total)
    tcache = cache_from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    tok = np.array(jnp.argmax(jl[:, -1], -1), np.int32)
    # ragged rows sit at different positions (the cache beyond each row's
    # own prompt holds another row's prefix: a valid, if odd, history)
    pos = np.asarray([lp, lp - 5, lp - 11], np.int32) if ragged else lp
    for _ in range(4):
        jpos = jnp.asarray(pos) if ragged else jnp.int32(pos)
        tpos = torch.from_numpy(pos) if ragged else int(pos)
        jl, jcache = JT.decode_step(jp, jcfg, token=jnp.asarray(tok),
                                    pos=jpos, cache=jcache)
        tl = TT.decode_step(tp, tcfg, torch.from_numpy(tok), tpos, tcache)
        close(tl, jl, atol=1e-4)
        for key in jcache:
            for name in ("k", "v"):
                close(tcache[key][name], jcache[key][name], atol=1e-4)
        tok = np.array(jnp.argmax(jl, -1), np.int32)
        pos = pos + 1


def test_cache_bridge_round_trip_bitwise():
    jcfg, _ = tiny_cfgs("gemma3-1b")
    rng = np.random.default_rng(6)
    jc = jax.tree.map(np.asarray, JT.init_cache(jcfg, 2, 8))
    jc = jax.tree.map(lambda a: rng.standard_normal(a.shape)
                      .astype(np.float32), jc)
    jc["0"]["v"] = np.asarray(jnp.asarray(jc["0"]["v"], jnp.bfloat16))
    back = cache_to_numpy(cache_from_numpy(jc, "cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(jc)
    for a, b in zip(jax.tree.leaves(jc), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


# ---------------------------------------------------------------------------
# greedy_generate and DecodeEngine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_tokens_match_jax(arch):
    jcfg, tcfg, jp, tp = _setup(arch, 7)
    prompt = _tokens(7, 1, L_PROMPT)[0]
    want = JE.greedy_generate(jp, jcfg, prompt, max_new_tokens=8)
    got = TE.greedy_generate(tp, tcfg, prompt, max_new_tokens=8,
                             device="cpu")
    assert got == want and len(got) == 8
    assert TE.greedy_generate(tp, tcfg, prompt, 1, device="cpu") == want[:1]


def _three_engines(arch, seed, **kw):
    jcfg, tcfg, jp, tp = _setup(arch, seed)
    return (JE.DecodeEngine(jp, jcfg, **kw),
            TE.DecodeEngine(tp, tcfg, device="cpu", **kw),
            TE.PagedDecodeEngine(tp, tcfg, page_size=4, chunk_size=8,
                                 device="cpu", **kw))


@pytest.mark.parametrize("lo,hi", [(1, 12), (16, 40)])  # short + long mixes
def test_decode_engine_matches_jax_and_paged(lo, hi):
    engs = _three_engines("qwen2-1.5b", 0, batch_slots=3, max_seq=48)
    for eng, mod in zip(engs, (JE, TE, TE)):
        for r in _requests(mod.Request, 3, 7, lo, hi):
            eng.submit(r)
    jd, td, tpg = (_gens(e.run()) for e in engs)
    assert td == jd
    assert td == tpg
    assert engs[1].steps == engs[0].steps


def test_decode_engine_gemma3_window_matches_jax_and_paged():
    """Prompts past the window of 16 on gemma3's local layers."""
    engs = _three_engines("gemma3-1b", 1, batch_slots=2, max_seq=40)
    for eng, mod in zip(engs, (JE, TE, TE)):
        for r in _requests(mod.Request, 5, 3, 2, 30, max_new=(2, 8)):
            eng.submit(r)
    jd, td, tpg = (_gens(e.run()) for e in engs)
    assert td == jd == tpg


def test_decode_engine_randomized_stream_matches_jax_and_paged():
    """Requests arrive in bursts between engine steps, with mixed lengths
    and budgets: admission and termination order match step for step."""
    jeng, teng, tpaged = _three_engines("qwen2-1.5b", 2, batch_slots=3,
                                        max_seq=48)

    def stream(eng, Request):
        rng = np.random.default_rng(11)
        reqs = _requests(Request, 12, 10, 1, 30, max_new=(1, 8))
        it = iter(reqs)
        pending = len(reqs)
        while pending or eng.queue or any(p != "idle" for p in eng.phase):
            for _ in range(int(rng.integers(0, 3))):
                r = next(it, None)
                if r is not None:
                    eng.submit(r)
                    pending -= 1
            eng.step()
        return _gens(eng.finished)

    got = stream(teng, TE.Request)
    assert got == stream(jeng, JE.Request)
    assert got == stream(tpaged, TE.Request)


def test_decode_engine_truncates_and_completes_empty_prompts():
    jeng, teng, _ = _three_engines("qwen2-1.5b", 3, batch_slots=1,
                                   max_seq=16)
    out = {}
    for eng, mod in ((jeng, JE), (teng, TE)):
        empty = mod.Request(rid=0, prompt=np.zeros(0, np.int32),
                            max_new_tokens=3)
        long = mod.Request(rid=1, prompt=np.arange(1, 41, dtype=np.int32),
                           max_new_tokens=5)
        eng.submit(empty)
        eng.submit(long)
        assert empty.done and empty.generated == []
        assert long.truncated and list(long.prompt) == list(range(26, 41))
        eng.run()
        # the prompt holds 15 of 16 positions: its last step gives one
        # token and the step that writes position 15 gives the last
        assert long.done and len(long.generated) == 2
        out[mod.__name__] = _gens(eng.finished)
    assert out["repro_torch.serve.engine"] == out["repro.serve.engine"]


def test_decode_engine_max_steps_drains_in_flight_requests():
    jeng, teng, _ = _three_engines("qwen2-1.5b", 4, batch_slots=2,
                                   max_seq=48)
    res = {}
    for eng, mod in ((jeng, JE), (teng, TE)):
        for r in _requests(mod.Request, 9, 5, 8, 30, max_new=(20, 30)):
            eng.submit(r)
        done = eng.run(max_steps=10)
        assert eng.steps == 10
        assert sum(r.preempted for r in done) == 2  # both slots in flight
        assert all(p == "idle" for p in eng.phase)
        assert len(eng.queue) == 3
        res[mod.__name__] = [(r.rid, r.preempted, r.done, list(r.generated))
                             for r in done]
    assert res["repro_torch.serve.engine"] == res["repro.serve.engine"]
    # the engine stays usable: the queue drains on the next run
    done = teng.run()
    assert len(done) == 5 and sum(r.done for r in done) == 3


def test_dense_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    _, tcfg = tiny_cfgs("qwen2-1.5b")
    params = TT.init_model(torch.Generator().manual_seed(0), tcfg, "cpu")
    with pytest.raises(RuntimeError, match="cuda.is_available"):
        TE.DecodeEngine(params, tcfg, batch_slots=1, max_seq=8)
    with pytest.raises(RuntimeError, match="cuda.is_available"):
        TE.greedy_generate(params, tcfg, [1, 2], 2)
    with pytest.raises(RuntimeError, match="cuda.is_available"):
        TT.init_cache(tcfg, 1, 8)
    with pytest.raises(RuntimeError, match="cuda.is_available"):
        cache_from_numpy({"0": {"k": np.zeros((1, 1, 2, 1, 4), np.float32)}})


def test_dense_engine_rejects_recurrent_stacks():
    """The dense engine serves jamba ``.reduced()`` with its experts (MoE
    FFNs inside the hybrid Mamba stack: tokens against JAX in
    tests/test_torch_moe.py) and a hybrid encoder-decoder stack with the
    encoder's memory (against JAX in tests/test_torch_encdec.py), which
    the paged cache rejects with the reference's message."""
    from repro_torch.configs import get_config

    jamba = dataclasses.replace(get_config("jamba-1.5-large-398b").reduced(),
                                d_model=64, vocab_size=64)
    assert jamba.num_experts and jamba.family == "hybrid"
    params = TT.init_model(torch.Generator().manual_seed(0), jamba, "cpu")
    eng = TE.DecodeEngine(params, jamba, batch_slots=1, max_seq=8,
                          device="cpu")
    eng.submit(TE.Request(rid=0, prompt=np.arange(1, 4, dtype=np.int32),
                          max_new_tokens=2))
    (done,) = eng.run()
    assert done.done and len(done.generated) == 2
    enc_dec = dataclasses.replace(jamba, num_experts=0,
                                  is_encoder_decoder=True,
                                  num_encoder_layers=2)
    params = TT.init_model(torch.Generator().manual_seed(1), enc_dec, "cpu")
    memory = TT.encode(params, enc_dec, embeds=torch.randn(2, 5, 64),
                       kernel=False)
    eng = TE.DecodeEngine(params, enc_dec, batch_slots=2, max_seq=8,
                          device="cpu", memory=memory)
    for rid in range(3):
        eng.submit(TE.Request(rid=rid, prompt=np.arange(1, 4, dtype=np.int32),
                              max_new_tokens=2))
    done = eng.run()
    assert len(done) == 3 and all(r.done and len(r.generated) == 2
                                  for r in done)
    with pytest.raises(ValueError, match="paged cache does not support "
                                         "encoder-decoder models"):
        TT.init_paged_cache(enc_dec, num_pages=4, page_size=4, device="cpu")


# ---------------------------------------------------------------------------
# the ported examples, at their default tiny sizes
# ---------------------------------------------------------------------------
def test_example_quickstart_trains_then_generates(capsys):
    from repro_torch.examples import quickstart

    tokens = quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("step")]
    assert losses[-1] < losses[0] and "replica divergence 0.0e+00" in out
    assert len(tokens) == 8 and all(0 <= t < 64 for t in tokens)


def test_example_serve_decode_dense_equals_paged(capsys):
    from repro_torch.examples import serve_decode

    dense, paged = serve_decode.main(["--device", "cpu",
                                      "--cache-dtype", "float32"])
    assert dense == paged and len(dense) == 10
    assert "page pool drained clean: True" in capsys.readouterr().out
