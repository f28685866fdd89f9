"""The port's PagedDecodeEngine and KV-cache bookkeeping against the JAX
package, on the CPU.

Correctness bar as in tests/test_serving.py: greedy tokens identical to
the JAX ``PagedDecodeEngine`` (its jnp gather path) in f32, recompute
eviction changes no output, and the page pool drains clean.  With bf16
pools XLA and PyTorch round at different places, so there the per-step
logits are held within atol 5e-2 and the tokens are not required to match.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_layers import ARCHS, np_params, tiny_cfgs, to_jax

from repro.models import transformer as JT
from repro.serve import engine as JE
from repro.serve import kv_cache as JK
from repro_torch.bridge import params_from_numpy
from repro_torch.models import transformer as TT
from repro_torch.serve import engine as TE
from repro_torch.serve import kv_cache as TK

pytestmark = pytest.mark.torch


def _requests(Request, seed, n, lo, hi, max_new=(1, 10)):
    rng = np.random.default_rng(seed)
    return [Request(rid=i,
                    prompt=np.asarray(rng.integers(1, 64, size=int(l)),
                                      np.int32),
                    max_new_tokens=int(m))
            for i, (l, m) in enumerate(zip(
                rng.integers(lo, hi, size=n),
                rng.integers(max_new[0], max_new[1], size=n)))]


def _gens(finished):
    return {r.rid: list(r.generated) for r in finished}


def _engines(arch, seed, **kw):
    jcfg, tcfg = tiny_cfgs(arch)
    npp = np_params(jcfg, seed)
    jeng = JE.PagedDecodeEngine(to_jax(npp), jcfg, use_kernel=False, **kw)
    teng = TE.PagedDecodeEngine(params_from_numpy(npp, "cpu"), tcfg,
                                device="cpu", **kw)
    return jeng, teng


# ---------------------------------------------------------------------------
# engine parity
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("lo,hi", [(1, 12), (16, 40)])  # short + long mixes
def test_engine_matches_jax_engine_f32(arch, lo, hi):
    jeng, teng = _engines(arch, 0, batch_slots=3, max_seq=48, page_size=4,
                          chunk_size=8)
    for eng, mod in ((jeng, JE), (teng, TE)):
        for r in _requests(mod.Request, 3, 7, lo, hi):
            eng.submit(r)
    assert _gens(teng.run()) == _gens(jeng.run())
    assert teng.steps == jeng.steps
    teng.kv.allocator.check()
    assert teng.kv.allocator.num_allocated == 0


def test_engine_int8_pool_matches_jax_engine():
    """int8 pools take the gather path on both sides; the quantization is
    bit-exact (test_torch_layers), so the tokens match."""
    jeng, teng = _engines("qwen2-1.5b", 1, batch_slots=2, max_seq=32,
                          page_size=4, chunk_size=8, cache_dtype="int8")
    assert teng.cache["0"]["k_pages"].dtype == torch.int8
    for eng, mod in ((jeng, JE), (teng, TE)):
        for r in _requests(mod.Request, 4, 3, 2, 16, max_new=(3, 6)):
            eng.submit(r)
    assert _gens(teng.run()) == _gens(jeng.run())


def test_eviction_completes_identically_and_no_leak():
    """A page-starved pool forces head-of-line blocking and recompute
    eviction; the tokens match the ample pool's and no page leaks."""
    jcfg, tcfg = tiny_cfgs("qwen2-1.5b")
    params = params_from_numpy(np_params(jcfg, 0), "cpu")
    kw = dict(batch_slots=3, max_seq=48, page_size=4, chunk_size=8,
              device="cpu")
    ample = TE.PagedDecodeEngine(params, tcfg, **kw)
    tiny = TE.PagedDecodeEngine(params, tcfg, num_pages=1 + 12, **kw)
    for eng in (ample, tiny):
        for r in _requests(TE.Request, 7, 8, 1, 20):
            eng.submit(r)
    assert _gens(ample.run()) == _gens(tiny.run())
    assert sum(r.evictions for r in tiny.finished) > 0
    tiny.kv.allocator.check()
    assert tiny.kv.allocator.num_allocated == 0


def test_preemption_drain_releases_all_pages():
    _, tcfg = tiny_cfgs("qwen2-1.5b")
    eng = TE.PagedDecodeEngine(
        params_from_numpy(np_params(tiny_cfgs("qwen2-1.5b")[0], 0), "cpu"),
        tcfg, batch_slots=2, max_seq=48, page_size=4, chunk_size=4,
        device="cpu")
    for r in _requests(TE.Request, 9, 5, 8, 30, max_new=(20, 30)):
        eng.submit(r)
    done = eng.run(max_steps=3)  # force a mid-flight drain
    assert any(r.preempted for r in done)
    eng.kv.allocator.check()
    assert eng.kv.allocator.num_allocated == 0
    assert (eng.kv.tables == 0).all()


def test_submit_truncates_and_completes_empty_prompts():
    _, tcfg = tiny_cfgs("qwen2-1.5b")
    eng = TE.PagedDecodeEngine(
        params_from_numpy(np_params(tiny_cfgs("qwen2-1.5b")[0], 0), "cpu"),
        tcfg, batch_slots=1, max_seq=16, page_size=4, device="cpu")
    empty = TE.Request(rid=0, prompt=np.zeros(0, np.int32), max_new_tokens=3)
    long = TE.Request(rid=1, prompt=np.arange(1, 41, dtype=np.int32),
                      max_new_tokens=5)
    eng.submit(empty)
    eng.submit(long)
    assert empty.done and empty.generated == []
    assert long.truncated and list(long.prompt) == list(range(26, 41))
    eng.run()
    # the prompt holds 15 of 16 positions: prefill gives one token and the
    # decode step that writes position 15 gives the last
    assert long.done and len(long.generated) == 2


# ---------------------------------------------------------------------------
# bf16 pools: per-step logits within tolerance
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_pool_step_logits(arch):
    jcfg, tcfg = tiny_cfgs(arch)
    npp = np_params(jcfg, 2)
    jp, tp = to_jax(npp), params_from_numpy(npp, "cpu")
    b, ps, mb, chunk = 2, 4, 8, 20
    bt = (1 + np.arange(b * mb, dtype=np.int32)).reshape(b, mb)
    jcache = JT.init_paged_cache(jcfg, 1 + b * mb, ps, dtype=jnp.bfloat16)
    tcache = TT.init_paged_cache(tcfg, 1 + b * mb, ps, dtype="bfloat16",
                                 device="cpu")
    toks = np.random.default_rng(2).integers(0, 64, (b, chunk))
    toks = toks.astype(np.int32)
    poss = np.tile(np.arange(chunk, dtype=np.int32), (b, 1))
    last = np.full((b,), chunk - 1, np.int32)
    jl, jcache = JT.prefill_chunk_paged(jp, jcfg, jnp.asarray(toks),
                                        jnp.asarray(poss), jcache,
                                        jnp.asarray(bt), jnp.asarray(last))
    tl = TT.prefill_chunk_paged(tp, tcfg, torch.from_numpy(toks),
                                torch.from_numpy(poss), tcache,
                                torch.from_numpy(bt), torch.from_numpy(last))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=5e-2)
    pos = np.full((b,), chunk, np.int32)
    for _ in range(4):
        tok = np.array(jnp.argmax(jl, -1), np.int32)  # one token stream
        jl, jcache = JT.decode_step_paged(jp, jcfg, jnp.asarray(tok),
                                          jnp.asarray(pos), jcache,
                                          jnp.asarray(bt))
        tl = TT.decode_step_paged(tp, tcfg, torch.from_numpy(tok),
                                  torch.from_numpy(pos), tcache,
                                  torch.from_numpy(bt))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=5e-2)
        pos += 1


# ---------------------------------------------------------------------------
# block allocator / paged cache: the port's copy of serve/kv_cache.py
# ---------------------------------------------------------------------------
def test_block_allocator_invariants():
    a = TK.BlockAllocator(num_pages=9, page_size=4)
    assert a.num_free == 8  # page 0 reserved
    got = a.alloc(3)
    assert len(got) == 3 and 0 not in got
    a.check()
    assert a.alloc(6) is None          # all-or-nothing: 5 free < 6
    assert a.num_free == 5             # failed alloc allocated nothing
    a.free(got)
    a.check()
    with pytest.raises(ValueError):    # double-free
        a.free(got)
    a.check()
    assert [a.blocks_for(n) for n in (0, 1, 4, 5)] == [0, 1, 1, 2]


def test_paged_kv_cache_admit_grow_release():
    kv = TK.PagedKVCache(num_slots=2, pages_per_seq=4,
                         allocator=TK.BlockAllocator(num_pages=8,
                                                     page_size=4))
    assert kv.admit(0, 6)              # 2 pages
    assert kv.tables[0, 0] != 0 and kv.tables[0, 1] != 0
    assert kv.tables[0, 2] == 0        # unallocated → trash
    assert kv.ensure(0, 6)             # covered: no-op
    assert kv.ensure(0, 9)             # grow to 3 pages
    assert kv.admit(1, 16)             # 4 pages
    assert not kv.ensure(0, 16)        # pool exhausted (7 of 7 used)
    kv.release(1)
    kv.allocator.check()
    assert kv.ensure(0, 16)
    kv.release(0)
    kv.allocator.check()
    assert kv.allocator.num_allocated == 0
    assert (kv.tables == 0).all()


def test_kv_cache_copy_tracks_reference_op_for_op():
    """A seeded stream of admit/ensure/release leaves both copies in the
    same state after every operation."""
    rng = np.random.default_rng(0)
    caches = [mod.PagedKVCache(4, 6, mod.BlockAllocator(16, 4))
              for mod in (JK, TK)]
    for _ in range(300):
        op, slot = int(rng.integers(3)), int(rng.integers(4))
        n = int(rng.integers(1, 25))
        res = []
        for c in caches:
            if op == 0:
                res.append(c.admit(slot, n) if not c.owned[slot] else None)
            elif op == 1:
                res.append(c.ensure(slot, n))
            else:
                res.append(c.release(slot))
        assert res[0] == res[1]
        np.testing.assert_array_equal(caches[0].tables, caches[1].tables)
        assert caches[0].owned == caches[1].owned
        assert caches[0].allocator._free == caches[1].allocator._free
        caches[1].allocator.check()


def test_engine_rejects_recurrent_stacks():
    import dataclasses

    _, tcfg = tiny_cfgs("qwen2-1.5b")
    hybrid = dataclasses.replace(tcfg, family="hybrid", attn_every=2)
    with pytest.raises(ValueError, match="attention-only"):
        TT.init_paged_cache(hybrid, num_pages=4, page_size=4, device="cpu")


def test_jax_engine_kernel_flag_is_off_here():
    """The JAX side of these parities is its gather path (CPU backend)."""
    assert jax.default_backend() == "cpu"
