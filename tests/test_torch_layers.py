"""The port's layers and model steps against the JAX package, in f32.

Every input is made with numpy from a seed and handed to both packages:
parameters in the tree layout of ``repro.models.transformer.init_model``
(shapes from ``jax.eval_shape``), activations, pages and block tables.
The JAX side runs on the CPU through its jnp gather path, as its own
serving tests do; the port's single-token decode goes through
``paged_attention_plain``.  Tolerance: atol 1e-5 unless noted.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs import get_config as torch_config
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

pytestmark = pytest.mark.torch

ARCHS = ["qwen2-1.5b", "gemma3-1b"]
# qwen2 keeps KV=2 so the grouped (kv, g) query order is exercised; gemma3
# brings qk-norm, the sliding window (16 once reduced) and two rope thetas;
# the MoE cuts keep their routing shape at a small width: granite 8 experts
# top 4 with GQA, qwen2-moe 6 experts padded to 8, top 2, one shared
# expert, MHA with qkv bias; seamless an encoder-decoder with MHA (its
# reduced 2 encoder layers), pixtral GQA
TINY = {"qwen2-1.5b": dict(num_heads=4, num_kv_heads=2),
        "gemma3-1b": dict(num_heads=2, num_kv_heads=1),
        "granite-moe-1b-a400m": dict(num_heads=4, num_kv_heads=2,
                                     moe_d_ff=32, num_experts=8, top_k=4),
        "qwen2-moe-a2.7b": dict(num_heads=4, num_kv_heads=4, moe_d_ff=32,
                                num_experts=6, expert_pad_to=8, top_k=2),
        "seamless-m4t-medium": dict(num_heads=4, num_kv_heads=4),
        "pixtral-12b": dict(num_heads=4, num_kv_heads=2)}


def tiny_cfgs(arch, **over):
    """(JAX config, port config) of one tiny layout: 2 layers, d_model 64,
    vocab 64, as the JAX package's own serving tests."""
    kw = {**dict(num_layers=2, d_model=64, head_dim=32, d_ff=128,
                 vocab_size=64), **TINY[arch], **over}
    return (dataclasses.replace(jax_config(arch).reduced(), **kw),
            dataclasses.replace(torch_config(arch).reduced(), **kw))


def np_params(cfg, seed=0):
    """Seeded numpy parameters in ``init_model``'s tree layout, the
    recurrent mixers' and the MoE layers' leaves included."""
    shapes = jax.eval_shape(lambda k: JT.init_model(k, cfg),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, sds):
        name, shape = path[-1].key, sds.shape
        if name == "scale":
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name in ("bq", "bk", "bv", "conv_b", "dt_bias"):
            a = 0.1 * rng.standard_normal(shape)
        # the recurrent leaves near the reference's init: A = -(1..N),
        # skip D = 1, forget biases 3, sLSTM's R by its fan-in dh
        elif name == "A_log":
            a = np.log(np.arange(1, shape[-1] + 1)) \
                + 0.1 * rng.standard_normal(shape)
        elif name == "D":
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name == "fgate_bias":
            a = 3.0 + 0.1 * rng.standard_normal(shape)
        elif name == "b":  # sLSTM gate biases: i, f (3), z, o
            d = shape[-1] // 4
            a = np.concatenate([np.zeros(d), np.full(d, 3.0),
                                np.zeros(2 * d)]) \
                + 0.1 * rng.standard_normal(shape)
        elif name == "R":
            a = rng.standard_normal(shape) / np.sqrt(shape[2])
        else:  # stacked leaves lead with the repeat axis
            # the experts (R, E_pad, D, F) and (R, E_pad, F, D) by D and F
            expert = (len(path) > 1 and path[-2].key == "moe"
                      and name != "router")
            fan_in = (shape[-1] if name == "embed" else
                      shape[1] * shape[2] if name == "wo" else
                      shape[2] if expert else shape[1])
            a = rng.standard_normal(shape) / np.sqrt(fan_in)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def tokens(seed, b, lp, vocab=64):
    """(b, lp) int32 prompt tokens below ``vocab``."""
    return np.random.default_rng(seed).integers(0, vocab, (b, lp)) \
        .astype(np.int32)


def make_requests(Request, seed, n, lo, hi, max_new=(1, 10), vocab=64):
    """``n`` requests of the given package's ``Request`` class: prompt
    lengths in [lo, hi), tokens in [1, vocab), budgets in ``max_new``."""
    rng = np.random.default_rng(seed)
    return [Request(rid=i,
                    prompt=np.asarray(rng.integers(1, vocab, size=int(l)),
                                      np.int32),
                    max_new_tokens=int(m))
            for i, (l, m) in enumerate(zip(
                rng.integers(lo, hi, size=n),
                rng.integers(max_new[0], max_new[1], size=n)))]


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def close(a, b, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=atol, rtol=0)


def paged_setup(cfg, seed, b=3, ps=4, mb=6):
    """A random pool, scrambled tables, and per-row positions for one
    prefill chunk; row 0 is idle (all -1 positions, all-trash table)."""
    rng = np.random.default_rng(seed)
    n_pages = 1 + b * mb
    kv, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    pages = {"k_pages": rand(rng, n_pages, ps, kv, dh),
             "v_pages": rand(rng, n_pages, ps, kv, dh)}
    bt = rng.permutation(np.arange(1, n_pages)).reshape(b, mb)
    bt = bt.astype(np.int32)
    bt[0] = 0
    return rng, pages, bt


def torch_pages(pages):
    return {k: torch.from_numpy(v.copy()) for k, v in pages.items()}


# ---------------------------------------------------------------------------
# elementwise layers
# ---------------------------------------------------------------------------
def test_rms_norm():
    rng = np.random.default_rng(0)
    x, s = rand(rng, 2, 5, 64), rand(rng, 64)
    ref = JL.rms_norm(jnp.asarray(x), {"scale": jnp.asarray(s)}, 1e-6)
    out = TL.rms_norm(torch.from_numpy(x), {"scale": torch.from_numpy(s)},
                      1e-6)
    close(out, ref)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_with_clamped_idle_positions(theta):
    rng = np.random.default_rng(1)
    x = rand(rng, 3, 4, 2, 32)
    pos = np.asarray([[-1, -1, -1, -1], [0, 1, 2, 3], [40, 41, 42, -1]],
                     np.int32)
    pc = np.maximum(pos, 0)
    ref = JL.rope(jnp.asarray(x), jnp.asarray(pc), theta)
    out = TL.rope(torch.from_numpy(x), torch.from_numpy(pos).clamp_min(0),
                  theta)
    close(out, ref, atol=2e-5)  # |x| up to ~4 and sin/cos of angles ~1e2


def test_quant_kv_int8_exact():
    rng = np.random.default_rng(2)
    x = rand(rng, 3, 5, 2, 32) * 3.0
    x[0, 0, 0] = 0.0  # the amax floor
    jq, js = JL._quant_kv_int8(jnp.asarray(x))
    tq, ts = TL._quant_kv_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# ---------------------------------------------------------------------------
# paged write / gather
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_paged_write_and_gather(dtype):
    jcfg, _ = tiny_cfgs("qwen2-1.5b")
    rng, pages, bt = paged_setup(jcfg, 3)
    kv, dh = jcfg.num_kv_heads, jcfg.resolved_head_dim
    jcache = JL.init_paged_attn_cache(jcfg, pages["k_pages"].shape[0], 4,
                                      jnp.dtype(dtype))
    tcache = TL.init_paged_attn_cache(jcfg, pages["k_pages"].shape[0], 4,
                                      getattr(torch, dtype), "cpu")
    pos = np.asarray([[-1] * 5, [0, 1, 2, 3, 4], [9, 10, 11, -1, -1]],
                     np.int32)
    k, v = rand(rng, 3, 5, kv, dh), rand(rng, 3, 5, kv, dh)
    jnew = JL._paged_write(jcache, jnp.asarray(bt), jnp.asarray(pos),
                           jnp.asarray(k), jnp.asarray(v))
    TL._paged_write(tcache, torch.from_numpy(bt), torch.from_numpy(pos),
                    torch.from_numpy(k), torch.from_numpy(v))
    for name in jnew:
        jn, tn = np.asarray(jnew[name]), tcache[name].numpy()
        # pads all land on (trash page 0, offset 0); which of the duplicate
        # writes wins there is unspecified, and nothing live reads it
        np.testing.assert_array_equal(tn[1:], jn[1:])
        np.testing.assert_array_equal(tn[0, 1:], jn[0, 1:])
        assert not tn[0, 1:].any()
    jks, jvs = JL._paged_gather(jnew, jnp.asarray(bt), jnp.float32)
    tks, tvs = TL._paged_gather(tcache, torch.from_numpy(bt), torch.float32)
    # row 0 reads the trash page only
    close(tks[1:], jks[1:], atol=0)
    close(tvs[1:], jvs[1:], atol=0)


# ---------------------------------------------------------------------------
# attention over the pages
# ---------------------------------------------------------------------------
def _attn_case(arch, c, seed):
    jcfg, tcfg = tiny_cfgs(arch)
    rng, pages, bt = paged_setup(jcfg, seed)
    p = np_params(jcfg, seed)["stack"]["0"]
    attn = jax.tree.map(lambda a: a[0], p["attn"])
    x = rand(rng, 3, c, jcfg.d_model)
    pos = np.full((3, c), -1, np.int32)
    pos[1] = np.arange(5, 5 + c)
    pos[2, : max(1, c - 1)] = np.arange(17, 17 + max(1, c - 1))
    return jcfg, tcfg, pages, bt, attn, x, pos


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("c", [1, 6])  # a decode step, a prefill chunk
def test_attention_paged(arch, c):
    jcfg, tcfg, pages, bt, attn, x, pos = _attn_case(arch, c, seed=4)
    windows, thetas = jcfg.layer_windows()
    for w, th in {(int(a), float(b)) for a, b in zip(windows[:, 0],
                                                     thetas[:, 0])}:
        jout, jcache = JL.attention_paged(
            to_jax(attn), jcfg, jnp.asarray(x), jnp.asarray(pos),
            jnp.int32(w), jnp.float32(th), to_jax(pages), jnp.asarray(bt))
        tcache = torch_pages(pages)
        tout = TL.attention_paged(
            params_from_numpy(attn, "cpu"), tcfg, torch.from_numpy(x),
            torch.from_numpy(pos), w, th, tcache, torch.from_numpy(bt))
        live = pos[:, :1] >= 0  # idle row 0 is garbage by contract
        close(tout.numpy()[live[:, 0]], np.asarray(jout)[live[:, 0]])
        for name in ("k_pages", "v_pages"):
            close(tcache[name].numpy()[1:], np.asarray(jcache[name])[1:])


# ---------------------------------------------------------------------------
# model steps
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_logits(arch):
    jcfg, tcfg = tiny_cfgs(arch)
    npp = np_params(jcfg, 5)
    jp, tp = to_jax(npp), params_from_numpy(npp, "cpu")
    b, ps, mb, chunk = 3, 4, 10, 24
    rng = np.random.default_rng(5)
    bt = (1 + np.arange(b * mb, dtype=np.int32)).reshape(b, mb)
    jcache = JT.init_paged_cache(jcfg, 1 + b * mb, ps)
    tcache = TT.init_paged_cache(tcfg, 1 + b * mb, ps, device="cpu")
    lens = np.asarray([24, 19, 7], np.int32)  # 24 > the window of 16
    toks = rng.integers(0, 64, (b, chunk)).astype(np.int32)
    poss = np.where(np.arange(chunk)[None] < lens[:, None],
                    np.arange(chunk)[None], -1).astype(np.int32)
    jl, jcache = JT.prefill_chunk_paged(jp, jcfg, jnp.asarray(toks),
                                        jnp.asarray(poss), jcache,
                                        jnp.asarray(bt),
                                        jnp.asarray(lens - 1))
    tl = TT.prefill_chunk_paged(tp, tcfg, torch.from_numpy(toks),
                                torch.from_numpy(poss), tcache,
                                torch.from_numpy(bt),
                                torch.from_numpy(lens - 1))
    close(tl, jl, atol=1e-4)
    pos = lens.copy()
    pos[2] = -1  # an idle slot
    for _ in range(3):
        tok = np.array(jnp.argmax(jl, -1), np.int32)
        jl, jcache = JT.decode_step_paged(jp, jcfg, jnp.asarray(tok),
                                          jnp.asarray(pos), jcache,
                                          jnp.asarray(bt))
        tl = TT.decode_step_paged(tp, tcfg, torch.from_numpy(tok),
                                  torch.from_numpy(pos), tcache,
                                  torch.from_numpy(bt))
        close(tl[:2], np.asarray(jl)[:2], atol=1e-4)
        pos[:2] += 1


# ---------------------------------------------------------------------------
# parameters: layout and bridge
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_init_model_matches_reference_layout(arch):
    jcfg, tcfg = tiny_cfgs(arch)
    shapes = jax.eval_shape(lambda k: JT.init_model(k, jcfg),
                            jax.random.PRNGKey(0))
    ours = TT.init_model(torch.Generator().manual_seed(0), tcfg, "cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(shapes)[0]
    flat_t = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: jax.ShapeDtypeStruct(
            tuple(t.shape), np.dtype(str(t.dtype).split(".")[1])), ours,
            is_leaf=lambda t: isinstance(t, torch.Tensor)))[0]
    assert [(jax.tree_util.keystr(k), v.shape, v.dtype) for k, v in flat_j] \
        == [(jax.tree_util.keystr(k), v.shape, v.dtype) for k, v in flat_t]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_bitwise(dtype):
    jcfg, _ = tiny_cfgs("gemma3-1b")
    tree = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, dtype)),
                        np_params(jcfg, 6))
    back = params_to_numpy(params_from_numpy(tree, "cpu"))
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
