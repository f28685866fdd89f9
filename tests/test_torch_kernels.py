"""The port's paged-attention kernel module against the JAX package.

``paged_attention_plain`` (PyTorch, CPU) is held against the JAX oracle
``paged_attention_ref`` and against the Pallas kernel in interpret mode on
the same numpy inputs.  The CUDA kernel itself runs only on a card: its
test skips here and ``chip_smoke.py`` holds it against the plain version
on the H100.
"""

import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ssm import SWEEP as SCAN_SWEEP

from repro.kernels.paged_attention import paged_attention as pallas_paged
from repro.kernels.ref import paged_attention_ref
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa

pytestmark = pytest.mark.torch

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
GRID = [(None, None), (-1, None), (7, None), (None, 30.0), (7, 30.0)]


def _inputs(seed=0, b=4, kv=2, g=4, dh=32, ps=8, mb=5):
    """Scrambled disjoint block tables and ragged ctx; row 0 is an idle
    slot (ctx 1 over an all-trash table row)."""
    rng = np.random.default_rng(seed)
    n_pages = 1 + b * mb
    q = rng.standard_normal((b, kv, g, dh)).astype(np.float32)
    kp = rng.standard_normal((n_pages, ps, kv, dh)).astype(np.float32)
    vp = rng.standard_normal((n_pages, ps, kv, dh)).astype(np.float32)
    bt = rng.permutation(np.arange(1, n_pages)).reshape(b, mb)
    bt = bt.astype(np.int32)
    bt[0] = 0
    ctx = np.asarray([1, 1, 17, mb * ps], np.int32)[:b]
    return q, kp, vp, bt, ctx


def _jax(arrs, jdt):
    q, kp, vp, bt, ctx = arrs
    return (jnp.asarray(q, jdt), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt),
            jnp.asarray(bt), jnp.asarray(ctx))


def _torch(arrs, tdt, device="cpu"):
    q, kp, vp, bt, ctx = (torch.from_numpy(a).to(device) for a in arrs)
    return q.to(tdt), kp.to(tdt), vp.to(tdt), bt, ctx


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32), np.float32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("window,softcap", GRID)
def test_plain_matches_ref(window, softcap, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    arrs = _inputs()
    ref = paged_attention_ref(*_jax(arrs, jdt), window=window, softcap=softcap)
    out = pa.paged_attention_plain(*_torch(arrs, tdt), window=window,
                                   softcap=softcap)
    assert out.dtype == tdt and tuple(out.shape) == ref.shape
    np.testing.assert_allclose(_np(out), _np(ref), atol=tol)


@pytest.mark.parametrize("dtype,window,softcap",
                         [("float32", None, None), ("float32", 7, 30.0),
                          ("bfloat16", 7, None)])
def test_plain_matches_interpret_kernel(dtype, window, softcap):
    jdt, tdt, tol = DTYPES[dtype]
    arrs = _inputs(seed=1)
    ref = pallas_paged(*_jax(arrs, jdt), window=window, softcap=softcap,
                       interpret=True)
    out = pa.paged_attention_plain(*_torch(arrs, tdt), window=window,
                                   softcap=softcap)
    np.testing.assert_allclose(_np(out), _np(ref), atol=tol)


def test_plain_mixed_dtypes_upcast_like_ref():
    """q and pages may differ in dtype; both are upcast to f32."""
    arrs = _inputs(seed=2)
    q, kp, vp, bt, ctx = _jax(arrs, jnp.float32)
    ref = paged_attention_ref(q, kp.astype(jnp.bfloat16),
                              vp.astype(jnp.bfloat16), bt, ctx, window=7)
    tq, tk, tv, tbt, tctx = _torch(arrs, torch.float32)
    out = pa.paged_attention_plain(tq, tk.bfloat16(), tv.bfloat16(), tbt,
                                   tctx, window=7)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-5)


def test_plain_row_without_live_token_is_zero_like_interpret_kernel():
    """A row with ctx 0 has no live token: the Pallas kernel (and the CUDA
    kernel) give 0 there, and so does the plain version; the other rows
    are the reference's."""
    q, kp, vp, bt, ctx = _inputs(seed=6)
    ctx = ctx.copy()
    ctx[0] = 0
    arrs = (q, kp, vp, bt, ctx)
    ref = pallas_paged(*_jax(arrs, jnp.float32), window=7, interpret=True)
    out = pa.paged_attention_plain(*_torch(arrs, torch.float32), window=7)
    assert not out[0].any()
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-5)
    oracle = paged_attention_ref(*_jax(arrs, jnp.float32), window=7)
    np.testing.assert_allclose(_np(out)[1:], _np(oracle)[1:], atol=1e-5)


# ---------------------------------------------------------------------------
# the split-K design, emulated on the CPU with the wrapper's own planner
# ---------------------------------------------------------------------------
def _split_k_emulation(q, kp, vp, bt, ctx, window, softcap):
    """The kernel's two passes in f32: every (b, h) row's live context cut
    into ``split_plan`` parts by ``split_range``; each part's m, l and acc
    (an empty part: m = -2e38, l = 0, acc = 0); then the combine
    m* = max m_s, l = sum l_s e^(m_s - m*), out = sum acc_s e^(m_s - m*)
    / max(l, 1e-30)."""
    b, kv, g, dh = q.shape
    splits = pa.split_plan(q, kp, bt)
    ks = kp[bt.long()].reshape(b, -1, kv, dh).float()
    vs = vp[bt.long()].reshape(b, -1, kv, dh).float()
    out = torch.empty(b, kv, g, dh)
    for i in range(b):
        ms, ls, accs = [], [], []
        for s in range(splits):
            lo, hi = pa.split_range(int(ctx[i]), ks.shape[1], window, splits,
                                    s)
            if lo >= hi:
                ms.append(torch.full((kv, g), pa.NEG_INF))
                ls.append(torch.zeros(kv, g))
                accs.append(torch.zeros(kv, g, dh))
                continue
            x = torch.einsum("kgd,skd->kgs", q[i].float(), ks[i, lo:hi]) \
                * (dh ** -0.5)
            if softcap is not None:
                x = softcap * torch.tanh(x / softcap)
            m = x.amax(-1)
            p = torch.exp(x - m[..., None])
            ms.append(m)
            ls.append(p.sum(-1))
            accs.append(torch.einsum("kgs,skd->kgd", p, vs[i, lo:hi]))
        m = torch.stack(ms)
        w = torch.exp(m - m.amax(0))
        l_tot = (torch.stack(ls) * w).sum(0)
        acc = (torch.stack(accs) * w[..., None]).sum(0)
        out[i] = acc / l_tot.clamp_min(1e-30)[..., None]
    return out.to(q.dtype), splits


# (b, kv, g, dh, page_size, max_blocks, ctx per row, splits expected): ctx
# 0 (an idle row), 1, and ctx at the parts' edges +- 1: 8 parts of 32
# tokens cover a 256-token reach; 17 parts of 2048 give 32-token parts up
# to ctx 544 = 17 * 32 and 64-token parts from 545
SPLIT_CASES = [
    (4, 2, 4, 32, 16, 16, [0, 1, 255, 256], 8),
    (4, 2, 4, 32, 16, 16, [31, 32, 33, 64], 8),
    (8, 2, 6, 32, 16, 128, [0, 1, 543, 544, 545, 1087, 1088, 2048], 17),
    # ctx past the table's reach (64 tokens): the window's edge is the
    # query's, at ctx - 1
    (2, 1, 3, 64, 8, 8, [63, 67], 2),
]


@pytest.mark.parametrize("window,softcap", [(None, None), (7, None),
                                            (100, None), (512, None),
                                            (100, 30.0)])
@pytest.mark.parametrize("case", SPLIT_CASES,
                         ids=[f"case{i}" for i in range(len(SPLIT_CASES))])
def test_split_k_emulation_matches_plain(case, window, softcap):
    b, kv, g, dh, ps, mb, ctx, want = case
    rng = np.random.default_rng(b * mb + dh)
    n_pages = 1 + b * mb
    q = torch.from_numpy(rng.standard_normal((b, kv, g, dh), np.float32))
    kp = torch.from_numpy(
        rng.standard_normal((n_pages, ps, kv, dh), np.float32))
    vp = torch.from_numpy(
        rng.standard_normal((n_pages, ps, kv, dh), np.float32))
    bt = torch.from_numpy(
        rng.permutation(np.arange(1, n_pages)).reshape(b, mb).astype(np.int32))
    cl = torch.tensor(ctx, dtype=torch.int32)
    out, splits = _split_k_emulation(q, kp, vp, bt, cl, window, softcap)
    assert splits == want
    ref = pa.paged_attention_plain(q, kp, vp, bt, cl, window=window,
                                   softcap=softcap)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_split_parts_tile_the_live_range():
    """Parts are whole SPLIT_TILEs, disjoint, in order, and cover exactly
    the live range [lo, ctx) (the last one cut at ctx)."""
    reach = 2048
    for splits in (1, 2, 8, 17, 64):
        for ctx in (0, 1, 31, 32, 33, 543, 544, 545, 2048, 2050):
            for window in (None, -1, 7, 100, 512):
                lo = max(ctx - window, 0) if window and window > 0 else 0
                hi = min(ctx, reach)
                covered = []
                for s in range(splits):
                    begin, end = pa.split_range(ctx, reach, window, splits,
                                                s)
                    if begin < end:
                        assert (begin - lo) % pa.SPLIT_TILE == 0
                        covered += range(begin, end)
                assert covered == list(range(lo, max(hi, lo)))


def test_split_plan_reads_shapes_only():
    """The planner takes meta tensors, which hold no values: it cannot read
    ``ctx_lens`` (or anything else) back from the card."""
    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    # qwen2-1.5b at 8 slots: B·KV = 16, 2048-token reach -> 17 parts
    assert pa.split_plan(meta(8, 2, 6, 128), meta(257, 16, 2, 128),
                         meta(8, 128, dtype=torch.int32)) == 17
    # gemma3-1b at 4 slots: B·KV = 4 wants 66 parts, capped at 1024 / 32
    assert pa.split_plan(meta(4, 1, 4, 256), meta(65, 16, 1, 256),
                         meta(4, 64, dtype=torch.int32)) == 32
    # a short reach keeps one tile a part; a wide batch needs one part
    assert pa.split_plan(meta(1, 1, 1, 32), meta(2, 8, 1, 32),
                         meta(1, 2, dtype=torch.int32)) == 1
    assert pa.split_plan(meta(256, 2, 4, 64), meta(9, 16, 2, 64),
                         meta(256, 128, dtype=torch.int32)) == 1
    assert pa.split_plan(meta(1, 1, 1, 32), meta(2, 16, 1, 32),
                         meta(1, 1024, dtype=torch.int32)) == pa.MAX_SPLITS


def test_ops_dispatch_cpu_takes_plain_without_launch():
    arrs = _inputs(seed=3)
    before = pa.paged_attention.launches
    out = ops.paged_attention(*_torch(arrs, torch.float32), window=7,
                              softcap=30.0)
    ref = pa.paged_attention_plain(*_torch(arrs, torch.float32), window=7,
                                   softcap=30.0)
    assert pa.paged_attention.launches == before
    assert torch.equal(out, ref)


def test_kernel_wrapper_rejects_cpu_tensors():
    """The kernel wrapper never runs the plain version itself."""
    with pytest.raises(ValueError, match="CUDA tensors only"):
        pa.paged_attention(*_torch(_inputs(), torch.float32))


def test_argtypes_match_c_prototype():
    """ctypes passes each argument by the declared type; a count or a
    pointer/int mismatch would only show on the card."""
    src = (Path(pa.__file__).parent / "csrc" / "paged_attention.cu").read_text()
    proto = re.search(r'extern "C" int paged_attention_fwd\((.*?)\)', src,
                      re.S).group(1)
    kinds = []
    for arg in proto.split(","):
        arg = arg.strip()
        kinds.append(ctypes.c_void_p if "*" in arg else
                     ctypes.c_float if arg.startswith("float") else
                     ctypes.c_int)
    assert kinds == pa._ARGTYPES


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_kernel_matches_plain(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100; chip_smoke.py also "
                    "covers this)")
    _, tdt, _ = DTYPES[dtype]
    tol = 2e-5 if dtype == "float32" else 2e-2
    for window, softcap in GRID:
        inp = _torch(_inputs(seed=4), tdt, device="cuda")
        out = pa.paged_attention(*inp, window=window, softcap=softcap)
        ref = pa.paged_attention_plain(*inp, window=window, softcap=softcap)
        torch.cuda.synchronize()
        assert out.dtype == tdt
        assert (out.float() - ref.float()).abs().max().item() <= tol


# ---------------------------------------------------------------------------
# the training path's kernels: onebit_quant_packed, topk_encode_ef,
# fused_adam (their plain versions are held against the JAX kernels in
# tests/test_torch_compression.py)
# ---------------------------------------------------------------------------
def _c_argtypes(source, fn):
    """ctypes types of the C prototype ``extern "C" int fn(...)``."""
    src = (Path(pa.__file__).parent / "csrc" / source).read_text()
    proto = re.search(r'extern "C" int ' + fn + r'\((.*?)\)', src,
                      re.S).group(1)
    kinds = []
    for arg in proto.split(","):
        arg = arg.strip()
        kinds.append(ctypes.c_void_p if "*" in arg else
                     ctypes.c_float if arg.startswith("float") else
                     ctypes.c_longlong if arg.startswith("long long") else
                     ctypes.c_int)
    return kinds


# the ctypes argtypes of an entry point other than its module's _ARGTYPES
_OTHER_ARGTYPES = {"topk_sparsify_fwd": "_SPARSIFY_ARGTYPES"}


@pytest.mark.parametrize("module,source,fn", [
    ("onebit_quant", "onebit_quant.cu", "onebit_quant_packed_fwd"),
    ("topk_sparsify", "topk_sparsify.cu", "topk_encode_ef_fwd"),
    ("fused_adam", "fused_adam.cu", "fused_adam_fwd"),
    ("onebit_quant", "onebit_quant.cu", "onebit_quant_fwd"),
    ("topk_sparsify", "topk_sparsify.cu", "topk_sparsify_fwd"),
])
def test_training_kernel_argtypes_match_c_prototype(module, source, fn):
    """A count, width or pointer/int mismatch would only show on the
    card: a 64-bit row count passed as a 32-bit int is cut."""
    import importlib

    mod = importlib.import_module(f"repro_torch.kernels.{module}")
    assert _c_argtypes(source, fn) == getattr(
        mod, _OTHER_ARGTYPES.get(fn, "_ARGTYPES"))


def test_flash_attention_argtypes_match_c_prototype():
    """The flash kernel's 12 strides are 64-bit: passed as 32-bit ints
    they would be cut."""
    from repro_torch.kernels import flash_attention as fa

    kinds = _c_argtypes("flash_attention.cu", "flash_attention_fwd")
    assert kinds == fa._ARGTYPES
    assert kinds.count(ctypes.c_longlong) == 12


def test_mamba_scan_argtypes_match_c_prototype():
    """The scan's B/C strides are 64-bit: passed as 32-bit ints they would
    be cut."""
    from repro_torch.kernels import mamba_scan as ms

    kinds = _c_argtypes("mamba_scan.cu", "mamba_scan_fwd")
    assert kinds == ms._ARGTYPES
    assert kinds.count(ctypes.c_longlong) == 4
    assert kinds.count(ctypes.c_void_p) == 9  # 8 tensors and the stream


def test_mamba_scan_bwd_argtypes_match_c_prototype():
    """The backward's B/C strides, its partial-block count and its
    checkpoint count are 64-bit; 13 tensors and the stream are pointers."""
    from repro_torch.kernels import mamba_scan as ms

    kinds = _c_argtypes("mamba_scan_bwd.cu", "mamba_scan_bwd")
    assert kinds == ms._BWD_ARGTYPES
    assert kinds.count(ctypes.c_longlong) == 6
    assert kinds.count(ctypes.c_void_p) == 14


def test_mamba_scan_bwd_block_shape_matches_the_kernel():
    """The wrapper sizes the dB/dC partials and the checkpoint scratch from
    BWD_LANE_STATES, BWD_WARPS and BWD_CHUNK; the kernel indexes them with
    its own kLaneStates, kWarps and kChunk."""
    from repro_torch.kernels import mamba_scan as ms

    text = (Path(ms.__file__).parent / "csrc"
            / "mamba_scan_bwd.cu").read_text()
    consts = dict(re.findall(
        r"constexpr int (kLaneStates|kChunk|kWarps) = (\d+);", text))
    assert consts == {"kLaneStates": str(ms.BWD_LANE_STATES),
                      "kChunk": str(ms.BWD_CHUNK),
                      "kWarps": str(ms.BWD_WARPS)}


def test_training_kernels_match_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100; chip_smoke.py also "
                    "covers this)")
    from repro_torch.kernels import fused_adam as fa
    from repro_torch.kernels import onebit_quant as ob
    from repro_torch.kernels import topk_sparsify as tk

    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.standard_normal((37, 256), dtype=np.float32))
    r = 0.1 * torch.from_numpy(rng.standard_normal((37, 256),
                                                   dtype=np.float32))
    g, r = g.cuda(), r.cuda()
    g[0], r[0] = 0.0, 0.0
    packed, scale, new_r = ob.onebit_quant_packed(g, r)
    want = ob.onebit_quant_packed_plain(g, r)
    assert torch.equal(packed, want[0])
    ulps = (scale.view(torch.int16).int() - want[1].view(torch.int16).int())
    assert ulps.abs().max().item() <= 1
    t = g + r
    own = t - torch.where(t >= 0, 1.0, -1.0) * scale.float()
    assert torch.equal(new_r.view(torch.int32), own.view(torch.int32))
    gk, rk = g.reshape(-1, 1024).contiguous(), r.reshape(-1, 1024) \
        .contiguous()
    got, want = tk.topk_encode_ef(gk[:9], rk[:9], 10), \
        tk.topk_encode_ef_plain(gk[:9], rk[:9], 10)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    n = 1000
    p, gg, m = (torch.randn(n, device="cuda") for _ in range(3))
    v = torch.rand(n, device="cuda")
    consts = torch.tensor([1e-3, 0.1, 1e-3], device="cuda")
    a = [x.clone() for x in (p, gg, m, v)]
    fa.fused_adam(a[0], a[1], a[2], a[3], consts)
    fa.fused_adam_plain(p, gg, m, v, consts)
    torch.cuda.synchronize()
    for x, y in zip((a[0], a[2], a[3]), (p, m, v)):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the top-k kernels' selection (csrc/topk_sparsify.cu::select_topk),
# emulated on the CPU with the kernel's lane map
# ---------------------------------------------------------------------------
def _topk_emulation(mag, k, vec):
    """The kernel's selection over one row of ``mag`` (bits of |t| as f32,
    sign cleared), a lane holding 16-byte vectors of ``vec`` columns:
    vector v belongs to lane v % 32, so slot s = j vec + e of lane l is
    column vec (l + 32 j) + e.  Keys are mag + 1.  Returns (columns in
    pick order, taken columns, path, candidate count or None)."""
    block = mag.size
    nvec = block // vec
    col = np.full((32, 32), -1, np.int64)
    for lane in range(32):
        for s in range(32):
            j, e = divmod(s, vec)
            if lane + 32 * j < nvec:
                col[lane, s] = vec * (lane + 32 * j) + e
    valid = col >= 0
    key = np.where(valid, mag[np.maximum(col, 0)].astype(np.int64) + 1, 0)
    taken = np.zeros((32, 32), bool)

    def take(c):  # the owner lane's bit of column c
        lane, s = (c // vec) % 32, (c // (32 * vec)) * vec + c % vec
        assert col[lane, s] == c
        taken[lane, s] = True

    def columns_taken():
        out = np.zeros(block, bool)
        out[col[taken]] = True
        return out

    picks, count = [], None
    if k <= 32:
        cur = key.max(axis=1)  # each lane's largest key (0: no column)
        seen = 0
        while True:  # tau: the k-th largest lane maximum
            tau = cur.max()
            seen += int((cur == tau).sum())
            if seen >= k:
                break
            cur = np.where(cur == tau, 0, cur)
        # ballot compaction: slot by slot, lanes in order within a slot
        cand = [(key[lane, s], col[lane, s]) for s in range(32)
                for lane in range(32) if valid[lane, s] and key[lane, s] >= tau]
        count = len(cand)
        if count <= 32:
            ckey = [c[0] for c in cand] + [0] * (32 - count)
            ccol = [c[1] for c in cand] + [-1] * (32 - count)
            for _ in range(k):
                m = max(ckey)
                assert m >= 1
                c = min(cc for kk, cc in zip(ckey, ccol) if kk == m)
                ckey[ccol.index(c)] = 0
                take(c)
                picks.append(int(c))
            return picks, columns_taken(), "fast", count

    def best(lane):  # the lane's best untaken key, lowest column on a tie
        live = np.where(valid[lane] & ~taken[lane], key[lane], 0)
        s = int(np.argmax(live))  # the first maximum: slots run by column
        return int(live[s]), int(col[lane, s])

    bests = [best(lane) for lane in range(32)]
    for _ in range(k):
        m = max(b for b, _ in bests)
        assert m >= 1
        c = min(cc for b, cc in bests if b == m)
        take(c)
        picks.append(c)
        owner = (c // vec) % 32
        bests[owner] = best(owner)
    return picks, columns_taken(), "general", count


TOPK_EMU_ROWS = ("random", "all_equal", "all_zero", "fewer_than_k",
                 "signed_zeros", "nan_inf", "32_candidates",
                 "33_candidates", "small_ints")


def _topk_rows(block, k, vec, seed):
    """(g, r) f32 rows, one of each ``TOPK_EMU_ROWS``; r is 0.1 N(0, 1) on
    the random row and zero elsewhere, so t = g there."""
    rng = np.random.default_rng(seed)
    nb = len(TOPK_EMU_ROWS)
    g = np.zeros((nb, block), np.float32)
    r = np.zeros((nb, block), np.float32)
    g[0] = rng.standard_normal(block)
    r[0] = 0.1 * rng.standard_normal(block)
    g[1] = 0.75 * rng.choice([-1.0, 1.0], block)
    few = rng.choice(block, size=k - 1, replace=False)
    g[3, few] = rng.standard_normal(k - 1)
    g[4] = rng.choice([-0.0, 0.0], block)
    g[4, rng.choice(block, size=3, replace=False)] = [1.5, -1.5, 0.25]
    g[5] = rng.standard_normal(block)
    g[5, rng.choice(block, size=6, replace=False)] = [
        np.nan, -np.nan, np.inf, -np.inf, np.inf, np.nan]
    # 32 and 33 equal magnitudes above the rest, one a lane in turn: every
    # lane that holds one has it as its maximum, so they are the candidates
    lanes = min(32, block // vec)
    for row, n in ((6, 32), (7, 33)):
        g[row] = rng.uniform(-1.0, 1.0, block)
        for i in range(min(n, block)):
            lane, j = i % lanes, i // lanes
            g[row, vec * lane + 32 * vec * (j // vec) + j % vec] = \
                rng.choice([-4.0, 4.0])
    g[8] = rng.integers(-3, 4, block)
    return g, r


TOPK_EMU_CASES = [(block, k) for block in (32, 64, 1024)
                  for k in sorted({1, 10, 32, 33, block}) if k <= block]


def _emulate_rows(t, k, vec):
    mag = (t.float().contiguous().view(torch.int32) & 0x7FFFFFFF).numpy()
    return [_topk_emulation(row, k, vec) for row in mag]


def _same_bits(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a.contiguous().view(torch.uint8),
                       b.contiguous().view(torch.uint8))


@pytest.mark.parametrize("kernel", ["encode_ef", "sparsify_float32",
                                    "sparsify_bfloat16"])
@pytest.mark.parametrize("block,k", TOPK_EMU_CASES)
def test_topk_selection_emulation_matches_plain(block, k, kernel):
    """Both kernels' selection, emulated with their lane maps (4 f32 or 8
    bf16 columns a 16-byte vector), bitwise against both plain versions
    on adversarial rows; the fast path where its candidates fit in 32
    lanes, the general path otherwise."""
    from repro_torch.kernels import topk_sparsify as tk

    dtype = torch.bfloat16 if kernel.endswith("bfloat16") else torch.float32
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    g, r = (torch.from_numpy(a) for a in _topk_rows(block, k, vec,
                                                   block * 100 + k))
    if kernel == "encode_ef":
        t = g + r
        vals, idx, new_r = tk.topk_encode_ef_plain(g, r, k)
    else:
        t = g.to(dtype)
        vals, idx, dense = tk.topk_sparsify_plain(t, k)
    emulated = _emulate_rows(t, k, vec)
    for i, (picks, taken, _, _) in enumerate(emulated):
        assert idx[i].tolist() == picks, TOPK_EMU_ROWS[i]
        sel = torch.from_numpy(taken)
        _same_bits(vals[i], t[i, picks])
        if kernel == "encode_ef":
            _same_bits(new_r[i], t[i] - torch.where(sel, t[i], 0.0))
        else:
            _same_bits(dense[i], torch.where(sel, t[i],
                                             torch.zeros((), dtype=dtype)))
    paths = {name: (path, count)
             for name, (_, _, path, count) in zip(TOPK_EMU_ROWS, emulated)}
    if k > 32:
        assert {p for p, _ in paths.values()} == {"general"}
    if block == 1024 and k <= 32:
        assert paths["32_candidates"] == ("fast", 32)
        assert paths["33_candidates"] == ("general", 33)
        # ties at tau: every zero ties once a row has fewer than k nonzeros
        for name in ("all_equal", "all_zero", "fewer_than_k") + \
                (("signed_zeros",) if k > 3 else ()):
            assert paths[name][0] == "general", name
        if k == 10:
            assert paths["random"][0] == "fast"


def test_topk_gradient_rows_take_the_fast_path():
    """Gradient-like rows at the path's shape (block 1024, k 10) take the
    fast path with a handful of candidates over k."""
    rng = np.random.default_rng(7)
    t = torch.from_numpy(rng.standard_normal((64, 1024), np.float32)
                         + 0.1 * rng.standard_normal((64, 1024), np.float32))
    emulated = _emulate_rows(t, 10, 4)
    assert {path for _, _, path, _ in emulated} == {"fast"}
    counts = [count for *_, count in emulated]
    assert min(counts) >= 10 and np.mean(counts) <= 20


# ---------------------------------------------------------------------------
# the scan kernel's schedule (csrc/mamba_scan.cu), emulated on the CPU
# ---------------------------------------------------------------------------
def _scan_constant(name):
    """A lane-map constant of csrc/mamba_scan.cu (``constexpr int``)."""
    src = (Path(pa.__file__).parent / "csrc" / "mamba_scan.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _widest(esize, values):
    """csrc/mamba_scan.cu::widest: the widest of 16, 8, 4 (and 2 for bf16)
    bytes that divides every value."""
    w = 16
    while w > esize:
        if all(v % w == 0 for v in values):
            return w
        w //= 2
    return esize


def _scan_stage(flat, starts, width, cols, piece, esize, pad):
    """The kernel's ``stage`` for rows beginning at element ``starts`` of
    ``flat`` (-1: a row past L): each row of ``width`` elements in pieces
    of ``piece`` bytes, every piece aligned to its width (the pointer
    starts 256-byte aligned), columns at or past ``cols`` and rows past L
    set to ``pad``."""
    per = piece // esize
    assert per >= 1 and width % per == 0
    col = torch.arange(width)
    live = (starts[..., None] >= 0) & (col < cols)
    addr = starts[..., None] + col
    piece_start = addr[..., ::per][live[..., ::per]]
    assert ((piece_start * esize) % piece == 0).all()
    # a piece is all inside D or all outside it
    assert (live[..., ::per].repeat_interleave(per, -1) == live).all()
    read = torch.where(live, addr, 0)  # nothing outside is read
    return torch.where(live, flat[read], torch.tensor(pad))


def _scan_emulation(u, delta, a, b, c, d_skip):
    """csrc/mamba_scan.cu's schedule in torch f32 on the CPU.  N / S
    lanes own a channel (S = min(kLaneStates, N) states a lane),
    32 / (N / S) channels a warp; a warp stages tiles of kTile
    steps of u, delta (its channels) and B, C through ``_scan_stage`` in
    the pieces ``widest`` picks, rows past L as dt = 0, u = -0, B = C = 0
    and channels past D likewise; each lane sums its states' terms of y_t
    in state order (one rounding each, as FFMA); after the tile a
    channel's lanes are summed in lane order, D * u is added once, and y
    is stored in vectors of the y piece's width, rows past L and channels
    past D masked.  The exponentials are the plain version's expression
    on its own shapes (padded steps and channels take exp(0) = 1).
    Returns (y, h_last, pieces, count of stores to each y element)."""
    states, tile = _scan_constant("kLaneStates"), _scan_constant("kTile")
    bsz, l, d = u.shape
    n = a.shape[1]
    s = min(states, n)
    lanes = n // s
    ch = 32 // lanes
    warps = -(-d // ch)
    es = u.element_size()
    pieces = {"ud": _widest(es, [u.storage_offset() * es,
                                 delta.storage_offset() * es, d * es,
                                 ch * es]),
              "y": _widest(es, [0, d * es, ch * es])}
    for name, t in (("b", b), ("c", c)):
        pieces[name] = _widest(es, [t.storage_offset() * es,
                                    t.stride(0) * es, t.stride(1) * es,
                                    n * es])
    flat = {name: t.as_strided((t.untyped_storage().nbytes() // es,), (1,),
                               0).float()
            for name, t in (("u", u), ("dt", delta), ("b", b), ("c", c))}
    af = a.float()
    h = torch.zeros((bsz, warps * ch, n))
    dead = torch.zeros((bsz, warps * ch - d, n))
    y = torch.zeros((bsz, l, d))
    stores = torch.zeros((bsz, l, d), dtype=torch.int32)
    ds = torch.zeros(warps * ch)
    ds[:d] = d_skip.float()
    for t0 in range(0, l, tile):
        rows = torch.arange(t0, t0 + tile)
        inside = rows < l
        bi = torch.arange(bsz)[:, None, None]
        w0 = torch.arange(warps)[None, :, None] * ch
        ud_start = torch.where(inside, (bi * l + rows) * d, -1) \
            + u.storage_offset()
        ud_start = torch.where(inside, ud_start + w0, -1)  # (B, W, T)
        cols = (d - w0).clamp_max(ch)[..., None]
        st = {}
        for name, pad in (("u", -0.0), ("dt", 0.0)):
            off = delta.storage_offset() - u.storage_offset() \
                if name == "dt" else 0
            st[name] = _scan_stage(flat[name], torch.where(
                ud_start >= 0, ud_start + off, -1), ch, cols,
                pieces["ud"], es, pad)  # (B, W, T, C)
        for name, t in (("b", b), ("c", c)):
            start = torch.where(inside, t.storage_offset()
                                + bi[..., 0] * t.stride(0)
                                + rows * t.stride(1), -1)  # (B, T)
            st[name] = _scan_stage(flat[name], start, n, n, pieces[name], es,
                                   0.0)  # (B, T, N)
        us = st["u"].permute(0, 2, 1, 3).reshape(bsz, tile, -1)
        dts = st["dt"].permute(0, 2, 1, 3).reshape(bsz, tile, -1)
        part = torch.empty((bsz, tile, warps * ch, lanes))
        for i in range(tile):
            t = t0 + i
            if t < l:  # the plain version's expression on its own shape
                live = torch.exp(delta.float()[:, t, :, None] * af)
            else:
                live = torch.exp(dts[:, i, :d, None] * af)
            abar = torch.cat([live, torch.exp(dts[:, i, d:, None] * dead)],
                             1)
            du = dts[:, i] * us[:, i]
            h = abar * h + du[..., None] * st["b"][:, i, None, :]
            hl = h.view(bsz, -1, lanes, s).double()
            cl = st["c"][:, i].view(bsz, 1, lanes, s).double()
            acc = torch.zeros((bsz, warps * ch, lanes), dtype=torch.float64)
            for e in range(s):
                acc = (hl[..., e] * cl[..., e] + acc).float().double()
            part[:, i] = acc.float()
        ysum = part[..., 0]
        for q in range(1, lanes):
            ysum = ysum + part[..., q]
        yt = ysum + ds * us  # (B, T, W * C)
        per = pieces["y"] // es
        for w in range(warps):
            for col in range(0, ch, per):
                d1 = w * ch + col
                if d1 >= d:
                    continue
                assert d1 + per <= d  # a store is all inside D
                r = min(tile, l - t0)
                y[:, t0:t0 + r, d1:d1 + per] = yt[:, :r, d1:d1 + per]
                stores[:, t0:t0 + r, d1:d1 + per] += 1
    return y.to(u.dtype), h[:, :d], pieces, stores


def _scan_case_inputs(seed, bsz, l, d, n, layout):
    """The reference sweep's distributions; B and C as slices of one
    wider tensor: "model" as the model passes them (B at column 0, C at
    N), "offset" at odd columns (1 and N + 3: not 16-byte aligned)."""
    rng = np.random.default_rng(seed)
    u = torch.from_numpy(0.5 * rng.standard_normal((bsz, l, d), np.float32))
    delta = torch.nn.functional.softplus(
        torch.from_numpy(rng.standard_normal((bsz, l, d), np.float32)))
    a = -torch.from_numpy(rng.standard_normal((d, n), np.float32)).abs()
    ob, oc = (0, n) if layout == "model" else (1, n + 3)
    wide = torch.from_numpy(0.5 * rng.standard_normal((bsz, l, 2 * n + 4),
                                                      np.float32))
    ds = torch.from_numpy(rng.standard_normal(d, np.float32))
    return u, delta, a, wide[..., ob:ob + n], wide[..., oc:oc + n], ds


# (B, L, D, N, B/C layout)
SCAN_EMU_CASES = (
    [s + ("model",) for s in SCAN_SWEEP]          # the reference's sweep
    + [(1, 1000, 64, 16, "model"), (2, 33, 32, 8, "model")]  # L % tile
    + [(1, 40, 200, 16, "model"), (2, 20, 96, 16, "model")]  # D % block
    + [(1, 50, 37, n, "model") for n in (4, 8, 16)]  # N, odd D
    + [(2, 40, 64, 16, "offset"), (2, 40, 64, 4, "offset")])


@pytest.mark.parametrize("case", SCAN_EMU_CASES,
                         ids=["-".join(map(str, c)) for c in SCAN_EMU_CASES])
def test_scan_schedule_emulation_matches_plain(case):
    """The kernel's lane map, tiles with their padded tail, per-lane
    terms and staged y rows against ``mamba_scan_plain``: h_last bitwise,
    y within 1e-6, every y element stored once."""
    from repro_torch.kernels import mamba_scan as ms

    bsz, l, d, n, layout = case
    args = _scan_case_inputs(bsz * l + d + n, bsz, l, d, n, layout)
    y, h, pieces, stores = _scan_emulation(*args)
    yp, hp = ms.mamba_scan_plain(*args)
    assert torch.equal(h.view(torch.int32), hp.view(torch.int32))
    torch.testing.assert_close(y, yp, atol=1e-6, rtol=1e-6)
    assert (stores == 1).all()
    if layout == "offset":
        assert pieces["b"] == pieces["c"] == 4  # f32 pieces, one element
    elif d % 2:
        assert pieces["ud"] == pieces["y"] == 4  # a row of odd length
    elif n == 16 and d % 16 == 0:
        assert set(pieces.values()) == {16}  # the 16-byte instance


def test_scan_padded_step_leaves_state_bitwise_unchanged():
    """A step past L (dt = 0, u = -0, B = C = 0) is the identity on h for
    every value, -0.0 included: exp(0) = 1, 1 * h = h, du * b = -0 and
    h + -0 = h; staged as u = +0 it would turn -0.0 into +0.0."""
    from repro_torch.kernels import mamba_scan as ms

    u, delta, a, b, c, ds = _scan_case_inputs(3, 2, 40, 32, 16, "model")
    u = -u.abs()  # u < 0 throughout the real steps
    _, h = ms.mamba_scan_plain(u, delta, a, b, c, ds)
    h = h.clone()
    h[0, 0, :4] = torch.tensor([-0.0, 0.0, float("inf"), -float("inf")])
    zero = torch.zeros((2, 32))
    for pad_u, same in ((-0.0, True), (0.0, False)):
        abar = torch.exp(zero[..., None] * a)
        du = zero * torch.full((2, 32), pad_u)
        after = abar * h + du[..., None] * torch.zeros((2, 1, 16))
        assert torch.equal(after.view(torch.int32),
                           h.view(torch.int32)) == same



# ---------------------------------------------------------------------------
# the scan backward's schedule (csrc/mamba_scan_bwd.cu), emulated on the CPU
# ---------------------------------------------------------------------------
def _bwd_constant(name):
    """A lane-map constant of csrc/mamba_scan_bwd.cu (``constexpr int``)."""
    src = (Path(pa.__file__).parent / "csrc"
           / "mamba_scan_bwd.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _bwd_lane_map(n):
    """(states a lane, lanes a channel, channels a warp) of the kernel's
    LaneMap<N>: at least two lanes a channel."""
    s = min(_bwd_constant("kLaneStates"), n // 2)
    return s, n // s, 32 // (n // s)


def _bwd_perm(lane, n):
    """csrc/mamba_scan_bwd.cu::state_perm: the lane's register s holds state
    n0 + (s ^ perm)."""
    s, ln, _ = _bwd_lane_map(n)
    perm, h, m = 0, s // 2, ln
    while h >= 1:
        perm |= h if lane & m else 0
        h, m = h // 2, m * 2
    return perm


def _bwd_column(lane, n):
    """csrc/mamba_scan_bwd.cu::bc_column: the dB/dC column whose sum the
    halving leaves in ``lane`` (its state in register 0)."""
    s, ln, _ = _bwd_lane_map(n)
    return (n if lane & n else 0) + lane % ln * s + _bwd_perm(lane, n)


def _fma(x, y, z):
    """fmaf in f32: the exact product and its sum in f64, rounded to f32
    (the f64 rounding first is far below the test's tolerance)."""
    return (x.double() * y.double() + z.double()).float()


def _bwd_emulation(u, delta, a, b, c, d_skip, dy):
    """csrc/mamba_scan_bwd.cu's schedule in torch f32 on the CPU: D padded
    to whole blocks and L to whole tiles (pads dt = 0, u = -0, dy = B = C
    = 0), the forward sweep's checkpoints, and the reverse walk with each
    lane's sums over its states in state order, ddelta/du over a channel's
    lanes (halves traded at xor 1, then the butterfly) and dB/dC through
    the reduce-scatter over each state group's lanes (every shuffle an
    index by lane ^ m), each warp's row written by its owner lanes only,
    the block's warps summed in order.  Returns (the six gradients as the
    plain version returns them, the checkpoints, the per-block partials,
    the writes to each (B, L, D) element of ddelta and du)."""
    chunk, warps = _bwd_constant("kChunk"), _bwd_constant("kWarps")
    bsz, l, d = u.shape
    n = a.shape[1]
    s, ln, cw = _bwd_lane_map(n)
    nblk = -(-d // (warps * cw))
    wt, dp = nblk * warps, nblk * warps * cw
    tiles = -(-l // chunk)
    lp = tiles * chunk

    def pad(x, fill, cols):
        out = torch.full((bsz, lp, cols), fill)
        out[:, :l, :x.shape[-1]] = x.float()
        return out

    uf, df, gf = pad(u, -0.0, dp), pad(delta, 0.0, dp), pad(dy, 0.0, dp)
    bf, cf = pad(b, 0.0, n), pad(c, 0.0, n)
    af = torch.zeros((dp, n))
    af[:d] = a.float()
    ds = torch.zeros(dp)
    ds[:d] = d_skip.float()
    # the sweep (and the rebuild, the same products and sums): states[t] =
    # h before step t
    states = [torch.zeros((bsz, dp, n))]
    for t in range(lp):
        abar = torch.exp(df[:, t, :, None] * af)
        states.append(abar * states[-1] + (df[:, t] * uf[:, t])[..., None]
                      * bf[:, t, None, :])
    ckpt = torch.stack(states[:lp:chunk], 1)  # (B, tiles, Dp, N)

    lanes = torch.arange(32)
    col = torch.tensor([_bwd_column(x, n) for x in range(32)])
    owner = (lanes & (31 & ~(2 * n - 1))) == 0
    assert sorted(col[owner].tolist()) == list(range(2 * n))
    # register r of lane l holds the lane's state (r ^ perm)
    order = torch.tensor([[r ^ _bwd_perm(x, n) for r in range(s)]
                          for x in range(32)])

    def per_lane(x):  # (B, Dp, N) -> (B, warps, lanes, registers)
        x = x.reshape(bsz, wt, 32, s)
        return x.gather(-1, order.expand(bsz, wt, 32, s))

    def per_channel(x):  # (B, Dp) -> each lane's channel's value
        return x.reshape(bsz, wt, cw)[..., lanes // ln]

    def warp_sum(x, m):
        """csrc/mamba_scan_bwd.cu::warp_sum of x * m (x (B, W, 32, S) in
        the lanes' orders, m (B, W, 32)): the first level keeps the lower
        half as FMAs onto the partner's products, then halving, then the
        copies added."""
        h = s // 2
        sent = (x[..., h:] * m[..., None])[..., lanes ^ ln, :]
        v = _fma(x[..., :h], m[..., None], sent)
        k = 2 * ln
        while v.shape[-1] > 1:
            h = v.shape[-1] // 2
            v = v[..., :h] + v[..., lanes ^ k, h:]
            k *= 2
        v = v[..., 0]
        k = n
        while k < 32:
            v, k = v + v[..., lanes ^ k], k * 2
        return v

    g = torch.zeros((bsz, dp, n))
    da = torch.zeros((bsz, dp, n))
    dd = torch.zeros((bsz, dp))
    ddelta = torch.zeros((bsz, l, d))
    du = torch.zeros((bsz, l, d))
    writes = torch.zeros((2, bsz, l, d), dtype=torch.int32)
    part = torch.zeros((bsz, nblk, l, 2 * n))
    for t in reversed(range(lp)):
        dt, ut, gy = df[:, t], uf[:, t], gf[:, t]
        bt = bf[:, t, None, :].expand(bsz, dp, n)
        abar = torch.exp(dt[..., None] * af)
        hp, ht = states[t], states[t + 1]
        gt = _fma(gy[..., None], cf[:, t, None, :], g)
        decay = abar * hp
        gd = gt * decay
        gdl, gl, bl, al = (per_lane(x) for x in (gd, gt, bt, af.expand(
            bsz, dp, n)))
        sga = torch.zeros((bsz, wt, 32))
        sdu = torch.zeros((bsz, wt, 32))
        for e in range(s):
            sga = _fma(al[..., e], gdl[..., e], sga)
            sdu = _fma(gl[..., e], bl[..., e], sdu)
        sdl = _fma(per_channel(ut), sdu, sga)
        da = _fma(gd, dt[..., None], da)
        g = abar * gt
        dd = _fma(gy, ut, dd)
        dtl, gyl = per_channel(dt), per_channel(gy)
        skip = per_channel(ds.expand(bsz, dp)) * gyl
        odd = (lanes & 1).bool()
        sm = torch.where(odd, sdu, sdl) \
            + torch.where(odd, sdl, sdu)[..., lanes ^ 1]
        m = 2
        while m < ln:
            sm, m = sm + sm[..., lanes ^ m], m * 2
        writer = lanes % ln < 2
        outs = [(0, sm, writer & ~odd), (1, _fma(sm, dtl, skip),
                                         writer & odd)]
        if t < l:
            chan = (torch.arange(wt)[:, None] * cw + lanes // ln)  # (W, 32)
            for which, val, lane_ok in outs:
                ok = lane_ok & (chan < d)
                dst = (ddelta, du)[which]
                bi, wi, li = torch.nonzero(ok.expand(bsz, wt, 32),
                                           as_tuple=True)
                dst[bi, t, chan[wi, li]] = val[bi, wi, li]
                writes[which, bi, t, chan[wi, li]] += 1
        sums = [warp_sum(per_lane(gt), per_channel(dt * ut)),
                warp_sum(per_lane(ht), gyl)]  # dB, dC
        v = torch.where((lanes & n) != 0, sums[1], sums[0])
        rows = torch.zeros((bsz, wt, 2 * n))
        rows[:, :, col[owner]] = v[..., owner]
        rows = rows.view(bsz, nblk, warps, 2 * n)
        block = rows[:, :, 0]
        for x in range(1, warps):
            block = block + rows[:, :, x]
        if t < l:
            part[:, :, t] = block
    bc = part.sum(1)
    grads = (du.to(u.dtype), ddelta.to(delta.dtype), da.sum(0)[:d],
             bc[..., :n].to(b.dtype), bc[..., n:].to(c.dtype), dd.sum(0)[:d])
    return grads, ckpt[:, :, :d], part, writes


# (B, L, D, N, B/C layout): L not a multiple of the tile, ragged D (not a
# multiple of a block's channels), every N, B/C at odd columns
BWD_EMU_CASES = ([(2, 21, 37, n, "model") for n in (4, 8, 16)]
                 + [(1, 40, 200, 16, "model"), (2, 19, 96, 8, "offset"),
                    (1, 9, 64, 4, "offset")])


@pytest.mark.parametrize("case", BWD_EMU_CASES,
                         ids=["-".join(map(str, c)) for c in BWD_EMU_CASES])
def test_bwd_schedule_emulation_matches_plain(case):
    """The backward kernel's lane map, padded tiles, checkpoints, per-lane
    sums, shuffle butterflies and the block's sum of its warps' dB/dC rows
    against ``mamba_scan_bwd_plain``: each output within 1e-5 of its
    largest, every ddelta and du element written once, the checkpoints
    bitwise the forward's states, and the partials and checkpoints of the
    shapes ``bwd_scratch_shapes`` allocates."""
    from repro_torch.kernels import mamba_scan as ms

    bsz, l, d, n, layout = case
    args = _scan_case_inputs(bsz * l + d + n, bsz, l, d, n, layout)
    dy = torch.from_numpy(np.random.default_rng(l).standard_normal(
        (bsz, l, d), dtype=np.float32))
    got, ckpt, part, writes = _bwd_emulation(*args, dy)
    want = ms.mamba_scan_bwd_plain(*args, dy)
    for name, x, y in zip(("du", "ddelta", "da", "db", "dc", "dd"), got,
                          want):
        assert x.shape == y.shape, name
        scale = y.abs().max().item()
        assert (x - y).abs().max().item() <= 1e-5 * scale, name
    assert (writes == 1).all()
    part_shape, ckpt_shape = ms.bwd_scratch_shapes(bsz, l, d, n)
    assert tuple(part.shape) == part_shape
    assert tuple(ckpt.shape) == ckpt_shape
    k = ckpt.shape[1] - 1  # the last checkpoint: the forward's state there
    _, h = ms.mamba_scan_plain(*(x[:, :k * ms.BWD_CHUNK] for x in args[:2]),
                               args[2],
                               *(x[:, :k * ms.BWD_CHUNK] for x in args[3:5]),
                               args[5]) if k else (None, torch.zeros_like(
                                   ckpt[:, 0]))
    assert torch.equal(ckpt[:, k].view(torch.int32), h.view(torch.int32))


@pytest.mark.parametrize("n", [4, 8, 16])
def test_bwd_scratch_shapes_match_the_kernel(n):
    """``bwd_scratch_shapes`` (what the wrapper allocates and passes as the
    kernel's block and checkpoint counts) against the kernel's own counts
    from its source's constants: a block of kWarps warps of 32 /
    (N / kLaneStates) channels, a checkpoint every kChunk steps; ragged D
    and L not a multiple of the tile.  At jamba's shape the partials stay
    within 512 rows (134 MB), the one-state-a-lane design's."""
    from repro_torch.kernels import mamba_scan as ms

    warps, chunk = _bwd_constant("kWarps"), _bwd_constant("kChunk")
    _, _, cw = _bwd_lane_map(n)
    for bsz, l, d in ((1, 1, 1), (2, chunk - 1, 37), (2, chunk + 1, 200),
                      (1, 2048, 16384), (3, 5 * chunk, warps * cw + 1)):
        part, ckpt = ms.bwd_scratch_shapes(bsz, l, d, n)
        blocks = -(-d // (warps * cw))
        assert part == (bsz, blocks, l, 2 * n)
        assert ckpt == (bsz, -(-l // chunk), d, n)
        assert (blocks - 1) * warps * cw < d <= blocks * warps * cw
    if n == 16:
        part, _ = ms.bwd_scratch_shapes(1, 2048, 16384, 16)
        assert part[1] <= 512 and np.prod(part) * 4 <= 134_217_728
