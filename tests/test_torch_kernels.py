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
