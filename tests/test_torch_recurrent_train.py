"""Training the recurrent families against the JAX package on the CPU: the
selective scan's gradient (``mamba_scan_bwd_plain``, ``MambaScan``), each
recurrent mixer's training layer, ``make_loss_fn`` on jamba and xLSTM,
remat, and the replica trainer's history.

Inputs are made with numpy from a seed and handed to both packages.  The
models are the configs' ``.reduced()`` widths: jamba 16 layers (2
attention, 14 Mamba; with its 4 experts or without), ``ssm_chunk`` cut to
16 so that 32 tokens span two chunks of the reference's chunked scan, and
one case at the default chunk of 256 with 300 tokens; xLSTM 4 layers (2
mLSTM, 2 sLSTM).  The JAX side differentiates its own training path (the
jnp chunked scan); the port runs ``MambaScan`` with the plain backward.

Tolerances: the plain backward against autograd through
``mamba_scan_plain`` and against ``jax.vjp`` of ``mamba_scan_ref``: each
output within 1e-5 of its largest |value| in f32; in bf16 the outputs are
rounded to bf16, so one bf16 rounding (2^-8 of the element) more.  A
mixer layer's gradients (every parameter and the input) and a model's:
loss within 1e-5 and every leaf's max |port - JAX| within 1e-4 of the
leaf's largest |g| (element-wise tolerances fail on the elements near 0
that every leaf has: the two packages sum in other orders).  In bf16 a
Mamba layer's gradients are held within 5e-2 of each leaf's largest: the
reference's model forms ``delta * u`` in bf16, the port's scan in f32,
and every projection's gradient is rounded to bf16.  Remat: gradients
bitwise those without.  Trainer histories: wire bytes exact, divergence
0, loss within rtol 1e-4 over 5 steps (as tests/test_torch_moe.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_layers import np_params, to_jax, tokens

import repro.launch.train as JCLI
from repro.configs import get_config as jax_config
from repro.core.comm import LocalComm as JLocalComm
from repro.core.compression import get_compressor as jget_compressor
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import worker_batches as jworker_batches
from repro.kernels.ref import mamba_scan_ref
from repro.models import ssm as JS
from repro.optim import optimizers as JO
from repro.train import loop as JLOOP
from repro_torch.bridge import params_from_numpy, train_state_from_numpy
from repro_torch.configs import get_config as torch_config
from repro_torch.core import tree as TREE
from repro_torch.core.comm import LocalComm
from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels import ops
from repro_torch.launch import train as CLI
from repro_torch.models import ssm as TS
from repro_torch.optim import optimizers as TO
from repro_torch.train import loop as TLOOP

pytestmark = pytest.mark.torch

JAMBA, XLSTM = "jamba-1.5-large-398b", "xlstm-125m"
# (B, L, D, N): the reference's sweep (tests/test_kernels.py:166)
SWEEP = [(2, 32, 64, 8), (1, 16, 128, 16), (2, 24, 96, 4)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
GRAD_NAMES = ("du", "ddelta", "da", "db", "dc", "dd")
LEAF_RTOL = 1e-4  # a leaf's max |port - JAX| against its largest |g|


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny models: one intra-op thread, as in test_torch_decode.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_launch():
    """Every test here runs on CPU tensors: no kernel may launch."""
    before = (ms.mamba_scan.launches, ms.mamba_scan_bwd.launches)
    yield
    assert (ms.mamba_scan.launches, ms.mamba_scan_bwd.launches) == before


def cfgs(arch, **over):
    """(JAX config, port config) at the reduced widths; jamba with
    ``ssm_chunk`` 16 unless ``over`` says otherwise."""
    kw = dict(ssm_chunk=16) if arch == JAMBA else {}
    kw.update(over)
    return (dataclasses.replace(jax_config(arch).reduced(), **kw),
            dataclasses.replace(torch_config(arch).reduced(), **kw))


def leaf_ratio(a, b):
    """max |a - b| over max |b| (0 where b is all zeros and a agrees)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    scale = np.abs(b).max()
    return float(np.abs(a - b).max() / scale) if scale else \
        float(np.abs(a).max())


def assert_leaves_close(got, want, names, rtol=LEAF_RTOL):
    assert len(got) == len(want) == len(names)
    ratios = {n: leaf_ratio(a, b) for n, a, b in zip(names, got, want)}
    bad = {n: r for n, r in ratios.items() if not r <= rtol}
    assert not bad, bad


# ---------------------------------------------------------------------------
# the scan's gradient
# ---------------------------------------------------------------------------
def _scan_inputs(seed, b, l, d, n):
    """The reference sweep's distributions (u, delta = softplus(.),
    a = -|.|, B, C, D) and a cotangent dy, f32 numpy."""
    rng = np.random.default_rng(seed)
    u = 0.5 * rng.standard_normal((b, l, d))
    delta = np.logaddexp(rng.standard_normal((b, l, d)), 0.0)
    a = -np.abs(rng.standard_normal((d, n)))
    bb = 0.5 * rng.standard_normal((b, l, n))
    cc = 0.5 * rng.standard_normal((b, l, n))
    ds = rng.standard_normal(d)
    dy = rng.standard_normal((b, l, d))
    return [x.astype(np.float32) for x in (u, delta, a, bb, cc, ds, dy)]


def _torch_in(arrs, tdt):
    """a stays f32, the rest in ``tdt`` (rounded through it)."""
    return [torch.from_numpy(x).to(torch.float32 if i == 2 else tdt)
            for i, x in enumerate(arrs)]


def assert_grads_close(got, want, dtype):
    """Each output within 1e-5 of its largest |value|; in bf16 one bf16
    rounding of the element more (dD included: autograd and JAX round it
    to the bf16 skip's dtype; only dA, of the f32 A, is not rounded)."""
    for name, g, w in zip(GRAD_NAMES, got, want):
        g = np.asarray(g, np.float32)
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, name
        tol = 1e-5 * np.abs(w).max()
        if dtype == "bfloat16" and name != "da":
            tol = tol + 2.0 ** -8 * np.abs(w)
        assert (np.abs(g - w) <= tol).all(), (
            name, float(np.abs(g - w).max()), float(np.abs(w).max()))


@pytest.mark.parametrize("b,l,d,n", SWEEP)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_bwd_plain_matches_autograd_through_the_plain_scan(b, l, d, n, dtype,
                                                           no_launch):
    arrs = _scan_inputs(b * l + d, b, l, d, n)
    t = _torch_in(arrs, DTYPES[dtype][1])
    got = ms.mamba_scan_bwd_plain(*t)
    for g, x in zip(got, t[:6]):
        assert g.dtype == (torch.float32 if x is t[5] else x.dtype)
        assert g.shape == x.shape
    ins = [x.clone().requires_grad_() for x in t[:6]]
    y, _ = ms.mamba_scan_plain(*ins)
    want = torch.autograd.grad(y, ins, t[6])
    assert_grads_close([g.float() for g in got], [w.float() for w in want],
                       dtype)


@pytest.mark.parametrize("b,l,d,n", SWEEP)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_bwd_plain_matches_jax_vjp_of_the_reference_scan(b, l, d, n, dtype,
                                                         no_launch):
    """In bf16 JAX gets the bf16-rounded inputs in f32: the reference's
    scan casts every input to f32 first, but its vjp sums dD's per-step
    cotangents in the primal's bf16, L * B roundings deep."""
    jdt, tdt = DTYPES[dtype]
    arrs = _scan_inputs(b * l + d + 1, b, l, d, n)
    j = [jnp.asarray(jnp.asarray(x, jnp.float32 if i == 2 else jdt),
                     jnp.float32) for i, x in enumerate(arrs)]
    _, vjp = jax.vjp(lambda *xs: mamba_scan_ref(*xs)[0], *j[:6])
    want = [np.asarray(jnp.asarray(w, jnp.float32 if i == 2 else jdt),
                       np.float32) for i, w in enumerate(vjp(j[6]))]
    got = ms.mamba_scan_bwd_plain(*_torch_in(arrs, tdt))
    assert_grads_close([g.float().numpy() for g in got], want, dtype)


def test_mamba_scan_function_runs_the_plain_versions_on_cpu(no_launch):
    """``MambaScan`` on CPU tensors: y and h_last are the plain scan's,
    h_last is not differentiable, and the gradients are the plain
    backward's, dB and dC scattered into the projection they were sliced
    from."""
    b, l, d, n = 2, 24, 96, 8
    arrs = _scan_inputs(11, b, l, d, n)
    t = _torch_in(arrs, torch.float32)
    wide = torch.cat([t[3], t[4], t[3]], dim=-1).requires_grad_()
    ins = [x.clone().requires_grad_() for x in (t[0], t[1], t[2], t[5])]
    u, delta, a, ds = ins
    bb, cc = wide[..., :n], wide[..., n:2 * n]  # strided, as x_proj's
    y, h = ms.MambaScan.apply(u, delta, a, bb, cc, ds)
    yp, hp = ms.mamba_scan_plain(*t[:6])
    assert torch.equal(y, yp) and torch.equal(h, hp)
    assert y.requires_grad and not h.requires_grad
    grads = torch.autograd.grad(y, ins + [wide], t[6])
    want = ms.mamba_scan_bwd_plain(*t)
    for g, w in zip(grads[:4], (want[0], want[1], want[2], want[5])):
        assert torch.equal(g, w)
    assert torch.equal(grads[4][..., :n], want[3])
    assert torch.equal(grads[4][..., n:2 * n], want[4])
    assert not grads[4][..., 2 * n:].any()
    # nothing asks for a gradient: no graph, as the bare scan
    with torch.no_grad():
        y2, _ = ms.MambaScan.apply(*t[:6])
    assert y2.grad_fn is None and torch.equal(y2, yp)


def test_mamba_scan_function_gradients_keep_each_input_dtype(no_launch):
    """bf16 u, delta, B, C and skip D with the f32 A: each gradient comes
    back in its input's dtype (dD in bf16 as the model's ``D``)."""
    t = _torch_in(_scan_inputs(12, 1, 16, 32, 4), torch.bfloat16)
    ins = [x.clone().requires_grad_() for x in t[:6]]
    y, _ = ms.MambaScan.apply(*ins)
    assert y.dtype == torch.bfloat16
    grads = torch.autograd.grad(y, ins, t[6])
    assert [g.dtype for g in grads] == [x.dtype for x in ins]
    assert ins[2].dtype == torch.float32


def test_ops_dispatch_takes_the_plain_backward_on_cpu(no_launch):
    t = _torch_in(_scan_inputs(13, 1, 12, 40, 16), torch.float32)
    for g, w in zip(ops.mamba_scan_bwd(*t), ms.mamba_scan_bwd_plain(*t)):
        assert torch.equal(g, w)


def _bad(case):
    t = _torch_in(_scan_inputs(14, 1, 8, 16, 4), torch.float32)
    if case == "state":  # N 32 is not built
        t[2] = torch.zeros((16, 32))
        t[3] = t[4] = torch.zeros((1, 8, 32))
    elif case == "dy_shape":
        t[6] = t[6][:, :4]
    elif case == "dy_dtype":
        t[6] = t[6].to(torch.bfloat16)
    elif case == "b_dtype":
        t[3] = t[3].to(torch.bfloat16)
    return t


@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA tensors only"),
    ("state", r"built for N in \(4, 8, 16\)"),
    ("dy_shape", "dy torch.float32"),
    ("dy_dtype", "dy torch.bfloat16"),
    ("b_dtype", "the kernel takes one dtype")])
def test_bwd_wrapper_raises_on_what_the_kernel_does_not_take(case, match,
                                                             no_launch):
    """The kernel wrapper never runs the plain version: CPU tensors raise,
    and shapes and dtypes the kernel does not take raise before the
    device check."""
    with pytest.raises(ValueError, match=match):
        ms.mamba_scan_bwd(*_bad(case))


def test_bwd_blocks_cover_every_channel():
    for n in ms.STATE_DIMS:
        # a warp's 32 lanes hold BWD_LANE_STATES states each (N / 2 if
        # less)
        per = ms.BWD_WARPS * 32 * min(ms.BWD_LANE_STATES, n // 2) // n
        for d in (1, per - 1, per, per + 1, 16384):
            nb = ms.bwd_blocks(d, n)
            assert (nb - 1) * per < d <= nb * per


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_bwd_kernel_matches_plain(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100; chip_smoke.py's "
                    "kernel_check_mamba_bwd also covers this)")
    tdt = DTYPES[dtype][1]
    for b, l, d, n in SWEEP + [(2, 300, 200, 16)]:
        t = [x.cuda() for x in _torch_in(_scan_inputs(b + l, b, l, d, n),
                                         tdt)]
        wide = torch.cat([t[3], t[4], t[3]], dim=-1)  # B/C as row slices
        t[3], t[4] = wide[..., :n], wide[..., n:2 * n]
        got = ms.mamba_scan_bwd(*t)
        again = ms.mamba_scan_bwd(*t)
        want = ms.mamba_scan_bwd_plain(*t)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(got, again))
        assert_grads_close([g.float().cpu() for g in got],
                           [w.float().cpu() for w in want], dtype)


# ---------------------------------------------------------------------------
# each mixer's training layer
# ---------------------------------------------------------------------------
MIXERS = {"mamba": (JAMBA, "1", JS.mamba, TS.mamba),
          "mlstm": (XLSTM, "0", JS.mlstm, TS.mlstm),
          "slstm": (XLSTM, "1", JS.slstm, TS.slstm)}


def _layer_grads(mixer, seed, jdt=jnp.float32, tdt=torch.float32, l=32):
    """(port, JAX) gradients of sum(out * w) for the layer's parameters
    and its input, and the leaf names."""
    arch, key, jfn, tfn = MIXERS[mixer]
    jcfg, tcfg = cfgs(arch)
    p = jax.tree.map(lambda a: a[0], np_params(jcfg, seed)["stack"][key]
                     [mixer])
    rng = np.random.default_rng(seed)
    x = 0.5 * rng.standard_normal((2, l, jcfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, l, jcfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), p)

    def jloss(p, x):
        out, _ = jfn(p, jcfg, x)
        return jnp.sum(out.astype(jnp.float32) * w)

    jg = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x, jdt))
    tp = params_from_numpy(p, "cpu")
    leaves = [t.to(tdt).requires_grad_() for t in TREE.leaves(tp)]
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    out, cache = tfn(TREE.unflatten(TREE.flatten(tp)[1], leaves), tcfg, tx)
    assert cache is None
    tg = torch.autograd.grad((out.float() * torch.from_numpy(w)).sum(),
                             leaves + [tx])
    names = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(jg[0])[0]] + ["x"]
    return ([g.float().numpy() for g in tg],
            jax.tree.leaves(jg[0]) + [jg[1]], names)


@pytest.mark.parametrize("mixer", sorted(MIXERS))
def test_mixer_layer_gradients_match_jax(mixer, no_launch):
    got, want, names = _layer_grads(mixer, 21)
    assert_leaves_close(got, want, names)


def test_mamba_layer_gradients_bf16(no_launch):
    """A bf16 Mamba layer: the reference forms ``delta * u`` in bf16, the
    port's scan in f32 (ROADMAP's known differences), and each gradient
    is rounded to bf16: every leaf within 5e-2 of its largest."""
    got, want, names = _layer_grads("mamba", 22, jnp.bfloat16,
                                    torch.bfloat16)
    assert_leaves_close(got, want, names, rtol=5e-2)


# ---------------------------------------------------------------------------
# the model: make_loss_fn, remat, the trainer
# ---------------------------------------------------------------------------
LOSS_CASES = {"jamba": (JAMBA, dict(num_experts=0), 32),
              "jamba_moe": (JAMBA, {}, 32),
              "jamba_default_chunk": (JAMBA, dict(num_experts=0,
                                                  ssm_chunk=256), 300),
              "xlstm": (XLSTM, {}, 32)}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_and_gradients_match_jax(case, no_launch):
    """``make_loss_fn`` against ``jax.value_and_grad`` of the reference's:
    jamba without and with experts over two chunks of the reference's
    scan, jamba at its default chunk with 300 tokens (one chunk of 256
    and a remainder: the reference then takes the whole sequence as one
    chunk), xlstm-125m."""
    arch, over, l = LOSS_CASES[case]
    jcfg, tcfg = cfgs(arch, **over)
    npp = np_params(jcfg, 23)
    toks = tokens(23, 2, l, jcfg.vocab_size)
    jl, jg = jax.value_and_grad(JLOOP.make_loss_fn(jcfg, remat=False))(
        to_jax(npp), {"tokens": jnp.asarray(toks),
                      "labels": jnp.asarray(toks)})
    tp = params_from_numpy(npp, "cpu")
    leaves = TREE.leaves(tp)
    for x in leaves:
        x.requires_grad_()
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(toks)}
    tl = TLOOP.make_loss_fn(tcfg, remat=False)(tp, batch)
    tg = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    names = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(jg)[0]]
    mixers = {"mamba"} if arch == JAMBA else {"mlstm", "slstm"}
    assert all(any(m in k for k in names) for m in mixers)
    assert_leaves_close([g.numpy() for g in tg], jax.tree.leaves(jg), names)


@pytest.mark.parametrize("arch", [JAMBA, XLSTM])
def test_remat_gradients_equal_no_remat(arch, no_launch):
    """Each super-block under ``torch.utils.checkpoint`` (the scan's
    forward then runs again in the backward pass): loss and gradients
    bitwise those without."""
    jcfg, tcfg = cfgs(arch)
    params = params_from_numpy(np_params(jcfg, 24), "cpu")
    toks = torch.from_numpy(tokens(24, 2, 32, jcfg.vocab_size))
    out = {}
    for remat in (False, True):
        leaves = [x.detach().clone().requires_grad_()
                  for x in TREE.leaves(params)]
        p = TREE.unflatten(TREE.flatten(params)[1], leaves)
        loss = TLOOP.make_loss_fn(tcfg, remat=remat)(
            p, {"tokens": toks, "labels": toks})
        out[remat] = (loss.detach(), torch.autograd.grad(loss, leaves))
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(out[True][1], out[False][1]):
        assert torch.equal(a, b)


def test_remat_runs_the_scan_forward_again(monkeypatch):
    """Under remat each Mamba layer's scan runs twice a step (once in the
    forward, once when the backward recomputes it) and its backward once."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = ops.mamba_scan, ops.mamba_scan_bwd

    def count(name, fn):
        def run(*a):
            calls[name] += 1
            return fn(*a)
        return run

    monkeypatch.setattr(ops, "mamba_scan", count("fwd", fwd))
    monkeypatch.setattr(ops, "mamba_scan_bwd", count("bwd", bwd))
    jcfg, tcfg = cfgs(JAMBA, num_experts=0, num_layers=8)
    params = params_from_numpy(np_params(jcfg, 25), "cpu")
    toks = torch.from_numpy(tokens(25, 1, 16, jcfg.vocab_size))
    layers = 7  # one super-block: 1 attention, 7 Mamba
    for remat, fwd_calls in ((False, layers), (True, 2 * layers)):
        calls.update(fwd=0, bwd=0)
        leaves = [x.detach().clone().requires_grad_()
                  for x in TREE.leaves(params)]
        loss = TLOOP.make_loss_fn(tcfg, remat=remat)(
            TREE.unflatten(TREE.flatten(params)[1], leaves),
            {"tokens": toks, "labels": toks})
        torch.autograd.grad(loss, leaves)
        assert calls == {"fwd": fwd_calls, "bwd": layers}, (remat, calls)


STEPS = 5


def _jcomp(name, **kw):
    return dataclasses.replace(jget_compressor(name, **kw), fused_encode=None)


@pytest.mark.parametrize("arch", [JAMBA, XLSTM])
def test_trainer_history_matches_jax(arch, monkeypatch, no_launch):
    """Both CLIs' ``sync --compressor onebit`` with Adam (fused in the
    port) over 5 steps of the JAX package's batches on the ``--reduced``
    model (jamba with its experts), each step taken from the reference's
    state (the bridge brings the whole state, 1-bit residuals included,
    into the port first).  Adam's first update is lr * sign(g), so a
    last-bit difference in a gradient element near 0 moves that element
    by 2 lr: jamba's step 0 moves 174 of 32.7 M parameters so, and free
    runs then part by 4e-3 in loss within 5 steps, as far as the
    reference's own runs part when only its scan's chunk changes (16 to
    4 steps: 3.3e-3).  So each step: the loss within rtol 1e-5, wire
    bytes exact, divergence 0, and the new parameters within 1e-6 of the
    reference's on all but 1e-3 of the elements, none further than 3 lr
    (1.5 flipped updates); Adam's m and v and the 1-bit residuals within
    1e-4 of their leaf's largest on all but 1e-3 of each one's elements,
    none further than twice it (a flipped sign)."""
    monkeypatch.setattr(JCLI, "get_compressor", _jcomp)
    jcfg = jax_config(arch).reduced()
    tcfg = torch_config(arch).reduced()
    w, lr = 2, 1e-3
    argv = ["--strategy", "sync", "--compressor", "onebit", "--fused-adam",
            "--steps", str(STEPS), "--workers", str(w)]
    jstrat = JCLI.strategy_from_args(JCLI.build_argparser().parse_args(argv))
    tstrat = CLI.strategy_from_args(CLI.build_argparser().parse_args(
        argv + ["--device", "cpu"]))
    jopt = JO.adam(JO.warmup_cosine(lr, 1, STEPS))
    topt = TO.adam(TO.warmup_cosine(lr, 1, STEPS), fused=True)
    jcomm, tcomm = JLocalComm(w), LocalComm(w)
    params = jcomm.replicate(to_jax(np_params(jcfg, seed=26)))
    jstate = JLOOP.init_train_state(params, jopt, jstrat, jcomm)
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
        # copies: the reference's step donates the state it is given
        tstate = train_state_from_numpy(jax.tree.map(np.array, jstate),
                                        "cpu")
        jstate, jm = jstep(jstate, jnp.asarray(toks))
        tstate, tm = tstep(tstate, torch.from_numpy(toks))
        assert tm["wire_bytes"].item() == float(jm["wire_bytes"]), t
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   rtol=1e-5)
        assert tm["replica_divergence"].item() == 0.0
        diffs = [np.abs(np.asarray(jax.device_get(j), np.float32)
                        - x.float().numpy()).ravel()
                 for j, x in zip(jax.tree.leaves(jstate["params"]),
                                 TREE.leaves(tstate["params"]))]
        diffs = np.concatenate(diffs)
        assert diffs.max() <= 3 * lr, (t, diffs.max())
        assert (diffs > 1e-6).mean() <= 1e-3, (t, (diffs > 1e-6).mean())
        # Adam's m and v and the 1-bit residuals, each measured against its
        # leaf's largest; a flipped sign moves an element by twice its
        # row's scale
        for part in ("opt_state", "comm_state"):
            got = TREE.leaves(tstate[part])
            want = jax.tree_util.tree_flatten_with_path(jstate[part])[0]
            assert len(got) == len(want), part
            off, size = {}, {}
            for (path, j), x in zip(want, got):
                j = np.asarray(jax.device_get(j), np.float32)
                assert j.shape == tuple(x.shape), (part, path)
                scale = np.abs(j).max() or 1.0
                rel = np.abs(x.float().numpy() - j) / scale
                assert rel.max() <= 2.0, (t, jax.tree_util.keystr(path))
                kind = jax.tree_util.keystr(path[:1])
                off[kind] = off.get(kind, 0) + int((rel > 1e-4).sum())
                size[kind] = size.get(kind, 0) + j.size
            assert set(off) == ({"['m']", "['v']"} if part == "opt_state"
                                else {"['residual']"}), off
            for kind in off:
                assert off[kind] <= 1e-3 * size[kind], (t, part, kind,
                                                        off[kind])


@pytest.mark.parametrize("arch", [JAMBA, XLSTM])
def test_cli_trains_a_recurrent_arch_on_cpu(arch, capsys, no_launch):
    """The README's drive, shortened: ``--reduced --device cpu
    --compressor onebit --fused-adam`` takes jamba (16 layers, 4 experts)
    and xlstm-125m, as the reference's CLI does."""
    hist = CLI.main(["--arch", arch, "--reduced", "--device", "cpu",
                     "--compressor", "onebit", "--fused-adam", "--steps",
                     "2", "--log-every", "1", "--workers", "2",
                     "--batch-per-worker", "2", "--seq-len", "16"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"arch={arch}-reduced ")
    assert len(hist) == 2
    assert all(np.isfinite(r["loss"]) and r["divergence"] == 0.0
               for r in hist)
