"""SGD, momentum and Adam, and their learning-rate schedules.

Port of ``repro/optim/optimizers.py``.  Every update runs in f32 against
the params it is handed and casts the result back to the param dtype.
The schedules are computed as f32 tensors on the step counter's device,
in the reference's order of operations: a Python-float ``math.cos`` would
drift from ``jnp.cos`` in f32 by an ulp, and a host value would cost a
device synchronisation per step.

``adam(fused=True)`` runs the update leaf by leaf through
``kernels.ops.fused_adam`` (the CUDA kernel for CUDA tensors, its plain
version for CPU tensors), IN PLACE on the params and the optimizer state,
as a donated JAX step reuses their buffers; the unfused update returns new
tensors.  ``delay_compensated_sgd`` (DC-ASGD) keeps the weight snapshot its
gradients were computed against in its state.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.core import tree as T
from repro_torch.kernels import ops


def _step_tensor(t, params=None):
    """The step counter as an int32 tensor.  A Python int (the train loop
    passes one) becomes one on the device of ``params``' first leaf, the
    host without ``params``; ``torch.full`` fills it there without a
    host-to-device copy, which would wait for the device."""
    if isinstance(t, torch.Tensor):
        return t
    leaves = T.leaves(params) if params is not None else []
    return torch.full((), int(t), dtype=torch.int32,
                      device=leaves[0].device if leaves else None)


# ---------------------------------------------------------------------------
# learning-rate schedules
# ---------------------------------------------------------------------------
def constant_schedule(lr):
    return lambda t: torch.full((), lr, dtype=torch.float32,
                                device=_step_tensor(t).device)


def cosine_schedule(lr, total_steps, final_frac=0.1):
    def f(t):
        frac = torch.clamp(_step_tensor(t) / max(1, total_steps), 0.0, 1.0)
        c = 0.5 * (1 + torch.cos(math.pi * frac))
        return lr * (final_frac + (1 - final_frac) * c)
    return f


def warmup_cosine(lr, warmup, total_steps, final_frac=0.1):
    cos = cosine_schedule(lr, total_steps - warmup, final_frac)

    def f(t):
        t = _step_tensor(t)
        w = torch.clamp((t + 1) / max(1, warmup), max=1.0)
        return torch.where(t < warmup, lr * w, cos(t - warmup))
    return f


# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Optimizer:
    init: Callable  # params -> opt_state
    update: Callable  # (grads, opt_state, params, t) -> (new_params, opt_state)
    state_floats: int = 0  # f32 state values kept per parameter element


def state_template(opt: Optimizer, params):
    """Shape/dtype skeleton of ``opt.init(params)`` with NO allocation:
    ``init`` runs on meta tensors of the params' shapes and dtypes."""
    meta = T.tree_map(lambda x: torch.empty(tuple(x.shape), dtype=x.dtype,
                                            device="meta"), params)
    return opt.init(meta)


def _as_sched(lr):
    return lr if callable(lr) else constant_schedule(lr)


def _zeros(p):
    return torch.zeros_like(p, dtype=torch.float32)


def sgd(lr, weight_decay: float = 0.0) -> Optimizer:
    lr = _as_sched(lr)

    def init(params):
        return {}

    def update(grads, state, params, t):
        step = lr(_step_tensor(t, params))

        def one(p, g):
            return (p.float() - step * (g.float() + weight_decay * p.float())
                    ).to(p.dtype)

        return T.tree_map(one, params, grads), state

    return Optimizer(init, update, state_floats=0)


def momentum(lr, beta: float = 0.9, nesterov: bool = False,
             weight_decay: float = 0.0) -> Optimizer:
    lr = _as_sched(lr)

    def init(params):
        return {"m": T.tree_map(_zeros, params)}

    def update(grads, state, params, t):
        step = lr(_step_tensor(t, params))
        m = T.tree_map(lambda m_, g: beta * m_ + g.float(), state["m"], grads)
        upd = (T.tree_map(lambda m_, g: beta * m_ + g.float(), m, grads)
               if nesterov else m)

        def one(p, u):
            return (p.float() - step * (u + weight_decay * p.float())
                    ).to(p.dtype)

        return T.tree_map(one, params, upd), {"m": m}

    return Optimizer(init, update, state_floats=1)


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0, fused: bool = False) -> Optimizer:
    """``fused=True`` runs the (p, m, v) read-modify-write through
    ``kernels.ops.fused_adam`` leaf by leaf on the flattened view, in
    place.  The kernel carries no weight-decay term, so fusion is only
    offered for ``weight_decay=0``."""
    lr = _as_sched(lr)
    if fused and weight_decay:
        raise ValueError("fused adam does not implement weight_decay; "
                         "use fused=False")

    def init(params):
        return {"m": T.tree_map(_zeros, params),
                "v": T.tree_map(_zeros, params)}

    def update(grads, state, params, t):
        t = _step_tensor(t, params)
        tt = t.float() + 1.0
        m = T.tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(),
                       state["m"], grads)
        v = T.tree_map(
            lambda v_, g: b2 * v_ + (1 - b2) * torch.square(g.float()),
            state["v"], grads)
        mh = T.tree_map(lambda m_: m_ / (1 - b1 ** tt), m)
        vh = T.tree_map(lambda v_: v_ / (1 - b2 ** tt), v)
        step = lr(t)

        def one(p, m_, v_):
            return (p.float() - step * (m_ / (torch.sqrt(v_) + eps)
                                        + weight_decay * p.float())
                    ).to(p.dtype)

        return T.tree_map(one, params, mh, vh), {"m": m, "v": v}

    def update_fused(grads, state, params, t):
        t = _step_tensor(t, params)
        tt = t.float() + 1.0
        # (lr, bc1, bc2) stay an f32 tensor on the device: no host read
        consts = torch.stack([lr(t), 1.0 - b1 ** tt, 1.0 - b2 ** tt])
        for p, g, m_, v_ in zip(T.leaves(params), T.leaves(grads),
                                T.leaves(state["m"]), T.leaves(state["v"])):
            ops.fused_adam(p.view(-1), g.float().reshape(-1).contiguous(),
                           m_.view(-1), v_.view(-1), consts, b1=b1, b2=b2,
                           eps=eps)
        return params, state

    return Optimizer(init, update_fused if fused else update, state_floats=2)


def delay_compensated_sgd(lr, lam: float = 0.04) -> Optimizer:
    """DC-ASGD (Zheng et al. 2016): g̃ = g + λ · g ⊙ g ⊙ (w − w_bak).

    ``w_bak`` is the weight snapshot the gradient was computed against;
    the optimizer state carries it (f32) and the update refreshes it to
    the new weights.  An asynchronous caller that ships a gradient may
    overwrite ``state["w_bak"]``."""
    lr = _as_sched(lr)

    def init(params):
        return {"w_bak": T.tree_map(lambda p: p.to(torch.float32, copy=True),
                                    params)}

    def update(grads, state, params, t):
        step = lr(_step_tensor(t, params))

        def comp(p, g, wb):
            gf = g.float()
            corr = gf + lam * gf * gf * (p.float() - wb)
            return (p.float() - step * corr).to(p.dtype)

        new = T.tree_map(comp, params, grads, state["w_bak"])
        new_bak = T.tree_map(lambda p: p.to(torch.float32, copy=True), new)
        return new, {"w_bak": new_bak}

    return Optimizer(init, update, state_floats=1)
