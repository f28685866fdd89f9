"""The replica-simulator training step.

Port of ``repro/train/loop.py``: ``make_loss_fn``, ``init_train_state``,
``make_replica_train_step`` and ``_stack_divergence``.  W model replicas
are stacked on axis 0 of every leaf (the ``LocalComm`` layout), each
replica takes its own data shard, and the strategy exchanges the
gradients and steps the optimizer.

Per-replica gradients come from a loop over the W replicas with
``torch.autograd.grad``, each replica's parameters taken as views of the
stacked leaves: one replica's activations and gradients are alive at a
time, and the stacked gradient is written in place, so the peak holds one
replica's temporaries instead of W of them (``torch.func.vmap`` over the
stacked tree would hold all W).  The step mutates the train state it is
given where the optimizer updates in place (``adam(fused=True)``), as the
reference's donated step reuses its buffers: keep a copy of a state you
want to re-step from.

The step counter ``state["step"]`` is an int32 tensor on the device, as
the reference's; beside it the step keeps the counter as a Python int and
hands that to ``strategy.update``, so a strategy's schedule (``local_sgd``,
``easgd`` and ``gossip``'s gates, ``ssp``'s ring slot, ``downpour``'s
pushes) decides on the host with no device read-back a step.  The int is
read back from the tensor only for a state this step did not make (the
first step, a state from ``bridge``).

This slice ports the f32 step (the reference's ``policy=None``) at
``accum_steps=1`` for the strategies of ``core/strategies.py``; precision
policies, microbatch accumulation and the ZeRO strategies are later
slices.
"""

from __future__ import annotations

import torch

from repro_torch.core import tree as T
from repro_torch.core.strategies import Strategy
from repro_torch.models import transformer as TM
from repro_torch.optim.optimizers import Optimizer
from repro_torch.train.losses import lm_loss


def make_loss_fn(cfg):
    """loss_fn(params, batch) -> scalar for ONE replica of a decoder-only
    model; ``batch`` holds "tokens" and "labels"."""
    def loss_fn(params, batch):
        logits, aux = TM.forward(params, cfg, tokens=batch["tokens"])
        return lm_loss(logits, batch["labels"], aux)

    return loss_fn


def init_train_state(params, optimizer: Optimizer, strategy: Strategy,
                     comm):
    """Stacked ``params`` → {params, opt_state, comm_state, step}; the step
    counter is an int32 tensor on the params' device."""
    device = T.leaves(params)[0].device
    return {
        "params": params,
        "opt_state": optimizer.init(params),
        "comm_state": strategy.init(params, comm),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def _replica_grads(loss_fn, params, batches, size):
    """Per-replica (losses (W,), stacked grads) of ``loss_fn`` for the
    stacked ``params`` and per-worker ``batches``, replica by replica."""
    leaves, tdef = T.flatten(params)
    grads = [torch.empty_like(x) for x in leaves]
    losses = []
    for w in range(size):
        pw = [x[w].detach().requires_grad_() for x in leaves]
        loss = loss_fn(T.unflatten(tdef, pw), batches[w])
        for out, gw in zip(grads, torch.autograd.grad(loss, pw)):
            out[w].copy_(gw)
        losses.append(loss.detach())
    return torch.stack(losses), T.unflatten(tdef, grads)


def make_replica_train_step(loss_fn, optimizer: Optimizer, strategy: Strategy,
                            comm):
    """loss_fn(params, batch) -> scalar, defined for ONE replica.

    The returned step takes the stacked state (leading dim W on every leaf
    of params and opt_state) and per-worker batches (leading dim W), and
    returns (new_state, metrics) with the metrics ``wire_bytes``,
    ``comm_events``, ``loss`` (mean over replicas) and
    ``replica_divergence``."""

    host = {"tensor": None, "t": 0}  # the last step tensor made, its value

    def step(state, batches):
        src = state["params"]
        t = host["t"] if state["step"] is host["tensor"] \
            else int(state["step"])
        loss, grads = _replica_grads(loss_fn, src, batches, comm.size)
        params, opt_state, comm_state, metrics = strategy.update(
            src, grads, state["opt_state"], state["comm_state"], t,
            optimizer, comm)
        del grads
        new_state = {"params": params, "opt_state": opt_state,
                     "comm_state": comm_state, "step": state["step"] + 1}
        host.update(tensor=new_state["step"], t=t + 1)
        metrics = dict(metrics)
        metrics["loss"] = loss.mean()
        metrics["replica_divergence"] = _stack_divergence(params)
        return new_state, metrics

    return step


def _stack_divergence(params):
    """Max |w_i − w_0| over replicas, the model-consistency measure of §3.
    Replica by replica, so the temporaries stay one replica's size."""
    out = []
    for x in T.leaves(params):
        if x.dim() > 0 and x.shape[0] > 1:
            out.append(torch.stack([(x[i] - x[0]).abs().max()
                                    for i in range(1, x.shape[0])]).max()
                       .float())
        else:
            out.append(torch.zeros((), dtype=torch.float32, device=x.device))
    return torch.stack(out).max() if out else torch.zeros(())
