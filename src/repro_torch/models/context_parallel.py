"""Context parallelism (``sharding_mode="cp"``) over a mesh's "model" axis.

Port of the reference's ``cp`` mode (``repro/launch/sharding.py``'s
``PARAM_RULES_CP``, the ``cp`` branches of ``repro/models/layers.py::
_sdpa`` and ``repro/models/transformer.py::_logits``): the "model" axis
carries the SEQUENCE.  Each model rank holds every weight whole and, of
its data rank's (B, L) rows, the contiguous chunk ``[m·L/T, (m+1)·L/T)``
at its global positions (RoPE and the masks read them).  Attention takes
q from the rank's own chunk; k and v are computed after RoPE at the KV
heads and all-gathered over "model" on the sequence axis
(``core/comm.py::all_gather``, whose backward reduce-scatters the
cotangents in rank order), then the grouped einsum of the reference's
``cp`` branch runs over the whole sequence on the masked path.  The MLP,
the norms, the embedding and the head stay local.  Recurrent mixers
raise (ROADMAP.md Queue 1 item 11d part 3).

**MoE on the gathered rows.**  An MoE layer (``layers.py::moe``)
all-gathers its input over "model" (``gather_seq``) and routes the data
rank's WHOLE rows, as the reference's ``shard_map`` ``in_specs``
``P(dp, None, None)`` make its cp program do: the branch rule
(``_moe_ep`` or ``_moe_dense``) reads the gathered token count, so both
programs take the same branch, route the same token slices at the same
capacity and drop the same rows.  The output is narrowed back to the
rank's chunk (``chunk``); the shared experts' MLP is per token and runs
on the chunk.  The experts stay whole on every rank: ``_moe_ep`` takes
its E/T rows of each bank, whose other rows get no gradient there.

**The aux loss.**  On ``_moe_ep`` each model rank's slice has its aux
and the layer's is their ``pmean`` over "model"; on ``_moe_dense``
every model rank computes the one aux over the same gathered rows.
Either way every model rank holds the same value and ``cp_lm_loss``
adds it once.  The reference also pmeans it over the batch axes; here
each data rank keeps its own (its rows' mean), as the replica step's.

**One memory gather a step.**  An encoder runs on this rank's chunk of
the source at its global positions, its self-attention on the same
k/v all-gather (non-causal), and gives the memory's chunk (B, S/T, D).
``train/loop.py::make_loss_fn`` all-gathers it once a step; cross
attention then sees the whole memory on every rank and needs no
collective of its own, and the gather's backward reduce-scatters every
rank's cotangent onto the chunk's owner.

**The loss.** ``lm_loss`` shifts by one: position p predicts token p + 1,
so the last position of chunk m predicts the FIRST token of chunk m + 1
and the last rank has one target fewer.  A mean of the chunks' means is
not the unsharded loss.  Each rank sums its token losses against the
global next tokens (``cp_lm_loss``), the sums are all-summed over
"model" (``psum``) and divided by the global count B·(L − 1): every
model rank holds the unsharded loss.

**Which gradients a rank gets.** As for tensor parallelism
(``tensor_parallel.py``): each rank back-propagates that loss with the
cotangent 1/T; ``psum``'s backward all-sums, so each rank's token sum
gets the cotangent 1/(B·(L − 1)), the unsharded loss's.  Every
all-gather's backward sums every rank's cotangent of this rank's chunk
(a reduce-scatter): the k/v gathers', the MoE input's and the memory's.
So a rank's gradient of a weight is its share: the path through its own
chunk's activations, with the cotangents that the other ranks sent back
through its k and v, its MoE rows and its memory.  The shares sum to
the unsharded gradient, and ``CPContext.finalize_grads`` all-sums them
(every leaf is replicated over "model"; a bank row that ``_moe_ep``
left to another rank adds zeros).  The aux's cotangent is 1/T on every
rank: ``pmean``'s backward keeps it 1/T on each slice's aux, and on
``_moe_dense`` each of the T identical auxes gets 1/T, so the all-sum
gives the router the aux's gradient once.  Under ``remat`` the
all-gathers inside a super-block run again in the recomputation, on
every rank alike.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass

import torch

from repro_torch.core.comm import ShardComm, all_gather, psum
from repro_torch.core.fabric import DEFAULT_BUCKET_BYTES, Fabric


@dataclass(frozen=True)
class CPContext:
    """Active context parallelism: ``degree`` ranks over ``comm`` (the
    mesh's "model" ``ShardComm``), this rank the ``rank``-th chunk;
    ``fabric`` buckets ``finalize_grads``' all-sum."""

    degree: int
    comm: ShardComm
    fabric: Fabric

    @property
    def rank(self) -> int:
        return self.comm.rank

    def chunk(self, x, axis: int = 1):
        """This rank's contiguous chunk of ``x`` along ``axis``."""
        n = x.shape[axis]
        if n % self.degree:
            raise ValueError(f"cp: sequence length {n} does not divide by "
                             f"the model axis's {self.degree} ranks")
        c = n // self.degree
        return x.narrow(axis, self.rank * c, c)

    def positions(self, b: int, c: int, device):
        """(B, c) int32 global positions of this rank's chunk of c."""
        start = self.rank * c
        return torch.arange(start, start + c, dtype=torch.int32,
                            device=device).expand(b, c)

    def gather_seq(self, x):
        """Every rank's chunk of ``x`` (B, c, ...) in rank order: the
        whole sequence (B, T·c, ...)."""
        return all_gather(x, self.comm, 1)

    def finalize_grads(self, grads):
        """All-sum every leaf's gradient (each rank's share) over the
        ranks: one bucketed Fabric all-sum of the whole tree."""
        return self.fabric.all_sum(grads)


def check_cp(cfg) -> None:
    """Raise ``NotImplementedError`` for a stack that ``cp`` does not
    cover: recurrent mixers (ROADMAP.md Queue 1 item 11d part 3)."""
    specs, _ = cfg.superblock()
    what = sorted({s.mixer for s in specs} - {"attn"})
    if what:
        raise NotImplementedError(
            f"sharding_mode='cp' covers attention stacks with dense-MLP or "
            f"MoE FFNs and encoders; {cfg.name} has {', '.join(what)} "
            "mixers: see ROADMAP.md Queue 1 item 11d part 3")


_STACK: list = []


def current_cp():
    """The innermost active ``cp_context``, or None."""
    return _STACK[-1] if _STACK else None


@contextmanager
def cp_context(degree: int, comm: ShardComm = None,
               bucket_bytes: int = DEFAULT_BUCKET_BYTES):
    """Install a CP context over ``comm`` (``degree`` ranks) for the code
    run within, the backward passes that code's autograd graph takes
    included."""
    if degree < 2:
        raise ValueError(f"cp_context needs degree >= 2, got {degree}")
    if comm is None or comm.size != degree:
        raise ValueError(f"cp_context({degree}) needs the model axis's "
                         f"ShardComm of {degree} ranks, got "
                         f"{None if comm is None else comm.size}")
    ctx = CPContext(degree, comm, Fabric(comm, bucket_bytes))
    _STACK.append(ctx)
    try:
        yield ctx
    finally:
        _STACK.pop()


def cp_lm_loss(logits, labels, cp: CPContext, aux=0.0):
    """The unsharded ``lm_loss`` from this rank's chunk: ``logits`` (B, c,
    V) f32 of the chunk, ``labels`` the WHOLE (B, L) rows.  The chunk's
    positions predict the global next tokens (the last rank's last
    position predicts nothing); the rank's sum of token losses is
    all-summed over the ranks and divided by B·(L − 1)."""
    b, c = logits.shape[:2]
    l = labels.shape[1]
    start = cp.rank * c
    targets = labels[:, start + 1:start + c + 1]  # c, or c - 1 on the last
    lg = logits[:, :targets.shape[1]]
    logz = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, targets[..., None].long())[..., 0]
    total = psum((logz - gold).sum(), cp.comm)
    count = torch.as_tensor(b * (l - 1), dtype=total.dtype).to(total.device)
    return total / count + aux
