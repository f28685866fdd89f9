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
the norms, the embedding and the head stay local.  Attention and dense
MLP stacks only: MoE, recurrent mixers and encoders raise (ROADMAP.md
Queue 1 item 11d).

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
gets the cotangent 1/(B·(L − 1)), the unsharded loss's.  The k/v
all-gather's backward sums every rank's cotangent of this rank's chunk
(a reduce-scatter), so a rank's gradient of a weight is its share: the
path through its own chunk's activations, with the cotangents that the
other ranks' queries sent back through its k and v.  The shares sum to
the unsharded gradient, and ``CPContext.finalize_grads`` all-sums them
(every leaf is replicated over "model").  Under ``remat`` the
all-gather runs again in the recomputation, on every rank alike.
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
    cover: MoE FFNs, recurrent mixers and encoders (ROADMAP.md Queue 1
    item 11d)."""
    specs, _ = cfg.superblock()
    what = sorted({s.mixer for s in specs} - {"attn"})
    if any(s.ffn == "moe" for s in specs):
        what.append("an MoE FFN")
    if cfg.is_encoder_decoder:
        what.append("an encoder")
    if what:
        raise NotImplementedError(
            f"sharding_mode='cp' covers attention and dense-MLP stacks; "
            f"{cfg.name} has {', '.join(what)}: see ROADMAP.md Queue 1 item "
            "11d")


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
