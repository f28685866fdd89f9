"""Losses.  Port of ``repro/train/losses.py``."""

from __future__ import annotations

import torch


def cross_entropy(logits, labels, mask=None):
    """logits: (..., V) f32; labels: (...) int. Mean over unmasked."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def lm_loss(logits, tokens, aux=0.0):
    """Shifted next-token loss: predict tokens[t+1] from position t."""
    return cross_entropy(logits[:, :-1], tokens[:, 1:]) + aux
