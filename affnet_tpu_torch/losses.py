"""Descriptor losses of AffNet training and shape optimization.

Counterparts of ``loss_hardnegc``, ``loss_hardnet`` (its default
``batch_reduce="min"``), ``descriptor_dist`` and ``get_snn`` in
``affnet_tpu/losses.py``, with the same masking constants: +10 on the
diagonal, +10 on near-duplicate negatives (distance < 0.008).
"""

from __future__ import annotations

import torch

from .match import distance_matrix, distance_vectors_pairwise

Tensor = torch.Tensor

EPS = 1e-8


def _mask_negatives(d: Tensor) -> Tensor:
    n = d.shape[0]
    d = d + torch.eye(n, dtype=d.dtype, device=d.device) * 10.0
    return d + (d < 0.008).to(d.dtype) * 10.0


def loss_hardnet(anchor: Tensor, positive: Tensor, anchor_swap: bool = False,
                 margin: float = 1.0) -> Tensor:
    """Hardest-in-batch triplet margin loss."""
    d = distance_matrix(anchor, positive) + EPS
    pos = torch.diagonal(d)
    dist = _mask_negatives(d)
    min_neg = dist.min(dim=1).values
    if anchor_swap:
        min_neg = torch.minimum(min_neg, dist.min(dim=0).values)
    return torch.clamp(margin + pos - min_neg, min=0.0).mean()


def loss_hardnegc(anchor: Tensor, positive: Tensor,
                  margin: float = 1.0) -> Tensor:
    """Symmetric hardest-negative contrastive loss with the negatives'
    side detached in each half — the AffNet training loss."""
    pos1 = distance_vectors_pairwise(anchor, positive)

    def half(a: Tensor, p: Tensor, dim: int) -> Tensor:
        d = _mask_negatives(distance_matrix(a, p) + EPS)
        min_neg = d.min(dim=dim).values
        return torch.clamp(margin + pos1 - min_neg, min=0.0).mean()

    return (0.5 * half(anchor, positive.detach(), 1)
            + 0.5 * half(anchor.detach(), positive, 0))


def get_snn(anchor: Tensor, positive: Tensor) -> Tensor:
    """Second-nearest-neighbor ratio per anchor: the positive distance over
    the nearest negative's (the diagonal masked by +10)."""
    d = distance_matrix(anchor, positive) + EPS
    n = d.shape[0]
    pos = torch.diagonal(d)
    d_masked = d + torch.eye(n, dtype=d.dtype, device=d.device) * 10.0
    return pos / (d_masked.min(dim=1).values + EPS)


def descriptor_dist(desc_a: Tensor, desc_p: Tensor) -> Tensor:
    """Mean positive distance — the 'PosDist' loss."""
    return torch.sqrt(((desc_a - desc_p) ** 2).sum(dim=1) + 1e-6).mean()
