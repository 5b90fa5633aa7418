"""Descriptor losses of the trainers and of shape optimization.

Counterparts of every function in ``affnet_tpu/losses.py``: the HardNet,
HardNegC, L2Net and random-sampling losses, the global orthogonal
regularization, ``get_snn`` and ``descriptor_dist``, with the same masking
constants: +10 on the diagonal, +10 on near-duplicate negatives (distance
< 0.008).
"""

from __future__ import annotations

from typing import Optional

import torch

from .match import distance_matrix, distance_vectors_pairwise

Tensor = torch.Tensor

EPS = 1e-8


def _mask_negatives(d: Tensor) -> Tensor:
    n = d.shape[0]
    d = d + torch.eye(n, dtype=d.dtype, device=d.device) * 10.0
    return d + (d < 0.008).to(d.dtype) * 10.0


def _margin_loss(pos: Tensor, min_neg: Tensor, margin: float,
                 loss_type: str) -> Tensor:
    if loss_type == "triplet_margin":
        loss = torch.clamp(margin + pos - min_neg, min=0.0)
    elif loss_type == "softmax":
        exp_pos = torch.exp(2.0 - pos)
        exp_den = exp_pos + torch.exp(2.0 - min_neg) + EPS
        loss = -torch.log(exp_pos / exp_den)
    elif loss_type == "contrastive":
        loss = torch.clamp(margin - min_neg, min=0.0) + pos
    else:
        raise ValueError(f"Unknown loss type {loss_type}")
    return loss.mean()


def loss_hardnet(anchor: Tensor, positive: Tensor, anchor_swap: bool = False,
                 margin: float = 1.0, batch_reduce: str = "min",
                 loss_type: str = "triplet_margin",
                 generator: Optional[torch.Generator] = None,
                 perm: Optional[Tensor] = None) -> Tensor:
    """The HardNet loss over the masked distance matrix.  ``batch_reduce``
    picks each anchor's negative: ``min`` the hardest in its row (and
    column with ``anchor_swap``), ``average`` every entry (each paired with
    the positive distance of its column, as the reference tiles them),
    ``random`` column ``perm[i]`` for anchor i, a permutation drawn from
    ``generator`` unless given.  ``jax.random.permutation`` cannot be
    reproduced here, so parity with the JAX package passes both the same
    ``perm``.  ``loss_type``: triplet_margin, softmax or contrastive."""
    d = distance_matrix(anchor, positive) + EPS
    pos1 = torch.diagonal(d)
    dist = _mask_negatives(d)
    n = anchor.shape[0]
    if batch_reduce == "min":
        min_neg = dist.min(dim=1).values
        if anchor_swap:
            min_neg = torch.minimum(min_neg, dist.min(dim=0).values)
        pos = pos1
    elif batch_reduce == "average":
        pos = pos1.repeat(n)
        min_neg = dist.reshape(-1)
        if anchor_swap:
            min_neg = torch.minimum(min_neg, dist.T.reshape(-1))
    elif batch_reduce == "random":
        if perm is None:
            perm = torch.randperm(n, generator=generator,
                                  device=None if generator is None
                                  else generator.device)
        perm = perm.to(dist.device)
        rows = torch.arange(n, device=dist.device)
        min_neg = dist[rows, perm]
        if anchor_swap:
            min_neg = torch.minimum(min_neg, dist.T[rows, perm])
        pos = pos1
    else:
        raise ValueError(f"Unknown batch_reduce {batch_reduce}")
    return _margin_loss(pos, min_neg, margin, loss_type)


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


def loss_l2net(anchor: Tensor, positive: Tensor, anchor_swap: bool = False,
               margin: float = 1.0, loss_type: str = "softmax") -> Tensor:
    """The L2Net loss: a softmax over each anchor's whole row (and column
    with ``anchor_swap``)."""
    if loss_type != "softmax":
        raise ValueError("Only softmax loss works with L2Net sampling")
    d = distance_matrix(anchor, positive)
    exp_pos = torch.exp(2.0 - torch.diagonal(d))
    exp_d = torch.exp(2.0 - d)
    loss = -torch.log(exp_pos / (exp_d.sum(dim=1) + EPS))
    if anchor_swap:
        loss = loss - torch.log(exp_pos / (exp_d.sum(dim=0) + EPS))
    return loss.mean()


def loss_random_sampling(anchor: Tensor, positive: Tensor, negative: Tensor,
                         anchor_swap: bool = False, margin: float = 1.0,
                         loss_type: str = "triplet_margin") -> Tensor:
    """Triplet, softmax or contrastive loss against each triplet's own
    (random) negative; ``anchor_swap`` also takes the positive's distance
    to it."""
    pos, d_a_n, d_p_n = distance_vectors_pairwise(anchor, positive, negative)
    min_neg = torch.minimum(d_a_n, d_p_n) if anchor_swap else d_a_n
    return _margin_loss(pos, min_neg, margin, loss_type)


def global_orthogonal_regularization(anchor: Tensor,
                                     negative: Tensor) -> Tensor:
    """The GOR term: mean(a.n)^2 + max(mean((a.n)^2) - 1/dim, 0)."""
    neg_dis = (anchor * negative).sum(dim=1)
    dim = anchor.shape[1]
    return neg_dis.mean() ** 2 + torch.clamp((neg_dis ** 2).mean() - 1.0 / dim,
                                             min=0.0)


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
