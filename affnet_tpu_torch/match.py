"""Descriptor distances used by the training losses.

Counterparts of ``distance_matrix`` and ``distance_vectors_pairwise`` in
``affnet_tpu/match.py``.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def distance_matrix(anchor: Tensor, positive: Tensor,
                    eps: float = 1e-6) -> Tensor:
    """Pairwise L2 distances sqrt(| |a|^2 + |p|^2 - 2 a.p | + eps).  The
    abs keeps identical points finite: cancellation can leave a tiny
    negative under the root."""
    d1 = (anchor * anchor).sum(dim=1)[:, None]
    d2 = (positive * positive).sum(dim=1)[None, :]
    cross = anchor @ positive.T
    return torch.sqrt(torch.abs(d1 + d2 - 2.0 * cross) + eps)


def distance_vectors_pairwise(anchor: Tensor, positive: Tensor,
                              eps: float = 1e-8) -> Tensor:
    """Row-wise distances |a_i - p_i| through the same expansion."""
    a_sq = (anchor * anchor).sum(dim=1)
    p_sq = (positive * positive).sum(dim=1)
    return torch.sqrt(a_sq + p_sq - 2 * (anchor * positive).sum(dim=1) + eps)
