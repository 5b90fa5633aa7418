"""Descriptor matching: distance matrices and SNN-ratio tentative matching.

Counterparts of ``affnet_tpu/match.py``.  Reference: Losses.py:5-28 (the
distance kernels) and the matching logic inside test()
(train_AffNet_test_on_graffity.py:292-305).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import resolve_device
from .utils import float32_math

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
                              negative: Tensor = None, eps: float = 1e-8):
    """Row-wise distances |a_i - p_i| through the same expansion; with
    ``negative`` also |a_i - n_i| and |p_i - n_i|: (d_a_p, d_a_n, d_p_n)."""
    a_sq = (anchor * anchor).sum(dim=1)
    p_sq = (positive * positive).sum(dim=1)
    d_a_p = torch.sqrt(a_sq + p_sq - 2 * (anchor * positive).sum(dim=1) + eps)
    if negative is None:
        return d_a_p
    n_sq = (negative * negative).sum(dim=1)
    d_a_n = torch.sqrt(a_sq + n_sq - 2 * (anchor * negative).sum(dim=1)
                       + eps)
    d_p_n = torch.sqrt(p_sq + n_sq - 2 * (positive * negative).sum(dim=1)
                       + eps)
    return d_a_p, d_a_n, d_p_n


@float32_math()
def snn_match(desc1: Tensor, desc2: Tensor, snn_threshold: float = 0.8):
    """Second-nearest-neighbour ratio matching as the reference test() does
    it (train_AffNet_test_on_graffity.py:292-298): the nearest neighbour of
    each row (the first column among ties, as ``jnp.argmin``), then every
    column that is some row's nearest neighbour is set to 1e5 for ALL rows
    (the reference's ``dist_matrix[:, idxs_in_2] = 100000``, not a per-row
    second minimum) before the second minimum.  Runs where the descriptors
    lie, with TF32 off.

    Returns (idxs_in_2, mask, min_dist, ratio), each of length N1."""
    d = distance_matrix(desc1, desc2)
    idxs_in_2 = torch.argmin(d, dim=1)
    min_dist = torch.gather(d, 1, idxs_in_2[:, None])[:, 0]
    col_hit = torch.zeros(d.shape[1], dtype=torch.bool, device=d.device)
    col_hit[idxs_in_2] = True
    min_2nd = torch.where(col_hit[None, :], torch.full_like(d, 1e5),
                          d).min(dim=1).values
    ratio = min_dist / (min_2nd + 1e-8)
    mask = ratio <= snn_threshold
    return idxs_in_2, mask, min_dist, ratio


def snn_match_host(desc1, desc2, snn_threshold: float = 0.8,
                   device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Host wrapper: numpy (or tensor) descriptors matched on ``device``;
    returns the tentative matches (tent_idxs_in_1, tent_idxs_in_2) as int64
    numpy arrays."""
    dev = resolve_device(device)
    idxs_in_2, mask, _, _ = snn_match(torch.as_tensor(desc1, device=dev),
                                      torch.as_tensor(desc2, device=dev),
                                      snn_threshold)
    mask = mask.cpu().numpy()
    return np.arange(len(mask))[mask], idxs_in_2.cpu().numpy()[mask]
