"""Homography reprojection of LAFs and ground-truth correspondences.

Counterparts of ``linH``, ``reproject_lafs``, ``gt_correspondence_mask`` and
``get_gt_correspondence_indexes`` in ``affnet_tpu/reproj.py``, with the
reference's return convention.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .laf import lafs_to_h_frames
from .match import distance_matrix

Tensor = torch.Tensor


def linH(H: Tensor, x: Tensor, y: Tensor) -> Tensor:
    """The local linearization (Jacobian) of homography H at (x, y):
    (..., 2, 2)."""
    den = x * H[2, 0] + y * H[2, 1] + H[2, 2]
    num1_densq = (x * H[0, 0] + y * H[0, 1] + H[0, 2]) / (den * den)
    num2_densq = (x * H[1, 0] + y * H[1, 1] + H[1, 2]) / (den * den)
    a11 = H[0, 0] / den - num1_densq * H[2, 0]
    a12 = H[0, 1] / den - num1_densq * H[2, 1]
    a21 = H[1, 0] / den - num2_densq * H[2, 0]
    a22 = H[1, 1] / den - num2_densq * H[2, 1]
    return torch.stack([torch.stack([a11, a12], -1),
                        torch.stack([a21, a22], -1)], -2)


def reproject_lafs(lafs1: Tensor, H1to2: Tensor,
                   return_lhfs: bool = False) -> Tensor:
    """Map (N, 2, 3) LAFs into the other view under H: centers through H,
    shapes through its local linearization."""
    lhf1 = lafs_to_h_frames(lafs1)
    xy1 = H1to2[None] @ lhf1[:, :, 2:]
    xy1 = xy1 / xy1[:, 2:, :]
    As = linH(H1to2, lafs1[:, 0, 2], lafs1[:, 1, 2])
    out = torch.cat([As @ lhf1[:, 0:2, 0:2], xy1[:, :2, :]], dim=2)
    return lafs_to_h_frames(out) if return_lhfs else out


def gt_correspondence_mask(lafs1: Tensor, lafs2: Tensor, H1to2: Tensor,
                           dist_threshold: float = 4.0
                           ) -> Tuple[Tensor, Tensor, Tensor]:
    """Center-distance nearest-neighbor GT matching: for each LAF of view
    1, the nearest LAF of view 2 reprojected into view 1.  Returns
    (min_dist, idxs_in_2, mask), each of length N1."""
    lhf2_in_1 = reproject_lafs(lafs2, torch.linalg.inv(H1to2), True)
    dist = distance_matrix(lafs1[:, :, 2], lhf2_in_1[:, 0:2, 2])
    min_dist, idxs_in_2 = dist.min(dim=1)
    return min_dist, idxs_in_2, min_dist <= dist_threshold


def get_gt_correspondence_indexes(lafs1, lafs2, H1to2,
                                  dist_threshold: float = 4.0):
    """Host wrapper with the reference's return convention:
    (min_dist[mask], plain_idxs[mask], idxs_in_2[mask]) as numpy arrays,
    where ``plain_idxs`` enumerates the rows of view 1.  (The reference
    names them ``plain_indxs_in1`` and ``idxs_in_2``, and its own callers
    read them the other way round; the triples are the same.)"""
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    md, idx, mask = gt_correspondence_mask(as_t(lafs1), as_t(lafs2),
                                           as_t(H1to2), dist_threshold)
    md, idx, mask = md.numpy(), idx.numpy(), mask.numpy()
    plain = np.arange(len(idx))
    return md[mask], plain[mask], idx[mask]
