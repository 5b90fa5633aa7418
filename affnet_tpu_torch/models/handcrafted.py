"""Handcrafted (weight-free) shape and orientation estimators.

Counterpart of ``affnet_tpu/models/handcrafted.py``: the Baumberg step
(:class:`AffineShapeEstimator`, the gradient second-moment matrix under a
Gaussian window, its unit-determinant inverse square root rectified
up-is-up) and the dominant gradient orientation over 36 angular bins
(:class:`OrientationDetector`).  The extractor runs them where it is given
no shape or orientation net, as the JAX extractor does.

Both are ``nn.Module``s on (N, PS, PS) patches with ``.ps`` and
``forward(patches, use_kernels=...)``, so the extractor calls them as it
calls a ``PatchNet``.  In JAX they are XLA programs, not Pallas kernels:
plain PyTorch is their port, on any device, and ``use_kernels`` changes
nothing.  They compute in float32 whatever the extractor's ``fast`` mode.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..laf import abc2A, invsqrt2x2_sym, rectify_up_is_up, rotation_matrix
from .sift import _grad_x, _grad_y

Tensor = torch.Tensor

NUM_ANG_BINS = 36


def circular_gauss_kernel(kernlen: Optional[int] = None,
                          circ_zeros: bool = False,
                          sigma: Optional[float] = None, norm: bool = True,
                          py2: bool = False) -> np.ndarray:
    """2-D Gaussian window, float32 numpy.  ``py2`` takes the original
    python-2 integer half size; the default is a python-3 run's (float)."""
    if kernlen is None and sigma is None:
        raise ValueError("circular_gauss_kernel needs kernlen or sigma")
    if kernlen is None:
        kernlen = int(2.0 * 3.0 * sigma + 1.0)
        if kernlen % 2 == 0:
            kernlen += 1
    half = kernlen // 2 if py2 else kernlen / 2.0
    r2 = float(half * half)
    sigma2 = 0.9 * r2 if sigma is None else 2.0 * sigma * sigma
    x = np.linspace(-half, half, kernlen)
    xv, yv = np.meshgrid(x, x, indexing="xy")
    distsq = xv ** 2 + yv ** 2
    kernel = np.exp(-(distsq / sigma2))
    if circ_zeros:
        kernel *= (distsq <= r2).astype(np.float32)
    if norm:
        kernel /= np.sum(kernel)
    return kernel.astype(np.float32)


def _window(patches: Tensor, kernel: np.ndarray) -> Tensor:
    return torch.from_numpy(kernel).to(patches.device, patches.dtype)


def affine_shape_estimator(patches: Tensor, patch_size: int = 19) -> Tensor:
    """One Baumberg step: (N, PS, PS) patches -> (N, 2, 2) unit-determinant
    upright shapes."""
    gk = _window(patches, circular_gauss_kernel(
        kernlen=patch_size, sigma=(patch_size / 2) / 3.0))
    gx = _grad_x(patches, (-1.0, 0.0, 1.0))
    gy = _grad_y(patches, (-1.0, 0.0, 1.0))
    a1 = torch.mean(gx * gx * gk, dim=(-1, -2))
    b1 = torch.mean(gx * gy * gk, dim=(-1, -2))
    c1 = torch.mean(gy * gy * gk, dim=(-1, -2))
    a, b, c, _, _ = invsqrt2x2_sym(a1, b1, c1)
    return rectify_up_is_up(abc2A(a, b, c))


def orientation_detector(patches: Tensor, patch_size: int = 19) -> Tensor:
    """Dominant orientation per patch (radians): gradient magnitudes under a
    10x Gaussian window binned by angle into 36 bins, smoothed with [0.33,
    0.34, 0.33] (zero padding), the first largest bin.  As in the reference
    and the JAX package, only the lower bin's weight ``wo0`` is added: the
    upper bin gets nothing.  The bins are a ``scatter_add`` (the JAX
    package's one-hot would be (N, PS, PS, 36)); on the card its float
    sums come in atomic order, so a near-tie of two bins can fall either
    way from run to run."""
    n = patches.shape[0]
    gk = 10.0 * _window(patches, circular_gauss_kernel(kernlen=patch_size))
    gx = _grad_x(patches, (0.5, 0.0, -0.5))
    gy = _grad_y(patches, (0.5, 0.0, -0.5))
    mag = torch.sqrt(gx * gx + gy * gy + 1e-10) * gk
    ori = torch.atan2(gy, gx)
    o_big = NUM_ANG_BINS * (ori + math.pi) / (2.0 * math.pi)
    bo0 = torch.floor(o_big)
    wo1 = o_big - bo0
    bo0 = torch.remainder(bo0, NUM_ANG_BINS).long()
    wo0 = (1.0 - wo1) * mag
    bins = torch.zeros((n, NUM_ANG_BINS), dtype=patches.dtype,
                       device=patches.device)
    bins.scatter_add_(1, bo0.reshape(n, -1), wo0.reshape(n, -1))
    bins = bins / float(patch_size * patch_size)
    zero = torch.zeros_like(bins[:, :1])
    left = torch.cat([zero, bins[:, :-1]], dim=1)
    right = torch.cat([bins[:, 1:], zero], dim=1)
    smoothed = 0.33 * left + 0.34 * bins + 0.33 * right
    idx = torch.argmax(smoothed, dim=1).to(patches.dtype)
    return -((2.0 * math.pi * idx / NUM_ANG_BINS) - math.pi)


class AffineShapeEstimator(nn.Module):
    """The Baumberg step as a patch net: (N, PS, PS) -> (N, 2, 2)."""

    def __init__(self, patch_size: int = 19):
        super().__init__()
        self.ps = patch_size

    def forward(self, patches: Tensor, use_kernels: bool = True) -> Tensor:
        return affine_shape_estimator(patches, self.ps)


class OrientationDetector(nn.Module):
    """The dominant gradient orientation as a patch net: (N, PS, PS) ->
    the (N, 2, 2) rotation matrix; :meth:`angle` gives the angle."""

    def __init__(self, patch_size: int = 19):
        super().__init__()
        self.ps = patch_size

    def angle(self, patches: Tensor, use_kernels: bool = True) -> Tensor:
        return orientation_detector(patches, self.ps)

    def forward(self, patches: Tensor, use_kernels: bool = True) -> Tensor:
        return rotation_matrix(orientation_detector(patches, self.ps))
