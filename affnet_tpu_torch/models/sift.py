"""Differentiable SIFT descriptor (weight-free), the descriptor of the
shape-optimization demo.

Counterpart of ``affnet_tpu/models/sift.py``: gradients -> 8 soft-assigned
angular bins -> 4x4 spatial pooling with a triangular kernel -> L2 / clip
0.2 / L2.  The pooling is a grouped ``F.conv2d``, a plain convolution that
the JAX package also leaves to its compiler.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .cnn import l2norm

Tensor = torch.Tensor


def get_pooling_kernel(kernel_size: int = 25) -> np.ndarray:
    """Triangular pooling kernel."""
    step = 1.0 / float(np.floor(kernel_size / 2.0))
    x_coef = np.arange(step / 2.0, 1.0, step)
    xc2 = np.hstack([x_coef, [1], x_coef[::-1]])
    kernel = np.outer(xc2.T, xc2)
    return np.maximum(0, kernel).astype(np.float32)


def get_bin_weight_kernel_size_and_stride(patch_size: int,
                                          num_spatial_bins: int):
    """(pooling kernel size, stride) of ``num_spatial_bins`` bins."""
    bin_weight_stride = int(round(2.0 * math.floor(patch_size / 2)
                                  / float(num_spatial_bins + 1)))
    bin_weight_kernel_size = int(2 * bin_weight_stride - 1)
    return bin_weight_kernel_size, bin_weight_stride


def _sift_gauss_kernel(kernlen: int, py2: bool = False) -> np.ndarray:
    """SIFT's circular-masked, unnormalized Gaussian window."""
    half = kernlen // 2 if py2 else kernlen / 2.0
    r2 = float(half * half)
    sigma2 = 0.9 * r2
    k = np.zeros((kernlen, kernlen), np.float32)
    for y in range(kernlen):
        for x in range(kernlen):
            disq = (y - half) ** 2 + (x - half) ** 2
            k[y, x] = math.exp(-disq / sigma2) if disq < r2 else 0.0
    return k


def _grad_x(p: Tensor, taps: Sequence[float] = (-1.0, 0.0, 1.0)) -> Tensor:
    """3-tap horizontal gradient with replicate padding (torch
    cross-correlation taps: out[i] = t0 x[i-1] + t1 x[i] + t2 x[i+1])."""
    xp = torch.cat([p[..., :, :1], p, p[..., :, -1:]], dim=-1)
    return (taps[0] * xp[..., :, :-2] + taps[1] * xp[..., :, 1:-1]
            + taps[2] * xp[..., :, 2:])


def _grad_y(p: Tensor, taps: Sequence[float] = (-1.0, 0.0, 1.0)) -> Tensor:
    yp = torch.cat([p[..., :1, :], p, p[..., -1:, :]], dim=-2)
    return (taps[0] * yp[..., :-2, :] + taps[1] * yp[..., 1:-1, :]
            + taps[2] * yp[..., 2:, :])


def sift_describe(patches: Tensor, patch_size: int = 65,
                  num_ang_bins: int = 8, num_spatial_bins: int = 4,
                  clipval: float = 0.2) -> Tensor:
    """(N, PS, PS) -> (N, num_ang_bins * num_spatial_bins^2) descriptors,
    differentiable in ``patches``."""
    dev, dt = patches.device, patches.dtype
    gk = torch.from_numpy(_sift_gauss_kernel(patch_size)).to(dev, dt)
    ksize, stride = get_bin_weight_kernel_size_and_stride(patch_size,
                                                          num_spatial_bins)
    pk = torch.from_numpy(get_pooling_kernel(ksize)).to(dev, dt)

    gx = _grad_x(patches)
    gy = _grad_y(patches)
    mag = torch.sqrt(gx * gx + gy * gy + 1e-10) * gk
    ori = torch.atan2(gy, gx + 1e-8)
    o_big = (ori + 2.0 * math.pi) / (2.0 * math.pi) * float(num_ang_bins)
    bo0 = torch.floor(o_big)
    wo1 = o_big - bo0
    bo0 = torch.remainder(bo0, num_ang_bins).long()
    bo1 = torch.remainder(bo0 + 1, num_ang_bins)
    wo0 = (1.0 - wo1) * mag
    wo1 = wo1 * mag

    def one_hot(b: Tensor) -> Tensor:          # (N, bins, H, W)
        return F.one_hot(b, num_ang_bins).permute(0, 3, 1, 2).to(dt)

    maps = one_hot(bo0) * wo0[:, None] + one_hot(bo1) * wo1[:, None]
    # Spatial pooling: the same triangular kernel per angular bin.
    weight = pk.expand(num_ang_bins, 1, ksize, ksize)
    pooled = F.conv2d(maps, weight, stride=stride, groups=num_ang_bins)
    flat = l2norm(pooled.reshape(pooled.shape[0], -1))
    flat = torch.clamp(flat, 0.0, clipval)
    return l2norm(flat)
