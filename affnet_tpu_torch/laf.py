"""Local Affine Frame (LAF) algebra — the pieces the extraction and training
paths use.

A LAF is a ``(..., 2, 3)`` tensor ``[A | t]``; inside the pipeline LAFs live
in normalized image coordinates (``A`` divided by ``min(h, w)``, ``t`` by
``(w, h)``).  Counterparts of the same-named functions in
``affnet_tpu/laf.py``.
"""

from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor


def eig2x2_vals(A: Tensor) -> Tuple[Tensor, Tensor]:
    """Closed-form eigenvalues of (..., 2, 2); complex pairs map to the
    sentinel (1000, 1e-4) so their ratio fails any sanity gate."""
    trace = A[..., 0, 0] + A[..., 1, 1]
    det = A[..., 0, 0] * A[..., 1, 1] - A[..., 1, 0] * A[..., 0, 1]
    delta1 = trace * trace - 4.0 * det
    mask = (delta1 > 0).to(A.dtype)
    delta = torch.sqrt(torch.abs(delta1))
    l1 = mask * (trace + delta) / 2.0 + 1000.0 * (1.0 - mask)
    l2 = mask * (trace - delta) / 2.0 + 0.0001 * (1.0 - mask)
    return l1, l2


def rectify_up_is_up(A: Tensor) -> Tensor:
    """Canonicalize (..., 2, 2) so 'up stays up': zero a12, keep |det|.
    The 1e-10 under the root and the order of the divisions are the JAX
    package's, so autograd differentiates the same expression (AffNet's
    head during training)."""
    det = torch.sqrt(torch.abs(A[..., 0, 0] * A[..., 1, 1]
                               - A[..., 1, 0] * A[..., 0, 1] + 1e-10))
    b2a2 = torch.sqrt(A[..., 0, 1] * A[..., 0, 1]
                      + A[..., 0, 0] * A[..., 0, 0])
    a11 = b2a2 / det
    a12 = torch.zeros_like(det)
    a21 = (A[..., 1, 1] * A[..., 0, 1]
           + A[..., 1, 0] * A[..., 0, 0]) / (b2a2 * det)
    a22 = det / b2a2
    return torch.stack([torch.stack([a11, a12], -1),
                        torch.stack([a21, a22], -1)], -2)


def rotation_matrix(angle: Tensor) -> Tensor:
    """Batched 2x2 rotation [[cos, sin], [-sin, cos]]."""
    c, s = torch.cos(angle), torch.sin(angle)
    return torch.stack([torch.stack([c, s], -1),
                        torch.stack([-s, c], -1)], -2)


def get_normalized_affine_shape(tilt: Tensor, angle: Tensor) -> Tensor:
    """det-1 tilt R(phi) @ diag(t, 1) @ R(phi), rectified up-is-up (the
    train-time shape augmentation)."""
    one = torch.ones_like(tilt)
    zero = torch.zeros_like(tilt)
    tilt_A = torch.stack([torch.stack([tilt, zero], -1),
                          torch.stack([zero, one], -1)], -2)
    rot = rotation_matrix(angle)
    return rectify_up_is_up(rot @ tilt_A @ rot)


def check_touch_boundary(lafs: Tensor) -> Tensor:
    """True for LAFs whose +-1 unit-square corners stay inside the
    normalized image [0, 1]^2."""
    pts = torch.tensor([[-1.0, -1.0, 1.0, 1.0],
                        [-1.0, 1.0, -1.0, 1.0],
                        [1.0, 1.0, 1.0, 1.0]],
                       dtype=lafs.dtype, device=lafs.device)
    out = lafs @ pts                                   # (..., 2, 4)
    bad = ((out > 1.0) | (out < 0.0)).sum(dim=(-1, -2)) > 0
    return ~bad


def _norm_coef(w: int, h: int, like: Tensor) -> Tensor:
    m = float(min(h, w))
    return torch.tensor([[m, m, float(w)], [m, m, float(h)]],
                        dtype=like.dtype, device=like.device)


def denormalize_lafs(lafs: Tensor, w: int, h: int) -> Tensor:
    """Normalized image coordinates -> pixels."""
    return lafs * _norm_coef(w, h, lafs)


def sc_y_x_to_lafs(sc_y_x: Tensor) -> Tensor:
    """(scale, y, x) -> LAF = [scale * I | (x, y)]."""
    s = sc_y_x[..., 0]
    zero = torch.zeros_like(s)
    return torch.stack([torch.stack([s, zero, sc_y_x[..., 2]], -1),
                        torch.stack([zero, s, sc_y_x[..., 1]], -1)], -2)
