"""Homography reprojection, ground-truth correspondences and the geometric
LAF losses.

Counterparts of every function of ``affnet_tpu/reproj.py``
(ReprojectionStuff.py in the reference): ``linH`` and ``reproject_lafs``;
the centre-distance matching ``gt_correspondence_mask`` and its host
wrapper ``get_gt_correspondence_indexes`` (numpy, the reference's return
convention); and the Frobenius half: ``px2grid_A``, ``grid2px_A`` and
``affine_aug`` (a random affine warp of a whole image), ``ratio_matrix``,
``inverse_lhfs``, ``frobenius_canonical_dist``, the Frobenius matchers
``gt_correspondence_fro_mask`` and ``gt_correspondence_fro_and_center_mask``
(fixed-size masked forms, tensors as JAX returns arrays), ``lhf_scale``,
``closest_correspondences`` (mutually nearest pairs), the losses
``laf_magic`` and ``laf_magic_fro``, and ``identity_loss``.

``affine_aug`` draws its 3x3 uniforms from a ``torch.Generator`` and hands
them to :func:`affine_aug_core`, which the tests feed JAX's draws.  Its
whole-image bilinear sample (zeros outside) is JAX's XLA four-corner
sampler, not a Pallas kernel: here it is the same four-corner arithmetic
in plain PyTorch, on any device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .laf import lafs_to_h_frames, rectify_up_is_up
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


# ---------------------------------------------------------------------------
# Random affine augmentation of a whole image
# ---------------------------------------------------------------------------

def px2grid_A(w: float, h: float) -> np.ndarray:
    """Pixels -> [-1, 1] grid coordinates, (3, 3) float32."""
    A = np.eye(3, dtype=np.float32)
    A[0, 0] = 2.0 / w
    A[1, 1] = 2.0 / h
    A[0, 2] = -1
    A[1, 2] = -1
    return A


def grid2px_A(w: float, h: float) -> np.ndarray:
    """[-1, 1] grid coordinates -> pixels, (3, 3) float32."""
    A = np.eye(3, dtype=np.float32)
    A[0, 0] = w / 2.0
    A[0, 2] = w / 2.0
    A[1, 1] = h / 2.0
    A[1, 2] = h / 2.0
    return A


def _bilinear_sample(img: Tensor, u: Tensor, v: Tensor) -> Tensor:
    """Bilinear samples of the (H, W) ``img`` at pixel positions (u, v),
    corners outside the image counting zero: JAX's four-corner sampler
    (``_bilinear_window_sample``) in its order."""
    h, w = img.shape
    flat = img.reshape(-1)
    x0 = torch.floor(u)
    y0 = torch.floor(v)
    fx, fy = u - x0, v - y0
    x0i, y0i = x0.long(), y0.long()

    def corner(xc, yc, wgt):
        inb = (xc >= 0) & (xc <= w - 1) & (yc >= 0) & (yc <= h - 1)
        idx = yc.clamp(0, h - 1) * w + xc.clamp(0, w - 1)
        return flat[idx] * wgt * inb.to(img.dtype)

    return (corner(x0i, y0i, (1 - fx) * (1 - fy))
            + corner(x0i + 1, y0i, fx * (1 - fy))
            + corner(x0i, y0i + 1, (1 - fx) * fy)
            + corner(x0i + 1, y0i + 1, fx * fy))


def affine_aug_core(img: Tensor, uniforms: Tensor, max_add: float = 0.5,
                    align_corners: bool = False) -> Tuple[Tensor, Tensor]:
    """The warp of :func:`affine_aug` for given (3, 3) uniforms in [0, 1):
    A = I + max_add * 2 (U - 0.5), its last row kept (0, 0, 1); the image
    sampled on affine_grid(A) (the grid of ``align_corners``), zeros
    outside; returns (new image, H mapping original -> new pixels)."""
    h, w = img.shape
    dev, dt = img.device, img.dtype
    rand_add = max_add * (uniforms.to(dev, dt) - 0.5) * 2.0
    rand_add = torch.cat([rand_add[:2], torch.zeros((1, 3), dtype=dt,
                                                    device=dev)])
    A = torch.eye(3, dtype=dt, device=dev) + rand_add
    H_orig2new = (torch.from_numpy(grid2px_A(w, h)).to(dev)
                  @ torch.linalg.inv(A)
                  @ torch.from_numpy(px2grid_A(w, h)).to(dev))
    if align_corners:
        lx = torch.linspace(-1.0, 1.0, w, dtype=dt, device=dev)
        ly = torch.linspace(-1.0, 1.0, h, dtype=dt, device=dev)
    else:
        lx = (2.0 * torch.arange(w, dtype=dt, device=dev) + 1.0) / w - 1.0
        ly = (2.0 * torch.arange(h, dtype=dt, device=dev) + 1.0) / h - 1.0
    gxx = lx[None, :].expand(h, w)
    gyy = ly[:, None].expand(h, w)
    xs = A[0, 0] * gxx + A[0, 1] * gyy + A[0, 2]
    ys = A[1, 0] * gxx + A[1, 1] * gyy + A[1, 2]
    if align_corners:
        u = (xs + 1.0) / 2.0 * (w - 1)
        v = (ys + 1.0) / 2.0 * (h - 1)
    else:
        u = ((xs + 1.0) * w - 1.0) / 2.0
        v = ((ys + 1.0) * h - 1.0) / 2.0
    return _bilinear_sample(img, u, v), H_orig2new


def affine_aug(img: Tensor, generator: torch.Generator,
               max_add: float = 0.5, align_corners: bool = False
               ) -> Tuple[Tensor, Tensor]:
    """Random affine warp of a whole (H, W) image and the homography
    mapping original -> new pixel coordinates (ReprojectionStuff.py:57-76):
    :func:`affine_aug_core` on 3x3 uniforms drawn from ``generator`` (on
    the generator's device)."""
    u = torch.rand((3, 3), generator=generator, device=generator.device,
                   dtype=img.dtype)
    return affine_aug_core(img, u, max_add, align_corners)


# ---------------------------------------------------------------------------
# Frobenius distances and matchers
# ---------------------------------------------------------------------------

def ratio_matrix(a: Tensor, p: Tensor, eps: float = 1e-12) -> Tensor:
    """out[i, j] = a[j] / (p[i] + eps), the reference's broadcast
    (ReprojectionStuff.py:88-90)."""
    return a[None, :] / (p[:, None] + eps)


def inverse_lhfs(lhfs: Tensor) -> Tensor:
    return torch.linalg.inv(lhfs)


def frobenius_canonical_dist(lhf1_inv: Tensor, lhf2: Tensor,
                             skip_center: bool = False) -> Tensor:
    """(N1, N2) ||LHF1^-1 @ LHF2 - I||_F^2 (ReprojectionStuff.py:102-124);
    ``skip_center``: the 2x2 block only."""
    prod = torch.einsum("aij,bjk->abik", lhf1_inv, lhf2)
    eye = torch.eye(3, dtype=lhf1_inv.dtype, device=lhf1_inv.device)
    diff2 = (prod - eye) ** 2
    if skip_center:
        return diff2[:, :, :2, :2].sum(dim=(2, 3))
    return diff2.sum(dim=(2, 3))


def lhf_scale(lhf: Tensor) -> Tensor:
    """sqrt|det| of the 2x2 block of each (N, >=2, >=2) frame."""
    return torch.sqrt(torch.abs(lhf[:, 0, 0] * lhf[:, 1, 1]
                                - lhf[:, 1, 0] * lhf[:, 0, 1]))


def gt_correspondence_fro_mask(lafs1: Tensor, lafs2: Tensor, H1to2: Tensor,
                               dist_threshold: float = 4.0,
                               skip_center_in_fro: bool = False
                               ) -> Tuple[Tensor, Tensor, Tensor]:
    """Frobenius-distance GT matching (ReprojectionStuff.py:139-150): for
    each LAF of view 1, the nearest LAF of view 2 reprojected into view 1.
    Returns (min_dist, idxs_in_2, mask), each of length N1."""
    lhf2_in_1 = reproject_lafs(lafs2, torch.linalg.inv(H1to2), True)
    fro = frobenius_canonical_dist(inverse_lhfs(lafs_to_h_frames(lafs1)),
                                   lhf2_in_1, skip_center_in_fro)
    min_dist = fro.amin(dim=1)
    return min_dist, fro.argmin(dim=1), min_dist <= dist_threshold


def gt_correspondence_fro_and_center_mask(
        lafs1: Tensor, lafs2: Tensor, H1to2: Tensor,
        dist_threshold: float = 4.0, center_dist_th: float = 2.0,
        scale_diff_coef: float = 0.3, skip_center_in_fro: bool = False,
        do_up_is_up: bool = False, inv_to_eye: bool = True):
    """Frobenius matching gated by centre distance and scale ratio
    (ReprojectionStuff.py:152-203): pairs whose centres lie
    ``center_dist_th`` or more apart, or whose scales differ by more than
    ``scale_diff_coef``, get 1000 added.  ``do_up_is_up`` rectifies both
    sides' shapes at their scale first; without ``inv_to_eye`` the
    distance is the L2 distance of the flattened frames.  Returns
    (min_dist, idxs_in_2, mask, LHF2_in_1)."""
    lhf2_pre = reproject_lafs(lafs2, torch.linalg.inv(H1to2), True)
    if do_up_is_up:
        A2 = lhf2_pre[:, :2, :2]
        sc2 = lhf_scale(A2)[:, None, None]
        lhf2_in_1 = torch.cat([
            torch.cat([rectify_up_is_up(A2 / sc2) * sc2,
                       lhf2_pre[:, :2, 2:]], 2), lhf2_pre[:, 2:]], 1)
        A1 = lafs1[:, :2, :2]
        sc1 = lhf_scale(A1)[:, None, None]
        lhf1 = lafs_to_h_frames(torch.cat(
            [rectify_up_is_up(A1 / sc1) * sc1, lafs1[:, :, 2:]], 2))
    else:
        lhf2_in_1 = lhf2_pre
        lhf1 = lafs_to_h_frames(lafs1)

    if inv_to_eye:
        fro = frobenius_canonical_dist(inverse_lhfs(lhf1), lhf2_in_1,
                                       skip_center_in_fro)
    elif not skip_center_in_fro:
        fro = distance_matrix(lhf1.reshape(lhf1.shape[0], -1),
                              lhf2_in_1.reshape(lhf2_in_1.shape[0], -1))
    else:
        fro = distance_matrix(
            lhf1[:, 0:2, 0:2].reshape(lhf1.shape[0], -1),
            lhf2_in_1[:, 0:2, 0:2].reshape(lhf2_in_1.shape[0], -1))

    if scale_diff_coef > 0:
        scale_matrix = ratio_matrix(lhf_scale(lhf2_in_1), lhf_scale(lafs1))
        scale_ok = torch.abs(1.0 - scale_matrix) <= scale_diff_coef
    else:
        scale_ok = torch.ones_like(fro, dtype=torch.bool)
    center_far = distance_matrix(lafs1[:, :, 2],
                                 lhf2_in_1[:, 0:2, 2]) >= center_dist_th
    masked = ((1.0 - scale_ok.to(fro.dtype) + center_far.to(fro.dtype))
              * 1000.0 + fro)
    min_dist = masked.amin(dim=1)
    return (min_dist, masked.argmin(dim=1), min_dist <= dist_threshold,
            lhf2_in_1)


# ---------------------------------------------------------------------------
# Differentiable geometric losses over mutually nearest LAF pairs
# ---------------------------------------------------------------------------

def closest_correspondences(lhf1: Tensor, lhf2_in_1: Tensor, xy_th: float,
                            scale_log: float) -> Tuple[Tensor, Tensor]:
    """Mutually nearest pairs under centre distance plus |log scale
    ratio|, 1000 added where both exceed their thresholds
    (ReprojectionStuff.py:204-225), masked: returns (mutual, nn_in_2),
    for each row of ``lhf1`` whether it and its nearest ``lhf2_in_1``
    row (``nn_in_2``) are each other's nearest, within 100."""
    center = distance_matrix(lhf1[:, 0:2, 2], lhf2_in_1[:, 0:2, 2])
    scale = torch.abs(torch.log(ratio_matrix(lhf_scale(lhf2_in_1),
                                             lhf_scale(lhf1))))
    mm = (1000.0 * ((scale > scale_log) & (center > xy_th)).to(center.dtype)
          + center + scale)
    d2_to_1 = mm.amin(dim=1)
    nn_in_2 = mm.argmin(dim=1)
    nn_in_1 = mm.argmin(dim=0)
    rows = torch.arange(mm.shape[0], device=mm.device)
    return (rows == nn_in_1[nn_in_2]) & (d2_to_1 <= 100.0), nn_in_2


def _nearest_pairs(lafs1: Tensor, lafs2: Tensor, H1to2: Tensor,
                   xy_th: float, scale_log: float):
    lhf2_in_1 = reproject_lafs(lafs2, torch.linalg.inv(H1to2), True)
    lhf1 = lafs_to_h_frames(lafs1)
    mutual, nn_in_2 = closest_correspondences(lhf1, lhf2_in_1, xy_th,
                                              scale_log)
    return lhf1, lhf2_in_1, mutual, nn_in_2


def laf_magic(lafs1: Tensor, lafs2: Tensor, H1to2: Tensor,
              xy_th: float = 5.0, scale_log: float = 0.4, t: float = 1.0,
              sc: float = 1.0, aff: float = 1.0):
    """LAFMagic (ReprojectionStuff.py:228-259), masked: per row of view 1
    and its nearest reprojected LAF of view 2, t * the centre distance
    over the mean scale (not differentiated) + sc * log1p of the scale
    difference over the mean scale + aff * the mean squared difference of
    the unit-scale shapes.  Returns (per-row loss, mutual mask,
    idxs_in_2, LHF2_in_1[:, 0:2, :])."""
    lhf1, lhf2_in_1, mutual, nn_in_2 = _nearest_pairs(lafs1, lafs2, H1to2,
                                                      xy_th, scale_log)
    lhf2 = lhf2_in_1[nn_in_2]
    s1, s2 = lhf_scale(lhf1), lhf_scale(lhf2)
    max_s, min_s = torch.maximum(s1, s2), torch.minimum(s1, s2)
    mean_s = 0.5 * (max_s + min_s)
    loss = 0.0
    if t != 0:
        loss = loss + t * (torch.sqrt(
            ((lhf1[:, 0:2, 2] - lhf2[:, 0:2, 2]) ** 2).sum(dim=1) + 1e-12)
            / mean_s.detach())
    if sc != 0:
        loss = loss + sc * torch.log1p((max_s - min_s) / mean_s)
    if aff != 0:
        A1 = lhf1[:, :2, :2] / s1[:, None, None]
        A2 = lhf2[:, :2, :2] / s2[:, None, None]
        loss = loss + aff * ((A1 - A2) ** 2).mean(dim=(1, 2))
    return loss, mutual, nn_in_2, lhf2_in_1[:, 0:2, :]


def laf_magic_fro(lafs1: Tensor, lafs2: Tensor, H1to2: Tensor,
                  xy_th: float = 5.0, scale_log: float = 0.4):
    """LAFMagicFro (ReprojectionStuff.py:260-278), masked: the mean over
    the 9 entries of |LHF1 - LHF2| (sqrt(d^2 + 1e-12)) over the mean
    scale (not differentiated).  Returns as :func:`laf_magic`."""
    lhf1, lhf2_in_1, mutual, nn_in_2 = _nearest_pairs(lafs1, lafs2, H1to2,
                                                      xy_th, scale_log)
    lhf2 = lhf2_in_1[nn_in_2]
    s1, s2 = lhf_scale(lhf1), lhf_scale(lhf2)
    mean_s = 0.5 * (torch.maximum(s1, s2) + torch.minimum(s1, s2))
    diff = lhf1.reshape(-1, 9) - lhf2.reshape(-1, 9)
    loss = (torch.sqrt(diff ** 2 + 1e-12) / mean_s.detach()[:, None]
            ).mean(dim=1)
    return loss, mutual, nn_in_2, lhf2_in_1[:, 0:2, :]


def identity_loss(A: Tensor) -> Tensor:
    """The mean over the batch of each [A|t]'s mean |[A|t] - [I|0]|
    (sqrt(d^2 + 1e-15)), clipped to [0, 100] (ReprojectionStuff.py:
    281-288)."""
    eye = torch.cat([torch.eye(2, dtype=A.dtype, device=A.device),
                     torch.zeros((2, 1), dtype=A.dtype, device=A.device)], 1)
    per = torch.sqrt((A - eye) ** 2 + 1e-15).reshape(A.shape[0], -1).mean(1)
    return torch.clamp(per, 0.0, 100.0).mean()
