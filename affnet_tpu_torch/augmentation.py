"""Train-time augmentation: random rotations, tilts and shifts, the warps
that apply them and the predicted shapes, and the descriptor trainer's
pair-shared transpose and flip (:func:`fliprot`).

Counterpart of ``affnet_tpu/augmentation.py``.  The base LAF
[[0.5, 0, 0.5], [0, 0.5, 0.5]] covers the central half of a patch in
normalized coordinates.  Random draws come from an explicit
``torch.Generator`` (they cannot reproduce ``jax.random``'s streams);
every warp goes through kernel B5 (:func:`.ops.batched_sampler.sample_batched`).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

from .laf import get_normalized_affine_shape, rotation_matrix
from .ops.batched_sampler import sample_batched

Tensor = torch.Tensor


def _base_lafs(n: int, dtype=torch.float32, device=None) -> Tensor:
    base = torch.tensor([[0.5, 0.0, 0.5], [0.0, 0.5, 0.5]], dtype=dtype,
                        device=device)
    return base.expand(n, 2, 3)


def _uniform(n: int, generator: torch.Generator) -> Tensor:
    return torch.rand(n, generator=generator, device=generator.device)


def get_random_rotation_lafs(n: int, angle_mag: float,
                             generator: torch.Generator
                             ) -> Tuple[Tensor, Tensor]:
    """Random-rotation LAFs (rotation in U[-angle_mag, angle_mag]) and the
    inverse rotation matrices."""
    phi = 2.0 * _uniform(n, generator) - 1.0
    rot = rotation_matrix(angle_mag * phi)
    inv_rot = rotation_matrix(-angle_mag * phi)
    lafs = _base_lafs(n, device=phi.device)
    return torch.cat([rot @ lafs[:, :, 0:2], lafs[:, :, 2:]], dim=2), inv_rot


def get_random_shifts(n: int, w_mag: int, generator: torch.Generator
                      ) -> Tuple[Tensor, Tensor]:
    """Center shifts: integers in [0, 2*w_mag) minus w_mag // 2, halved."""
    dev = generator.device
    shift_w = (torch.randint(0, 2 * w_mag, (n,), generator=generator,
                             device=dev) - w_mag // 2).float() / 2.0
    shift_h = (torch.randint(0, 2 * w_mag, (n,), generator=generator,
                             device=dev) - w_mag // 2).float() / 2.0
    return shift_w, shift_h


def get_random_norm_affine_lafs(n: int, max_tilt: float,
                                generator: torch.Generator) -> Tensor:
    """Random det-1 tilt in U[1/t, t] and rotation in U[-pi, pi] through
    :func:`get_normalized_affine_shape`."""
    tilt = 1.0 / max_tilt + (max_tilt - 1.0 / max_tilt) * \
        _uniform(n, generator)
    phi = math.pi * (2.0 * _uniform(n, generator) - 1.0)
    TA = get_normalized_affine_shape(tilt, phi)
    lafs = _base_lafs(n, device=tilt.device)
    return torch.cat([TA @ lafs[:, :, 0:2], lafs[:, :, 2:]], dim=2)


def random_warp_lafs(n: int, max_rot: Union[float, Tensor], max_tilt: float,
                     generator: torch.Generator
                     ) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    """The random draw of :func:`extract_random_laf`: (warp LAFs, rotation
    LAFs, inverse rotations).  ``max_rot`` is a rotation magnitude, or
    rotation LAFs to share (then the inverse rotations are None)."""
    if isinstance(max_rot, float):
        rot_lafs, inv_rotmat = get_random_rotation_lafs(n, max_rot, generator)
    else:
        rot_lafs, inv_rotmat = max_rot, None
    aff_lafs = get_random_norm_affine_lafs(n, max_tilt, generator)
    A = rot_lafs[:, 0:2, 0:2] @ aff_lafs[:, 0:2, 0:2]
    return torch.cat([A, aff_lafs[:, :, 2:]], dim=2), rot_lafs, inv_rotmat


def warp_and_crop(data: Tensor, lafs: Tensor, crop_size: int = 32,
                  align_corners: bool = False,
                  use_kernel: bool = True) -> Tuple[Tensor, Tensor]:
    """The deterministic part of :func:`extract_random_laf`: warp (N, H, W)
    patches by ``lafs`` at PS = H, then center-crop.  Returns (cropped,
    warped_full)."""
    h = data.shape[1]
    st = (h - crop_size) // 2
    warped = sample_batched(data, lafs, ps=h, align_corners=align_corners,
                            use_kernel=use_kernel)
    return warped[:, st:st + crop_size, st:st + crop_size], warped


def extract_random_laf(data: Tensor, max_rot: Union[float, Tensor],
                       max_tilt: float = 1.0, crop_size: int = 32,
                       align_corners: bool = False, *,
                       generator: torch.Generator):
    """Random rotation x tilt warp of (N, H, W) patches, center-cropped.
    ``max_rot``: a rotation magnitude, or rotation LAFs shared between anchor
    and positive ('Rot'-free archs).  Returns (cropped, warped_full,
    rot_lafs, inv_rotmat)."""
    lafs, rot_lafs, inv_rotmat = random_warp_lafs(data.shape[0], max_rot,
                                                  max_tilt, generator)
    crop, warped = warp_and_crop(data, lafs, crop_size, align_corners)
    return crop, warped, rot_lafs, inv_rotmat


def warp_by_predicted_transform(patches: Tensor, trans: Tensor,
                                crop_size: int = 32,
                                align_corners: bool = False,
                                use_kernel: bool = True) -> Tensor:
    """Re-warp full patches by a predicted (N, 2, 2) transform and
    center-crop.  With the align_corners=False grid and an even margin, the
    center crop of the PS = H warp equals sampling at PS = crop_size with
    the linear part scaled by crop_size / H (the cropped grid rows are the
    half-scale grid), so that branch samples 4x fewer points."""
    n, h, _ = patches.shape
    base = _base_lafs(n, patches.dtype, patches.device)
    if not align_corners and (h - crop_size) % 2 == 0:
        scale = crop_size / h
        lafs = torch.cat([scale * (trans @ base[:, 0:2, 0:2]),
                          base[:, 0:2, 2:]], dim=2)
        return sample_batched(patches, lafs, ps=crop_size,
                              align_corners=False, use_kernel=use_kernel)
    st = (h - crop_size) // 2
    lafs = torch.cat([trans @ base[:, 0:2, 0:2], base[:, 0:2, 2:]], dim=2)
    out = sample_batched(patches, lafs, ps=h, align_corners=align_corners,
                         use_kernel=use_kernel)
    return out[:, st:st + crop_size, st:st + crop_size]


def draw_fliprot(generator: torch.Generator) -> Tuple[Tensor, Tensor]:
    """The random draw of :func:`fliprot`: (do_rot, do_flip), 0-d bool
    tensors on the generator's device, each true with probability 1/2 (no
    host sync)."""
    u = _uniform(2, generator)
    return u[0] < 0.5, u[1] < 0.5


def fliprot_core(img_a: Tensor, img_p: Tensor, do_rot, do_flip
                 ) -> Tuple[Tensor, Tensor]:
    """One transpose (``do_rot``), then one horizontal flip (``do_flip``),
    shared by every pair of the square (N, H, H) batches; the flags are
    bools or 0-d bool tensors."""
    rot = torch.as_tensor(do_rot, device=img_a.device)
    flip = torch.as_tensor(do_flip, device=img_a.device)
    out = []
    for x in (img_a, img_p):
        x = torch.where(rot, x.transpose(1, 2), x)
        out.append(torch.where(flip, x.flip(2), x))
    return out[0], out[1]


def fliprot(img_a: Tensor, img_p: Tensor, generator: torch.Generator
            ) -> Tuple[Tensor, Tensor]:
    """A random transpose and horizontal flip of a pair batch, drawn once
    for the whole batch (the reference draws them per sample)."""
    return fliprot_core(img_a, img_p, *draw_fliprot(generator))
