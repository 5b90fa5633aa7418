"""External keypoints -> AffNet shapes, OriNet orientations, descriptors.

Counterpart of ``affnet_tpu/keypoints.py``: the reference's modern usage
(the kornia notebook, examples/SIFT-AffNet-HardNet-kornia-matching.ipynb
cells 0-10).  Detect keypoints with any detector (OpenCV DoG/SIFT, your
own), then

  1. build base LAFs from (x, y, size[, angle])   (:func:`lafs_from_keypoints`)
  2. AffNet on upright patches -> det-1 upright shape A
  3. OriNet on shape-corrected patches -> orientation
  4. a descriptor on the final measurement patches (PS 32).

The compositions are the extractor's (detector.py): the shape multiplies
the base A on the LEFT, the orientation's rotation on the RIGHT
(SparseImgRepresenter.py:175-177), so the shipped weights behave on
external keypoints as inside the pipeline.

Every patch fetch is kernel B4 (``ops/cuda_patches.py``, the plain sampler
for CPU tensors) over the image itself as a one-level buffer
(``ops/patches.py`` ``batched_tables(1, h, w)``): no pyramid is built and
the image is not copied.  External keypoints have unbounded extents (some
3 x size px at ``mr_size`` 6), so many samples fall outside the image;
B4's corners outside the level contribute zero.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from . import resolve_device
from .laf import denormalize_lafs, rotation_matrix
from .ops.cuda_patches import extract_patches_pyramid
from .ops.patches import batched_tables
from .utils import float32_math

Tensor = torch.Tensor

DESC_PS = 32


def lafs_from_keypoints(x, y, scale, angle=None, img_hw=None,
                        mr_size: float = 6.0) -> Tensor:
    """(x, y) pixel centres, ``scale`` = keypoint size (diameter, OpenCV's
    ``KeyPoint.size``), optional ``angle`` in degrees (OpenCV's convention,
    clockwise-positive; kornia negates it, cell 2) -> normalized (N, 2, 3)
    float32 LAFs with measurement radius ``mr_size * size / 2`` pixels
    (kornia ``laf_from_center_scale_ori`` with the notebook's mrSize 6):
    A = r R(-angle) with r = radius / min(h, w), centre (x / w, y / h).
    Arrays or tensors; the LAFs lie where ``x`` does (numpy: the CPU)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    dev = x.device
    y = torch.as_tensor(y, dtype=torch.float32, device=dev)
    s = torch.as_tensor(scale, dtype=torch.float32, device=dev)
    h, w = img_hw
    r = (mr_size * s / 2.0) / float(min(h, w))
    if angle is None:
        A = r[:, None, None] * torch.eye(2, device=dev).expand(
            x.shape[0], 2, 2)
    else:
        th = -torch.deg2rad(torch.as_tensor(angle, dtype=torch.float32,
                                            device=dev))
        A = r[:, None, None] * rotation_matrix(th)
    t = torch.stack([x / float(w), y / float(h)], dim=-1)[..., None]
    return torch.cat([A, t], dim=2)


def _extract(img: Tensor, lafs: Tensor, ps: int,
             use_kernels: bool) -> Tensor:
    """Patches of the (H, W) image as a one-level buffer (B4, or the plain
    sampler for CPU tensors or ``use_kernels=False``)."""
    h, w = img.shape
    _, offs, hs, ws = batched_tables(1, h, w, img.device)
    lvl = torch.zeros(lafs.shape[0], dtype=torch.int32, device=img.device)
    patches, _ = extract_patches_pyramid(img, lafs, lvl, offs, hs, ws,
                                         ps=ps, use_kernel=use_kernels)
    return patches


@float32_math()
def process_keypoints(img: Tensor, lafs: Tensor,
                      shape_net: Optional[nn.Module] = None,
                      ori_net: Optional[nn.Module] = None,
                      desc_net: Optional[nn.Module] = None,
                      use_kernels: bool = True) -> Dict[str, Tensor]:
    """Shape, orientation and description of normalized base LAFs over one
    contiguous (H, W) float32 image, on the image's device; any net may be
    None to skip its stage (the notebook's DoG-OriNet-HardNet and
    DoG-AffNet-OriNet-HardNet variants).  The nets lie on that device.
    Returns ``lafs`` (normalized) and, per stage run, ``shape`` (det-1
    upright 2x2), ``angle`` (degrees), ``patches`` and ``descs``.  One B4
    launch per stage.

    JAX's version also returns ``n_overflow``, the window misses of its
    window-matmul sampler; B4 is a direct gather with no window, so nothing
    can overflow and the port returns no such count (and warns of none)."""
    out = {}
    cur = lafs
    if shape_net is not None:
        A = shape_net(_extract(img, cur, shape_net.ps, use_kernels),
                      use_kernels=use_kernels)
        # det-1 upright shape (AffNet's head already rectifies it upright).
        det = torch.abs(A[:, 0, 0] * A[:, 1, 1] - A[:, 0, 1] * A[:, 1, 0])
        A = A / torch.sqrt(det + 1e-10)[:, None, None]
        out["shape"] = A
        cur = torch.cat([A @ cur[:, :, :2], cur[:, :, 2:]], dim=2)
    if ori_net is not None:
        rot = ori_net(_extract(img, cur, ori_net.ps, use_kernels),
                      use_kernels=use_kernels)
        out["angle"] = torch.rad2deg(torch.atan2(rot[:, 1, 0], rot[:, 0, 0]))
        cur = torch.cat([cur[:, :, :2] @ rot, cur[:, :, 2:]], dim=2)
    out["lafs"] = cur
    if desc_net is not None:
        out["patches"] = _extract(img, cur, DESC_PS, use_kernels)
        out["descs"] = desc_net(out["patches"], use_kernels=use_kernels)
    return out


@torch.inference_mode()
def describe_keypoints(img, x, y, scale, angle=None, mr_size: float = 6.0,
                       shape_net: Optional[nn.Module] = None,
                       ori_net: Optional[nn.Module] = None,
                       desc_net: Optional[nn.Module] = None,
                       device="cuda", use_kernels: bool = True
                       ) -> Dict[str, np.ndarray]:
    """Host API: an (H, W) grayscale image and keypoint arrays -> numpy
    ``lafs`` in pixels (``laf.denormalize_lafs``) and, per net given,
    ``shape`` (det-1 upright 2x2), ``angle`` (degrees), ``patches`` and
    ``descs``.  Runs on ``device`` (the nets are moved there) with TF32
    off; ``use_kernels=False`` samples through the plain version."""
    dev = resolve_device(device)
    img = torch.as_tensor(np.asarray(img, np.float32)).to(dev).contiguous()
    h, w = img.shape
    lafs = lafs_from_keypoints(x, y, scale, angle, (h, w), mr_size).to(dev)
    nets = [None if n is None else n.to(dev).eval()
            for n in (shape_net, ori_net, desc_net)]
    out = process_keypoints(img, lafs, *nets, use_kernels=use_kernels)
    out["lafs"] = denormalize_lafs(out["lafs"], w, h)
    return {k: v.cpu().numpy() for k, v in out.items()}
