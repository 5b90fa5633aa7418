"""3x3x3 scale-space NMS, soft-argmax refinement, the octave dedup map and
the exact global top-k.

Counterpart of ``affnet_tpu/ops/nms.py``; the semantics are the reference's:

  - a center-level pixel survives iff cur + 1e-5 > max over the 3x3x3 cube
    of (low, cur, high) (out-of-image neighbours do not count)
  - responses in a border of width int(mrSize) are zeroed
  - the octave dedup map: a level with <= 1 survivor is dropped and does not
    update the map; the map update truncates float -> byte, so only
    responses >= 1.0 claim a pixel
  - soft-argmax over the zero-padded 3x3x3 cube with the reference's biased
    [-0.5, 0.5, 1.5] spatial grid, normalized by (min(h, w), h, w)
  - the global top-k keeps (value desc, index asc) order, ties included.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .cuda_topk import row_topm_flat

Tensor = torch.Tensor

NMS_EPS = 1e-5


def _maxpool3x3(x: Tensor) -> Tensor:
    """3x3 stride-1 max pool with -inf padding, as shifted-slice maxes."""
    h, w = x.shape
    xp = F.pad(x[None, None], (1, 1, 1, 1), value=float("-inf"))[0, 0]
    out = None
    for i in range(3):
        r = xp[i:i + h]
        rm = torch.maximum(torch.maximum(r[:, 0:w], r[:, 1:w + 1]),
                           r[:, 2:w + 2])
        out = rm if out is None else torch.maximum(out, rm)
    return out


def nms2d(x: Tensor, threshold: float = 0.0) -> Tensor:
    """2-D max-pool-equality NMS on (H, W): x where it is (within 1e-5 of)
    the max of its 3x3 neighbourhood and, for a ``threshold`` above 1e-5,
    above it; else 0 (the reference's NMS2d)."""
    keep = (x - _maxpool3x3(x) + NMS_EPS) > 0
    if threshold > NMS_EPS:
        keep = keep & (x > threshold)
    return keep.to(x.dtype) * x


def nms3d_center(low: Tensor, cur: Tensor, high: Tensor) -> Tensor:
    """cur where it is (within 1e-5 of) the max of its 27-neighbourhood
    across the three scale slices, else 0."""
    m = torch.maximum(torch.maximum(low, cur), high)
    mp = _maxpool3x3(m)
    keep = (cur - mp + NMS_EPS) > 0
    return keep.to(cur.dtype) * cur


def border_mask(h: int, w: int, b: int, device=None,
                dtype=torch.float32) -> Tensor:
    """1 inside, 0 in a b-wide frame; all zeros when the frame swallows the
    map."""
    if b >= h or b >= w:
        return torch.zeros((h, w), dtype=dtype, device=device)
    row = torch.arange(h, device=device)[:, None]
    col = torch.arange(w, device=device)[None, :]
    inside = (row >= b) & (row < h - b) & (col >= b) & (col < w - b)
    return inside.to(dtype)


def softargmax_scale_y_x(low: Tensor, cur: Tensor, high: Tensor,
                         sigmas3: Sequence[float]
                         ) -> Tuple[Tensor, Tensor, Tensor]:
    """Per-pixel soft-argmax (scale, y, x) maps over the zero-padded 3x3x3
    response cube, normalized by (min(h, w), h, w).  The spatial offsets are
    [-0.5, 0.5, 1.5], the reference's +0.5 px biased grid."""
    h, w = cur.shape

    def shifts2d(m):
        mp = F.pad(m[None, None], (1, 1, 1, 1))[0, 0]
        s = torch.zeros_like(m)
        sy = torch.zeros_like(m)
        sx = torch.zeros_like(m)
        for di in range(3):
            r = mp[di:di + h]
            c0, c1, c2 = r[:, 0:w], r[:, 1:w + 1], r[:, 2:w + 2]
            rsum = c0 + c1 + c2
            s = s + rsum
            sy = sy + (di - 0.5) * rsum
            sx = sx + (-0.5 * c0 + 0.5 * c1 + 1.5 * c2)
        return s, sy, sx

    num_z = torch.zeros_like(cur)
    num_y = torch.zeros_like(cur)
    num_x = torch.zeros_like(cur)
    den = torch.zeros_like(cur)
    for lvl, m in enumerate((low, cur, high)):
        s, sy, sx = shifts2d(m)
        den = den + s
        num_z = num_z + float(sigmas3[lvl]) * s
        num_y = num_y + sy
        num_x = num_x + sx
    den = den + 1e-8
    sc = num_z / den
    row = torch.arange(h, device=cur.device, dtype=cur.dtype)[:, None]
    col = torch.arange(w, device=cur.device, dtype=cur.dtype)[None, :]
    y = num_y / den + row
    x = num_x / den + col
    # Normalized by multiplying with float32 reciprocals: PyTorch's CUDA
    # division by a scalar does exactly this, its CPU division does not;
    # spelled out, the CPU, the GPU and kernel B2 round alike.
    inv = [float(np.float32(1.0) / np.float32(v)) for v in (min(h, w), h, w)]
    return sc * inv[0], y * inv[1], x * inv[2]


def update_octave_map(octave_map: Tensor, nmsed: Tensor
                      ) -> Tuple[Tensor, Tensor]:
    """Apply the octave dedup map to a fresh NMS response; returns
    (masked_response, new_map).  Stays on the device (no host sync)."""
    masked = nmsed * (1.0 - octave_map)
    keep = ((masked > 0).sum() > 1).to(nmsed.dtype)
    masked = masked * keep
    new_map = (torch.floor(octave_map + masked) > 0).to(nmsed.dtype)
    return masked, new_map


# Row width and per-row candidate count of the two-stage top-k (as in the
# JAX package): the fallback to the full sort happens only when more than
# M_CAND members of the global top-k share one 1024-wide row.
ROW_S = 1024
M_CAND = 16


def sorted_topk(values: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """Exact top-k by a full stable sort: (value desc, index asc)."""
    v, i = torch.sort(values, descending=True, stable=True)
    return v[:k], i[:k]


def two_stage_topk(values: Tensor, k: int,
                   use_kernel: bool = True) -> Tuple[Tensor, Tensor]:
    """Exact top-k of a large flat vector: per-row top-M_CAND candidates
    (kernel B3, reading the vector as rows of ROW_S with -1 past its end,
    so no padded copy is made), a stable sort of the candidates in (row,
    extraction) order, and an exactness check that falls back to the full
    sort when a row's leftover could reach the k-th value.  Equal to
    :func:`sorted_topk` on every positive entry.  The check reads one bool
    on the host (the JAX package branches on the device with lax.cond)."""
    n = values.numel()
    rv, rc, leftover = row_topm_flat(values, M_CAND, use_kernel=use_kernel)
    b = rv.shape[0]
    row0 = torch.arange(b, device=values.device)[:, None] * ROW_S
    flat_idx = torch.clamp(row0 + rc.long(), max=n - 1)
    top_v, pos = sorted_topk(rv.reshape(-1), k)
    top_i = flat_idx.reshape(-1)[pos]
    kth = top_v[k - 1]
    ok = bool(torch.all((leftover < kth) | (leftover <= 0.0)))
    if ok:
        return top_v, top_i
    return sorted_topk(values, k)


def masked_topk(values: Tensor, k: int, use_kernel: bool = True
                ) -> Tuple[Tensor, Tensor, Tensor]:
    """Global top-k with validity mask ``vals > 0``.  Inputs above 2^18
    entries take the two-stage path when its candidates can hold k."""
    n_cand = (-(-values.numel() // ROW_S)) * M_CAND
    if values.numel() > (1 << 18) and 1 <= k <= n_cand:
        vals, idxs = two_stage_topk(values, k, use_kernel=use_kernel)
    else:
        vals, idxs = sorted_topk(values, k)
    return vals, idxs, vals > 0
