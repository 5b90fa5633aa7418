"""Affine patch extraction from the row-padded pyramid buffer, descriptor
level selection and sample extents.

Counterpart of ``affnet_tpu/ops/patches.py`` (the XLA gather path) with
torch ``affine_grid`` + ``grid_sample`` semantics in both conventions:

  - ``align_corners=False``: base grid (2j+1)/PS - 1, u = p - 0.5
  - ``align_corners=True``: base grid linspace(-1, 1, PS),
    u = p * (size - 1) / size

where p = A_norm * min(h, w) @ (gx, gy) + (tx * w, ty * h) in the level's
pixels; out-of-level bilinear corners contribute zero.  Every LAF carries a
flat level index into the (row_offsets, heights, widths) tables.

``bf16=True`` is the plain version of kernel B4's bf16 mode (the TPU
sampler's ``mxu_dtype=bf16``): corner values and column weights rounded to
bf16, each row's two products summed in float32, the rows weighted by the
float32 row weights.
"""

from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor


def base_lin(ps: int, align_corners: bool) -> np.ndarray:
    """The affine_grid base coordinates along one axis, float32."""
    if align_corners:
        return np.linspace(-1.0, 1.0, ps, dtype=np.float32)
    j = np.arange(ps, dtype=np.float32)
    return ((np.float32(2.0) * j + np.float32(1.0)) / np.float32(ps)
            - np.float32(1.0))


def extract_patches_from_flat_pyramid(buf2d: Tensor, lafs: Tensor,
                                      level_idx: Tensor, row_offsets: Tensor,
                                      heights: Tensor, widths: Tensor,
                                      ps: int = 32,
                                      align_corners: bool = False,
                                      bf16: bool = False) -> Tensor:
    """(N, PS, PS) float32 bilinear patches; LAF i samples flat level
    ``level_idx[i]`` of the row-padded buffer (pitch = buffer width)."""
    dev, dt = lafs.device, lafs.dtype
    lin = torch.from_numpy(base_lin(ps, align_corners)).to(dev)
    gx = lin[None, :].expand(ps, ps)
    gy = lin[:, None].expand(ps, ps)
    n = lafs.shape[0]
    lvl = level_idx.long()
    hi = heights[lvl][:, None, None]
    wi = widths[lvl][:, None, None]
    ro = row_offsets[lvl][:, None, None]
    h = hi.to(dt)
    w = wi.to(dt)
    m = torch.minimum(h, w)
    A = lafs[:, None, None, :, :]
    xs = m * (A[..., 0, 0] * gx + A[..., 0, 1] * gy) + w * A[..., 0, 2]
    ys = m * (A[..., 1, 0] * gx + A[..., 1, 1] * gy) + h * A[..., 1, 2]
    if align_corners:
        u = xs * (w - 1.0) / w
        v = ys * (h - 1.0) / h
    else:
        u = xs - 0.5
        v = ys - 0.5
    pitch = buf2d.shape[1]
    flat = buf2d.reshape(-1)
    x0 = torch.floor(u)
    y0 = torch.floor(v)
    fx = u - x0
    fy = v - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)

    def fetch(xc, yc):
        inb = (xc >= 0) & (xc <= wi - 1) & (yc >= 0) & (yc <= hi - 1)
        xcc = torch.minimum(torch.clamp(xc, min=0), wi - 1)
        ycc = torch.minimum(torch.clamp(yc, min=0), hi - 1)
        return flat[(ro + ycc) * pitch + xcc], inb.to(dt)

    if bf16:
        def corner_bf16(xc, yc):
            vals, inb = fetch(xc, yc)
            return to_bf16(vals) * inb

        cx0, cx1 = to_bf16(1 - fx), to_bf16(fx)
        row0 = (corner_bf16(x0i, y0i) * cx0
                + corner_bf16(x0i + 1, y0i) * cx1)
        row1 = (corner_bf16(x0i, y0i + 1) * cx0
                + corner_bf16(x0i + 1, y0i + 1) * cx1)
        return ((1 - fy) * row0 + fy * row1).reshape(n, ps, ps)

    def corner(xc, yc, wgt):
        vals, inb = fetch(xc, yc)
        return vals * wgt * inb

    out = (corner(x0i, y0i, (1 - fx) * (1 - fy))
           + corner(x0i + 1, y0i, fx * (1 - fy))
           + corner(x0i, y0i + 1, (1 - fx) * fy)
           + corner(x0i + 1, y0i + 1, fx * fy))
    return out.reshape(n, ps, ps)


def to_bf16(x: Tensor) -> Tensor:
    """float32 values rounded to bf16 (round to nearest even), as float32."""
    return x.to(torch.bfloat16).to(x.dtype)


def batched_tables(n: int, h: int, w: int, device) -> tuple:
    """Level tables that make a stack of n (h, w) images, flattened to an
    (n*h, w) buffer, a flat pyramid with one level per image: level i at
    row i*h.  Returns (level_idx, row_offsets, heights, widths), int32."""
    idx = torch.arange(n, dtype=torch.int32, device=device)
    full = torch.full((n,), h, dtype=torch.int32, device=device)
    return idx, idx * h, full, torch.full_like(full, w)


def extract_patches_batched(imgs: Tensor, lafs: Tensor, ps: int = 32,
                            align_corners: bool = False) -> Tensor:
    """Per-sample extraction, the plain version of kernel B5: LAF i samples
    image i of (N, H, W) ``imgs`` -> (N, PS, PS).  Differentiable in both
    arguments through autograd.  Counterpart of the JAX package's
    ``_extract_patches_batched_xla``."""
    n, h, w = imgs.shape
    tables = batched_tables(n, h, w, imgs.device)
    return extract_patches_from_flat_pyramid(
        imgs.reshape(n * h, w), lafs, *tables, ps=ps,
        align_corners=align_corners)


def select_levels_for_lafs(dlafs: Tensor, sigma_pixdist_table: Tensor,
                           ps: int) -> Tensor:
    """The flat level whose blur (sigma * pix_dist) is closest to
    scale / PS for each denormalized LAF (first level on ties)."""
    A = dlafs[..., :2, :2]
    scales = torch.sqrt(torch.abs(A[..., 0, 0] * A[..., 1, 1]
                                  - A[..., 0, 1] * A[..., 1, 0]) + 1e-12)
    needed = scales / float(ps)
    d = torch.abs(sigma_pixdist_table[None, :] - needed[:, None])
    return torch.argmin(d, dim=1)


def _grid_coeff(ps: int, align_corners: bool):
    """lin(t) = a * t + b of the base grid coordinates."""
    if align_corners:
        return 2.0 / (ps - 1), -1.0
    return 2.0 / ps, 1.0 / ps - 1.0


def sample_extents(lafs: Tensor, level_idx: Tensor, heights: Tensor,
                   widths: Tensor, ps: int, align_corners: bool):
    """Half-extents (eu cols, ev rows, in level pixels) of each patch's
    sample spread; NaN/inf LAFs map to +inf.  Copy of
    ``affnet_tpu/ops/pallas_patches.py:sample_extents``."""
    lvl = level_idx.long()
    h_l = heights[lvl].to(torch.float32)
    w_l = widths[lvl].to(torch.float32)
    m = torch.minimum(h_l, w_l)
    A = lafs[:, :2, :2].to(torch.float32)
    if align_corners:
        su = (w_l - 1.0) / w_l
        sv = (h_l - 1.0) / h_l
    else:
        su = torch.ones_like(w_l)
        sv = torch.ones_like(h_l)
    ga, gb = _grid_coeff(ps, align_corners)
    gmax = max(abs(ga * (ps - 1) + gb), abs(gb))
    eu = (torch.abs(m * A[:, 0, 0] * su)
          + torch.abs(m * A[:, 0, 1] * su)) * gmax
    ev = (torch.abs(m * A[:, 1, 0] * sv)
          + torch.abs(m * A[:, 1, 1] * sv)) * gmax
    bad = ~(torch.isfinite(eu) & torch.isfinite(ev))
    inf = torch.full_like(eu, float("inf"))
    return torch.where(bad, inf, eu), torch.where(bad, inf, ev)
