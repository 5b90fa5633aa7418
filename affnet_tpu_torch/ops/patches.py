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


def _sample_positions(lafs: Tensor, level_idx: Tensor, row_offsets: Tensor,
                      heights: Tensor, widths: Tensor, ps: int,
                      align_corners: bool):
    """Each sample's position (u, v) in its level's pixels, (N, PS, PS),
    with the level's (height, width, first row) as int64 and (h, w, m)
    as float, each (N, 1, 1), and the base grid (gx, gy) as (PS, PS)."""
    dev, dt = lafs.device, lafs.dtype
    lin = torch.from_numpy(base_lin(ps, align_corners)).to(dev)
    gx = lin[None, :].expand(ps, ps)
    gy = lin[:, None].expand(ps, ps)
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
    return u, v, (hi, wi, ro), (h, w, m), (gx, gy)


def extract_patches_from_flat_pyramid(buf2d: Tensor, lafs: Tensor,
                                      level_idx: Tensor, row_offsets: Tensor,
                                      heights: Tensor, widths: Tensor,
                                      ps: int = 32,
                                      align_corners: bool = False,
                                      bf16: bool = False) -> Tensor:
    """(N, PS, PS) float32 bilinear patches; LAF i samples flat level
    ``level_idx[i]`` of the row-padded buffer (pitch = buffer width)."""
    dt = lafs.dtype
    n = lafs.shape[0]
    u, v, (hi, wi, ro), _, _ = _sample_positions(
        lafs, level_idx, row_offsets, heights, widths, ps, align_corners)
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


def laf_cotangent_replay(buf2d: Tensor, lafs: Tensor, level_idx: Tensor,
                         row_offsets: Tensor, heights: Tensor,
                         widths: Tensor, g: Tensor, ps: int = 32,
                         align_corners: bool = False) -> Tensor:
    """The LAF cotangent of :func:`extract_patches_from_flat_pyramid` for
    upstream gradient ``g`` (N, PS, PS), computed in the order and rounding
    of kernel B5/B6 backward (``csrc/patches_bwd.cu``), so the kernel's
    result equals it bit for bit: the (N, 2, 3) cotangent.  Used by the
    tests and ``chip_smoke.py`` to hold the kernel; autograd of the sampler
    is the plain version.

    Per sample: the forward's position, corner values selected to 0 outside
    the level (and everywhere for positions not within 1e9 px), gu = g du,
    gv = g dv.  Per thread of the kernel's 256: PS 32 and 64, thread t owns
    column t % PS of PS*PS/256 consecutive rows and sums gu, gu gy, gv,
    gv gy down them, then multiplies the gu and gv sums by its gx; any
    other PS, thread t sums gu gx, gu gy, gu, gv gx, gv gy, gv over the
    samples t, t + 256, ... in turn.  Then each warp's shuffle-down tree
    (lane i adds lane i + 16, then i + 8, ...), the eight warps added in
    order, and the scale (s_u m), (s_u w), (s_v m), (s_v h)."""
    n = lafs.shape[0]
    u, v, (hi, wi, ro), (h, w, m), (gx, gy) = _sample_positions(
        lafs, level_idx, row_offsets, heights, widths, ps, align_corners)
    flat = buf2d.reshape(-1)
    pitch = buf2d.shape[1]
    x0 = torch.floor(u)
    y0 = torch.floor(v)
    fx = u - x0
    fy = v - y0
    near = (torch.abs(u) < 1e9) & (torch.abs(v) < 1e9)
    zero = torch.zeros_like(x0)
    x0i = torch.where(near, x0, zero).to(torch.int64)
    y0i = torch.where(near, y0, zero).to(torch.int64)

    def corner(xc, yc):
        inb = near & (xc >= 0) & (xc <= wi - 1) & (yc >= 0) & (yc <= hi - 1)
        xcc = torch.minimum(torch.clamp(xc, min=0), wi - 1)
        ycc = torch.minimum(torch.clamp(yc, min=0), hi - 1)
        vals = flat[(ro + ycc) * pitch + xcc]
        return torch.where(inb, vals, torch.zeros_like(vals))

    v00, v10 = corner(x0i, y0i), corner(x0i + 1, y0i)
    v01, v11 = corner(x0i, y0i + 1), corner(x0i + 1, y0i + 1)
    du = (1 - fy) * (v10 - v00) + fy * (v11 - v01)
    dv = (1 - fx) * (v01 - v00) + fx * (v11 - v10)
    gu, gv = g * du, g * dv
    threads = 256
    if ps in (32, 64):
        per, r0s = ps * ps // threads, threads // ps
        gu4, gv4 = (t.reshape(n, r0s, per, ps) for t in (gu, gv))
        gy4 = gy.reshape(r0s, per, ps)
        acc = [torch.zeros((n, r0s, ps), dtype=gu.dtype, device=gu.device)
               for _ in range(4)]
        for k in range(per):
            a, b, gyk = gu4[:, :, k], gv4[:, :, k], gy4[:, k]
            acc = [acc[0] + a, acc[1] + a * gyk, acc[2] + b,
                   acc[3] + b * gyk]
        gxc = gx[0]
        parts = [gxc * acc[0], acc[1], acc[0], gxc * acc[2], acc[3], acc[2]]
    else:
        steps = -(-ps * ps // threads)
        pad = steps * threads - ps * ps

        def lay(t):
            t = t.expand(n, ps, ps).reshape(n, ps * ps)
            return torch.nn.functional.pad(t, (0, pad)).reshape(
                n, steps, threads)

        gu3, gv3, gx3, gy3 = (lay(t) for t in (gu, gv, gx, gy))
        valid = torch.arange(steps * threads, device=gu.device).reshape(
            steps, threads) < ps * ps
        acc = [torch.zeros((n, threads), dtype=gu.dtype, device=gu.device)
               for _ in range(6)]
        for j in range(steps):
            a, b, ok = gu3[:, j], gv3[:, j], valid[j]
            terms = [a * gx3[:, j], a * gy3[:, j], a, b * gx3[:, j],
                     b * gy3[:, j], b]
            acc = [torch.where(ok, s + t, s) for s, t in zip(acc, terms)]
        parts = acc
    x = torch.stack([p.reshape(n, threads) for p in parts], 1)
    x = x.reshape(n, 6, threads // 32, 32)
    for off in (16, 8, 4, 2, 1):
        x = x[..., :off] + x[..., off:2 * off]
    tot = x[..., 0, 0]
    for wp in range(1, threads // 32):
        tot = tot + x[:, :, wp, 0]
    h1, w1, m1 = h[:, 0, 0], w[:, 0, 0], m[:, 0, 0]
    if align_corners:
        su, sv = (w1 - 1.0) / w1, (h1 - 1.0) / h1
    else:
        su = sv = torch.ones_like(w1)
    scale = torch.stack([su * m1, su * m1, su * w1, sv * m1, sv * m1,
                         sv * h1], 1)
    return (scale * tot).reshape(n, 2, 3)


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


def extract_patches(img: Tensor, lafs: Tensor, ps: int = 32,
                    align_corners: bool = False,
                    use_kernel: bool = True) -> Tensor:
    """(N, PS, PS) bilinear patches of the (H, W) image at normalized
    (N, 2, 3) LAFs, zeros outside (the reference's extract_patches): the
    image as a one-level buffer (:func:`batched_tables` of one image)
    through kernel B4 on the card, its plain version for a CPU tensor or
    ``use_kernel=False``."""
    from .cuda_patches import extract_patches_pyramid
    h, w = img.shape
    _, offs, hs, ws = batched_tables(1, h, w, img.device)
    lvl = torch.zeros(lafs.shape[0], dtype=torch.int32, device=img.device)
    patches, _ = extract_patches_pyramid(img, lafs, lvl, offs, hs, ws, ps=ps,
                                         align_corners=align_corners,
                                         use_kernel=use_kernel)
    return patches


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
