"""Kernel B2: the detection stage, as three kernels.

Replaces ``affnet_tpu/ops/pallas_detect.py:_detect_octave_kernel`` (entry
``detect_octave_fused``) with the JAX caller's border mask and octave dedup
map (``affnet_tpu/detector.py:183-195``).  CUDA source: ``csrc/detect.cu``.

- :func:`detect_stencil`, one launch per octave: det-Hessian response *
  sigma^4 clamped at ``th``, 3x3x3 NMS and the border mask, written into
  the octave's slice of the flat response vector; plus the counters the
  dedup needs (per center level k and per set K of earlier centers, the
  survivors no center of K claims, saturated at 2).
- :func:`dedup`, one launch per image: the octave dedup map
  (``nms.update_octave_map``'s sequence) with each level's keep flag read
  from the counters, in place.
- :func:`refine`, one launch per image: the soft-argmax (sigma, y, x) at
  the kept indices only, from the level buffer.

The plain versions (:func:`stencil_plain`, :func:`dedup_plain`,
:func:`refine_plain`) perform the same float operations in the same order
as the full-map chain of :mod:`.hessian` and :mod:`.nms`, so responses,
survivor sets and (sigma, y, x) are identical.  :func:`detect_octave` (the
full (L - 2, 4, H, W) maps of one octave: the JAX kernel's output) stays as
the yardstick against JAX; on the card it runs the stencil and the refine at
every pixel.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels.build import (check_rows, check_tensor, host_floats, launch,
                             stream_of)
from .hessian import clipped_response
from .nms import border_mask, nms3d_center, softargmax_scale_y_x

Tensor = torch.Tensor

MAX_CENTERS = 20    # csrc/detect.cu: 2^(L - 2) - 1 counters an octave

launches = 0           # the stencil, one per octave
launches_dedup = 0
launches_refine = 0


def n_counters(n_levels: int) -> int:
    """Dedup counters of an octave of ``n_levels`` levels."""
    return (1 << (n_levels - 2)) - 1


def _sigma4(sigmas: Sequence[float]) -> List[float]:
    """sigma^4 rounded to float32 from the double, as the plain version's
    ``tensor * (sigma ** 4)`` does."""
    return [float(np.float32(float(s) ** 4)) for s in sigmas]


# ---------------------------------------------------------------------------
# The stencil
# ---------------------------------------------------------------------------

def stencil_plain(levels: Tensor, sigmas: Sequence[float], th: float,
                  border: int, bmask: Optional[Tensor] = None
                  ) -> Tuple[Tensor, Tensor]:
    """Plain version on (L, H, W) levels: the border-masked NMS responses
    (L - 2, H, W) and the int32 dedup counters (2^(L - 2) - 1,) of
    :func:`count_survivors`."""
    n, h, w = levels.shape
    if bmask is None:
        bmask = border_mask(h, w, border, device=levels.device,
                            dtype=levels.dtype)
    rs = [clipped_response(levels[l], sigmas[l], th) for l in range(n)]
    resp = torch.stack([nms3d_center(rs[lc - 1], rs[lc], rs[lc + 1]) * bmask
                        for lc in range(1, n - 1)])
    return resp, count_survivors(resp)


def count_survivors(resp: Tensor) -> Tensor:
    """The dedup counters of one octave's (L - 2, ...) responses: entry
    2^k - 1 + K holds min(2, the entries of center k > 0 where no center j
    in the bit set K is >= 1)."""
    surv, claim = resp > 0, resp >= 1.0
    counts = []
    for k in range(resp.shape[0]):
        for K in range(1 << k):
            claimed = torch.zeros_like(surv[k])
            for j in range(k):
                if K >> j & 1:
                    claimed = claimed | claim[j]
            counts.append((surv[k] & ~claimed).sum())
    return torch.stack(counts).clamp(max=2).to(torch.int32)


def stencil_cuda(levels: Tensor, sigmas: Sequence[float], th: float,
                 border: int, resp: Tensor, counters: Tensor) -> None:
    """Launch the stencil on float32 CUDA levels: (L, H, W) with unit column
    stride (a view of the level buffer); writes ``resp`` (contiguous
    (L - 2, H, W)) and adds into ``counters`` (zeroed int32)."""
    global launches
    if levels.dim() != 3:
        raise ValueError(f"levels: expected (L, H, W), got "
                         f"{tuple(levels.shape)}")
    n, h, w = levels.shape
    check_rows(levels[0], "levels")
    if not 3 <= n <= MAX_CENTERS + 2 or len(sigmas) != n:
        raise ValueError(f"detect: need 3..{MAX_CENTERS + 2} levels and one "
                         f"sigma each, got {n} and {len(sigmas)}")
    if h == 0 or w == 0:
        raise ValueError("detect: empty levels")
    check_tensor(resp, "resp", torch.float32, 3)
    check_tensor(counters, "counters", torch.int32, 1)
    if tuple(resp.shape) != (n - 2, h, w) or counters.numel() != \
            n_counters(n):
        raise ValueError("detect: resp or counters of the wrong size")
    launch("launch_detect_stencil", levels.data_ptr(), levels.stride(0),
           levels.stride(1), h, w, n, host_floats(_sigma4(sigmas)),
           float(th), int(border), resp.data_ptr(), counters.data_ptr(),
           stream_of(resp))
    launches += 1


def detect_stencil(levels: Tensor, sigmas: Sequence[float], th: float,
                   border: int, resp: Tensor, counters: Tensor,
                   bmask: Optional[Tensor] = None,
                   use_kernel: bool = True) -> None:
    """One octave's stencil into ``resp`` and ``counters``: the kernel for
    CUDA tensors, the plain version for CPU tensors or when ``use_kernel``
    is False (``bmask``: its cached border mask)."""
    if resp.device.type == "cpu" or not use_kernel:
        r, c = stencil_plain(levels, sigmas, th, border, bmask)
        resp.copy_(r)
        counters.copy_(c)
    else:
        stencil_cuda(levels, sigmas, th, border, resp, counters)


# ---------------------------------------------------------------------------
# The octave dedup
# ---------------------------------------------------------------------------

def _n_centers(counters: Tensor) -> int:
    return (counters.shape[1] + 1).bit_length() - 1


def dedup_plain(resp: Tensor, counters: Tensor,
                octaves: Sequence[Tuple[int, int]]) -> None:
    """Plain version, in place on the flat response vector: per octave
    (``octaves``: its first entry and h * w) and center k, keep the level
    when its counter under the earlier kept centers is 2, then
    ``update_octave_map``'s sequence with that keep flag."""
    n_centers = _n_centers(counters)
    for o, (off, hw) in enumerate(octaves):
        kept = torch.zeros((), dtype=torch.int64, device=resp.device)
        octmap = torch.zeros(hw, dtype=resp.dtype, device=resp.device)
        for k in range(n_centers):
            keep = counters[o][(1 << k) - 1 + kept] >= 2
            kept = kept + keep.long() * (1 << k)
            sl = resp[off + k * hw:off + (k + 1) * hw]
            masked = sl * (1.0 - octmap)
            masked = masked * keep.to(resp.dtype)
            octmap = (torch.floor(octmap + masked) > 0).to(resp.dtype)
            sl.copy_(masked)


def dedup_cuda(resp: Tensor, counters: Tensor,
               octaves: Sequence[Tuple[int, int]]) -> None:
    """Launch the dedup on the CUDA response vector, in place."""
    global launches_dedup
    check_tensor(resp, "resp", torch.float32, 1)
    check_tensor(counters, "counters", torch.int32, 2)
    if counters.shape[0] != len(octaves):
        raise ValueError("dedup: one row of counters per octave")
    n = len(octaves)
    offs = (ctypes.c_longlong * n)(*[int(o) for o, _ in octaves])
    hws = (ctypes.c_longlong * n)(*[int(hw) for _, hw in octaves])
    launch("launch_detect_dedup", resp.data_ptr(), counters.data_ptr(), offs,
           hws, n, _n_centers(counters), stream_of(resp))
    launches_dedup += 1


def dedup(resp: Tensor, counters: Tensor,
          octaves: Sequence[Tuple[int, int]], use_kernel: bool = True) -> None:
    """The octave dedup of one image, in place: the kernel for CUDA tensors,
    the plain version for CPU tensors or when ``use_kernel`` is False."""
    if resp.device.type == "cpu" or not use_kernel:
        dedup_plain(resp, counters, octaves)
    else:
        dedup_cuda(resp, counters, octaves)


# ---------------------------------------------------------------------------
# The refine
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RefineTables:
    """Where each entry of the response vector comes from, on the device:
    per center level its first entry (``det_offsets``) and the flat index of
    the level below it (``ext_levels``); per flat level its buffer row,
    height, width, sigma, float32(sigma^4) and the float32 reciprocals of
    (min(h, w), h, w)."""
    det_offsets: Tensor
    ext_levels: Tensor
    row_offsets: Tensor
    heights: Tensor
    widths: Tensor
    sigma: Tensor
    sigma4: Tensor
    inv: Tensor

    @classmethod
    def for_octave(cls, h: int, w: int, sigmas: Sequence[float],
                   device) -> "RefineTables":
        """The tables of one octave's (L, h, w) levels stacked as an
        (L * h, w) buffer, and its (L - 2, h, w) responses as the vector."""
        n = len(sigmas)

        def dev(a, dtype):
            return torch.tensor(a, dtype=dtype, device=device)

        return cls(dev([k * h * w for k in range(n - 2)], torch.int64),
                   dev(list(range(n - 2)), torch.int64),
                   dev([l * h for l in range(n)], torch.int32),
                   dev([h] * n, torch.int32), dev([w] * n, torch.int32),
                   *_level_tables(sigmas, [h] * n, [w] * n, device))

    @staticmethod
    def level_tables(plan, device) -> Tuple[Tensor, Tensor, Tensor]:
        """(sigma, sigma4, inv) per flat level of a ``PyramidPlan``."""
        sigmas = [s for o in plan.sigmas for s in o]
        return _level_tables(sigmas, [h for h, _ in plan.level_shapes()],
                             [w for _, w in plan.level_shapes()], device)


def _level_tables(sigmas, heights, widths, device):
    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    hs = np.asarray(heights, np.float32)
    ws = np.asarray(widths, np.float32)
    one = np.float32(1.0)
    inv = np.stack([one / np.minimum(hs, ws), one / hs, one / ws], -1)
    return dev(sigmas), dev(_sigma4(sigmas)), dev(inv)


def refine_plain(buf: Tensor, idxs: Tensor, t: RefineTables,
                 th: float) -> Tensor:
    """Plain version: (sigma, y, x) normalized, (N, 3), at the response
    vector's entries ``idxs``; the full-map chain's float operations on the
    5x5 neighbourhood of the three levels around each point."""
    d = torch.searchsorted(t.det_offsets, idxs, right=True) - 1
    lf = t.ext_levels[d]
    h, w = t.heights[lf].long(), t.widths[lf].long()
    pix = idxs - t.det_offsets[d]
    y = torch.div(pix, w, rounding_mode="floor")
    x = pix - y * w
    off = torch.arange(-2, 3, device=buf.device)
    near = torch.arange(-1, 2, device=buf.device)
    inside = (((y[:, None] + near >= 0) & (y[:, None] + near < h[:, None]))
              [:, :, None]
              & ((x[:, None] + near >= 0) & (x[:, None] + near < w[:, None]))
              [:, None, :])
    zero = torch.zeros((), dtype=buf.dtype, device=buf.device)
    rs = []
    for k in range(3):
        lvl = lf + k
        yy = torch.minimum((y[:, None] + off).clamp(min=0), h[:, None] - 1)
        xx = torch.minimum((x[:, None] + off).clamp(min=0), w[:, None] - 1)
        rows = t.row_offsets[lvl].long()[:, None] + yy
        v = buf[rows[:, :, None], xx[:, None, :]]               # (N, 5, 5)
        gxx = v[:, 1:4, 0:3] - 2.0 * v[:, 1:4, 1:4] + v[:, 1:4, 2:5]
        gyy = v[:, 0:3, 1:4] - 2.0 * v[:, 1:4, 1:4] + v[:, 2:5, 1:4]
        gx0 = 0.5 * (v[:, 0:3, 0:3] - v[:, 0:3, 2:5])
        gx2 = 0.5 * (v[:, 2:5, 0:3] - v[:, 2:5, 2:5])
        gxy = 0.5 * (gx0 - gx2)
        r = torch.abs(gxx * gyy - gxy * gxy) * t.sigma4[lvl][:, None, None]
        rs.append(torch.where(inside, torch.clamp(r - th, min=0.0), zero))
    num_z = torch.zeros_like(y, dtype=buf.dtype)
    num_y, num_x, den = (torch.zeros_like(num_z) for _ in range(3))
    for k, m in enumerate(rs):
        s, sy, sx = (torch.zeros_like(num_z) for _ in range(3))
        for di in range(3):
            c0, c1, c2 = m[:, di, 0], m[:, di, 1], m[:, di, 2]
            rsum = c0 + c1 + c2
            s = s + rsum
            sy = sy + (di - 0.5) * rsum
            sx = sx + (-0.5 * c0 + 0.5 * c1 + 1.5 * c2)
        den = den + s
        num_z = num_z + t.sigma[lf + k] * s
        num_y = num_y + sy
        num_x = num_x + sx
    den = den + 1e-8
    sc = num_z / den
    yv = num_y / den + y.to(buf.dtype)
    xv = num_x / den + x.to(buf.dtype)
    inv = t.inv[lf]
    return torch.stack([sc * inv[:, 0], yv * inv[:, 1], xv * inv[:, 2]], -1)


def refine_cuda(buf: Tensor, idxs: Tensor, t: RefineTables,
                th: float) -> Tensor:
    """Launch the refine on the CUDA level buffer at ``idxs`` (int64)."""
    global launches_refine
    check_rows(buf, "buf")
    check_tensor(idxs, "idxs", torch.int64, 1)
    out = torch.empty((idxs.numel(), 3), dtype=torch.float32,
                      device=buf.device)
    if idxs.numel() == 0:
        return out
    launch("launch_detect_refine", buf.data_ptr(), buf.stride(0),
           idxs.data_ptr(), idxs.numel(), t.det_offsets.data_ptr(),
           t.ext_levels.data_ptr(), t.det_offsets.numel(),
           t.row_offsets.data_ptr(), t.heights.data_ptr(),
           t.widths.data_ptr(), t.sigma.data_ptr(), t.sigma4.data_ptr(),
           float(th), out.data_ptr(), stream_of(buf))
    launches_refine += 1
    return out


def refine(buf: Tensor, idxs: Tensor, tables: RefineTables, th: float,
           use_kernel: bool = True) -> Tensor:
    """(sigma, y, x) at ``idxs``: the kernel for a CUDA buffer, the plain
    version for a CPU buffer or when ``use_kernel`` is False."""
    if buf.device.type == "cpu" or not use_kernel:
        return refine_plain(buf, idxs, tables, th)
    return refine_cuda(buf, idxs, tables, th)


# ---------------------------------------------------------------------------
# The full maps of one octave: the JAX kernel's output, the parity yardstick
# ---------------------------------------------------------------------------

def detect_octave_plain(levels: Tensor, sigmas: Sequence[float],
                        th: float) -> Tensor:
    """Plain PyTorch version on (L, H, W) levels -> (L - 2, 4, H, W): per
    center level (nmsed_raw, sc, y, x), no border mask, no dedup."""
    n = levels.shape[0]
    rs = [clipped_response(levels[l], sigmas[l], th) for l in range(n)]
    out = []
    for lc in range(1, n - 1):
        nm = nms3d_center(rs[lc - 1], rs[lc], rs[lc + 1])
        sc, y, x = softargmax_scale_y_x(rs[lc - 1], rs[lc], rs[lc + 1],
                                        sigmas[lc - 1:lc + 2])
        out.append(torch.stack([nm, sc, y, x]))
    return torch.stack(out)


def detect_octave_cuda(levels: Tensor, sigmas: Sequence[float],
                       th: float) -> Tensor:
    """The same maps on contiguous float32 (L, H, W) CUDA levels: the
    stencil (border 0) and the refine at every pixel."""
    check_tensor(levels, "levels", torch.float32, 3)
    n, h, w = levels.shape
    resp = torch.empty((n - 2, h, w), dtype=torch.float32,
                       device=levels.device)
    counters = torch.zeros(n_counters(n), dtype=torch.int32,
                           device=levels.device)
    stencil_cuda(levels, sigmas, th, 0, resp, counters)
    tables = RefineTables.for_octave(h, w, sigmas, levels.device)
    idxs = torch.arange((n - 2) * h * w, device=levels.device)
    maps = refine_cuda(levels.view(n * h, w), idxs, tables, th)
    maps = maps.view(n - 2, h, w, 3).permute(0, 3, 1, 2)
    return torch.cat([resp[:, None], maps], dim=1)


def detect_octave(levels: Tensor, sigmas: Sequence[float], th: float,
                  use_kernel: bool = True) -> Tensor:
    """The kernels for CUDA levels; the plain version for CPU levels or when
    ``use_kernel`` is False."""
    if levels.device.type == "cpu" or not use_kernel:
        return detect_octave_plain(levels, sigmas, th)
    return detect_octave_cuda(levels, sigmas, th)
