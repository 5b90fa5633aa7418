"""Kernels B4, B5 and B6: the bilinear patch sampler and its backward.

B4 replaces ``affnet_tpu/ops/pallas_patches.py:_sampler_kernel`` (entries
``extract_patches_window_matmul`` and ``extract_patches_bucketed``) on the
extraction path.  CUDA source: ``csrc/patches.cu``.  Its bf16 mode
(B4-bf16) is the same kernel with ``mxu_dtype=bf16``, the extractor's
``fast`` mode at both patch sites.

The TPU kernel fetches a static window per patch and turns bilinear
sampling into tent-weight matmuls, with an exact fallback for patches that
overflow their window.  Here the function is ported, not the mechanism: a
direct gather by persistent blocks, templated on the patch size (32 and 64;
a generic instance for any other size >= 2), with the plain sampler's
arithmetic (:func:`.patches.extract_patches_from_flat_pyramid`) in the same
order, bit for bit.  There is no static window, so nothing can overflow and
``n_overflow`` is always 0.  The base grid goes to the kernels as a device
array (:func:`lin_device`), so the patch size has no upper limit.

B5 is the same ``_sampler_kernel`` reached through the training warps'
custom VJP (``_batched_sample_diff``): its forward is B4's kernel on
per-sample tables (:func:`sample_batched_cuda`), its backward the kernel of
``csrc/patches_bwd.cu`` (:func:`sample_bwd_cuda`).  The autograd pairing is
``ops/batched_sampler.py``.

B6 is the same ``_sampler_kernel`` reached through the shape optimizer's
``make_pyramid_sampler_diff``: LAF i samples flat pyramid level
``level_idx[i]``, which moves with the LAFs from step to step.  Forward:
B4's kernel on the pyramid's own level table (:func:`sample_pyramid_cuda`);
backward: the kernel of ``csrc/patches_bwd.cu`` on the same table and the
same level index (:func:`sample_pyramid_bwd_cuda`).  The JAX forward runs
windows of 256x384 with ``max(16, n // 16)`` fallback slots; the direct
gather has no window, so it cannot overflow.  The autograd pairing is
``ops/pyramid_sampler.py``.

Launch counts: ``launches`` (B4), ``launches_bf16`` (B4-bf16),
``launches_batched`` (B5 forward; and ``launches_batched_ps``, the same
launches by patch size, one per training site), ``launches_bwd`` (B5
backward), ``launches_pyramid`` and ``launches_pyramid_bwd`` (B6 forward
and backward), one per launch of the kernel, nowhere else.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..kernels.build import check_tensor, launch, stream_of
from .patches import base_lin, extract_patches_from_flat_pyramid

Tensor = torch.Tensor

launches = 0
launches_bf16 = 0
launches_batched = 0
launches_batched_ps: Dict[int, int] = {}
launches_bwd = 0
launches_pyramid = 0
launches_pyramid_bwd = 0

_LIN: Dict[Tuple[int, bool, torch.device], Tensor] = {}


def lin_device(ps: int, align_corners: bool, device) -> Tensor:
    """The base grid (:func:`.patches.base_lin`) as a float32 tensor on
    ``device``, made once per (ps, align_corners, device)."""
    key = (ps, align_corners, torch.device(device))
    if key not in _LIN:
        _LIN[key] = torch.from_numpy(base_lin(ps, align_corners)).to(device)
    return _LIN[key]


def _check_sampler_args(buf2d: Tensor, lafs: Tensor, level_idx: Tensor,
                        row_offsets: Tensor, heights: Tensor,
                        widths: Tensor, ps: int) -> None:
    check_tensor(buf2d, "buf2d", torch.float32, 2)
    check_tensor(lafs, "lafs", torch.float32, 3)
    check_tensor(level_idx, "level_idx", torch.int32, 1)
    for name, t in (("row_offsets", row_offsets), ("heights", heights),
                    ("widths", widths)):
        check_tensor(t, name, torch.int32, 1)
    n = lafs.shape[0]
    n_levels = heights.shape[0]
    if lafs.shape[1:] != (2, 3) or level_idx.shape[0] != n:
        raise ValueError("patches: need (N, 2, 3) LAFs and N level indices")
    if row_offsets.shape[0] != n_levels or widths.shape[0] != n_levels:
        raise ValueError("patches: level tables differ in length")
    if ps < 2:
        raise ValueError(f"patches: need ps >= 2, got {ps}")


def _sample(buf2d: Tensor, lafs: Tensor, level_idx: Tensor,
            row_offsets: Tensor, heights: Tensor, widths: Tensor, ps: int,
            align_corners: bool, bf16: bool = False) -> Tensor:
    """Check the arguments and launch csrc/patches.cu (unless N is 0);
    returns the (N, PS, PS) float32 patches."""
    _check_sampler_args(buf2d, lafs, level_idx, row_offsets, heights, widths,
                        ps)
    if buf2d.numel() >= 1 << 31:
        raise ValueError("patches: the buffer must hold fewer than 2^31 "
                         "elements (32-bit indexing)")
    n = lafs.shape[0]
    out = torch.empty((n, ps, ps), dtype=torch.float32, device=lafs.device)
    if n == 0:
        return out
    launch("launch_sample_patches", buf2d.data_ptr(), buf2d.shape[0],
           buf2d.shape[1], lafs.data_ptr(), level_idx.data_ptr(),
           row_offsets.data_ptr(), heights.data_ptr(), widths.data_ptr(),
           heights.shape[0],
           lin_device(ps, align_corners, lafs.device).data_ptr(),
           out.data_ptr(), n, ps, int(align_corners), int(bf16),
           stream_of(lafs))
    return out


def extract_patches_cuda(buf2d: Tensor, lafs: Tensor, level_idx: Tensor,
                         row_offsets: Tensor, heights: Tensor,
                         widths: Tensor, ps: int = 32,
                         align_corners: bool = False,
                         bf16: bool = False) -> Tensor:
    """Launch B4 (B4-bf16 with ``bf16``): float32 buffer and (N, 2, 3)
    LAFs, int32 level index and level tables, all contiguous CUDA
    tensors."""
    global launches, launches_bf16
    out = _sample(buf2d, lafs, level_idx, row_offsets, heights, widths, ps,
                  align_corners, bf16)
    if out.shape[0] > 0:
        if bf16:
            launches_bf16 += 1
        else:
            launches += 1
    return out


def sample_batched_cuda(buf2d: Tensor, lafs: Tensor, tables: tuple,
                        ps: int, align_corners: bool) -> Tensor:
    """Launch B5's forward: B4's kernel with LAF i sampling level i of
    ``tables`` = (level_idx, row_offsets, heights, widths)
    (:func:`.patches.batched_tables`)."""
    global launches_batched
    out = _sample(buf2d, lafs, *tables, ps, align_corners)
    if out.shape[0] > 0:
        launches_batched += 1
        launches_batched_ps[ps] = launches_batched_ps.get(ps, 0) + 1
    return out


def sample_pyramid_cuda(buf2d: Tensor, lafs: Tensor, tables: tuple,
                        ps: int, align_corners: bool) -> Tensor:
    """Launch B6's forward: B4's kernel, LAF i sampling flat level
    ``level_idx[i]`` of ``tables`` = (level_idx, row_offsets, heights,
    widths)."""
    global launches_pyramid
    out = _sample(buf2d, lafs, *tables, ps, align_corners)
    launches_pyramid += int(out.shape[0] > 0)
    return out


def _sample_bwd(buf2d: Tensor, lafs: Tensor, tables: tuple, g: Tensor,
                ps: int, align_corners: bool, need_buf: bool,
                need_lafs: bool) -> Tuple[Optional[Tensor],
                                          Optional[Tensor]]:
    """Check the arguments and launch csrc/patches_bwd.cu (unless N is 0):
    (d buf2d or None, d lafs or None)."""
    level_idx, row_offsets, heights, widths = tables
    _check_sampler_args(buf2d, lafs, level_idx, row_offsets, heights, widths,
                        ps)
    check_tensor(g, "g", torch.float32, 3)
    n = lafs.shape[0]
    if g.shape != (n, ps, ps):
        raise ValueError(f"patches bwd: g has shape {tuple(g.shape)}, "
                         f"expected {(n, ps, ps)}")
    if not (need_buf or need_lafs):
        raise ValueError("patches bwd: no cotangent asked for")
    grad_buf = torch.zeros_like(buf2d) if need_buf else None
    grad_lafs = torch.empty_like(lafs) if need_lafs else None
    if n == 0:
        return grad_buf, grad_lafs
    launch("launch_sample_patches_bwd", buf2d.data_ptr(), buf2d.shape[0],
           buf2d.shape[1], lafs.data_ptr(), level_idx.data_ptr(),
           row_offsets.data_ptr(), heights.data_ptr(), widths.data_ptr(),
           heights.shape[0],
           lin_device(ps, align_corners, lafs.device).data_ptr(),
           g.data_ptr(), grad_buf.data_ptr() if need_buf else None,
           grad_lafs.data_ptr() if need_lafs else None, n, ps,
           int(align_corners), stream_of(lafs))
    return grad_buf, grad_lafs


def sample_bwd_cuda(buf2d: Tensor, lafs: Tensor, tables: tuple, g: Tensor,
                    ps: int, align_corners: bool, need_buf: bool,
                    need_lafs: bool) -> Tuple[Optional[Tensor],
                                              Optional[Tensor]]:
    """Launch B5's backward (csrc/patches_bwd.cu) on upstream gradient
    ``g`` (N, PS, PS): returns (d buf2d or None, d lafs or None) as asked."""
    global launches_bwd
    grads = _sample_bwd(buf2d, lafs, tables, g, ps, align_corners, need_buf,
                        need_lafs)
    launches_bwd += int(lafs.shape[0] > 0)
    return grads


def sample_pyramid_bwd_cuda(buf2d: Tensor, lafs: Tensor, tables: tuple,
                            g: Tensor, ps: int, align_corners: bool,
                            need_buf: bool, need_lafs: bool
                            ) -> Tuple[Optional[Tensor], Optional[Tensor]]:
    """Launch B6's backward: csrc/patches_bwd.cu on the pyramid's level
    table and the forward's level index."""
    global launches_pyramid_bwd
    grads = _sample_bwd(buf2d, lafs, tables, g, ps, align_corners, need_buf,
                        need_lafs)
    launches_pyramid_bwd += int(lafs.shape[0] > 0)
    return grads


def extract_patches_pyramid(buf2d: Tensor, lafs: Tensor, level_idx: Tensor,
                            row_offsets: Tensor, heights: Tensor,
                            widths: Tensor, ps: int = 32,
                            align_corners: bool = False,
                            use_kernel: bool = True,
                            bf16: bool = False) -> Tuple[Tensor, int]:
    """Pyramid patches and the overflow count (always 0: no static
    window).  B4 (B4-bf16 with ``bf16``) for CUDA tensors; the plain sampler
    for CPU tensors or when ``use_kernel`` is False."""
    if lafs.device.type == "cpu" or not use_kernel:
        patches = extract_patches_from_flat_pyramid(
            buf2d, lafs, level_idx, row_offsets, heights, widths, ps=ps,
            align_corners=align_corners, bf16=bf16)
    else:
        patches = extract_patches_cuda(
            buf2d, lafs.contiguous(), level_idx.to(torch.int32).contiguous(),
            row_offsets, heights, widths, ps=ps, align_corners=align_corners,
            bf16=bf16)
    return patches, 0
