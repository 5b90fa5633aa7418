"""Kernel B6: the differentiable pyramid sampler of shape optimization.

Replaces ``affnet_tpu/ops/pallas_patches.py:make_pyramid_sampler_diff``
(custom VJP: the Pallas forward, the XLA VJP of the flat gather as its
backward), which ``LAFShapeOptimizer`` routes every patch of a step through.
The LAFs are the variable being optimized and the level of each LAF is
chosen from its current scale, so the level index is an argument of the
sampler: the JAX package carries it as float32 with a zero cotangent; here
it is an int32 tensor, which autograd never differentiates.

On CUDA tensors :class:`PyramidSample` pairs B4's forward kernel on the
pyramid's level table (``csrc/patches.cu``,
:func:`.cuda_patches.sample_pyramid_cuda`) with the backward kernel
``csrc/patches_bwd.cu`` (:func:`.cuda_patches.sample_pyramid_bwd_cuda`),
saving the forward's level index for the backward and computing only the
cotangents autograd asks for: shape optimization asks for the LAFs', never
the buffer's.  On CPU tensors the plain version, autograd through
:func:`.patches.extract_patches_from_flat_pyramid`, runs instead.
"""

from __future__ import annotations

from typing import Callable

import torch

from . import cuda_patches
from .patches import extract_patches_from_flat_pyramid

Tensor = torch.Tensor


class PyramidSample(torch.autograd.Function):
    """(buf2d, lafs (N, 2, 3), level_idx (N,) int32) -> (N, PS, PS)
    through the CUDA kernels, forward and backward."""

    @staticmethod
    def forward(ctx, buf2d: Tensor, lafs: Tensor, level_idx: Tensor,
                row_offsets: Tensor, heights: Tensor, widths: Tensor,
                ps: int, align_corners: bool) -> Tensor:
        tables = (level_idx, row_offsets, heights, widths)
        ctx.save_for_backward(buf2d, lafs, *tables)
        ctx.ps, ctx.align_corners = ps, align_corners
        return cuda_patches.sample_pyramid_cuda(buf2d, lafs, tables, ps,
                                                align_corners)

    @staticmethod
    def backward(ctx, g: Tensor):
        buf2d, lafs, *tables = ctx.saved_tensors
        need_buf, need_lafs = ctx.needs_input_grad[:2]
        g_buf = g_lafs = None
        if need_buf or need_lafs:
            g_buf, g_lafs = cuda_patches.sample_pyramid_bwd_cuda(
                buf2d, lafs, tuple(tables), g.contiguous(), ctx.ps,
                ctx.align_corners, need_buf, need_lafs)
        return g_buf, g_lafs, None, None, None, None, None, None


def make_pyramid_sampler_diff(row_offsets: Tensor, heights: Tensor,
                              widths: Tensor, ps: int, align_corners: bool,
                              use_kernel: bool = True
                              ) -> Callable[[Tensor, Tensor, Tensor],
                                            Tensor]:
    """``sample(buf2d, lafs, level_idx)`` -> (N, PS, PS) patches of the
    flat pyramid described by the level tables, differentiable in
    ``buf2d`` and ``lafs``: B6 for CUDA tensors, the plain version for CPU
    tensors or when ``use_kernel`` is False."""
    tables = tuple(t.to(torch.int32).contiguous()
                   for t in (row_offsets, heights, widths))

    def sample(buf2d: Tensor, lafs: Tensor, level_idx: Tensor) -> Tensor:
        if lafs.device.type == "cpu" or not use_kernel:
            return extract_patches_from_flat_pyramid(
                buf2d, lafs, level_idx, *tables, ps=ps,
                align_corners=align_corners)
        return PyramidSample.apply(
            buf2d.contiguous(), lafs.contiguous(),
            level_idx.to(torch.int32).contiguous(), *tables, ps,
            align_corners)

    return sample
