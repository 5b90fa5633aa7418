"""Kernel B5: the differentiable per-sample patch sampler of the training
warps.

Replaces ``affnet_tpu/ops/pallas_patches.py:_batched_sample_diff`` (custom
VJP, entry ``extract_patches_batched_pallas``), which the JAX package's
``ops/patches.extract_patches_batched`` routes every training warp through.
LAF i samples image i of an (N, H, W) stack; the stack is the flat pyramid
of :func:`.patches.batched_tables`, one level per image.

On CUDA tensors :class:`BatchedSample` pairs B4's forward kernel
(``csrc/patches.cu``, :func:`.cuda_patches.sample_batched_cuda`) with the
backward kernel ``csrc/patches_bwd.cu`` (:func:`.cuda_patches.sample_bwd_cuda`),
which computes only the cotangents autograd asks for: the training rewarp
needs the LAFs', never the images'.  On CPU tensors the plain version,
autograd through :func:`.patches.extract_patches_batched`, runs instead.
"""

from __future__ import annotations

import torch

from . import cuda_patches
from .patches import batched_tables, extract_patches_batched

Tensor = torch.Tensor


class BatchedSample(torch.autograd.Function):
    """(imgs (N, H, W), lafs (N, 2, 3)) -> (N, PS, PS) through the CUDA
    kernels, forward and backward."""

    @staticmethod
    def forward(ctx, imgs: Tensor, lafs: Tensor, ps: int,
                align_corners: bool) -> Tensor:
        n, h, w = imgs.shape
        buf2d = imgs.reshape(n * h, w)
        tables = batched_tables(n, h, w, imgs.device)
        ctx.save_for_backward(buf2d, lafs, *tables)
        ctx.ps, ctx.align_corners, ctx.shape = ps, align_corners, imgs.shape
        return cuda_patches.sample_batched_cuda(buf2d, lafs, tables, ps,
                                                align_corners)

    @staticmethod
    def backward(ctx, g: Tensor):
        buf2d, lafs, *tables = ctx.saved_tensors
        need_img, need_lafs = ctx.needs_input_grad[:2]
        if not (need_img or need_lafs):
            return None, None, None, None
        g_buf, g_lafs = cuda_patches.sample_bwd_cuda(
            buf2d, lafs, tuple(tables), g.contiguous(), ctx.ps,
            ctx.align_corners, need_img, need_lafs)
        g_img = g_buf.reshape(ctx.shape) if need_img else None
        return g_img, g_lafs, None, None


def sample_batched(imgs: Tensor, lafs: Tensor, ps: int = 32,
                   align_corners: bool = False,
                   use_kernel: bool = True) -> Tensor:
    """Differentiable per-sample patches: B5 for CUDA tensors, the plain
    version for CPU tensors or when ``use_kernel`` is False."""
    if imgs.device.type == "cpu" or not use_kernel:
        return extract_patches_batched(imgs, lafs, ps=ps,
                                       align_corners=align_corners)
    return BatchedSample.apply(imgs.contiguous(), lafs.contiguous(), ps,
                               align_corners)
