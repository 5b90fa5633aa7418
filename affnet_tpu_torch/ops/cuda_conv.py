"""Kernel B7: one convolution layer of the flat eval stack.

Replaces ``affnet_tpu/ops/pallas_conv.py:_conv_kernel`` (entry
``conv_flat``) together with the crop and subsample that JAX's flat stack
applies to its output.  CUDA source: ``csrc/conv.cu``; plain version:
:func:`.conv_flat.conv_layer_plain`, whose module states the contract.
B7 (float32) is a register-tiled direct convolution with float32 FMAs on
the CUDA cores; its bf16 mode (B7-bf16) is an implicit GEMM on the tensor
cores (``mma.sync`` m16n8k16): bf16 operands, float32 sums, bias and
activation in float32, one rounding to bf16, as the TPU kernel with
``compute_dtype=bf16``.

Both sum in another order than the plain version's matrix products, so
the two agree to float32 rounding (bf16: to one bf16 ulp where that
rounding crosses a bf16 boundary), not bit for bit.

Launch counts: ``launches`` (B7) and ``launches_bf16`` (B7-bf16), one per
launch of the kernel, nowhere else.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.build import check_tensor, launch, stream_of
from .conv_flat import (ACTIVATIONS, check_layer_args, conv_layer_plain,
                        out_extent)

Tensor = torch.Tensor

KERNEL_SIZES = (3, 7)   # csrc/conv.cu: the float32 kernel's instances

launches = 0
launches_bf16 = 0


def pack_weights(w: Tensor, dtype: torch.dtype) -> Tensor:
    """(kh, kw, C, O) float32 -> the kernel's layout.  float32: (C,
    kh*kw, O).  bf16: (kh*kw, O, Cp) with C zero-padded to Cp, a multiple
    of 16 (the tensor cores' k16 step); for C == 1, (O, K) with the taps
    zero-padded to K, a multiple of 16."""
    kh, kw, c, o = w.shape
    if dtype == torch.float32:
        return w.permute(2, 0, 1, 3).reshape(c, kh * kw, o).contiguous()
    if c == 1:
        wk = w.reshape(kh * kw, o).T
        return F.pad(wk, (0, -(-kh * kw // 16) * 16 - kh * kw)).to(
            dtype).contiguous()
    wk = w.reshape(kh * kw, c, o).permute(0, 2, 1)
    return F.pad(wk, (0, -(-c // 16) * 16 - c)).to(dtype).contiguous()


def conv_flat_cuda(x: Tensor, w: Tensor, bias: Optional[Tensor],
                   img_hw: Tuple[int, int], pad: int, act: str = "none",
                   stride: int = 1) -> Tensor:
    """Launch B7 (B7-bf16 for bf16 ``x``) on CUDA tensors."""
    global launches, launches_bf16
    bf16 = x.dtype == torch.bfloat16
    check_tensor(x, "x", torch.bfloat16 if bf16 else torch.float32, 2)
    check_tensor(w, "w", torch.float32, 4)
    check_layer_args(x, w, img_hw, pad, act, stride)
    h, wd = img_hw
    c, total = x.shape
    k, _, _, o = w.shape
    if k not in KERNEL_SIZES:
        raise ValueError(f"conv_flat: the kernel takes kh in {KERNEL_SIZES}"
                         f" (kh <= {max(KERNEL_SIZES)}), got kh={k}")
    if x.data_ptr() % 16:
        x = x.clone()
    n = total // (h * wd)
    ho, wo = out_extent(img_hw, k, pad, stride)
    wk = pack_weights(w, x.dtype)
    b = (torch.zeros(o, dtype=torch.float32, device=x.device)
         if bias is None else bias.float().contiguous())
    check_tensor(b, "bias", torch.float32, 1)
    out = torch.empty((o, n * ho * wo), dtype=x.dtype, device=x.device)
    launch("launch_conv_flat", x.data_ptr(), wk.data_ptr(), b.data_ptr(),
           out.data_ptr(), c, o, n, h, wd, k, stride, pad,
           ACTIVATIONS.index(act), int(bf16), stream_of(x))
    if bf16:
        launches_bf16 += 1
    else:
        launches += 1
    return out


def conv_flat(x: Tensor, w: Tensor, bias: Optional[Tensor],
              img_hw: Tuple[int, int], pad: int, act: str = "none",
              stride: int = 1, use_kernel: bool = True) -> Tensor:
    """One layer on the flat layout: x (C, N*H*W) -> (O, N*Ho*Wo), only the
    layer's kept outputs.  It folds JAX's caller-side crop of a VALID layer
    and subsample of a stride-2 layer into the launch.  B7 for a CUDA
    tensor; the plain version for a CPU tensor or when ``use_kernel`` is
    False."""
    if x.device.type == "cpu" or not use_kernel:
        return conv_layer_plain(x, w, bias, img_hw, pad, act, stride)
    return conv_flat_cuda(x.contiguous(), w.contiguous(), bias, img_hw, pad,
                          act, stride)
