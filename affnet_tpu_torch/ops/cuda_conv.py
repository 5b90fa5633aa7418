"""Kernel B7: the flat-layout convolution of the eval layer stack.

Replaces ``affnet_tpu/ops/pallas_conv.py:_conv_kernel`` (entry
``conv_flat``).  CUDA source: ``csrc/conv.cu``; plain version:
:func:`.conv_flat.conv_flat_plain`, whose module states the contract.  Its
bf16 mode (B7-bf16) is the same kernel on bf16 activations, the TPU
kernel with ``compute_dtype=bf16``: bf16 operands, float32 sums, bias and
activation in float32, one rounding to bf16.

The kernel is a direct convolution through shared memory and registers;
its sums run in another order than the plain version's matrix product, so
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
from .conv_flat import ACTIVATIONS, check_conv_args, conv_flat_plain

Tensor = torch.Tensor

MAX_KH = 32        # csrc/conv.cu: row-mask bits
MAX_W = 1024       # csrc/conv.cu: one tile row of pixels

launches = 0
launches_bf16 = 0


def pack_weights(w: Tensor, c_pad: int, dtype: torch.dtype) -> Tensor:
    """(kh, kw, C, O) -> the kernel's (C_pad, kh * kw, O) float32, zero rows
    for the padded channels, values rounded to the activations' dtype."""
    kh, kw, c, o = w.shape
    wk = F.pad(w.permute(2, 0, 1, 3).reshape(c, kh * kw, o),
               (0, 0, 0, 0, 0, c_pad - c))
    return wk.to(dtype).float().contiguous()


def conv_flat_cuda(x: Tensor, w: Tensor, bias: Optional[Tensor],
                   img_hw: Tuple[int, int], pad: int,
                   act: str = "none") -> Tensor:
    """Launch B7 (B7-bf16 for bf16 ``x``) on CUDA tensors."""
    global launches, launches_bf16
    bf16 = x.dtype == torch.bfloat16
    check_tensor(x, "x", torch.bfloat16 if bf16 else torch.float32, 2)
    check_tensor(w, "w", torch.float32, 4)
    check_conv_args(x, w, img_hw, pad, act)
    h, wd = img_hw
    c_pad, total = x.shape
    kh, kw, _, o = w.shape
    if kh > MAX_KH or wd > MAX_W:
        raise ValueError(f"conv_flat: the kernel takes kh <= {MAX_KH} and "
                         f"W <= {MAX_W}, got kh={kh}, W={wd}")
    wk = pack_weights(w, c_pad, x.dtype)
    b = (torch.zeros(o, dtype=torch.float32, device=x.device)
         if bias is None else bias.float().contiguous())
    check_tensor(b, "bias", torch.float32, 1)
    out = torch.empty((o, total), dtype=x.dtype, device=x.device)
    launch("launch_conv_flat", x.data_ptr(), wk.data_ptr(), b.data_ptr(),
           out.data_ptr(), c_pad, o, total // wd, h, wd, kh, kw, pad,
           ACTIVATIONS.index(act), int(bf16), stream_of(x))
    if bf16:
        launches_bf16 += 1
    else:
        launches += 1
    return out


def conv_flat(x: Tensor, w: Tensor, bias: Optional[Tensor],
              img_hw: Tuple[int, int], pad: int, act: str = "none",
              use_kernel: bool = True) -> Tensor:
    """B7 for a CUDA tensor; the plain version for a CPU tensor or when
    ``use_kernel`` is False."""
    if x.device.type == "cpu" or not use_kernel:
        return conv_flat_plain(x, w, bias, img_hw, pad, act)
    return conv_flat_cuda(x.contiguous(), w.contiguous(), bias, img_hw, pad,
                          act)
