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

# csrc/conv.cu's planning constants (launch_f32, launch_bf16).
_MAX_SMEM = 227 * 1024       # kMaxSmem
_BUDGET = 110 * 1024         # kBudget
_MAX_THREADS = 512           # kMaxThreads
_PX = 8                      # kPx: output pixels a float32 thread computes
_MARGIN = 4                  # kMargin
_WARPS = 8                   # kWarps (bf16)
_RAW_ELEMS = 16384           # kRawElems (bf16)

launches = 0
launches_bf16 = 0


def _f32_fits(o: int, k: int, pad: int, stride: int, h: int,
              wd: int) -> bool:
    """launch_f32's plan: the output rows of one patch over at most 512
    threads (the output channels halved while that fails and they stay a
    multiple of 16), and one channel of one patch with its weights in the
    227 KB of shared memory."""
    ho = (h + 2 * pad - k) // stride + 1
    wo = (wd + 2 * pad - k) // stride + 1
    seg = -(-wo // _PX)
    ob = o
    while ho * seg * (ob // 8) > _MAX_THREADS and ob % 16 == 0:
        ob //= 2
    if ho * seg * (ob // 8) > _MAX_THREADS:
        return False
    p = 0 if pad == 0 else (k - 1) // 2
    vec = -(-(_MARGIN - p + (_PX - 1) * stride + k) // 4)   # Window::kVec
    need = (seg - 1) * _PX * stride + 4 * vec
    ws = (max(_MARGIN + wd + p, need) + 3) & ~3
    if ws % 8 == 0:
        ws += 4
    return 4 * 2 * ((h + 2 * p) * ws + k * k * ob) <= _MAX_SMEM


def _bf16_fits(c: int, o: int, k: int, pad: int, h: int, wd: int) -> bool:
    """launch_bf16's plan at one patch a block (the fewest it takes): the
    staged patch, the weights of its output tile, the gather table, the
    warps' output tiles and the copy buffer in the 227 KB of shared
    memory."""
    gather = c == 1
    taps = k * k
    cp = 1 if gather else -(-c // 16) * 16
    kr = (-(-taps // 16) * 16 if gather else cp) + 8
    taps_eff = 1 if gather else taps
    ksteps = -(-taps // 16) if gather else cp // 16
    pix_bytes = 2 if gather else 2 * kr
    patch_bytes = (h + 2 * pad) * (wd + 2 * pad) * pix_bytes
    tab_bytes = 4 * ksteps * 16 if gather else 0
    ob = 8
    for cand in (64, 32, 16):
        if o % cand == 0 and taps_eff * cand * kr * 2 <= _BUDGET // 2:
            ob = cand
            break
    w_bytes = taps_eff * ob * kr * 2
    vec8 = (h * wd) % 8 == 0 and c * h * wd <= _RAW_ELEMS
    e_bytes = _WARPS * ob * ((1 if ob == 64 else 2) * 16 + 8) * 2
    raw_bytes = c * (h * wd + 8) * 2 if vec8 else 0
    x_bytes = (patch_bytes + 15) & ~15
    return x_bytes + w_bytes + tab_bytes + e_bytes + raw_bytes <= _MAX_SMEM


def b7_takes(c: int, o: int, k: int, pad: int, stride: int, h: int,
             wd: int, dtype: torch.dtype = torch.float32) -> bool:
    """Whether B7 (B7-bf16 for bf16) launches on a layer of ``c`` input
    channels, ``o`` outputs and a ``k`` x ``k`` kernel at ``pad`` and
    ``stride`` on ``h`` x ``wd`` maps: ``launch_conv_flat``'s own checks
    and plans (``csrc/conv.cu``), so :func:`conv_flat_cuda` refuses
    exactly what this refuses, and the flat stack
    (``models/cnn.py:apply_flat``) runs such a layer through the stock
    layers instead."""
    if (c <= 0 or o <= 0 or o % 8 or h <= 0 or wd <= 0
            or k not in KERNEL_SIZES or pad not in (0, (k - 1) // 2)
            or stride not in (1, 2) or k > h + 2 * pad or k > wd + 2 * pad):
        return False
    if dtype == torch.bfloat16:
        return _bf16_fits(c, o, k, pad, h, wd)
    return _f32_fits(o, k, pad, stride, h, wd)


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
    """Launch B7 (B7-bf16 for bf16 ``x``) on CUDA tensors; raises on a
    layer outside :func:`b7_takes`."""
    global launches, launches_bf16
    bf16 = x.dtype == torch.bfloat16
    check_layer_args(x, w, img_hw, pad, act, stride)
    h, wd = img_hw
    c, total = x.shape
    k, _, _, o = w.shape
    if not b7_takes(c, o, k, pad, stride, h, wd, x.dtype):
        raise ValueError(
            f"conv_flat: B7 does not take a {k}x{k} layer at pad {pad}, "
            f"stride {stride}, {c} -> {o} channels on {h}x{wd} maps in "
            f"{x.dtype}: it takes kh in {KERNEL_SIZES} (kh <= "
            f"{max(KERNEL_SIZES)}) with pad 0 or (k-1)/2, within its "
            "shared-memory and thread budgets (b7_takes)")
    check_tensor(x, "x", torch.bfloat16 if bf16 else torch.float32, 2)
    check_tensor(w, "w", torch.float32, 4)
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
