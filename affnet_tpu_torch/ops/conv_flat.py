"""The flat-layout convolution of the patch CNNs' eval stack: the plain
version of kernel B7.

Counterpart of ``affnet_tpu/ops/pallas_conv.py``'s ``conv_flat`` and its
``_edge_masks``.  Activations are flat as ``(C_pad, N*H*W)``: channels in
rows (zero-padded up to a multiple of 8), every pixel of every patch in
columns.  A stride-1 ``k x k`` convolution with zero padding per patch
gives the output ``(O, N*H*W)`` at the input's full extent; tap ``(r, s)``
of output pixel ``(y, x)`` reads input pixel ``(y + r - pad, x + s - pad)``
of the same patch, or zero outside it.  With ``pad = 0`` the first
``(H - k + 1)`` rows and columns are the VALID convolution (the caller
crops); a stride-2 layer is computed at stride 1 and subsampled by the
caller.  Eval BatchNorm is folded into ``w`` and ``bias`` by the caller;
the bias and the activation are applied here.

Numerics: an explicit im2col of the shifted, masked taps and one float32
matrix product.  With bf16 activations the operands are bf16 (the weights
are rounded to bf16), their products are exact in float32 and summed in
float32, and the bias and the activation are applied in float32 before the
output is rounded to bf16 -- what the TPU kernel computes
(``pallas_conv.py:100-115``).  The TPU kernel's tap groups, patch blocks
and VMEM budget are tiling and have no counterpart here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

ACTIVATIONS = ("none", "relu", "tanh", "elu")

# Bytes of im2col columns per chunk of patches: bounds the plain version's
# memory at any patch count.
CHUNK_BYTES = 1 << 28


def check_conv_args(x: Tensor, w: Tensor, img_hw: Tuple[int, int],
                    pad: int, act: str) -> None:
    """Raise unless the arguments meet ``conv_flat``'s contract."""
    h, wd = img_hw
    if x.dim() != 2 or w.dim() != 4:
        raise ValueError("conv_flat: x must be (C_pad, N*H*W) and w "
                         "(kh, kw, C, O)")
    c_pad, total = x.shape
    kh, kw, c, o = w.shape
    if c_pad % 8 or c > c_pad:
        raise ValueError(f"conv_flat: C_pad={c_pad} must be a multiple of 8 "
                         f"holding the weights' C={c}")
    if o % 8:
        raise ValueError(f"conv_flat: O={o} must be a multiple of 8")
    if h <= 0 or wd <= 0 or total % (h * wd):
        raise ValueError(f"conv_flat: {total} columns are not whole "
                         f"{h}x{wd} patches")
    if not (0 <= pad < kh and pad < kw):
        raise ValueError(f"conv_flat: need 0 <= pad < k, got pad={pad} for "
                         f"a {kh}x{kw} kernel")
    if act not in ACTIVATIONS:
        raise ValueError(f"conv_flat: unknown activation {act!r}")


def activation(y: Tensor, act: str) -> Tensor:
    """The fused activations, in the input's precision."""
    if act == "relu":
        return torch.clamp_min(y, 0.0)
    if act == "tanh":
        return torch.tanh(y)
    if act == "elu":
        return torch.where(y > 0, y, torch.expm1(y))
    return y


def conv_flat_plain(x: Tensor, w: Tensor, bias: Optional[Tensor],
                    img_hw: Tuple[int, int], pad: int,
                    act: str = "none") -> Tensor:
    """x (C_pad, N*H*W) float32 or bf16; w (kh, kw, C, O) float32 with C
    <= C_pad; bias (O,) float32 or None.  Returns (O, N*H*W) in x's dtype.
    """
    check_conv_args(x, w, img_hw, pad, act)
    h, wd = img_hw
    c_pad, total = x.shape
    kh, kw, c, o = w.shape
    n = total // (h * wd)
    # (O, taps * C_pad) in tap-major order, weights rounded to x's dtype.
    wt = F.pad(w.permute(3, 0, 1, 2), (0, c_pad - c))
    wt = wt.reshape(o, kh * kw * c_pad).to(x.dtype).float()
    b = (torch.zeros(o, dtype=torch.float32, device=x.device)
         if bias is None else bias.float())
    x4 = x.reshape(c_pad, n, h, wd)
    out = torch.empty((o, n, h, wd), dtype=x.dtype, device=x.device)
    per = max(1, CHUNK_BYTES // (kh * kw * c_pad * h * wd * 4))
    for p0 in range(0, n, per):
        xp = F.pad(x4[:, p0:p0 + per].float(),
                   (pad, kw - 1 - pad, pad, kh - 1 - pad))
        cols = torch.stack([xp[:, :, r:r + h, s:s + wd]
                            for r in range(kh) for s in range(kw)])
        y = wt @ cols.reshape(kh * kw * c_pad, -1) + b[:, None]
        out[:, p0:p0 + per] = activation(y, act).reshape(
            o, -1, h, wd).to(x.dtype)
    return out.reshape(o, total)
