"""The flat-layout convolution of the patch CNNs' eval stack: the plain
versions of kernel B7.

Activations are flat as ``(C, N*H*W)``: channels in rows, every pixel of
every patch in columns.  Two functions:

- :func:`conv_flat_plain` is the counterpart of
  ``affnet_tpu/ops/pallas_conv.py``'s ``conv_flat`` and its
  ``_edge_masks``: rows zero-padded to ``C_pad``, a multiple of 8, and a
  stride-1 ``k x k`` convolution with zero padding per patch at the
  input's full extent, ``(O, N*H*W)``; tap ``(r, s)`` of output pixel
  ``(y, x)`` reads input pixel ``(y + r - pad, x + s - pad)`` of the same
  patch, or zero outside it.  JAX's flat stack crops a VALID layer's
  output to its first ``H - k + 1`` rows and columns and keeps the even
  rows and columns of a stride-2 layer's.
- :func:`conv_layer_plain` is the layer's own work, what kernel B7
  computes: ``conv_flat_plain`` on the real channels followed by exactly
  that crop and subsample, ``(O, N*Ho*Wo)`` from ``(C, N*H*W)`` with
  ``Ho = (H + 2*pad - k) // stride + 1``.

Eval BatchNorm is folded into ``w`` and ``bias`` by the caller; the bias
and the activation are applied here.

Numerics: an explicit im2col of the shifted, masked taps and float32
matrix products, one for each of the TPU kernel's tap groups (at most 256
rows of K each, ``pallas_conv.py:_tap_groups``), summed in group order as
the TPU kernel does (``pallas_conv.py:106-111``).  With bf16 activations
the operands are bf16 (the weights are rounded to bf16), their products
are exact in float32 and summed in float32, and the bias and the
activation are applied in float32 before the output is rounded to bf16 --
what the TPU kernel computes (``pallas_conv.py:100-115``).  Its patch
blocks and VMEM budget are tiling and have no counterpart here.
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
K_TARGET = 256


def tap_groups(n_taps: int, c_pad: int):
    """(first tap, tap count) of each group of taps whose contraction depth
    is at most 256, as even as possible: the TPU kernel's tap groups
    (``pallas_conv.py:_tap_groups``), one float32 product each, summed in
    group order."""
    per = max(1, K_TARGET // c_pad)
    n_groups = -(-n_taps // per)
    base, rem = divmod(n_taps, n_groups)
    groups, at = [], 0
    for g in range(n_groups):
        size = base + (1 if g < rem else 0)
        groups.append((at, size))
        at += size
    return groups


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


def out_extent(img_hw: Tuple[int, int], k: int, pad: int,
               stride: int) -> Tuple[int, int]:
    """(Ho, Wo) of a ``k x k`` layer with ``pad`` and ``stride``."""
    h, wd = img_hw
    return ((h + 2 * pad - k) // stride + 1,
            (wd + 2 * pad - k) // stride + 1)


def check_layer_args(x: Tensor, w: Tensor, img_hw: Tuple[int, int],
                     pad: int, act: str, stride: int) -> None:
    """Raise unless the arguments meet the layer contract of
    :func:`conv_layer_plain` (and kernel B7)."""
    h, wd = img_hw
    if x.dim() != 2 or w.dim() != 4:
        raise ValueError("conv_flat: x must be (C, N*H*W) and w "
                         "(kh, kw, C, O)")
    c, total = x.shape
    kh, kw, cw, o = w.shape
    if c != cw:
        raise ValueError(f"conv_flat: x has C={c} rows, the weights "
                         f"C={cw}")
    if o % 8:
        raise ValueError(f"conv_flat: O={o} must be a multiple of 8")
    if h <= 0 or wd <= 0 or total % (h * wd):
        raise ValueError(f"conv_flat: {total} columns are not whole "
                         f"{h}x{wd} patches")
    if stride not in (1, 2):
        raise ValueError(f"conv_flat: stride must be 1 or 2, got {stride}")
    if kh != kw or not 0 <= 2 * pad <= kh - 1:
        raise ValueError(f"conv_flat: need a square kernel and "
                         f"0 <= 2*pad <= k-1, got pad={pad} for a "
                         f"{kh}x{kw} kernel")
    if kh > h + 2 * pad or kw > wd + 2 * pad:
        raise ValueError(f"conv_flat: a {kh}x{kw} kernel does not fit "
                         f"{h}x{wd} maps with pad={pad}")
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
    groups = tap_groups(kh * kw, c_pad)
    per = max(1, CHUNK_BYTES // (kh * kw * c_pad * h * wd * 4))
    for p0 in range(0, n, per):
        xp = F.pad(x4[:, p0:p0 + per].float(),
                   (pad, kw - 1 - pad, pad, kh - 1 - pad))
        cols = torch.stack([xp[:, :, r:r + h, s:s + wd]
                            for r in range(kh) for s in range(kw)])
        cols = cols.reshape(kh * kw * c_pad, -1)
        acc = None
        for t0, nt in groups:
            rows = slice(t0 * c_pad, (t0 + nt) * c_pad)
            part = wt[:, rows] @ cols[rows]
            acc = part if acc is None else acc + part
        y = acc + b[:, None]
        out[:, p0:p0 + per] = activation(y, act).reshape(
            o, -1, h, wd).to(x.dtype)
    return out.reshape(o, total)


def conv_layer_plain(x: Tensor, w: Tensor, bias: Optional[Tensor],
                     img_hw: Tuple[int, int], pad: int, act: str = "none",
                     stride: int = 1) -> Tensor:
    """x (C, N*H*W) float32 or bf16; w (kh, kw, C, O) float32; bias (O,)
    float32 or None.  Returns (O, N*Ho*Wo) in x's dtype: the layer's kept
    outputs, :func:`conv_flat_plain` on x's rows zero-padded to C_pad
    followed by JAX's crop to ``Ho_1 = H + 2*pad - k + 1`` rows and
    columns (``_onehot_first``) and, at stride 2, its even rows and columns
    (``_downsample2_onehot``)."""
    check_layer_args(x, w, img_hw, pad, act, stride)
    h, wd = img_hw
    c, total = x.shape
    kh, kw, _, o = w.shape
    n = total // (h * wd)
    c_pad = -(-c // 8) * 8
    xp = F.pad(x, (0, 0, 0, c_pad - c)) if c_pad != c else x
    y = conv_flat_plain(xp, w, bias, img_hw, pad, act).reshape(o, n, h, wd)
    h1, w1 = h + 2 * pad - kh + 1, wd + 2 * pad - kw + 1
    y = y[:, :, :h1:stride, :w1:stride]
    return y.reshape(o, -1)
