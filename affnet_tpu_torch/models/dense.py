"""Dense (fully convolutional) AffNet and its local contrast normalization.

Counterpart of ``affnet_tpu/models/dense.py``: ``local_norm_2d`` and
``AffNetFastFullConv``, the dense shape field of the OnePassSIR extractor
(``onepass.py``): reflect-pad 14, AffNetFast's trunk run densely, ``tanh``
of a bilinear resize back to the input's size, and each pixel's affine
shape rectified up-is-up.  The output is channels last, (N, H, W, 4) with
(a11, a12, a21, a22), as in JAX.

The trunk is AffNetFast's layers 0-19 (its weights load from
``weights/AffNetFast.npz``; :meth:`AffNetFastFullConv.pretrained`).  In JAX
it is ``lax.conv`` outside any Pallas kernel; here it runs through cuDNN
under the default "nchw" eval layout, and under "flat" through the flat
stack (``cnn.apply_flat``), where B7 takes the layers that its contract
(``ops/cuda_conv.py`` ``b7_takes``) accepts at the map's size and the rest
run stock.  It stays float32 in the extractor's fast mode, as in JAX
(there is no ``with_dtype``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import load_pretrained
from ..laf import rectify_up_is_up_dense
from . import cnn
from .cnn import Dropout, apply_flat, apply_layers, batch_norm
from .convert import params_from_jax

Tensor = torch.Tensor


def reflect_index(n: int, pad: int, device=None) -> Tensor:
    """Source index of each of the ``n + 2 * pad`` positions of a
    reflect-padded axis of length ``n``, as ``np.pad(mode="reflect")`` and
    ``jnp.pad`` give it also where ``pad >= n`` (the reflection repeats
    with period ``2 * (n - 1)``; ``F.pad`` refuses such pads)."""
    i = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = torch.remainder(i, period)
    return torch.where(i >= n, period - i, i)


def reflect_pad2d(x: Tensor, pad: int) -> Tensor:
    """Reflect-pad the last two axes by ``pad`` on every side, any
    ``pad``."""
    h, w = x.shape[-2:]
    rows = reflect_index(h, pad, x.device)
    cols = reflect_index(w, pad, x.device)
    return x.index_select(-2, rows).index_select(-1, cols)


def local_norm_2d(x: Tensor, kernel_size: int = 33,
                  eps: float = 1e-10) -> Tensor:
    """Local contrast normalization over a ``kernel_size`` square window of
    the reflect-padded map, clamped to [-6, 6]; x: (N, 1, H, W).  Each box
    sum is one pass over the whole window, as JAX's ``reduce_window`` and
    the reference's ``avg_pool2d`` take it: the variance cancels (E[x^2] -
    E[x]^2), so the order of the sums shows in the output: a row pass then
    a column pass lands 1.6e-3 off JAX on the 120x160 fixture, this one
    2.4e-7."""
    pd = kernel_size // 2
    scale = 1.0 / (kernel_size * kernel_size)

    def box(v):
        return F.avg_pool2d(reflect_pad2d(v, pd), kernel_size, stride=1,
                            divisor_override=1) * scale

    mean = box(x)
    var = box(x * x) - mean * mean
    return torch.clamp((x - mean) / (torch.sqrt(torch.abs(var)) + eps),
                       -6.0, 6.0)


def _conv(cin: int, cout: int, k: int, stride: int = 1, pad: int = 0,
          bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=pad, bias=bias)


class AffNetFastFullConv(nn.Module):
    """Dense AffNet: (N, H, W) (or (H, W)) image -> (N, H, W, 4) rectified
    per-pixel affine shapes."""

    ps = 32

    def __init__(self):
        super().__init__()
        self.features = nn.Sequential(
            _conv(1, 16, 3, 1, 1), batch_norm(16), nn.ReLU(),
            _conv(16, 16, 3, 1, 1), batch_norm(16), nn.ReLU(),
            _conv(16, 32, 3, 2, 1), batch_norm(32), nn.ReLU(),
            _conv(32, 32, 3, 1, 1), batch_norm(32), nn.ReLU(),
            _conv(32, 64, 3, 2, 1), batch_norm(64), nn.ReLU(),
            _conv(64, 64, 3, 1, 1), batch_norm(64), nn.ReLU(),
            Dropout(0.25), _conv(64, 3, 8, 1, 0, bias=True),
        )
        self.eval()

    @classmethod
    def pretrained(cls, weights_dir: Optional[str] = None
                   ) -> "AffNetFastFullConv":
        """The dense trunk with the shipped AffNetFast weights (its layers
        0-19 are this trunk's)."""
        net = cls()
        net.load_state_dict(params_from_jax(
            load_pretrained("AffNetFast", weights_dir)))
        return net

    def trunk(self, x: Tensor, use_kernels: bool = True) -> Tensor:
        """The layers on NCHW ``x``: the flat stack in eval mode under the
        "flat" layout with no autograd recording, else one by one."""
        if (not self.training and cnn.EVAL_CONV_LAYOUT == "flat"
                and not torch.is_grad_enabled()):
            return apply_flat(self.features, x, None, use_kernels)
        return apply_layers(self.features, x)

    def forward(self, img: Tensor, use_kernels: bool = True) -> Tensor:
        if img.dim() == 2:
            img = img[None]
        x = img[:, None, :, :]
        n, _, h, w = x.shape
        x = reflect_pad2d(local_norm_2d(x), 14)
        ff = self.trunk(x, use_kernels)                    # (N, 3, h', w')
        xy = torch.tanh(F.interpolate(ff, size=(h, w), mode="bilinear",
                                      align_corners=False, antialias=False))
        xy = xy.permute(0, 2, 3, 1)
        a0bc = torch.stack([1.0 + xy[..., 0], 0.0 * xy[..., 1], xy[..., 1],
                            1.0 + xy[..., 2]], dim=-1)
        return rectify_up_is_up_dense(a0bc)
