"""Shared pieces of the patch CNNs: per-patch input standardization, L2
and L1 normalization, BatchNorm, dropout from an explicit generator, the
orthogonal initialization of a fresh net, and the three eval layer stacks.

Counterparts of ``affnet_tpu/models/cnn.py``'s ``input_norm``, ``l2norm``,
``l1norm``, ``batchnorm_eval``/``batchnorm_train``, its ``Dropout`` layer,
``init_params``, ``apply_spec`` (:func:`apply_layers`),
``_apply_spec_flat`` (:func:`apply_flat`) and ``_apply_spec_cnhw``
(:func:`apply_cnhw`, with ``conv_cnhw``).

``EVAL_CONV_LAYOUT`` picks the eval stack, as in the JAX package: "nchw"
(the default) runs each layer as it stands (``nn.Conv2d``: cuDNN on the
card); "flat" runs the trunk convolutions through kernel B7 on the flat
``(C, N*H*W)`` layout (:func:`apply_flat`); "cnhw" keeps the activations
as ``(C, N, H, W)`` and runs each conv as one matrix product over the
stacked taps (:func:`apply_cnhw`).  It is read from ``AFFNET_EVAL_CONV``
at import, which refuses any other value; :func:`eval_layout` sets it for
a block or a function.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .. import parallel
from ..ops.conv_flat import activation, out_extent
from ..ops.cuda_conv import b7_takes, conv_flat

Tensor = torch.Tensor

BN_EPS = 1e-5
BN_MOMENTUM = 0.1

EVAL_CONV_LAYOUTS = ("nchw", "cnhw", "flat")


def _checked_layout(layout: str) -> str:
    if layout not in EVAL_CONV_LAYOUTS:
        raise ValueError(f"eval conv layout {layout!r}: the layouts are "
                         f"{EVAL_CONV_LAYOUTS}")
    return layout


EVAL_CONV_LAYOUT = _checked_layout(
    os.environ.get("AFFNET_EVAL_CONV", "nchw"))


@contextlib.contextmanager
def eval_layout(layout: str):
    """``EVAL_CONV_LAYOUT = layout`` for a ``with`` block, or for each call
    of a function it decorates (``eval_layout("flat")(fn)``); the previous
    layout is restored after."""
    global EVAL_CONV_LAYOUT
    old = EVAL_CONV_LAYOUT
    EVAL_CONV_LAYOUT = _checked_layout(layout)
    try:
        yield
    finally:
        EVAL_CONV_LAYOUT = old


def input_norm(x: Tensor, detach: bool = True) -> Tensor:
    """Per-sample standardization over all pixels: unbiased std + 1e-7.

    The 1e-12 under the root keeps a constant patch finite, and its
    gradient too when the statistics are not detached (a fully
    out-of-bounds rewarped patch is constant).  ``detach`` stops the
    gradient through the mean and std, as AffNet's forward does; the
    descriptor HardTFeatNet keeps it.  The forward value is the same
    either way."""
    n = x.shape[0]
    flat = x.reshape(n, -1)
    mp = flat.mean(dim=1)
    d = flat - mp[:, None]
    denom = max(flat.shape[1] - 1, 1)
    sp = torch.sqrt((d * d).sum(dim=1) / denom + 1e-12) + 1e-7
    if detach:
        mp = mp.detach()
        sp = sp.detach()
    shape = (n,) + (1,) * (x.dim() - 1)
    return (x - mp.reshape(shape)) / sp.reshape(shape)


def l2norm(x: Tensor, eps: float = 1e-10) -> Tensor:
    """Row-wise L2 normalization."""
    norm = torch.sqrt((x * x).sum(dim=1) + eps)
    return x / norm[:, None]


def l1norm(x: Tensor, eps: float = 1e-10) -> Tensor:
    """Row-wise L1 normalization."""
    norm = torch.abs(x).sum(dim=1) + eps
    return x / norm[:, None]


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` that, in train mode inside a sharded step over
    more than one rank (``parallel.sharded``), normalizes with the global
    batch's statistics (``parallel.batch_norm_global``); otherwise, one
    process included, it is PyTorch's native BatchNorm."""

    def forward(self, x: Tensor) -> Tensor:
        shard = parallel.current()
        if self.training and shard is not None and shard.world > 1:
            return parallel.batch_norm_global(self, x)
        return super().forward(x)


def batch_norm(ch: int) -> nn.BatchNorm2d:
    """BatchNorm without affine parameters (the reference's everywhere).
    Eval mode normalizes with the running statistics; train mode with the
    batch's biased variance, and updates the running statistics in place
    with momentum 0.1 and the unbiased variance, as the JAX package's
    ``batchnorm_train`` returns them."""
    return BatchNorm2d(ch, eps=BN_EPS, momentum=BN_MOMENTUM, affine=False)


class Dropout(nn.Module):
    """Dropout whose mask comes from an explicit ``torch.Generator``.  It
    acts only in train mode and only when given a generator, as the JAX
    package's dropout acts only when given a key (``rng=None`` is off).
    Inside a sharded step the mask is drawn for the global batch and this
    rank's rows are kept (``parallel.local``)."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p

    def forward(self, x: Tensor,
                generator: Optional[torch.Generator] = None) -> Tensor:
        if not self.training or generator is None or self.p <= 0:
            return x
        shape = (parallel.global_count(x.shape[0]),) + tuple(x.shape[1:])
        keep = parallel.local(torch.rand(
            shape, generator=generator, device=x.device,
            dtype=x.dtype) < 1.0 - self.p)
        return torch.where(keep, x / (1.0 - self.p), torch.zeros_like(x))


def _orthogonal(shape_oihw, gain: float,
                generator: torch.Generator) -> Tensor:
    """Orthogonal init of an OIHW conv weight: QR of a normal matrix with
    the signs of R's diagonal folded in (the JAX package's ``_orthogonal``)."""
    o = shape_oihw[0]
    f = 1
    for s in shape_oihw[1:]:
        f *= s
    a = torch.randn((max(o, f), min(o, f)), generator=generator,
                    dtype=torch.float32)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    if o < f:
        q = q.T
    return (gain * q[:o, :f]).reshape(shape_oihw)


@torch.no_grad()
def init_params(net: nn.Module, generator: torch.Generator,
                gain: float = 0.8, last_gain: float = 1.0,
                last_bias: Optional[Sequence[float]] = None,
                bias_const: float = 0.01) -> nn.Module:
    """Initialize ``net.features`` in place: orthogonal(``gain``) conv
    weights, biases ``bias_const``; the last conv gets ``last_gain`` and
    ``last_bias`` when ``last_bias`` is given; BatchNorm running mean 0 and
    variance 1.  ``generator`` is a CPU generator, so a seed gives the same
    weights on any device."""
    layers = list(net.features)
    convs = [i for i, l in enumerate(layers) if isinstance(l, nn.Conv2d)]
    last = convs[-1] if convs else -1
    for i, layer in enumerate(layers):
        if isinstance(layer, nn.Conv2d):
            is_last = i == last and last_bias is not None
            w = _orthogonal(tuple(layer.weight.shape),
                            last_gain if is_last else gain, generator)
            layer.weight.copy_(w)
            if layer.bias is not None:
                if is_last:
                    layer.bias.copy_(torch.tensor(list(last_bias),
                                                  dtype=torch.float32))
                else:
                    layer.bias.fill_(bias_const)
        elif isinstance(layer, nn.BatchNorm2d):
            layer.reset_running_stats()
    return net


# ---------------------------------------------------------------------------
# The eval layer stacks
# ---------------------------------------------------------------------------

def _channel(v: Tensor, dtype: torch.dtype) -> Tensor:
    return v.to(dtype)[None, :, None, None]


def _conv_in(x: Tensor, conv: nn.Conv2d, dtype: torch.dtype) -> Tensor:
    """``conv`` with ``dtype`` inputs and weights, float32 accumulation,
    output rounded to ``dtype``, then the bias in ``dtype``."""
    y = F.conv2d(x, conv.weight.to(dtype), None, conv.stride, conv.padding)
    return y if conv.bias is None else y + _channel(conv.bias, dtype)


def _batchnorm_eval_in(x: Tensor, bn: nn.BatchNorm2d,
                       dtype: torch.dtype) -> Tensor:
    """Eval BatchNorm with the float32 statistics rounded to ``dtype``."""
    inv = torch.rsqrt(bn.running_var + bn.eps)
    return (x - _channel(bn.running_mean, dtype)) * _channel(inv, dtype)


def apply_layers(layers, x: Tensor, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None) -> Tensor:
    """The layers one by one on NCHW ``x``.  With ``dtype`` (bf16, eval
    only) every conv and eval BatchNorm computes in ``dtype`` as the JAX
    layers do with a ``compute_dtype``; ``generator`` draws dropout masks
    in train mode."""
    if dtype is not None:
        x = x.to(dtype)
    for layer in layers:
        if isinstance(layer, Dropout):
            x = layer(x, generator)
        elif dtype is not None and isinstance(layer, nn.Conv2d):
            x = _conv_in(x, layer, dtype)
        elif dtype is not None and isinstance(layer, nn.BatchNorm2d):
            x = _batchnorm_eval_in(x, layer, dtype)
        else:
            x = layer(x)
    return x


_ACTS = {nn.ReLU: "relu", nn.Tanh: "tanh", nn.ELU: "elu"}


def _rsqrt_rounded(v: Tensor) -> Tensor:
    """1/sqrt(v) of a float32 ``v``, rounded once to float32: the same bits
    on the CPU and the card.  ``torch.rsqrt`` in float32 and XLA's CPU
    rsqrt (an estimate refined by one Newton step) each miss the correctly
    rounded value by one ulp for a share of inputs, and not for the same
    ones; a folded weight that lies near a bf16 rounding boundary then
    rounds to the neighbouring bf16 value on one side only."""
    return torch.rsqrt(v.double()).float()


def _fold(layers, i: int):
    """Conv ``layers[i]`` with a following eval BatchNorm folded into its
    HWIO weights and bias (float32) and a following activation taken for
    fusing; returns (w, bias, act, index after them)."""
    conv = layers[i]
    w = conv.weight.float().permute(2, 3, 1, 0)
    bias = (torch.zeros(conv.out_channels, device=w.device)
            if conv.bias is None else conv.bias.float())
    j = i + 1
    if j < len(layers) and isinstance(layers[j], nn.BatchNorm2d):
        bn = layers[j]
        scale = _rsqrt_rounded(bn.running_var + bn.eps)
        w = w * scale
        bias = (bias - bn.running_mean) * scale
        j += 1
    act = "none"
    if j < len(layers) and type(layers[j]) in _ACTS:
        act = _ACTS[type(layers[j])]
        j += 1
    return w, bias, act, j


def apply_flat(layers, x: Tensor, dtype: Optional[torch.dtype] = None,
               use_kernel: bool = True) -> Tensor:
    """Eval-only layer stack on the flat ``(C, N*H*W)`` layout, the JAX
    package's ``_apply_spec_flat``.  Takes and returns NCHW like
    :func:`apply_layers`; ``dtype`` (bf16) is the activations' dtype.

    - A conv with the following eval BatchNorm folded into its weights and
      bias (in float32; in bf16 the folded weights are then rounded) and
      the following activation fused runs as one launch of B7
      (``ops/cuda_conv.py``; the plain version for CPU tensors or
      ``use_kernel=False``) on the real input channels, at the layer's
      stride and padding: it writes only the outputs that JAX keeps of its
      full-extent ``conv_flat`` after the crop of a VALID conv and the
      subsample of a stride-2 conv.
    - A full-cover VALID conv (the 8x8 heads) is one float32 matrix
      product of depth kh*kw*C (bf16 operands in bf16 mode), as in JAX.
    - A 2x2 max pool works on the flat layout; dropout is the identity.
    - The stack stops at the first layer it does not cover: an output
      width not a multiple of 8, a non-square kernel, a stride other than
      1 or 2, a kernel as large as the map, a map with an odd number of
      pixels (where the TPU kernel's 128-lane blocks must hold 128 patches
      and exceed its VMEM budget: TFeat's 6x6 layer on 13x13 maps, JAX's
      ``block_patches`` verdict), or a layer that B7 does not take
      (:func:`..ops.cuda_conv.b7_takes`, the kernel's own contract: a
      5x5 kernel, a 7x7 one at pad 1, a map past its budgets), on every
      device, so the plan does not depend on where it runs.  The
      remaining layers run through :func:`apply_layers`.  JAX's flat
      stack takes the last kind through its Pallas conv, which gives the
      stock result for a SAME or VALID layer; it keeps a 7x7 pad-1
      layer's output at the map's full extent (it crops only pad-0
      layers), and there the port matches JAX's stock layout instead.
    """
    layers = list(layers)
    n, c, h, w = x.shape
    if c != 1:
        raise ValueError("apply_flat: patch CNNs take one input channel")
    dt = dtype if dtype is not None else x.dtype
    xf = x.to(dt).reshape(1, n * h * w)
    head = None
    i = 0
    while i < len(layers):
        layer = layers[i]
        if isinstance(layer, nn.Conv2d):
            kh, kw = layer.kernel_size
            stride, pad = layer.stride[0], layer.padding[0]
            o = layer.out_channels
            wgt, bias, act, j = _fold(layers, i)
            if kh == kw == h == w and pad == 0 and stride == 1:
                cin = layer.in_channels
                xk = xf.reshape(cin, n, h * w).permute(2, 0, 1)
                wk = wgt.reshape(kh * kw * cin, o).T.to(dt).float()
                y = wk @ xk.reshape(h * w * cin, n).float() + bias[:, None]
                head = activation(y, act).to(dt)          # (O, N)
                c, h, w = o, 1, 1
                i = j
                continue
            if (o % 8 or kh != kw or layer.stride not in ((1, 1), (2, 2))
                    or layer.padding != (pad, pad) or kh >= min(h, w)
                    or (h * w) % 2
                    or not b7_takes(c, o, kh, pad, stride, h, w, dt)):
                break
            xf = conv_flat(xf, wgt, bias, (h, w), pad, act, stride,
                           use_kernel=use_kernel)
            c = o
            h, w = out_extent((h, w), kh, pad, stride)
            i = j
        elif (isinstance(layer, nn.MaxPool2d)
              and (layer.kernel_size, layer.stride, layer.padding)
              == (2, 2, 0)):
            y4 = F.max_pool2d(xf.reshape(c, n, h, w), 2, 2)
            h, w = y4.shape[2], y4.shape[3]
            xf = y4.reshape(c, n * h * w)
            i += 1
        elif isinstance(layer, Dropout):
            i += 1
        else:
            break
    if head is not None:
        x_tail = head.T.reshape(n, c, 1, 1)
    else:
        x_tail = xf.reshape(c, n, h, w).transpose(0, 1)
    return apply_layers(layers[i:], x_tail, dtype)


def conv_cnhw(x: Tensor, conv: nn.Conv2d) -> Tensor:
    """``conv`` on ``(C, N, H, W)`` ``x`` as one matrix product
    ``(O, kh*kw*C) @ (kh*kw*C, N*Hs*Ws)`` over the stacked taps at stride
    1 (the transposed im2col of JAX's ``conv_cnhw``), in ``x``'s dtype
    (bf16 operands with float32 sums and the output rounded to bf16, or
    float32 as the caller's TF32 flags allow: ``utils.float32_math``
    keeps it float32); a stride-2 conv then keeps the even rows and
    columns, as JAX's one-hot selection products do exactly; the bias is
    added last in ``x``'s dtype.  The stacked taps hold kh*kw*C*N*Hs*Ws
    values, as JAX materializes them."""
    c, n, h, w = x.shape
    kh, kw = conv.kernel_size
    pad = conv.padding[0]
    stride = conv.stride[0]
    if conv.padding != (pad, pad) or stride not in (1, 2) \
            or conv.stride != (stride, stride):
        raise ValueError(f"conv_cnhw: stride {conv.stride} padding "
                         f"{conv.padding}: symmetric padding and stride 1 "
                         "or 2 only")
    if pad:
        x = F.pad(x, (pad, pad, pad, pad))
    hs, ws = h + 2 * pad - kh + 1, w + 2 * pad - kw + 1
    taps = torch.cat([x[:, :, r:r + hs, s:s + ws]
                      for r in range(kh) for s in range(kw)], 0)
    o = conv.out_channels
    wt = conv.weight.permute(0, 2, 3, 1).reshape(o, kh * kw * c).to(x.dtype)
    y = (wt @ taps.reshape(kh * kw * c, n * hs * ws)).reshape(o, n, hs, ws)
    if stride == 2:
        y = y[:, :, ::2, ::2]
    if conv.bias is not None:
        y = y + conv.bias.to(x.dtype)[:, None, None, None]
    return y


def apply_cnhw(layers, x: Tensor, dtype: Optional[torch.dtype] = None
               ) -> Tensor:
    """Eval-only layer stack in the transposed ``(C, N, H, W)`` layout,
    the JAX package's ``_apply_spec_cnhw``: takes and returns NCHW like
    :func:`apply_layers`; ``dtype`` (bf16) is the activations' dtype.
    Convs through :func:`conv_cnhw`; eval BatchNorm as (x - mean) *
    1/sqrt(var + eps), the statistics computed in float32 and rounded to
    the activations' dtype; dropout the identity; the global average over
    (H, W); a 2x2 max pool of stride 2 (the only pool it takes, as in
    JAX)."""
    x = x.transpose(0, 1)
    if dtype is not None:
        x = x.to(dtype)
    for layer in layers:
        if isinstance(layer, nn.Conv2d):
            x = conv_cnhw(x, layer)
        elif isinstance(layer, nn.BatchNorm2d):
            inv = torch.rsqrt(layer.running_var + layer.eps)
            x = ((x - layer.running_mean.to(x.dtype)[:, None, None, None])
                 * inv.to(x.dtype)[:, None, None, None])
        elif isinstance(layer, (nn.ReLU, nn.Tanh, nn.ELU)):
            x = layer(x)
        elif isinstance(layer, Dropout):
            pass
        elif isinstance(layer, nn.AdaptiveAvgPool2d) \
                and layer.output_size in (1, (1, 1)):
            x = x.mean(dim=(2, 3), keepdim=True)
        elif (isinstance(layer, nn.MaxPool2d)
              and (layer.kernel_size, layer.stride, layer.padding)
              == (2, 2, 0)):
            x = F.max_pool2d(x, 2, 2)
        else:
            raise TypeError(f"apply_cnhw: layer {layer!r}")
    return x.transpose(0, 1)
