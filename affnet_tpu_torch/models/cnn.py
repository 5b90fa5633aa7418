"""Shared pieces of the patch CNNs: per-patch input standardization, L2
normalization, BatchNorm, dropout from an explicit generator, and the
orthogonal initialization of a fresh net.

Counterparts of ``affnet_tpu/models/cnn.py``'s ``input_norm``, ``l2norm``,
``batchnorm_eval``/``batchnorm_train``, its ``Dropout`` layer and
``init_params``.  The convolutions themselves are plain ``nn.Conv2d``: the
JAX path runs them in XLA too (its Pallas conv is opt-in).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

Tensor = torch.Tensor

BN_EPS = 1e-5
BN_MOMENTUM = 0.1


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


def batch_norm(ch: int) -> nn.BatchNorm2d:
    """BatchNorm without affine parameters (the reference's everywhere).
    Eval mode normalizes with the running statistics; train mode with the
    batch's biased variance, and updates the running statistics in place
    with momentum 0.1 and the unbiased variance, as the JAX package's
    ``batchnorm_train`` returns them."""
    return nn.BatchNorm2d(ch, eps=BN_EPS, momentum=BN_MOMENTUM, affine=False)


class Dropout(nn.Module):
    """Dropout whose mask comes from an explicit ``torch.Generator``.  It
    acts only in train mode and only when given a generator, as the JAX
    package's dropout acts only when given a key (``rng=None`` is off)."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p

    def forward(self, x: Tensor,
                generator: Optional[torch.Generator] = None) -> Tensor:
        if not self.training or generator is None or self.p <= 0:
            return x
        keep = torch.rand(x.shape, generator=generator, device=x.device,
                          dtype=x.dtype) < 1.0 - self.p
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
