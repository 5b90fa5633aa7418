"""The patch CNNs of the extraction path as ``nn.Module``s.

Each net keeps its layers in one ``nn.Sequential`` named ``features`` whose
indices equal the JAX spec's indices (``affnet_tpu/models/zoo.py``), so the
JAX parameter tree ``layer{i}`` maps onto ``features.{i}``
(:func:`affnet_tpu_torch.models.convert.params_from_jax`).

The nets take ``(N, PS, PS)`` patches and are built in eval mode:
BatchNorm on running statistics, dropout off.  ``net.train()`` switches
AffNetFast to the training forward of the JAX package's
``apply_with_state``: BatchNorm on batch statistics, updating the running
statistics in place (so two calls chain them, as ``np1`` feeds the second
pass there), and dropout when ``forward`` gets a generator.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..laf import rectify_up_is_up
from .cnn import Dropout, batch_norm, input_norm, l2norm

Tensor = torch.Tensor


def _conv(cin: int, cout: int, k: int, stride: int = 1, pad: int = 0,
          bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=pad, bias=bias)


class PatchNet(nn.Module):
    """``features`` over input-normalized patches, then ``head``.
    ``detach_input_norm`` stops the gradient through ``input_norm``'s
    statistics (the JAX nets' flag of the same name)."""

    ps = 32
    detach_input_norm = True

    def __init__(self, layers):
        super().__init__()
        self.features = nn.Sequential(*layers)
        self.eval()

    def head(self, feats: Tensor) -> Tensor:
        return feats

    def forward(self, patches: Tensor,
                generator: Optional[torch.Generator] = None) -> Tensor:
        """``generator`` draws the dropout masks in train mode; without one
        dropout is off."""
        x = input_norm(patches[:, None, :, :], detach=self.detach_input_norm)
        for layer in self.features:
            x = layer(x, generator) if isinstance(layer, Dropout) else layer(x)
        return self.head(x.flatten(1))


class AffNetFast(PatchNet):
    """AffNetFast: the shared 6-conv trunk, an 8x8 conv to 3 outputs, tanh
    and a global average, then the head ``[[1+x0, 0], [x1, 1+x2]]``
    rectified up-is-up.  Returns (N, 2, 2) affine shapes."""

    def __init__(self):
        super().__init__([
            _conv(1, 16, 3, 1, 1), batch_norm(16), nn.ReLU(),
            _conv(16, 16, 3, 1, 1), batch_norm(16), nn.ReLU(),
            _conv(16, 32, 3, 2, 1), batch_norm(32), nn.ReLU(),
            _conv(32, 32, 3, 1, 1), batch_norm(32), nn.ReLU(),
            _conv(32, 64, 3, 2, 1), batch_norm(64), nn.ReLU(),
            _conv(64, 64, 3, 1, 1), batch_norm(64), nn.ReLU(),
            Dropout(0.25), _conv(64, 3, 8, 1, 0, bias=True),
            nn.Tanh(), nn.AdaptiveAvgPool2d(1),
        ])

    def head(self, x: Tensor) -> Tensor:
        a11 = 1.0 + x[:, 0]
        a21 = x[:, 1]
        a22 = 1.0 + x[:, 2]
        zero = torch.zeros_like(a11)
        A = torch.stack([torch.stack([a11, zero], -1),
                         torch.stack([a21, a22], -1)], -2)
        return rectify_up_is_up(A)


class _Descriptor(PatchNet):
    def head(self, feats: Tensor) -> Tensor:
        return l2norm(feats)


class HardTFeatNet(_Descriptor):
    """TFeat-shaped descriptor with the HardNet loss: 128-D, L2-normalized.
    Its ``input_norm`` is not detached: as the frozen descriptor of AffNet
    training it passes the loss's gradient on to the patches through it."""

    detach_input_norm = False

    def __init__(self):
        super().__init__([
            _conv(1, 32, 7, bias=True), nn.Tanh(), nn.MaxPool2d(2, 2),
            _conv(32, 64, 6, bias=True), nn.Tanh(),
            Dropout(0.1), _conv(64, 128, 8, bias=True), nn.Tanh(),
        ])


class HardNet(_Descriptor):
    """HardNet: 7 conv layers with eval BN, 128-D, L2-normalized."""

    def __init__(self):
        super().__init__([
            _conv(1, 32, 3, 1, 1), batch_norm(32), nn.ReLU(),
            _conv(32, 32, 3, 1, 1), batch_norm(32), nn.ReLU(),
            _conv(32, 64, 3, 2, 1), batch_norm(64), nn.ReLU(),
            _conv(64, 64, 3, 1, 1), batch_norm(64), nn.ReLU(),
            _conv(64, 128, 3, 2, 1), batch_norm(128), nn.ReLU(),
            _conv(128, 128, 3, 1, 1), batch_norm(128), nn.ReLU(),
            Dropout(0.1), _conv(128, 128, 8), batch_norm(128),
        ])
