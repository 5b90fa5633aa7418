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

``net.with_dtype(torch.bfloat16)`` is the JAX nets' ``with_dtype``: in eval
mode the activation chain runs in bf16 from the input normalization on
(computed in float32) to the features, which the head gets in float32.
Each conv takes bf16 inputs and weights, accumulates in float32 and rounds
its output to bf16 (cuDNN's bf16 convolution); a bias, and eval
BatchNorm's mean and 1/sqrt(var + eps) (computed in float32), are rounded
to bf16 and applied in bf16, as the JAX layers cast them to the
activation's dtype (``models/cnn.py`` ``conv2d`` and ``batchnorm_eval``).
Train mode computes in float32.

In eval, ``cnn.EVAL_CONV_LAYOUT == "flat"`` runs the trunk through kernel
B7 (:func:`.cnn.apply_flat`), the JAX nets' flat layout, in float32 or in
the bf16 chain.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch
from torch import nn

from ..laf import rectify_up_is_up, rotation_matrix
from . import cnn
from .cnn import (Dropout, apply_flat, apply_layers, batch_norm, input_norm,
                  l2norm)

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
    init_gain = 0.8           # the orthogonal init's gain (cnn.init_params)
    compute_dtype: Optional[torch.dtype] = None

    def __init__(self, layers):
        super().__init__()
        self.features = nn.Sequential(*layers)
        self.eval()

    def head(self, feats: Tensor) -> Tensor:
        return feats

    def with_dtype(self, dtype: Optional[torch.dtype]) -> "PatchNet":
        """A copy of the net whose eval forward runs its activation chain
        in ``dtype`` (None: float32)."""
        net = copy.deepcopy(self)
        net.compute_dtype = dtype
        return net

    def feature_vectors(self, patches: Tensor,
                        generator: Optional[torch.Generator] = None,
                        use_kernels: bool = True) -> Tensor:
        """(N, K) float32 features before the head.  In eval mode with
        ``cnn.EVAL_CONV_LAYOUT == "flat"`` and no autograd recording, the
        layers run as the flat stack (:func:`.cnn.apply_flat`: kernel B7,
        or its plain version with ``use_kernels=False``); otherwise one by
        one.  ``generator`` draws the dropout masks in train mode; without
        one dropout is off."""
        x = input_norm(patches[:, None, :, :], detach=self.detach_input_norm)
        if self.training:
            x = apply_layers(self.features, x, None, generator)
        elif cnn.EVAL_CONV_LAYOUT == "flat" and not torch.is_grad_enabled():
            x = apply_flat(self.features, x, self.compute_dtype, use_kernels)
        else:
            x = apply_layers(self.features, x, self.compute_dtype)
        return x.float().flatten(1)

    def forward(self, patches: Tensor,
                generator: Optional[torch.Generator] = None,
                use_kernels: bool = True) -> Tensor:
        return self.head(self.feature_vectors(patches, generator,
                                              use_kernels))


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


def _orinet_layers(ps: int):
    return [
        _conv(1, 16, 3, 1, 1), batch_norm(16), nn.ReLU(),
        _conv(16, 16, 3, 1, 1), batch_norm(16), nn.ReLU(),
        _conv(16, 32, 3, 2, 1), batch_norm(32), nn.ReLU(),
        _conv(32, 32, 3, 1, 1), batch_norm(32), nn.ReLU(),
        _conv(32, 64, 3, 2, 1), batch_norm(64), nn.ReLU(),
        _conv(64, 64, 3, 1, 1), batch_norm(64), nn.ReLU(),
        Dropout(0.25), _conv(64, 2, ps // 4, 1, 1, bias=True),
        nn.Tanh(), nn.AdaptiveAvgPool2d(1),
    ]


class OriNet(PatchNet):
    """OriNet: AffNet's trunk, a pad-1 (ps/4 x ps/4) conv to 2 outputs,
    tanh and a global average (x0, x1); the angle is
    atan2(x0 + 1e-8, x1 + 1e-8) and the net returns its (N, 2, 2) rotation
    matrix.  Its ``input_norm`` is not detached."""

    detach_input_norm = False
    init_gain = 0.9

    def __init__(self, ps: int = 32):
        super().__init__(_orinet_layers(ps))
        self.ps = ps

    def angle(self, patches: Tensor, use_kernels: bool = True) -> Tensor:
        return self._angle(self.feature_vectors(patches,
                                                use_kernels=use_kernels))

    @staticmethod
    def _angle(xy: Tensor) -> Tensor:
        return torch.atan2(xy[:, 0] + 1e-8, xy[:, 1] + 1e-8)

    def head(self, xy: Tensor) -> Tensor:
        return rotation_matrix(self._angle(xy))


class OriNetFast(OriNet):
    """OriNet on 16x16 patches (4x4 head)."""

    def __init__(self):
        super().__init__(16)


class OriNetFast32(OriNet):
    """OriNet on 32x32 patches (8x8 head): the HesAffNet program's
    orientation net, with the shipped OriNetFast weights."""

    def __init__(self):
        super().__init__(32)


class _Registry(dict):
    """Name -> net class; a name the port lacks raises a KeyError that
    names the ported ones."""

    def __missing__(self, name):
        raise KeyError(f"{name!r} is not in the port's zoo, which has "
                       f"{sorted(self)} (the JAX package's ablation heads "
                       "and HardNetNarELU are not ported)")


REGISTRY = _Registry({net.__name__: net for net in (
    AffNetFast, OriNetFast, OriNetFast32, HardNet, HardTFeatNet)})
