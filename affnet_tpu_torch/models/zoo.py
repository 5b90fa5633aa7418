"""The patch CNNs of the JAX package's zoo as ``nn.Module``s: the AffNet
family (AffNetFast and its ten ablation variants), OriNetFast and
OriNetFast32, HardNet, HardTFeatNet and HardNetNarELU.

Each net keeps its layers in one ``nn.Sequential`` named ``features`` whose
indices equal the JAX spec's indices (``affnet_tpu/models/zoo.py``), so the
JAX parameter tree ``layer{i}`` maps onto ``features.{i}``
(:func:`affnet_tpu_torch.models.convert.params_from_jax`).

The nets take ``(N, PS, PS)`` patches and are built in eval mode:
BatchNorm on running statistics, dropout off.  ``net.train()`` switches a
net to the training forward of the JAX package's ``apply_with_state``:
BatchNorm on batch statistics, updating the running statistics in place
(so two calls chain them, as ``np1`` feeds the second pass there), and
dropout when ``forward`` gets a generator.

``net.with_dtype(torch.bfloat16)`` is the JAX nets' ``with_dtype``: in eval
mode the activation chain runs in bf16 from the input normalization on
(computed in float32) to the features, which the head gets in float32.
Each conv takes bf16 inputs and weights, accumulates in float32 and rounds
its output to bf16 (cuDNN's bf16 convolution); a bias, and eval
BatchNorm's mean and 1/sqrt(var + eps) (computed in float32), are rounded
to bf16 and applied in bf16, as the JAX layers cast them to the
activation's dtype (``models/cnn.py`` ``conv2d`` and ``batchnorm_eval``).
Train mode computes in float32.  HardNetNarELU ignores the dtype, as its
JAX ``features`` does.

In eval, ``cnn.EVAL_CONV_LAYOUT`` picks the layer stack: "nchw" layer by
layer, "flat" through kernel B7 (:func:`.cnn.apply_flat`, no autograd
recording), "cnhw" as one matrix product per conv (:func:`.cnn.apply_cnhw`),
each in float32 or in the bf16 chain.

A fresh net's weights come from :meth:`PatchNet.init`: the orthogonal
init at the net's ``init_gain``, and the last conv at ``last_gain`` with
the bias ``last_bias`` where the JAX net sets one.
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..laf import rectify_up_is_up, rotation_matrix
from ..utils import check_finite
from . import cnn
from .cnn import (Dropout, apply_cnhw, apply_flat, apply_layers, batch_norm,
                  init_params, input_norm, l2norm)

Tensor = torch.Tensor


def _conv(cin: int, cout: int, k: int, stride: int = 1, pad: int = 0,
          bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=pad, bias=bias)


def run_layers(layers, x: Tensor, training: bool,
               dtype: Optional[torch.dtype] = None,
               generator: Optional[torch.Generator] = None,
               use_kernels: bool = True) -> Tensor:
    """``layers`` on NCHW ``x`` through the stack that the mode and
    ``cnn.EVAL_CONV_LAYOUT`` pick (see the module docstring)."""
    if training:
        return apply_layers(layers, x, None, generator)
    if cnn.EVAL_CONV_LAYOUT == "flat" and not torch.is_grad_enabled():
        return apply_flat(layers, x, dtype, use_kernels)
    if cnn.EVAL_CONV_LAYOUT == "cnhw":
        return apply_cnhw(layers, x, dtype)
    return apply_layers(layers, x, dtype)


class PatchNet(nn.Module):
    """``features`` over input-normalized patches, then ``head``.
    ``detach_input_norm`` stops the gradient through ``input_norm``'s
    statistics (the JAX nets' flag of the same name)."""

    ps = 32
    detach_input_norm = True
    init_gain = 0.8           # the orthogonal init's gain (cnn.init_params)
    last_gain = 1.0           # the last conv's, where last_bias is set
    last_bias: Optional[Tuple[float, ...]] = None
    compute_dtype: Optional[torch.dtype] = None

    def __init__(self, layers):
        super().__init__()
        self.features = nn.Sequential(*layers)
        self.eval()

    def head(self, feats: Tensor) -> Tensor:
        return feats

    def init(self, generator: torch.Generator) -> "PatchNet":
        """The JAX net's ``init``: :func:`.cnn.init_params` in place with
        this net's gains and last bias; ``generator`` is a CPU generator.
        Returns the net."""
        return init_params(self, generator, gain=self.init_gain,
                           last_gain=self.last_gain,
                           last_bias=self.last_bias)

    def with_dtype(self, dtype: Optional[torch.dtype]) -> "PatchNet":
        """A copy of the net whose eval forward runs its activation chain
        in ``dtype`` (None: float32)."""
        net = copy.deepcopy(self)
        net.compute_dtype = dtype
        return net

    def feature_vectors(self, patches: Tensor,
                        generator: Optional[torch.Generator] = None,
                        use_kernels: bool = True) -> Tensor:
        """(N, K) float32 features before the head (:func:`run_layers`;
        the flat stack runs kernel B7, or its plain version with
        ``use_kernels=False``).  ``generator`` draws the dropout masks in
        train mode; without one dropout is off."""
        x = input_norm(patches[:, None, :, :], detach=self.detach_input_norm)
        x = run_layers(self.features, x, self.training, self.compute_dtype,
                       generator, use_kernels)
        return x.float().flatten(1)

    def forward(self, patches: Tensor,
                generator: Optional[torch.Generator] = None,
                use_kernels: bool = True) -> Tensor:
        return check_finite(self.head(self.feature_vectors(
            patches, generator, use_kernels)), type(self).__name__)


# ---------------------------------------------------------------------------
# The AffNet family
# ---------------------------------------------------------------------------

_TAIL = {"tanh": nn.Tanh, "avg": lambda: nn.AdaptiveAvgPool2d(1)}


def _trunk(with_bn6: bool, out_dim: int, tail: Sequence[str]) -> list:
    """The AffNet trunk 1->16->16->32/2->32->64/2->64 (BatchNorm and ReLU
    after each conv; after the sixth only a ReLU unless ``with_bn6``),
    dropout, an 8x8 conv to ``out_dim`` with a bias, then ``tail`` ("tanh"
    and "avg", the global average, in order): JAX's ``_trunk``."""
    layers = [
        _conv(1, 16, 3, 1, 1), batch_norm(16), nn.ReLU(),
        _conv(16, 16, 3, 1, 1), batch_norm(16), nn.ReLU(),
        _conv(16, 32, 3, 2, 1), batch_norm(32), nn.ReLU(),
        _conv(32, 32, 3, 1, 1), batch_norm(32), nn.ReLU(),
        _conv(32, 64, 3, 2, 1), batch_norm(64), nn.ReLU(),
        _conv(64, 64, 3, 1, 1),
    ]
    layers += [batch_norm(64), nn.ReLU()] if with_bn6 else [nn.ReLU()]
    layers += [Dropout(0.25), _conv(64, out_dim, 8, bias=True)]
    return layers + [_TAIL[t]() for t in tail]


def _stack2x2(a11: Tensor, a12: Tensor, a21: Tensor, a22: Tensor) -> Tensor:
    return torch.stack([torch.stack([a11, a12], -1),
                        torch.stack([a21, a22], -1)], -2)


def _lower(a11: Tensor, a21: Tensor, a22: Tensor) -> Tensor:
    """[[a11, 0], [a21, a22]]."""
    return _stack2x2(a11, torch.zeros_like(a11), a21, a22)


def _sym_from_3(x: Tensor) -> Tensor:
    """[[x0, x1], [x1, x2]] from columns 0:3."""
    return _stack2x2(x[:, 0], x[:, 1], x[:, 1], x[:, 2])


def _rot_of(y: Tensor, x: Tensor) -> Tensor:
    """The rotation by atan2(y, x + 1e-8), the heads' angle."""
    return rotation_matrix(torch.atan2(y, x + 1e-8))


class AffNet(PatchNet):
    """The AffNet family: :func:`_trunk` with the class's ``with_bn6``,
    ``out_dim`` and ``tail``, and its head from the (N, out_dim) features
    to (N, 2, 2) affine shapes.  ``train_affnet --arch`` and ``eval_graf
    --shape-arch`` take every subclass in ``REGISTRY``."""

    with_bn6 = True
    out_dim = 3
    tail: Tuple[str, ...] = ("tanh", "avg")

    def __init__(self):
        super().__init__(_trunk(self.with_bn6, self.out_dim, self.tail))


class AffNetFast(AffNet):
    """AffNetFast: tanh and the global average of 3 outputs, then the head
    ``[[1+x0, 0], [x1, 1+x2]]`` rectified up-is-up (the shipped net)."""

    def head(self, x: Tensor) -> Tensor:
        return rectify_up_is_up(_lower(1.0 + x[:, 0], x[:, 1],
                                       1.0 + x[:, 2]))


class AffNetFast4(AffNet):
    """No sixth BatchNorm, 4 outputs averaged, the raw 2x2 rectified."""

    with_bn6, out_dim, tail = False, 4, ("avg",)
    last_bias = (1.0, 0.0, 0.0, 1.0)

    def head(self, x: Tensor) -> Tensor:
        return rectify_up_is_up(x.reshape(-1, 2, 2))


class AffNetFastScale(AffNet):
    """AffNetFast's head times exp(x3): 4 outputs, tanh, averaged."""

    out_dim = 4

    def head(self, x: Tensor) -> Tensor:
        A = _lower(1.0 + x[:, 0], x[:, 1], 1.0 + x[:, 2])
        return torch.exp(x[:, 3])[:, None, None] * rectify_up_is_up(A)


class AffNetFast4Rot(AffNet):
    """The raw 2x2, averaged then tanh (not rectified)."""

    with_bn6, out_dim, tail = False, 4, ("avg", "tanh")
    last_bias = (0.8, 0.0, 0.0, 0.8)

    def head(self, x: Tensor) -> Tensor:
        return x.reshape(-1, 2, 2)


class AffNetFast4RotNosc(AffNet):
    """The raw 2x2 divided by sqrt|det| (+1e-10 under the root, +1e-8
    after it)."""

    with_bn6, out_dim, tail = False, 4, ("avg",)
    last_bias = (1.0, 0.0, 0.0, 1.0)

    def head(self, x: Tensor) -> Tensor:
        A = x.reshape(-1, 2, 2)
        det = A[:, 0, 0] * A[:, 1, 1] - A[:, 1, 0] * A[:, 0, 1]
        scale = torch.sqrt(torch.abs(det + 1e-10))
        return A / (scale[:, None, None] + 1e-8)


class AffNetFast52RotUp(AffNet):
    """The rotation atan2(x3, x4 + 1e-8) times the symmetric
    [[x0, x1], [x1, x2]] rectified up-is-up; a per-pair rotation in
    training (its name holds "Rot")."""

    with_bn6, out_dim, tail = False, 5, ("avg",)
    last_bias = (1.0, 0.0, 1.0, 0.0, 1.0)

    def head(self, x: Tensor) -> Tensor:
        return _rot_of(x[:, 3], x[:, 4]) @ rectify_up_is_up(_sym_from_3(x))


class AffNetFast52Rot(AffNet):
    """The rotation atan2(x3, x4 + 1e-8) times [[x0, x1], [x1, x2]];
    averaged, then tanh."""

    with_bn6, out_dim, tail = False, 5, ("avg", "tanh")
    last_bias = (0.8, 0.0, 0.8, 0.0, 1.0)

    def head(self, x: Tensor) -> Tensor:
        return _rot_of(x[:, 3], x[:, 4]) @ _sym_from_3(x)


class AffNetFast52RotL(AffNetFast52Rot):
    """AffNetFast52Rot's head on averaged outputs, no tanh."""

    tail = ("avg",)


class AffNetFast5Rot(AffNet):
    """The rotation atan2(x3, x4 + 1e-8) times [[x0, 0], [x1, x2]]."""

    with_bn6, out_dim, tail = False, 5, ("avg",)
    last_bias = (1.0, 0.0, 1.0, 0.0, 1.0)

    def head(self, x: Tensor) -> Tensor:
        return _rot_of(x[:, 3], x[:, 4]) @ _lower(x[:, 0], x[:, 1], x[:, 2])


class AffNetFast2Par(AffNet):
    """Two parameters: the rotation atan2(x1, x2 + 1e-8) times the tilt
    diag(sqrt t, 1/sqrt t), t = exp(1.8 tanh x0), rectified up-is-up."""

    with_bn6, out_dim, tail = False, 3, ("avg",)
    last_bias = (0.0, 0.0, 1.0)

    def head(self, x: Tensor) -> Tensor:
        st = torch.sqrt(torch.exp(1.8 * torch.tanh(x[:, 0])))
        zero = torch.zeros_like(st)
        T = _stack2x2(st, zero, zero, 1.0 / st)
        return rectify_up_is_up(_rot_of(x[:, 1], x[:, 2]) @ T)


class AffNetFastBias(AffNet):
    """[[x0, 0], [x1, x2]] rectified up-is-up, the identity carried by the
    last bias instead of AffNetFast's 1 + x."""

    last_bias = (0.8, 0.0, 0.8)

    def head(self, x: Tensor) -> Tensor:
        return rectify_up_is_up(_lower(x[:, 0], x[:, 1], x[:, 2]))


# ---------------------------------------------------------------------------
# Descriptors
# ---------------------------------------------------------------------------

class Descriptor(PatchNet):
    """A descriptor net: its features L2-normalized."""

    def head(self, feats: Tensor) -> Tensor:
        return l2norm(feats)


class HardTFeatNet(Descriptor):
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


class HardNet(Descriptor):
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


class HardNetNarELU(PatchNet):
    """The narrow ELU HardNet (the reference's HardNet.py:30-71): six
    biased 3x3 convs 1->16->16->32/2->32->64/2->64 with ELU, no
    BatchNorm, and the global average: 64-D features, not normalized.
    Its forward skips ``input_norm`` and ignores ``compute_dtype`` (float32
    under ``with_dtype``), as the JAX net's ``features`` does."""

    def __init__(self):
        super().__init__([
            _conv(1, 16, 3, 1, 1, bias=True), nn.ELU(),
            _conv(16, 16, 3, 1, 1, bias=True), nn.ELU(),
            _conv(16, 32, 3, 2, 1, bias=True), nn.ELU(),
            _conv(32, 32, 3, 1, 1, bias=True), nn.ELU(),
            _conv(32, 64, 3, 2, 1, bias=True), nn.ELU(),
            _conv(64, 64, 3, 1, 1, bias=True), nn.ELU(),
            nn.AdaptiveAvgPool2d(1),
        ])

    def feature_vectors(self, patches: Tensor,
                        generator: Optional[torch.Generator] = None,
                        use_kernels: bool = True) -> Tensor:
        x = run_layers(self.features, patches[:, None, :, :], self.training,
                       None, generator, use_kernels)
        return x.float().flatten(1)


# ---------------------------------------------------------------------------
# OriNet
# ---------------------------------------------------------------------------

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
    """Name -> net class; a name the zoo lacks raises a KeyError that names
    the ones it has."""

    def __missing__(self, name):
        raise KeyError(f"{name!r} is not in the zoo, which has "
                       f"{sorted(self)}")


REGISTRY = _Registry({net.__name__: net for net in (
    AffNetFast, AffNetFast4, AffNetFastScale, AffNetFast4Rot,
    AffNetFast4RotNosc, AffNetFast52RotUp, AffNetFast52Rot,
    AffNetFast52RotL, AffNetFast5Rot, AffNetFast2Par, AffNetFastBias,
    OriNetFast, OriNetFast32, HardNet, HardTFeatNet, HardNetNarELU)})
