"""YiNet: the LIFT paper's orientation estimator with GHH heads.

Counterpart of ``affnet_tpu/models/yinet.py`` (the reference's GHH,
architectures.py:84-103, and YiNet, :105-151).  GHH, the generalized
hinge head, is a linear layer viewed as (n_out, s, m): the max over m,
then the sum over s with alternating signs.  YiNet takes (N, 28, 28)
patches: input_norm (not detached), 5x5 conv to 10, ReLU, 3x3 max pool of
stride 2 and padding 1, 5x5 conv to 20, ReLU, 4x4 max pool of stride 2
and padding 2, 3x3 conv to 50, ReLU, the global max, GHH to 100, GHH to
2; the angle is atan2(x0 + 1e-8, x1 + 1e-8).  The convs and pools are
PyTorch's (cuDNN on the card); ``max_pool2d``'s padding counts as -inf,
as JAX's ``reduce_window`` padding does.  Weights ship as LIFT's ``.npy``
dumps, read by :meth:`YiNet.import_weights`.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..laf import rotation_matrix
from ..utils import check_finite
from .cnn import input_norm

Tensor = torch.Tensor


def ghh(params, x: Tensor, n_out: int, s: int = 4, m: int = 4) -> Tensor:
    """(N, n_in) -> (N, n_out); ``params`` holds ``w`` (n_in,
    n_out*s*m) and ``b`` (n_out*s*m,)."""
    feats = (x @ params["w"] + params["b"]).reshape(x.shape[0], n_out, s, m)
    deltas = torch.from_numpy(np.where(np.arange(s) % 2 == 0, 1.0, -1.0)
                              .astype(np.float32)).to(x.device, x.dtype)
    return (feats.amax(dim=3) * deltas).sum(dim=2)


def _ghh_params(n_in: int, n_feats: int) -> nn.ParameterDict:
    return nn.ParameterDict({"w": nn.Parameter(torch.zeros(n_in, n_feats)),
                             "b": nn.Parameter(torch.zeros(n_feats))})


class YiNet(nn.Module):
    """(N, PS, PS) patches -> orientation angle (N,), or with
    ``return_rot_matrix`` the (N, 2, 2) rotation by minus that angle, as
    the JAX net returns it.  Built in eval mode (it has no BatchNorm or
    dropout, so the mode changes nothing)."""

    name = "YiNet"

    def __init__(self, patch_size: int = 28):
        super().__init__()
        self.ps = patch_size
        self.conv0 = nn.Conv2d(1, 10, 5)
        self.conv1 = nn.Conv2d(10, 20, 5)
        self.conv2 = nn.Conv2d(20, 50, 3)
        self.ghh0 = _ghh_params(50, 1600)
        self.ghh1 = _ghh_params(100, 32)
        self.eval()

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "YiNet":
        """The JAX net's ``init``: normal weights times 0.05, zero biases;
        ``generator`` is a CPU generator.  Returns the net."""
        for conv in (self.conv0, self.conv1, self.conv2):
            conv.weight.copy_(0.05 * torch.randn(conv.weight.shape,
                                                 generator=generator))
            conv.bias.zero_()
        for head in (self.ghh0, self.ghh1):
            head["w"].copy_(0.05 * torch.randn(head["w"].shape,
                                               generator=generator))
            head["b"].zero_()
        return self

    def angle(self, patches: Tensor) -> Tensor:
        x = input_norm(patches[:, None, :, :], detach=False)
        x = F.max_pool2d(torch.relu(self.conv0(x)), 3, 2, 1)
        x = F.max_pool2d(torch.relu(self.conv1(x)), 4, 2, 2)
        x = torch.relu(self.conv2(x)).amax(dim=(2, 3))
        x = ghh(self.ghh1, ghh(self.ghh0, x, 100), 2)
        return torch.atan2(x[:, 0] + 1e-8, x[:, 1] + 1e-8)

    def forward(self, patches: Tensor,
                return_rot_matrix: bool = False) -> Tensor:
        a = self.angle(patches)
        return check_finite(rotation_matrix(-a) if return_rot_matrix else a,
                            "YiNet")

    @staticmethod
    def state_dict_from_tree(tree: Dict[str, Dict[str, np.ndarray]]
                             ) -> Dict[str, Tensor]:
        """The JAX net's parameter tree (``conv{i}``: ``w`` HWIO and
        ``b``; ``ghh{i}``: ``w`` and ``b``) -> this net's ``state_dict``."""
        sd = {}
        for name, p in tree.items():
            w = np.asarray(p["w"], np.float32)
            b = np.asarray(p["b"], np.float32)
            if name.startswith("conv"):
                sd[f"{name}.weight"] = torch.from_numpy(
                    np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1))))
                sd[f"{name}.bias"] = torch.from_numpy(b.copy())
            else:
                sd[f"{name}.w"] = torch.from_numpy(w.copy())
                sd[f"{name}.b"] = torch.from_numpy(b.copy())
        return sd

    def import_weights(self, dir_name: str,
                       device: Optional[torch.device] = None) -> "YiNet":
        """Load LIFT's ``.npy`` dumps (architectures.py:125-138):
        ``layer{0,1,2}_W.npy`` conv weights in OIHW order with
        ``layer{i}_b.npy``, and ``layer{3,4}_W.npy`` the GHH weights,
        reshaped to (50, 1600) and (100, 32), with their biases.  Returns
        the net, its parameters on ``device`` (default: where they are)."""
        def load(n):
            return np.load(os.path.join(dir_name, n)).astype(np.float32)

        tree = {f"conv{i}": {"w": np.transpose(load(f"layer{i}_W.npy"),
                                               (2, 3, 1, 0)),
                             "b": load(f"layer{i}_b.npy").reshape(-1)}
                for i in range(3)}
        tree["ghh0"] = {"w": load("layer3_W.npy").reshape(50, 1600),
                        "b": load("layer3_b.npy").reshape(1600)}
        tree["ghh1"] = {"w": load("layer4_W.npy").reshape(100, 32),
                        "b": load("layer4_b.npy").reshape(32)}
        dev = device or self.conv0.weight.device
        self.load_state_dict({k: v.to(dev) for k, v in
                              self.state_dict_from_tree(tree).items()})
        return self
