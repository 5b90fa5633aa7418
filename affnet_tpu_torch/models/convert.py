"""Weights carried across from the JAX package and from the reference's
``.pth`` checkpoints.

The JAX nets keep their parameters as a tree ``{"layer{i}": {...}}`` keyed
by the layer's index in the spec: convolutions as ``w`` (HWIO) and ``b``,
eval BatchNorm as ``mean`` and ``var``.  The port's nets keep the same
indices in ``features`` (models/zoo.py), so the conversion is a walk, and
:func:`params_to_jax` walks back (checkpoints go both ways).

The reference ships ``AffNet.pth`` and ``OriNet.pth`` as ``{'epoch',
'state_dict'}`` (train_AffNet_test_on_graffity.py:244-245) whose
``state_dict`` has the same ``features.{i}`` indices, except HardTFeatNet,
which keeps two ``nn.Sequential``s (:data:`HARDTFEAT_INDEX_MAP`).
:func:`convert_pth` reads one into a port net's ``state_dict``;
:func:`save_params_npz` writes that as the JAX package's npz layout, which
both packages read (``load_params_npz``).  Counterparts of
``affnet_tpu/models/convert.py``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn


def _flat_items(tree: Dict[str, Any], prefix: str = ""):
    for key, val in tree.items():
        name = f"{prefix}/{key}" if prefix else key
        if isinstance(val, dict):
            yield from _flat_items(val, name)
        else:
            yield name, val


_FIELDS = {"w": "weight", "b": "bias", "mean": "running_mean",
           "var": "running_var"}


def params_from_jax(tree: Dict[str, Any],
                    prefix: str = "features") -> Dict[str, torch.Tensor]:
    """JAX parameter tree (nested dict, or flat ``"layer{i}/w"`` keys, of
    numpy-convertible arrays) -> ``state_dict`` for the port's nets:

    - ``layer{i}/w`` (HWIO) -> ``{prefix}.{i}.weight`` (OIHW)
    - ``layer{i}/b``        -> ``{prefix}.{i}.bias``
    - ``layer{i}/mean``, ``/var`` -> ``running_mean``, ``running_var``
      (the eval BatchNorm statistics) and ``num_batches_tracked`` = 0.
    """
    names = _FIELDS
    sd: Dict[str, torch.Tensor] = {}
    for name, val in _flat_items(tree):
        layer, field = name.split("/")
        if not layer.startswith("layer") or field not in names:
            raise KeyError(f"unexpected parameter {name!r}")
        arr = np.array(val, np.float32)   # a writable copy
        if field == "w":
            arr = np.transpose(arr, (3, 2, 0, 1))
        base = f"{prefix}.{int(layer[5:])}"
        sd[f"{base}.{names[field]}"] = torch.from_numpy(
            np.ascontiguousarray(arr))
        if field == "mean":
            sd[f"{base}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    return sd


def params_to_jax(state_dict: Dict[str, torch.Tensor],
                  prefix: str = "features") -> Dict[str, Dict[str, np.ndarray]]:
    """Inverse of :func:`params_from_jax`: a net's ``state_dict`` -> the JAX
    parameter tree of float32 numpy arrays (``layer{i}/w`` HWIO, ``b``,
    ``mean``, ``var``).  ``num_batches_tracked`` has no JAX counterpart and
    is dropped."""
    fields = {v: k for k, v in _FIELDS.items()}
    tree: Dict[str, Dict[str, np.ndarray]] = {}
    for name, val in state_dict.items():
        parts = name.split(".")
        if parts[-1] == "num_batches_tracked":
            continue
        if len(parts) != 3 or parts[0] != prefix or parts[2] not in fields:
            raise KeyError(f"unexpected state_dict entry {name!r}")
        arr = val.detach().to("cpu", torch.float32).numpy()
        field = fields[parts[2]]
        if field == "w":
            arr = np.transpose(arr, (2, 3, 1, 0))
        # A copy: the tree must not alias the net's live tensors.
        tree.setdefault(f"layer{parts[1]}", {})[field] = np.array(
            arr, order="C", copy=True)
    return tree


def torch_state_dict_to_params(net: nn.Module, sd: Dict[str, Any],
                               prefix: str = "features",
                               index_map: Optional[Dict[int, str]] = None
                               ) -> Dict[str, torch.Tensor]:
    """A reference-layout ``state_dict`` (tensors or arrays) -> the
    ``state_dict`` of the port net ``net``, walking ``net.features`` as
    JAX walks its spec: conv ``{base}.weight`` (and ``.bias`` where the
    layer has one), BatchNorm ``{base}.running_mean`` and
    ``.running_var``, where ``base`` is ``index_map[i]`` if given, else
    ``{prefix}.{i}``.  Only the keys the net needs are read."""
    def get(key):
        v = sd[key]
        v = v.detach().cpu().numpy() if torch.is_tensor(v) else v
        return torch.from_numpy(np.array(v, np.float32))

    out: Dict[str, torch.Tensor] = {}
    for i, layer in enumerate(net.features):
        base = (index_map or {}).get(i, f"{prefix}.{i}")
        name = f"features.{i}"
        if isinstance(layer, nn.Conv2d):
            out[f"{name}.weight"] = get(f"{base}.weight")
            if layer.bias is not None:
                out[f"{name}.bias"] = get(f"{base}.bias").reshape(-1)
        elif isinstance(layer, nn.BatchNorm2d):
            out[f"{name}.running_mean"] = get(f"{base}.running_mean")
            out[f"{name}.running_var"] = get(f"{base}.running_var")
            out[f"{name}.num_batches_tracked"] = torch.zeros(
                (), dtype=torch.long)
    return out


def load_torch_checkpoint(path: str) -> Dict[str, Any]:
    """A reference ``.pth``'s ``state_dict``, unwrapping the ``{'epoch',
    'state_dict'}`` convention.  Read with ``weights_only=True``: tensors,
    numbers and containers only, nothing that runs code."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return (ckpt["state_dict"]
            if isinstance(ckpt, dict) and "state_dict" in ckpt else ckpt)


def convert_pth(path: str, net: nn.Module, prefix: str = "features",
                index_map: Optional[Dict[int, str]] = None
                ) -> Dict[str, torch.Tensor]:
    """A reference ``.pth`` -> ``net``'s ``state_dict``
    (:func:`torch_state_dict_to_params`)."""
    return torch_state_dict_to_params(net, load_torch_checkpoint(path),
                                      prefix=prefix, index_map=index_map)


# HardTFeatNet keeps two Sequentials (HardNet.py:37-47): the spec's convs
# 0 and 3 are features.0 and features.3, its conv 6 is classifier.1.
HARDTFEAT_INDEX_MAP = {
    0: "features.0", 3: "features.3", 6: "classifier.1",
}


def save_params_npz(params: Dict[str, torch.Tensor], path: str) -> None:
    """Write a port net's ``state_dict`` (e.g. :func:`convert_pth`'s) as
    the JAX package's flat npz (``layer{i}/w`` HWIO, ``b``, ``mean``,
    ``var``), creating the directory."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **{f"{layer}/{field}": arr
                      for layer, fields in params_to_jax(params).items()
                      for field, arr in fields.items()})
