"""Weights carried across from the JAX package.

The JAX nets keep their parameters as a tree ``{"layer{i}": {...}}`` keyed
by the layer's index in the spec: convolutions as ``w`` (HWIO) and ``b``,
eval BatchNorm as ``mean`` and ``var``.  The port's nets keep the same
indices in ``features`` (models/zoo.py), so the conversion is a walk, and
:func:`params_to_jax` walks back (checkpoints go both ways).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


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
