"""affnet_tpu_torch — the PyTorch/CUDA port of ``affnet_tpu``.

The same image -> LAFs -> descriptors pipeline as the JAX package, written
in PyTorch's eager idiom: plain functions on tensors, ``nn.Module`` nets and
an explicit ``device``.  Every Pallas kernel on the ported path has a
hand-written CUDA kernel for Hopper (``csrc/*.cu``, built at first use by
:mod:`affnet_tpu_torch.kernels.build`) and, beside it, a plain PyTorch
version of the same function.  A wrapper runs the plain version only for a
tensor on the CPU; for a CUDA tensor it launches the kernel or raises.

Entry points default to ``device="cuda"``.  The CPU runs only when the
caller asks for it; a missing GPU raises instead of falling back.

This package imports ``torch`` and ``numpy`` only — never ``jax`` and
nothing of ``affnet_tpu``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

__version__ = "0.1.0"

WEIGHTS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "weights")


def resolve_device(device: Any = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and
    absent (no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    return dev


def load_pretrained(name: str,
                    weights_dir: Optional[str] = None) -> Dict[str, Any]:
    """Read ``weights/<name>.npz`` (the JAX package's converted weights) into
    the same nested parameter tree of numpy arrays, e.g.
    ``{"layer0": {"w": HWIO array}, "layer1": {"mean": ..., "var": ...}}``.
    Counterpart of ``affnet_tpu.models.convert.load_pretrained``; turn the
    tree into a ``state_dict`` with :func:`models.convert.params_from_jax`."""
    return load_params_npz(os.path.join(weights_dir or WEIGHTS_DIR,
                                        f"{name}.npz"))


def load_params_npz(path: str) -> Dict[str, Any]:
    """A parameter tree from any npz in the JAX package's layout (flat
    ``"layer{i}/w"`` keys), as :func:`load_pretrained` returns it; a
    training checkpoint's ``__epoch__`` is left out."""
    tree: Dict[str, Any] = {}
    with np.load(path) as data:
        for key in data.files:
            if key == "__epoch__":
                continue
            parts = key.split("/")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = np.asarray(data[key])
    return tree


# The extractors and the inference helpers (imported last: their modules
# use the helpers above).
from .detector import (DetectorConfig,  # noqa: E402, F401
                       ScaleSpaceAffinePatchExtractor)
from .onepass import OnePassSIR  # noqa: E402, F401
from .keypoints import (describe_keypoints,  # noqa: E402, F401
                        lafs_from_keypoints, process_keypoints)
from .match import snn_match, snn_match_host  # noqa: E402, F401
from .export import export_patch_net, load_exported  # noqa: E402, F401
from .utils import StageTimer, fence, profiler_trace  # noqa: E402, F401
# The trainers and their data.
from .models import REGISTRY  # noqa: E402, F401
from .train import (TrainConfig, make_affnet_train_step,  # noqa: E402, F401
                    make_descriptor_train_step, make_orinet_train_step,
                    train_loop)
from .data import (PairDataset, TotalDatasetsLoader,  # noqa: E402, F401
                   TripletDataset, load_total_datasets)
