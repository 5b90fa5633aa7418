"""Model export and import: ``torch.export`` programs with a symbolic batch.

Counterpart of ``affnet_tpu/export.py``, which serializes a patch net's
jitted forward as StableHLO.  The reference's deployment story is
torch.jit traces (convertJIT/convert_OriNet_and_AffNet_to_JIT.ipynb ->
AffNetJIT.pt / OriNetJIT.pt); here a net's eval forward is traced with
``torch.export`` (weights baked into the artifact), its batch dimension
symbolic, and saved with ``torch.export.save``.

The trace runs the stock ``nchw`` layout, under ``eval_layout("nchw")`` and
``torch.no_grad()`` in eval mode: the nets read ``cnn.EVAL_CONV_LAYOUT`` and
``torch.is_grad_enabled()`` in Python, which the trace fixes, and the flat
layout calls kernel B7 through a ctypes library, which ``torch.export``
cannot trace.  The program runs on the device the net's weights were on
when it was exported; it takes batches of 1 or more (the trace uses a batch
of 2, since a symbolic size is specialized at 0 and 1).
"""

from __future__ import annotations

import io
from typing import Callable

import torch

from .models import cnn


def export_patch_net(net: torch.nn.Module, batch: str = "b") -> bytes:
    """Serialize ``net``'s eval forward on (batch, PS, PS) float32 patches,
    ``batch`` symbolic, as the bytes of a ``torch.export`` program.  The
    net is left in the mode it was in."""
    was_training = net.training
    dev = next(net.parameters()).device
    example = torch.zeros((2, net.ps, net.ps), dtype=torch.float32,
                          device=dev)
    try:
        net.eval()
        with cnn.eval_layout("nchw"), torch.no_grad():
            program = torch.export.export(
                net, (example,),
                dynamic_shapes={"patches": {0: torch.export.Dim(batch)}})
    finally:
        net.train(was_training)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def load_exported(blob: bytes) -> Callable:
    """Deserialize an exported net: a callable(patches) -> output, with
    gradients off."""
    module = torch.export.load(io.BytesIO(blob)).module()

    def call(patches):
        with torch.no_grad():
            return module(torch.as_tensor(patches))
    return call


def export_to_file(net: torch.nn.Module, path: str) -> None:
    with open(path, "wb") as f:
        f.write(export_patch_net(net))


def load_from_file(path: str) -> Callable:
    with open(path, "rb") as f:
        return load_exported(f.read())
