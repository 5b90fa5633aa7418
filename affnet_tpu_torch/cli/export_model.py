"""Export a patch CNN of the zoo as a ``torch.export`` program.

Counterpart of ``affnet_tpu/cli/export_model.py`` (which writes StableHLO):
any ``models.REGISTRY`` name, with ``--weights X.npz`` (the JAX package's
layout, e.g. a training checkpoint), else the shipped weights where
``weights/`` has them and they fit (OriNetFast32 takes OriNetFast's; the
16-px OriNetFast cannot, as the file holds the 32-px net), else the
seeded init (seed 0) with a note.  The net's eval forward is traced under the
nchw layout with a symbolic batch (``export.py``) and saved; the file is
read back and run on 3 seeded patches, which must give the eager net's
output within 1e-5.  Runs on the card unless ``--device cpu`` asks for
the CPU; the program runs on the device it was exported on.

Usage: python -m affnet_tpu_torch.cli.export_model AffNetFast \
           exports/AffNet.pt2 [--weights X.npz] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .. import load_params_npz, resolve_device
from ..export import export_to_file, load_from_file
from ..models import REGISTRY, params_from_jax
from ..utils import float32_math
from . import shipped_or_seeded

ROUND_TRIP_ATOL = 1e-5


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("model", help="registry name, e.g. AffNetFast, "
                                      "OriNetFast32, HardNet")
    parser.add_argument("output")
    parser.add_argument("--weights", default=None,
                        help=".npz weights (defaults to the converted "
                             "pretrained weights for that name)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    dev = resolve_device(args.device)
    if args.weights:
        net = REGISTRY[args.model]()
        net.load_state_dict(params_from_jax(load_params_npz(args.weights)))
    else:
        net, note = shipped_or_seeded(args.model)
        if note:
            print(note)
    net = net.to(dev).eval()

    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    export_to_file(net, args.output)
    # Round-trip check.
    fn = load_from_file(args.output)
    x = torch.from_numpy(np.random.RandomState(0).rand(3, net.ps, net.ps)
                         .astype(np.float32)).to(dev)
    with float32_math(), torch.no_grad():
        out = fn(x)
        ref = net(x)
    err = float((out - ref).abs().max())
    if not err <= ROUND_TRIP_ATOL:
        raise SystemExit(f"{args.model}: the reloaded program differs from "
                         f"the net by {err}")
    print(f"{args.model} -> {args.output} "
          f"({os.path.getsize(args.output)} bytes; reloaded output "
          f"{tuple(out.shape)}, max |diff| from the net {err:.3g})")
    return out, ref


if __name__ == "__main__":
    main()
