"""Command-line programs of the port (``python -m affnet_tpu_torch.cli.<name>``)."""

from typing import Optional, Tuple

import torch

from .. import load_pretrained
from ..models import REGISTRY
from ..models.convert import params_from_jax


def pretrained(net, name: str):
    """``net`` with the shipped weights ``weights/<name>.npz``."""
    net.load_state_dict(params_from_jax(load_pretrained(name)))
    return net


def shipped_or_seeded(name: str) -> Tuple[torch.nn.Module, Optional[str]]:
    """``REGISTRY[name]`` with its shipped weights where ``weights/`` has
    them and they fit (OriNetFast32 takes OriNetFast's, as the JAX package's
    export program does; the file holds the 32-px net, which the 16-px
    OriNetFast cannot take), else its seeded init (seed 0).  Returns the
    net and, for the seeded init, a note that says why."""
    net = REGISTRY[name]()
    try:
        tree = load_pretrained("OriNetFast" if name == "OriNetFast32"
                               else name)
    except FileNotFoundError:
        tree = None
    note = None
    if tree is not None:
        own = net.state_dict()
        if all(k in own and own[k].shape == v.shape
               for k, v in params_from_jax(tree).items()):
            net.load_state_dict(params_from_jax(tree))
            return net, None
        note = f"(the shipped weights for {name} do not fit its " \
               f"{net.ps}-px layers)\n"
    note = (note or "") + (f"(no pretrained weights for {name}; "
                           f"exporting randomly initialized)")
    net.init(torch.Generator().manual_seed(0))
    return net, note
