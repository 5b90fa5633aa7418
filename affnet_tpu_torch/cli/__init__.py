"""Command-line programs of the port (``python -m affnet_tpu_torch.cli.<name>``)."""

from .. import load_pretrained
from ..models.convert import params_from_jax


def pretrained(net, name: str):
    """``net`` with the shipped weights ``weights/<name>.npz``."""
    net.load_state_dict(params_from_jax(load_pretrained(name)))
    return net
