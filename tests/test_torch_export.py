"""The port's export (affnet_tpu_torch.export, ``torch.export`` with a
symbolic batch) on the CPU: the round trip through bytes at two batch
sizes, and through a file, against the module and against the JAX net on the same
weights.

AffNetFast, OriNetFast32 and HardTFeatNet carry the shipped weights; HardNet
JAX's ``init(PRNGKey(0))`` weights, carried across with ``params_from_jax``.
The exported program computes the module's operations: atol 1e-6 against
the module (measured: 0).  Against JAX: the float32 convolutions sum in
another order, atol 1e-5 (measured below 2e-6).
"""

import numpy as np
import pytest
import torch

import jax
from affnet_tpu import models as jmodels
from affnet_tpu.models.convert import load_pretrained as jload
from affnet_tpu_torch import export
from affnet_tpu_torch.models import (AffNetFast, HardNet, HardTFeatNet,
                                     OriNetFast32, cnn, params_from_jax)

NETS = {
    "AffNetFast": (AffNetFast, "AffNetFast"),
    "OriNetFast32": (OriNetFast32, "OriNetFast"),
    "HardTFeatNet": (HardTFeatNet, "HardTFeatNet"),
    "HardNet": (HardNet, None),
}


def _nets(name):
    cls, weights = NETS[name]
    jnet = getattr(jmodels, name)
    params = (jload(weights) if weights
              else jnet.init(jax.random.PRNGKey(0)))
    net = cls()
    net.load_state_dict(params_from_jax(params))
    return net.eval(), jnet, params


def _patches(seed, n, ps):
    rng = np.random.RandomState(seed)
    return rng.uniform(0, 1, (n, ps, ps)).astype(np.float32)


@pytest.mark.parametrize("name", list(NETS))
def test_export_round_trip_matches_module_and_jax(name):
    net, jnet, params = _nets(name)
    blob = export.export_patch_net(net)
    assert isinstance(blob, bytes) and not net.training
    loaded = export.load_exported(blob)
    for n in (5, 11):
        x = _patches(n, n, net.ps)
        got = loaded(torch.from_numpy(x))
        with torch.no_grad():
            ref = net(torch.from_numpy(x))
        assert got.shape == ref.shape and got.shape[0] == n
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(got.numpy(), np.asarray(jnet(params, x)),
                                   rtol=0, atol=1e-5)


def test_export_bakes_weights_and_keeps_the_mode(tmp_path):
    """Through a file: the artifact carries the weights, so changing the
    net after export changes nothing; the net's training mode and the eval
    layout are left as they were."""
    net, _, _ = _nets("AffNetFast")
    net.train()
    path = str(tmp_path / "affnet.pt2")
    with cnn.eval_layout("flat"):
        export.export_to_file(net, path)
        assert cnn.EVAL_CONV_LAYOUT == "flat"
    assert net.training
    net.eval()
    x = torch.from_numpy(_patches(0, 4, 32))
    with torch.no_grad():
        ref = net(x)
        for p in net.parameters():
            p.add_(1.0)
    np.testing.assert_allclose(export.load_from_file(path)(x).numpy(),
                               ref.numpy(), rtol=0, atol=1e-6)
