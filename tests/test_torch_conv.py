"""Kernel B7's plain version and the flat eval stack against the JAX
package: ``ops/conv_flat.py`` against JAX's Pallas ``conv_flat`` (run in
interpret mode, as tests/conftest.py sets), and each ported net under the
flat layout against the same JAX net under the flat layout, on the same
numpy inputs and weights.

Tolerances: float32 within 1e-5 of the output's largest magnitude (the two
sum the same products in another order); bf16 within one bf16 ulp of the
value (a float32 sum that differs in its last bits can round to the
neighbouring bf16 value) plus that float32 term; the nets within the JAX
layout test's own atol 5e-6 (tests/test_models.py
``test_eval_conv_layout_parity``)."""

import contextlib
import itertools
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from affnet_tpu.models import cnn as jcnn
from affnet_tpu.models import zoo as jzoo
from affnet_tpu.ops import pallas_conv
from affnet_tpu_torch.models import cnn, params_from_jax, zoo
from affnet_tpu_torch.ops import launch_counts
from affnet_tpu_torch.ops.conv_flat import (ACTIVATIONS, conv_flat_plain,
                                            conv_layer_plain)
from affnet_tpu_torch.ops.cuda_conv import (b7_takes, conv_flat,
                                            conv_flat_cuda, pack_weights)

# (C_pad, C, O, k, pad, H): the layers the flat stack puts through B7 --
# AffNetFast's and OriNetFast32's six trunk convs (stride-2 layers run at
# stride 1), HardTFeatNet's 7x7 VALID conv, and HardNet's trunk.
LAYERS = {
    "aff1": (8, 1, 16, 3, 1, 32),
    "aff2": (16, 16, 16, 3, 1, 32),
    "aff3": (16, 16, 32, 3, 1, 32),
    "aff4": (32, 32, 32, 3, 1, 16),
    "aff5": (32, 32, 64, 3, 1, 16),
    "aff6": (64, 64, 64, 3, 1, 8),
    "tfeat1": (8, 1, 32, 7, 0, 32),
    "hard1": (8, 1, 32, 3, 1, 32),
    "hard2": (32, 32, 32, 3, 1, 32),
    "hard3": (32, 32, 64, 3, 1, 32),
    "hard4": (64, 64, 64, 3, 1, 16),
    "hard5": (64, 64, 128, 3, 1, 16),
    "hard6": (128, 128, 128, 3, 1, 8),
}
N_PATCHES = 3


def _inputs(layer, seed):
    c_pad, c, o, k, pad, h = LAYERS[layer]
    rng = np.random.RandomState(seed)
    x = np.zeros((c_pad, N_PATCHES * h * h), np.float32)
    x[:c] = rng.randn(c, N_PATCHES * h * h)
    w = (rng.randn(k, k, c, o) / np.sqrt(k * k * c)).astype(np.float32)
    b = (0.1 * rng.randn(o)).astype(np.float32)
    return x, w, b, (h, h), pad


def _jax_conv(x, w, b, hw, pad, act, dtype):
    return np.asarray(pallas_conv.conv_flat(
        jnp.asarray(x).astype(dtype), jnp.asarray(w).astype(dtype),
        jnp.asarray(b), img_hw=hw, pad=pad, act=act,
        n_patches=N_PATCHES).astype(jnp.float32))


def _port_conv(x, w, b, hw, pad, act, dtype):
    xt = torch.from_numpy(x).to(dtype)
    return conv_flat_plain(xt, torch.from_numpy(w), torch.from_numpy(b), hw,
                           pad, act).float().numpy()


def _assert_close(got, ref, bf16):
    scale = float(np.abs(ref).max())
    tol = 1e-5 * scale
    if bf16:
        tol = tol + np.abs(ref) * 2.0 ** -7
    assert np.all(np.abs(got - ref) <= tol), float(np.abs(got - ref).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["none", "relu", "tanh", "elu"])
@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_conv_flat_plain_matches_jax(layer, act, dtype):
    x, w, b, hw, pad = _inputs(layer, seed=sorted(LAYERS).index(layer))
    ref = _jax_conv(x, w, b, hw, pad, act, getattr(jnp, dtype))
    got = _port_conv(x, w, b, hw, pad, act, getattr(torch, dtype))
    assert got.shape == ref.shape == (LAYERS[layer][2], x.shape[1])
    _assert_close(got, ref, dtype == "bfloat16")


def test_conv_flat_valid_masks_read_past_the_patch_edge():
    """pad=0: tap (r, s) reads +r, +s from each pixel, zero past the
    patch's own edge (not the next patch's pixels), so the first 26x26 of
    the 32x32 output is the VALID 7x7 convolution of each patch."""
    x, w, b, hw, _ = _inputs("tfeat1", seed=5)
    got = _port_conv(x, w, b, hw, 0, "none", torch.float32)
    x4 = torch.from_numpy(x[:1].reshape(1, N_PATCHES, 32, 32)).transpose(0, 1)
    valid = torch.nn.functional.conv2d(
        x4, torch.from_numpy(w).permute(3, 2, 0, 1), torch.from_numpy(b))
    g4 = got.reshape(32, N_PATCHES, 32, 32)
    np.testing.assert_allclose(g4[:, :, :26, :26],
                               valid.transpose(0, 1).numpy(), atol=1e-5)
    # Beyond the valid region only the in-patch taps count: the last row
    # and column see tap (0, 0) alone.
    np.testing.assert_allclose(
        g4[:, :, 31, 31], w[0, 0, 0][:, None] * x4[:, 0, 31, 31].numpy()[None]
        + b[:, None], atol=1e-5)


def test_conv_flat_checks_and_cpu_dispatch():
    x, w, b, hw, pad = _inputs("aff1", seed=0)
    xt, wt, bt = map(torch.from_numpy, (x, w, b))
    xt = xt[:1]                                  # the layer's real C
    before = launch_counts()
    out = conv_flat(xt, wt, bt, hw, pad, "relu", stride=2)
    assert launch_counts() == before            # CPU: the plain version
    torch.testing.assert_close(out, conv_layer_plain(xt, wt, bt, hw, pad,
                                                     "relu", 2),
                               rtol=0, atol=0)
    assert out.shape == (16, N_PATCHES * 16 * 16)
    with pytest.raises(ValueError, match="multiple of 8"):
        conv_flat_plain(torch.from_numpy(x)[:5], wt, bt, hw, pad)
    with pytest.raises(ValueError, match="activation"):
        conv_flat_plain(torch.from_numpy(x), wt, bt, hw, pad, "gelu")
    with pytest.raises(ValueError, match="pad"):
        conv_flat_plain(torch.from_numpy(x), wt, bt, hw, 3)
    with pytest.raises(ValueError, match="C=8 rows"):
        conv_layer_plain(torch.from_numpy(x), wt, bt, hw, pad)
    with pytest.raises(ValueError, match="stride"):
        conv_layer_plain(xt, wt, bt, hw, pad, stride=3)
    with pytest.raises(ValueError, match="pad"):
        conv_layer_plain(xt, wt, bt, hw, 2)
    # The kernel's weight layouts: float32 (C, taps, O); bf16 (taps, O,
    # Cp) with Cp a multiple of 16, and (O, K) with K the taps rounded up
    # to 16 for one input channel; values rounded to bf16.
    assert torch.equal(pack_weights(wt, torch.float32),
                       wt.permute(2, 0, 1, 3).reshape(1, 9, 16))
    wk = pack_weights(wt, torch.bfloat16)
    assert wk.shape == (16, 16) and wk.dtype == torch.bfloat16
    assert torch.equal(wk[:, 9:], torch.zeros_like(wk[:, 9:]))
    assert torch.equal(wk[:, :9], wt.reshape(9, 16).T.bfloat16())
    w3 = torch.from_numpy(_inputs("aff4", seed=0)[1])
    wk3 = pack_weights(w3, torch.bfloat16)
    assert wk3.shape == (9, 32, 32)
    assert torch.equal(wk3, w3.reshape(9, 32, 32).transpose(1, 2).bfloat16())
    wk24 = pack_weights(w3[:, :, :24], torch.bfloat16)
    assert wk24.shape == (9, 32, 32)
    assert torch.equal(wk24[:, :, 24:], torch.zeros_like(wk24[:, :, 24:]))


# (C, O, k, pad, stride, H): every layer shape the zoo's flat stacks put
# through B7 -- AffNetFast's and OriNetFast32's trunk on 32x32 patches,
# OriNetFast's on 16x16, HardTFeatNet's 7x7 VALID layer and HardNet's
# trunk -- at the layer's own stride, padding and real channel count.
LAYER_SHAPES = {
    "aff1": (1, 16, 3, 1, 1, 32),
    "aff2": (16, 16, 3, 1, 1, 32),
    "aff3": (16, 32, 3, 1, 2, 32),
    "aff4": (32, 32, 3, 1, 1, 16),
    "aff5": (32, 64, 3, 1, 2, 16),
    "aff6": (64, 64, 3, 1, 1, 8),
    "ori16_3": (16, 32, 3, 1, 2, 16),
    "ori16_5": (32, 64, 3, 1, 2, 8),
    "ori16_6": (64, 64, 3, 1, 1, 4),
    "tfeat1": (1, 32, 7, 0, 1, 32),
    "hard1": (1, 32, 3, 1, 1, 32),
    "hard3": (32, 64, 3, 1, 2, 32),
    "hard5": (64, 128, 3, 1, 2, 16),
    "hard6": (128, 128, 3, 1, 1, 8),
}


def _jax_layer(x, w, b, hw, pad, act, stride, dtype):
    """JAX's flat stack on one layer: the interpreted Pallas conv_flat on
    the rows padded to C_pad, then its own crop (``_onehot_first``) and
    subsample (``_downsample2_onehot``)."""
    c = x.shape[0]
    c_pad = -(-c // 8) * 8
    xp = np.zeros((c_pad, x.shape[1]), np.float32)
    xp[:c] = x
    h, wd = hw
    k, o = w.shape[0], w.shape[3]
    y = pallas_conv.conv_flat(
        jnp.asarray(xp).astype(dtype), jnp.asarray(w).astype(dtype),
        jnp.asarray(b), img_hw=hw, pad=pad, act=act, n_patches=N_PATCHES)
    y4 = y.reshape(o, N_PATCHES, h, wd)
    dname = jnp.dtype(dtype).name
    if pad == 0:
        ho, wo = h - k + 1, wd - k + 1
        y4 = jnp.einsum("cnhw,wx->cnhx", y4, jcnn._onehot_first(wd, wo, dname))
        y4 = jnp.einsum("cnhx,hg->cngx", y4, jcnn._onehot_first(h, ho, dname))
    if stride == 2:
        y4 = jcnn._downsample2_onehot(y4)
    return np.asarray(y4.reshape(o, -1).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layer", sorted(LAYER_SHAPES))
def test_conv_layer_plain_matches_jax_crop_subsample(layer, dtype):
    """The kernel's plain version (the layer's own work) against JAX's
    interpreted conv_flat followed by JAX's crop and subsample: float32
    within 1e-5 of the largest magnitude, bf16 plus one bf16 ulp."""
    c, o, k, pad, stride, h = LAYER_SHAPES[layer]
    rng = np.random.RandomState(sorted(LAYER_SHAPES).index(layer))
    x = rng.randn(c, N_PATCHES * h * h).astype(np.float32)
    w = (rng.randn(k, k, c, o) / np.sqrt(k * k * c)).astype(np.float32)
    b = (0.1 * rng.randn(o)).astype(np.float32)
    act = ACTIVATIONS[sorted(LAYER_SHAPES).index(layer) % 4]
    ref = _jax_layer(x, w, b, (h, h), pad, act, stride, getattr(jnp, dtype))
    got = conv_layer_plain(torch.from_numpy(x).to(getattr(torch, dtype)),
                           torch.from_numpy(w), torch.from_numpy(b), (h, h),
                           pad, act, stride).float().numpy()
    ho = (h + 2 * pad - k) // stride + 1
    assert got.shape == ref.shape == (o, N_PATCHES * ho * ho)
    _assert_close(got, ref, dtype == "bfloat16")


# ---------------------------------------------------------------------------
# The nets under the flat layout
# ---------------------------------------------------------------------------

NETS = {
    "AffNetFast": (zoo.AffNetFast, jzoo.AffNetFast),
    "OriNetFast": (zoo.OriNetFast, jzoo.OriNetFast),
    "OriNetFast32": (zoo.OriNetFast32, jzoo.OriNetFast32),
    "HardTFeatNet": (zoo.HardTFeatNet, jzoo.HardTFeatNet),
    "HardNet": (zoo.HardNet, jzoo.HardNet),
}


def _jax_params(jnet, seed):
    """Init params with non-trivial BatchNorm statistics, so the folding
    is exercised."""
    params = jax.tree_util.tree_map(np.asarray,
                                    jnet.init(jax.random.PRNGKey(seed)))
    rng = np.random.RandomState(seed)
    for p in params.values():
        if "mean" in p:
            p["mean"] = (0.1 * rng.randn(*p["mean"].shape)).astype(np.float32)
            p["var"] = rng.uniform(0.5, 2.0, p["var"].shape).astype(np.float32)
    return params


def _port_net(cls, params):
    net = cls()
    net.load_state_dict(params_from_jax(params))
    return net


@contextlib.contextmanager
def _layout(layout):
    """Both packages' eval layout for a block (the port's through
    ``cnn.eval_layout``)."""
    old = jcnn.EVAL_CONV_LAYOUT
    jcnn.EVAL_CONV_LAYOUT = layout
    try:
        with cnn.eval_layout(layout):
            yield
    finally:
        jcnn.EVAL_CONV_LAYOUT = old


def _run_both(name, seed=3, dtype=None):
    cls, jnet = NETS[name]
    params = _jax_params(jnet, seed)
    net = _port_net(cls, params)
    if dtype is not None:
        net, jnet = net.with_dtype(torch.bfloat16), jnet.with_dtype(
            jnp.bfloat16)
    patches = np.random.RandomState(1).rand(6, jnet.ps, jnet.ps).astype(
        np.float32)
    ref = np.asarray(jnet(jax.tree_util.tree_map(jnp.asarray, params),
                          jnp.asarray(patches)))
    with torch.no_grad():
        got = net(torch.from_numpy(patches)).numpy()
    return got, ref, net, patches


@pytest.mark.parametrize("name", sorted(NETS))
def test_net_flat_matches_jax_flat(name):
    with _layout("flat"):
        before = launch_counts()
        got, ref, _, _ = _run_both(name)
        assert launch_counts() == before
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=5e-6)


@pytest.mark.parametrize("name", sorted(NETS))
def test_net_flat_matches_port_nchw(name):
    with _layout("flat"):
        got, _, net, patches = _run_both(name)
    with torch.no_grad():
        ref = net(torch.from_numpy(patches)).numpy()
    np.testing.assert_allclose(got, ref, atol=5e-6)


@pytest.mark.parametrize("name", sorted(NETS))
def test_net_flat_bf16_matches_jax_flat_bf16(name):
    """The bf16 chain under the flat layout: folded float32 weights rounded
    to bf16, bf16 activations, float32 sums, as JAX's flat path.  A bf16
    activation whose float32 sum differs in the last bits rounds the other
    way (one bf16 ulp, 2^-8 relative); measured: max |diff| 8e-4 (HardNet),
    mean under 1e-5."""
    with _layout("flat"):
        got, ref, _, _ = _run_both(name, dtype=torch.bfloat16)
    np.testing.assert_allclose(got, ref, atol=2e-3)
    assert np.abs(got - ref).mean() < 5e-5


def test_flat_stack_launch_plan():
    """Which layers the flat stack covers: 6 trunk convs for AffNetFast
    and OriNetFast32 (OriNet's pad-1 8x8 head runs stock), 1 for
    HardTFeatNet (its 6x6 layer on 13x13 maps stops the stack), 6 for
    HardNet (its 8x8 head is one matrix product)."""
    calls = []
    orig = cnn.conv_flat

    def spy(x, w, bias, img_hw, pad, act, stride, use_kernel=True):
        calls.append((tuple(w.shape), img_hw, pad, act, stride))
        return orig(x, w, bias, img_hw, pad, act, stride,
                    use_kernel=use_kernel)

    expect = {"AffNetFast": 6, "OriNetFast32": 6, "OriNetFast": 6,
              "HardTFeatNet": 1, "HardNet": 6}
    try:
        cnn.conv_flat = spy
        for name, cls in (("AffNetFast", zoo.AffNetFast),
                          ("OriNetFast32", zoo.OriNetFast32),
                          ("OriNetFast", zoo.OriNetFast),
                          ("HardTFeatNet", zoo.HardTFeatNet),
                          ("HardNet", zoo.HardNet)):
            calls.clear()
            net = cls()
            with _layout("flat"), torch.no_grad():
                net(torch.rand(2, net.ps, net.ps))
            assert len(calls) == expect[name], (name, calls)
            if name == "HardTFeatNet":
                assert calls == [((7, 7, 1, 32), (32, 32), 0, "tanh", 1)]
            if name == "AffNetFast":
                assert [c[1] for c in calls] == [(32, 32)] * 3 + [
                    (16, 16)] * 2 + [(8, 8)]
                assert {c[3] for c in calls} == {"relu"}
                assert [c[4] for c in calls] == [1, 1, 2, 1, 2, 1]
    finally:
        cnn.conv_flat = orig


# Small nets with a middle layer that B7 does not take, between layers it
# does: (kernel, pad) of the middle 16 -> 16 layer.
ODD_LAYERS = {"k5": (5, 2), "k7p1": (7, 1)}


def _odd_nets(name, seed=3):
    """The same net in both packages: 3x3 1->16, BN, ReLU; the middle
    layer, BN, ReLU; 3x3 16->32 at stride 2, BN, ReLU; global average."""
    k, pad = ODD_LAYERS[name]
    spec = (jcnn.Conv(1, 16, 3, 1, 1), jcnn.BN(16), jcnn.ReLU(),
            jcnn.Conv(16, 16, k, 1, pad), jcnn.BN(16), jcnn.ReLU(),
            jcnn.Conv(16, 32, 3, 2, 1), jcnn.BN(32), jcnn.ReLU(),
            jcnn.AvgPoolGlobal())
    jnet = jzoo.PatchNet(name, spec, 32)
    params = _jax_params(jnet, seed)
    nn = torch.nn
    net = zoo.PatchNet([
        nn.Conv2d(1, 16, 3, 1, 1, bias=False), cnn.batch_norm(16), nn.ReLU(),
        nn.Conv2d(16, 16, k, 1, pad, bias=False), cnn.batch_norm(16),
        nn.ReLU(),
        nn.Conv2d(16, 32, 3, 2, 1, bias=False), cnn.batch_norm(32),
        nn.ReLU(), nn.AdaptiveAvgPool2d(1)])
    net.load_state_dict(params_from_jax(params))
    return jnet, params, net


@pytest.mark.parametrize("name", sorted(ODD_LAYERS))
def test_flat_stack_stops_at_layers_b7_does_not_take(name):
    """A 5x5 layer and a 7x7 layer at pad 1 are outside B7's contract
    (``b7_takes``): the flat stack puts the first layer through
    ``conv_flat`` (the spy of test_flat_stack_launch_plan) and hands the
    middle layer and the rest to the stock layers.  The output is held
    within the flat nets' atol 5e-6 to JAX's flat layout for the 5x5
    layer (JAX's conv_flat takes any kernel size).  For the 7x7 pad-1
    layer JAX's flat layout is no reference: it crops only pad-0 layers,
    so it keeps that layer's output at the map's full extent (measured:
    3e-2 off its own stock layout); the port is held to JAX's stock
    layout there, which JAX's tests hold its flat layout to, and to its
    own nchw layout, at the same atol."""
    k, pad = ODD_LAYERS[name]
    assert b7_takes(1, 16, 3, 1, 1, 32, 32)
    assert not b7_takes(16, 16, k, pad, 1, 32, 32)
    assert not b7_takes(16, 16, k, pad, 1, 32, 32, torch.bfloat16)
    jnet, params, net = _odd_nets(name)
    patches = np.random.RandomState(1).rand(6, 32, 32).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    calls = []
    orig = cnn.conv_flat

    def spy(x, w, bias, img_hw, pad, act, stride, use_kernel=True):
        calls.append((tuple(w.shape), img_hw, pad, act, stride))
        return orig(x, w, bias, img_hw, pad, act, stride,
                    use_kernel=use_kernel)

    try:
        cnn.conv_flat = spy
        with _layout("flat"), torch.no_grad():
            got = net(torch.from_numpy(patches)).numpy()
            ref_flat = np.asarray(jnet(jp, jnp.asarray(patches)))
    finally:
        cnn.conv_flat = orig
    assert calls == [((3, 3, 1, 16), (32, 32), 1, "relu", 1)]
    with _layout("nchw"), torch.no_grad():
        nchw = net(torch.from_numpy(patches)).numpy()
        ref_stock = np.asarray(jnet(jp, jnp.asarray(patches)))
    assert got.shape == ref_stock.shape == (6, 32)
    np.testing.assert_allclose(got, nchw, atol=5e-6)
    np.testing.assert_allclose(got, ref_stock, atol=5e-6)
    if name == "k5":
        np.testing.assert_allclose(got, ref_flat, atol=5e-6)
    else:
        assert np.abs(ref_flat - ref_stock).max() > 1e-3


def test_b7_takes_agrees_with_conv_flat_cuda():
    """``conv_flat_cuda`` refuses, before it needs a card, exactly the
    layers ``b7_takes`` refuses, over a grid of kernel sizes, pads,
    strides, channels, map sizes and both dtypes; what it takes goes on to
    the device check (a CPU tensor is refused there).  Among the refusals:
    kernel sizes other than 3 and 7, a pad other than 0 or (k-1)/2, a
    float32 map over 512 threads' rows (66x66), the outputs that cannot
    halve under it (24 outputs on 40x40), and bf16 maps past the 227 KB of
    shared memory (64 channels of 7x7 on 32x32).  On the card,
    tests/test_torch_cuda.py holds ``b7_takes`` to the launcher itself."""
    takes = refused = 0
    for k, pad, stride, c, o, hw, dt in itertools.product(
            (3, 5, 7), (0, 1, 2, 3), (1, 2), (1, 16, 64), (8, 24, 64),
            (8, 16, 32, 40, 66), (torch.float32, torch.bfloat16)):
        if 2 * pad > k - 1 or k > hw + 2 * pad:
            continue                   # outside the plain contract too
        x = torch.zeros((c, hw * hw), dtype=dt)
        w = torch.zeros((k, k, c, o))
        ok = b7_takes(c, o, k, pad, stride, hw, hw, dt)
        with pytest.raises(ValueError) as err:
            conv_flat_cuda(x, w, None, (hw, hw), pad, "relu", stride)
        if ok:
            assert "CUDA tensor" in str(err.value), (k, pad, stride, c, o,
                                                     hw, dt)
            takes += 1
        else:
            assert "B7 does not take" in str(err.value)
            refused += 1
    assert takes > 100 and refused > 100
    assert not b7_takes(16, 16, 3, 1, 1, 66, 66)
    assert b7_takes(16, 16, 3, 1, 1, 64, 64)
    assert not b7_takes(16, 24, 3, 1, 1, 40, 40)
    assert b7_takes(16, 32, 3, 1, 1, 40, 40)
    assert not b7_takes(64, 64, 7, 3, 1, 32, 32, torch.bfloat16)
    assert b7_takes(64, 64, 7, 3, 1, 32, 32)
    assert b7_takes(64, 64, 3, 1, 1, 32, 32, torch.bfloat16)


def test_apply_flat_feeds_each_layer_its_real_channels():
    """The flat stack hands B7 the layer's own input: one row for the
    1-channel input (no zero rows padded to 8), and each layer's output
    (O, N*Ho*Wo) straight to the next layer, with no crop or subsample
    copy in between."""
    calls = []
    orig = cnn.conv_flat

    def spy(x, w, bias, img_hw, pad, act, stride, use_kernel=True):
        y = orig(x, w, bias, img_hw, pad, act, stride, use_kernel=use_kernel)
        calls.append((x, y))
        return y

    try:
        cnn.conv_flat = spy
        for cls in (zoo.AffNetFast, zoo.OriNetFast32, zoo.HardTFeatNet):
            calls.clear()
            net = cls()
            with _layout("flat"), torch.no_grad():
                net(torch.rand(2, net.ps, net.ps))
            convs = [l for l in net.features
                     if isinstance(l, torch.nn.Conv2d)][:len(calls)]
            assert [x.shape[0] for x, _ in calls] == [
                l.in_channels for l in convs]
            assert calls[0][0].shape == (1, 2 * net.ps * net.ps)
            for (_, y), (x, _) in zip(calls, calls[1:]):
                assert x is y
    finally:
        cnn.conv_flat = orig


def test_eval_layout_refuses_unknown_layouts():
    """The layouts are "nchw", "cnhw" and "flat": any other value, one
    that neither package has ("nhwc"), is refused by ``eval_layout`` (the
    layout in force is kept) and by the import that reads
    ``AFFNET_EVAL_CONV``."""
    before = cnn.EVAL_CONV_LAYOUT
    with pytest.raises(ValueError, match="nhwc"):
        with cnn.eval_layout("nhwc"):
            pass
    assert cnn.EVAL_CONV_LAYOUT == before
    seen = cnn.eval_layout("flat")(lambda: cnn.EVAL_CONV_LAYOUT)
    assert seen() == "flat" and cnn.EVAL_CONV_LAYOUT == before
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run(
        [sys.executable, "-c", "import affnet_tpu_torch.models.cnn"],
        cwd=root, env={**os.environ, "AFFNET_EVAL_CONV": "nhwc"},
        capture_output=True, text=True, timeout=300)
    assert run.returncode != 0 and "nhwc" in run.stderr


def test_eval_layout_and_env_take_cnhw():
    """``eval_layout("cnhw")`` and ``AFFNET_EVAL_CONV=cnhw`` are taken."""
    before = cnn.EVAL_CONV_LAYOUT
    with cnn.eval_layout("cnhw"):
        assert cnn.EVAL_CONV_LAYOUT == "cnhw"
    assert cnn.EVAL_CONV_LAYOUT == before
    assert "cnhw" in cnn.EVAL_CONV_LAYOUTS
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run(
        [sys.executable, "-c", "from affnet_tpu_torch.models import cnn; "
         "print(cnn.EVAL_CONV_LAYOUT)"],
        cwd=root, env={**os.environ, "AFFNET_EVAL_CONV": "cnhw"},
        capture_output=True, text=True, timeout=300)
    assert run.returncode == 0 and run.stdout.split() == ["cnhw"], run.stderr


def test_flat_layout_needs_no_grad_mode():
    """With autograd recording the nets keep the layer-by-layer stack
    (B7 has no backward), so a descriptor's input gradient still flows."""
    net = zoo.HardTFeatNet()
    x = torch.rand(2, 32, 32, requires_grad=True)
    with _layout("flat"):
        net(x).sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()


def test_orinet_angle_and_rotation_match_jax():
    params = jax.tree_util.tree_map(
        np.asarray, jax.tree_util.tree_map(np.asarray, _jax_params(
            jzoo.OriNetFast32, 7)))
    net = _port_net(zoo.OriNetFast32, params)
    patches = np.random.RandomState(2).rand(9, 32, 32).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    ref_a = np.asarray(jzoo.OriNetFast32(jp, jnp.asarray(patches),
                                         return_rot_matrix=False))
    ref_r = np.asarray(jzoo.OriNetFast32(jp, jnp.asarray(patches)))
    with torch.no_grad():
        a = net.angle(torch.from_numpy(patches)).numpy()
        rot = net(torch.from_numpy(patches)).numpy()
    np.testing.assert_allclose(a, ref_a, atol=1e-5)
    np.testing.assert_allclose(rot, ref_r, atol=1e-5)
    np.testing.assert_allclose(rot[:, 0, 0], np.cos(a), atol=1e-6)
    np.testing.assert_allclose(rot[:, 0, 1], np.sin(a), atol=1e-6)
