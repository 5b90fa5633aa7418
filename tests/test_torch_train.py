"""The port's AffNet training against the JAX package on the same numpy
inputs: losses, the train-mode nets, one whole deterministic step, SGD,
schedules, data and checkpoints.

Tolerances (stated beside each check):
  - losses: values rtol 1e-5, gradients rtol 1e-4 / atol 1e-6;
  - train-mode AffNetFast: shapes atol 2e-5 (the JAX model tests'),
    input gradients per sample in relative L2 norm (see the test: ReLU
    kinks), BatchNorm statistics rtol 1e-5 / atol 1e-6;
  - one whole step (tilted warps, AffNetFast twice, rewarp, HardTFeatNet,
    HardNegC, SGD): loss rtol 1e-4; parameter gradients within 1e-3 of
    each tensor's largest magnitude (the kinks of ReLU, of floor() in the
    sampler and of the loss's min make a gradient jump where an argument
    crosses within rounding; measured 3.2e-4); BatchNorm statistics rtol
    1e-5 / atol 1e-6; parameters after SGD rtol 1e-5 / atol 1e-6.  Run
    this file as a script to print the measured differences of that step
    and the next;
  - SGD against tests/fixtures/sgd_golden.npz: rtol 1e-5 / atol 1e-7
    (tests/test_train.py);
  - data and checkpoints: bit for bit.
"""

import json
import math
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from affnet_tpu import augmentation as jaug
from affnet_tpu import data as jdata
from affnet_tpu import losses as jlosses
from affnet_tpu import train as jtrain
from affnet_tpu.laf import get_normalized_affine_shape, rotation_matrix
from affnet_tpu.models import AffNetFast as JAffNetFast
from affnet_tpu.models.cnn import input_norm as j_input_norm
from affnet_tpu.models.convert import load_pretrained as jax_load_pretrained
from affnet_tpu.ops.patches import extract_patches_batched as j_batched
from affnet_tpu_torch import data as tdata
from affnet_tpu_torch import load_pretrained, losses, train
from affnet_tpu_torch.models import (AffNetFast, HardTFeatNet,
                                     params_from_jax, params_to_jax)
from affnet_tpu_torch.models.cnn import Dropout, init_params, input_norm

FIX = os.path.join(os.path.dirname(__file__), "fixtures")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_tree_close(got, ref, of_max=None, **tol):
    """Leaf by leaf; ``of_max`` sets each leaf's atol to that fraction of
    the leaf's largest magnitude (rtol 0)."""
    assert set(got) == set(ref)
    for layer in ref:
        assert set(got[layer]) == set(ref[layer]), layer
        for k in ref[layer]:
            r = np.asarray(ref[layer][k])
            if of_max is not None:
                tol = dict(rtol=0, atol=of_max * float(np.abs(r).max()))
            np.testing.assert_allclose(got[layer][k], r,
                                       err_msg=f"{layer}/{k}", **tol)


def _affnet(params):
    net = AffNetFast()
    net.load_state_dict(params_from_jax(_np_tree(params)))
    return net.train()


def _grad_tree(net):
    return params_to_jax({n: p.grad for n, p in net.named_parameters()})


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def _descs(seed, n=24, d=128):
    rng = np.random.RandomState(seed)
    a = rng.randn(n, d).astype(np.float32)
    p = (a + 0.4 * rng.randn(n, d)).astype(np.float32)
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    p[3] = a[3]                     # an identical pair: the eps keeps it finite
    return a, p


@pytest.mark.parametrize("name", ["hardnegc", "hardnet", "hardnet_swap",
                                  "descriptor_dist"])
def test_losses_match_jax(name):
    fns = {
        "hardnegc": (losses.loss_hardnegc, jlosses.loss_hardnegc),
        "hardnet": (losses.loss_hardnet, jlosses.loss_hardnet),
        "hardnet_swap": (lambda a, p: losses.loss_hardnet(a, p, True),
                         lambda a, p: jlosses.loss_hardnet(a, p, True)),
        "descriptor_dist": (losses.descriptor_dist, jlosses.descriptor_dist),
    }
    tfn, jfn = fns[name]
    a, p = _descs(len(name))
    ref, (gja, gjp) = jax.value_and_grad(jfn, argnums=(0, 1))(
        jnp.asarray(a), jnp.asarray(p))
    ta = torch.from_numpy(a).requires_grad_(True)
    tp = torch.from_numpy(p).requires_grad_(True)
    val = tfn(ta, tp)
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(ref), rtol=1e-5)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(gja), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(gjp), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("name", ["pixels", "TFeat"])
def test_descriptors_match_jax(name):
    rng = np.random.RandomState(7)
    patches = rng.uniform(0, 1, (10, 32, 32)).astype(np.float32)
    w = rng.uniform(-1, 1, (10, 128 if name == "TFeat" else 1024))
    w = w.astype(np.float32)
    if name == "TFeat":
        # A constant patch, weighted 0: input_norm's 1e-12 keeps its
        # gradient finite (0 * inf would be NaN without it).  Its
        # descriptor is the rounding of its mean magnified by 1e6: noise in
        # either package, so it is left out of the comparison.
        patches[4] = 0.3
        w[4] = 0.0
    params = jax_load_pretrained("HardTFeatNet") if name == "TFeat" else None
    jfn = jtrain.make_descriptor(name, params)
    ref, gj = jax.value_and_grad(
        lambda x: (jfn(x) * w).sum())(jnp.asarray(patches))
    tfn = train.make_descriptor(name, _np_tree(params) if params else None,
                                device="cpu")
    tx = torch.from_numpy(patches).requires_grad_(True)
    val = (tfn(tx) * torch.from_numpy(w)).sum()
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(ref), rtol=1e-5,
                               atol=1e-5)
    assert np.isfinite(tx.grad.numpy()).all()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gj), rtol=1e-3,
                               atol=2e-5)


# ---------------------------------------------------------------------------
# The nets in train mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("detach", [True, False])
def test_input_norm_detach_matches_jax(detach):
    rng = np.random.RandomState(int(detach))
    x = rng.uniform(0, 1, (6, 1, 16, 16)).astype(np.float32)
    w = rng.uniform(-1, 1, x.shape).astype(np.float32)
    gj = jax.grad(lambda v: (j_input_norm(v, detach=detach) * w).sum())(
        jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    out = input_norm(tx, detach=detach)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(j_input_norm(jnp.asarray(x))),
                               atol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gj), rtol=1e-4,
                               atol=1e-5)


def test_affnetfast_train_mode_matches_apply_with_state():
    """Output, input gradient and the BatchNorm statistics after two chained
    passes (anchor then positive) against apply_with_state(rng=None).

    The input gradient is held per sample in relative L2 norm: median at
    most 1e-3, at most one sample above 1e-2, none above 5e-2.  A ReLU
    whose pre-activation lies within rounding of zero can take opposite
    sides in the two packages; its sample's gradient then differs at the
    1e-2 level, and the batch-statistics backward of the next BatchNorm
    spreads that over the batch.  This input has one such ReLU (layer 14,
    sample 2: -5.1e-7 here, +2.3e-6 in JAX); measured 2.4e-2 for that
    sample, median 5.4e-4, 2.3e-3 at most for the others."""
    params = JAffNetFast.init(jax.random.PRNGKey(3))
    rng = np.random.RandomState(3)
    xa = rng.uniform(0, 1, (16, 32, 32)).astype(np.float32)
    xp = rng.uniform(0, 1, (16, 32, 32)).astype(np.float32)
    w = rng.uniform(-1, 1, (16, 2, 2)).astype(np.float32)

    def jf(x, prm):
        out, new = JAffNetFast.apply_with_state(prm, x, rng=None)
        return (out * w).sum(), (out, new)

    (_, (out_a, np1)), gxa = jax.value_and_grad(jf, has_aux=True)(
        jnp.asarray(xa), params)
    _, (out_p, np2) = jf(jnp.asarray(xp), np1)

    net = _affnet(params)
    ta = torch.from_numpy(xa).requires_grad_(True)
    got_a = net(ta)
    (got_a * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got_a.detach().numpy(), np.asarray(out_a),
                               atol=2e-5)
    gt, gj = ta.grad.numpy().reshape(16, -1), np.asarray(gxa).reshape(16, -1)
    rel = np.linalg.norm(gt - gj, axis=1) / np.linalg.norm(gj, axis=1)
    assert np.isfinite(gt).all()
    assert np.median(rel) <= 1e-3 and np.sum(rel > 1e-2) <= 1, rel
    assert rel.max() <= 5e-2, rel
    _assert_tree_close(params_to_jax(net.state_dict()), np1, rtol=1e-5,
                       atol=1e-6)
    with torch.no_grad():
        got_p = net(torch.from_numpy(xp))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(out_p), atol=2e-5)
    _assert_tree_close(params_to_jax(net.state_dict()), np2, rtol=1e-5,
                       atol=1e-6)


def test_dropout_needs_train_mode_and_a_generator():
    d = Dropout(0.25).train()
    x = torch.ones(4000)
    assert d(x) is x
    y = d(x, torch.Generator().manual_seed(0))
    assert set(y.unique().tolist()) == {0.0, float(np.float32(1.0) / 0.75)}
    assert abs(float((y == 0).float().mean()) - 0.25) < 0.03
    torch.testing.assert_close(y, d(x, torch.Generator().manual_seed(0)))
    assert d.eval()(x, torch.Generator().manual_seed(0)) is x


def test_init_params_orthogonal_and_seeded():
    net = init_params(AffNetFast(), torch.Generator().manual_seed(0))
    again = init_params(AffNetFast(), torch.Generator().manual_seed(0))
    for (name, a), b in zip(net.state_dict().items(),
                            again.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    for layer in net.features:
        if isinstance(layer, torch.nn.Conv2d):
            w = layer.weight.reshape(layer.weight.shape[0], -1)
            o, f = w.shape
            gram = w @ w.T if o <= f else w.T @ w
            torch.testing.assert_close(gram, 0.64 * torch.eye(min(o, f)),
                                       rtol=0, atol=1e-5)
            if layer.bias is not None:
                assert torch.all(layer.bias == 0.01)
        elif isinstance(layer, torch.nn.BatchNorm2d):
            assert torch.all(layer.running_mean == 0)
            assert torch.all(layer.running_var == 1)
    last = init_params(AffNetFast(), torch.Generator().manual_seed(0),
                       last_gain=1.0, last_bias=(0.5, 0.0, 0.5)).features[19]
    assert last.bias.tolist() == [0.5, 0.0, 0.5]
    w = last.weight.reshape(3, -1)
    torch.testing.assert_close(w @ w.T, torch.eye(3), rtol=0, atol=1e-5)
    jax_shapes = {k: {kk: np.shape(vv) for kk, vv in v.items()} for k, v in
                  JAffNetFast.init(jax.random.PRNGKey(0)).items()}
    assert {k: {kk: vv.shape for kk, vv in v.items()} for k, v in
            params_to_jax(net.state_dict()).items()} == jax_shapes


# ---------------------------------------------------------------------------
# One whole deterministic step
# ---------------------------------------------------------------------------

def _step_inputs(n=16, seed=0):
    img = np.load(os.path.join(FIX, "detector_golden_fullres.npz"))["img"]
    patches, _ = tdata.synthetic_pairs_from_image(img, n_classes=n,
                                                  views_per_class=2,
                                                  seed=seed)
    a = patches[0::2].astype(np.float32) / 255.0
    p = patches[1::2].astype(np.float32) / 255.0
    rng = np.random.RandomState(seed + 1)

    def lafs(phi_r):
        tilt = rng.uniform(1 / 3.0, 3.0, n).astype(np.float32)
        phi = rng.uniform(-math.pi, math.pi, n).astype(np.float32)
        A = (rotation_matrix(jnp.asarray(phi_r))
             @ get_normalized_affine_shape(jnp.asarray(tilt), jnp.asarray(phi))
             @ (0.5 * jnp.eye(2)))
        return np.concatenate([np.asarray(A), np.full((n, 2, 1), 0.5)],
                              2).astype(np.float32)

    phi_r = rng.uniform(-math.pi, math.pi, n).astype(np.float32)
    return a, p, lafs(phi_r), lafs(phi_r)      # shared rotation


def _jax_step(params, buf, step, cfg, a, p, la, lp):
    desc = jtrain.make_descriptor("TFeat", jax_load_pretrained("HardTFeatNet"))

    def loss_fn(prm):
        fa = j_batched(jnp.asarray(a), jnp.asarray(la), ps=64)
        fp = j_batched(jnp.asarray(p), jnp.asarray(lp), ps=64)
        A_a, np1 = JAffNetFast.apply_with_state(prm, fa[:, 16:48, 16:48],
                                                rng=None)
        A_p, np2 = JAffNetFast.apply_with_state(np1, fp[:, 16:48, 16:48],
                                                rng=None)
        da = desc(jaug.warp_by_predicted_transform(fa, A_a, 32))
        dp = desc(jaug.warp_by_predicted_transform(fp, A_p, 32))
        return jlosses.loss_hardnegc(da, dp), np2

    (loss, np2), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    lr = jtrain.lr_at_step(jnp.asarray(step), cfg)
    new, buf = jtrain.sgd_update(params, grads, buf, lr, cfg, step=step)
    stats = {k: v for k, v in np2.items() if "mean" in v}
    new = {k: (np2[k] if k in stats else v) for k, v in new.items()}
    return float(loss), grads, stats, new, buf


def _step_diffs(n_steps=1):
    """Run ``n_steps`` steps in both packages on the same batch and warps;
    return the per-quantity pairs (port, JAX) of each step."""
    a, p, la, lp = _step_inputs()
    kw = dict(batch_size=16, n_pairs=10_000_000, epochs=20, lr=0.005,
              descriptor="TFeat", loss="HardNegC")
    jcfg, cfg = jtrain.TrainConfig(**kw), train.TrainConfig(**kw)
    params = JAffNetFast.init(jax.random.PRNGKey(0))
    buf = jtrain.init_momentum(params)
    net = _affnet(params)
    state = train.init_state(net, cfg)
    desc = train.make_descriptor("TFeat", load_pretrained("HardTFeatNet"),
                                 device="cpu")
    batch = (torch.from_numpy(a), torch.from_numpy(p))
    lafs = (torch.from_numpy(la), torch.from_numpy(lp))
    out = []
    for step in range(n_steps):
        jl, jg, jstats, params, buf = _jax_step(params, buf, step, jcfg,
                                                a, p, la, lp)
        m = train.affnet_step_core(state, desc, cfg, batch, lafs)
        sd = params_to_jax(net.state_dict())
        out.append(dict(
            loss=(float(m["loss"]), jl),
            grads=(_grad_tree(net),
                   {k: v for k, v in _np_tree(jg).items() if "w" in v}),
            stats=({k: sd[k] for k in jstats}, _np_tree(jstats)),
            params=(sd, _np_tree(params))))
    return out


def test_whole_step_matches_jax():
    for s in _step_diffs():
        np.testing.assert_allclose(*s["loss"], rtol=1e-4)
        _assert_tree_close(*s["grads"], of_max=1e-3)
        _assert_tree_close(*s["stats"], rtol=1e-5, atol=1e-6)
        _assert_tree_close(*s["params"], rtol=1e-5, atol=1e-6)


def test_posdist_step_reduces_loss():
    """Same batch and same generator each step, small LR: PosDist must fall
    (tests/test_train.py:81-101), and the BatchNorm statistics move."""
    cfg = train.TrainConfig(batch_size=16, n_pairs=100000, epochs=1,
                            descriptor="pixels", loss="PosDist", lr=5e-5)
    net = init_params(AffNetFast(), torch.Generator().manual_seed(0)).train()
    mean0 = net.features[1].running_mean.clone()
    state = train.init_state(net, cfg)
    step = train.make_affnet_train_step(train.make_descriptor("pixels"), cfg)
    a, p, _, _ = _step_inputs()
    batch = (torch.from_numpy(a), torch.from_numpy(p))
    got = [float(step(state, batch, torch.Generator().manual_seed(42),
                      3.0)["loss"]) for _ in range(6)]
    assert np.isfinite(got).all()
    assert got[-1] < got[0]
    assert not torch.allclose(net.features[1].running_mean, mean0)
    assert state.step == 6


# ---------------------------------------------------------------------------
# SGD and schedules
# ---------------------------------------------------------------------------

def test_sgd_matches_torch_golden():
    gold = np.load(os.path.join(FIX, "sgd_golden.npz"))
    cfg = train.TrainConfig(lr=float(gold["lr"]), wd=float(gold["wd"]),
                            momentum=float(gold["momentum"]),
                            dampening=float(gold["dampening"]),
                            batch_size=1, n_pairs=10 ** 9, epochs=1)
    layer = torch.nn.Linear(3, 4, bias=False)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(gold["w0"]))
    state = train.init_state(layer, cfg)
    target = torch.from_numpy(gold["target"])
    for i in range(gold["params"].shape[0]):
        state.optimizer.zero_grad()
        ((layer.weight - target) ** 2).sum().backward()
        state.optimizer.step()
        np.testing.assert_allclose(layer.weight.detach().numpy(),
                                   gold["params"][i], rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(
            state.optimizer.state[layer.weight]["momentum_buffer"].numpy(),
            gold["momentum_buffers"][i], rtol=1e-5, atol=1e-7)


def test_resumed_state_damps_from_the_first_step():
    """A resumed JAX state starts from zero momentum with step != 0, so its
    first update is damped; init_state(start_step > 0) does the same."""
    cfg = train.TrainConfig(lr=0.1, wd=0.0)
    p = torch.nn.Parameter(torch.zeros(3))
    state = train.init_state(torch.nn.ParameterList([p]), cfg, start_step=5)
    p.grad = torch.ones(3)
    state.optimizer.step()
    torch.testing.assert_close(p.detach(), torch.full((3,), -0.1 * 0.1))


@pytest.mark.parametrize("epoch", [0, 1, 2, 3, 4, 5, 7, 9, 100])
def test_tilt_schedule_matches_jax(epoch):
    assert train.tilt_for_epoch(epoch) == jtrain.tilt_for_epoch(epoch)


@pytest.mark.parametrize("total", [None, 20])
def test_lr_at_step_matches_jax(total):
    kw = dict(lr=0.005, batch_size=1024, n_pairs=10_000_000, epochs=4,
              total_epochs=total)
    cfg, jcfg = train.TrainConfig(**kw), jtrain.TrainConfig(**kw)
    for step in (0, 1, 7, 1000, 9765, 39060, 39062, 40000, 10 ** 6):
        ref = float(jtrain.lr_at_step(jnp.asarray(step), jcfg))
        assert train.lr_at_step(step, cfg) == ref
    assert train.lr_at_step(10 ** 7, cfg) == 0.0      # the clamp


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

def test_generate_pairs_bit_identical():
    labels = np.random.RandomState(0).randint(0, 60, 400)
    labels[:2] = 999                             # a two-member class
    got = tdata.generate_pairs(labels, 500, 32, np.random.RandomState(4))
    ref = jdata.generate_pairs(labels, 500, 32, np.random.RandomState(4))
    np.testing.assert_array_equal(got, ref)


def test_synthetic_pairs_and_pair_dataset_bit_identical():
    img = np.load(os.path.join(FIX, "detector_golden_fullres.npz"))["img"]
    got = tdata.synthetic_pairs_from_image(img, n_classes=40,
                                           views_per_class=3, seed=2)
    ref = jdata.synthetic_pairs_from_image(img, n_classes=40,
                                           views_per_class=3, seed=2)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
    ours = tdata.PairDataset(*got, n_pairs=96, batch_size=32, seed=5)
    theirs = jdata.PairDataset(*ref, n_pairs=96, batch_size=32, seed=5)
    np.testing.assert_array_equal(ours.pairs, theirs.pairs)
    n = 0
    for (a, p), (ra, rp) in zip(ours.batches(), theirs.batches()):
        np.testing.assert_array_equal(a, ra)
        np.testing.assert_array_equal(p, rp)
        n += 1
    assert n == 3


@pytest.mark.parametrize("fliprot", [True, False])
def test_device_pair_dataset_equals_host_on_cpu(fliprot):
    rng = np.random.RandomState(1)
    patches = rng.randint(0, 256, (120, 64, 64)).astype(np.uint8)
    labels = np.repeat(np.arange(40), 3)
    host = tdata.PairDataset(patches, labels, n_pairs=64, batch_size=16,
                             fliprot=fliprot, seed=3)
    dev = tdata.DevicePairDataset(
        tdata.PairDataset(patches, labels, n_pairs=64, batch_size=16,
                          fliprot=fliprot, seed=3), device="cpu")
    assert len(dev) == len(host) == 64
    n = 0
    for (a, p), (ta, tp) in zip(host.batches(), dev.batches()):
        assert ta.dtype == torch.float32
        np.testing.assert_array_equal(ta.numpy(), a)
        np.testing.assert_array_equal(tp.numpy(), p)
        n += 1
    assert n == 4


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_port_to_jax(tmp_path):
    net = init_params(AffNetFast(), torch.Generator().manual_seed(1))
    with torch.no_grad():
        net.features[1].running_mean.add_(0.25)
    path = os.path.join(tmp_path, "ck.npz")
    train.save_checkpoint(path, net, epoch=7)
    loaded, epoch = jtrain.load_checkpoint(path)
    assert epoch == 7
    _assert_tree_close(_np_tree(loaded), params_to_jax(net.state_dict()),
                       rtol=0, atol=0)
    x = np.random.RandomState(0).uniform(0, 1, (4, 32, 32)).astype(np.float32)
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(JAffNetFast(loaded,
                                                           jnp.asarray(x))),
                               atol=2e-5)


def test_checkpoint_jax_to_port(tmp_path):
    params = JAffNetFast.init(jax.random.PRNGKey(4))
    path = os.path.join(tmp_path, "ck.npz")
    jtrain.save_checkpoint(path, params, epoch=3)
    tree, epoch = train.load_checkpoint(path)
    assert epoch == 3
    _assert_tree_close(tree, _np_tree(params), rtol=0, atol=0)
    net = AffNetFast()
    net.load_state_dict(params_from_jax(tree))
    _assert_tree_close(params_to_jax(net.state_dict()), _np_tree(params),
                       rtol=0, atol=0)


def test_params_to_jax_inverts_params_from_jax():
    tree = _np_tree(jax_load_pretrained("HardTFeatNet"))
    net = HardTFeatNet()
    net.load_state_dict(params_from_jax(tree))
    _assert_tree_close(params_to_jax(net.state_dict()), tree, rtol=0, atol=0)
    with pytest.raises(KeyError):
        params_to_jax({"head.0.weight": torch.zeros(1)})


# ---------------------------------------------------------------------------
# The loop
# ---------------------------------------------------------------------------

class _TinyData:
    def batches(self):
        rng = np.random.RandomState(0)
        for _ in range(2):
            yield (rng.rand(8, 64, 64).astype(np.float32),
                   rng.rand(8, 64, 64).astype(np.float32))


def test_train_loop_resume_starts_at_global_step(tmp_path):
    """As tests/test_train.py:382: the step (and so the LR) resumes at the
    global position; the checkpoint carries the next epoch."""
    cfg = train.TrainConfig(batch_size=8, n_pairs=16, epochs=1,
                            total_epochs=10, descriptor="pixels",
                            loss="PosDist", log_interval=1)
    state = train.train_loop(AffNetFast(), _TinyData(), cfg,
                             log_dir=str(tmp_path), start_epoch=3,
                             device="cpu")
    assert state.step == 3 * 2 + 2
    with open(os.path.join(tmp_path, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["lr"] for r in recs] == [train.lr_at_step(s, cfg)
                                       for s in (6, 7)]
    tree, epoch = jtrain.load_checkpoint(
        os.path.join(tmp_path, "checkpoint_3.npz"))
    assert epoch == 4 and set(tree) == set(
        JAffNetFast.init(jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="past the LR schedule end"):
        train.train_loop(AffNetFast(), _TinyData(), cfg,
                         log_dir=str(tmp_path), start_epoch=10, device="cpu")


def test_train_loop_is_seeded(tmp_path):
    cfg = train.TrainConfig(batch_size=8, n_pairs=16, epochs=1,
                            descriptor="pixels", loss="HardNegC")
    runs = []
    for i in range(2):
        st = train.train_loop(AffNetFast(), _TinyData(), cfg,
                              log_dir=os.path.join(tmp_path, str(i)),
                              device="cpu")
        runs.append(params_to_jax(st.model.state_dict()))
    _assert_tree_close(runs[0], runs[1], rtol=0, atol=0)


if __name__ == "__main__":
    # As tests/conftest.py sets it: the Pallas sampler interpreted on the CPU.
    from affnet_tpu.ops import pallas_patches
    pallas_patches.INTERPRET = True
    for i, s in enumerate(_step_diffs(2)):
        print(f"step {i}: loss {s['loss'][0]:.8f} vs {s['loss'][1]:.8f}")
        for key in ("grads", "stats", "params"):
            got, ref = s[key]
            worst = max(
                (float(np.max(np.abs(got[l][k] - ref[l][k]))
                       / np.max(np.abs(ref[l][k]))), f"{l}/{k}",
                 float(np.max(np.abs(got[l][k] - ref[l][k]))))
                for l in ref for k in ref[l])
            print(f"  {key}: max |diff| / max |ref| {worst[0]:.3g} at "
                  f"{worst[1]} (max |diff| {worst[2]:.3g})")
