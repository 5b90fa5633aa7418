"""The port's OriNet, descriptor and triplet AffNet steps against the JAX
package's step functions rebuilt from its own building blocks, with the
same draws (``jax.random`` streams cannot be reproduced, so both sides get
the same warps, shifts and flips), and the new descriptors, losses and
loop modes.

Tolerances, as ``tests/test_torch_train.py`` holds the AffNet step: loss
rtol 1e-4; parameter gradients within 1e-3 of each tensor's largest
magnitude (kinks of ReLU, of max pooling, of floor() in the sampler and of
the loss's min and hinge make a gradient jump where an argument crosses
within rounding); BatchNorm statistics rtol 1e-5 / atol 1e-6; parameters
after SGD rtol 1e-5 / atol 1e-6, against JAX's ``sgd_update`` of the
port's gradients and, where the gradients hold 1e-3, against JAX's own
step.  Three steps cross more kinks than that bound allows, and each
gradient bound is stated beside its case (``GRAD_OF_MAX``) with what was
measured: the port against JAX, and the port against itself when 1e-6 of
noise is added to the anchors (its own float32 sensitivity, the same
order).  OriNet's atan2 is not among the causes: the predicted (x0, x1)
stay far from the origin (checked below).
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
from affnet_tpu import losses as jlosses
from affnet_tpu import train as jtrain
from affnet_tpu.laf import get_normalized_affine_shape, rotation_matrix
from affnet_tpu.models import AffNetFast as JAffNetFast
from affnet_tpu.models import HardNet as JHardNet
from affnet_tpu.models import OriNetFast32 as JOriNetFast32
from affnet_tpu.models.cnn import l2norm as j_l2norm
from affnet_tpu.models.convert import load_pretrained as jax_load_pretrained
from affnet_tpu.ops.patches import extract_patches_batched as j_batched
from affnet_tpu_torch import data as tdata
from affnet_tpu_torch import train
from affnet_tpu_torch.models import (REGISTRY, AffNetFast, HardNet,
                                     OriNetFast32, params_from_jax,
                                     params_to_jax)
from affnet_tpu_torch.models.cnn import init_params

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
N = 16


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


def _patches(n=N, views=2, seed=0):
    """(views) stacks of n 64x64 patches in [0, 1], one class per row."""
    img = np.load(os.path.join(FIX, "detector_golden_fullres.npz"))["img"]
    patches, _ = tdata.synthetic_pairs_from_image(img, n_classes=n,
                                                  views_per_class=views,
                                                  seed=seed)
    return [patches[v::views].astype(np.float32) / 255.0
            for v in range(views)]


def _tilt_lafs(rng, n, phi_r):
    tilt = rng.uniform(1 / 3.0, 3.0, n).astype(np.float32)
    phi = rng.uniform(-math.pi, math.pi, n).astype(np.float32)
    A = (rotation_matrix(jnp.asarray(phi_r))
         @ get_normalized_affine_shape(jnp.asarray(tilt), jnp.asarray(phi))
         @ (0.5 * jnp.eye(2)))
    return np.concatenate([np.asarray(A), np.full((n, 2, 1), 0.5)],
                          2).astype(np.float32)


def _sgd_and_stats(params, grads, np_last, buf, step, cfg):
    lr = jtrain.lr_at_step(jnp.asarray(step), cfg)
    new, buf = jtrain.sgd_update(params, grads, buf, lr, cfg, step=step)
    stats = {k: v for k, v in np_last.items() if "mean" in v}
    new = {k: (np_last[k] if k in stats else v) for k, v in new.items()}
    return stats, new


# Gradient bounds (fractions of each tensor's largest magnitude) of the
# steps that cross more kinks than 1e-3 allows, measured on these inputs:
# (port against JAX, port against itself under 1e-6 anchor noise).
GRAD_OF_MAX = {
    "descriptor": 3e-2,     # (1.5e-2, 2.0e-2): HardNet from its init
    "orinet-HardNet": 5e-2,  # (1.9e-2, 4.8e-2): HardNet's ReLUs in the
    #                          descriptor's backward
    "random_sampling": 1.5e-2,  # (7.9e-3, 5.2e-3): the triplet hinge
}


def _compare(net, metrics, jloss, jgrads, jstats, jparams, params, cfg,
             grad_of_max=1e-3):
    """Loss, gradients, BatchNorm statistics and parameters after SGD of
    the port's ``net`` against JAX's (see the module docstring)."""
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss),
                               rtol=1e-4)
    got_g = params_to_jax({n: p.grad for n, p in net.named_parameters()})
    _assert_tree_close(got_g, {k: v for k, v in _np_tree(jgrads).items()
                               if "w" in v}, of_max=grad_of_max)
    sd = params_to_jax(net.state_dict())
    _assert_tree_close({k: sd[k] for k in jstats}, _np_tree(jstats),
                       rtol=1e-5, atol=1e-6)
    full_g = {k: dict(v, **got_g.get(k, {})) for k, v in jgrads.items()}
    _, sgd_of_ours = _sgd_and_stats(params, full_g, jstats,
                                    jtrain.init_momentum(params), 0, cfg)
    _assert_tree_close(sd, _np_tree(sgd_of_ours), rtol=1e-5, atol=1e-6)
    if grad_of_max <= 1e-3:
        _assert_tree_close(sd, _np_tree(jparams), rtol=1e-5, atol=1e-6)


def _net(cls, params):
    net = cls()
    net.load_state_dict(params_from_jax(_np_tree(params)))
    return net.train()


def _descriptors(name):
    """(JAX descriptor fn, port descriptor fn) with the same weights:
    HardNet from JAX's seeded init, TFeat shipped, SIFT weight-free."""
    params = {"HardNet": lambda: JHardNet.init(jax.random.PRNGKey(11)),
              "TFeat": lambda: jax_load_pretrained("HardTFeatNet"),
              "SIFT": lambda: None}[name]()
    return (jtrain.make_descriptor(name, params),
            train.make_descriptor(name, None if params is None
                                  else _np_tree(params), device="cpu"))


# ---------------------------------------------------------------------------
# The descriptor step (HardNet from scratch)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flips", [(False, False), (True, True)])
def test_descriptor_step_matches_jax(flips):
    a, p = _patches()
    kw = dict(arch="HardNet", batch_size=N, n_pairs=500000, epochs=10,
              lr=0.1, loss="HardNet")
    jcfg, cfg = jtrain.TrainConfig(**kw), train.TrainConfig(**kw)
    params = JHardNet.init(jax.random.PRNGKey(2))

    def loss_fn(prm):
        ja, jp = jaug.fliprot(key, a, p)
        fa, np1 = JHardNet.features(prm, ja[:, 16:48, 16:48], train=True,
                                    rng=None)
        fp, np2 = JHardNet.features(np1, jp[:, 16:48, 16:48], train=True,
                                    rng=None)
        return jlosses.loss_hardnet(j_l2norm(fa), j_l2norm(fp)), np2

    # The key whose fliprot draws are ``flips``.
    key = next(k for k in (jax.random.PRNGKey(i) for i in range(64))
               if tuple(bool(jax.random.bernoulli(s))
                        for s in jax.random.split(k)) == flips)
    (jl, np2), jg = jax.value_and_grad(loss_fn, has_aux=True)(params)
    jstats, jnew = _sgd_and_stats(params, jg, np2,
                                  jtrain.init_momentum(params), 0, jcfg)

    net = _net(HardNet, params)
    state = train.init_state(net, cfg)
    m = train.descriptor_step_core(state, cfg, (torch.from_numpy(a),
                                                 torch.from_numpy(p)), flips)
    _compare(net, m, jl, jg, jstats, jnew, params, jcfg,
             GRAD_OF_MAX["descriptor"])
    assert state.step == 1


# ---------------------------------------------------------------------------
# The OriNet step
# ---------------------------------------------------------------------------

def _orinet_draw(seed, n=N):
    rng = np.random.RandomState(seed)
    phi = rng.uniform(-1, 1, n).astype(np.float32)
    rot = np.asarray(rotation_matrix(jnp.asarray(math.pi * phi)))
    inv = np.asarray(rotation_matrix(jnp.asarray(-math.pi * phi)))
    rot_lafs = np.concatenate([0.5 * rot, np.full((n, 2, 1), 0.5,
                                                  np.float32)], 2)
    scale = (0.9 + 0.3 * rng.uniform(0, 1, n)).astype(np.float32)
    shifts = [(rng.randint(0, 4, n) - 1).astype(np.float32) / 2.0
              for _ in range(2)]
    return rot_lafs.astype(np.float32), inv, scale, shifts[0], shifts[1]


@pytest.mark.parametrize("loss,descriptor", [("HardNet", "HardNet"),
                                             ("Geom", "SIFT")])
def test_orinet_step_matches_jax(loss, descriptor):
    a, p = _patches(seed=1)
    draw = _orinet_draw(3)
    kw = dict(arch="OriNetFast32", batch_size=N, n_pairs=10_000_000,
              epochs=20, lr=0.005, loss=loss, descriptor=descriptor)
    jcfg, cfg = jtrain.TrainConfig(**kw), train.TrainConfig(**kw)
    jdesc, tdesc = _descriptors(descriptor)
    params = JOriNetFast32.init(jax.random.PRNGKey(4))
    rot_lafs, inv_rotmat, scale, shift_w, shift_h = (jnp.asarray(x)
                                                     for x in draw)
    def loss_fn(prm):
        # affnet_tpu/train.py make_orinet_train_step's loss_fn after its
        # draws, on the given ones.
        A = rot_lafs[:, 0:2, 0:2] * scale[:, None, None]
        t = jnp.stack([rot_lafs[:, 0, 2] + shift_w / 64,
                       rot_lafs[:, 1, 2] + shift_h / 64], -1)[..., None]
        data_a_rot = j_batched(jnp.asarray(a), jnp.concatenate([A, t], 2),
                               ps=64)
        out_a, np1 = JOriNetFast32.features(prm, data_a_rot[:, 16:48, 16:48],
                                            train=True, rng=None)
        out_p, np2 = JOriNetFast32.features(np1, jnp.asarray(p)[:, 16:48,
                                                                16:48],
                                            train=True, rng=None)
        R_a = rotation_matrix(jnp.arctan2(out_a[:, 0] + 1e-8,
                                          out_a[:, 1] + 1e-8))
        R_p = rotation_matrix(jnp.arctan2(out_p[:, 0] + 1e-8,
                                          out_p[:, 1] + 1e-8))
        da = jdesc(jaug.warp_by_predicted_transform(data_a_rot, R_a, 32))
        dp = jdesc(jaug.warp_by_predicted_transform(jnp.asarray(p), R_p, 32))
        geom = jnp.mean(jnp.sqrt(jnp.sum((R_a - inv_rotmat @ R_p) ** 2,
                                         axis=(1, 2)) + 1e-8))
        return jtrain.apply_loss(loss, da, dp, geom), (np2, out_a, out_p)

    (jl, (np2, out_a, out_p)), jg = jax.value_and_grad(
        loss_fn, has_aux=True)(params)
    jstats, jnew = _sgd_and_stats(params, jg, np2,
                                  jtrain.init_momentum(params), 0, jcfg)
    # atan2's kink at the origin is far: every |(x0, x1)| is large.
    radius = np.hypot(*np.asarray(jnp.concatenate([out_a, out_p])).T)
    assert radius.min() > 1e-3, radius.min()

    net = _net(OriNetFast32, params)
    state = train.init_state(net, cfg)
    m = train.orinet_step_core(state, tdesc, cfg,
                               (torch.from_numpy(a), torch.from_numpy(p)),
                               tuple(torch.from_numpy(x) for x in draw))
    _compare(net, m, jl, jg, jstats, jnew, params, jcfg,
             GRAD_OF_MAX.get(f"orinet-{descriptor}", 1e-3))


def test_draw_orinet_ranges():
    gen = torch.Generator().manual_seed(0)
    rot_lafs, inv, scale, sw, sh = train.draw_orinet(500, gen)
    eye = torch.eye(2).expand(500, 2, 2)
    torch.testing.assert_close(2 * rot_lafs[:, :, :2] @ inv, eye)
    assert float(scale.min()) >= 0.9 and float(scale.max()) < 1.2
    for s in (sw, sh):
        assert set(s.tolist()) == {-0.5, 0.0, 0.5, 1.0}
    lafs = train.orinet_lafs((rot_lafs, inv, scale, sw, sh), 64, 64)
    torch.testing.assert_close(lafs[:, :, 2], 0.5 + torch.stack([sw, sh],
                                                                 1) / 64)


# ---------------------------------------------------------------------------
# The AffNet step: triplets, and a trained HardNet or SIFT as descriptor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("loss,descriptor", [("random_sampling", "TFeat"),
                                             ("HardNegC", "HardNet"),
                                             ("HardNet", "SIFT")])
def test_affnet_step_matches_jax(loss, descriptor):
    triplet = loss == "random_sampling"
    views = _patches(views=2, seed=2)
    if triplet:
        views.append(views[0][::-1].copy())    # other classes: negatives
    rng = np.random.RandomState(5)
    phi_r = rng.uniform(-math.pi, math.pi, N).astype(np.float32)
    lafs = [_tilt_lafs(rng, N, phi_r), _tilt_lafs(rng, N, phi_r)]
    if triplet:
        lafs.append(_tilt_lafs(rng, N, rng.uniform(-math.pi, math.pi, N)
                               .astype(np.float32)))
    kw = dict(batch_size=N, n_pairs=10_000_000, epochs=20, lr=0.005,
              descriptor=descriptor, loss=loss)
    jcfg, cfg = jtrain.TrainConfig(**kw), train.TrainConfig(**kw)
    jdesc, tdesc = _descriptors(descriptor)
    params = JAffNetFast.init(jax.random.PRNGKey(6))

    def loss_fn(prm):
        # affnet_tpu/train.py make_affnet_train_step's loss_fn after its
        # draws: the BatchNorm statistics chain a -> p -> n.
        descs, state = [], prm
        for x, laf in zip(views, lafs):
            full = j_batched(jnp.asarray(x), jnp.asarray(laf), ps=64)
            A, state = JAffNetFast.apply_with_state(
                state, full[:, 16:48, 16:48], rng=None)
            descs.append(jdesc(jaug.warp_by_predicted_transform(full, A,
                                                                32)))
        desc_n = descs[2] if triplet else None
        return jtrain.apply_loss(loss, descs[0], descs[1],
                                 desc_n=desc_n), state

    (jl, np_last), jg = jax.value_and_grad(loss_fn, has_aux=True)(params)
    jstats, jnew = _sgd_and_stats(params, jg, np_last,
                                  jtrain.init_momentum(params), 0, jcfg)
    net = _net(AffNetFast, params)
    state = train.init_state(net, cfg)
    m = train.affnet_step_core(state, tdesc, cfg,
                               tuple(torch.from_numpy(x) for x in views),
                               tuple(torch.from_numpy(x) for x in lafs))
    _compare(net, m, jl, jg, jstats, jnew, params, jcfg,
             GRAD_OF_MAX.get(loss, 1e-3))


def test_draw_affnet_lafs_negative_has_its_own_rotation():
    gen = torch.Generator().manual_seed(0)
    a, p, n = train.draw_affnet_lafs(64, 3.0, gen, shared_rot=True,
                                     negative=True)
    again = train.draw_affnet_lafs(64, 3.0, torch.Generator().manual_seed(0),
                                   shared_rot=True)
    assert torch.equal(a, again[0]) and torch.equal(p, again[1])
    for x in (a, p, n):     # rotation x det-1 tilt, both on the base LAF
        torch.testing.assert_close(torch.linalg.det(x[:, :, :2]),
                                   torch.full((64,), 0.0625))
    assert not torch.allclose(n, a) and not torch.allclose(n, p)


# ---------------------------------------------------------------------------
# Descriptors and losses of the trainers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["SIFT", "HardNet"])
def test_new_descriptors_match_jax(name):
    rng = np.random.RandomState(9)
    patches = rng.uniform(0, 1, (10, 32, 32)).astype(np.float32)
    w = rng.uniform(-1, 1, (10, 128)).astype(np.float32)
    jfn, tfn = _descriptors(name)
    ref, gj = jax.value_and_grad(
        lambda x: (jfn(x) * w).sum())(jnp.asarray(patches))
    tx = torch.from_numpy(patches).requires_grad_(True)
    val = (tfn(tx) * torch.from_numpy(w)).sum()
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(ref), rtol=1e-5,
                               atol=1e-5)
    got, ref = tx.grad.numpy(), np.asarray(gj)
    if name == "SIFT":
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=2e-5)
    else:
        # Per sample in relative L2 norm: one sample crosses a ReLU kink
        # (measured 8.0e-4; 6e-7 for the others; the port alone moves
        # one sample by 2.2e-3 under 1e-6 of input noise).
        rel = (np.linalg.norm((got - ref).reshape(10, -1), axis=1)
               / np.linalg.norm(ref.reshape(10, -1), axis=1))
        assert np.median(rel) <= 1e-5 and rel.max() <= 5e-3, rel
    if name == "HardNet":
        assert not tfn.training
        assert not any(q.requires_grad for q in tfn.parameters())
        with pytest.raises(ValueError, match="needs its weights"):
            train.make_descriptor("HardNet", None, device="cpu")


def test_apply_loss_new_names():
    a, p, n = (torch.from_numpy(x.reshape(N, -1)[:, :128].copy())
               for x in _patches(views=3, seed=4))
    geom = torch.tensor(0.25)
    assert train.apply_loss("Geom", a, p, geom) is geom
    torch.testing.assert_close(
        train.apply_loss("random_sampling", a, p, desc_n=n),
        train.losses.loss_random_sampling(a, p, n))
    with pytest.raises(ValueError, match="triplet batches"):
        train.apply_loss("random_sampling", a, p)
    with pytest.raises(ValueError, match="Geom"):
        train.apply_loss("Geom", a, p)
    with pytest.raises(ValueError, match="Unknown loss"):
        train.apply_loss("L2Net", a, p)


def test_registry_names_the_ported_nets():
    assert sorted(REGISTRY) == ["AffNetFast", "HardNet", "HardTFeatNet",
                                "OriNetFast", "OriNetFast32"]
    assert isinstance(REGISTRY["OriNetFast32"](), OriNetFast32)
    with pytest.raises(KeyError, match="AffNetFast4.*HardTFeatNet"):
        REGISTRY["AffNetFast4"]


# ---------------------------------------------------------------------------
# The loop's modes and its eval hook
# ---------------------------------------------------------------------------

class _Pairs:
    def __init__(self, n_batches=2, n=8, views=2):
        self.n_batches, self.n, self.views = n_batches, n, views

    def batches(self):
        rng = np.random.RandomState(0)
        for _ in range(self.n_batches):
            yield tuple(rng.rand(self.n, 64, 64).astype(np.float32)
                        for _ in range(self.views))


@pytest.mark.parametrize("mode,arch,views,loss,descriptor", [
    ("descriptor", "HardNet", 2, "HardNet", "pixels"),
    ("orinet", "OriNetFast32", 2, "HardNet", "pixels"),
    ("affnet", "AffNetFast", 3, "random_sampling", "pixels")])
def test_train_loop_modes_and_eval_hook(tmp_path, mode, arch, views, loss,
                                        descriptor):
    cfg = train.TrainConfig(arch=arch, batch_size=8, n_pairs=16, epochs=2,
                            loss=loss, descriptor=descriptor,
                            log_interval=1, seed=3)
    calls = []

    def hook(model, epoch):
        calls.append((epoch, model.training,
                      params_to_jax(model.state_dict())))

    state = train.train_loop(REGISTRY[arch](), _Pairs(views=views), cfg,
                             log_dir=str(tmp_path), device="cpu", mode=mode,
                             eval_fn=hook)
    assert state.step == 4 and state.model.training
    assert [c[:2] for c in calls] == [(0, False), (1, False)]
    # The hook sees each epoch's net, as its checkpoint holds it.
    for epoch, _, tree in calls:
        saved, saved_epoch = train.load_checkpoint(
            os.path.join(tmp_path, f"checkpoint_{epoch}.npz"))
        assert saved_epoch == epoch + 1
        _assert_tree_close(saved, tree, rtol=0, atol=0)
    with open(os.path.join(tmp_path, "metrics.jsonl")) as f:
        losses = [json.loads(line)["loss"] for line in f]
    assert len(losses) == 4 and np.isfinite(losses).all()
    # The seeded init uses the net's gain: OriNet's 0.9, the others' 0.8.
    fresh = init_params(REGISTRY[arch](), torch.Generator()
                              .manual_seed(3), gain=REGISTRY[arch].init_gain)
    w = fresh.features[0].weight.reshape(fresh.features[0].weight.shape[0],
                                         -1)
    gram = w @ w.T if w.shape[0] <= w.shape[1] else w.T @ w
    gain = 0.9 if mode == "orinet" else 0.8
    torch.testing.assert_close(torch.diagonal(gram),
                               torch.full((min(w.shape),), gain ** 2))


def test_train_loop_ori_flag_is_orinet_mode(tmp_path):
    cfg = train.TrainConfig(arch="OriNetFast32", batch_size=8, n_pairs=8,
                            epochs=1, loss="Geom", descriptor="pixels")
    runs = []
    for i, kw in enumerate([dict(ori=True), dict(mode="orinet")]):
        st = train.train_loop(OriNetFast32(), _Pairs(1), cfg,
                              log_dir=os.path.join(tmp_path, str(i)),
                              device="cpu", **kw)
        runs.append(params_to_jax(st.model.state_dict()))
    _assert_tree_close(runs[0], runs[1], rtol=0, atol=0)
