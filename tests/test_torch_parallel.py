"""The port's data parallelism (``affnet_tpu_torch/parallel.py``) on the
CPU: two gloo ranks against one process on the global batch, and against
the JAX package's sharded step.

Every case spawns its ranks through ``parallel.spawn`` (``file://``
rendezvous in a fresh temporary directory, so the test workers do not race
for ports); the rank workers live in the package (``parallel.run_steps``,
the trainers' ``_rank_main``), since spawned children import them.  Two
groups are spawned in all: one for the five training steps and the JAX
case together, one for the AffNet program.

Tolerances (summation order differs between one process and two ranks):
  - one step at batch 16 (AffNet with HardNegC and with HardNet ``min``,
    the descriptor step, the OriNet step, the triplet step; dropout on):
    loss rtol 1e-5 (measured within 4.8e-7); BatchNorm running statistics
    atol 1e-6 (measured 1.2e-7); each parameter after SGD within 2e-3 of
    the largest magnitude of its one-process update (measured 3.0e-4 in
    the AffNet step with HardNet ``min``, whose hardest negatives cross
    kinks; the others 2.7e-6 to 3.4e-5); both ranks hold equal parameters
    and statistics, exactly;
  - the sharded AffNet loss on JAX's warps, dropout off, against JAX's
    ``shard_train_step`` on the 8-device CPU mesh: rtol 1e-4 (the JAX
    sharded-against-one-device test's tolerance);
  - ``shard_apply`` against one device: atol 1e-5 (JAX's test's);
  - the sharded image pipeline against per-image runs: equal;
  - ``train_affnet --mesh 2`` (2 steps) against ``--mesh 1``: the
    checkpoint within atol 1e-4 (measured 1.8e-6), the logged loss rtol
    1e-5; ``--mesh 1`` (a group of one in this process) equals ``--mesh
    0`` bit for bit.
"""

import glob
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from affnet_tpu import augmentation as jaug
from affnet_tpu import losses as jlosses
from affnet_tpu import train as jtrain
from affnet_tpu.models import AffNetFast as JAffNetFast
from affnet_tpu.ops.patches import extract_patches_batched as j_batched
from affnet_tpu.parallel import make_mesh as jmake_mesh
from affnet_tpu.parallel import shard_train_step as jshard_train_step
from affnet_tpu_torch import data as tdata
from affnet_tpu_torch import parallel
from affnet_tpu_torch.cli import hesaffnet, train_affnet
from affnet_tpu_torch.detector import (DetectorConfig,
                                       ScaleSpaceAffinePatchExtractor)
from affnet_tpu_torch.models import (REGISTRY, AffNetFast, params_from_jax,
                                     params_to_jax)
from affnet_tpu_torch.models.cnn import init_params
from affnet_tpu_torch.train import TrainConfig, load_checkpoint

from test_torch_train import _step_inputs

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
N = 16

# name -> (mode, arch, loss, views per sample)
STEPS = {"affnet_hardnegc": ("affnet", "AffNetFast", "HardNegC", 2),
         "affnet_hardnet": ("affnet", "AffNetFast", "HardNet", 2),
         "descriptor": ("descriptor", "HardNet", "HardNet", 2),
         "orinet": ("orinet", "OriNetFast32", "HardNet", 2),
         "triplet": ("affnet", "AffNetFast", "random_sampling", 3)}


def _fixture_patches(n_classes, views, seed):
    img = np.load(os.path.join(FIX, "detector_golden_fullres.npz"))["img"]
    return tdata.synthetic_pairs_from_image(
        img.astype(np.float64), n_classes=n_classes, views_per_class=views,
        seed=seed)


def _start(arch, seed):
    net = REGISTRY[arch]()
    init_params(net, torch.Generator().manual_seed(seed), gain=net.init_gain)
    return params_to_jax(net.state_dict())


def _cases():
    patches, _ = _fixture_patches(N, 3, seed=0)
    x = patches.astype(np.float32) / 255.0
    cases = {}
    for i, (name, (mode, arch, loss, views)) in enumerate(STEPS.items()):
        cfg = TrainConfig(arch=arch, descriptor="pixels", loss=loss,
                          batch_size=N, n_pairs=N, epochs=1, seed=i,
                          lr=0.1 if mode == "descriptor" else 0.005)
        # Views 0, 1 of each class; the negatives are view 2 of the next.
        batch = (x[0::3], x[1::3], np.roll(x[2::3], 1, axis=0))[:views]
        cases[name] = dict(mode=mode, arch=arch, cfg=cfg, batches=[batch],
                           start=_start(arch, i))
    a, p, la, lp = _step_inputs()
    cfg = TrainConfig(batch_size=N, descriptor="pixels", loss="HardNet")
    cases["jax_draws"] = dict(
        mode="affnet", arch="AffNetFast", cfg=cfg, batches=[(a, p)],
        start=jax.tree_util.tree_map(
            np.asarray, JAffNetFast.init(jax.random.PRNGKey(0))),
        draws=[(la, lp)])
    return cases


@pytest.fixture(scope="module")
def steps():
    """(cases, one-process results, rank 0's results over two ranks)."""
    cases = _cases()
    one = dict(zip(cases, parallel.run_steps(
        0, torch.device("cpu"), None, list(cases.values()))))
    two = dict(zip(cases, parallel.spawn(parallel.run_steps, 2, "cpu",
                                         args=(list(cases.values()),))))
    return cases, one, two


@pytest.mark.parametrize("name", list(STEPS))
def test_sharded_step_matches_one_process(steps, name):
    cases, one, two = steps
    ref, got = one[name], two[name]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
    assert got["rank_spread"] == 0.0
    start = {k: v.numpy() for k, v in params_from_jax(
        cases[name]["start"]).items() if v.is_floating_point()}
    for key, r in ref["state"].items():
        g = got["state"][key]
        if "running" in key:
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-6, err_msg=key)
        else:
            update = float(np.abs(r - start[key]).max())
            assert update > 0, key
            err = float(np.abs(g - r).max())
            assert err <= 2e-3 * update, (key, err / update)


def test_sharded_loss_matches_jax_sharded_step(steps):
    """The AffNet step's loss on JAX's warps and the global batch of 16,
    dropout off: the port's two gloo ranks against JAX's
    ``shard_train_step`` on the 8-device CPU mesh (HardNet ``min``
    loss, pixels descriptor, global BatchNorm by GSPMD)."""
    cases, one, two = steps
    case = cases["jax_draws"]
    (a, p), (la, lp) = case["batches"][0], case["draws"][0]
    desc = jtrain.make_descriptor("pixels")

    def step(state, batch, key, max_tilt):
        a, p, la, lp = batch

        def loss_fn(prm):
            fa = j_batched(a, la, ps=64)
            fp = j_batched(p, lp, ps=64)
            A_a, np1 = JAffNetFast.apply_with_state(prm, fa[:, 16:48, 16:48],
                                                    rng=None)
            A_p, _ = JAffNetFast.apply_with_state(np1, fp[:, 16:48, 16:48],
                                                  rng=None)
            return jlosses.loss_hardnet(
                desc(jaug.warp_by_predicted_transform(fa, A_a, 32)),
                desc(jaug.warp_by_predicted_transform(fp, A_p, 32)))

        return state, {"loss": loss_fn(state.params)}

    with jax.default_device(jax.devices("cpu")[0]):
        params = JAffNetFast.init(jax.random.PRNGKey(0))
        state = jtrain.TrainState(params, jtrain.init_momentum(params),
                                  jnp.asarray(0, jnp.int32))
        sharded = jshard_train_step(step, jmake_mesh(
            8, devices=jax.devices("cpu")))
        _, m = sharded(state, tuple(jnp.asarray(v) for v in (a, p, la, lp)),
                       jax.random.PRNGKey(7), 3.0)
    np.testing.assert_allclose(two["jax_draws"]["losses"][0], float(m["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(one["jax_draws"]["losses"][0],
                               float(m["loss"]), rtol=1e-4)


def test_shard_apply_matches_one_device():
    net = AffNetFast()
    init_params(net, torch.Generator().manual_seed(0), gain=net.init_gain)
    patches = torch.from_numpy(np.random.RandomState(0).rand(
        33, 32, 32).astype(np.float32))
    apply = parallel.shard_apply(net, parallel.make_mesh(2, "cpu"))
    with torch.no_grad():
        ref = net(patches)
    np.testing.assert_allclose(apply(patches).numpy(), ref.numpy(),
                               atol=1e-5)


def test_sharded_image_pipeline_matches_per_image():
    """Five 64x96 images dealt over two CPU replicas (images 0, 2, 4 and
    1, 3): each output equals the image's own run, in input order."""
    rng = np.random.RandomState(0)
    imgs = (rng.rand(5, 64, 96) * 255).astype(np.float32)
    cfg = DetectorConfig(num_features=32, border=5, mr_size=5.192,
                         num_baum_iters=0, th=None)
    det = ScaleSpaceAffinePatchExtractor(cfg, device="cpu")
    fn = parallel.make_sharded_image_pipeline(
        det, 64, 96, parallel.make_mesh(2, "cpu"), do_ori=False,
        describe=False)
    outs = fn(imgs)
    assert len(outs) == 5
    for img, out in zip(imgs, outs):
        single = det(img, describe=False, capped=True)
        assert set(out) == set(single)
        for k in single:
            assert np.array_equal(out[k], single[k]), k
    with pytest.raises(ValueError, match="64x96"):
        fn([imgs[0][:32]])


def test_make_mesh_and_spawn_refuse_missing_cards():
    assert parallel.make_mesh(3, "cpu") == [torch.device("cpu")] * 3
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(ValueError, match="0 present"):
        parallel.make_mesh(2)
    with pytest.raises(ValueError, match="0 present"):
        parallel.spawn(parallel.run_steps, 2, "cuda", args=([],))


def _train(tmp_path, mesh, root):
    log_dir = tmp_path / f"logs{mesh}"
    state = train_affnet.main([
        "--dataroot", str(root), "--batch-size", str(N), "--n-pairs",
        str(2 * N), "--epochs", "1", "--descriptor", "pixels", "--loss",
        "HardNegC", "--no-eval", "--log-dir", str(log_dir), "--device",
        "cpu", "--mesh", str(mesh), "--log-interval", "1"])
    (run_dir,) = glob.glob(str(log_dir / "*"))
    ckpts = glob.glob(os.path.join(run_dir, "checkpoint_*.npz"))
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        losses = [json.loads(line)["loss"] for line in f]
    return state, load_checkpoint(ckpts[0]), len(ckpts), losses


def test_train_affnet_mesh_checkpoints(tmp_path, capsys):
    """``--mesh 2`` (two gloo CPU ranks) writes one checkpoint and one
    metrics log, equal to ``--mesh 1``'s within the stated tolerance;
    ``--mesh 1`` equals ``--mesh 0`` exactly."""
    root = tmp_path / "data"
    root.mkdir()
    patches, labels = _fixture_patches(32, 3, seed=1)
    np.savez(root / "a.npz", patches=patches, labels=labels)
    runs = {m: _train(tmp_path, m, root) for m in (0, 1, 2)}
    assert runs[2][0].step == runs[1][0].step == 2
    for m in (1, 2):
        (tree, epoch), n_ckpt, losses = runs[m][1:]
        (ref, ref_epoch), _, ref_losses = runs[0][1:]
        assert n_ckpt == 1 and epoch == ref_epoch == 1
        assert len(losses) == len(ref_losses) == 2
        np.testing.assert_allclose(losses, ref_losses, rtol=1e-5 * (m - 1))
        for layer in ref:
            for k in ref[layer]:
                np.testing.assert_allclose(tree[layer][k], ref[layer][k],
                                           rtol=0, atol=1e-4 * (m - 1),
                                           err_msg=f"--mesh {m} {layer}/{k}")


def test_hesaffnet_mesh_deals_images_over_replicas(tmp_path, capsys):
    """``--mesh 2 --device cpu`` on three same-size images: two CPU
    replicas (said on stderr), one file per image, each equal to the
    single-image bulk-mode run's (``--mesh 1``)."""
    img = np.load(os.path.join(FIX, "detector_golden_fullres.npz"))["img"]
    paths = []
    for i, (y, x) in enumerate([(0, 0), (100, 200), (300, 400)]):
        paths.append(str(tmp_path / f"im{i}.npy"))
        np.save(paths[-1], img[y:y + 64, x:x + 96].astype(np.float32))
    outs = {}
    for mesh in (1, 2):
        out = str(tmp_path / f"m{mesh}.ells")
        hesaffnet.main([",".join(paths), out, "--mesh", str(mesh), "--do-ori",
                        "--max-keypoints", "64", "--device", "cpu"])
        err = capsys.readouterr().err
        assert f"--mesh {mesh}: {mesh} CPU replica(s)" in err
        outs[mesh] = [open(str(tmp_path / f"m{mesh}_{i}.ells")).read()
                      for i in range(3)]
    assert outs[1] == outs[2] and all(len(o) > 0 for o in outs[2])
