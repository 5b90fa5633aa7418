"""The port's four training programs on the CPU (``--device cpu``) at a
few steps: train_descriptor, train_affnet (pairs against a HardNet
checkpoint written by the JAX package, and triplets), train_orinet and
gen_ds,
each against the JAX program's parser, data and printed lines where they
meet.  ``load_train_images`` is replaced by images cut from the committed
fixtures, so ``--synthetic`` needs no reference checkout; the per-epoch
eval runs once, on a graf directory built in ``tmp_path``, against JAX's
eval_graf on the same checkpoint (tentatives and true matches within 3,
or 1% of JAX's tentatives, as tests/test_torch_apps_cli.py holds
eval_graf).  No test reads outside the fixtures and ``tmp_path``, and none
reaches the network.
"""

import glob
import json
import os

import numpy as np
import jax
import pytest
import torch

from affnet_tpu import data as jdata
from affnet_tpu import train as jtrain
from affnet_tpu.cli import eval_graf as jeval
from affnet_tpu.cli import gen_ds as jgen_ds
from affnet_tpu.cli import train_affnet as jtrain_affnet
from affnet_tpu.cli import train_descriptor as jtrain_descriptor
from affnet_tpu.models import zoo as jzoo
from affnet_tpu_torch import data as tdata
from affnet_tpu_torch.cli import (eval_graf, gen_ds, train_affnet,
                                  train_descriptor, train_orinet)
from affnet_tpu_torch.models import (AffNetFast, HardNet, OriNetFast32,
                                     params_from_jax, params_to_jax)
from affnet_tpu_torch.models.cnn import init_params
from affnet_tpu_torch.train import load_checkpoint

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
# Image 1 -> 3 of the graf directory: a rotation of 4 degrees, scale 0.95,
# a shift and a little perspective (tests/test_torch_apps_cli.py's H12).
H13 = np.array([[0.9477, -0.0663, 14.0],
                [0.0663, 0.9477, -6.0],
                [2e-5, -1e-5, 1.0]])


def _fixture_images():
    img = np.load(os.path.join(FIX, "detector_golden_fullres.npz"))["img"]
    img = img.astype(np.float64)
    return [img[:320, :400], img[320:, 400:]]


@pytest.fixture
def train_images(monkeypatch):
    """load_train_images -> two 320x400 cuts of the fixture, in both
    packages."""
    for mod in (tdata, jdata):
        monkeypatch.setattr(mod, "load_train_images", _fixture_images)


def _run(main, argv, log_dir):
    state = main(argv + ["--log-dir", str(log_dir), "--device", "cpu"])
    (run_dir,) = glob.glob(os.path.join(log_dir, "*"))
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return state, run_dir, recs


def _moved_and_saved(state, run_dir, net_cls, epoch=0):
    """The checkpoint of ``epoch`` loads into a fresh ``net_cls`` and
    holds the trained net's parameters and statistics."""
    tree, saved_epoch = load_checkpoint(
        os.path.join(run_dir, f"checkpoint_{epoch}.npz"))
    assert saved_epoch == epoch + 1
    net = net_cls()
    net.load_state_dict(params_from_jax(tree))
    trained = state.model.state_dict()
    for name, got in net.state_dict().items():
        if got.is_floating_point():
            assert np.array_equal(got.numpy(), trained[name].numpy()), name
    return tree


def _png(path, arr):
    from PIL import Image
    Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8)).save(path)


def _warp(img, H):
    """img seen under H (bilinear, zero outside)."""
    h, w = img.shape
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    p = np.linalg.inv(H) @ np.stack([xs.ravel(), ys.ravel(),
                                     np.ones(h * w)])
    u, v = p[0] / p[2], p[1] / p[2]
    x0, y0 = np.floor(u).astype(int), np.floor(v).astype(int)
    fx, fy = u - x0, v - y0
    out = np.zeros(h * w)
    for dx, dy, wt in ((0, 0, (1 - fx) * (1 - fy)), (1, 0, fx * (1 - fy)),
                       (0, 1, (1 - fx) * fy), (1, 1, fx * fy)):
        xc, yc = x0 + dx, y0 + dy
        ok = (xc >= 0) & (xc < w) & (yc >= 0) & (yc < h)
        out[ok] += wt[ok] * img[yc[ok], xc[ok]]
    return out.reshape(h, w)


def test_parsers_keep_jax_flags():
    """Every flag of the JAX programs, with its default; the port adds
    --device."""
    for ours, theirs in ((train_affnet.build_parser(),
                          jtrain_affnet.build_parser()),
                         (train_descriptor.build_parser(),
                          jtrain_descriptor.build_parser())):
        mine = vars(ours.parse_args([]))
        ref = vars(theirs.parse_args([]))
        assert mine.pop("device") == "cuda"
        assert mine == ref
    assert "gen_classes" not in vars(train_descriptor.build_parser()
                                     .parse_args([]))


def test_train_descriptor_cli(tmp_path, train_images, monkeypatch, capsys):
    """HardNet from scratch at the published lr 0.1: the synthetic
    classes of the fixture images (JAX's data bit for bit), 2 steps."""
    seen = []
    real = tdata.synthetic_pairs_from_images

    def spy(imgs, **kw):
        kw["n_classes"] = 40     # the program passes JAX's 8192
        seen.append(real(imgs, **kw))
        assert seen[-1][0].shape[0] == 40 * 6
        ref = jdata.synthetic_pairs_from_images(imgs, **kw)
        for g, r in zip(seen[-1], ref):
            np.testing.assert_array_equal(g, r)
        return seen[-1]

    monkeypatch.setattr(tdata, "synthetic_pairs_from_images", spy)
    state, run_dir, recs = _run(
        train_descriptor.main, ["--synthetic", "--batch-size", "16",
                                "--n-pairs", "32", "--epochs", "1",
                                "--log-interval", "1", "--no-eval"],
        tmp_path)
    assert os.path.basename(run_dir) == "_HardNet_desc_0.1_32_HardNet"
    assert len(seen) == 1 and state.step == 2
    assert [r["lr"] for r in recs] == [float(np.float32(0.1)),
                                       float(np.float32(0.05))]
    assert np.isfinite([r["loss"] for r in recs]).all()
    assert isinstance(state.model, HardNet)
    _moved_and_saved(state, run_dir, HardNet)
    assert "epoch 0 step 1 loss" in capsys.readouterr().out


@pytest.mark.parametrize("loss,descriptor,extra", [
    ("HardNegC", "HardNet", ["--host-data"]),
    ("random_sampling", "SIFT", [])])
def test_train_affnet_cli(tmp_path, train_images, loss, descriptor, extra):
    """The published second stage against a HardNet checkpoint (pairs),
    and the triplet trainer (TripletDataset, the random-sampling loss)."""
    hardnet = str(tmp_path / "hardnet.npz")
    jtrain.save_checkpoint(hardnet, params_to_jax(init_params(
        HardNet(), torch.Generator().manual_seed(1)).state_dict()), 1)
    argv = ["--synthetic", "--gen-classes", "24", "--gen-views", "3",
            "--batch-size", "8", "--n-pairs", "16", "--epochs", "1",
            "--lr", "0.005", "--loss", loss, "--descriptor", descriptor,
            "--desc-weights", hardnet, "--no-eval"] + extra
    state, run_dir, recs = _run(train_affnet.main, argv, tmp_path / "logs")
    assert state.step == 2 and isinstance(state.model, AffNetFast)
    assert np.isfinite([r["loss"] for r in recs]).all()
    tree = _moved_and_saved(state, run_dir, AffNetFast)
    # The JAX package reads the checkpoint.
    jtree, epoch = jtrain.load_checkpoint(
        os.path.join(run_dir, "checkpoint_0.npz"))
    assert epoch == 1 and set(jtree) == set(tree)


def test_train_affnet_cli_takes_every_affnet(tmp_path, train_images,
                                             monkeypatch):
    """``--arch`` takes JAX's 11 AffNet names: AffNetFast52RotUp trains
    (a "Rot" name: each positive drawn with its own rotation, its seeded
    init with JAX's last bias), and its per-epoch eval passes it to
    eval_graf's --shape-arch with the epoch's checkpoint; train_descriptor
    --arch takes HardNetNarELU."""
    from affnet_tpu_torch import train as ttrain
    from affnet_tpu_torch.models import (REGISTRY, AffNet, AffNetFast52RotUp,
                                         HardNetNarELU)
    jaffnets = sorted(n for n in jzoo.REGISTRY if n.startswith("AffNet"))
    assert len(jaffnets) == 11
    assert sorted(n for n, c in REGISTRY.items()
                  if issubclass(c, AffNet)) == jaffnets
    draws = []
    real_draw = ttrain.draw_affnet_lafs

    def spy_draw(n, max_tilt, generator, shared_rot, negative=False):
        draws.append(shared_rot)
        return real_draw(n, max_tilt, generator, shared_rot, negative)

    monkeypatch.setattr(ttrain, "draw_affnet_lafs", spy_draw)
    evals = []
    monkeypatch.setattr(eval_graf, "main", lambda argv: evals.append(argv))
    argv = ["--synthetic", "--gen-classes", "24", "--gen-views", "3",
            "--batch-size", "8", "--n-pairs", "16", "--epochs", "1",
            "--arch", "AffNetFast52RotUp", "--no-vis"]
    state, run_dir, recs = _run(train_affnet.main, argv, tmp_path / "aff")
    assert isinstance(state.model, AffNetFast52RotUp) and state.step == 2
    assert draws == [False, False]
    assert np.isfinite([r["loss"] for r in recs]).all()
    _moved_and_saved(state, run_dir, AffNetFast52RotUp)
    ((eval_argv),) = evals
    assert eval_argv[eval_argv.index("--shape-arch") + 1] \
        == "AffNetFast52RotUp"
    assert eval_argv[eval_argv.index("--shape-weights") + 1] == os.path.join(
        run_dir, "checkpoint_0.npz")
    real_pairs = tdata.synthetic_pairs_from_images
    monkeypatch.setattr(     # the program passes JAX's 8192 classes
        tdata, "synthetic_pairs_from_images",
        lambda imgs, **kw: real_pairs(imgs, **{**kw, "n_classes": 40}))
    state, run_dir, recs = _run(
        train_descriptor.main, ["--synthetic", "--batch-size", "8",
                                "--n-pairs", "16", "--epochs", "1",
                                "--arch", "HardNetNarELU", "--no-eval"],
        tmp_path / "desc")
    assert isinstance(state.model, HardNetNarELU) and state.step == 2
    assert np.isfinite([r["loss"] for r in recs]).all()
    _moved_and_saved(state, run_dir, HardNetNarELU)


def test_train_orinet_cli_on_a_dataset_dir(tmp_path):
    """train_orinet at its defaults (OriNetFast32, HardNet loss) on
    --dataroot: an npz cache and a .pt one, read as JAX reads them."""
    root = tmp_path / "6Brown"
    root.mkdir()
    imgs = _fixture_images()
    for i, img in enumerate(imgs):
        patches, labels = tdata.synthetic_pairs_from_image(
            img, n_classes=16, views_per_class=3, seed=i)
        if i == 0:
            np.savez(root / "a.npz", patches=patches, labels=labels)
        else:
            torch.save((torch.from_numpy(patches[:, None]),
                        torch.from_numpy(labels)), root / "b.pt")
    state, run_dir, recs = _run(
        train_orinet.main, ["--dataroot", str(root), "--batch-size", "8",
                            "--n-pairs", "24", "--epochs", "1",
                            "--descriptor", "pixels", "--no-eval"],
        tmp_path / "logs")
    assert os.path.basename(run_dir) == "_OriNet_6Brown_pixels_0.005_24_HardNet"
    assert state.step == 3 and isinstance(state.model, OriNetFast32)
    assert len(recs) == 1 and np.isfinite(recs[0]["loss"])
    _moved_and_saved(state, run_dir, OriNetFast32)
    assert os.path.exists(root / "b.npz")


@pytest.mark.parametrize("main,argv,match", [
    (train_affnet.main, ["--mesh", "2", "--device", "cuda"],
     "--mesh 2: one card per rank"),
    (train_orinet.main, ["--mesh", "4", "--device", "cuda"], "--mesh 4"),
    (train_descriptor.main, ["--mesh", "2", "--device", "cuda"],
     "CUDA cards are present"),
    (train_affnet.main, ["--arch", "AffNetFast7"], "AffNetFast52RotUp"),
    (train_affnet.main, ["--arch", "OriNetFast32"], "AffNet trainer"),
    (train_orinet.main, ["--arch", "AffNetFast"], "OriNetFast32"),
    (train_affnet.main, ["--descriptor", "HardNet"], "--desc-weights")])
def test_refusals(tmp_path, main, argv, match):
    """--mesh N above the cards present (one card per rank) and nets the
    zoo lacks or that are not the trainer's kind never run; HardNet needs
    its weights, as in JAX.  ``argv`` comes last, so its ``--device``
    wins."""
    with pytest.raises(SystemExit, match=match):
        main(["--log-dir", str(tmp_path), "--device", "cpu"] + argv)
    assert not glob.glob(str(tmp_path / "*" / "checkpoint_*"))


def test_per_epoch_eval_matches_jax(tmp_path, train_images, monkeypatch,
                                    capsys):
    """train_affnet's per-epoch hook: the epoch's checkpoint, then
    eval_graf with JAX's argv (the trained net as --shape-arch's weights)
    on the same device; its counts against JAX's eval_graf on that
    checkpoint."""
    big = np.load(os.path.join(FIX, "detector_golden_fullres.npz"))["img"]
    crop = np.clip(big[150:390, 200:520], 0, 255).astype(np.uint8)
    graf = tmp_path / "graf"
    graf.mkdir()
    _png(str(graf / "img1.png"), crop)
    _png(str(graf / "img3.png"), _warp(crop.astype(np.float64), H13))
    np.savetxt(str(graf / "H1to3p"), H13)
    monkeypatch.setattr(eval_graf, "DEFAULT_GRAF", str(graf))
    calls = []
    real = eval_graf.main

    def spy(argv):
        calls.append((list(argv), real(argv)))
        return calls[-1][1]

    monkeypatch.setattr(eval_graf, "main", spy)
    _, run_dir, _ = _run(train_affnet.main, [
        "--synthetic", "--gen-classes", "16", "--gen-views", "2",
        "--batch-size", "8", "--n-pairs", "8", "--epochs", "1",
        "--descriptor", "pixels", "--no-vis"], tmp_path / "logs")
    ckpt = os.path.join(run_dir, "checkpoint_0.npz")
    ((argv, got),) = calls
    assert argv == ["--nfeats", "1000", "--img2-idx", "3", "--descriptor",
                    "SIFT", "--shape-arch", "AffNetFast", "--shape-weights",
                    ckpt, "--device", "cpu"]
    assert "[graf eval epoch 0]" in capsys.readouterr().out
    with jax.default_device(jax.devices("cpu")[0]):
        ref = jeval.main(["--graf-dir", str(graf)] + argv[:-2])
    assert got[0] > 50
    allowed = max(3, ref[0] // 100)
    assert abs(got[0] - ref[0]) <= allowed
    assert abs(got[1] - ref[1]) <= allowed


def test_gen_ds_prints_jax_lines(tmp_path, monkeypatch, capsys):
    """Without a network every subset prints JAX's FAILED line; an
    extracted directory is cached."""
    import urllib.request

    def refuse(*args, **kwargs):
        raise OSError("network unreachable")

    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)
    subsets = ["--subsets", "liberty", "yosemite"]
    jgen_ds.main(["--root", str(tmp_path / "jax")] + subsets)
    ref = capsys.readouterr().out.replace(str(tmp_path / "jax"), "ROOT")
    gen_ds.main(["--root", str(tmp_path / "port")] + subsets)
    got = capsys.readouterr().out.replace(str(tmp_path / "port"), "ROOT")
    assert got == ref and got.count("FAILED (network unreachable)") == 2
    assert "place the extracted dataset at ROOT/liberty and re-run" in got
    # An extracted directory (one sheet and info.txt) is cached as npz.
    from PIL import Image
    d = tmp_path / "port" / "liberty"
    d.mkdir()
    Image.fromarray(np.zeros((1024, 1024), np.uint8)).save(
        d / "patches0000.bmp")
    np.savetxt(d / "info.txt", np.array([[0, 0], [0, 0], [1, 0]]),
               fmt="%d")
    gen_ds.main(["--root", str(tmp_path / "port"), "--subsets", "liberty"])
    assert capsys.readouterr().out == (
        f"liberty: cached at {tmp_path / 'port' / 'liberty.npz'}\n")
    with np.load(tmp_path / "port" / "liberty.npz") as data:
        assert data["patches"].shape == (3, 64, 64)
        assert data["labels"].tolist() == [0, 0, 1]


def test_programs_default_to_the_card(tmp_path, train_images):
    """Without --device the programs ask for the card and, without one,
    raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    argv = ["--synthetic", "--gen-classes", "8", "--batch-size", "4",
            "--n-pairs", "8", "--no-eval", "--log-dir", str(tmp_path)]
    for main in (train_affnet.main, train_orinet.main):
        with pytest.raises(RuntimeError, match="device='cuda' requested"):
            main(argv)
    with pytest.raises(RuntimeError, match="device='cuda' requested"):
        train_affnet.main(argv + ["--host-data"])
