"""The port's inference programs against the JAX package's on the same
files, on the CPU: detect_affine_shape, describe_keypoints, match_demo and
eval_graf (profile_pipeline: tests/test_torch_profile_cli.py).

Inputs come from the committed fixtures, written to ``tmp_path``: the
120x160 reference image (``detector_golden.npz``) and 240x320 crops of the
640x800 graf image (``detector_golden_fullres.npz``), one warped by a known
homography with numpy.  Tolerances and allowances (measured values, CPU, in
brackets):

- detect_affine_shape: the %10.5f files within 2e-5 (0: the same digits).
- describe_keypoints: the 7-column files within 1e-3 px (the LAFs differ
  by the nets' float32 summation order, tests/test_torch_keypoints.py),
  descriptors within 1e-4.
- match_demo and eval_graf: SIFT descriptors agree within 1e-5 where the
  keypoints agree, and they do on the two crops; on the warped view one
  keypoint per side differs (an eig-ratio gate flip and its re-top-k
  refill, ROADMAP Queue C's "eig-ratio gate" gap), and one keypoint can
  become another row's nearest neighbour and move the SNN column mask.
  So the tentative matches, the true matches and their pair sets may
  differ by 3, or 1% of JAX's tentatives if that is more (measured:
  match_demo 0; eval_graf 2 tentatives and 2 true matches, 260 and 257
  against 262 and 259).
"""

import os

import numpy as np
import pytest
import jax

from affnet_tpu.cli import describe_keypoints as jdescribe
from affnet_tpu.cli import detect_affine_shape as jdetect
from affnet_tpu.cli import eval_graf as jeval
from affnet_tpu.cli import match_demo as jmatch
from affnet_tpu_torch.cli import (describe_keypoints, detect_affine_shape,
                                  eval_graf, match_demo)

FIX = os.path.join(os.path.dirname(__file__), "fixtures")

# Image 1 -> 2: a rotation of 4 degrees, scale 0.95, a shift and a little
# perspective.
H12 = np.array([[0.9477, -0.0663, 14.0],
                [0.0663, 0.9477, -6.0],
                [2e-5, -1e-5, 1.0]])


def _png(path, arr):
    from PIL import Image
    Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8)).save(path)
    return path


def _warp(img, H):
    """img seen under H (bilinear, zero outside): out(x2) = img(H^-1 x2)."""
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


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("apps")
    small = np.load(os.path.join(FIX, "detector_golden.npz"))["img"]
    big = np.load(os.path.join(FIX, "detector_golden_fullres.npz"))["img"]
    crop1 = np.clip(big[150:390, 200:520], 0, 255).astype(np.uint8)
    crop2 = np.clip(big[170:410, 230:550], 0, 255).astype(np.uint8)
    graf = d / "graf"
    graf.mkdir()
    _png(str(graf / "img1.png"), crop1)
    _png(str(graf / "img6.png"), _warp(crop1.astype(np.float64), H12))
    np.savetxt(str(graf / "H1to6p"), H12)
    small_u8 = np.clip(small, 0, 255).astype(np.uint8)
    np.save(str(d / "small.npy"), small_u8)
    return dict(dir=d, small_png=_png(str(d / "small.png"), small_u8),
                small_npy=str(d / "small.npy"),
                crop1=str(graf / "img1.png"),
                crop2=_png(str(d / "crop2.png"), crop2), graf=str(graf))


def _cpu():
    return jax.default_device(jax.devices("cpu")[0])


def test_detect_affine_shape_cli_matches_jax(files, tmp_path, capsys):
    from PIL import Image
    img = np.asarray(Image.open(files["small_png"]))
    col = np.concatenate([img[y:y + 40, 60:100] for y in (0, 40, 80)], 0)
    inp = _png(str(tmp_path / "col.png"), col)
    ours, theirs = str(tmp_path / "ours.txt"), str(tmp_path / "theirs.txt")
    detect_affine_shape.main([inp, ours, "--device", "cpu"])
    with _cpu():
        jdetect.main([inp, theirs])
    assert capsys.readouterr().out.splitlines()[0] == (
        f"3 affine shapes -> {ours}")
    got, ref = np.loadtxt(ours), np.loadtxt(theirs)
    assert got.shape == (3, 4) and (got[:, 1] == 0).all()
    np.testing.assert_allclose(got[:, 0] * got[:, 3], 1.0, atol=1e-3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)


@pytest.mark.parametrize("source", ["png", "npy"])
def test_describe_keypoints_cli_matches_jax(files, tmp_path, capsys,
                                            source):
    rng = np.random.RandomState(7)
    n = 30
    kp = np.stack([rng.uniform(0, 160, n), rng.uniform(0, 120, n),
                   rng.uniform(2, 20, n), rng.uniform(-180, 180, n)], 1)
    kp_path = str(tmp_path / "kpts.txt")
    np.savetxt(kp_path, kp)
    img = files["small_png"] if source == "png" else files["small_npy"]
    ours = [str(tmp_path / f"ours.{e}") for e in ("txt", "npy")]
    theirs = [str(tmp_path / f"theirs.{e}") for e in ("txt", "npy")]
    describe_keypoints.main([img, kp_path, ours[0], "--descs", ours[1],
                             "--device", "cpu"])
    with _cpu():
        jdescribe.main([files["small_png"], kp_path, theirs[0], "--descs",
                        theirs[1]])
    assert capsys.readouterr().out.splitlines()[0] == (
        f"{n} keypoints -> {ours[0]} + {ours[1]}")
    got, ref = np.loadtxt(ours[0]), np.loadtxt(theirs[0])
    assert got.shape == (n, 7) and (got[:, 6] == 0).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)
    with open(ours[0]) as f:       # the %10.5f format
        assert all(len(tok.split(".")[1]) == 5 for tok in f.read().split())
    d, dj = np.load(ours[1]), np.load(theirs[1])
    np.testing.assert_allclose(np.linalg.norm(d, axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(d, dj, rtol=0, atol=1e-4)


def _pairs(pts1, pts2):
    return {tuple(np.round(np.concatenate([a, b]), 2))
            for a, b in zip(pts1, pts2)}


def _spy(monkeypatch, module, name):
    """Record what ``module.name`` returns when the program calls it."""
    real, seen = getattr(module, name), []

    def spy(*args, **kwargs):
        seen.append(real(*args, **kwargs))
        return seen[-1]

    monkeypatch.setattr(module, name, spy)
    return seen


def test_match_demo_matches_jax(files, tmp_path, monkeypatch, capsys):
    drawn = {}

    def capture(img1, img2, pts1, pts2, out_path):
        drawn["pairs"] = _pairs(np.asarray(pts1), np.asarray(pts2))

    monkeypatch.setattr(jmatch, "draw_matches", capture)
    with _cpu():
        jmatch.main([files["crop1"], files["crop2"],
                     str(tmp_path / "theirs.png"), "--nfeats", "300"])
    seen = _spy(monkeypatch, match_demo, "match_images")
    ours = str(tmp_path / "ours.png")
    match_demo.main([files["crop1"], files["crop2"], ours, "--nfeats",
                     "300", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    n_theirs, n_ours = int(out[0].split()[0]), int(out[2].split()[0])
    assert out[3] == f"match visualization -> {ours}"
    assert os.path.getsize(ours) > 1000
    t1, t2, pts1, pts2 = seen[0]
    assert len(t1) == len(t2) == len(pts1) == n_ours > 50
    mine = _pairs(pts1, pts2)
    allowed = max(3, n_theirs // 100)
    assert abs(n_ours - n_theirs) <= allowed
    assert len(mine - drawn["pairs"]) <= allowed
    assert len(drawn["pairs"] - mine) <= allowed


def test_eval_graf_matches_jax(files, monkeypatch, capsys):
    args = ["--graf-dir", files["graf"], "--nfeats", "300"]
    with _cpu():
        ref = jeval.main(args)
    seen = _spy(monkeypatch, eval_graf, "evaluate_pair")
    got = eval_graf.main(args + ["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[1] == (f"Test on graf1-6, {got[0]} tentatives {got[1]} "
                        f"true matches {got[2]:.4f} inl.ratio")
    assert got[0] > 50 and got[1] > 0.5 * got[0]
    allowed = max(3, ref[0] // 100)
    assert abs(got[0] - ref[0]) <= allowed
    assert abs(got[1] - ref[1]) <= allowed
    assert abs(got[2] - ref[2]) <= allowed / ref[0] + 1e-4
    # evaluate_pair's indices agree with its counts; --shape-arch refuses
    # nets the port's zoo lacks.
    n_tent, n_true, ratio, t1, t2, in1 = seen[0]
    assert (n_tent, n_true, ratio) == got
    assert len(t1) == len(t2) == n_tent and len(in1) == n_true
    with pytest.raises(SystemExit, match="AffNetFast"):
        eval_graf.main(args + ["--shape-arch", "AffNetFast4", "--device",
                               "cpu"])
