"""The port's hesaffbaum and extract_geom programs against the JAX
package's on the 120x160 fixture image, written to ``tmp_path`` as a PNG
(both programs) and as ``.npy`` (the port's, which needs no PIL for it).

Regions are matched by their centres (1e-2 px).  extract_geom: the same
regions in the same order up to 2 on one side only (NMS near-ties: on this
8-bit image one survivor's response, 71.9157 in JAX, lies 7e-4 under its
neighbour's on the next level there, and the two packages' responses
differ by up to 1e-4 relative where the det-Hessian cancels, ROADMAP Queue
C), shapes within rtol 1e-2, LAFs within the detector tests' atol 1e-2
px with at most 2 keypoints over it (measured with OriNetFast32: 2, the
largest 0.0137 px on a 17 px axis), descriptors atol 1e-3.  hesaffbaum: 16
Baumberg iterations are chaotic for a few keypoints (tests/
test_torch_handcrafted.py), so up to 3 regions may be on one side only and
15% of the matched shapes may differ by more than rtol 1e-2."""

import os

import numpy as np
import jax
import pytest

from affnet_tpu import io_formats as jio
from affnet_tpu.cli import extract_geom as jextract_geom
from affnet_tpu.cli import hesaffbaum as jhesaffbaum
from affnet_tpu_torch import io_formats
from affnet_tpu_torch.cli import extract_geom, hesaffbaum

FIX_IMG = os.path.join(os.path.dirname(__file__), "fixtures",
                       "detector_golden.npz")


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    from PIL import Image
    d = tmp_path_factory.mktemp("geom_cli")
    img = np.clip(np.load(FIX_IMG)["img"], 0, 255).astype(np.uint8)
    png, npy = str(d / "img.png"), str(d / "img.npy")
    Image.fromarray(img).save(png)
    np.save(npy, img)
    return png, npy


def _match(got, ref):
    """Indices (gi, ri) of the regions with the same centre."""
    d = np.abs(got[:, None, :2] - ref[None, :, :2]).max(-1)
    gi, ri = np.nonzero(d < 1e-2)
    assert len(set(gi)) == len(gi) and len(set(ri)) == len(ri)
    return gi, ri


def _shape_off(got, ref):
    return ~np.all(np.abs(got[:, 2:] - ref[:, 2:])
                   <= 1e-2 * np.abs(ref[:, 2:]) + 1e-6, axis=1)


def test_hesaffbaum_cli_matches_jax_cli(images, tmp_path, capsys):
    png, npy = images
    ours, theirs = str(tmp_path / "ours.ells"), str(tmp_path / "theirs.ells")
    hesaffbaum.main([npy, ours, "200", "--device", "cpu"])
    with jax.default_device(jax.devices("cpu")[0]):
        jhesaffbaum.main([png, theirs, "200"])
    printed = capsys.readouterr().out.splitlines()
    got, ref = io_formats.read_ells(ours), jio.read_ells(theirs)
    assert printed[0] == f"{len(got)} affine regions -> {ours}"
    assert len(got) >= 40 and np.isfinite(got).all()
    gi, ri = _match(got, ref)
    assert len(got) - len(gi) <= 3 and len(ref) - len(ri) <= 3
    assert _shape_off(got[gi], ref[ri]).sum() <= len(gi) * 15 // 100
    # The PNG gives the same file as the .npy.
    again = str(tmp_path / "png.ells")
    hesaffbaum.main([png, again, "200", "--device", "cpu"])
    assert open(again).read() == open(ours).read()


@pytest.mark.parametrize("mode", ["topk_sift", "th_ori"])
def test_extract_geom_cli_matches_jax_cli(images, tmp_path, capsys, mode):
    png, npy = images
    flags = (["200", "--descriptor", "SIFT"] if mode == "topk_sift"
             else ["--th", "28.41", "--do-ori"])
    files = {}
    for who, main, img in (("ours", extract_geom.main, npy),
                           ("theirs", jextract_geom.main, png)):
        f = {k: str(tmp_path / f"{who}_{k}") for k in
             ("ells", "lafs.npy", "descs.npy")}
        argv = [img, f["ells"], *flags, "--save-lafs", f["lafs.npy"],
                "--save-descs", f["descs.npy"]]
        if who == "ours":
            main(argv + ["--device", "cpu"])
        else:
            with jax.default_device(jax.devices("cpu")[0]):
                main(argv)
        files[who] = f
    printed = capsys.readouterr().out.splitlines()
    assert printed[0].startswith("det time = ")
    assert printed[1].startswith("LAFs2ell time = ")
    got = io_formats.read_ells(files["ours"]["ells"])
    ref = jio.read_ells(files["theirs"]["ells"])
    assert printed[2] == f"{len(got)} regions -> {files['ours']['ells']}"
    assert len(ref) >= 40
    gi, ri = _match(got, ref)
    assert len(got) - len(gi) <= 2 and len(ref) - len(ri) <= 2
    order = np.argsort(gi)
    assert np.all(np.diff(ri[order]) > 0)          # the same order
    assert not _shape_off(got[gi], ref[ri]).any()
    lafs = np.load(files["ours"]["lafs.npy"])
    assert lafs.shape == (len(got), 2, 3)
    err = np.abs(lafs[gi] - np.load(files["theirs"]["lafs.npy"])[ri])
    assert (err.reshape(len(gi), -1).max(axis=1) > 1e-2).sum() <= 2
    if mode == "topk_sift":
        descs = np.load(files["ours"]["descs.npy"])
        assert descs.shape == (len(got), 128)
        np.testing.assert_allclose(
            descs[gi], np.load(files["theirs"]["descs.npy"])[ri], atol=1e-3)
    else:
        assert not any(tmp_path.glob("*descs.npy"))
