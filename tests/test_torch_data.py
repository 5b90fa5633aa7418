"""The port's training data against ``affnet_tpu.data`` and
``affnet_tpu.augmentation`` on the same inputs, bit for bit: fliprot's
core, triplet generation and batches, the multi-image synthetic classes
(mesh warp and blur jitter on), the PhotoTour sheet reader and caches, the
reference's ``.pt`` caches and the concatenation of a dataset directory.
Every input comes from the committed fixtures or from ``tmp_path``.
"""

import os

import numpy as np
import jax
import pytest
import torch

from affnet_tpu import augmentation as jaug
from affnet_tpu import data as jdata
from affnet_tpu_torch import augmentation as aug
from affnet_tpu_torch import data as tdata

FIX = os.path.join(os.path.dirname(__file__), "fixtures")


def fixture_images():
    """Three 320x400 views cut from the committed 640x800 graf fixture, as
    ``load_train_images`` returns images (float64)."""
    img = np.load(os.path.join(FIX, "detector_golden_fullres.npz"))["img"]
    img = img.astype(np.float64)
    return [img[:320, :400], img[320:, 400:], img[160:480, 200:600]]


def _labelled_patches(seed, n_classes=30, size=64):
    rng = np.random.RandomState(seed)
    labels = np.repeat(np.arange(n_classes), rng.randint(1, 5, n_classes))
    labels[:2] = n_classes + 7                 # a two-member class
    patches = rng.randint(0, 256, (len(labels), size, size)).astype(np.uint8)
    return patches, labels


def test_fliprot_core_matches_jax():
    rng = np.random.RandomState(0)
    a = rng.rand(6, 16, 16).astype(np.float32)
    p = rng.rand(6, 16, 16).astype(np.float32)
    seen = set()
    for i in range(12):
        key = jax.random.PRNGKey(i)
        k1, k2 = jax.random.split(key)
        flags = (bool(jax.random.bernoulli(k1)),
                 bool(jax.random.bernoulli(k2)))
        seen.add(flags)
        ja, jp = jaug.fliprot(key, a, p)
        ta, tp = aug.fliprot_core(torch.from_numpy(a), torch.from_numpy(p),
                                  *flags)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert len(seen) == 4
    gen = torch.Generator().manual_seed(3)
    got = aug.fliprot(torch.from_numpy(a), torch.from_numpy(p), gen)
    flags = aug.draw_fliprot(torch.Generator().manual_seed(3))
    for g, r in zip(got, aug.fliprot_core(torch.from_numpy(a),
                                          torch.from_numpy(p), *flags)):
        assert torch.equal(g, r)


def test_generate_triplets_bit_identical():
    _, labels = _labelled_patches(1, n_classes=60)
    got = tdata.generate_triplets(labels, 300, 32, np.random.RandomState(4))
    ref = jdata.generate_triplets(labels, 300, 32, np.random.RandomState(4))
    np.testing.assert_array_equal(got, ref)
    assert np.all(labels[got[:, 0]] == labels[got[:, 1]])
    assert np.all(labels[got[:, 0]] != labels[got[:, 2]])


@pytest.mark.parametrize("fliprot", [True, False])
def test_triplet_dataset_bit_identical(fliprot):
    patches, labels = _labelled_patches(2)
    ours = tdata.TripletDataset(patches, labels, n_triplets=40,
                                batch_size=12, fliprot=fliprot, seed=5)
    theirs = jdata.TripletDataset(patches, labels, n_triplets=40,
                                  batch_size=12, fliprot=fliprot, seed=5)
    assert len(ours) == len(theirs) == 40
    n = 0
    for got, ref in zip(ours.batches(), theirs.batches()):
        assert len(got) == 3
        for g, r in zip(got, ref):
            assert g.dtype == np.float32
            np.testing.assert_array_equal(g, r)
        n += 1
    assert n == 3


def test_synthetic_pairs_from_images_bit_identical():
    imgs = fixture_images()
    kw = dict(n_classes=18, views_per_class=4, seed=3, mesh_warp=2.5,
              blur_jitter=1.5)
    got = tdata.synthetic_pairs_from_images(imgs, **kw)
    ref = jdata.synthetic_pairs_from_images(imgs, **kw)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
    assert got[0].shape == (72, 64, 64)
    np.testing.assert_array_equal(got[1], np.repeat(np.arange(18), 4))


def _write_sheets(root, n_patches, seed=0):
    """A Brown-format directory: 1024x1024 sheets of 16x16 64-px cells and
    info.txt; returns (patches, labels) as written."""
    from PIL import Image
    os.makedirs(root)
    rng = np.random.RandomState(seed)
    patches = rng.randint(0, 256, (n_patches, 64, 64)).astype(np.uint8)
    labels = np.arange(n_patches) // 2          # classes of two views
    for s in range(0, n_patches, 256):
        sheet = np.zeros((1024, 1024), np.uint8)
        for i, patch in enumerate(patches[s:s + 256]):
            r, c = divmod(i, 16)
            sheet[r * 64:(r + 1) * 64, c * 64:(c + 1) * 64] = patch
        Image.fromarray(sheet).save(
            os.path.join(root, f"patches{s // 256:04d}.bmp"))
    with open(os.path.join(root, "info.txt"), "w") as f:
        for lab in labels:
            f.write(f"{lab} 0\n")
    return patches, labels


def test_read_phototour_dir_and_cache_bit_identical(tmp_path):
    patches, labels = _write_sheets(str(tmp_path / "liberty"), 300)
    got = tdata.read_phototour_dir(str(tmp_path / "liberty"))
    ref = jdata.read_phototour_dir(str(tmp_path / "liberty"))
    for g, r, w in zip(got, ref, (patches, labels)):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(g, w)
    path = tdata.cache_phototour(str(tmp_path), "liberty", download=False)
    assert path == str(tmp_path / "liberty.npz")
    with np.load(path) as d:
        np.testing.assert_array_equal(d["patches"], patches)
        np.testing.assert_array_equal(d["labels"], labels)
    with pytest.raises(FileNotFoundError):
        tdata.cache_phototour(str(tmp_path), "yosemite", download=False)
    assert tdata.PHOTOTOUR_URLS == jdata.PHOTOTOUR_URLS
    assert tdata.PHOTOTOUR_LENS == jdata.PHOTOTOUR_LENS
    assert tdata.PHOTOTOUR_MEAN == jdata.PHOTOTOUR_MEAN
    assert tdata.PHOTOTOUR_STD == jdata.PHOTOTOUR_STD


def test_download_phototour_without_network(tmp_path, monkeypatch):
    """No test reaches the network: urlretrieve raises as it does on a
    machine without egress, and the error reaches the caller."""
    import urllib.request

    def refuse(*args, **kwargs):
        raise OSError("network unreachable")

    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)
    with pytest.raises(OSError, match="network unreachable"):
        tdata.cache_phototour(str(tmp_path), "notredame", download=True)
    assert not os.path.exists(tmp_path / "notredame.npz")


def _dataset_dir(root):
    os.makedirs(root)
    a_p, a_l = _labelled_patches(7, n_classes=20)
    b_p, b_l = _labelled_patches(8, n_classes=25)
    np.savez(os.path.join(root, "a_set.npz"), patches=a_p, labels=a_l)
    # The reference's cache: (patches, labels) tensors, patches with a
    # channel axis that the conversion squeezes.
    torch.save((torch.from_numpy(b_p[:, None]), torch.from_numpy(b_l)),
               os.path.join(root, "b_set.pt"))
    with open(os.path.join(root, "notes.txt"), "w") as f:
        f.write("not a cache\n")


def test_load_total_datasets_npz_and_pt_bit_identical(tmp_path):
    _dataset_dir(str(tmp_path / "port"))
    _dataset_dir(str(tmp_path / "jax"))
    got = tdata.load_total_datasets(str(tmp_path / "port"))
    ref = jdata.load_total_datasets(str(tmp_path / "jax"))
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
    # The converted cache is JAX's.
    for key in ("patches", "labels"):
        with np.load(tmp_path / "port" / "b_set.npz") as g, \
                np.load(tmp_path / "jax" / "b_set.npz") as r:
            np.testing.assert_array_equal(g[key], r[key])
    # A second call reads the .pt's npz in its place, not both.
    again = tdata.load_total_datasets(str(tmp_path / "port"))
    for g, r in zip(again, got):
        np.testing.assert_array_equal(g, r)
    # Fresh directories: a second JAX call would read b_set twice.
    _dataset_dir(str(tmp_path / "port_loader"))
    _dataset_dir(str(tmp_path / "jax_loader"))
    ours = tdata.TotalDatasetsLoader(str(tmp_path / "port_loader"),
                                     n_pairs=48, batch_size=16, seed=2)
    theirs = jdata.TotalDatasetsLoader(str(tmp_path / "jax_loader"),
                                       n_pairs=48, batch_size=16, seed=2)
    n = 0
    for (a, p), (ra, rp) in zip(ours.batches(), theirs.batches()):
        np.testing.assert_array_equal(a, ra)
        np.testing.assert_array_equal(p, rp)
        n += 1
    assert n == 3


def test_convert_pt_cache_matches_jax(tmp_path):
    _dataset_dir(str(tmp_path / "d"))
    pt = str(tmp_path / "d" / "b_set.pt")
    got = tdata.convert_pt_cache(pt, str(tmp_path / "port.npz"))
    ref = jdata.convert_pt_cache(pt, str(tmp_path / "jax.npz"))
    with np.load(got) as g, np.load(ref) as r:
        assert sorted(g.files) == sorted(r.files) == ["labels", "patches"]
        for key in g.files:
            assert g[key].dtype == r[key].dtype
            np.testing.assert_array_equal(g[key], r[key])


def test_load_train_images_reads_the_listed_paths(tmp_path):
    from PIL import Image
    assert tdata.TRAIN_IMAGE_PATHS == jdata.TRAIN_IMAGE_PATHS
    rel = tdata.TRAIN_IMAGE_PATHS[1]
    os.makedirs(os.path.dirname(tmp_path / rel))
    rgb = np.random.RandomState(0).randint(0, 256, (40, 50, 3))
    Image.fromarray(rgb.astype(np.uint8)).save(tmp_path / rel)
    got = tdata.load_train_images(str(tmp_path))
    ref = jdata.load_train_images(str(tmp_path))
    assert len(got) == len(ref) == 1
    assert got[0].dtype == ref[0].dtype
    np.testing.assert_array_equal(got[0], ref[0])
