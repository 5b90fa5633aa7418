"""Patch datasets of the trainers.

Counterparts of ``affnet_tpu/data.py``: the PhotoTour (Brown) readers and
caches, pair and triplet generation, the pair and triplet datasets, the
concatenation of every cache in a directory, the HPatches patch-sheet
reader and pair dataset (``read_patch_file``, ``HPatchesDM``), and the
offline synthetic patch classes.  All but :class:`DevicePairDataset` are numpy and draw from
the same ``np.random.RandomState`` stream in the same order as the JAX
package, so a seed gives the same pairs, triplets, patches and flips bit
for bit.  :class:`DevicePairDataset` keeps the uint8 patch store on the
device and builds each batch there.  PIL is imported inside the readers
that need it.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from . import resolve_device


# Brown PhotoTour download table (dataset.py:297-331).
PHOTOTOUR_URLS = {
    "notredame_harris": [
        "http://matthewalunbrown.com/patchdata/notredame_harris.zip",
        "notredame_harris.zip", "69f8c90f78e171349abdf0307afefe4d"],
    "yosemite_harris": [
        "http://matthewalunbrown.com/patchdata/yosemite_harris.zip",
        "yosemite_harris.zip", "a73253d1c6fbd3ba2613c45065c00d46"],
    "liberty_harris": [
        "http://matthewalunbrown.com/patchdata/liberty_harris.zip",
        "liberty_harris.zip", "c731fcfb3abb4091110d0ae8c7ba182c"],
    "notredame": ["http://icvl.ee.ic.ac.uk/vbalnt/notredame.zip",
                  "notredame.zip", "509eda8535847b8c0a90bbb210c83484"],
    "yosemite": ["http://icvl.ee.ic.ac.uk/vbalnt/yosemite.zip",
                 "yosemite.zip", "533b2e8eb7ede31be40abc317b2fd4f0"],
    "liberty": ["http://icvl.ee.ic.ac.uk/vbalnt/liberty.zip",
                "liberty.zip", "fdd9152f138ea5ef2091746689176414"],
}

PHOTOTOUR_MEAN = {"notredame": 0.4854, "yosemite": 0.4844, "liberty": 0.4437,
                  "notredame_harris": 0.4854, "yosemite_harris": 0.4844,
                  "liberty_harris": 0.4437}
PHOTOTOUR_STD = {"notredame": 0.1864, "yosemite": 0.1818, "liberty": 0.2019,
                 "notredame_harris": 0.1864, "yosemite_harris": 0.1818,
                 "liberty_harris": 0.2019}
PHOTOTOUR_LENS = {"notredame": 468159, "yosemite": 633587, "liberty": 450092,
                  "liberty_harris": 379587, "yosemite_harris": 450912,
                  "notredame_harris": 325295}


# ---------------------------------------------------------------------------
# PhotoTour raw ingestion (replaces torchvision.datasets.PhotoTour)
# ---------------------------------------------------------------------------

def read_phototour_dir(data_dir: str, patch_size: int = 64
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Read an extracted Brown dataset directory: ``patchesNNNN.bmp`` sheets
    of 16x16 cells of 64 px, row by row, and ``info.txt`` (the 3D point id
    of each patch).  Returns (patches uint8 (N, 64, 64), labels int64)."""
    from PIL import Image
    info = os.path.join(data_dir, "info.txt")
    labels = np.loadtxt(info, dtype=np.int64, usecols=(0,))
    n = len(labels)
    fnames = sorted(f for f in os.listdir(data_dir)
                    if f.startswith("patches") and f.endswith(".bmp"))
    per_sheet = (1024 // patch_size) ** 2
    patches = np.zeros((n, patch_size, patch_size), np.uint8)
    idx = 0
    for f in fnames:
        sheet = np.asarray(Image.open(os.path.join(data_dir, f)).convert("L"))
        rows = sheet.shape[0] // patch_size
        cols = sheet.shape[1] // patch_size
        for r in range(rows):
            for c in range(cols):
                if idx >= n:
                    break
                patches[idx] = sheet[r * patch_size:(r + 1) * patch_size,
                                     c * patch_size:(c + 1) * patch_size]
                idx += 1
    return patches[:idx], labels[:idx]


def download_phototour(root: str, name: str) -> str:
    """Download and extract a Brown dataset into ``root/name`` (the
    reference's gen_ds.py); returns the directory.  Raises without a
    network."""
    import urllib.request
    import zipfile
    url, zname, md5 = PHOTOTOUR_URLS[name]
    os.makedirs(root, exist_ok=True)
    zpath = os.path.join(root, zname)
    out_dir = os.path.join(root, name)
    if os.path.isdir(out_dir):
        return out_dir
    if not os.path.exists(zpath):
        print(f"Downloading {url}")
        urllib.request.urlretrieve(url, zpath)
        digest = hashlib.md5(open(zpath, "rb").read()).hexdigest()
        if digest != md5:
            raise RuntimeError(f"md5 mismatch for {zname}")
    with zipfile.ZipFile(zpath) as z:
        z.extractall(out_dir)
    return out_dir


def cache_phototour(root: str, name: str, download: bool = True) -> str:
    """Make sure ``root/name.npz`` (patches, labels) exists, reading
    ``root/name`` or downloading it first; returns the npz's path."""
    npz = os.path.join(root, f"{name}.npz")
    if os.path.exists(npz):
        return npz
    data_dir = os.path.join(root, name)
    if not os.path.isdir(data_dir):
        if not download:
            raise FileNotFoundError(data_dir)
        data_dir = download_phototour(root, name)
    patches, labels = read_phototour_dir(data_dir)
    np.savez(npz, patches=patches, labels=labels)
    return npz


# ---------------------------------------------------------------------------
# The reference's torch .pt caches
# ---------------------------------------------------------------------------

def convert_pt_cache(pt_path: str, npz_path: Optional[str] = None) -> str:
    """Convert a reference-format ``<name>.pt`` cache, a pickled
    (patches, labels) pair of tensors, into the npz the JAX package writes
    (``patches`` squeezed, ``labels``); read here in process.  Load only
    caches you made or trust: unpickling can run code."""
    npz_path = npz_path or pt_path.replace(".pt", ".npz")
    if not os.path.exists(npz_path):
        data = torch.load(pt_path, map_location="cpu", weights_only=False)
        np.savez(npz_path, patches=data[0].numpy().squeeze(),
                 labels=data[1].numpy())
    return npz_path


# ---------------------------------------------------------------------------
# Pair and triplet generation
# ---------------------------------------------------------------------------

def generate_pairs(labels: np.ndarray, num_pairs: int, batch_size: int,
                   rng: np.random.RandomState) -> np.ndarray:
    """Same-class pairs with classes unique within each batch; a class of
    two members always gives (0, 1).  Returns (num_pairs, 2) indices."""
    indices: Dict[int, List[int]] = {}
    for idx, lab in enumerate(labels):
        indices.setdefault(int(lab), []).append(idx)
    # Only classes with >= 2 members can produce pairs.
    unique_labels = np.array([l for l, v in indices.items() if len(v) >= 2])
    n_classes = len(unique_labels)
    pairs = np.zeros((num_pairs, 2), np.int64)
    already = set()
    for x in range(num_pairs):
        if len(already) >= batch_size:
            already = set()
        c1 = unique_labels[rng.randint(0, n_classes)]
        while c1 in already:
            c1 = unique_labels[rng.randint(0, n_classes)]
        already.add(c1)
        members = indices[int(c1)]
        if len(members) == 2:
            n1, n2 = 0, 1
        else:
            n1 = rng.randint(0, len(members))
            n2 = rng.randint(0, len(members))
            while n1 == n2:
                n2 = rng.randint(0, len(members))
        pairs[x] = (members[n1], members[n2])
    return pairs


def generate_triplets(labels: np.ndarray, num_triplets: int, batch_size: int,
                      rng: np.random.RandomState) -> np.ndarray:
    """Anchor and positive from one class, the negative from another, with
    anchor classes unique within each batch and the two-member shortcut of
    :func:`generate_pairs`.  Returns (num_triplets, 3) indices."""
    indices: Dict[int, List[int]] = {}
    for idx, lab in enumerate(labels):
        indices.setdefault(int(lab), []).append(idx)
    unique_labels = np.array([l for l, v in indices.items() if len(v) >= 2])
    all_labels = np.array(sorted(indices.keys()))
    n_classes = len(unique_labels)
    triplets = np.zeros((num_triplets, 3), np.int64)
    already = set()
    for x in range(num_triplets):
        if len(already) >= batch_size:
            already = set()
        c1 = unique_labels[rng.randint(0, n_classes)]
        while c1 in already:
            c1 = unique_labels[rng.randint(0, n_classes)]
        already.add(c1)
        c2 = all_labels[rng.randint(0, len(all_labels))]
        while c1 == c2:
            c2 = all_labels[rng.randint(0, len(all_labels))]
        members = indices[int(c1)]
        if len(members) == 2:
            n1, n2 = 0, 1
        else:
            n1 = rng.randint(0, len(members))
            n2 = rng.randint(0, len(members))
            while n1 == n2:
                n2 = rng.randint(0, len(members))
        negs = indices[int(c2)]
        n3 = rng.randint(0, len(negs))
        triplets[x] = (members[n1], members[n2], negs[n3])
    return triplets


class PairDataset:
    """Patch pairs over (patches uint8 (N, H, W), labels) with the reference's
    pair generation and pair-shared fliprot.  Iterate with ``batches()``:
    (anchor, positive) float32 numpy batches in [0, 1]."""

    def __init__(self, patches: np.ndarray, labels: np.ndarray,
                 n_pairs: int = 500000, batch_size: int = 128,
                 fliprot: bool = True, seed: int = 0):
        self.patches = patches
        self.labels = labels
        self.batch_size = batch_size
        self.fliprot = fliprot
        self.rng = np.random.RandomState(seed)
        self.pairs = generate_pairs(labels, n_pairs, batch_size, self.rng)

    def __len__(self):
        return len(self.pairs)

    def batches(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        n = len(self.pairs)
        for st in range(0, n - self.batch_size + 1, self.batch_size):
            sel = self.pairs[st:st + self.batch_size]
            a = self.patches[sel[:, 0]].astype(np.float32) / 255.0
            p = self.patches[sel[:, 1]].astype(np.float32) / 255.0
            if self.fliprot:
                # Per-sample transpose / horizontal flip shared within the
                # pair.
                do_rot = self.rng.rand(len(a)) > 0.5
                do_flip = self.rng.rand(len(a)) > 0.5
                a[do_rot] = np.swapaxes(a[do_rot], 1, 2)
                p[do_rot] = np.swapaxes(p[do_rot], 1, 2)
                a[do_flip] = a[do_flip, :, ::-1]
                p[do_flip] = p[do_flip, :, ::-1]
            yield a, p


class DevicePairDataset:
    """:class:`PairDataset` with the uint8 patch store uploaded to the
    device once; each batch is built there from the pair indices and flip
    draws (the same draws from the same stream, so the batches equal the
    host ones: bit for bit on the CPU, and up to the rounding of /255 on a
    card, whose division by a scalar multiplies by the reciprocal)."""

    def __init__(self, inner: PairDataset, device="cuda"):
        self.inner = inner
        self.batch_size = inner.batch_size
        self.device = resolve_device(device)
        self._store = torch.from_numpy(inner.patches).to(self.device)

    def __len__(self):
        return len(self.inner)

    def batches(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        inner = self.inner
        bs = inner.batch_size
        n = len(inner.pairs)
        for st in range(0, n - bs + 1, bs):
            sel = torch.from_numpy(inner.pairs[st:st + bs]).to(self.device)
            a = self._store[sel[:, 0]].to(torch.float32) / 255.0
            p = self._store[sel[:, 1]].to(torch.float32) / 255.0
            if inner.fliprot:
                do_rot = torch.from_numpy(inner.rng.rand(bs) > 0.5)
                do_flip = torch.from_numpy(inner.rng.rand(bs) > 0.5)
                rot = do_rot.to(self.device)[:, None, None]
                flip = do_flip.to(self.device)[:, None, None]

                def fliprot(x):
                    x = torch.where(rot, x.transpose(1, 2), x)
                    return torch.where(flip, x.flip(2), x)

                a, p = fliprot(a), fliprot(p)
            yield a, p


class TripletDataset:
    """(anchor, positive, negative) float32 numpy batches in [0, 1] for the
    random-sampling loss, with per-sample transposes and flips shared
    across each triplet."""

    def __init__(self, patches: np.ndarray, labels: np.ndarray,
                 n_triplets: int = 500000, batch_size: int = 128,
                 fliprot: bool = True, seed: int = 0):
        self.patches = patches
        self.batch_size = batch_size
        self.fliprot = fliprot
        self.rng = np.random.RandomState(seed)
        self.triplets = generate_triplets(labels, n_triplets, batch_size,
                                          self.rng)

    def __len__(self):
        return len(self.triplets)

    def batches(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        n = len(self.triplets)
        for st in range(0, n - self.batch_size + 1, self.batch_size):
            sel = self.triplets[st:st + self.batch_size]
            out = [self.patches[sel[:, i]].astype(np.float32) / 255.0
                   for i in range(3)]
            if self.fliprot:
                do_rot = self.rng.rand(len(out[0])) > 0.5
                do_flip = self.rng.rand(len(out[0])) > 0.5
                for i in range(3):
                    out[i][do_rot] = np.swapaxes(out[i][do_rot], 1, 2)
                    out[i][do_flip] = out[i][do_flip, :, ::-1]
            yield tuple(out)


def load_total_datasets(datasets_path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Concatenate every cache in a directory, in name order, each one's
    labels shifted past the ones before: the npz caches and the
    reference's ``.pt`` ones (through :func:`convert_pt_cache`).  A
    ``.pt`` whose npz is already in the directory is read once, as the
    npz (the JAX package would read it twice on a second call)."""
    all_patches, all_labels = [], []
    label_base = 0
    names = sorted(os.listdir(datasets_path))
    for fname in names:
        path = os.path.join(datasets_path, fname)
        if fname.endswith(".pt"):
            if fname[:-3] + ".npz" in names:
                continue
            path = convert_pt_cache(path)
        elif not fname.endswith(".npz"):
            continue
        with np.load(path) as data:
            all_patches.append(data["patches"])
            labels = data["labels"].astype(np.int64)
        all_labels.append(labels + label_base)
        label_base = int(all_labels[-1].max()) + 1
    return np.concatenate(all_patches), np.concatenate(all_labels)


class TotalDatasetsLoader(PairDataset):
    """:class:`PairDataset` over every cache in a directory
    (:func:`load_total_datasets`)."""

    def __init__(self, datasets_path: str, n_pairs: int = 500000,
                 batch_size: int = 128, fliprot: bool = True, seed: int = 0):
        patches, labels = load_total_datasets(datasets_path)
        super().__init__(patches, labels, n_pairs, batch_size, fliprot, seed)


# ---------------------------------------------------------------------------
# HPatches patch sheets (the reference's dataset.py:28-192)
# ---------------------------------------------------------------------------

def read_patch_file(fname: str, patch_w: int = 65, patch_h: int = 65,
                    start_idx: int = 0):
    """Read one HPatches sheet (a grid of ``patch_h`` x ``patch_w`` cells,
    grey as the mean of RGB) and skip blank or flat cells; a row of the
    grid that keeps fewer than two cells is dropped.  Returns (patches
    uint8 (N, patch_h, patch_w), the indices of each kept row's patches
    from ``start_idx``, the last index)."""
    from PIL import Image
    img = Image.open(fname).convert("RGB")
    width, height = img.size
    if height % patch_h or width % patch_w:
        raise ValueError(f"{fname}: {width}x{height} is not a grid of "
                         f"{patch_w}x{patch_h} cells")
    arr = np.asarray(img, np.float32).mean(axis=2)
    patch_idxs: List[List[int]] = []
    patches: List[np.ndarray] = []
    cur = start_idx
    for y in range(0, height, patch_h):
        patch_idxs.append([])
        row_patches = []
        for x in range(0, width, patch_w):
            p = arr[y:y + patch_h, x:x + patch_w]
            if p.mean() != 0 and p.std() > 1e-2:
                row_patches.append(p.astype(np.uint8))
                patch_idxs[-1].append(cur)
                cur += 1
        if len(row_patches) > 1:
            patches.extend(row_patches)
        else:
            cur -= len(row_patches)
            patch_idxs = patch_idxs[:-1]
    return (np.array(patches) if patches else
            np.zeros((0, patch_h, patch_w), np.uint8)), patch_idxs, cur - 1


class HPatchesDM:
    """HPatches pair dataset over the sheets of ``root/name`` named in
    ``root/splits.json`` (split ``split_name``, train or test), each kept
    row of a sheet one class, cached as ``root/{name}_{train|test}.npz``;
    pairs as :class:`PairDataset` makes them, without flips.  A sheet that
    cannot be read is skipped, as the reference does."""

    def __init__(self, root: str, name: str, train: bool = True,
                 n_pairs: int = 1000, batch_size: int = 128,
                 split_name: str = "b", seed: int = 0):
        self.root = os.path.expanduser(root)
        self.data_dir = os.path.join(self.root, name)
        cache = os.path.join(self.root,
                             f"{name}_{'train' if train else 'test'}.npz")
        if not os.path.exists(cache):
            with open(os.path.join(self.root, "splits.json")) as f:
                splits = json.load(f)
            good = splits[split_name]["train" if train else "test"]
            patches, idxs = [], []
            cur = 0
            for f in sorted(os.listdir(self.data_dir)):
                if not f.endswith(".png") or f[:-len(".png")] not in good:
                    continue
                try:
                    p, rows, max_idx = read_patch_file(
                        os.path.join(self.data_dir, f), 65, 65, cur)
                except (OSError, ValueError):
                    continue
                cur = max_idx + 1
                patches.append(p)
                idxs.extend(rows)
            flat = np.concatenate(patches)
            row_of = np.zeros(len(flat), np.int64)
            for row_id, members in enumerate(idxs):
                row_of[members] = row_id
            np.savez(cache, patches=flat, labels=row_of)
        with np.load(cache) as data:
            self.pairset = PairDataset(data["patches"], data["labels"],
                                       n_pairs, batch_size, fliprot=False,
                                       seed=seed)

    def batches(self):
        return self.pairset.batches()


# ---------------------------------------------------------------------------
# Offline synthetic patch classes
# ---------------------------------------------------------------------------

def synthetic_pairs_from_image(img: np.ndarray, n_classes: int = 512,
                               patch_size: int = 64, seed: int = 0,
                               max_warp: float = 0.25,
                               views_per_class: int = 2):
    """A labeled patch set cut from one image: per class a random location,
    one straight crop and ``views_per_class - 1`` crops warped by random
    small affine maps (bilinear inverse mapping).  The offline stand-in for
    PhotoTour.  Returns (patches uint8 (N, PS, PS), labels int64)."""
    rng = np.random.RandomState(seed)
    h, w = img.shape
    half = patch_size  # sample a 2x context then center-crop after warp
    patches, labels = [], []
    for c in range(n_classes):
        cy = rng.randint(half, h - half)
        cx = rng.randint(half, w - half)
        big = img[cy - half:cy + half, cx - half:cx + half]
        for v in range(views_per_class):
            if v == 0:
                crop = big[half // 2:half // 2 + patch_size,
                           half // 2:half // 2 + patch_size]
            else:
                A = np.eye(2) + (rng.rand(2, 2) - 0.5) * 2 * max_warp
                yy, xx = np.mgrid[0:patch_size, 0:patch_size]
                pts = np.stack([xx - patch_size / 2, yy - patch_size / 2])
                src = np.tensordot(np.linalg.inv(A), pts, axes=1)
                sx = src[0] + half
                sy = src[1] + half
                x0 = np.clip(np.floor(sx).astype(int), 0, 2 * half - 2)
                y0 = np.clip(np.floor(sy).astype(int), 0, 2 * half - 2)
                fx = np.clip(sx - x0, 0, 1)
                fy = np.clip(sy - y0, 0, 1)
                crop = (big[y0, x0] * (1 - fx) * (1 - fy)
                        + big[y0, x0 + 1] * fx * (1 - fy)
                        + big[y0 + 1, x0] * (1 - fx) * fy
                        + big[y0 + 1, x0 + 1] * fx * fy)
            patches.append(np.clip(crop, 0, 255).astype(np.uint8))
            labels.append(c)
    return np.array(patches), np.array(labels, np.int64)


def _bilinear_crop(big: np.ndarray, sx: np.ndarray, sy: np.ndarray):
    """Clamped bilinear sampling of ``big`` at float coords (sx, sy)."""
    hh, ww = big.shape
    x0 = np.clip(np.floor(sx).astype(int), 0, ww - 2)
    y0 = np.clip(np.floor(sy).astype(int), 0, hh - 2)
    fx = np.clip(sx - x0, 0, 1)
    fy = np.clip(sy - y0, 0, 1)
    return (big[y0, x0] * (1 - fx) * (1 - fy)
            + big[y0, x0 + 1] * fx * (1 - fy)
            + big[y0 + 1, x0] * (1 - fx) * fy
            + big[y0 + 1, x0 + 1] * fx * fy)


def synthetic_pairs_from_images(imgs, n_classes: int = 8192,
                                patch_size: int = 64, seed: int = 0,
                                views_per_class: int = 4,
                                max_tilt: float = 3.0,
                                rot_jitter: float = 0.35,
                                perspective: float = 0.004,
                                occlude_prob: float = 0.25,
                                anchor_scale_range=(0.6, 1.8),
                                mesh_warp: float = 0.0,
                                blur_jitter: float = 0.0):
    """Multi-image synthetic patch classes approximating PhotoTour's
    viewpoint diversity (reference dataset.py:292-419): corner-ish anchor
    locations (gradient-energy-weighted sampling), per-view random
    *anisotropic* warps A = R(phi) diag(t, 1/t) R(psi) * s (viewpoint tilt
    up to ``max_tilt``, scale 0.8-1.25, small rotation jitter), and
    photometric contrast/brightness jitter.  Patch centers correspond across
    views by construction (the warp fixes the crop center), so descriptor
    losses see true correspondences.

    Per view, beyond the tilt:

      - ``perspective``: views warp through a full homography
        src = (A @ p + t) / (q . p + 1) with |q| <= perspective per pixel —
        the foreshortening gradient real tilted planes have and affine
        warps lack.
      - ``occlude_prob``: per non-anchor view, paste an elliptical patch
        from a DIFFERENT image (its own small affine motion + photometric
        state) — a depth-layered composite; the anchor stays clean, so the
        loss sees occlusion as nuisance, not signal.
      - ``anchor_scale_range``: per-class context scale s0 (the 2x context
        is cropped at s0 and resized back), so classes live across the
        scale range the detector feeds AffNet, not at one blur level.
      - ``mesh_warp``: per-view smooth NON-PLANAR displacement field (sum of
        three random low-frequency sinusoids, amplitude up to ``mesh_warp``
        px, zeroed at the patch center so class correspondence is exact
        there) added to the inverse map — curved-surface parallax that a
        homography cannot express, so shape equivariance must hold under
        locally-varying affines like on real (non-planar) PhotoTour scenes.
      - ``blur_jitter``: per-view Gaussian blur with sigma ~ U(0, blur_
        jitter) — cross-view defocus/scale mismatch (PhotoTour patches come
        from different cameras/distances; our pyramid crops are one blur).
    """
    rng = np.random.RandomState(seed)
    half = patch_size
    # Gradient-energy sampling maps per image (corner-ish anchors).
    probs = []
    for img in imgs:
        gy, gx = np.gradient(img.astype(np.float32))
        e = (gx * gx + gy * gy)
        e[:half, :] = 0
        e[-half:, :] = 0
        e[:, :half] = 0
        e[:, -half:] = 0
        p = e.ravel()
        s = p.sum()
        probs.append(p / s if s > 0 else None)
    patches, labels = [], []
    yy, xx = np.mgrid[0:patch_size, 0:patch_size]
    pts = np.stack([xx - patch_size / 2, yy - patch_size / 2])
    oy, ox = np.mgrid[0:patch_size, 0:patch_size]

    def rot(a):
        return np.array([[np.cos(a), -np.sin(a)],
                         [np.sin(a), np.cos(a)]])

    for c in range(n_classes):
        i = c % len(imgs)
        img = imgs[i].astype(np.float32)
        h, w = img.shape
        # Class-level context scale: crop a (2*half*s0) region, resample to
        # the canonical 2*half context.
        s0 = np.exp(rng.uniform(np.log(anchor_scale_range[0]),
                                np.log(anchor_scale_range[1])))
        ch = max(8, int(round(half * s0)))
        if 2 * ch >= min(h, w):
            ch = half
            s0 = 1.0
        if probs[i] is not None:
            flat = rng.choice(len(probs[i]), p=probs[i])
            cy, cx = flat // w, flat % w
            cy = int(np.clip(cy, ch, h - ch - 1))
            cx = int(np.clip(cx, ch, w - ch - 1))
        else:
            cy = rng.randint(ch, h - ch)
            cx = rng.randint(ch, w - ch)
        raw = img[cy - ch:cy + ch, cx - ch:cx + ch]
        if ch != half:
            # Resample the scaled context to the canonical grid.
            lin = (np.arange(2 * half) + 0.5) * (2 * ch) / (2 * half) - 0.5
            gx_, gy_ = np.meshgrid(lin, lin)
            big = _bilinear_crop(raw, gx_, gy_)
        else:
            big = raw
        for v in range(views_per_class):
            if v == 0:
                crop = big[half // 2:half // 2 + patch_size,
                           half // 2:half // 2 + patch_size].copy()
            else:
                t = np.exp(rng.uniform(0, np.log(max_tilt)))
                phi = rng.uniform(0, np.pi)
                psi = rng.uniform(-rot_jitter, rot_jitter)
                s = rng.uniform(0.8, 1.25)
                A = rot(phi) @ np.diag([np.sqrt(t), 1.0 / np.sqrt(t)]) \
                    @ rot(-phi) @ rot(psi) * s
                Ainv = np.linalg.inv(A)
                src = np.tensordot(Ainv, pts, axes=1)
                if perspective > 0:
                    # Projective view: divide by (q . p + 1).  Sampling the
                    # INVERSE map directly keeps the warp distribution
                    # symmetric without a 3x3 inverse.
                    q = rng.uniform(-perspective, perspective, 2)
                    denom = q[0] * pts[0] + q[1] * pts[1] + 1.0
                    denom = np.where(np.abs(denom) < 0.25,
                                     np.sign(denom) * 0.25, denom)
                    src = src / denom
                if mesh_warp > 0:
                    # Smooth non-planar displacement: three random
                    # low-frequency sinusoids per axis, pinned to zero at
                    # the center pixel (pts == 0) so the class anchor stays
                    # an exact correspondence.
                    for axis in (0, 1):
                        d = np.zeros_like(src[axis])
                        for _ in range(3):
                            f = rng.uniform(0.5, 1.5, 2) / patch_size
                            ph = rng.uniform(0, 2 * np.pi)
                            a_ = rng.uniform(0, mesh_warp / 3)
                            arg = 2 * np.pi * (f[0] * pts[0]
                                               + f[1] * pts[1]) + ph
                            d += a_ * (np.sin(arg) - np.sin(ph))
                        src[axis] = src[axis] + d
                sx = src[0] + half
                sy = src[1] + half
                crop = _bilinear_crop(big, sx, sy)
                if blur_jitter > 0:
                    sig = rng.uniform(0, blur_jitter)
                    if sig > 0.2:
                        from scipy.ndimage import gaussian_filter
                        crop = gaussian_filter(crop, sig, mode="nearest")
                if len(imgs) > 1 and rng.rand() < occlude_prob:
                    # Depth-layered composite: elliptical foreground from a
                    # different image, with its own photometric state.
                    j = rng.choice([k for k in range(len(imgs)) if k != i])
                    src_img = imgs[j].astype(np.float32)
                    sh, sw = src_img.shape
                    r = rng.randint(6, patch_size // 3)
                    if sh > 2 * r + 2 and sw > 2 * r + 2:
                        sy0 = rng.randint(r, sh - r)
                        sx0 = rng.randint(r, sw - r)
                        fg = src_img[sy0 - r:sy0 + r, sx0 - r:sx0 + r]
                        py = rng.randint(0, patch_size)
                        px = rng.randint(0, patch_size)
                        ry = r * rng.uniform(0.6, 1.0)
                        rx = r * rng.uniform(0.6, 1.0)
                        mask = (((oy - py) / ry) ** 2
                                + ((ox - px) / rx) ** 2) <= 1.0
                        fy_ = np.clip(oy - py + r, 0, 2 * r - 1)
                        fx_ = np.clip(ox - px + r, 0, 2 * r - 1)
                        gain_o = rng.uniform(0.7, 1.3)
                        crop = np.where(mask, fg[fy_, fx_] * gain_o, crop)
                # Photometric jitter (PhotoTour views differ in exposure).
                gain = rng.uniform(0.7, 1.3)
                bias = rng.uniform(-20, 20)
                crop = crop * gain + bias
            patches.append(np.clip(crop, 0, 255).astype(np.uint8))
            labels.append(c)
    return np.array(patches), np.array(labels, np.int64)


TRAIN_IMAGE_PATHS = (
    # Images of the reference other than the test scene (test-graf), so
    # training never sees the graf images it is evaluated on.
    "examples/hesaffnet/img/fox1.png",
    "examples/hesaffnet/img/fox2.png",
    "examples/hesaffnet/img/kpi1.png",
    "examples/hesaffnet/img/kpi2.png",
    "examples/hesaffnet/img/cat.png",
)


def load_train_images(root: str = "."):
    """The training images of TRAIN_IMAGE_PATHS that exist under ``root``
    (a checkout of the reference), grey as the mean of RGB (float64)."""
    from PIL import Image
    out = []
    for rel in TRAIN_IMAGE_PATHS:
        p = os.path.join(root, rel)
        if os.path.exists(p):
            out.append(np.mean(np.asarray(
                Image.open(p).convert("RGB")), axis=2))
    return out
