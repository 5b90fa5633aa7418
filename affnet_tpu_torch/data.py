"""Patch-pair datasets of AffNet training.

Counterparts of ``generate_pairs``, ``PairDataset``,
``synthetic_pairs_from_image`` and ``DevicePairDataset`` in
``affnet_tpu/data.py``.  The first three are numpy and draw from the same
``np.random.RandomState`` stream in the same order, so a seed gives the
same pairs, patches and flips bit for bit.  :class:`DevicePairDataset`
keeps the uint8 patch store on the device and builds each batch there.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from . import resolve_device


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
