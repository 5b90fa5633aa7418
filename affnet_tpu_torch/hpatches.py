"""The HPatches benchmark: verification, matching and retrieval.

Counterpart of ``affnet_tpu/hpatches.py``: the three tasks of "HPatches: A
benchmark and evaluation of handcrafted and learned local descriptors"
(Balntas et al., CVPR 2017) over a local ``hpatches-release`` tree (one
directory per sequence holding ``ref.png`` and ``e1..e5``, ``h1..h5``,
``t1..t5`` sheets of 65x65 patches stacked in one column):

- **verification**: same or different physical point for pairs of one
  sheet pair; ROC AUC and the false-positive rate at 95% recall;
- **matching**: nearest-neighbour matching of each reference sheet against
  each warped sheet (index-aligned); the share of correct first matches,
  by difficulty (e, h, t) and by sequence kind (i_ illumination, v_
  viewpoint);
- **retrieval**: warped patches query the pool of every sequence's
  reference patches; top-1 accuracy and mean reciprocal rank.

Sheets are read on the host with PIL.  The descriptors run on the device
in chunks of ``device_batch``: the resize of each 65x65 patch to the net's
input (:func:`resize_patches`, PIL's bilinear downscale on the device),
the net (``models.REGISTRY``, or ``SIFTNet`` at PS 65), then unit
normalization on the host as in JAX.  The tasks are numpy, as in JAX.
When the tree is absent :func:`load_sequences` raises
``FileNotFoundError``; the program prints a skip line and exits 0.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Sequence as Seq

import numpy as np
import torch
import torch.nn.functional as F

from . import load_params_npz, load_pretrained, resolve_device
from .models import REGISTRY, SIFTNet, params_from_jax
from .utils import float32_math

PATCH = 65


# ---------------------------------------------------------------------------
# Loading
# ---------------------------------------------------------------------------

def read_sheet(fname: str, patch: int = PATCH) -> np.ndarray:
    """One hpatches-release sheet, an (N * patch, patch) greyscale PNG, as
    (N, patch, patch) float32."""
    from PIL import Image
    img = Image.open(fname)
    if img.mode != "L":
        img = img.convert("L")
    arr = np.asarray(img, np.float32)
    h, w = arr.shape
    if h % patch != 0 or w != patch:
        raise ValueError(f"{fname}: unexpected sheet shape {arr.shape}")
    return arr.reshape(h // patch, patch, patch)


@dataclasses.dataclass
class Sequence:
    name: str
    ref: np.ndarray                      # (N, 65, 65)
    warped: Dict[str, np.ndarray]        # "e1".."t5" -> (N, 65, 65)

    @property
    def kind(self) -> str:
        return "v" if self.name.startswith("v_") else "i"


def load_sequences(root: str, max_seqs: Optional[int] = None,
                   difficulties: Seq[str] = ("e", "h", "t")
                   ) -> List[Sequence]:
    """The sequences under ``root`` (name order) with a ``ref.png``, each
    with its warped sheets of the reference's length; raises
    ``FileNotFoundError`` when the tree is absent or holds none."""
    if not os.path.isdir(root):
        raise FileNotFoundError(root)
    seqs = []
    for name in sorted(os.listdir(root)):
        d = os.path.join(root, name)
        if not os.path.isdir(d) or not os.path.exists(
                os.path.join(d, "ref.png")):
            continue
        ref = read_sheet(os.path.join(d, "ref.png"))
        warped = {}
        for diff in difficulties:
            for i in range(1, 6):
                f = os.path.join(d, f"{diff}{i}.png")
                if os.path.exists(f):
                    w = read_sheet(f)
                    if len(w) == len(ref):
                        warped[f"{diff}{i}"] = w
        if warped:
            seqs.append(Sequence(name, ref, warped))
        if max_seqs is not None and len(seqs) >= max_seqs:
            break
    if not seqs:
        raise FileNotFoundError(f"no sequences under {root}")
    return seqs


# ---------------------------------------------------------------------------
# Descriptors
# ---------------------------------------------------------------------------

def resize_patches(patches: np.ndarray, ps: int, device: Any) -> torch.Tensor:
    """(N, S, S) grey patches (0-255) -> (N, ps, ps) float32 on ``device``,
    as JAX resizes them (each patch as a uint8 PIL image, ``resize`` with
    ``BILINEAR``): PIL's downscale is a triangle filter stretched by the
    scale (``F.interpolate``'s ``antialias``), applied along the rows and
    then along the columns, each pass rounded half up to uint8.  Patches
    already ``ps`` wide are returned as they are."""
    x = torch.as_tensor(np.asarray(patches, np.float32), device=device)
    if x.shape[1] == ps:
        return x
    x = x.to(torch.uint8).float()[:, None]
    for size in ((x.shape[2], ps), (ps, ps)):
        x = F.interpolate(x, size=size, mode="bilinear", antialias=True,
                          align_corners=False)
        x = torch.floor(x + 0.5).clamp_(0.0, 255.0)
    return x[:, 0]


def make_descriptor_fn(descriptor: str = "TFeat",
                       weights: Optional[str] = None,
                       device_batch: int = 2048, device: Any = "cuda"):
    """(fn, ps): fn maps (N, 65, 65) patches (0-255) to (N, D) unit float32
    descriptors on the host.  ``pixels`` is the net-free baseline (the 16x16
    resize, mean removed, unit norm); ``SIFT`` the weight-free SIFTNet at
    the sheets' 65 px; ``TFeat`` (HardTFeatNet), ``HardNet`` or another
    ``models.REGISTRY`` name a net with ``weights`` (an npz, e.g. a
    ``train_descriptor`` checkpoint) or its shipped weights."""
    dev = resolve_device(device)
    if descriptor == "pixels":
        def fn(patches: np.ndarray) -> np.ndarray:
            x = resize_patches(patches, 16, dev).reshape(len(patches), -1)
            x = (x - x.mean(dim=1, keepdim=True)).cpu().numpy()
            return x / (np.linalg.norm(x, axis=1, keepdims=True) + 1e-8)
        return fn, 16

    if descriptor == "SIFT":
        net = SIFTNet()
    else:
        name = "HardTFeatNet" if descriptor == "TFeat" else descriptor
        net = REGISTRY[name]()
        net.load_state_dict(params_from_jax(
            load_params_npz(weights) if weights else load_pretrained(name)))
    net = net.to(dev).eval()

    @float32_math()
    @torch.no_grad()
    def fn(patches: np.ndarray) -> np.ndarray:
        outs = [net(resize_patches(patches[i:i + device_batch], net.ps,
                                   dev)).float().cpu().numpy()
                for i in range(0, len(patches), device_batch)]
        out = np.concatenate(outs)
        return out / (np.linalg.norm(out, axis=1, keepdims=True) + 1e-8)

    return fn, net.ps


# ---------------------------------------------------------------------------
# Tasks
# ---------------------------------------------------------------------------

def _auc(pos: np.ndarray, neg: np.ndarray) -> float:
    """ROC AUC for distances (smaller = same), by the rank statistic with
    midranks for ties."""
    scores = np.concatenate([-pos, -neg])
    labels = np.concatenate([np.ones(len(pos)), np.zeros(len(neg))])
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty(len(scores))
    ranks[order] = np.arange(1, len(scores) + 1)
    s_sorted = scores[order]
    i = 0
    while i < len(s_sorted):
        j = i
        while j + 1 < len(s_sorted) and s_sorted[j + 1] == s_sorted[i]:
            j += 1
        ranks[order[i:j + 1]] = 0.5 * (i + j) + 1
        i = j + 1
    n_pos, n_neg = len(pos), len(neg)
    return float((ranks[labels == 1].sum()
                  - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def _fpr_at_recall(pos: np.ndarray, neg: np.ndarray,
                   recall: float = 0.95) -> float:
    th = np.quantile(pos, recall)
    return float((neg <= th).mean())


def task_verification(seqs: List[Sequence], desc_fn, rng_seed: int = 0,
                      pairs_per_seq: int = 512) -> Dict[str, float]:
    """Positives: the reference patch and its warped copy in a random
    sheet; negatives: the reference patch and another index of that sheet
    (intra-sequence, the harder protocol)."""
    rng = np.random.RandomState(rng_seed)
    pos_d, neg_d = [], []
    descs = {s.name: {k: desc_fn(v) for k, v in
                      dict(ref=s.ref, **s.warped).items()} for s in seqs}
    for s in seqs:
        d = descs[s.name]
        n = len(s.ref)
        keys = [k for k in d if k != "ref"]
        for _ in range(pairs_per_seq):
            k = keys[rng.randint(len(keys))]
            i = rng.randint(n)
            pos_d.append(np.linalg.norm(d["ref"][i] - d[k][i]))
            j = (i + 1 + rng.randint(n - 1)) % n
            neg_d.append(np.linalg.norm(d["ref"][i] - d[k][j]))
    pos, neg = np.array(pos_d), np.array(neg_d)
    return {"auc": _auc(pos, neg),
            "fpr95": _fpr_at_recall(pos, neg, 0.95),
            "n_pairs": int(len(pos))}


def task_matching(seqs: List[Sequence], desc_fn) -> Dict[str, float]:
    by_diff: Dict[str, List[float]] = {}
    by_kind: Dict[str, List[float]] = {}
    for s in seqs:
        dref = desc_fn(s.ref)
        for k, sheet in s.warped.items():
            dw = desc_fn(sheet)
            sim = dref @ dw.T
            acc = float((np.argmax(sim, axis=1)
                         == np.arange(len(dref))).mean())
            by_diff.setdefault(k[0], []).append(acc)
            by_kind.setdefault(s.kind, []).append(acc)
    out = {f"map_{d}": float(np.mean(v)) for d, v in sorted(by_diff.items())}
    out.update({f"map_kind_{k}": float(np.mean(v))
                for k, v in sorted(by_kind.items())})
    out["map"] = float(np.mean(sum(by_diff.values(), [])))
    return out


def task_retrieval(seqs: List[Sequence], desc_fn, rng_seed: int = 0,
                   queries_per_seq: int = 64) -> Dict[str, float]:
    """Each sequence's first and last warped sheets (one easy, one tough)
    query the pool of every reference patch."""
    rng = np.random.RandomState(rng_seed)
    ref_descs = [desc_fn(s.ref) for s in seqs]
    pool = np.concatenate(ref_descs)
    offsets = np.cumsum([0] + [len(d) for d in ref_descs[:-1]])
    top1, rr = [], []
    for si, s in enumerate(seqs):
        keys = sorted(s.warped)
        n = len(s.ref)
        qidx = rng.randint(0, n, size=min(queries_per_seq, n))
        for k in keys[:1] + keys[-1:]:
            dq = desc_fn(s.warped[k][qidx])
            sim = dq @ pool.T
            true = offsets[si] + qidx
            order = np.argsort(-sim, axis=1)
            rank = np.argmax(order == true[:, None], axis=1) + 1
            top1.extend((rank == 1).tolist())
            rr.extend((1.0 / rank).tolist())
    return {"top1": float(np.mean(top1)), "mrr": float(np.mean(rr)),
            "pool_size": int(len(pool)), "n_queries": int(len(top1))}


def run_benchmark(root: str, descriptor: str = "TFeat",
                  weights: Optional[str] = None,
                  max_seqs: Optional[int] = None,
                  tasks: Seq[str] = ("verification", "matching",
                                     "retrieval"),
                  device: Any = "cuda") -> Dict[str, Any]:
    """The chosen tasks over the tree at ``root``, each array of patches
    described once (memoized across the tasks by identity).  The memo
    holds each array it keys, so a freed temporary (retrieval's query
    rows) cannot pass its identity on to the next one; JAX's memo holds
    only the descriptors, and there a later query sheet can be served an
    earlier one's descriptors."""
    seqs = load_sequences(root, max_seqs=max_seqs)
    desc_fn, _ = make_descriptor_fn(descriptor, weights, device=device)
    cache: Dict[int, tuple] = {}

    def cached(patches: np.ndarray) -> np.ndarray:
        key = id(patches)
        if key not in cache:
            cache[key] = (patches, desc_fn(patches))
        return cache[key][1]

    out: Dict[str, Any] = {"n_sequences": len(seqs),
                           "descriptor": descriptor}
    if "verification" in tasks:
        out["verification"] = task_verification(seqs, cached)
    if "matching" in tasks:
        out["matching"] = task_matching(seqs, cached)
    if "retrieval" in tasks:
        out["retrieval"] = task_retrieval(seqs, cached)
    return out
