"""The port's HPatches benchmark (``affnet_tpu_torch/hpatches.py``,
``cli/eval_hpatches.py``) and HPatches readers (``data.read_patch_file``,
``HPatchesDM``) against the JAX package's on the same ``tmp_path`` trees:
each case of tests/test_hpatches.py (and the reader case of
tests/test_utils.py) with the port's outputs held to JAX's.

Tolerances (stated beside each check):
  - the 65 -> 32 and 65 -> 16 resize against PIL's BILINEAR on uint8
    images: within 1 grey level, at most 1% of the pixels off (measured
    0.30% and 0.17% on random patches): PIL computes in 22-bit fixed
    point, so a value within rounding of a half rounds the other way;
  - descriptors against JAX's: SIFT (no resize) atol 1e-5 (measured
    1.0e-7); pixels atol 5e-3 (measured 2.0e-3: one grey level of one
    resized pixel moves its entry of the unit vector by 1 / |x - mean|,
    some 1.3e-3 on these patches); TFeat atol 2e-3 (measured 3.8e-4);
  - the task metrics: matching accuracies, top-1 and the counts equal;
    AUC, FPR at 95% and MRR within 1e-3;
  - loading and the readers: bit for bit.
"""

import json
import os

import numpy as np
import jax
import pytest
import torch
from PIL import Image

from affnet_tpu import data as jdata
from affnet_tpu import hpatches as J
from affnet_tpu.cli import eval_hpatches as jcli
from affnet_tpu_torch import data as tdata
from affnet_tpu_torch import hpatches as H
from affnet_tpu_torch.cli import eval_hpatches as tcli

from test_hpatches import _make_tree


@pytest.fixture(autouse=True)
def _jax_on_cpu():
    with jax.default_device(jax.devices("cpu")[0]):
        yield


def _desc(name, backend, **kw):
    if backend is J:
        return J.make_descriptor_fn(name, **kw)
    return H.make_descriptor_fn(name, device="cpu", **kw)


@pytest.fixture()
def trees(tmp_path):
    _make_tree(str(tmp_path), n_seqs=2)
    return str(tmp_path), J.load_sequences(str(tmp_path))


def test_read_sheet_roundtrip(tmp_path):
    _make_tree(str(tmp_path), n_seqs=1)
    (s,) = H.load_sequences(str(tmp_path))
    (j,) = J.load_sequences(str(tmp_path))
    assert s.ref.shape == (8, 65, 65) and s.kind == j.kind == "i"
    assert s.name == j.name and set(s.warped) == set(j.warped) == {
        "e1", "h1", "t1"}
    assert np.array_equal(s.ref, j.ref)
    for k in s.warped:
        assert np.array_equal(s.warped[k], j.warped[k])


def test_missing_root_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        H.load_sequences(str(tmp_path / "nope"))


@pytest.mark.parametrize("ps", [32, 16])
def test_resize_matches_pil(ps):
    rng = np.random.RandomState(ps)
    patches = (rng.rand(100, 65, 65) * 255).astype(np.uint8).astype(
        np.float32)
    ref = np.stack([np.asarray(Image.fromarray(p.astype(np.uint8)).resize(
        (ps, ps), Image.BILINEAR), np.float32) for p in patches])
    got = H.resize_patches(patches, ps, "cpu").numpy()
    diff = np.abs(got - ref)
    assert diff.max() <= 1.0
    assert (diff > 0).mean() <= 0.01, f"{(diff > 0).mean():.4%} differ"
    assert np.array_equal(H.resize_patches(patches, 65, "cpu").numpy(),
                          patches)


@pytest.mark.parametrize("name,atol", [("SIFT", 1e-5), ("pixels", 5e-3),
                                       ("TFeat", 2e-3)])
def test_descriptors_match_jax(trees, name, atol):
    _, seqs = trees
    patches = np.concatenate([seqs[0].ref, seqs[1].warped["t1"]])
    fn, ps = _desc(name, H)
    jfn, jps = _desc(name, J)
    got, ref = fn(patches), jfn(patches)
    assert ps == jps and got.shape == ref.shape
    assert np.allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    err = float(np.abs(got - ref).max())
    assert err <= atol, f"{name}: max |port - JAX| {err:.3g}"


def test_matching_pixels_matches_jax(trees):
    _, seqs = trees
    out = H.task_matching(seqs, _desc("pixels", H)[0])
    assert out == J.task_matching(seqs, _desc("pixels", J)[0])
    assert out["map_e"] == 1.0 and 0.0 <= out["map_t"] <= 1.0
    assert set(out) >= {"map", "map_e", "map_h", "map_t", "map_kind_i",
                        "map_kind_v"}


def _close(got, ref, keys_equal, keys_close):
    for k in keys_equal:
        assert got[k] == ref[k], k
    for k in keys_close:
        assert abs(got[k] - ref[k]) <= 1e-3, (k, got[k], ref[k])


def test_verification_matches_jax(trees):
    _, seqs = trees
    out = H.task_verification(seqs, _desc("pixels", H)[0], pairs_per_seq=128)
    ref = J.task_verification(seqs, _desc("pixels", J)[0], pairs_per_seq=128)
    _close(out, ref, ["n_pairs"], ["auc", "fpr95"])
    assert out["auc"] > 0.9 and out["fpr95"] < 0.5


def test_retrieval_matches_jax(trees):
    _, seqs = trees
    out = H.task_retrieval(seqs, _desc("pixels", H)[0], queries_per_seq=8)
    ref = J.task_retrieval(seqs, _desc("pixels", J)[0], queries_per_seq=8)
    _close(out, ref, ["pool_size", "n_queries", "top1"], ["mrr"])
    assert out["pool_size"] == 16 and out["top1"] > 0.5
    assert 0.0 < out["mrr"] <= 1.0


@pytest.mark.parametrize("descriptor", ["pixels", "SIFT", "TFeat"])
def test_run_benchmark_matches_jax(trees, descriptor):
    root, _ = trees
    out = H.run_benchmark(root, descriptor, device="cpu")
    ref = J.run_benchmark(root, descriptor)
    assert out["n_sequences"] == ref["n_sequences"] == 2
    _close(out["matching"], ref["matching"], list(ref["matching"]), [])
    _close(out["verification"], ref["verification"], ["n_pairs"],
           ["auc", "fpr95"])
    _close(out["retrieval"], ref["retrieval"],
           ["pool_size", "n_queries", "top1"], ["mrr"])


def test_run_benchmark_describes_each_array(trees, monkeypatch):
    """The memo holds the arrays it keys: each of retrieval's query arrays
    (two per sequence) is described, none served another's descriptors
    through a reused identity."""
    root, seqs = trees
    calls = []
    real = H.make_descriptor_fn

    def counting(*args, **kwargs):
        fn, ps = real(*args, **kwargs)
        return (lambda p: calls.append(len(p)) or fn(p)), ps

    monkeypatch.setattr(H, "make_descriptor_fn", counting)
    H.run_benchmark(root, "pixels", tasks=("retrieval",), device="cpu")
    assert calls == [8, 8] + [8] * (2 * len(seqs))


def _main_json(main, argv, capsys):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out)


def test_cli_skip_line_is_jax(tmp_path, capsys):
    argv = ["--root", str(tmp_path / "absent")]
    got = _main_json(tcli.main, argv + ["--device", "cpu"], capsys)
    assert got == _main_json(jcli.main, argv, capsys)
    assert got["skipped"] is True


@pytest.mark.parametrize("n_seqs,descriptor", [(2, "pixels"), (1, "SIFT")])
def test_cli_runs_like_jax(tmp_path, capsys, n_seqs, descriptor):
    _make_tree(str(tmp_path), n_seqs=n_seqs)
    argv = ["--root", str(tmp_path), "--descriptor", descriptor, "--tasks",
            "matching"]
    got = _main_json(tcli.main, argv + ["--device", "cpu"], capsys)
    assert got == _main_json(jcli.main, argv, capsys)
    assert got["n_sequences"] == n_seqs and got["matching"]["map_e"] >= 0.5


def test_cli_defaults_to_the_card(tmp_path):
    """Without --device the descriptors ask for the card and, without one,
    raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    _make_tree(str(tmp_path), n_seqs=1)
    with pytest.raises(RuntimeError, match="device='cuda' requested"):
        tcli.main(["--root", str(tmp_path), "--descriptor", "SIFT"])


def test_read_patch_file_and_hpatchesdm_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    # 4 rows x 3 cols of 65px cells; one row blank (skipped).
    sheet = (rng.rand(4 * 65, 3 * 65) * 200 + 20).astype(np.uint8)
    sheet[2 * 65:3 * 65] = 0
    trees = {}
    for pkg in ("jax", "port"):
        d = tmp_path / pkg / "seq"
        d.mkdir(parents=True)
        Image.fromarray(sheet).convert("RGB").save(d / "a.png")
        (d / "junk.png").write_bytes(b"not a png")   # skipped by both
        with open(tmp_path / pkg / "splits.json", "w") as f:
            json.dump({"b": {"train": ["a", "junk"], "test": []}}, f)
        trees[pkg] = str(tmp_path / pkg)
    got = tdata.read_patch_file(os.path.join(trees["port"], "seq", "a.png"))
    ref = jdata.read_patch_file(os.path.join(trees["jax"], "seq", "a.png"))
    assert np.array_equal(got[0], ref[0]) and got[1:] == ref[1:]
    assert len(got[1]) == 3 and got[0].shape == (9, 65, 65)
    kw = dict(train=True, n_pairs=8, batch_size=2)
    batches = list(tdata.HPatchesDM(trees["port"], "seq", **kw).batches())
    jbatches = list(jdata.HPatchesDM(trees["jax"], "seq", **kw).batches())
    assert len(batches) == len(jbatches) == 4
    for b, jb in zip(batches, jbatches):
        assert b[0].shape == (2, 65, 65)
        assert all(np.array_equal(x, y) for x, y in zip(b, jb))
