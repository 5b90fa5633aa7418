"""The zoo's AffNet variants and HardNetNarELU, YiNet, the ``.pth``
readers, ``debug_nans``, ``l1norm`` and the cnhw eval layout against the
JAX package, on the same seeded inputs and weights (``params_from_jax``).

Each net runs on 8 seeded 32x32 patches with JAX's seeded init and
seeded BatchNorm statistics (so folding is exercised); one JAX run per
net and layout is shared by the tests (``_jax_out``).  Tolerances:

- nchw and cnhw, float32: atol 2e-6 (the same float32 sums in another
  order; the atan2 heads carry their inputs' error into the angle, and
  the rectification divides by sqrt(det)).  Measured on these inputs: at
  most 1.8e-7 against JAX under nchw and under cnhw, 2.4e-7 between the
  port's cnhw and nchw.
- the port's flat (the plain B7) against its own nchw: atol 5e-6, the JAX
  layout test's own (tests/test_models.py ``test_eval_conv_layout_parity``);
  against JAX's interpreted flat stack, the same.  Measured: 1.5e-7 and
  1.2e-7.
- cnhw in bf16: atol 1e-3 and a mean under 1e-4 (bf16 activations, one
  bf16 ulp where a float32 sum rounds the other way).  Measured: 6.0e-8.
"""

import contextlib
import functools
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from affnet_tpu.models import cnn as jcnn
from affnet_tpu.models import convert as jconvert
from affnet_tpu.models import zoo as jzoo
from affnet_tpu.models.yinet import YiNet as JYiNet
from affnet_tpu_torch import utils
from affnet_tpu_torch.models import (REGISTRY, AffNet, YiNet, cnn, convert,
                                     params_from_jax, params_to_jax, zoo)
from affnet_tpu_torch.ops import launch_counts

AFFNETS = ["AffNetFast", "AffNetFast4", "AffNetFastScale", "AffNetFast4Rot",
           "AffNetFast4RotNosc", "AffNetFast52RotUp", "AffNetFast52Rot",
           "AffNetFast52RotL", "AffNetFast5Rot", "AffNetFast2Par",
           "AffNetFastBias"]
NETS = AFFNETS + ["HardNetNarELU"]
N = 8


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's side on one thread: its tensors here are a few patches,
    where the intra-op pool's threads cost more CPU than they save."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_params(name, seed=3):
    """JAX's seeded init with seeded BatchNorm statistics, numpy leaves
    (one draw per net, shared: callers only read it)."""
    params = jax.tree_util.tree_map(
        np.asarray, jzoo.REGISTRY[name].init(jax.random.PRNGKey(seed)))
    rng = np.random.RandomState(seed)
    for p in params.values():
        if "mean" in p:
            p["mean"] = (0.1 * rng.randn(*p["mean"].shape)).astype(np.float32)
            p["var"] = rng.uniform(0.5, 2.0, p["var"].shape).astype(np.float32)
    return params


def _patches(seed=1):
    return np.random.RandomState(seed).rand(N, 32, 32).astype(np.float32)


@contextlib.contextmanager
def _layout(layout):
    old = jcnn.EVAL_CONV_LAYOUT
    jcnn.EVAL_CONV_LAYOUT = layout
    try:
        with cnn.eval_layout(layout):
            yield
    finally:
        jcnn.EVAL_CONV_LAYOUT = old


@functools.lru_cache(maxsize=None)
def _jax_out(name, layout, bf16=False):
    jnet = jzoo.REGISTRY[name]
    if bf16:
        jnet = jnet.with_dtype(jnp.bfloat16)
    params = jax.tree_util.tree_map(jnp.asarray, _jax_params(name))
    with _layout(layout):
        return np.asarray(jnet(params, jnp.asarray(_patches())))


def _port_out(name, layout, bf16=False):
    net = REGISTRY[name]()
    net.load_state_dict(params_from_jax(_jax_params(name)))
    if bf16:
        net = net.with_dtype(torch.bfloat16)
    with cnn.eval_layout(layout), torch.no_grad():
        return net(torch.from_numpy(_patches())).numpy()


# ---------------------------------------------------------------------------
# The registry, the family and the init
# ---------------------------------------------------------------------------

def test_registry_has_jax_names_and_affnet_family():
    assert sorted(REGISTRY) == sorted(jzoo.REGISTRY)
    assert sorted(n for n, c in REGISTRY.items()
                  if issubclass(c, AffNet)) == sorted(AFFNETS)
    with pytest.raises(KeyError, match="AffNetFast4.*OriNetFast32"):
        REGISTRY["AffNetFast7"]


@pytest.mark.parametrize("name", sorted(jzoo.REGISTRY))
def test_init_matches_jax_biases_gains_and_layout(name):
    """``PatchNet.init`` writes JAX's biases (``last_bias`` on the last
    conv, 0.01 elsewhere), orthogonal weights at JAX's gains (the rows or
    columns of each flattened weight have norm gain), unit BatchNorm
    statistics, and the same parameter tree shapes."""
    jnet = jzoo.REGISTRY[name]
    ref = _jax_params(name)     # its seeded BatchNorm statistics unread
    net = REGISTRY[name]().init(torch.Generator().manual_seed(0))
    got = params_to_jax(net.state_dict())
    assert {k: {f: v.shape for f, v in d.items()} for k, d in got.items()} \
        == {k: {f: v.shape for f, v in d.items()} for k, d in ref.items()}
    convs = sorted((k for k in ref if "w" in ref[k]), key=lambda k: int(k[5:]))
    for k in convs:
        if "b" in ref[k]:
            np.testing.assert_array_equal(got[k]["b"], ref[k]["b"])
        w = got[k]["w"].reshape(-1, got[k]["w"].shape[-1])     # (khkwI, O)
        gram = w.T @ w if w.shape[1] <= w.shape[0] else w @ w.T
        wr = ref[k]["w"].reshape(w.shape)
        gref = wr.T @ wr if w.shape[1] <= w.shape[0] else wr @ wr.T
        np.testing.assert_allclose(np.diag(gram), np.diag(gref), rtol=1e-4)
    for k, d in got.items():
        if "mean" in d:
            np.testing.assert_array_equal(d["mean"], 0.0)
            np.testing.assert_array_equal(d["var"], 1.0)
    assert REGISTRY[name].init_gain == jnet.init_gain
    assert REGISTRY[name].last_bias == (
        None if jnet.last_bias is None
        else tuple(float(b) for b in jnet.last_bias))


# ---------------------------------------------------------------------------
# The nets against JAX under the three layouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NETS)
def test_net_nchw_matches_jax(name):
    got, ref = _port_out(name, "nchw"), _jax_out(name, "nchw")
    assert got.shape == ref.shape == ((N, 64) if name == "HardNetNarELU"
                                      else (N, 2, 2))
    np.testing.assert_allclose(got, ref, atol=2e-6)


@pytest.mark.parametrize("name", NETS)
def test_net_cnhw_matches_jax_cnhw(name):
    got, ref = _port_out(name, "cnhw"), _jax_out(name, "cnhw")
    np.testing.assert_allclose(got, ref, atol=2e-6)
    np.testing.assert_allclose(got, _port_out(name, "nchw"), atol=2e-6)


@pytest.mark.parametrize("name", ["AffNetFast52RotUp", "HardNetNarELU"])
def test_net_cnhw_bf16_matches_jax_cnhw_bf16(name):
    """The bf16 chain under cnhw (HardNetNarELU ignores the dtype, so it
    is float32 on both sides)."""
    got, ref = _port_out(name, "cnhw", True), _jax_out(name, "cnhw", True)
    tol = 2e-6 if name == "HardNetNarELU" else 1e-3
    np.testing.assert_allclose(got, ref, atol=tol)
    assert np.abs(got - ref).mean() < tol / 10


@pytest.mark.parametrize("name", NETS)
def test_net_flat_matches_port_nchw(name):
    """The flat stack through the plain B7 (CPU tensors: no launch)."""
    before = launch_counts()
    got = _port_out(name, "flat")
    assert launch_counts() == before
    np.testing.assert_allclose(got, _port_out(name, "nchw"), atol=5e-6)


@pytest.mark.parametrize("name", ["AffNetFast4", "HardNetNarELU"])
def test_net_flat_matches_jax_flat(name):
    """A no-BN6 trunk (conv and ReLU folded into one B7 layer) and
    NarELU's biased ELU layers against JAX's interpreted flat stack."""
    np.testing.assert_allclose(_port_out(name, "flat"),
                               _jax_out(name, "flat"), atol=5e-6)


def test_narelu_ignores_with_dtype():
    """JAX's HardNetNarELU.features calls apply_spec without a dtype:
    ``with_dtype(bf16)`` leaves it in float32, and skips input_norm."""
    params = _jax_params("HardNetNarELU")
    net = zoo.HardNetNarELU()
    net.load_state_dict(params_from_jax(params))
    x = torch.from_numpy(_patches())
    with torch.no_grad():
        ref = net(x)
        for layout in ("nchw", "cnhw"):
            with cnn.eval_layout(layout):
                got = net.with_dtype(torch.bfloat16)(x)
            assert got.dtype == torch.float32
            torch.testing.assert_close(got, ref, rtol=0, atol=1e-6)
        # No input_norm: an affine change of the input changes the output.
        assert not torch.allclose(net(2 * x + 1), ref, atol=1e-3)
    jref = _jax_out("HardNetNarELU", "nchw")
    jbf = np.asarray(jzoo.HardNetNarELU.with_dtype(jnp.bfloat16)(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(_patches())))
    np.testing.assert_array_equal(jbf, jref)


# ---------------------------------------------------------------------------
# The eval layouts
# ---------------------------------------------------------------------------

def test_eval_layout_takes_cnhw(monkeypatch):
    """``eval_layout("cnhw")`` sets the layout for a block and restores
    it; the nets' eval forward then runs ``apply_cnhw`` (and the training
    forward does not)."""
    calls = []
    real = zoo.apply_cnhw
    monkeypatch.setattr(zoo, "apply_cnhw",
                        lambda *a: calls.append(1) or real(*a))
    before = cnn.EVAL_CONV_LAYOUT
    net = zoo.AffNetFast()
    x = torch.rand(2, 32, 32)
    with cnn.eval_layout("cnhw"):
        assert cnn.EVAL_CONV_LAYOUT == "cnhw"
        net(x)
        net.train()(x)
    assert cnn.EVAL_CONV_LAYOUT == before and calls == [1]


def test_conv_cnhw_matches_conv2d():
    """One conv at stride 1 and 2, pad 0 and 1, with and without a bias,
    against ``F.conv2d`` on the NCHW tensor."""
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(3, 5, 12, 12).astype(np.float32))
    for stride, pad, bias in ((1, 1, True), (2, 1, False), (1, 0, True),
                              (2, 0, True)):
        conv = torch.nn.Conv2d(5, 8, 3, stride, pad, bias=bias)
        with torch.no_grad():
            got = cnn.conv_cnhw(x.transpose(0, 1), conv).transpose(0, 1)
            torch.testing.assert_close(got, conv(x), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="stride"):
        cnn.conv_cnhw(x.transpose(0, 1), torch.nn.Conv2d(5, 8, 3, 3))


def test_l1norm_matches_jax():
    x = np.random.RandomState(5).randn(7, 11).astype(np.float32)
    got = cnn.l1norm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jcnn.l1norm(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.abs(got).sum(1), 1.0, rtol=1e-5)


# ---------------------------------------------------------------------------
# YiNet
# ---------------------------------------------------------------------------

def test_yinet_matches_jax():
    """Angles within 1e-5 rad, the rotation matrices (by minus the angle)
    within 1e-5, on 6 seeded 28x28 patches."""
    jnet = JYiNet()
    params = jax.tree_util.tree_map(np.asarray,
                                    jnet.init(jax.random.PRNGKey(1)))
    x = np.random.RandomState(2).rand(6, 28, 28).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    ref_a = np.asarray(jnet(jp, jnp.asarray(x)))
    ref_r = np.asarray(jnet(jp, jnp.asarray(x), return_rot_matrix=True))
    net = YiNet()
    net.load_state_dict(YiNet.state_dict_from_tree(params))
    with torch.no_grad():
        a = net(torch.from_numpy(x)).numpy()
        r = net(torch.from_numpy(x), return_rot_matrix=True).numpy()
    assert a.shape == (6,) and r.shape == (6, 2, 2)
    np.testing.assert_allclose(a, ref_a, atol=1e-5)
    np.testing.assert_allclose(r, ref_r, atol=1e-5)
    np.testing.assert_allclose(r[:, 0, 1], -np.sin(a), atol=1e-6)
    fresh = YiNet().init(torch.Generator().manual_seed(0))
    assert float(fresh.conv0.bias.abs().max()) == 0.0
    assert 0.03 < float(fresh.ghh0["w"].std()) < 0.07


def test_yinet_import_weights_round_trip(tmp_path):
    """LIFT's .npy dump layout (conv W in OIHW, GHH W reshape-compatible
    with (n_in, n_out*s*m)), written from JAX's seeded init: both
    packages' import_weights give the same parameters and angles."""
    jnet = JYiNet()
    params = jax.tree_util.tree_map(np.asarray,
                                    jnet.init(jax.random.PRNGKey(3)))
    for i, name in enumerate(["conv0", "conv1", "conv2"]):
        np.save(tmp_path / f"layer{i}_W.npy",
                np.transpose(params[name]["w"], (3, 2, 0, 1)))
        np.save(tmp_path / f"layer{i}_b.npy", params[name]["b"])
    for i, name in enumerate(["ghh0", "ghh1"]):
        np.save(tmp_path / f"layer{i + 3}_W.npy", params[name]["w"])
        np.save(tmp_path / f"layer{i + 3}_b.npy", params[name]["b"][None])
    jimported = jnet.import_weights(str(tmp_path))
    net = YiNet().import_weights(str(tmp_path))
    sd = YiNet.state_dict_from_tree(
        jax.tree_util.tree_map(np.asarray, jimported))
    for k, v in net.state_dict().items():
        assert torch.equal(v, sd[k]), k
    x = np.random.RandomState(5).rand(3, 28, 28).astype(np.float32)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jnet(jimported,
                                                    jnp.asarray(x))),
                               atol=1e-5)


# ---------------------------------------------------------------------------
# The .pth readers
# ---------------------------------------------------------------------------

def _reference_state_dict(name, index_map=None):
    """A reference-layout state_dict of the net ``name`` with JAX's seeded
    init: ``features.{i}`` (or ``index_map[i]``) keys, OIHW weights,
    BatchNorm running statistics and ``num_batches_tracked``."""
    sd = params_from_jax(_jax_params(name), prefix="features")
    if index_map:
        for i, base in index_map.items():
            for field in ("weight", "bias"):
                key = f"features.{i}.{field}"
                if key in sd:
                    sd[f"{base}.{field}"] = sd.pop(key)
    return sd


@pytest.mark.parametrize("name,index_map", [
    ("AffNetFast52RotUp", None), ("OriNetFast", None),
    ("HardTFeatNet", "HARDTFEAT_INDEX_MAP")])
def test_pth_readers_match_jax(tmp_path, name, index_map):
    """A ``torch.save``d ``{'epoch', 'state_dict'}`` through both
    packages' ``convert_pth`` (HardTFeatNet with its features/classifier
    index map) and ``save_params_npz``: the same tree, the same npz, and the
    loaded net equal to the JAX net's output."""
    jmap = getattr(jconvert, index_map) if index_map else None
    tmap = getattr(convert, index_map) if index_map else None
    if index_map:
        assert tmap == jmap
    # HardTFeatNet's reference layout: conv 6 lives in classifier.1.
    sd = _reference_state_dict(name, jmap and {6: jmap[6]})
    path = tmp_path / f"{name}.pth"
    torch.save({"epoch": 7, "state_dict": sd}, path)
    jtree = jconvert.convert_pth(str(path), jzoo.REGISTRY[name].spec,
                                 index_map=jmap)
    net = REGISTRY[name]()
    got = convert.convert_pth(str(path), net, index_map=tmap)
    net.load_state_dict(got)
    tree = params_to_jax(got)
    assert sorted(tree) == sorted(jtree)
    for k in jtree:
        for f in jtree[k]:
            np.testing.assert_array_equal(tree[k][f], jtree[k][f])
    assert convert.load_torch_checkpoint(str(path)).keys() == sd.keys()
    torch.save(sd, tmp_path / "bare.pth")
    assert convert.load_torch_checkpoint(str(tmp_path / "bare.pth")).keys() \
        == sd.keys()
    jconvert.save_params_npz(jtree, str(tmp_path / "j" / "w.npz"))
    convert.save_params_npz(got, str(tmp_path / "t" / "w.npz"))
    with np.load(tmp_path / "j" / "w.npz") as a, \
            np.load(tmp_path / "t" / "w.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for f in a.files:
            np.testing.assert_array_equal(a[f], b[f])
    x = np.random.RandomState(0).rand(4, net.ps, net.ps).astype(np.float32)
    with torch.no_grad():
        out = net(torch.from_numpy(x)).numpy()
    ref = np.asarray(jzoo.REGISTRY[name](
        jax.tree_util.tree_map(jnp.asarray, jtree), jnp.asarray(x)))
    np.testing.assert_allclose(out, ref, atol=2e-5)


# ---------------------------------------------------------------------------
# debug_nans
# ---------------------------------------------------------------------------

def test_debug_nans_raises_inside_and_restores():
    """Inside ``debug_nans`` a forward given a NaN patch raises, and a
    backward that makes a NaN raises (anomaly mode); outside, the same
    forward returns NaNs, and anomaly mode is as it was."""
    net = zoo.AffNetFast().init(torch.Generator().manual_seed(0))
    x = torch.rand(3, 32, 32)
    x[1, 4, 4] = float("nan")
    before = torch.is_anomaly_enabled()
    with utils.debug_nans():
        assert torch.is_anomaly_enabled()
        with pytest.raises(FloatingPointError, match="AffNetFast"):
            net(x)
        net(torch.rand(3, 32, 32))          # finite: no raise
        z = torch.zeros(2, requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(z - 1.0).sum().backward()
        with utils.debug_nans(False):
            assert not torch.isfinite(net(x)).all()
            assert not torch.is_anomaly_enabled()
        assert torch.is_anomaly_enabled()
    assert torch.is_anomaly_enabled() == before
    assert not torch.isfinite(net(x)).all()
    tree = {"a": np.array([1.0, np.inf]), "b": [torch.ones(2)]}
    assert utils.check_finite(tree) is tree
    with utils.debug_nans(), pytest.raises(FloatingPointError, match="out"):
        utils.check_finite(tree, "out")


def test_shape_arch_extractor_takes_ablation_nets(tmp_path, monkeypatch):
    """``eval_graf``'s extractor with ``shape_arch`` an ablation AffNet
    and ``shape_weights`` an npz written by the JAX package (its seeded
    init of AffNetFast52RotUp): the net carries those weights and shapes
    every keypoint of the 120x160 golden image (50 features)."""
    from affnet_tpu_torch.cli import eval_graf
    img = np.load(os.path.join(os.path.dirname(__file__), "fixtures",
                               "detector_golden.npz"))["img"]
    params = _jax_params("AffNetFast52RotUp", seed=5)
    jconvert.save_params_npz(params, str(tmp_path / "w.npz"))
    det = eval_graf.make_extractor(50, "SIFT",
                                   shape_arch="AffNetFast52RotUp",
                                   shape_weights=str(tmp_path / "w.npz"),
                                   device="cpu")
    assert isinstance(det.shape_net, zoo.AffNetFast52RotUp)
    tree = params_to_jax(det.shape_net.state_dict())
    for k in params:
        for f in params[k]:
            np.testing.assert_array_equal(tree[k][f], params[k][f])
    seen = []
    real = zoo.AffNetFast52RotUp.head
    monkeypatch.setattr(zoo.AffNetFast52RotUp, "head",
                        lambda self, x: seen.append(len(x)) or real(self, x))
    out = det(img)
    assert seen and seen[0] >= len(out["lafs"]) > 0
    assert np.isfinite(out["lafs"]).all()
