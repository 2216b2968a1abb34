"""The port's CORAL stage-2 evaluation and serving on the CPU against the JAX
package.

The pools, the UDLR refiner's pieces and ``sparse_refiner_forward`` (JAX
parameters carried across by ``models.convert.refiner_from_jax``), the
refiner checkpoint in the reference layout, ``LRDataset``'s geometry and
caches, ``cli.lt_eval_main`` and ``RefinePredictor``, each on the same numpy
inputs and weights as its JAX counterpart.  Small width: DINO 64 hidden, 3
layers, 4 heads of 16 at 56px (the JAX package sends them to its XLA
attention); the refiner at dim 64 with 4 heads, window size 3, window
length 8.  float32 throughout.

Tolerances: the pools 1e-6 (two f32 products of bin matrices, or one f32
window sum, in other orders); the refiner's functions 1e-5 (f32 products
over 64-256 terms and a softmax); cached features 1e-5 (the forward
tolerance of tests/test_dino_parity.py:179); metrics 1e-5 and masks equal
(the JAX package prints them to 4 decimals; a float32 logit within
rounding of the 0.5 threshold would show here, and does not at these
seeds); the geometry and the checkpoint files exactly.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from ucod_dpl_tpu import cli as JCLI
from ucod_dpl_tpu.config import CfgNode as JCfg
from ucod_dpl_tpu.data import dataset as JDS
from ucod_dpl_tpu.engine.coral_loop import concate_m_patch_preds as j_concate
from ucod_dpl_tpu.engine.runner import LocalRefineRunner as JRunner
from ucod_dpl_tpu.models import udlr as JU
from ucod_dpl_tpu.ops import resize as JR
from ucod_dpl_tpu.serving import RefinePredictor as JPredictor
from ucod_dpl_tpu_torch import cli as TCLI
from ucod_dpl_tpu_torch.config import CfgNode as TCfg
from ucod_dpl_tpu_torch.data import dataset as TDS
from ucod_dpl_tpu_torch.data.feature_extractor import FeatureExtractor as TFE
from ucod_dpl_tpu_torch.data.transforms import load_image_batch_transform
from ucod_dpl_tpu_torch.engine.coral_loop import concate_m_patch_preds as t_concate
from ucod_dpl_tpu_torch.engine.runner import LocalRefineRunner as TRunner
from ucod_dpl_tpu_torch.models import convert as C
from ucod_dpl_tpu_torch.models import udlr as TU
from ucod_dpl_tpu_torch.models.dba import init_rev_decoder, rev_decoder_forward_resized
from ucod_dpl_tpu_torch.models.dino import DinoConfig, init_dino, save_hf_checkpoint
from ucod_dpl_tpu_torch.models.safetensors_io import save_decoder_checkpoint
from ucod_dpl_tpu_torch.ops import resize as TR
from ucod_dpl_tpu_torch.serving import RefinePredictor as TPredictor

DIM = 64
HEADS = 4
ARCH = {"hidden_size": DIM, "num_layers": 3, "num_heads": 4, "patch_size": 14, "image_size": 56}
KEYS = ("ACC", "mIOU", "E_MAX", "E_MEAN", "F_MAX", "F_MEAN", "SMeasure", "MAE", "WFM")
TOL = dict(rtol=1e-5, atol=1e-5)


# -- the pools ---------------------------------------------------------------------

@pytest.mark.parametrize("shape,out", [((2, 1, 24, 24), (3, 3)), ((1, 3, 17, 10), (3, 4)), ((2, 5, 7), (7, 2)),
                                       ((1, 1, 102, 102), (3, 3))])
def test_adaptive_avg_pool2d_matches_jax(shape, out):
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    got = TR.adaptive_avg_pool2d(torch.from_numpy(x), out)
    want = JR.adaptive_avg_pool2d(jnp.asarray(x), out)
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape,kernel,stride,padding", [((2, 1, 24, 24), 19, 1, 9), ((1, 2, 30, 20), 3, 2, 1),
                                                         ((3, 11, 9), 5, 1, 0), ((1, 1, 8, 8), 19, 1, 9)])
def test_avg_pool2d_matches_jax(shape, kernel, stride, padding):
    x = np.random.default_rng(kernel).random(shape).astype(np.float32)
    got = TR.avg_pool2d(torch.from_numpy(x), kernel, stride, padding)
    want = JR.avg_pool2d(jnp.asarray(x), kernel, stride, padding)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


# -- the refiner -------------------------------------------------------------------

@pytest.fixture(scope="module")
def refiner():
    jp = JU.init_sparse_refiner(jax.random.PRNGKey(5), dim=DIM, num_heads=HEADS)
    jp = jax.tree_util.tree_map(np.asarray, jp)
    # non-trivial LayerNorms and biases, so a swapped scale/bias or a dropped
    # bias shows
    rng = np.random.default_rng(5)
    for ln in ("norm_q", "norm_kv", "norm_mlp"):
        jp["csf"]["attn"][ln] = {"scale": 1 + 0.1 * rng.standard_normal(DIM).astype(np.float32),
                                 "bias": 0.1 * rng.standard_normal(DIM).astype(np.float32)}
    jp["csf"]["attn"]["in_proj_b"] = 0.1 * rng.standard_normal(3 * DIM).astype(np.float32)
    jp["csf"]["dw_conv"]["b"] = 0.1 * rng.standard_normal(DIM).astype(np.float32)
    return jp, C.refiner_from_jax(jp)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_refiner_converters_round_trip_exactly(refiner):
    jp, tp = refiner
    back = C.refiner_to_jax(tp, num_heads=HEADS)
    flat_j, tree_j = jax.tree_util.tree_flatten(jp)
    flat_b, tree_b = jax.tree_util.tree_flatten(back)
    assert tree_j == tree_b
    for a, b in zip(flat_j, flat_b):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert tuple(tp["csf"]["dw_conv"]["w"].shape) == (DIM, 1, 7, 7)
    assert tuple(tp["csf"]["attn"]["fc1"]["w"].shape) == (4 * DIM, DIM)


def test_refiner_pieces_match_jax(refiner):
    jp, tp = refiner
    rng = np.random.default_rng(6)
    q = rng.standard_normal((3, 20, DIM)).astype(np.float32)
    kv = rng.standard_normal((3, 12, DIM)).astype(np.float32)
    got = TU.cross_attention_block(tp["csf"]["attn"], torch.from_numpy(q), torch.from_numpy(kv), HEADS)
    want = JU.cross_attention_block(jp["csf"]["attn"], jnp.asarray(q), jnp.asarray(kv), HEADS)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)

    l_in = rng.standard_normal((4, 8, 8, DIM)).astype(np.float32)
    h_in = rng.standard_normal((4, 8, 8, DIM)).astype(np.float32)
    got = TU.csf_forward(tp["csf"], torch.from_numpy(l_in), torch.from_numpy(h_in), HEADS)
    want = JU.csf_forward(jp["csf"], jnp.asarray(l_in), jnp.asarray(h_in), HEADS)
    assert tuple(got.shape) == (4, 8, 8, 1)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)

    for preds in (rng.standard_normal((2, 8, 8, 1)).astype(np.float32) * 4,  # logits
                  rng.random((2, 8, 8, 1)).astype(np.float32)):  # probabilities
        m_t, e_t = TU.entropy_select(torch.from_numpy(preds), 3, 0.0015)
        m_j, e_j = JU.entropy_select(jnp.asarray(preds), 3, 0.0015)
        np.testing.assert_array_equal(_np(m_t), _np(m_j))
        np.testing.assert_allclose(_np(e_t), _np(e_j), **TOL)
    m_t, _ = TU.entropy_select(torch.from_numpy(preds), 3, 0.3)
    m_j, _ = JU.entropy_select(jnp.asarray(preds), 3, 0.3)
    np.testing.assert_array_equal(_np(m_t), _np(m_j))

    l1 = rng.standard_normal((2, 8, 8, 1)).astype(np.float32) * 3
    l2 = rng.standard_normal((2, 24, 24, 1)).astype(np.float32) * 3
    for g, w in zip(TU.gated_ensemble(tp["ge"], torch.from_numpy(l1), torch.from_numpy(l2)),
                    JU.gated_ensemble(jp["ge"], jnp.asarray(l1), jnp.asarray(l2))):
        np.testing.assert_allclose(_np(g), _np(w), **TOL)


@pytest.mark.parametrize("threshold", [0.0015, 0.2, 10.0])
def test_sparse_refiner_forward_matches_jax(refiner, threshold):
    """Every window selected, some, and none."""
    jp, tp = refiner
    rng = np.random.default_rng(7)
    l_f = rng.standard_normal((2, 8, 8, DIM)).astype(np.float32)
    h_f = rng.standard_normal((2, 9, 8, 8, DIM)).astype(np.float32)
    preds = (rng.standard_normal((2, 8, 8, 1)) * np.linspace(0.1, 6, 8)[None, :, None, None]).astype(np.float32)
    got = TU.sparse_refiner_forward(tp, *(torch.from_numpy(x) for x in (l_f, h_f, preds)), 3, threshold,
                                    num_heads=HEADS)
    want = JU.sparse_refiner_forward(jp, *(jnp.asarray(x) for x in (l_f, h_f, preds)), 3, threshold,
                                     num_heads=HEADS)
    assert got._fields == want._fields
    for name, g, w in zip(got._fields, got, want):
        assert tuple(g.shape) == w.shape, name
        if name == "mask":
            np.testing.assert_array_equal(_np(g), _np(w))
        else:
            np.testing.assert_allclose(_np(g), _np(w), err_msg=name, **TOL)
    selected = _np(got.mask).mean()
    assert selected == {0.0015: 1.0, 10.0: 0.0}.get(threshold, selected)
    assert threshold != 0.2 or 0 < selected < 1


def test_refiner_losses_and_training_entries_wait_for_item_15(tmp_path):
    for name in ("binary_iou_batch", "refiner_distillation_loss", "refiner_ensemble_loss", "refiner_train_loss"):
        with pytest.raises(NotImplementedError, match="item 15"):
            getattr(TU, name)()
    with pytest.raises(NotImplementedError, match="item 15"):
        TCLI.main(["lt_train", "-c", "x"])
    for method, args in (("launch_train", ()), ("save_refiner", (1,))):
        with pytest.raises(NotImplementedError, match="item 15"):
            getattr(TRunner, method)(object.__new__(TRunner), *args)


def test_concate_m_patch_preds_matches_jax():
    p = np.random.default_rng(8).standard_normal((2, 4, 68, 68, 1)).astype(np.float32)
    np.testing.assert_allclose(t_concate(torch.from_numpy(p)).numpy(), np.asarray(j_concate(jnp.asarray(p))),
                               rtol=1e-6, atol=1e-6)


def _by_path(tree, path=()):
    """A params tree as {key path: numpy array}."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _by_path(sub, path + (key,)).items()}
    return {path: tree.numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)}


def test_refiner_checkpoints_cross_packages(refiner, tmp_path):
    """Either package reads the other's file, and both write the same
    tensors under the same names; a file that is not a refiner raises."""
    from safetensors.numpy import load_file

    jp, tp = refiner
    JU.save_refiner_checkpoint(str(tmp_path / "j.safetensors"), jp)
    TU.save_refiner_checkpoint(str(tmp_path / "t.safetensors"), tp)
    flat_j, flat_t = load_file(str(tmp_path / "j.safetensors")), load_file(str(tmp_path / "t.safetensors"))
    assert sorted(flat_j) == sorted(flat_t)
    for k in flat_j:
        assert flat_j[k].dtype == flat_t[k].dtype and flat_j[k].shape == flat_t[k].shape, k
        np.testing.assert_array_equal(flat_j[k], flat_t[k])
    back_t = _by_path(TU.load_refiner_checkpoint(str(tmp_path / "j.safetensors")))
    assert back_t.keys() == _by_path(tp).keys()
    for k, v in _by_path(tp).items():
        np.testing.assert_array_equal(back_t[k].reshape(v.shape), v)
    back_j = _by_path(JU.load_refiner_checkpoint(str(tmp_path / "t.safetensors"), num_heads=HEADS))
    assert back_j.keys() == _by_path(jp).keys()
    for k, v in _by_path(jp).items():
        np.testing.assert_array_equal(back_j[k].reshape(np.shape(v)), v)
    save_decoder_checkpoint(str(tmp_path / "dec.safetensors"), init_rev_decoder(0, DIM), init_rev_decoder(1, DIM))
    with pytest.raises(ValueError, match="SparseRefiner"):
        TU.load_refiner_checkpoint(str(tmp_path / "dec.safetensors"))


def test_init_sparse_refiner_shapes_and_seed():
    a, b, c = TU.init_sparse_refiner(0, DIM), TU.init_sparse_refiner(0, DIM), TU.init_sparse_refiner(1, DIM)
    shapes = jax.tree_util.tree_map(lambda x: x.shape, C.refiner_to_jax(a))
    want = jax.tree_util.tree_map(lambda x: np.shape(x), JU.init_sparse_refiner(jax.random.PRNGKey(0), dim=DIM))
    assert shapes == want
    la, lb, lc = (torch.cat([t.flatten() for t in C.tree_leaves(p)]) for p in (a, b, c))
    assert torch.equal(la, lb) and not torch.equal(la, lc)


# -- LRDataset -------------------------------------------------------------------------

def test_grid_patches_and_m_windows_match_jax_and_the_goldens():
    """tests/test_lr_dataset_geometry.py's goldens (row-major grid cells of
    the resized image; 36px m-windows at stride 18) on the port, and the
    JAX package's arrays."""
    from ucod_dpl_tpu_torch.data.transforms import image_transform

    img = Image.fromarray(np.random.default_rng(0).integers(0, 256, (80, 100, 3), dtype=np.uint8))
    got = TDS.grid_patch_arrays(img, (56, 56), 3)
    assert got.shape == (9, 56, 56, 3)
    np.testing.assert_array_equal(got, JDS.grid_patch_arrays(img, (56, 56), 3))
    big = img.resize((168, 168), Image.BILINEAR)
    for k, box in enumerate([(j * 56, i * 56, (j + 1) * 56, (i + 1) * 56) for i in range(3) for j in range(3)]):
        np.testing.assert_array_equal(got[k], image_transform(big.crop(box), None))
    np.testing.assert_array_equal(TDS.grid_patch_arrays(img, (28, 42), 2), JDS.grid_patch_arrays(img, (28, 42), 2))

    assert (TDS.M_PATCH_SLICE, TDS.M_PATCH_STRIDE) == (36, 18) == (JDS.M_PATCH_SLICE, JDS.M_PATCH_STRIDE)
    key = np.arange(54 * 54 * 2, dtype=np.float32).reshape(54, 54, 2)
    w = TDS.slice_m_windows(key)
    assert w.shape == (4, 36, 36, 2) and w.dtype == np.float32
    np.testing.assert_array_equal(w, JDS.slice_m_windows(key))
    assert w[0, 0, 0, 0] == key[0, 0, 0] and w[1, 0, 0, 0] == key[0, 18, 0]
    assert w[2, 0, 0, 0] == key[18, 0, 0] and w[3, -1, -1, 0] == key[53, 53, 0]
    assert TDS.fe_image_size("dinov2") == JDS.fe_image_size("dinov2") == (756, 756)
    assert TDS.fe_image_size("dinov1") == JDS.fe_image_size("dinov1") == (432, 432)


def _write_images(root, name, n, seed, labels=True):
    rng = np.random.default_rng(seed)
    (root / name / "im").mkdir(parents=True)
    if labels:
        (root / name / "gt").mkdir(parents=True)
    for i in range(n):
        h, w = ((80, 100), (90, 70), (64, 64))[i % 3]
        img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        img[h // 4 : h // 2, w // 3 : 2 * w // 3] //= 3  # a darker blob
        Image.fromarray(img).save(root / name / "im" / f"img{i}.jpg")
        if labels:
            mask = np.zeros((h, w), np.uint8)
            mask[h // 4 : h // 2, w // 3 : 2 * w // 3] = 255
            Image.fromarray(mask).save(root / name / "gt" / f"img{i}.png")


def _cfg_dict(root, tag, weights, m_patches=False, val_batch=2):
    return {
        "work_dir": str(root / f"work_{tag}"),
        "mode": "eval",
        "seed": 42,
        "model_cfg": {"dim": DIM, "feature_size": 8, "dis_use_features": False, "ema_weight": 0.99,
                      "window_size": 3, "window_length": 8, "threshold": 0.0015},
        "val_cfg": {"look_twice": False, "enable_val": True, "metric_workers": 0},
        "log_cfg": {"log_path": str(root / f"logs_{tag}"), "multi_rank": [0]},
        "tpu_cfg": {"mesh": {"data": -1, "model": 1}, "compute_dtype": "float32"},
        "dataset_cfg": {
            "dataset_dir": str(root / "RefCOD"),
            "cache_dir": str(root / f"cache_{tag}"),
            "valset_cfg": {"DATASET": "TINY", "require_label": True, "image_size": (56, 56), "keep_size": True,
                           "require_m_patches": m_patches},
            "trainset_cfg": {"DATASET": "TINY", "require_label": True, "image_size": (56, 56)},
            "val_loader_cfg": {"batch_size": val_batch},
            "trainloader_cfg": {"batch_size": 2, "shuffle": True},
            "feature_extractor_cfg": {"type": "dinov2", "backbone": "facebook/dinov2-base",
                                      "backbone_weights": str(weights), "arch": dict(ARCH)},
        },
    }


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """5 images with labels, one backbone, a decoder whose coarse
    predictions mark about a third of the pixels (its fg bias at the 67th
    percentile of its logits on these images) and one that marks none (every
    sample takes the centre-crop fallback), and a refiner checkpoint."""
    root = tmp_path_factory.mktemp("coral")
    _write_images(root / "RefCOD", "TINY", 5, 0)
    dcfg = dataclasses.replace(DinoConfig.from_type("dinov2"), **ARCH)
    (root / "hf").mkdir()
    save_hf_checkpoint(str(root / "hf" / "model.safetensors"), init_dino(0, dcfg), dcfg)
    fe = TFE(TCfg(_cfg_dict(root, "x", root / "hf")["dataset_cfg"]["feature_extractor_cfg"]), device="cpu")
    paths = sorted((root / "RefCOD" / "TINY" / "im").iterdir())
    feats = torch.from_numpy(fe.extract(load_image_batch_transform(paths, (56, 56))))
    dec = init_rev_decoder(1, DIM)
    fg = rev_decoder_forward_resized(dec, feats, 8)[0]
    mixed = dec._replace(conv_out_fg_b=dec.conv_out_fg_b - torch.quantile(fg.flatten(), 0.67))
    empty = dec._replace(conv_out_fg_b=dec.conv_out_fg_b - 1e3)
    ckpts = {}
    for name, d in (("mixed", mixed), ("empty", empty)):
        ckpts[name] = str(root / f"decoder_{name}.safetensors")
        save_decoder_checkpoint(ckpts[name], d, init_rev_decoder(2, DIM))
    jp = jax.tree_util.tree_map(np.asarray, JU.init_sparse_refiner(jax.random.PRNGKey(9), dim=DIM))
    refiner = str(root / "refiner.safetensors")
    JU.save_refiner_checkpoint(refiner, jp)
    return dict(root=root, weights=root / "hf", ckpts=ckpts, refiner=refiner, fe=fe)


@pytest.mark.parametrize("m_patches", [False, True])
def test_lr_dataset_caches_read_by_either_package(world, m_patches):
    """Each package builds its own grid- and m-patch caches (the port in
    one chunk of 2 images: cache_build_batch 18 over 9 crops an image); the
    entries agree, and each package's dataset reads the other's caches."""
    root, weights = world["root"], world["weights"]
    tag = f"ds{int(m_patches)}"
    fe_cfg = _cfg_dict(root, tag, weights)["dataset_cfg"]["feature_extractor_cfg"]
    kw = dict(dataset_dir=str(root / "RefCOD"), mode="test", image_size=(56, 56), require_label=True,
              keep_size=True, window_size=3, require_m_patches=m_patches, cache_build_batch=18)
    set_cfg = {"DATASET": "TINY"}
    tds = TDS.LRDataset(TCfg(set_cfg), TCfg(fe_cfg), cache_dir=str(root / f"cache_{tag}_t"),
                        feature_extractor=world["fe"], **kw)
    jfe = JDS.FeatureExtractor(JCfg(fe_cfg))
    jds = JDS.LRDataset(JCfg(set_cfg), JCfg(fe_cfg), cache_dir=str(root / f"cache_{tag}_j"), feature_extractor=jfe,
                        **kw)
    assert tds.patch_build_seconds is not None
    cross_t = TDS.LRDataset(TCfg(set_cfg), TCfg(fe_cfg), cache_dir=str(root / f"cache_{tag}_j"),
                            feature_extractor=world["fe"], **kw)
    cross_j = JDS.LRDataset(JCfg(set_cfg), JCfg(fe_cfg), cache_dir=str(root / f"cache_{tag}_t"),
                            feature_extractor=jfe, **kw)
    assert cross_t.patch_build_seconds is None  # read, not built
    for i in range(5):
        a, b, ct, cj = tds[i], jds[i], cross_t[i], cross_j[i]
        assert a["h_inputs"].shape == (9, 4, 4, DIM)
        for key in ("features", "h_inputs", "m_inputs"):
            if not m_patches and key == "m_inputs":
                assert a[key] is None and b[key] is None
                continue
            np.testing.assert_allclose(a[key], b[key], **TOL)
            np.testing.assert_array_equal(ct[key], b[key])
            np.testing.assert_array_equal(cj[key], a[key])
        if m_patches:
            assert a["m_inputs"].shape == (4, 36, 36, DIM)
    got = tds.get_features(str(tds.image_paths[1]), crop_center=True)
    want = jds.get_features(str(jds.image_paths[1]), crop_center=True)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            np.testing.assert_allclose(g, w, **TOL)


def _masks(log_path):
    d = os.path.join(log_path, "preds", "TINY")
    return {f: np.asarray(Image.open(os.path.join(d, f))) for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("decoder,m_patches,val_batch", [("mixed", False, 2), ("mixed", True, 2),
                                                         ("empty", False, 3)])
def test_cli_lt_eval_matches_jax(world, tmp_path, capsys, decoder, m_patches, val_batch):
    """``cli.lt_eval_main`` on both packages, same config file, decoder and
    refiner checkpoints: the printed lines, the metrics (the port's runner
    against a JAX ``LocalRefineRunner`` on the same cache) and the PNG
    masks.  The "empty" decoder sends every sample to the centre-crop
    fallback; batches of 2 and 3 over 5 images pad a tail batch."""
    root = world["root"]
    lines, runs = {}, {}
    for name, main, extra in (("jax", JCLI.lt_eval_main, []), ("port", TCLI.lt_eval_main, ["--device", "cpu"])):
        cfg = _cfg_dict(tmp_path, name, world["weights"], m_patches=m_patches, val_batch=val_batch)
        cfg["dataset_cfg"]["dataset_dir"] = str(root / "RefCOD")
        (tmp_path / f"coral_{name}.py").write_text(f"cfg = {cfg!r}\n")
        runs[name] = main(["-c", str(tmp_path / f"coral_{name}.py"), "--work_dir", str(tmp_path / f"wd_{name}"),
                           "--load_from", world["ckpts"][decoder], "--refiner_path", world["refiner"],
                           "--datasets", "TINY", *extra, "--opts", "log_cfg.log_path", str(tmp_path / f"cli_{name}")])
        out = capsys.readouterr().out.splitlines()
        lines[name] = [line for line in out if line.startswith(("running", "TINY"))]
    assert len(lines["port"]) == 2 and lines["port"] == lines["jax"], lines
    runner = runs["port"]["TINY"]
    assert isinstance(runner, TRunner)
    assert runner.evaluator.crops == (5 if decoder == "empty" else 0)
    jcfg = JCfg(_cfg_dict(tmp_path, "jax", world["weights"], m_patches=m_patches, val_batch=val_batch))
    jcfg.dataset_cfg.dataset_dir = str(root / "RefCOD")
    jres = JRunner(jcfg, mode="eval", load_from=world["ckpts"][decoder], refiner_path=world["refiner"]).launch_val()
    assert set(runner.evaluator.result) == set(KEYS)
    for k in KEYS:
        assert abs(runner.evaluator.result[k] - jres[k]) <= 1e-5, (k, runner.evaluator.result[k], jres[k])
    assert runner.log_path == str(tmp_path / "cli_port")
    got, want = _masks(runner.log_path), _masks(str(tmp_path / "cli_jax"))
    assert sorted(got) == sorted(want) and len(got) == 5
    for f in got:
        np.testing.assert_array_equal(got[f], want[f])


@pytest.mark.parametrize("use_m_patches", [False, True])
def test_refine_predictor_matches_jax(world, use_m_patches):
    """``RefinePredictor.predict`` on both packages from the same files
    (``from_config`` on the port): 3 images in chunks of 2 (a padded tail),
    masks equal, soft masks to 1e-5, one uint8 array input; the empty
    decoder takes the centre-crop fallback."""
    root = world["root"]
    cfg = _cfg_dict(root, "serve", world["weights"], m_patches=use_m_patches)
    (root / f"serve_{int(use_m_patches)}.py").write_text(f"cfg = {cfg!r}\n")
    paths = [str(p) for p in sorted((root / "RefCOD" / "TINY" / "im").iterdir())[:3]]
    arr = np.asarray(Image.open(paths[0]).convert("RGB"))
    for decoder in ("mixed", "empty"):
        tp = TPredictor.from_config(str(root / f"serve_{int(use_m_patches)}.py"), world["ckpts"][decoder],
                                    world["refiner"], device="cpu", max_batch=2)
        assert tp.use_m_patches == use_m_patches and tp.window_length == 8
        jfe = JDS.FeatureExtractor(JCfg(cfg["dataset_cfg"]["feature_extractor_cfg"]))
        from ucod_dpl_tpu.models.safetensors_io import load_decoder_checkpoint as j_load_decoder

        jp = JPredictor(jfe, j_load_decoder(world["ckpts"][decoder])[0], JU.load_refiner_checkpoint(world["refiner"]),
                        image_size=(56, 56), window_size=3, window_length=8, threshold=0.0015,
                        use_m_patches=use_m_patches, max_batch=2)
        for g, w in zip(tp.predict(paths + [arr]), jp.predict(paths + [arr])):
            assert g.shape == (56, 56) and g.dtype == np.float32
            np.testing.assert_array_equal(g, w)
        for g, w in zip(tp.predict(paths, soft=True, output_size=(60, 72)),
                        jp.predict(paths, soft=True, output_size=(60, 72))):
            np.testing.assert_allclose(g, w, **TOL)
    with pytest.raises(ValueError, match="original pixels"):
        tp.predict([np.zeros((56, 56, 3), np.float32)])
