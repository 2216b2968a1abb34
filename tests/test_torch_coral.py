"""The port's CORAL stage 2 (evaluation, serving and training) on the CPU
against the JAX package.

The pools, the UDLR refiner's pieces and ``sparse_refiner_forward`` (JAX
parameters carried across by ``models.convert.refiner_from_jax``), the
refiner checkpoint in the reference layout, the training losses and their
gradients, ``LRDataset``'s geometry and caches, ``cli.lt_eval_main``,
``RefinePredictor``, ``LocalRefineTrainLoop`` and ``cli.lt_train_main``,
each on the same numpy inputs and weights as its JAX counterpart.  Small
width: DINO 64 hidden, 3 layers, 4 heads of 16 at 56px (the JAX package
sends them to its XLA attention); the refiner at dim 64 with 4 heads (8 in
the loops, as both packages' trainers run it), window size 3, window length
8.  The entries also run on DINOv1's twin (ViT-B/8's patch 8, eps 1e-12, no
layerscale and 28 x 28 position grid, 128 wide in two heads of 64, its
m-patches at 432px), as CORAL_dinov1.py runs them with m-patches in val.
float32 throughout.

Tolerances: the pools 1e-6 (two f32 products of bin matrices, or one f32
window sum, in other orders); the refiner's functions 1e-5 (f32 products
over 64-256 terms and a softmax); cached features 1e-5 (the forward
tolerance of tests/test_dino_parity.py:179); metrics 1e-5 and masks equal
(the JAX package prints them to 4 decimals; a float32 logit within
rounding of the 0.5 threshold would show here, and does not at these
seeds); the geometry and the checkpoint files exactly.  Training: the
losses' values 1e-5 and the refiner's gradients rtol 2e-4 / atol 2e-5
(tests/test_attention_vjp.py's f32 gradient tolerance); after a few AdamW
steps the losses rtol 5e-5 / atol 2e-5 and the refiner and its EMA rtol
1e-4 / atol 5e-6 (tests/test_torch_train_loop.py's), at the shipped lr0
1e-4.
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
# the entries' backbone and refiner width by family
DIMS = {"dinov2": DIM, "dinov1": 128}
ARCHS = {"dinov2": ARCH, "dinov1": {"hidden_size": 128, "num_layers": 3, "num_heads": 2}}
BACKBONES = {"dinov2": "facebook/dinov2-base", "dinov1": "facebook/dino-vitb8"}
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


def _loss_inputs(seed):
    """Features, a coarse prediction (logits over a few decades) and binary
    window targets (18 windows of 8 x 8) as numpy arrays."""
    rng = np.random.default_rng(seed)
    l_f = rng.standard_normal((2, 8, 8, DIM)).astype(np.float32)
    h_f = rng.standard_normal((2, 9, 8, 8, DIM)).astype(np.float32)
    preds = (rng.standard_normal((2, 8, 8, 1)) * np.linspace(0.1, 6, 8)[None, :, None, None]).astype(np.float32)
    h_targets = (rng.random((18, 8, 8, 1)) < 0.4).astype(np.float32)
    return l_f, h_f, preds, h_targets


def test_binary_iou_batch_matches_jax():
    """Probabilities, logits (the batch-global max over 1 sends the whole
    batch through the sigmoid) and binary predictions against binary
    targets; an empty union gives 0."""
    rng = np.random.default_rng(10)
    t = (rng.random((5, 6, 7, 1)) < 0.5).astype(np.float32)
    for p in (rng.random((5, 6, 7, 1)).astype(np.float32), rng.standard_normal((5, 6, 7, 1)).astype(np.float32) * 3,
              (rng.random((5, 6, 7, 1)) < 0.3).astype(np.float32)):
        got = TU.binary_iou_batch(torch.from_numpy(p), torch.from_numpy(t))
        want = JU.binary_iou_batch(jnp.asarray(p), jnp.asarray(t))
        assert tuple(got.shape) == (5,) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    zeros = torch.zeros(2, 3, 3, 1)
    assert TU.binary_iou_batch(zeros, zeros).tolist() == [0.0, 0.0]


@pytest.mark.parametrize("threshold", [0.0015, 0.2, 10.0])
def test_refiner_losses_and_gradients_match_jax(refiner, threshold):
    """The three losses' values (1e-5) and the refiner's gradients of each
    (rtol 2e-4 / atol 2e-5) on the same inputs, with every window selected,
    some, and none (the distillation's ``max(num_sel, 1)``; with none
    selected it gives no gradient at all).  ``GE.alpha``, which the forward
    never reads, gets none in the port (zero in JAX)."""
    jp, tp = refiner
    l_f, h_f, preds, h_t = _loss_inputs(11)
    jtrain = {k: v for k, v in jp.items() if k != "num_heads"}
    for name in ("refiner_distillation_loss", "refiner_ensemble_loss", "refiner_train_loss"):
        def jloss(params):
            out = JU.sparse_refiner_forward(params, jnp.asarray(l_f), jnp.asarray(h_f), jnp.asarray(preds), 3,
                                            threshold, num_heads=HEADS)
            return getattr(JU, name)(out, jnp.asarray(preds), jnp.asarray(h_t), 3)

        want, jgrads = jax.value_and_grad(jloss)(jtrain)
        params = C.tree_map(lambda t: t.clone().requires_grad_(True), tp)
        out = TU.sparse_refiner_forward(params, *(torch.from_numpy(x) for x in (l_f, h_f, preds)), 3, threshold,
                                        num_heads=HEADS)
        got = getattr(TU, name)(out, torch.from_numpy(preds), torch.from_numpy(h_t), 3)
        got.backward()
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-5, err_msg=name)
        assert params["ge"]["alpha"].grad is None
        grads = C.refiner_to_jax(C.tree_map(lambda t: torch.zeros_like(t) if t.grad is None else t.grad, params))
        flat_j = _by_path(jgrads)
        for path, g in _by_path({k: v for k, v in grads.items() if k != "num_heads"}).items():
            np.testing.assert_allclose(g, flat_j[path].reshape(g.shape), rtol=2e-4, atol=2e-5,
                                       err_msg=f"{name} {path}")
        # the distillation reaches the CSF through the selected windows only:
        # none selected, no gradient at all
        moved = any(np.abs(g).max() > 0 for g in _by_path(jgrads).values())
        assert moved != (name == "refiner_distillation_loss" and threshold == 10.0)


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


def _cfg_dict(root, tag, weights, m_patches=False, val_batch=2, variant="dinov2"):
    return {
        "work_dir": str(root / f"work_{tag}"),
        "mode": "eval",
        "seed": 42,
        "model_cfg": {"dim": DIMS[variant], "feature_size": 8, "dis_use_features": False, "ema_weight": 0.99,
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
            "feature_extractor_cfg": {"type": variant, "backbone": BACKBONES[variant],
                                      "backbone_weights": str(weights), "arch": dict(ARCHS[variant])},
        },
    }


# the entries' cases on DINOv1 (``world`` parametrised indirectly): those
# with m-patches, the path CORAL_dinov1.py takes in val and train
def _with_dinov1(names, cases, dinov1_cases):
    """``pytest.mark.parametrize`` over ``world`` + ``names``: each of
    ``cases`` on dinov2 under its own id, then each of ``dinov1_cases``."""
    def case_id(case):
        return "-".join(str(v) for v in case)

    params = [pytest.param("dinov2", *c, id=case_id(c)) for c in cases]
    params += [pytest.param("dinov1", *c, id=f"dinov1-{case_id(c)}") for c in dinov1_cases]
    return pytest.mark.parametrize(",".join(["world", *names]), params, indirect=["world"])


@pytest.fixture(scope="module")
def world(tmp_path_factory, request):
    """5 images with labels, one backbone, a decoder whose coarse
    predictions mark about a third of the pixels (its fg bias at the 67th
    percentile of its logits on these images) and one that marks none (every
    sample takes the centre-crop fallback), and a refiner checkpoint."""
    variant = getattr(request, "param", "dinov2")
    dim = DIMS[variant]
    root = tmp_path_factory.mktemp(f"coral_{variant}")
    _write_images(root / "RefCOD", "TINY", 5, 0)
    dcfg = dataclasses.replace(DinoConfig.from_type(variant), **ARCHS[variant])
    (root / "hf").mkdir()
    save_hf_checkpoint(str(root / "hf" / "model.safetensors"), init_dino(0, dcfg), dcfg)
    fe = TFE(TCfg(_cfg_dict(root, "x", root / "hf", variant=variant)["dataset_cfg"]["feature_extractor_cfg"]),
             device="cpu")
    paths = sorted((root / "RefCOD" / "TINY" / "im").iterdir())
    feats = torch.from_numpy(fe.extract(load_image_batch_transform(paths, (56, 56))))
    dec = init_rev_decoder(1, dim)
    fg = rev_decoder_forward_resized(dec, feats, 8)[0]
    mixed = dec._replace(conv_out_fg_b=dec.conv_out_fg_b - torch.quantile(fg.flatten(), 0.67))
    empty = dec._replace(conv_out_fg_b=dec.conv_out_fg_b - 1e3)
    ckpts = {}
    for name, d in (("mixed", mixed), ("empty", empty)):
        ckpts[name] = str(root / f"decoder_{name}.safetensors")
        save_decoder_checkpoint(ckpts[name], d, init_rev_decoder(2, dim))
    jp = jax.tree_util.tree_map(np.asarray, JU.init_sparse_refiner(jax.random.PRNGKey(9), dim=dim))
    refiner = str(root / "refiner.safetensors")
    JU.save_refiner_checkpoint(refiner, jp)
    return dict(root=root, weights=root / "hf", ckpts=ckpts, refiner=refiner, fe=fe, variant=variant, dim=dim,
                grid=56 // dcfg.patch_size)


@_with_dinov1(["m_patches"], [(False,), (True,)], [(True,)])
def test_lr_dataset_caches_read_by_either_package(world, m_patches):
    """Each package builds its own grid- and m-patch caches (the port in
    one chunk of 2 images: cache_build_batch 18 over 9 crops an image); the
    entries agree, and each package's dataset reads the other's caches."""
    root, weights, dim, g = world["root"], world["weights"], world["dim"], world["grid"]
    tag = f"ds{int(m_patches)}"
    fe_cfg = _cfg_dict(root, tag, weights, variant=world["variant"])["dataset_cfg"]["feature_extractor_cfg"]
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
        assert a["h_inputs"].shape == (9, g, g, dim)
        for key in ("features", "h_inputs", "m_inputs"):
            if not m_patches and key == "m_inputs":
                assert a[key] is None and b[key] is None
                continue
            np.testing.assert_allclose(a[key], b[key], **TOL)
            np.testing.assert_array_equal(ct[key], b[key])
            np.testing.assert_array_equal(cj[key], a[key])
        if m_patches:
            assert a["m_inputs"].shape == (4, 36, 36, dim)
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


@_with_dinov1(["decoder", "m_patches", "val_batch"], [("mixed", False, 2), ("mixed", True, 2), ("empty", False, 3)],
              [("mixed", True, 2)])
def test_cli_lt_eval_matches_jax(world, tmp_path, capsys, decoder, m_patches, val_batch):
    """``cli.lt_eval_main`` on both packages, same config file, decoder and
    refiner checkpoints: the printed lines, the metrics (the port's runner
    against a JAX ``LocalRefineRunner`` on the same cache) and the PNG
    masks.  The "empty" decoder sends every sample to the centre-crop
    fallback; batches of 2 and 3 over 5 images pad a tail batch."""
    root = world["root"]
    lines, runs = {}, {}
    for name, main, extra in (("jax", JCLI.lt_eval_main, []), ("port", TCLI.lt_eval_main, ["--device", "cpu"])):
        cfg = _cfg_dict(tmp_path, name, world["weights"], m_patches=m_patches, val_batch=val_batch,
                        variant=world["variant"])
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
    jcfg = JCfg(_cfg_dict(tmp_path, "jax", world["weights"], m_patches=m_patches, val_batch=val_batch,
                          variant=world["variant"]))
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


@_with_dinov1(["use_m_patches"], [(False,), (True,)], [(True,)])
def test_refine_predictor_matches_jax(world, use_m_patches):
    """``RefinePredictor.predict`` on both packages from the same files
    (``from_config`` on the port): 3 images in chunks of 2 (a padded tail),
    masks equal, soft masks to 1e-5, one uint8 array input; the empty
    decoder takes the centre-crop fallback."""
    root = world["root"]
    cfg = _cfg_dict(root, "serve", world["weights"], m_patches=use_m_patches, variant=world["variant"])
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


# -- stage-2 training --------------------------------------------------------------

# losses, and the refiner and its EMA after training: a few AdamW steps turn
# float32 noise in near-zero gradients into parameter differences (the
# stage-1 precedent, tests/test_torch_train_loop.py)
LOSS_TOL = dict(rtol=5e-5, atol=2e-5)
PARAM_TOL = dict(rtol=1e-4, atol=5e-6)


def _assert_refiners_close(got, want, what):
    """Two refiners (port layout, or JAX layout with ``num_heads``) at PARAM_TOL."""
    def flat(p):
        return _by_path(C.refiner_to_jax(p) if isinstance(p["ge"]["alpha"], torch.Tensor) else p)

    g, w = flat(got), flat(want)
    assert g.keys() - {("num_heads",)} == w.keys() - {("num_heads",)}
    for path in g:
        if path != ("num_heads",):
            np.testing.assert_allclose(g[path], w[path].reshape(g[path].shape), err_msg=f"{what} {path}", **PARAM_TOL)


class _Log:
    def __init__(self):
        self.lines = []

    def log(self, msg):
        self.lines.append(msg)


class _Loader:
    """One batch an epoch, the epoch's own (``set_epoch`` picks it)."""

    def __init__(self, batches):
        self.batches, self.epoch = batches, None

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        return iter([self.batches[self.epoch]])


def _refine_batches(world, m_patches):
    """Three batches of 2 of the world's images: cached-style l, grid-patch
    and (with ``m_patches``) m-patch features from the world's backbone."""
    from ucod_dpl_tpu_torch.data.transforms import image_transform

    fe = world["fe"]
    paths = sorted((world["root"] / "RefCOD" / "TINY" / "im").iterdir())[:4]
    imgs = [Image.open(p).convert("RGB") for p in paths]
    l_f = fe.extract(load_image_batch_transform(paths, (56, 56)))
    h_f = np.stack([fe.extract(TDS.grid_patch_arrays(img, (56, 56), 3)) for img in imgs])
    m_f = np.stack([TDS.slice_m_windows(fe.extract(image_transform(img, (756, 756))[None])[0]) for img in imgs])
    return [{"features": l_f[[i, j]], "h_inputs": h_f[[i, j]], "m_inputs": m_f[[i, j]] if m_patches else [None] * 2}
            for i, j in ((0, 1), (2, 3), (1, 2))]


@pytest.mark.parametrize("m_patches", [False, True])
def test_train_loop_steps_match_jax(world, tmp_path, monkeypatch, m_patches):
    """Three epochs of one step each through both packages' loops (fake
    runners, the same batches, decoder and starting refiner): the rate
    steps every epoch (step_lr_size 1, gamma 0.5), the EMA is a copy at
    epoch 0 and moves from epoch 1 (start_ema 1).  The window targets agree
    pixel for pixel first; then the losses, the refiner and its EMA, and the
    files each epoch writes.  With WORLD_SIZE 2 the port's loop refuses."""
    from ucod_dpl_tpu.engine import coral_loop as JCL
    from ucod_dpl_tpu.models.dba import rev_decoder_forward as j_decoder
    from ucod_dpl_tpu.models.safetensors_io import load_decoder_checkpoint as j_load_decoder
    from ucod_dpl_tpu.parallel import build_mesh as j_build_mesh
    from ucod_dpl_tpu_torch.engine import coral_loop as TCL
    from ucod_dpl_tpu_torch.models.safetensors_io import load_decoder_checkpoint as t_load_decoder

    batches = _refine_batches(world, m_patches)
    cfg = {"start_ema": 1, "train_cfg": {"max_epoch": 3, "lr0": 1e-4, "step_lr_gamma": 0.5, "step_lr_size": 1},
           "model_cfg": {"window_size": 3, "window_length": 8, "threshold": 0.0015, "ema_weight": 0.7},
           "val_cfg": {"val_interval": 100, "val_start": 100}}
    jp = JU.load_refiner_checkpoint(world["refiner"])
    runners = {}
    for name, runner_cls, dec in (("jax", JRunner, j_load_decoder(world["ckpts"]["mixed"])[0]),
                                  ("port", TRunner, t_load_decoder(world["ckpts"]["mixed"])[0])):
        ns = runners[name] = type("R", (), {})()
        ns.decoder_params, ns.logger, ns.log_path = dec, _Log(), str(tmp_path / name)
        ns.train_dataloader, ns.device, ns.mesh = _Loader(batches), torch.device("cpu"), j_build_mesh()
        ns.refiner_params = jp if name == "jax" else C.refiner_from_jax(jp)
        ns.save_refiner = runner_cls.save_refiner.__get__(ns)

    tloop = TCL.LocalRefineTrainLoop(TCfg(cfg), runners["port"])
    jloop = JCL.LocalRefineTrainLoop(JCfg(cfg), runners["jax"])
    for batch in batches:  # the targets are thresholded logits: hold them equal before the losses
        l_t, h_t, p_t = tloop.prepare(batch)
        l_j, h_j, p_j = jloop._prepare(batch)
        np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), **TOL)
        flat = h_j.reshape(18, 8, 8, DIM)
        want = np.asarray(jax.nn.sigmoid(j_decoder(runners["jax"].decoder_params, flat, with_loss=False)[0]) > 0.5)
        got = torch.sigmoid(TCL.decoder_fg(tloop.decoder, h_t.reshape(18, 8, 8, DIM))) > 0.5
        np.testing.assert_array_equal(got.numpy(), want)
        assert 0 < want.mean() < 1

    j_losses = []
    j_step = jloop._train_step

    def recording(*a):
        out = j_step(*a)
        j_losses.append(float(out[2]))
        return out

    jloop._train_step = recording
    jloop.run()
    tloop.run()
    np.testing.assert_allclose(tloop.epoch_losses, j_losses, **LOSS_TOL)
    assert [line.split(":")[0] for line in runners["port"].logger.lines if "[stage2]" in line] == \
        [f"[stage2] epoch {e}" for e in range(3)]
    assert tloop.lr == pytest.approx(1e-4 * 0.25) and tloop.optimizer.adamw.param_groups[0]["lr"] == \
        float(np.float32(2.5e-5))
    _assert_refiners_close(runners["port"].refiner_params, runners["jax"].refiner_params, "refiner")
    _assert_refiners_close(tloop.ema_params, jloop.ema_params, "EMA")
    moved = C.refiner_to_jax(runners["port"].refiner_params)
    assert not np.array_equal(moved["csf"]["mask_dec"]["w"], np.asarray(jp["csf"]["mask_dec"]["w"]))
    for e in (1, 2, 3):
        for suffix in ("", "_ema"):
            f = f"epoch{e}{suffix}.safetensors"
            _assert_refiners_close(TU.load_refiner_checkpoint(str(tmp_path / "port" / "refiner_ckp" / f)),
                                   JU.load_refiner_checkpoint(str(tmp_path / "jax" / "refiner_ckp" / f)), f)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="single-process"):
        TCL.LocalRefineTrainLoop(TCfg(cfg), runners["port"]).run()


def _lt_train_cfg(root, tag, weights, m_patches, max_epoch=2):
    cfg = _cfg_dict(root, tag, weights, val_batch=2)
    cfg.update(mode="train", start_ema=1)
    cfg["model_cfg"]["ema_weight"] = 0.7
    cfg["train_cfg"] = {"max_epoch": max_epoch, "lr0": 1e-4, "step_lr_gamma": 0.5, "step_lr_size": 1}
    cfg["val_cfg"].update(val_interval=2, val_start=2)
    cfg["dataset_cfg"]["trainset_cfg"]["require_m_patches"] = m_patches
    return cfg


@pytest.mark.parametrize("m_patches", [False, True])
def test_cli_lt_train_matches_jax(world, tmp_path, monkeypatch, m_patches):
    """``cli.lt_train_main`` on both packages from the same config file,
    decoder and starting refiner over the world's 5 images (2 steps an
    epoch, 2 epochs, one validation at epoch 2): the per-epoch losses, the
    epoch and EMA files, the validation's metrics; each package's trained
    refiner file loads in the other."""
    from ucod_dpl_tpu.engine import coral_loop as JCL

    root = world["root"]
    j_losses, j_results = [], []
    j_init = JCL.LocalRefineTrainLoop.__init__

    def init(self, cfg, runner):
        j_init(self, cfg, runner)
        step = self._train_step

        def recording(*a):
            out = step(*a)
            j_losses.append(float(out[2]))
            return out

        self._train_step = recording

    monkeypatch.setattr(JCL.LocalRefineTrainLoop, "__init__", init)
    j_val = JRunner.launch_val
    monkeypatch.setattr(JRunner, "launch_val", lambda self: j_results.append(j_val(self)) or j_results[-1])
    runs, ckp = {}, {}
    for name, main, extra in (("jax", JCLI.lt_train_main, []), ("port", TCLI.lt_train_main, ["--device", "cpu"])):
        cfg = _lt_train_cfg(tmp_path, name, world["weights"], m_patches)
        cfg["dataset_cfg"]["dataset_dir"] = str(root / "RefCOD")
        (tmp_path / f"lt_{name}.py").write_text(f"cfg = {cfg!r}\n")
        runs[name] = main(["-c", str(tmp_path / f"lt_{name}.py"), "--work_dir", str(tmp_path / f"wd_{name}"),
                           "--load_from", world["ckpts"]["mixed"], "--refiner_path", world["refiner"], *extra,
                           "--opts", "log_cfg.log_path", str(tmp_path / f"cli_{name}")])
        ckp[name] = tmp_path / f"cli_{name}" / "refiner_ckp"
    runner = runs["port"]
    assert isinstance(runner, TRunner) and runner.train_dataset.require_m_patches == m_patches
    np.testing.assert_allclose(runner.train_loop.epoch_losses, [np.mean(j_losses[:2]), np.mean(j_losses[2:])],
                               **LOSS_TOL)
    assert len(j_losses) == 4
    files = sorted(os.listdir(ckp["port"]))
    assert files == sorted(os.listdir(ckp["jax"])) == [f"epoch{e}{s}.safetensors" for e in (1, 2) for s in ("", "_ema")]
    for f in files:
        _assert_refiners_close(TU.load_refiner_checkpoint(str(ckp["port"] / f)),
                               JU.load_refiner_checkpoint(str(ckp["jax"] / f)), f)
    # the EMA is a copy through epoch 0 and moves from epoch 1 (start_ema 1)
    flat = {f: _by_path(TU.load_refiner_checkpoint(str(ckp["port"] / f))) for f in files}
    assert all(np.array_equal(v, flat["epoch1_ema.safetensors"][k]) for k, v in flat["epoch1.safetensors"].items())
    assert not all(np.array_equal(v, flat["epoch2_ema.safetensors"][k]) for k, v in flat["epoch2.safetensors"].items())
    assert len(j_results) == 1 and set(runner.evaluator.result) == set(KEYS)
    for k in KEYS:
        assert abs(runner.evaluator.result[k] - j_results[0][k]) <= 1e-5, (k, runner.evaluator.result[k], j_results)
    # each package reads the other's trained file as its own
    for a, b in (("port", "jax"), ("jax", "port")):
        _assert_refiners_close(TU.load_refiner_checkpoint(str(ckp[a] / "epoch2.safetensors")),
                               C.refiner_from_jax(JU.load_refiner_checkpoint(str(ckp[b] / "epoch2.safetensors"))),
                               f"{a} read as {b}")


def test_cli_lt_train_preempts_and_restarts(world, tmp_path, monkeypatch):
    """tests/test_coral_e2e.py's preemption case on the port: the deferred
    flag is honoured at the next step boundary (here the one after the
    first epoch's save), the trainer saves ``epoch0_preempt`` and exits 128
    + SIGTERM; the file holds ``runner.refiner_params``, and a restart from
    it (``--refiner_path``) completes."""
    from ucod_dpl_tpu_torch.engine import preempt

    calls = {"n": 0, "armed": True}

    def flag_after_three():  # two train steps poll first (5 images, batch 2), then the epoch's end
        calls["n"] += 1
        return 15 if calls["armed"] and calls["n"] >= 3 else None

    monkeypatch.setattr(preempt, "requested_global", flag_after_three)
    cfg = _lt_train_cfg(tmp_path, "p", world["weights"], False, max_epoch=10_000)
    cfg["dataset_cfg"]["dataset_dir"] = str(world["root"] / "RefCOD")
    (tmp_path / "lt.py").write_text(f"cfg = {cfg!r}\n")

    def argv(*flags):
        return ["-c", str(tmp_path / "lt.py"), "--work_dir", str(tmp_path / "wd"), "--load_from",
                world["ckpts"]["mixed"], "--device", "cpu", *flags, "--opts", "log_cfg.log_path", str(tmp_path / "p")]

    with pytest.raises(SystemExit) as ei:
        TCLI.lt_train_main(argv())
    assert ei.value.code == 128 + 15
    ckpts = sorted((tmp_path / "p" / "refiner_ckp").glob("*_preempt.safetensors"))
    assert [p.name for p in ckpts] == ["epoch0_preempt.safetensors"]
    log = (tmp_path / "p" / "run.log").read_text()
    assert f"--refiner_path {ckpts[0]}" in log
    saved = TU.load_refiner_checkpoint(str(ckpts[0]))
    flat = _by_path(saved)
    epoch1 = _by_path(TU.load_refiner_checkpoint(str(tmp_path / "p" / "refiner_ckp" / "epoch1.safetensors")))
    assert all(np.array_equal(v, epoch1[k]) for k, v in flat.items())  # no step between the save and the flag

    calls["armed"] = False
    cfg["train_cfg"]["max_epoch"] = 1
    (tmp_path / "lt.py").write_text(f"cfg = {cfg!r}\n")
    runner = TCLI.lt_train_main(argv("--refiner_path", str(ckpts[0])))
    assert all(np.array_equal(v, flat[k]) for k, v in _by_path(TU.load_refiner_checkpoint(str(ckpts[0]))).items())
    assert len(runner.train_loop.epoch_losses) == 1 and np.isfinite(runner.train_loop.epoch_losses).all()
    assert all(np.isfinite(v).all() for v in _by_path(runner.refiner_params).values())
