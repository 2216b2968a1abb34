"""The port's pseudo-label generation on the CPU against the JAX package.

``dino_forward(want_cls_attention=True)`` -> ``FeatureExtractor.
extract_with_attention`` -> ``ops.pseudo_label.compute_background_mask`` and
``refine_small_components`` -> ``cli.generate_pseudo_label_main``, each held
against its JAX counterpart on the same numpy inputs and weights, plus the
port's copies of the bilateral solver and the visualisation helper.  Small
width: 64 hidden, 3 layers, 4 heads of 16, patch 14, 56px (the JAX package
sends 4 heads of 16 to its XLA attention, so no Pallas kernel runs there).
The CLI runs at dinov2-base's full width (neither CLI has an architecture
flag) over 17 tokens.

Tolerances: CLS attention and key tokens 1e-5 in float32 (the forward
tolerance of tests/test_dino_parity.py:179); the weighted similarity map
1e-5; background masks equal except where the JAX similarity lies within
1e-4 of ``th_bkg`` (a float32 similarity that close to the threshold may
fall either way); the small-component cleanup, the bilateral solver and the
visualisation exactly equal.
"""

import dataclasses
import hashlib
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from ucod_dpl_tpu import cli as JCLI
from ucod_dpl_tpu.config import CfgNode as JCfg
from ucod_dpl_tpu.data.dataset import CODDataset as JDataset
from ucod_dpl_tpu.data.feature_extractor import FeatureExtractor as JFE
from ucod_dpl_tpu.models import dino as JD
from ucod_dpl_tpu.ops import pseudo_label as JPL
from ucod_dpl_tpu.utils import bilateral_solver as JBS
from ucod_dpl_tpu.utils import visualize as JVIS
from ucod_dpl_tpu.utils.fileio import ArrayCache as JCache
from ucod_dpl_tpu_torch import cli as TCLI
from ucod_dpl_tpu_torch.config import CfgNode as TCfg
from ucod_dpl_tpu_torch.data.dataset import CODDataset as TDataset
from ucod_dpl_tpu_torch.data.feature_extractor import FeatureExtractor as TFE
from ucod_dpl_tpu_torch.models import convert as C
from ucod_dpl_tpu_torch.models import dino as TD
from ucod_dpl_tpu_torch.ops import pseudo_label as TPL
from ucod_dpl_tpu_torch.ops.quant import quantize_dino_linears
from ucod_dpl_tpu_torch.utils import bilateral_solver as TBS
from ucod_dpl_tpu_torch.utils import visualize as TVIS
from ucod_dpl_tpu_torch.utils.fileio import ArrayCache as TCache

ARCH = {"hidden_size": 64, "num_layers": 3, "num_heads": 4, "patch_size": 14, "image_size": 56}
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def tiny():
    cfg = dataclasses.replace(JD.DinoConfig.from_type("dinov2"), **ARCH)
    tcfg = dataclasses.replace(TD.DinoConfig.from_type("dinov2"), **ARCH)
    jp = JD.init_dino(jax.random.PRNGKey(3), cfg)
    tp = C.dino_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return cfg, tcfg, jp, tp


def _pixels(seed, b=3, hw=(56, 56)):
    return np.random.default_rng(seed).standard_normal((b, *hw, 3)).astype(np.float32)


@pytest.mark.parametrize("hw", [(56, 56), (70, 56)])
def test_dino_cls_attention_matches_jax(tiny, hw):
    cfg, tcfg, jp, tp = tiny
    px = _pixels(1, hw=hw)
    out_j = JD.dino_forward(jp, jnp.asarray(px), cfg, want_cls_attention=True)
    out_t = TD.dino_forward(tp, torch.from_numpy(px), tcfg, want_cls_attention=True)
    assert set(out_t) == {"key_tokens", "key_features", "cls_attention"}
    assert tuple(out_t["cls_attention"].shape) == (3, 4, 1 + (hw[0] // 14) * (hw[1] // 14))
    for key in out_t:
        np.testing.assert_allclose(out_t[key].numpy(), np.asarray(out_j[key]), **TOL)
    np.testing.assert_allclose(out_t["cls_attention"].sum(-1).numpy(), 1.0, rtol=1e-5)


def test_dino_cls_attention_refuses_fold_quant_and_tp(tiny):
    _, tcfg, _, tp = tiny
    px = torch.from_numpy(_pixels(2, b=1))
    fold = (torch.zeros(8, 64), torch.zeros(8))
    with pytest.raises(ValueError, match="key_fold"):
        TD.dino_forward(tp, px, tcfg, key_fold=fold, want_cls_attention=True)
    with pytest.raises(ValueError, match="full-precision"):
        TD.dino_forward(tp, px, tcfg, quant=quantize_dino_linears(tp), want_cls_attention=True)
    with pytest.raises(NotImplementedError, match="item 19"):
        TD.dino_forward([tp], px, tcfg, tp_shard=(None, "model"), want_cls_attention=True)


def test_extract_with_attention_matches_jax_and_ignores_int8(tmp_path):
    """Both extractors on one seeded HF checkpoint; an int8 extractor of the
    port returns what its float32 twin does (no int8 linears on this path)."""
    tcfg = dataclasses.replace(TD.DinoConfig.from_type("dinov2"), **ARCH)
    TD.save_hf_checkpoint(str(tmp_path / "model.safetensors"), TD.init_dino(4, tcfg), tcfg)
    fe_cfg = {"type": "dinov2", "backbone": "facebook/dinov2-base", "backbone_weights": str(tmp_path),
              "arch": dict(ARCH)}
    px = _pixels(5)
    got = TFE(TCfg(fe_cfg), device="cpu").extract_with_attention(px)
    want = JFE(JCfg(fe_cfg), compute_dtype=jnp.float32).extract_with_attention(px)
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_allclose(g, w, **TOL)
    got8 = TFE(TCfg(fe_cfg), device="cpu", quantize="int8").extract_with_attention(px)
    for g, g8 in zip(got, got8):
        np.testing.assert_array_equal(g, g8)
    bad = TFE(TCfg(fe_cfg), device="cpu")
    bad.params["cls_token"].fill_(float("nan"))
    with pytest.raises(FloatingPointError, match="key tokens"):
        bad.extract_with_attention(px)


def _near_threshold(jax_attn, jax_toks, grid, th, up_size, apply_weights):
    """Pixels whose JAX similarity lies within 1e-4 of ``th``: those the JAX
    masks at th - 1e-4 and th + 1e-4 disagree on."""
    lo, _ = JPL.compute_background_mask(jax_attn, jax_toks, grid, th - 1e-4, up_size=up_size,
                                        apply_weights=apply_weights)
    hi, _ = JPL.compute_background_mask(jax_attn, jax_toks, grid, th + 1e-4, up_size=up_size,
                                        apply_weights=apply_weights)
    return np.asarray(lo) != np.asarray(hi)


@pytest.mark.parametrize("up_size,apply_weights,th", [(None, True, 0.6), (None, False, 0.3), (9, True, 0.5),
                                                      (16, True, 0.6)])
def test_compute_background_mask_matches_jax(tiny, up_size, apply_weights, th):
    """On the tiny backbone's own CLS attention and key tokens (4 x 4 grid),
    at the grid's size and upsampled."""
    cfg, _, jp, _ = tiny
    out = JD.dino_forward(jp, jnp.asarray(_pixels(6, b=4)), cfg, want_cls_attention=True)
    attn, toks = np.array(out["cls_attention"]), np.array(out["key_tokens"])
    bkg_j, sim_j = JPL.compute_background_mask(jnp.asarray(attn), jnp.asarray(toks), (4, 4), th, up_size=up_size,
                                               apply_weights=apply_weights)
    bkg_t, sim_t = TPL.compute_background_mask(torch.from_numpy(attn), torch.from_numpy(toks), (4, 4), th,
                                               up_size=up_size, apply_weights=apply_weights)
    assert bkg_t.dtype == sim_t.dtype == torch.float32 and tuple(bkg_t.shape) == bkg_j.shape
    np.testing.assert_allclose(sim_t.numpy(), np.asarray(sim_j), **TOL)
    near = _near_threshold(jnp.asarray(attn), jnp.asarray(toks), (4, 4), th, up_size, apply_weights)
    differ = bkg_t.numpy() != np.asarray(bkg_j)
    assert not (differ & ~near).any()
    assert 0 < np.asarray(bkg_j).mean() < 1  # both labels present: the rule compares something


@pytest.mark.parametrize("seed,density,shape", [(0, 0.5, (16, 16)), (1, 0.2, (16, 16)), (2, 0.8, (16, 16)),
                                                (3, 0.5, (37, 23)), (4, 0.05, (16, 16, 1))])
def test_refine_small_components_matches_jax(seed, density, shape):
    mask = (np.random.default_rng(seed).random(shape) < density).astype(np.float32)
    got, want = TPL.refine_small_components(mask), JPL.refine_small_components(mask)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # an isolated foreground pixel inside background is flipped, on both sides
    mask = np.squeeze(mask).copy()
    mask[5:8, 5:8] = 0.0
    mask[6, 6] = 1.0
    got = TPL.refine_small_components(mask)
    assert got[6, 6] == 0.0
    np.testing.assert_array_equal(got, JPL.refine_small_components(mask))


def _blob_image(seed, h=40, w=52):
    rng = np.random.default_rng(seed)
    img = np.full((h, w, 3), 40, np.uint8)
    img[10:30, 14:40] = 200
    img = np.clip(img + rng.integers(-8, 9, img.shape), 0, 255).astype(np.uint8)
    mask = np.zeros((h, w), np.float32)
    mask[9:31, 12:38] = 1.0
    mask[rng.random((h, w)) < 0.03] = 1.0
    return img, mask


def test_bilateral_solver_matches_jax():
    img, mask = _blob_image(0)
    for fn, args in (("bilateral_solver_output", (img, mask)), ("apply_bilateral_solver", (mask, img))):
        got, want = getattr(TBS, fn)(*args), getattr(JBS, fn)(*args)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    got = TBS.batch_apply_bilateral_solver([mask, mask[:, ::-1]], [img, img[:, ::-1]])
    want = JBS.batch_apply_bilateral_solver([mask, mask[:, ::-1]], [img, img[:, ::-1]])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert TBS.bbox_from_mask(mask) == JBS.bbox_from_mask(mask)
    assert TBS.bbox_iou((0, 0, 9, 9), (5, 0, 14, 9)) == JBS.bbox_iou((0, 0, 9, 9), (5, 0, 14, 9))
    grid_t = TBS.BilateralGrid(img, sigma_spatial=8, sigma_luma=4, sigma_chroma=4)
    grid_j = JBS.BilateralGrid(img, sigma_spatial=8, sigma_luma=4, sigma_chroma=4)
    x = np.random.default_rng(1).random(img.shape[0] * img.shape[1])
    np.testing.assert_array_equal(grid_t.filter(x), grid_j.filter(x))


def test_visualize_matches_jax(tmp_path):
    img, mask = _blob_image(1)
    paths = [tmp_path / "t.png", tmp_path / "j.png"]
    for mod, path in zip((TVIS, JVIS), paths):
        mod.draw_bboxes_on_image_and_save(img, [(14, 10, 26, 20)], str(path), mask=mask)
    assert paths[0].exists() == paths[1].exists()
    if paths[0].exists():  # matplotlib is optional: both write nothing without it
        assert np.array_equal(np.asarray(Image.open(paths[0])), np.asarray(Image.open(paths[1])))


# -- the CLI, at full width ----------------------------------------------------------

DATASETS = ("SET-A", "SET-B")


@pytest.fixture(scope="module")
def pl_world(tmp_path_factory):
    """4 JPEGs in two dataset directories (blob images at two sizes), one
    seeded full-width dinov2-base HF checkpoint, and both CLIs' caches at
    56px in batches of 3."""
    root = tmp_path_factory.mktemp("pl")
    for d, name in enumerate(DATASETS):
        (root / "RefCOD" / name / "im").mkdir(parents=True)
        for i in range(2):
            img, _ = _blob_image(10 * d + i, *((60, 80) if i else (72, 64)))
            Image.fromarray(img).save(root / "RefCOD" / name / "im" / f"{name.lower()}_{i}.jpg")
    cfg = TD.DinoConfig.from_type("dinov2")
    (root / "hf").mkdir()
    TD.save_hf_checkpoint(str(root / "hf" / "model.safetensors"), TD.init_dino(7, cfg), cfg)

    def argv(tag, *extra):
        return ["--dataset", "+".join(DATASETS), "--image_path", str(root / "RefCOD" / "{}" / "im"),
                "--cache_path", str(root / f"cache_{tag}" / "pseudo_label_cache"), "--backbone_weights",
                str(root / "hf"), "--image_size", "56", "--batch_size", "3", *extra]

    JCLI.generate_pseudo_label_main(argv("jax"))
    out = TCLI.generate_pseudo_label_main(argv("port", "--device", "cpu"))
    return dict(root=root, argv=argv, port_dir=out)


def _entries(path):
    cache = TCache(path)
    assert cache.mode == "r"
    return [cache.read(i) for i in range(len(cache))], cache.read_meta()


def _expected_meta(root):
    paths = sorted(p for d in DATASETS for p in (root / "RefCOD" / d / "im").iterdir())
    stems = "\n".join(p.stem for p in paths)
    return {"n": 4, "fingerprint": hashlib.sha1(stems.encode()).hexdigest(), "th_bkg": 0.6}


def test_cli_generate_pseudo_label_matches_jax(pl_world):
    root = pl_world["root"]
    name = "+".join(DATASETS)
    assert pl_world["port_dir"] == str(root / "cache_port" / "pseudo_label_cache" / name)
    got, meta_t = _entries(pl_world["port_dir"])
    want, meta_j = _entries(root / "cache_jax" / "pseudo_label_cache" / name)
    assert meta_t == meta_j == _expected_meta(root)
    assert len(got) == len(want) == 4
    # the JAX package's near-threshold pixels, from its own extractor on the same batches
    fe = JFE(JCfg({"type": "dinov2", "backbone": "facebook/dinov2-base", "backbone_weights": str(root / "hf")}))
    from ucod_dpl_tpu.data.transforms import image_transform
    from ucod_dpl_tpu.utils.fileio import ImageIO

    paths = sorted(p for d in DATASETS for p in (root / "RefCOD" / d / "im").iterdir())
    near = []
    for s in range(0, 4, 3):
        batch = np.stack([image_transform(ImageIO.read_image(p, "RGB"), (56, 56)) for p in paths[s : s + 3]])
        toks, _, attn = fe.extract_with_attention(batch)
        near += list(_near_threshold(jnp.asarray(attn), jnp.asarray(toks), (4, 4), 0.6, None, True))
    for g, w, n in zip(got, want, near):
        assert g.shape == w.shape == (4, 4, 1) and g.dtype == np.float32
        assert not ((g[..., 0] != w[..., 0]) & ~n).any()


def test_cli_generate_pseudo_label_early_exit_and_overwrite(pl_world):
    """A complete cache is left alone (both CLIs return before writing); with
    ``--overwrite`` and another ``--th_bkg`` both regenerate to the same
    meta."""
    root, argv = pl_world["root"], pl_world["argv"]
    name = "+".join(DATASETS)
    index = [root / f"cache_{tag}" / "pseudo_label_cache" / name / "index.json" for tag in ("port", "jax")]
    stamps = [p.stat().st_mtime_ns for p in index]
    assert TCLI.generate_pseudo_label_main(argv("port", "--device", "cpu")) == pl_world["port_dir"]
    JCLI.generate_pseudo_label_main(argv("jax"))
    assert [p.stat().st_mtime_ns for p in index] == stamps
    TCLI.generate_pseudo_label_main(argv("port", "--device", "cpu", "--overwrite", "--th_bkg", "0.3"))
    JCLI.generate_pseudo_label_main(argv("jax", "--overwrite", "--th_bkg", "0.3"))
    _, meta_t = _entries(pl_world["port_dir"])
    _, meta_j = _entries(root / "cache_jax" / "pseudo_label_cache" / name)
    assert meta_t == meta_j == {**_expected_meta(root), "th_bkg": 0.3}
    # back to the default threshold for the tests after this one
    TCLI.generate_pseudo_label_main(argv("port", "--device", "cpu", "--overwrite"))
    JCLI.generate_pseudo_label_main(argv("jax", "--overwrite"))


def test_datasets_read_either_generators_cache(pl_world):
    """The port's ``CODDataset`` in train mode reads the JAX-written
    pseudo-label cache, and the JAX one the port's, entry for entry."""
    root = pl_world["root"]
    name = "+".join(DATASETS)
    fe_cfg = {"type": "dinov2", "backbone": "facebook/dinov2-base", "backbone_weights": str(root / "hf")}
    kw = dict(dataset_dir=str(root / "RefCOD"), mode="train", image_size=(56, 56))
    for reader, cfg_cls, fe, tag, writer in (
            (TDataset, TCfg, TFE(TCfg(fe_cfg), device="cpu"), "jax", "jax"),
            (JDataset, JCfg, JFE(JCfg(fe_cfg)), "port", "port")):
        ds = reader(cfg_cls({"DATASET": name}), cfg_cls(fe_cfg), cache_dir=str(root / f"cache_{tag}"),
                    feature_extractor=fe, **kw)
        entries, _ = _entries(root / f"cache_{writer}" / "pseudo_label_cache" / name)
        assert len(ds) == 4
        for i in range(4):
            np.testing.assert_array_equal(np.asarray(ds[i]["pseudo_label"]), entries[i])
    assert json.loads((root / "cache_port" / "pseudo_label_cache" / name / "index.json").read_text())
