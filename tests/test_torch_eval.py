"""The port's stage-1 eval entry on the CPU against the JAX package.

``cli eval`` -> ``Runner`` -> ``CODDataset`` feature-cache build ->
``LookTwiceEvaluator`` -> ``CODStatistics`` on both sides, with the tiny
configuration of tests/test_eval_e2e.py (DIM 64, feature size 8, 56px, a
2-layer backbone) in float32.  Both sides load the same backbone (a seeded
HuggingFace-layout checkpoint written by the port) and the same decoder
checkpoint; the images are seeded numpy arrays written as JPEG/PNG.  The
JAX side runs as test_eval_e2e.py runs it on the CPU.  Tolerances: cached
features 1e-5 (the float32 forward tolerance of test_dino_parity.py:179);
masks equal on at least 99.9% of pixels (a float32 logit within rounding of
the 0.5 threshold may fall either way); metrics 1e-6 from one cache and
1e-9 for the metric functions alone (the JAX package's native scorer and
its NumPy path agree to 1e-9, test_metrics.py).
"""

import dataclasses
import os
import time

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from ucod_dpl_tpu import cli as JCLI
from ucod_dpl_tpu.config import CfgNode as JCfg
from ucod_dpl_tpu.data.dataset import CODDataset as JDataset
from ucod_dpl_tpu.data.dataset import DataLoader as JLoader
from ucod_dpl_tpu.engine import Runner as JRunner
from ucod_dpl_tpu.engine.eval_loop import _make_first_pass, find_refine_bboxes as j_bboxes
from ucod_dpl_tpu.models.safetensors_io import load_decoder_checkpoint as j_load_decoder
from ucod_dpl_tpu.utils.fileio import ArrayCache as JCache
from ucod_dpl_tpu.utils.metrics import CODStatistics as JStats
from ucod_dpl_tpu_torch import cli as TCLI
from ucod_dpl_tpu_torch.config import CfgNode as TCfg
from ucod_dpl_tpu_torch.data.dataset import CODDataset as TDataset
from ucod_dpl_tpu_torch.data.dataset import DataLoader as TLoader
from ucod_dpl_tpu_torch.data.feature_extractor import FeatureExtractor
from ucod_dpl_tpu_torch.data.transforms import load_image_batch_transform
from ucod_dpl_tpu_torch.engine.eval_loop import LookTwiceEvaluator, find_refine_bboxes as t_bboxes
from ucod_dpl_tpu_torch.engine.runner import Runner as TRunner
from ucod_dpl_tpu_torch.models.dba import init_rev_decoder, rev_decoder_forward_resized
from ucod_dpl_tpu_torch.models.dino import DinoConfig, init_dino, save_hf_checkpoint
from ucod_dpl_tpu_torch.models.safetensors_io import save_decoder_checkpoint
from ucod_dpl_tpu_torch.utils.fileio import ArrayCache as TCache
from ucod_dpl_tpu_torch.utils.metrics import CODStatistics as TStats

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM = 64
ARCH = {"hidden_size": DIM, "num_layers": 2, "num_heads": 4, "patch_size": 14, "image_size": 56}
SIZES = ((80, 100), (90, 70))  # two image sizes, alternating
N_IMAGES = 5
KEYS = ("ACC", "mIOU", "E_MAX", "E_MEAN", "F_MAX", "F_MEAN", "SMeasure", "MAE", "WFM")


def _make_dataset(root, name="TINY", n=N_IMAGES):
    im, gt = root / name / "im", root / name / "gt"
    im.mkdir(parents=True)
    gt.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(n):
        size = SIZES[i % 2]
        Image.fromarray((rng.random((*size, 3)) * 255).astype(np.uint8)).save(im / f"img{i}.jpg")
        mask = np.zeros(size, dtype=np.uint8)
        mask[20 + i : 40 + i, 30:60] = 255
        Image.fromarray(mask).save(gt / f"img{i}.png")


def _cfg_dict(root, tag, weights, look_twice=True, val_batch=1):
    """tests/test_eval_e2e.py's tiny configuration, float32, with its own
    cache and log directories per ``tag``."""
    return {
        "work_dir": str(root / f"work_{tag}"),
        "mode": "eval",
        "seed": 42,
        "model_cfg": {"dim": DIM, "feature_size": 8, "dis_use_features": False, "ema_weight": 0.99},
        "val_cfg": {"look_twice": look_twice, "look_twice_th": 0.95, "expand_type": "dynamic",
                    "enable_val": True, "metric_workers": 0},
        "log_cfg": {"log_path": str(root / f"logs_{tag}"), "multi_rank": [0]},
        "tpu_cfg": {"mesh": {"data": -1, "model": 1}, "compute_dtype": "float32"},
        "dataset_cfg": {
            "dataset_dir": str(root / "RefCOD"),
            "cache_dir": str(root / f"cache_{tag}"),
            "valset_cfg": {"DATASET": "TINY", "require_label": True, "image_size": (56, 56), "keep_size": True},
            "trainset_cfg": {"DATASET": "TINY", "require_label": False, "image_size": (56, 56), "bkg_th": 0.6},
            "val_loader_cfg": {"batch_size": val_batch},
            "trainloader_cfg": {"batch_size": 2, "shuffle": True},
            "feature_extractor_cfg": {"type": "dinov2", "backbone": "facebook/dinov2-base",
                                      "backbone_weights": str(weights), "arch": dict(ARCH)},
        },
    }


def _masks(log_path):
    d = os.path.join(log_path, "preds", "TINY")
    return {f: np.asarray(Image.open(os.path.join(d, f))) for f in sorted(os.listdir(d))}


def _assert_masks_agree(a, b, share=0.999):
    assert sorted(a) == sorted(b)
    for name in a:
        assert a[name].shape == b[name].shape, name
        assert (a[name] == b[name]).mean() >= share, (name, (a[name] == b[name]).mean())


def _assert_metrics_close(got, want, tol):
    assert set(got) == set(want) == set(KEYS)
    for k in KEYS:
        assert abs(got[k] - want[k]) <= tol, (k, got[k], want[k])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A 5-image dataset, one backbone and one decoder checkpoint, and three
    runs: the JAX package (its own cache), the port building its own cache,
    and the port reading the JAX package's cache."""
    root = tmp_path_factory.mktemp("eval")
    _make_dataset(root / "RefCOD")
    dcfg = dataclasses.replace(DinoConfig.from_type("dinov2"), **ARCH)
    weights = root / "hf"
    weights.mkdir()
    save_hf_checkpoint(str(weights / "model.safetensors"), init_dino(0, dcfg), dcfg)

    # a decoder whose first pass marks about a third of the pixels: its fg
    # bias moved to the 67th percentile of the logits on these images
    fe = FeatureExtractor(TCfg(_cfg_dict(root, "x", weights)["dataset_cfg"]["feature_extractor_cfg"]),
                          device="cpu")
    paths = sorted((root / "RefCOD" / "TINY" / "im").iterdir())
    feats = torch.from_numpy(fe.extract(load_image_batch_transform(paths, (56, 56))))
    dec = init_rev_decoder(1, DIM)
    fg, _, _ = rev_decoder_forward_resized(dec, feats, 8)
    dec = dec._replace(conv_out_fg_b=dec.conv_out_fg_b - torch.quantile(fg.flatten(), 0.67))
    ckpt = str(root / "decoder.safetensors")
    save_decoder_checkpoint(ckpt, dec, init_rev_decoder(2, DIM))

    jrun = JRunner(JCfg(_cfg_dict(root, "jax", weights)), mode="eval", load_from=ckpt)
    jres = jrun.launch_val_look_twice()
    trun = TRunner(TCfg(_cfg_dict(root, "port", weights)), mode="eval", load_from=ckpt, device="cpu")
    tres = trun.launch_val_look_twice()
    shared = _cfg_dict(root, "shared", weights)
    shared["dataset_cfg"]["cache_dir"] = str(root / "cache_jax")
    srun = TRunner(TCfg(shared), mode="eval", load_from=ckpt, device="cpu")
    sres = srun.launch_val_look_twice()
    return dict(root=root, weights=weights, ckpt=ckpt, jrun=jrun, jres=jres, trun=trun, tres=tres,
                srun=srun, sres=sres)


def test_feature_cache_matches_jax(world):
    """The port's cache build against the JAX package's, entry by entry, in
    the same layout with the same identity sidecar."""
    sub = os.path.join("features_cache", "dinov2", "test", "TINY")
    jc = JCache(os.path.join(world["root"], "cache_jax", sub))
    tc = TCache(os.path.join(world["root"], "cache_port", sub))
    assert jc.mode == tc.mode == "r" and len(jc) == len(tc) == N_IMAGES
    assert jc.read_meta() == tc.read_meta()
    for i in range(N_IMAGES):
        a, b = jc.read(i), tc.read(i)
        assert a.shape == b.shape == (4, 4, DIM) and b.dtype == np.float32
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)
    # the port's own cache gives masks and metrics like the JAX package's
    _assert_masks_agree(_masks(world["trun"].log_path), _masks(world["jrun"].log_path), share=0.99)
    _assert_metrics_close(world["tres"], world["jres"], 1e-2)


def test_masks_bboxes_and_metrics_match_jax_from_one_cache(world):
    """Fed the JAX package's cache and the same decoder checkpoint, the port's
    first-pass masks, LookTwice bboxes, written masks and metrics are the
    JAX package's."""
    srun, jrun = world["srun"], world["jrun"]
    assert srun.val_dataset.caches.get("features").mode == "r"
    assert srun.evaluator.crops > 0  # look_twice_th 0.95 forces the crop path
    jfirst = _make_first_pass(8, (56, 56))
    jdec, _ = j_load_decoder(world["ckpt"])
    ev = LookTwiceEvaluator(srun.cfg, srun)
    for i in range(N_IMAGES):
        feats = srun.val_dataset[i]["features"][None]
        want = np.asarray(jfirst(jdec, feats))[0]
        got = ev._dispatch_first_pass(feats)[0].numpy()[0]
        assert got.dtype == np.uint8 and got.shape == (56, 56)
        assert (got == want).mean() >= 0.999
        assert 0.05 < got.mean() < 0.95  # a real mix of foreground and background
        binary = want.astype(np.float32)
        assert t_bboxes(binary, (56, 56), 0.95, "dynamic") == j_bboxes(binary, (56, 56), 0.95, "dynamic")
    _assert_masks_agree(_masks(srun.log_path), _masks(jrun.log_path))
    for m in _masks(srun.log_path).values():
        assert m.shape in SIZES and set(np.unique(m)) <= {0, 255}
    _assert_metrics_close(world["sres"], world["jres"], 1e-6)


@pytest.mark.parametrize("case", ["look_twice_off", "val_batch_4"])
def test_eval_variants_match_jax(world, case):
    """tests/test_eval_e2e.py's cases mirrored: LookTwice off against the JAX
    package (both reading the JAX cache); val batch 4 (a batch of 4 and a
    padded tail of 1) against the batch-1 run."""
    root, weights, ckpt = world["root"], world["weights"], world["ckpt"]
    d = _cfg_dict(root, f"{case}_port", weights, look_twice=case != "look_twice_off",
                  val_batch=4 if case == "val_batch_4" else 1)
    d["dataset_cfg"]["cache_dir"] = str(root / "cache_jax")
    got = TRunner(TCfg(d), mode="eval", load_from=ckpt, device="cpu").launch_val_look_twice()
    if case == "val_batch_4":
        want = world["sres"]
    else:
        j = _cfg_dict(root, f"{case}_jax", weights, look_twice=False)
        j["dataset_cfg"]["cache_dir"] = str(root / "cache_jax")
        want = JRunner(JCfg(j), mode="eval", load_from=ckpt).launch_val_look_twice()
    _assert_metrics_close(got, want, 1e-6)


def test_load_latest_checkpoint_and_interchange(world):
    """save_checkpoint -> load_latest_checkpoint: the newest epoch file wins
    and restores the decoder exactly; the JAX package reads the port's file
    to the same numbers; an empty directory gives None."""
    runner = world["srun"]
    runner.save_checkpoint(1)
    time.sleep(0.05)  # distinct mtimes: the newest by mtime is loaded
    saved = [t.clone() for t in runner.decoder_params]
    p2 = runner.save_checkpoint(2)
    runner.decoder_params = runner.decoder_params._replace(decoupling_b=runner.decoder_params.decoupling_b + 1)
    assert runner.load_latest_checkpoint() == p2
    for a, b in zip(saved, runner.decoder_params):
        assert torch.equal(a, b)
    jdec, _ = j_load_decoder(p2)
    np.testing.assert_array_equal(np.asarray(jdec.decoupling_b), saved[1].numpy())
    for f in os.listdir(runner.ckp_dir):
        os.unlink(os.path.join(runner.ckp_dir, f))
    assert runner.load_latest_checkpoint() is None


def _metric_pairs():
    rng = np.random.default_rng(3)
    gt = np.zeros((48, 64))
    gt[10:30, 20:50] = 1
    soft = rng.random((48, 64))
    return [
        (gt, (soft > 0.6).astype(np.float64)),  # binary prediction
        (gt, soft),  # soft prediction
        (gt * 255, np.clip(gt + 0.3 * rng.standard_normal(gt.shape), 0, 1)),  # 0/255 gt, noisy pred
        (gt, np.full(gt.shape, 0.5)),  # constant prediction (integer protocol quirk)
        (np.zeros((48, 64)), soft),  # empty gt
        (np.ones((48, 64)), soft),  # full gt
        (rng.random((31, 17)) > 0.5, rng.random((31, 17))),  # odd size, scattered gt
    ]


def test_cod_statistics_match_jax():
    """CODStatistics of the port against the JAX package on seeded pairs:
    every key within 1e-9, one pair at a time and all together."""
    pairs = _metric_pairs()
    for pair in pairs + [None]:
        t, j = TStats(), JStats()
        for g, p in pairs if pair is None else [pair]:
            t.step(g[None], p[None])
            j.step(g[None], p[None])
        got, want = t.get_result(), j.get_result()
        for k in KEYS:
            assert np.isfinite(got[k]) and abs(got[k] - want[k]) <= 1e-9, (k, got[k], want[k])


def test_cod_statistics_pool_matches_sync():
    """CODStatistics(workers=2) keeps its process pool and the sync result."""
    pairs = _metric_pairs()
    sync, pool = TStats(), TStats(workers=2)
    for g, p in pairs:
        sync.step(g[None], p[None])
        pool.step(g[None], p[None])
    assert pool.get_result() == sync.get_result()
    # metric_workers -1 picks a pool from 64 images on (the JAX package's
    # copy of this raises NameError there: it never imports os)
    assert TStats.auto_workers(63) == 0 and TStats.auto_workers(64) == (os.cpu_count() or 2) // 2


class _StubExtractor:
    """Deterministic "features" (every 7th pixel of the normalised batch),
    counting its calls: both packages' cache builds decode and normalise the
    same files, so their caches must agree bit for bit."""

    quantize = None

    def __init__(self):
        self.calls = 0

    def extract(self, batch):
        self.calls += 1
        return np.ascontiguousarray(np.asarray(batch)[:, ::7, ::7, :], np.float32)


def test_array_caches_and_invalidation_both_ways(tmp_path):
    """ArrayCache written by one package reads bit for bit in the other (with
    the sidecar); a dataset cache built by the JAX package is invalidated by
    the port when an image is renamed, rebuilt, and then read by the JAX
    package as built."""
    rng = np.random.default_rng(5)
    arrays = [rng.standard_normal((3, 4, 5)).astype(np.float32) for _ in range(3)]
    for writer, reader in ((JCache, TCache), (TCache, JCache)):
        base = tmp_path / f"{writer.__module__}"
        w = writer(base)
        for i, a in enumerate(arrays):
            w.write(i, a)
        w.flush(meta={"n": 3, "fingerprint": "abc"})
        r = reader(base)
        assert r.mode == "r" and r.read_meta() == {"n": 3, "fingerprint": "abc"}
        for i, a in enumerate(arrays):
            assert np.array_equal(r.read(i), a) and r.read(i).dtype == a.dtype

    _make_dataset(tmp_path / "RefCOD", n=3)
    set_cfg = {"DATASET": "TINY", "require_label": True}
    fe_cfg = {"type": "dinov2"}

    def build(pkg_dataset, cfg_cls, stub):
        return pkg_dataset(cfg_cls(set_cfg), cfg_cls(fe_cfg), dataset_dir=str(tmp_path / "RefCOD"),
                           cache_dir=str(tmp_path / "cache"), mode="test", image_size=(56, 56),
                           require_label=True, feature_extractor=stub)

    j1 = _StubExtractor()
    jds = build(JDataset, JCfg, j1)
    assert j1.calls == 1
    t0 = _StubExtractor()
    tds = build(TDataset, TCfg, t0)  # a complete cache of the same images: read, not rebuilt
    assert t0.calls == 0 and tds._cache_identity() == jds._cache_identity()
    for i in range(3):
        assert np.array_equal(tds[i]["features"], jds[i]["features"])
        assert np.array_equal(tds[i]["label"], jds[i]["label"])
    im = tmp_path / "RefCOD" / "TINY" / "im"
    gt = tmp_path / "RefCOD" / "TINY" / "gt"
    (im / "img1.jpg").rename(im / "img9.jpg")
    (gt / "img1.png").rename(gt / "img9.png")
    t1 = _StubExtractor()
    tds = build(TDataset, TCfg, t1)  # same count, other stems: invalidated and rebuilt
    assert t1.calls == 1
    j2 = _StubExtractor()
    jds = build(JDataset, JCfg, j2)  # the port's rebuild is complete for the JAX package
    assert j2.calls == 0 and tds._cache_identity() == jds._cache_identity()
    for i in range(3):
        assert np.array_equal(tds[i]["features"], jds[i]["features"])
        assert tds[i]["img_path"] == jds[i]["img_path"]


class _ListDataset:
    def __init__(self, n):
        self.items = [{"x": np.full((2, 2), i, np.float32), "path": f"p{i}", "i": i} for i in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


@pytest.mark.parametrize("kw", [
    dict(batch_size=3),
    dict(batch_size=4, shuffle=True, seed=7),
    dict(batch_size=4, shuffle=True, seed=7, drop_last=True),
    dict(batch_size=2, shard=(1, 3)),
    dict(batch_size=2, shuffle=True, seed=3, shard=(2, 3), pad_shards=True),
    dict(batch_size=3, shuffle=True, seed=3, shard=(0, 4), pad_shards=True, drop_last=True),
    dict(batch_size=5, prefetch=0, shuffle=True),
])
def test_dataloader_matches_jax(kw):
    """Batch order and contents over two epochs and a skip_batches resume,
    the JAX package's DataLoader against the port's."""
    ds = _ListDataset(11)
    j, t = JLoader(ds, **kw), TLoader(ds, **kw)
    assert len(j) == len(t)
    for epoch in range(3):
        if epoch == 2:
            j.skip_batches(1)
            t.skip_batches(1)
        jb, tb = list(j), list(t)
        assert len(jb) == len(tb)
        for a, b in zip(jb, tb):
            assert a.keys() == b.keys() and a["path"] == b["path"]
            assert np.array_equal(a["x"], b["x"]) and np.array_equal(a["i"], b["i"])


def _write_config(path, cfg_dict):
    path.write_text(f"cfg = {cfg_dict!r}\n")


def test_cli_eval_prints_the_jax_results(world, tmp_path, capsys):
    """``cli.eval_main(["--device", "cpu", ...])`` on the tiny configuration
    prints the per-dataset lines of ``ucod_dpl_tpu.cli.eval_main``."""
    lines = {}
    for name, main, extra in (("jax", JCLI.eval_main, []), ("port", TCLI.eval_main, ["--device", "cpu"])):
        cfg_path = tmp_path / f"tiny_{name}.py"
        _write_config(cfg_path, _cfg_dict(tmp_path, name, world["weights"]))
        main(["-c", str(cfg_path), "--work_dir", str(tmp_path / f"wd_{name}"), "--load_from", world["ckpt"],
              "--datasets", "TINY", *extra, "--opts", "dataset_cfg.dataset_dir", str(world["root"] / "RefCOD")])
        out = capsys.readouterr().out.splitlines()
        lines[name] = [line for line in out if line.startswith(("running", "TINY"))]
    assert len(lines["port"]) == 2 and lines["port"] == lines["jax"], lines


def test_cli_eval_on_the_shipped_config_runs_on_the_cpu(tmp_path, capsys):
    """``python3 -m ucod_dpl_tpu_torch.cli eval -c configs/uscod/UCOD-DPL_dinov2.py
    --device cpu --opts ...``: the full-width DINOv2-base backbone (random
    weights: none are in the repository) at 56px, float32, on 3 images."""
    _make_dataset(tmp_path / "RefCOD", name="SYN", n=3)
    argv = ["eval", "-c", os.path.join(REPO, "configs", "uscod", "UCOD-DPL_dinov2.py"), "--device", "cpu",
            "--work_dir", str(tmp_path / "wd"), "--datasets", "SYN", "--opts",
            "dataset_cfg.dataset_dir", str(tmp_path / "RefCOD"), "dataset_cfg.cache_dir", str(tmp_path / "cache"),
            "dataset_cfg.valset_cfg.image_size", "(56, 56)", "model_cfg.feature_size", "8",
            "tpu_cfg.compute_dtype", "float32", "val_cfg.look_twice_th", "0.95"]
    assert TCLI.main(argv) == 0
    out = capsys.readouterr().out
    line = [s for s in out.splitlines() if s.startswith("SYN ")]
    assert len(line) == 1 and all(k in line[0] for k in KEYS), out
    cache = TCache(tmp_path / "cache" / "features_cache" / "dinov2" / "test" / "SYN")
    assert cache.mode == "r" and cache.read(0).shape == (4, 4, 768)
    assert TCLI.main(["serve"]) == 2
    with pytest.raises(FileNotFoundError, match="Config file not found"):  # train is ported: it reads its config
        TCLI.main(["train", "-c", "x"])
    with pytest.raises(ValueError, match="does not exist"):  # ported: it parses its flags, refuses a missing dir
        TCLI.main(["generate_pseudo_label", "--image_path", str(tmp_path / "missing" / "{}"), "--device", "cpu",
                   "--backbone_weights", str(tmp_path / "none")])
