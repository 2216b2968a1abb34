"""The port's parity runner (``ucod_dpl_tpu_torch.tools.parity``) and
``LookTwiceEvaluator.look_twice`` on the CPU against the JAX package's
``scripts/parity.py`` and ``LookTwiceEvaluator.look_twice``.

Both runners run in this process on one tiny configuration: JAX's script
is imported as a module and each side's ``_load_stage_cfg`` is
monkeypatched to give tests/test_torch_eval.py's tiny stage-1 configuration
(DIM 64, feature size 8, 56px, LookTwice at ``look_twice_th`` 0.95 so that
the crop path runs) and tests/test_torch_coral.py's CORAL configuration
(window size 3, window length 8), over a backbone of 64 wide, 2 layers
(a seeded HuggingFace-layout checkpoint written by the port), a seeded
decoder checkpoint and a seeded refiner checkpoint, float32.  The JAX
script runs first and builds the caches; the port's tool reads them, so the
report's metrics come from one cache and are held within 1e-6 (the rows
print them rounded to 4 decimals, which may then differ by one unit).  The
exit codes, the asset problems of the sane and malformed layouts of
tests/test_parity_runner.py and the dataset-name refusal are the JAX
script's.  ``look_twice`` on one image: masks equal on at least 99.9% of
pixels (a float32 logit within rounding of 0.5 may fall either way).
"""

import argparse
import dataclasses
import importlib.util
import json
import os
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from ucod_dpl_tpu.config import CfgNode as JCfg
from ucod_dpl_tpu.engine import Runner as JRunner
from ucod_dpl_tpu.engine.eval_loop import LookTwiceEvaluator as JEvaluator
from ucod_dpl_tpu_torch.config import CfgNode as TCfg
from ucod_dpl_tpu_torch.data.feature_extractor import FeatureExtractor
from ucod_dpl_tpu_torch.data.transforms import load_image_batch_transform
from ucod_dpl_tpu_torch.engine.eval_loop import LookTwiceEvaluator as TEvaluator, find_refine_bboxes
from ucod_dpl_tpu_torch.engine.runner import Runner as TRunner
from ucod_dpl_tpu_torch.models.dba import init_rev_decoder, rev_decoder_forward_resized
from ucod_dpl_tpu_torch.models.dino import DinoConfig, init_dino, save_hf_checkpoint
from ucod_dpl_tpu_torch.models.safetensors_io import save_decoder_checkpoint
from ucod_dpl_tpu_torch.models.udlr import init_sparse_refiner, save_refiner_checkpoint
from ucod_dpl_tpu_torch.tools import parity as TP

from test_torch_eval import ARCH, DIM, _cfg_dict, _make_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATASET = "CHAMELEON"  # a name with a published row
KEYS = ("SMeasure", "WFM", "F_MEAN", "E_MEAN", "MAE")


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_parity_script", os.path.join(REPO, "scripts", "parity.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JP = _jax_script()


def _stage_cfg_dict(cfg_prefix, log_prefix, variant, args):
    """The tiny stand-in for ``configs/uscod/{cfg_prefix}_{variant}.py``,
    set up as ``_load_stage_cfg`` sets it up."""
    root = args.work_dir
    d = _cfg_dict(Path(root), log_prefix, args.backbone_weights)
    d["dataset_cfg"]["dataset_dir"] = args.data_dir
    d["dataset_cfg"]["cache_dir"] = args.cache_dir
    d["dataset_cfg"]["feature_extractor_cfg"]["strict_weights"] = not args.allow_random_backbone
    d["dataset_cfg"]["valset_cfg"]["keep_size"] = True
    d["val_cfg"]["save_preds"] = False
    if cfg_prefix == "CORAL":  # tests/test_torch_coral.py's refiner geometry
        d["model_cfg"].update(window_size=3, window_length=8, threshold=0.0015)
        d["val_cfg"]["look_twice"] = False
        d["dataset_cfg"]["valset_cfg"]["require_m_patches"] = False
        d["dataset_cfg"]["val_loader_cfg"]["batch_size"] = 2
    d["work_dir"] = root
    d["log_cfg"]["log_path"] = os.path.join(root, f"{log_prefix}_{variant}")
    return d


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """5 images in ``RefCOD/CHAMELEON``, the backbone checkpoint, a decoder
    whose first pass marks about a third of the pixels and a refiner."""
    root = tmp_path_factory.mktemp("parity")
    _make_dataset(root / "RefCOD", name=DATASET)
    dcfg = dataclasses.replace(DinoConfig.from_type("dinov2"), **ARCH)
    (root / "hf").mkdir()
    save_hf_checkpoint(str(root / "hf" / "model.safetensors"), init_dino(0, dcfg), dcfg)
    fe_cfg = _cfg_dict(root, "x", root / "hf")["dataset_cfg"]["feature_extractor_cfg"]
    fe = FeatureExtractor(TCfg(fe_cfg), device="cpu")
    paths = sorted((root / "RefCOD" / DATASET / "im").iterdir())
    feats = torch.from_numpy(fe.extract(load_image_batch_transform(paths, (56, 56))))
    dec = init_rev_decoder(1, DIM)
    fg, _, _ = rev_decoder_forward_resized(dec, feats, 8)
    dec = dec._replace(conv_out_fg_b=dec.conv_out_fg_b - torch.quantile(fg.flatten(), 0.67))
    ckpt = str(root / "decoder.safetensors")
    save_decoder_checkpoint(ckpt, dec, init_rev_decoder(2, DIM))
    refiner = str(root / "refiner.safetensors")
    save_refiner_checkpoint(refiner, init_sparse_refiner(9, dim=DIM))
    return dict(root=root, ckpt=ckpt, refiner=refiner, weights=str(root / "hf"), paths=paths)


def _argv(world, tag, *extra):
    root = world["root"]
    return ["--data-dir", str(root / "RefCOD"), "--cache-dir", str(root / "cache"), "--work-dir",
            str(root / f"work_{tag}"), "--backbone-weights", world["weights"], "--decoder-v2", world["ckpt"],
            "--refiner-v2", world["refiner"], "--datasets", DATASET, "--report", str(root / f"report_{tag}.json"),
            *extra]


def _run_jax(argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["parity.py", *argv])
    with pytest.raises(SystemExit) as e:
        JP.main()
    return e.value.code, capsys.readouterr()


def _run_port(argv, capsys):
    with pytest.raises(SystemExit) as e:
        TP.main(argv)
    return e.value.code, capsys.readouterr()


@pytest.fixture(scope="module")
def reports(world):
    """Both runners on the tiny configurations (JAX's first: it builds the
    caches), each metric dict they compared, their exit codes and reports."""
    mp = pytest.MonkeyPatch()
    results = {"jax": [], "port": []}
    try:
        for side, module, cfg_node in (("jax", JP, JCfg), ("port", TP, TCfg)):
            mp.setattr(module, "_load_stage_cfg", lambda *a, node=cfg_node: node(_stage_cfg_dict(*a)))
            real = module._compare
            mp.setattr(module, "_compare",
                       lambda report, key, result, tol, real=real, side=side: (
                           results[side].append((key, dict(result))), real(report, key, result, tol)))
        codes = {}
        mp.setattr(sys, "argv", ["parity.py", *_argv(world, "jax")])
        for side, run in (("jax", JP.main), ("port", lambda: TP.main(_argv(world, "port", "--device", "cpu")))):
            try:
                run()
            except SystemExit as e:
                codes[side] = e.code
    finally:
        mp.undo()
    rows = {side: json.load(open(world["root"] / f"report_{side}.json")) for side in ("jax", "port")}
    return dict(codes=codes, results=results, rows=rows)


def test_report_rows_and_exit_code_match_jax(reports):
    rows, codes = reports["rows"], reports["codes"]
    assert [(r["stage"], r["variant"], r["dataset"]) for r in rows["port"]] == [
        ("UCOD-DPL", "dinov2", DATASET), ("CORAL", "dinov2", DATASET)]
    for got, want in zip(rows["port"], rows["jax"]):
        assert set(got) == set(want) == {"stage", "variant", "dataset", "ours", "published", "delta", "pass"}
        assert got["published"] == want["published"] == TP.BASELINE[(got["stage"], "dinov2", DATASET)]
        for k in KEYS:
            assert abs(got["ours"][k] - want["ours"][k]) <= 1e-4 + 1e-12, (got["stage"], k)
            assert 0.0 <= got["ours"][k] <= 1.0
        assert got["pass"] == want["pass"]
    # a random tiny backbone cannot reproduce the published table: exit 1
    assert codes["port"] == codes["jax"] == (0 if all(r["pass"] for r in rows["port"]) else 1) == 1


def test_report_metrics_match_jax_from_one_cache(reports):
    got, want = reports["results"]["port"], reports["results"]["jax"]
    assert [k for k, _ in got] == [k for k, _ in want] and len(got) == 2
    for (key, g), (_, w) in zip(got, want):
        for k in KEYS:
            assert abs(g[k] - w[k]) <= 1e-6, (key, k, g[k], w[k])


def test_baseline_table_is_the_jax_scripts():
    assert TP.BASELINE == JP.BASELINE and TP.DEFAULT_DATASETS == JP.DEFAULT_DATASETS
    assert TP._METRIC_KEYS == JP._METRIC_KEYS


def _synth(root, n=2):
    """tests/test_parity_runner.py's layout: ``root/CHAMELEON/{im,gt}``."""
    im, gt = root / DATASET / "im", root / DATASET / "gt"
    im.mkdir(parents=True)
    gt.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(n):
        Image.fromarray((rng.random((64, 80, 3)) * 255).astype(np.uint8)).save(im / f"x{i}.jpg")
        m = np.zeros((64, 80), np.uint8)
        m[20:40, 20:50] = 255
        Image.fromarray(m).save(gt / f"x{i}.png")


@pytest.mark.parametrize("layout", ["sane", "malformed"])
def test_check_assets_matches_jax(world, tmp_path, monkeypatch, capsys, layout):
    _synth(tmp_path / "RefCOD")
    extra = ["--decoder-v2", world["ckpt"]]
    if layout == "malformed":  # a gt-less dataset, a garbage checkpoint, an empty weights dir
        shutil.rmtree(tmp_path / "RefCOD" / DATASET / "gt")
        (tmp_path / "bad.safetensors").write_bytes(b"not a safetensors file")
        (tmp_path / "weights").mkdir()
        extra = ["--decoder-v2", str(tmp_path / "bad.safetensors"), "--backbone-weights", str(tmp_path / "weights")]
    argv = ["--data-dir", str(tmp_path / "RefCOD"), "--cache-dir", str(tmp_path / "cache"), "--datasets", DATASET,
            "--check-assets", *extra]
    jcode, jout = _run_jax(argv, monkeypatch, capsys)
    tcode, tout = _run_port(argv, capsys)
    assert tcode == jcode == (0 if layout == "sane" else 2)
    assert tout.out == jout.out
    if layout == "sane":
        assert "assets: OK" in tout.out
    else:
        assert "missing" in tout.out and "not a readable safetensors" in tout.out and "no model.safetensors" in tout.out


def test_malformed_assets_stop_a_run_and_unknown_datasets_are_refused(world, tmp_path, monkeypatch, capsys):
    _synth(tmp_path / "RefCOD")
    argv = ["--data-dir", str(tmp_path / "RefCOD"), "--cache-dir", str(tmp_path / "cache"), "--datasets", DATASET,
            "--decoder-v2", str(tmp_path / "missing.safetensors")]
    jcode, jout = _run_jax(argv, monkeypatch, capsys)
    tcode, tout = _run_port(argv, capsys)
    assert isinstance(tcode, str) and tcode == jcode and "malformed assets" in tcode
    assert tout.err == jout.err and "ASSET PROBLEM" in tout.err
    argv = ["--data-dir", str(tmp_path / "RefCOD"), "--cache-dir", str(tmp_path / "cache"), "--datasets", "CHAMELON"]
    assert _run_jax(argv, monkeypatch, capsys)[0] == _run_port(argv, capsys)[0] == 2


def test_look_twice_matches_jax(world, reports):
    """One image's LookTwice through each package's evaluator, from the
    caches the runners built: the refined masks agree on at least 99.9% of
    pixels, and the port ran one crop call."""
    root = world["root"]
    d = _stage_cfg_dict("UCOD-DPL", "lt", "dinov2", argparse.Namespace(
        work_dir=str(root / "work_lt"), backbone_weights=world["weights"], data_dir=str(root / "RefCOD"),
        cache_dir=str(root / "cache"), allow_random_backbone=False))
    d["dataset_cfg"]["valset_cfg"]["DATASET"] = DATASET
    jev = JEvaluator(JCfg(d), JRunner(JCfg(d), mode="eval", load_from=world["ckpt"]))
    tev = TEvaluator(TCfg(d), TRunner(TCfg(d), mode="eval", load_from=world["ckpt"], device="cpu"))
    mask = np.zeros((56, 56), np.float32)
    mask[8:20, 10:24] = 1.0
    mask[34:46, 30:50] = 1.0
    bboxes = find_refine_bboxes(mask, (56, 56), 0.95, "dynamic")
    assert len(bboxes) == 2
    path = str(world["paths"][1])
    want = jev.look_twice(path, bboxes, mask)
    got = tev.look_twice(path, bboxes, mask)
    assert got.shape == want.shape == (56, 56) and got.dtype == np.float32
    assert (got == want).mean() >= 0.999
    assert tev.crop_batches == 1 and not np.array_equal(got, mask)
