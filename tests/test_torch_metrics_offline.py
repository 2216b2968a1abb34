"""The port's offline utilities against the JAX package's.

* ``utils/metrics.py::calculate_cod_metrics`` on the same written files:
  PNG and JPG predictions, sizes that need the resize, directory and list
  inputs, within 1e-6;
* ``auroc`` (the rank statistic, no scikit-learn) against the JAX one
  (``sklearn.metrics.roc_auc_score``) within 1e-12, with ties, a constant
  prediction and the single-class ``ValueError``;
* ``cli compute_metrics`` against ``scripts/compute_metrics.py`` run as a
  subprocess: the same printed lines and JSON;
* ``utils/profiling.py::annotate`` names a region of a ``torch.profiler``
  trace;
* ``utils/fileio.py::ArrayCache.dump_list`` round-trips through ``read``
  as the JAX one does, and each package reads the other's.
"""

import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch
from PIL import Image

from ucod_dpl_tpu.utils import metrics as JM
from ucod_dpl_tpu.utils.fileio import ArrayCache as JCache
from ucod_dpl_tpu_torch import cli
from ucod_dpl_tpu_torch.utils import metrics as TM
from ucod_dpl_tpu_torch.utils.fileio import ArrayCache as TCache
from ucod_dpl_tpu_torch.utils.profiling import annotate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("E_MAX", "E_MEAN", "F_MAX", "F_MEAN", "SMeasure", "MAE", "WFM")


@pytest.fixture(scope="module")
def masks(tmp_path_factory):
    """``gt/`` of 5 PNG masks at two sizes; ``pred/`` of soft predictions,
    three at the ground truth's size, two smaller (the resize), two stored
    as JPG (the extension fallback)."""
    root = tmp_path_factory.mktemp("masks")
    gt_dir, pred_dir = root / "gt", root / "pred"
    gt_dir.mkdir()
    pred_dir.mkdir()
    rng = np.random.default_rng(0)
    for i in range(5):
        h, w = ((40, 50), (64, 48))[i % 2]
        m = np.zeros((h, w), np.uint8)
        m[8 + i:h - 10, 10:w - 12 + i] = 255
        Image.fromarray(m).save(gt_dir / f"x{i}.png")
        ph, pw = (h, w) if i < 3 else (h // 2 + 1, w // 2 - 1)
        yy, xx = np.mgrid[:ph, :pw]
        soft = np.exp(-(((yy - ph / 2) / ph) ** 2 + ((xx - pw / 2) / pw) ** 2) * 4) * 255
        soft = np.clip(soft + rng.normal(0, 20, soft.shape), 0, 255).astype(np.uint8)
        Image.fromarray(soft).save(pred_dir / f"x{i}.{'jpg' if i in (1, 4) else 'png'}")
    return str(gt_dir), str(pred_dir)


def _assert_metrics_equal(got, want, tol=1e-6):
    assert list(got) == list(KEYS) and set(want) == set(KEYS)
    for k in KEYS:
        assert abs(got[k] - want[k]) <= tol, (k, got[k], want[k])


def test_calculate_cod_metrics_dirs_match_jax(masks):
    gt, pred = masks
    got = TM.calculate_cod_metrics(gt, pred)
    _assert_metrics_equal(got, JM.calculate_cod_metrics(gt, pred, verbose=False))
    assert 0.0 < got["MAE"] < 1.0 and 0.0 < got["SMeasure"] < 1.0


def test_calculate_cod_metrics_lists_match_jax(masks):
    """Lists, with predictions named by a ``.png`` path whose file is a
    ``.jpg`` (the fallback), in another order than the directory's."""
    gt, pred = masks
    order = [3, 0, 4, 1]
    gts = [os.path.join(gt, f"x{i}.png") for i in order]
    preds = [os.path.join(pred, f"x{i}.png") for i in order]
    _assert_metrics_equal(TM.calculate_cod_metrics(gts, preds), JM.calculate_cod_metrics(gts, preds, verbose=False))
    with pytest.raises(ValueError, match="count mismatch"):
        TM.calculate_cod_metrics(gts, preds[:-1])


@pytest.mark.parametrize("case", ["random", "ties", "constant", "bool-gt", "tiny"])
def test_auroc_matches_jax(case):
    rng = np.random.default_rng(7)
    gt = rng.random((30, 40)) > 0.6
    pred = {"random": rng.random((30, 40)),
            "ties": np.round(rng.random((30, 40)) * 4) / 4 + 0.3 * gt,  # 5 levels, many ties
            "constant": np.full((30, 40), 0.25),
            "bool-gt": rng.standard_normal((30, 40)) + gt,
            "tiny": np.array([0.1, 0.4, 0.35, 0.8])}[case]
    if case == "tiny":
        gt = np.array([0, 0, 1, 1])
    elif case != "bool-gt":
        gt = gt.astype(np.float64)
    got, want = TM.auroc(pred, gt), JM.auroc(pred, gt)
    assert abs(got - want) <= 1e-12, (got, want)
    if case == "constant":
        assert got == 0.5
    if case == "tiny":
        assert got == 0.75


def test_auroc_refuses_one_class():
    """The port raises scikit-learn's ValueError; the JAX ``auroc`` raises
    it too, or, with scikit-learn 1.9 and later, warns and returns NaN:
    neither gives a number."""
    pred, gt = np.random.default_rng(0).random((4, 4)), np.ones((4, 4))
    with pytest.raises(ValueError, match="Only one class present in y_true"):
        TM.auroc(pred, gt)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            want = JM.auroc(pred, gt)
        except ValueError as e:
            assert "Only one class present in y_true" in str(e)
        else:
            assert np.isnan(want)


def test_cli_compute_metrics_matches_the_jax_script(masks, tmp_path, capsys):
    gt, pred = masks
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO}
    want = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "compute_metrics.py"), "--gt-dir", gt,
                           "--pred-dir", pred, "--json", str(tmp_path / "jax.json")], capture_output=True, text=True,
                          env=env, cwd=REPO, timeout=300, check=True).stdout
    assert cli.main(["compute_metrics", "--gt-dir", gt, "--pred-dir", pred, "--json", str(tmp_path / "port.json")]) == 0
    got = capsys.readouterr().out
    assert got.splitlines() == want.splitlines() and len(got.splitlines()) == len(KEYS)
    assert json.loads((tmp_path / "port.json").read_text()) == json.loads((tmp_path / "jax.json").read_text())


def test_annotate_names_a_profiler_region():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with annotate("ucod_step_region"):
            torch.ones(8) @ torch.ones(8)
    assert "ucod_step_region" in {e.name for e in prof.events()}


def test_dump_list_round_trips_like_jax(tmp_path):
    rng = np.random.default_rng(3)
    arrays = [(rng.random((4, 4, 1)) > 0.5).astype(np.float32), rng.standard_normal((2, 3)).astype(np.float32),
              np.arange(5, dtype=np.int64)]
    for name, cache_cls in (("port", TCache), ("jax", JCache)):
        cache_cls(tmp_path / name).dump_list(arrays)
        for cls in (TCache, JCache):
            c = cls(tmp_path / name)
            assert c.mode == "r" and len(c) == len(arrays), (name, cls)
            for i, a in enumerate(arrays):
                got = c.read(i)
                assert got.dtype == a.dtype and np.array_equal(got, a), (name, cls, i)
