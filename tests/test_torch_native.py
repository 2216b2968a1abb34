"""The port's native host modules against the JAX package's NumPy and scipy
paths.

The scorer (``native/metrics_kernel.cpp``, built by the port into
``build/ucod_dpl_tpu_torch/native/``) against the JAX package's NumPy
``_score_one`` (``UCOD_NATIVE_METRICS=0``) on tests/test_metrics.py's cases
at rtol 1e-9 / atol 1e-12; the port's ``_score_one`` routes through it by
default and through NumPy under ``UCOD_NATIVE_METRICS=0``; a
``CODStatistics`` sweep gives equal results on both paths and counts the
images each scored.  The labeller (``native/cc_label.cpp``) against scipy's
partition on tests/test_native.py's cases, and ``connected_components``
taking it under ``UCOD_NATIVE_CC=1`` only.
"""

import numpy as np
import pytest
from scipy import ndimage

from ucod_dpl_tpu.utils import metrics as JM
from ucod_dpl_tpu_torch.utils import components as TC
from ucod_dpl_tpu_torch.utils import metrics as TM
from ucod_dpl_tpu_torch.utils import native as TN

TOL = dict(rtol=1e-9, atol=1e-12)


def _cases():
    """tests/test_metrics.py::test_native_scorer_parity's (gt, pred) pairs."""
    rng = np.random.default_rng(11)
    cases = []
    for _ in range(3):  # random soft predictions
        h, w = int(rng.integers(30, 150)), int(rng.integers(30, 150))
        cases.append(((rng.random((h, w)) > 0.7).astype(float) * 255, rng.random((h, w)) * 255))
    yy, xx = np.mgrid[:64, :80]  # tie-heavy EDT
    cases.append(((((yy // 8) + (xx // 8)) % 2).astype(float) * 255, rng.random((64, 80))))
    g = np.zeros((50, 60))
    g[20:30, 20:40] = 255
    cases.append((g, np.full((50, 60), 255.0)))  # constant prediction: the int-cast quirk
    cases.append((g, np.zeros((50, 60))))
    cases.append((np.zeros((50, 60)), rng.random((50, 60))))  # empty gt
    cases.append((np.full((50, 60), 255.0), rng.random((50, 60))))  # full gt
    g = np.zeros((50, 60))
    g[25, 30] = 255
    cases.append((g, rng.random((50, 60))))  # single-pixel gt (the ddof=1 NaN path)
    return cases


CASES = _cases()
CASE_IDS = ["soft0", "soft1", "soft2", "checkerboard", "constant255", "constant0", "empty_gt", "full_gt", "pixel_gt"]


@pytest.fixture(scope="module")
def scorer():
    if TN.get_metrics_lib() is None:
        pytest.skip("no g++: the native scorer is unavailable")


def _assert_bundle(got, want):
    for i in range(5):
        a, b = want[i], got[i]
        assert np.isclose(a, b, **TOL) or (np.isnan(a) and np.isnan(b)), (i, a, b)
    np.testing.assert_allclose(got[5], want[5], **TOL)
    np.testing.assert_allclose(got[6], want[6], **TOL)


@pytest.mark.parametrize("case", range(len(CASES)), ids=CASE_IDS)
def test_native_scorer_matches_jax_numpy(scorer, case, monkeypatch):
    """The port's ``_score_one`` on its NumPy path and its native path (the
    constant prediction's int64 dtype passed through to the scorer), and
    the native bundle itself, against the JAX package's NumPy path."""
    g, p = CASES[case]
    monkeypatch.setenv("UCOD_NATIVE_METRICS", "0")
    want = JM._score_one((g, p))
    got, native = TM._score_one((g, p))
    assert not native
    _assert_bundle(got, want)
    monkeypatch.delenv("UCOD_NATIVE_METRICS")
    pn, gn = TM.normalize_pair(p, g)
    assert (pn.dtype == np.int64) == (case in (4, 5))
    _assert_bundle(TN.score_one_native(pn, gn, TM._gauss_kernel_matlab()), want)
    got, native = TM._score_one((g, p))
    assert native
    _assert_bundle(got, want)


def test_cod_statistics_sweep_is_equal_on_both_paths(scorer, monkeypatch):
    """One sweep over the cases (one batch of three of equal size, then one
    image a step) through the native scorer and through NumPy: equal
    results, and the counter names the path of every image."""
    rng = np.random.default_rng(5)
    batch = (np.stack([(rng.random((40, 48)) > 0.6) * 255.0 for _ in range(3)]), rng.random((3, 40, 48)) * 255)
    results = {}
    for path in ("native", "numpy"):
        if path == "numpy":
            monkeypatch.setenv("UCOD_NATIVE_METRICS", "0")
        TM.native_scored.update(native=0, numpy=0)
        stats = TM.CODStatistics()
        stats.step(*batch)
        for g, p in CASES:
            stats.step(g, p)
        results[path] = stats.get_result()
        assert TM.native_scored == {"native": 0, "numpy": 0, path: 3 + len(CASES)}
    assert set(results["native"]) == {"ACC", "mIOU", "E_MAX", "E_MEAN", "F_MAX", "F_MEAN", "SMeasure", "MAE", "WFM"}
    for key, value in results["numpy"].items():
        got = results["native"][key]
        assert np.isclose(got, value, **TOL) or (np.isnan(value) and np.isnan(got)), key


@pytest.fixture(scope="module")
def labeller():
    if TN.get_lib() is None:
        pytest.skip("no g++: the native labeller is unavailable")


def _same_partition(n_nat, lab_nat, mask):
    lab_sp, n_sp = ndimage.label(mask, structure=np.ones((3, 3)))
    assert n_nat == n_sp
    for i in range(1, n_nat + 1):
        ids = np.unique(lab_sp[lab_nat == i])
        assert len(ids) == 1 and ids[0] != 0
    np.testing.assert_array_equal(lab_nat == 0, lab_sp == 0)


def test_native_labels_match_scipy_partition(labeller, monkeypatch):
    """tests/test_native.py's random masks, through ``cc_label`` and through
    ``connected_components`` under ``UCOD_NATIVE_CC=1`` (and scipy without
    it: same partition, the scipy labels themselves)."""
    rng = np.random.default_rng(0)
    for _ in range(8):
        mask = (rng.random((64, 64)) > 0.6).astype(np.uint8)
        _same_partition(*TN.cc_label(mask), mask)
        monkeypatch.setenv("UCOD_NATIVE_CC", "1")
        n, lab = TC.connected_components(mask)
        assert lab.dtype == np.int32
        _same_partition(n, lab, mask)
        monkeypatch.setenv("UCOD_NATIVE_CC", "0")
        n, lab = TC.connected_components(mask)
        want, n_sp = ndimage.label(mask, structure=np.ones((3, 3)))
        assert n == n_sp and np.array_equal(lab, want)


def test_native_stats_and_worst_cases(labeller):
    """tests/test_native.py's component statistics, checkerboard and stripes."""
    mask = np.zeros((32, 32), np.uint8)
    mask[2:6, 3:9] = 1  # area 24, bbox (3, 2)-(8, 5)
    mask[20:25, 20:22] = 1  # area 10, bbox (20, 20)-(21, 24)
    n, labels = TN.cc_label(mask)
    assert n == 2
    assert sorted(TN.cc_stats(labels, n).tolist(), key=lambda s: -s[0]) == [[24, 3, 2, 8, 5], [10, 20, 20, 21, 24]]
    assert TN.cc_stats(labels, 0).shape == (0, 5)
    checker = (np.indices((33, 33)).sum(axis=0) % 2).astype(np.uint8)  # one diagonal component
    assert TN.cc_label(checker)[0] == 1
    stripes = np.zeros((16, 16), np.uint8)
    stripes[:, ::2] = 1
    assert TN.cc_label(stripes)[0] == 8
