"""A run of each cell at a small size on the CPU, through the harness as the
card runs it (set-up, window, check; only the look for a card skipped), is
correct; with each fault the cell can have planted underneath
(``harness/faults.py``), it is not.  The limits are the cells' own; every
workload file is run, also one the manifest does not list yet."""

import pytest

from benchmark.harness import cell, faults, manifest
from benchmark.tests import tiny

SEED = 2 ** 31 + 12345  # more than 32 signed bits hold, as run seeds may be
CELLS = manifest.workload_names()
CASES = [(c, f) for c in CELLS for (d, f) in faults.FAULTS if d == manifest.workload(c)["driver"]]


def _run(name, **extra):
    return cell.run(name, SEED, 0.3, False, device="cpu", overrides=tiny.overrides(name, **extra))


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    r = _run(name)
    assert r["correct"], r["checks"]
    assert r["checks"]["int8_launches"]["value"] == 0 == r["checks"]["lowp_elements"]["value"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_is_caught(name, fault):
    with faults.planted(manifest.workload(name)["driver"], fault):
        r = _run(name)
    assert not r["correct"], r["checks"]


def test_a_failing_call_makes_the_run_incorrect(monkeypatch):
    from ucod_dpl_tpu_torch import serving

    calls = {"n": 0}
    orig = serving.Predictor.predict

    def flaky(self, *a, **k):
        calls["n"] += 1
        if calls["n"] == 3:  # the window's first call (two warm-up calls come before it)
            raise RuntimeError("lost")
        return orig(self, *a, **k)

    monkeypatch.setattr(serving.Predictor, "predict", flaky)
    r = _run("dinov2-predict-518-bs16")
    assert r["failed"] == 1 and not r["correct"]
