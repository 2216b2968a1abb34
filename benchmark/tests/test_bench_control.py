"""The controls come out not correct: the cell's comparison with the
program replaced by the reference computed one precision below the bf16
the configuration serves in (its products in fp8, ``Matmul(fp8=True)``),
and a run of the cell with the program's own int8 path switched on
(``program.int8_path``, as ``calibrate.py --int8`` runs it), which the
cell's precision checks refuse.  On the CPU at a small size; on the card
(marked ``cuda``) at the cells' own sizes, three seeds each:

    python -m pytest -q -p no:cacheprovider -m cuda benchmark/tests/test_bench_control.py
"""

import pytest
import torch

from benchmark.harness import cell, manifest, program
from benchmark.tests import tiny

CELLS = manifest.workload_names()
SEEDS = (2 ** 31 + 7, 2 ** 31 + 8, 2 ** 31 + 9)


def _control(name, seed, device, overrides=None):
    wl = {**manifest.workload(name), **(overrides or {})}
    cfg = wl["config"] if isinstance(wl["config"], dict) else manifest.config(wl["config"])
    run = cell.Run(wl, cfg, seed, torch.device(device), program.DTYPES[wl["dtype"]], False)
    return manifest.driver(wl["driver"]).control(run)


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_the_cpu(name):
    checks = _control(name, SEEDS[0], "cpu", tiny.overrides(name, dtype="bfloat16"))
    assert any(v > lim for v, lim in checks.values()), checks


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for seed in SEEDS:
        checks = _control(name, seed, "cuda")
        assert any(v > lim for v, lim in checks.values()), (seed, checks)


@pytest.mark.parametrize("name", CELLS)
def test_int8_path_fails_on_the_cpu(name):
    with program.int8_path():
        r = cell.run(name, SEEDS[0], 0.3, False, device="cpu", overrides=tiny.overrides(name))
    assert not r["correct"] and r["checks"]["lowp_elements"]["value"] > 0, r["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_int8_path_fails_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for seed in SEEDS:
        with program.int8_path():
            r = cell.run(name, seed, 2.0, False, device="cuda")
        assert not r["correct"], (seed, r["checks"])
        assert r["checks"]["int8_launches"]["value"] > 0 and r["checks"]["lowp_elements"]["value"] > 0, r["checks"]
